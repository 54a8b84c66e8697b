#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile DIR    # also profile a tree fit, a
                                           # forest fit and serving
                                           # (torch.profiler; tables in DIR)

Phases, in order; any failure raises and exits non-zero:

1. build: compile every ``mpitree_tpu_torch/csrc/*.cu`` (``histogram.cu``,
   ``traverse.cu``) with ``nvcc`` for ``sm_90a`` into ``build/``, one
   ``nvcc`` per source, started together.
2. kernels: bin ``covtype_like(581_012, seed=0)`` (256 bins) on the card;
   for S in {1, 8, 64, 128, 512, K} (K the fit's chunk width) spread the
   rows over S slots (some slots empty, some rows at -1) with class
   payloads, hold every histogram route whose tile fits that width, with
   int32 and with byte-wide bins, ``torch.equal`` to the plain version and
   time it behind a device-side hold (a sorted route as a whole, its sort
   included, and its kernel alone on rows ordered beforehand; the sort
   alone too), and time the plain version and one library call
   (``index_put_(..., accumulate=True)`` over prebuilt flat ids) beside
   the least time the card could take for the bytes the planned route
   reads (and, as ``bound_int32_ms``, for 4-byte bins).
3. fit: ``DecisionTreeClassifier(criterion="entropy", max_depth=20,
   max_bins=256)`` on the full matrix, twice; the launch counters are set
   to 0 just before the second fit and read just after it, and every
   route must have launched.
4. parity: ``covtype_like(50_000, seed=2)`` at ``max_depth=10`` on the
   card and with ``device="cpu"`` (the plain versions): the trees must be
   identical field for field, or differ first at a node whose two
   candidate float64 costs are within 1e-12 relative (an exact-tie
   residual: CUDA's and glibc's fp64 ``log`` may differ by an ulp).
5. forest: ``RandomForestClassifier(n_estimators=50, max_depth=12,
   max_bins=256, random_state=0)`` on the first 200,000 rows, twice; the
   histogram launch counters are set to 0 just before the second fit and
   read just after it. Held-out accuracy on ``covtype_like(50_000,
   seed=1)``. Then a 4-tree, depth-8 forest on ``covtype_like(20_000,
   seed=4)`` on the card and with ``device="cpu"``: identical trees.
6. serve kernels: on that forest's flat table, the traversal kernel K4 in
   ``sum`` over the served channel (per-leaf normalized counts), ``norm``
   (counts), ``sum`` (7 and 12 non-integer float64 channels) and
   ``percls`` (7 and 3 columns; 3 does not divide the 50 trees), and the
   quantized kernel K5 in ``sum`` and ``percls`` are held ``torch.equal``
   to their plain versions at 1, 64, 4,096 and 500,000 rows of
   ``covtype_like(500_000, seed=3)``, and timed beside their bound and
   their plain version. A kernel's launches are queued behind a
   device-side hold, so the events bracket device time only (the one-row
   and 64-row shapes average 50 launches per event pair). The served
   channel's K4 and K5 are also run, checked and timed at every forced
   tiling (rows per block), beside the planner's.
7. serve: ``ModelRegistry().publish("rf", forest)`` and
   ``publish("rf8", forest, quantize="int8")``, each answering 300
   one-row, 150 64-row and 30 4,096-row requests (p50/p99 per bucket),
   then one 500,000-row batch (rows/s); the traversal launch counters are
   set to 0 just before the publishes and read after the batch. ``rf``
   must equal ``forest.predict_proba`` bit for bit on 4,096 held-out rows,
   and ``rf8`` must stay within its own exactness report on its
   calibration batch.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the card's name and power limit, JSON lines of per-shape kernel timings
(``kernel_shapes``, ``serve_kernel_shapes``), of the serving measurements
(``serving``) and one ``kernels`` line come before it.
Without CUDA the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM peaks (data sheet; 700 W): HBM bytes/s and non-tensor fp32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SLOT_TIERS = (1, 8, 64, 128, 512)
DEV = torch.device("cuda")
ROWS, DEPTH = 581_012, 20  # covtype's rows; the BASELINE fit's depth
# One shape per route for the "kernels" line: stream's one width (the
# root level) and sorted at S=K, the width of the deep levels.
REPRESENTATIVE = {"stream": 1, "sorted": None}
# Device kernels of a profiled run, grouped by what they serve (first match).
PROFILE_KINDS = (
    ("histogram kernels", ("hist_tile_kernel", "hist_zero_split_kernel")),
    ("traversal kernels", ("traverse_kernel",)),
    ("copies", ("Memcpy", "memcpy", "Memset")),
    ("sort/search (binning, level order)",
     ("sort", "Sort", "radix", "Radix", "searchsorted")),
    ("float64 sweep", ("double",)),
)
REPLACES = {
    "stream": "mpitree_tpu/ops/pallas_hist.py:77",
    "sorted": "mpitree_tpu/ops/wide_hist.py:252",
}
# BASELINE config 5, bench.py's FOREST_SHAPES["tpu"]; not cut.
FOREST = dict(n_estimators=50, max_depth=12, max_bins=256, random_state=0)
FOREST_ROWS = 200_000
SERVE_SHAPES = (1, 64, 4_096, 500_000)  # the buckets, then a batch
SERVE_TILINGS = (1, 2, 4, 8, 16, 32, 64)  # rows per block, beside plan's
# launches averaged per event pair, by rows: a one-row launch is a few us
SERVE_INNER = {1: 50, 64: 50, 4_096: 20, 500_000: 2}
# device-side hold (clock cycles, about 4 ms) while a pair's launches are
# queued: several times the host's time to queue 50 of them
HOLD_CYCLES = 8_000_000
# (bucket rows, requests), as bench_tpu.py's serving section sends them
REQUESTS = ((1, 300), (64, 150), (4_096, 30))
# the serving kernels' kernels-line entries: launch counter -> (mode,
# channel) the served path runs, at the 4,096-row bucket
SERVE_LINE = {"traverse": ("sum", "proba"), "traverse_q": ("sum", "qproba")}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 7, inner: int = 1, hold: bool = False) -> float:
    """Median device time of one ``fn`` over ``reps`` event pairs (CUDA
    events), each around ``inner`` runs, after one warm-up run. ``hold``
    queues the runs behind a device-side sleep, so the first event fires
    only when all of them are queued and the pair brackets device time, not
    the host's time to launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    from mpitree_tpu_torch import _build

    t0 = time.perf_counter()
    names = _build.build_all()
    log(f"build: csrc/{{{','.join(names)}}}.cu in "
        f"{time.perf_counter() - t0:.3f} s (nvcc {_build.nvcc_path()})")


def _slots(rng, N: int, S: int) -> np.ndarray:
    """Rows spread over S slots, about 1/8 of the slots left empty and 10%
    of the rows parked at -1."""
    live = np.sort(rng.choice(S, size=max(1, S - S // 8), replace=False))
    slot = live[rng.integers(0, len(live), N)].astype(np.int32)
    slot[rng.random(N) < 0.1] = -1
    return slot


def phase_kernels(xb, y_d, B: int, K: int, feat_bins: list) -> list:
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.ops.histogram import class_payload

    N, F = xb.shape
    C = 7
    payload = class_payload(y_d, None, C).contiguous()
    packed = hist_kernel.pack_bins(xb, B)
    rng = np.random.default_rng(0)
    feat = torch.arange(F, device=xb.device, dtype=torch.int64)
    rows = []
    for S in sorted(set(SLOT_TIERS + (K,))):
        slot = torch.from_numpy(_slots(rng, N, S)).to(xb.device)
        planned = hist_kernel.plan(S, F, C, B, feat_bins=feat_bins,
                                   n_rows=N)["route"]
        want = hist_kernel.histogram_reference(xb, payload, slot,
                                               n_slots=S, n_bins=B)
        order, seg = hist_kernel.slot_segments(slot, S)
        torch.cuda.synchronize()
        sort_ms = cuda_ms(lambda: hist_kernel.slot_segments(slot, S),
                          hold=True)

        # Every route whose tile fits this width, with int32 and with
        # byte-wide bins: each is held equal to the plain version and
        # timed (a sorted route as a whole, its sort included, and its
        # kernel alone on rows ordered beforehand), so the plan's choice
        # is checked against the others on every run.
        route_ms = {}
        for route in hist_kernel.ROUTES:
            try:
                hist_kernel.plan(S, F, C, B, route, feat_bins=feat_bins)
            except ValueError:
                continue
            for bins, pk in (("int32", None), ("uint8", packed)):
                cases = {f"{route}/{bins}": {}}
                if route == "sorted":
                    cases[f"{route}/{bins}/presorted"] = dict(
                        order=order, seg_start=seg)
                for name, pre in cases.items():
                    def run(route=route, pk=pk, pre=pre):
                        return hist_kernel.histogram_cuda(
                            xb, payload, slot, n_slots=S, n_bins=B,
                            packed=pk, feat_bins=feat_bins, _variant=route,
                            **pre)
                    got = run()
                    torch.cuda.synchronize()
                    diff = float((got - want).abs().max().item())
                    if name == f"{planned}/uint8":
                        err = diff
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"{name} kernel != plain version at S={S} (max "
                            f"|diff| {diff})"
                        )
                    del got
                    route_ms[name] = cuda_ms(run, hold=True)
        del want

        # library yardstick: one index_put_ over prebuilt flat cell ids
        ok = (slot >= 0) & (slot < S)
        r = torch.nonzero(ok).squeeze(1)
        cls = y_d[r]
        ids = (((slot[r].to(torch.int64)[:, None] * F + feat) * C
                + cls[:, None]) * B + xb[r].to(torch.int64)).reshape(-1)
        vals = torch.ones_like(ids, dtype=torch.float32)
        n_in = int(r.numel())

        def library():
            out = torch.zeros(S * F * C * B, dtype=torch.float32,
                              device=xb.device)
            out.index_put_((ids,), vals, accumulate=True)
            return out

        plain_ms = cuda_ms(lambda: hist_kernel.histogram_reference(
            xb, payload, slot, n_slots=S, n_bins=B), reps=5)
        library_ms = cuda_ms(library, reps=5)
        del ids, vals, r, cls

        # Bytes the planned route must move: the slot vector (the sort
        # reads it, or the stream kernel), a padded byte row of bins and
        # the payload of every row in range, the sorted route's order and
        # segment offsets, and the output once. bound_int32 is the same
        # with 4-byte bins and no order: the earlier designs' bound.
        out_bytes = S * F * C * B * 4
        n_bytes = N * 4 + n_in * (packed.shape[1] + C * 4) + out_bytes
        if planned == "sorted":
            n_bytes += n_in * 4 + (S + 1) * 4
        int32_bytes = N * 4 + n_in * (F * 4 + C * 4) + out_bytes
        n_ops = n_in * F  # one add per (row, feature): one nonzero channel
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
        ms = route_ms[f"{planned}/uint8"]
        best = min(v for k, v in route_ms.items()
                   if not k.endswith("/presorted"))
        rows.append(dict(
            S=S, route=planned, rows_in_range=n_in, ms=ms,
            kernel_ms=route_ms.get(f"{planned}/uint8/presorted", ms),
            sort_ms=sort_ms if planned == "sorted" else 0.0,
            plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_int32_ms=max(int32_bytes / HBM_BYTES_PER_S, t_ops) * 1e3,
            max_abs_err=err, route_ms=route_ms, plan_vs_best=ms / best,
        ))
        log(f"kernels: S={S} {planned}: route {ms:.4f} ms (kernel "
            f"{rows[-1]['kernel_ms']:.4f}, sort {sort_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, index_put_ {library_ms:.4f} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}; int32 "
            f"bins {rows[-1]['bound_int32_ms']:.4f}); {ms / best:.3f}x the "
            f"best route; every route equal to plain, ms {route_ms}")
    return rows


def phase_fit(X, y, Xh, yh, depth: int):
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.tree import DecisionTreeClassifier

    clf = DecisionTreeClassifier(criterion="entropy", max_depth=depth,
                                 max_bins=256)
    t0 = time.perf_counter()
    clf.fit(X, y)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    for k in hist_kernel.launches:
        hist_kernel.launches[k] = 0
    t0 = time.perf_counter()
    clf.fit(X, y)
    torch.cuda.synchronize()
    second = time.perf_counter() - t0
    launches = dict(hist_kernel.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    t0 = time.perf_counter()
    proba = clf.predict_proba(Xh)
    predict_s = time.perf_counter() - t0
    train_acc = clf.score(X, y)
    test_acc = float(np.mean(clf.classes_[proba.argmax(axis=1)] == yh))
    tree = clf.tree_
    leaves = clf.apply(Xh)
    if not (proba.shape == (len(Xh), 7) and proba.dtype == np.int64
            and (proba.sum(axis=1) == tree.n_node_samples[leaves]).all()
            and (tree.feature[leaves] < 0).all()):
        raise AssertionError("predict_proba is not the leaves' raw counts")
    if not (0 < clf.get_depth() <= depth and tree.n_nodes > 1
            and np.isfinite(tree.impurity).all()
            and tree.n_node_samples[0] == len(X) and train_acc > 0.5
            and test_acc > 0.5):
        raise AssertionError(
            f"implausible fit: depth {clf.get_depth()}, nodes "
            f"{tree.n_nodes}, train {train_acc}, held-out {test_acc}"
        )
    missing = [k for k in hist_kernel.ROUTES if launches[k] == 0]
    if missing:
        raise AssertionError(f"fit never launched kernel routes {missing}")
    log(f"fit: {len(X)} x {X.shape[1]} depth {depth}: first {first:.3f} s, "
        f"second {second:.3f} s; train acc {train_acc:.6f}, held-out acc "
        f"{test_acc:.6f} ({len(Xh)} rows, predict {predict_s:.3f} s); "
        f"n_nodes {tree.n_nodes}, depth {clf.get_depth()}, leaves "
        f"{clf.get_n_leaves()}; peak device memory {peak_gib:.3f} GiB; "
        f"launches {launches}")
    return clf, launches, second


def _node_rows(tree, X: np.ndarray, node: int) -> np.ndarray:
    """Rows whose descent passes through ``node`` (its ancestors are the
    same in both trees, so either tree gives the same rows)."""
    from mpitree_tpu_torch.ops.predict import descend

    t = [torch.from_numpy(np.asarray(a)) for a in
         (tree.feature, tree.threshold, tree.left, tree.right)]
    ids = descend(torch.from_numpy(X), t[0].long(), t[1], t[2].long(),
                  t[3].long(), n_steps=int(tree.depth[node]))
    return (ids == node).numpy()


def phase_parity(depth: int = 10) -> None:
    from mpitree_tpu_torch.ops import histogram, impurity
    from mpitree_tpu_torch.ops.binning import bin_dataset
    from mpitree_tpu_torch.tree import DecisionTreeClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(50_000, seed=2)
    kw = dict(criterion="entropy", max_depth=depth, max_bins=256)
    t0 = time.perf_counter()
    gpu = DecisionTreeClassifier(device="cuda", **kw).fit(X, y).tree_
    t1 = time.perf_counter()
    cpu = DecisionTreeClassifier(device="cpu", **kw).fit(X, y).tree_
    t2 = time.perf_counter()
    fields = ("feature", "threshold", "left", "right", "count",
              "n_node_samples")
    same = gpu.n_nodes == cpu.n_nodes and all(
        np.array_equal(getattr(gpu, k), getattr(cpu, k), equal_nan=True)
        for k in fields
    )
    if same:
        log(f"parity: {len(X)} rows depth {depth}: cuda tree == cpu tree "
            f"({gpu.n_nodes} nodes; cuda {t1 - t0:.3f} s, cpu "
            f"{t2 - t1:.3f} s)")
        return
    n = min(gpu.n_nodes, cpu.n_nodes)
    diff = [i for i in range(n) if not all(
        np.array_equal(getattr(gpu, k)[i], getattr(cpu, k)[i],
                       equal_nan=True) for k in fields)]
    node = diff[0] if diff else n
    fa, fb = int(gpu.feature[node]), int(cpu.feature[node])
    if node >= n or fa < 0 or fb < 0:
        raise AssertionError(f"trees differ structurally at node {node}")
    binned = bin_dataset(X, max_bins=256)
    rows = _node_rows(cpu, X, node)
    hist = histogram.class_histogram(
        torch.from_numpy(binned.x_binned[rows]),
        torch.from_numpy(y[rows].astype(np.int64)),
        torch.zeros(int(rows.sum()), dtype=torch.int32), 0, n_slots=1,
        n_bins=binned.n_bins, n_classes=7,
    )
    hi, lo, _, _ = impurity.cost_sweep_f64(hist, "entropy")
    cost = hi.double() + lo.double()

    def cand(tree, f):
        b = np.flatnonzero(binned.thresholds[f] == tree.threshold[node])
        if len(b) != 1:
            raise AssertionError(
                f"node {node}: threshold {tree.threshold[node]!r} is not a "
                f"candidate of feature {f}"
            )
        return float(cost[0, f, int(b[0])])

    ca, cb = cand(gpu, fa), cand(cpu, fb)
    gap = abs(ca - cb) / max(abs(ca), abs(cb), 1e-300)
    log(f"parity: first difference at node {node} (depth "
        f"{int(cpu.depth[node])}, {int(rows.sum())} rows): cuda picks "
        f"feature {fa} at f64 cost {ca!r}, cpu picks feature {fb} at "
        f"{cb!r}; relative gap {gap:.3e}")
    if gap >= 1e-12:
        raise AssertionError(
            f"cuda and cpu trees differ beyond an exact-tie residual "
            f"(relative cost gap {gap:.3e} at node {node})"
        )


def phase_forest(X, y, Xh, yh):
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.tree import RandomForestClassifier

    Xf, yf = X[:FOREST_ROWS], y[:FOREST_ROWS]
    forest = RandomForestClassifier(**FOREST)
    t0 = time.perf_counter()
    forest.fit(Xf, yf)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0

    for k in hist_kernel.launches:
        hist_kernel.launches[k] = 0
    t0 = time.perf_counter()
    forest.fit(Xf, yf)
    torch.cuda.synchronize()
    second = time.perf_counter() - t0
    launches = dict(hist_kernel.launches)

    t0 = time.perf_counter()
    proba = forest.predict_proba(Xh)
    predict_s = time.perf_counter() - t0
    test_acc = float(np.mean(forest.classes_[proba.argmax(axis=1)] == yh))
    nodes = np.array([t.n_nodes for t in forest.trees_])
    depth = max(t.max_depth for t in forest.trees_)
    if not (len(nodes) == FOREST["n_estimators"] and nodes.min() > 1
            and depth <= FOREST["max_depth"] and np.isfinite(proba).all()
            and np.allclose(proba.sum(axis=1), 1.0, rtol=0, atol=1e-12)
            and test_acc > 0.5):
        raise AssertionError(
            f"implausible forest: {len(nodes)} trees, nodes {nodes.min()}.."
            f"{nodes.max()}, depth {depth}, held-out {test_acc}"
        )
    missing = [k for k in hist_kernel.ROUTES if launches[k] == 0]
    if missing:
        raise AssertionError(f"forest fit never launched {missing}")
    log(f"forest: {len(Xf)} x {Xf.shape[1]}, {len(nodes)} trees, depth "
        f"{depth}: first {first:.3f} s, second {second:.3f} s; nodes total "
        f"{int(nodes.sum())}, mean {float(nodes.mean())}; held-out acc "
        f"{test_acc:.6f} ({len(Xh)} rows, predict_proba {predict_s:.3f} s); "
        f"launches {launches}")
    return forest, launches, second


def phase_forest_parity() -> None:
    """A small forest fitted on the card and with ``device="cpu"`` (the
    plain versions): the trees must be identical field for field."""
    from mpitree_tpu_torch.tree import RandomForestClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(20_000, seed=4)
    kw = dict(FOREST, n_estimators=4, max_depth=8)
    gpu = RandomForestClassifier(device="cuda", **kw).fit(X, y).trees_
    cpu = RandomForestClassifier(device="cpu", **kw).fit(X, y).trees_
    fields = ("feature", "threshold", "left", "right", "count",
              "n_node_samples")
    for i, (a, b) in enumerate(zip(gpu, cpu, strict=True)):
        if a.n_nodes != b.n_nodes or not all(
                np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)
                for k in fields):
            raise AssertionError(f"forest tree {i}: cuda tree != cpu tree")
    log(f"forest parity: {len(X)} rows, {len(gpu)} trees depth "
        f"{kw['max_depth']}: cuda trees == cpu trees "
        f"({sum(t.n_nodes for t in gpu)} nodes)")


def _touched(table, cols, X) -> tuple:
    """(distinct nodes on the descent paths of ``X``, distinct leaves
    reached): what a traversal of ``X`` must read of the table."""
    from mpitree_tpu_torch.serving import traversal

    node = traversal.descend(X, *cols, table.n_steps)
    ids = torch.unique(node).cpu().numpy()
    n_leaves = len(ids)
    parent = np.full(table.n_nodes, -1, np.int64)
    inner = np.flatnonzero(table.feature >= 0)
    parent[table.left[inner]] = inner
    parent[table.right[inner]] = inner
    seen = np.zeros(table.n_nodes, bool)
    while ids.size:
        seen[ids] = True
        ids = np.unique(parent[ids])
        ids = ids[ids >= 0]
    return int(seen.sum()), n_leaves


def phase_serve_kernels(forest, Xbig) -> list:
    from mpitree_tpu_torch._device import sm_count
    from mpitree_tpu_torch.serving import quantize, serve_kernel, traversal
    from mpitree_tpu_torch.serving.tables import tables_for

    dev = DEV
    [table] = tables_for(forest.trees_, group_bytes=None)
    cols = table.dev_arrays(dev)[:5]
    record = table.dev_record(dev)
    T, M, C = table.n_trees, table.n_nodes, len(forest.classes_)
    counts = np.concatenate([t.count for t in forest.trees_])
    counts = counts[table.scatter_order()].astype(np.float64)
    rng = np.random.default_rng(0)
    channels = {  # name -> (M, K) float64 values on the card
        "counts": counts,
        "normal": rng.standard_normal((M, C)),
        "normal12": rng.standard_normal((M, 12)),
        "normal1": rng.standard_normal((M, 1)),
    }
    channels = {k: torch.from_numpy(v).to(dev) for k, v in channels.items()}
    channels["proba"] = traversal.normalize_rows(channels["counts"])
    state = quantize.build_state(
        table, quantize.prepare_channel("forest_proba", counts),
        kind="forest_proba", scale=T, n_steps=table.n_steps, tol=1.0,
        device=dev, n_features=Xbig.shape[1],
    )
    qcols = (state.feature, state.threshold, state.left, state.right,
             state.root)
    k4 = (cols, record, 4 + 4 + 4 + 4, 8)
    k5 = (qcols, state.record, 2 + 2 + 4 + 4, 4)
    cases = [  # (form, agg, channel, n_out)
        ("traverse", "sum", "proba", C), ("traverse", "norm", "counts", C),
        ("traverse", "sum", "normal", C), ("traverse", "sum", "normal12", 12),
        ("traverse", "percls", "normal1", C),
        ("traverse", "percls", "normal1", 3),
        ("traverse_q", "sum", "qproba", C),
        ("traverse_q", "percls", "qproba", 3),
    ]
    rows = []
    for N in SERVE_SHAPES:
        X = torch.from_numpy(np.ascontiguousarray(Xbig[:N])).to(dev)
        visited, leaves = _touched(table, cols, X)
        inner = SERVE_INNER[N]
        for form, agg, chan, n_out in cases:
            tcols, rec, node_bytes, acc_bytes = k4 if form == "traverse" \
                else k5
            values = state.qvals if chan == "qproba" else channels[chan]
            kw = dict(n_steps=table.n_steps, agg=agg, n_out=n_out)
            if form == "traverse":
                ref = serve_kernel.traverse_reference
                run = serve_kernel.traverse
            else:
                ref = serve_kernel.traverse_q_reference
                run = serve_kernel.traverse_q
            want = ref(X, *tcols, values, **kw)
            got = run(X, *tcols, values, n_features=X.shape[1], record=rec,
                      **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{form}[{agg}, {chan}] != plain version at N={N} (max "
                    f"|diff| {err})"
                )
            del got
            ms = cuda_ms(lambda: run(X, *tcols, values, n_features=X.shape[1],
                                     record=rec, **kw),
                         reps=5, inner=inner, hold=True)
            plain_ms = cuda_ms(lambda: ref(X, *tcols, values, **kw),
                               reps=3 if N > 4_096 else 5)
            p = serve_kernel.plan(form, N, T, n_out, n_features=X.shape[1],
                                  agg=agg, n_sms=sm_count(dev))
            tiling_ms = {}
            if chan in ("proba", "qproba"):  # the served path
                # every forced tiling equal to plain, and timed
                for R in SERVE_TILINGS:
                    def forced(R=R):
                        return serve_kernel._launch(
                            form, X, tcols, values, rec, **kw,
                            _rows_per_block=R)
                    if not torch.equal(forced(), want):
                        raise AssertionError(
                            f"{form}[{chan}] at {R} rows per block != plain "
                            f"version at N={N}"
                        )
                    tiling_ms[R] = cuda_ms(forced, reps=5, inner=inner,
                                           hold=True)
            del want
            # each input read once, the output written once; of the table
            # only the nodes on this batch's paths and the leaves it reaches
            read = 1 if agg == "percls" else values.shape[1]
            n_bytes = (X.numel() * 4 + visited * node_bytes + T * 4
                       + leaves * read * values.element_size()
                       + N * n_out * acc_bytes)
            rows.append(dict(
                kernel=form, agg=agg, channel=chan, n_out=n_out, rows=N,
                ms=ms, plain_ms=plain_ms,
                bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bytes=n_bytes, visited_nodes=visited, leaves=leaves,
                table_nodes=M, max_abs_err=err, launches_timed=inner,
                plan={k: p[k] for k in ("rows_per_block", "trees_per_chunk",
                                        "threads", "blocks", "smem")},
                tiling_ms=tiling_ms,
            ))
            log(f"serve kernels: {form}[{agg}, {chan}, n_out={n_out}] N={N}: "
                f"kernel {ms:.6f} ms, plain {plain_ms:.4f} ms, bound "
                f"{rows[-1]['bound_ms']:.6f} ms (bytes; {visited} of {M} "
                f"nodes, {leaves} leaves); R={p['rows_per_block']} "
                f"Tc={p['trees_per_chunk']} blocks={p['blocks']}; equal to "
                f"plain" + (f"; rows per block -> ms {tiling_ms}"
                            if tiling_ms else ""))
        del X
    return rows


def phase_serve(forest, Xh, Xbig) -> tuple:
    from mpitree_tpu_torch.serving import ModelRegistry, quantize
    from mpitree_tpu_torch.serving import serve_kernel
    from mpitree_tpu_torch.serving.tables import tables_for

    rng = np.random.default_rng(0)
    for k in serve_kernel.launches:
        serve_kernel.launches[k] = 0
    reg = ModelRegistry()
    stats = {}
    for name, kw in (("rf", {}), ("rf8", {"quantize": "int8"})):
        t0 = time.perf_counter()
        reg.publish(name, forest, **kw)
        publish_s = time.perf_counter() - t0
        lat = {}
        for b, count in REQUESTS:
            times = []
            for _ in range(count):
                lo = int(rng.integers(0, len(Xh) - b + 1))
                t0 = time.perf_counter()
                reg.predict_proba(name, Xh[lo:lo + b])
                times.append(time.perf_counter() - t0)
            ms = np.asarray(times) * 1e3
            lat[b] = dict(p50_ms=float(np.percentile(ms, 50)),
                          p99_ms=float(np.percentile(ms, 99)),
                          requests=count)
        t0 = time.perf_counter()
        out = reg.raw(name, Xbig)
        batch_s = time.perf_counter() - t0
        if out.shape != (len(Xbig), len(forest.classes_)):
            raise AssertionError(f"{name}: batch answer shape {out.shape}")
        stats[name] = dict(publish_s=publish_s, latency=lat,
                           batch_rows=len(Xbig), batch_s=batch_s,
                           rows_per_s=len(Xbig) / batch_s,
                           dispatch=reg.get(name).serve_report_["dispatch"])
        log(f"serve: {name} ({stats[name]['dispatch']}): publish "
            f"{publish_s:.3f} s; " + "; ".join(
                f"bucket {b}: p50 {v['p50_ms']:.4f} ms p99 "
                f"{v['p99_ms']:.4f} ms" for b, v in lat.items())
            + f"; {len(Xbig)} rows in {batch_s:.3f} s = "
            f"{stats[name]['rows_per_s']:.1f} rows/s")
    launches = dict(serve_kernel.launches)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"serving never launched {missing}")

    Xc = Xh[:4_096]
    want = forest.predict_proba(Xc)
    got = reg.predict_proba("rf", Xc)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"served rf != forest.predict_proba (max |diff| "
            f"{np.abs(got - want).max()})"
        )
    rep = reg.get("rf8").serve_report_["quantization"]
    [table] = tables_for(forest.trees_, group_bytes=None)
    cal = quantize.synthesize_calibration(table, Xh.shape[1])
    cal_delta = float(np.abs(reg.raw("rf8", cal) - reg.raw("rf", cal)).max())
    # the report compares float32 sums on the host; the served int32 lattice
    # sum and the float64 answer differ from those by float32 rounding
    if not (rep["ok"] and cal_delta <= rep["max_abs_delta"] + 1e-6):
        raise AssertionError(
            f"rf8 outside its exactness report: delta {cal_delta} on the "
            f"calibration batch, report {rep}"
        )
    q = reg.predict_proba("rf8", Xc)
    held_delta = float(np.abs(q - want).max())
    agree = float(np.mean(q.argmax(axis=1) == want.argmax(axis=1)))
    log(f"serve: rf == forest.predict_proba bit for bit on {len(Xc)} "
        f"held-out rows; rf8 calibration delta {cal_delta} <= report "
        f"max_abs_delta {rep['max_abs_delta']} (tolerance "
        f"{rep['tolerance']}); rf8 on held-out rows: max |delta| "
        f"{held_delta}, argmax agreement {agree}; launches {launches}")
    stats["rf8"].update(quantization=rep, calibration_delta=cal_delta,
                        heldout_max_delta=held_delta,
                        heldout_argmax_agreement=agree)
    return stats, launches


def phase_profile(name: str, work, out_dir: Path) -> None:
    """Run ``work()`` once more under torch.profiler: device time by kernel
    and the device's busy share of the wall-clock; the table goes to
    ``out_dir/profile_<name>.txt``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time_total for e in events)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{name}.txt").write_text(table)
    by_name: dict = {}
    by_kind: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
        kind = next((k for k, keys in PROFILE_KINDS if any(
            s in e.name for s in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(f"profile {name}: " + json.dumps({
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall if wall else None,
        "device_kernels": len(events),
        "hist_launches": sum("hist_tile_kernel" in e.name for e in events),
        "d2h_copies": sum("DtoH" in e.name for e in events),
        "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
        "top_device_ms": {k[:90]: v / 1e3 for k, v in top},
    }))


def profile_all(X, y, forest, Xh, out_dir: Path) -> None:
    """``--profile``: one more depth-20 fit, one more forest fit, and 300
    one-row requests to each of a freshly published ``rf`` and ``rf8``,
    each profiled."""
    from mpitree_tpu_torch.serving import ModelRegistry
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        RandomForestClassifier,
    )

    phase_profile("fit", lambda: DecisionTreeClassifier(
        criterion="entropy", max_depth=DEPTH, max_bins=256).fit(X, y),
        out_dir)
    phase_profile("forest", lambda: RandomForestClassifier(**FOREST).fit(
        X[:FOREST_ROWS], y[:FOREST_ROWS]), out_dir)
    reg = ModelRegistry()
    reg.publish("rf", forest)
    reg.publish("rf8", forest, quantize="int8")

    for name in ("rf", "rf8"):
        def requests(name=name):
            for i in range(REQUESTS[0][1]):
                reg.predict_proba(name, Xh[i:i + 1])

        phase_profile(f"serve_b1_{name}", requests, out_dir)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="profile one more tree fit, forest fit and 300 "
                    "one-row requests to rf and to rf8; tables go to DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import mpitree_tpu_torch  # noqa: F401  (fails outside a checkout)
    from mpitree_tpu_torch.core.builder import BuildConfig, _chunk_size
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.ops.binning import bin_dataset_torch
    from mpitree_tpu_torch.serving import serve_kernel
    from mpitree_tpu_torch.utils.datasets import covtype_like

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    phase_build()

    X, y = covtype_like(ROWS, seed=0)
    Xh, yh = covtype_like(50_000, seed=1)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    binned = bin_dataset_torch(X, max_bins=256, binning="auto", device=dev)
    torch.cuda.synchronize()
    log(f"binning: {ROWS} x {X.shape[1]} on the card in "
        f"{time.perf_counter() - t0:.3f} s, n_bins {binned.n_bins}")
    K = _chunk_size(ROWS, X.shape[1], binned.n_bins, 7,
                    BuildConfig(max_depth=DEPTH))
    y_d = torch.from_numpy(y).to(dev)
    shapes = phase_kernels(binned.x_binned, y_d, binned.n_bins, K,
                           [int(v) + 1 for v in binned.n_cand])
    del binned, y_d
    torch.cuda.empty_cache()

    _, launches, _ = phase_fit(X, y, Xh, yh, DEPTH)
    phase_parity()
    forest, forest_launches, _ = phase_forest(X, y, Xh, yh)
    phase_forest_parity()
    Xbig, _ = covtype_like(SERVE_SHAPES[-1], seed=3)
    serve_shapes = phase_serve_kernels(forest, Xbig)
    serving, serve_launches = phase_serve(forest, Xh, Xbig)
    if args.profile:
        profile_all(X, y, forest, Xh, args.profile)

    kernels = []
    for route, S in REPRESENTATIVE.items():
        row = next(r for r in shapes
                   if r["route"] == route and r["S"] == (S or K))
        kernels.append(dict(
            name=f"hist_{route}[S={row['S']}]", route="cuda",
            source="mpitree_tpu_torch/csrc/histogram.cu",
            replaces=REPLACES[route], launches=launches[route],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            kernel_ms=row["kernel_ms"], sort_ms=row["sort_ms"],
            bound_int32_ms=row["bound_int32_ms"],
            forest_launches=forest_launches[route],
        ))
    for form, (agg, chan) in SERVE_LINE.items():
        row = next(r for r in serve_shapes if r["kernel"] == form
                   and r["agg"] == agg and r["channel"] == chan
                   and r["rows"] == 4_096)
        kernels.append(dict(
            name=f"serve_{form}[agg={agg}]", route="cuda",
            source="mpitree_tpu_torch/csrc/traverse.cu",
            replaces="mpitree_tpu/serving/pallas_serve.py:49",
            launches=serve_launches[form], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None,
            library="none: no single PyTorch call computes an ensemble "
                    "traversal",
            by_rows={r["rows"]: {k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "max_abs_err")}
                for r in serve_shapes if r["kernel"] == form
                and r["agg"] == agg and r["channel"] == chan},
        ))
    if (set(hist_kernel.ROUTES) != set(REPRESENTATIVE)
            or set(serve_kernel.launches) != set(SERVE_LINE)):
        raise AssertionError("kernels line does not cover every kernel")
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernel_shapes": shapes}))
    log(json.dumps({"serve_kernel_shapes": serve_shapes}))
    log(json.dumps({"serving": serving}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
