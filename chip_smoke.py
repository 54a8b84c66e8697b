#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also profile one fit (torch.profiler)

Phases, in order; any failure raises and exits non-zero:

1. build: compile ``mpitree_tpu_torch/csrc/histogram.cu`` with ``nvcc``
   for ``sm_90a`` into ``build/``.
2. kernels: bin ``covtype_like(581_012, seed=0)`` (256 bins) on the card;
   for S in {1, 8, 64, 128, 512, K} (K the fit's chunk width) spread the
   rows over S slots (some slots empty, some rows at -1) with class
   payloads, hold every histogram kernel variant whose tile fits that
   width ``torch.equal`` to the plain version and time it, and time the
   plain version and one library call (``index_put_(...,
   accumulate=True)`` over prebuilt flat ids) beside the least time the
   card could take.
3. fit: ``DecisionTreeClassifier(criterion="entropy", max_depth=20,
   max_bins=256)`` on the full matrix, twice; the launch counters are set
   to 0 just before the second fit and read just after it, and every
   variant must have launched.
4. parity: ``covtype_like(50_000, seed=2)`` at ``max_depth=10`` on the
   card and with ``device="cpu"`` (the plain versions): the trees must be
   identical field for field, or differ first at a node whose two
   candidate float64 costs are within 1e-12 relative (an exact-tie
   residual: CUDA's and glibc's fp64 ``log`` may differ by an ulp).

The last line of standard output is ``{"ok": true, "device": {...}}``;
the card's name and power limit, one JSON line of per-shape kernel
timings (``kernel_shapes``) and one ``kernels`` line come before it.
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
ROWS, DEPTH = 581_012, 20  # covtype's rows; the BASELINE fit's depth
# One shape per variant for the "kernels" line: small's one width (the
# root level) and wide at S=K, the width of the deep levels.
REPRESENTATIVE = {"small": 1, "wide": None}
# Device kernels of a profiled fit, grouped by what they serve (first match).
PROFILE_KINDS = (
    ("histogram kernels", ("hist_small_kernel", "hist_wide_kernel")),
    ("copies", ("Memcpy", "memcpy", "Memset")),
    ("binning sort/search", ("sort", "Sort", "radix", "searchsorted")),
    ("float64 sweep", ("double",)),
)
REPLACES = {
    "small": "mpitree_tpu/ops/pallas_hist.py:77",
    "wide": "mpitree_tpu/ops/wide_hist.py:252",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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
    _build.load("histogram")
    log(f"build: csrc/histogram.cu in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.nvcc_path()})")


def _slots(rng, N: int, S: int) -> np.ndarray:
    """Rows spread over S slots, about 1/8 of the slots left empty and 10%
    of the rows parked at -1."""
    live = np.sort(rng.choice(S, size=max(1, S - S // 8), replace=False))
    slot = live[rng.integers(0, len(live), N)].astype(np.int32)
    slot[rng.random(N) < 0.1] = -1
    return slot


def phase_kernels(xb, y_d, B: int, K: int) -> list:
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.ops.histogram import class_payload

    N, F = xb.shape
    C = 7
    payload = class_payload(y_d, None, C).contiguous()
    rng = np.random.default_rng(0)
    feat = torch.arange(F, device=xb.device, dtype=torch.int64)
    rows = []
    for S in sorted(set(SLOT_TIERS + (K,))):
        slot = torch.from_numpy(_slots(rng, N, S)).to(xb.device)
        variant = hist_kernel.plan(S, F, C, B)["variant"]
        want = hist_kernel.histogram_reference(xb, payload, slot,
                                               n_slots=S, n_bins=B)
        torch.cuda.synchronize()
        # Every variant whose tile fits this width, the planned one first:
        # each is held equal to the plain version and timed, so the plan's
        # choice is checked against the others on every run.
        alt_ms = {}
        others = [v for v in hist_kernel.launches if v != variant]
        for v in [variant] + others:
            try:
                hist_kernel.plan(S, F, C, B, v)
            except ValueError:
                continue
            got = hist_kernel.histogram_cuda(xb, payload, slot, n_slots=S,
                                             n_bins=B, _variant=v)
            torch.cuda.synchronize()
            diff = float((got - want).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{v} kernel != plain version at S={S} (max |diff| "
                    f"{diff})"
                )
            if v == variant:
                err = diff
            del got
            alt_ms[v] = cuda_ms(lambda v=v: hist_kernel.histogram_cuda(
                xb, payload, slot, n_slots=S, n_bins=B, _variant=v))
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

        ms = alt_ms[variant]
        plain_ms = cuda_ms(lambda: hist_kernel.histogram_reference(
            xb, payload, slot, n_slots=S, n_bins=B), reps=5)
        library_ms = cuda_ms(library, reps=5)
        del ids, vals, r, cls

        n_bytes = N * 4 + n_in * (F * 4 + C * 4) + S * F * C * B * 4
        n_ops = n_in * F  # one add per (row, feature): one nonzero channel
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
        rows.append(dict(
            S=S, variant=variant, rows_in_range=n_in, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=err, variant_ms=alt_ms,
        ))
        log(f"kernels: S={S} {variant}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, index_put_ {library_ms:.4f} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); "
            f"every variant equal to plain, ms {alt_ms}")
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"fit never launched kernel variants {missing}")
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


def phase_profile(X, y, depth: int, out_dir: Path) -> None:
    """One more depth-``depth`` fit under torch.profiler: device time by
    kernel and the device's busy share of the wall-clock."""
    from torch.profiler import ProfilerActivity, profile

    from mpitree_tpu_torch.tree import DecisionTreeClassifier

    clf = DecisionTreeClassifier(criterion="entropy", max_depth=depth,
                                 max_bins=256)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clf.fit(X, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time_total for e in events)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_fit.txt").write_text(table)
    by_name: dict = {}
    by_kind: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
        kind = next((k for k, keys in PROFILE_KINDS if any(
            s in e.name for s in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log("profile: " + json.dumps({
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall if wall else None,
        "device_kernels": len(events),
        "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
        "top_device_ms": {k[:90]: v / 1e3 for k, v in top},
    }))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra fit; table in chiprun_out/")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import mpitree_tpu_torch  # noqa: F401  (fails outside a checkout)
    from mpitree_tpu_torch.core.builder import BuildConfig, _chunk_size
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.ops.binning import bin_dataset_torch
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
    shapes = phase_kernels(binned.x_binned, y_d, binned.n_bins, K)
    del binned, y_d
    torch.cuda.empty_cache()

    _, launches, _ = phase_fit(X, y, Xh, yh, DEPTH)
    phase_parity()
    if args.profile:
        phase_profile(X, y, DEPTH, Path("chiprun_out"))

    kernels = []
    for variant, S in REPRESENTATIVE.items():
        row = next(r for r in shapes
                   if r["variant"] == variant and r["S"] == (S or K))
        kernels.append(dict(
            name=f"hist_{variant}[S={row['S']}]", route="cuda",
            source="mpitree_tpu_torch/csrc/histogram.cu",
            replaces=REPLACES[variant], launches=launches[variant],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
        ))
    if set(hist_kernel.launches) != set(REPRESENTATIVE):
        raise AssertionError("kernels line does not cover every variant")
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernel_shapes": shapes}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
