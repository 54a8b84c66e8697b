#!/usr/bin/env python3
"""A/B of the fixed-point histogram route on the card: this checkout
against another (a parent commit unpacked beside it).

    python3 fixed_hist_ab.py --parent DIR [--e2e] [--out FILE]

Runs one worker process per checkout in the order parent, change, change,
parent; each imports ``mpitree_tpu_torch`` from its checkout, builds its
kernels there, and

- (kernels) at ``chip_smoke.py`` phase 12's cases (``FIXED_CASES``, its
  payloads, slots and byte bound, imported from this checkout's
  ``chip_smoke.py``) holds the fixed-point routes ``torch.equal`` to the
  plain version and to a second launch, and times each (CUDA events
  behind a device-side hold, medians of 7): the planned route on
  byte-wide bins (a sorted route with its sort), the sorted kernel alone
  on presorted rows, and every candidate the checkout's planner offers
  (``threads``, ``adds``; for the stream route half and twice the planned
  blocks); then compares the integer routes' SASS (``hist_tile_kernel``)
  across the checkouts;
- (``--e2e``) fits the estimators whose launches the route carries
  (``chip_smoke.py`` phases 13, 15, 17, 21, 25 and 26), twice where a fit
  takes seconds, and records the walls, the fixed-point launches and each
  model's fingerprint; fails unless every fingerprint is the same in all
  four runs.

Prints the card's name and power limit and writes every measurement to
``--out`` (JSON). Exits 1 without a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (by path: a worker's
    ``sys.path`` starts with the other checkout, which has its own)."""
    spec = importlib.util.spec_from_file_location(
        "fixed_ab_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _candidates(hk, p: dict, route: str, N: int) -> dict:
    """The candidates the checkout's planner offers at this shape, by
    name -> ``_tune``: each other block size of ``FIXED_SHAPES``, each
    other ``FIXED_ADDS``, and (stream) half and twice the planned blocks.
    A planner without the knobs offers none."""
    knobs = inspect.signature(hk.plan).parameters
    out = {}
    if "threads" in knobs:
        for nt in sorted({nt for _, nt in hk.FIXED_SHAPES[route]}):
            if nt != p["threads"]:
                out[f"threads={nt}"] = dict(threads=nt)
        if route == "stream":
            for blocks in (p["n_blocks"] // 2, p["n_blocks"] * 2):
                rows = -(-N // max(1, blocks))
                out[f"blocks={blocks}"] = dict(
                    piece_rows=-(-rows // 32) * 32)
    if "adds" in knobs:
        for adds in hk.FIXED_ADDS:
            if adds != p["adds"]:
                out[f"adds={adds}"] = dict(adds=adds)
    return out


def kernels_worker(out: Path) -> None:
    import torch

    from mpitree_tpu_torch import _build
    from mpitree_tpu_torch.core.builder import BuildConfig, _chunk_size
    from mpitree_tpu_torch.ops import hist_kernel as hk
    from mpitree_tpu_torch.ops.binning import bin_dataset_torch
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    cs = _chip_smoke()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    X, y = covtype_like(cs.ROWS, seed=0)
    Xc, yc = california_like(cs.CAL_ROWS, seed=0)
    cov = bin_dataset_torch(X, max_bins=256, binning="auto", device=dev)
    cal = bin_dataset_torch(Xc, max_bins=256, binning="auto", device=dev)
    y_cal = torch.from_numpy((yc - yc.mean()).astype(np.float32)).to(dev)
    rng = np.random.default_rng(12)
    cases = cs.fixed_payloads(cov, torch.from_numpy(y).to(dev), cal, y_cal,
                              rng)
    rows = []
    for name, widths, share in cs.FIXED_CASES:
        binned, payload = cases[name]
        xb = binned.x_binned
        N, F = xb.shape
        B, C = binned.n_bins, payload.shape[1]
        fb = [int(v) + 1 for v in binned.n_cand]
        se = hk.fixed_point_exponents(payload)
        packed = hk.pack_bins(xb, B)
        K = _chunk_size(N, F, B, C, BuildConfig(max_depth=cs.DEPTH),
                        cell_bytes=8)
        for S in cs.fixed_widths(widths, K):
            slot = torch.from_numpy(cs._slots(rng, N, S, share)).to(dev)
            want = hk.histogram_reference(xb, payload, slot, n_slots=S,
                                          n_bins=B, scale_exp=se)
            order, seg = hk.slot_segments(slot, S)
            p = hk.plan(S, F, C, B, feat_bins=fb, n_rows=N, fixed=True)
            route = p["route"]
            presorted = dict(order=order, seg_start=seg) \
                if route == "sorted" else {}
            runs = {"route": ({}, {})}
            if route == "sorted":
                runs["kernel"] = ({}, presorted)
            for cname, tune in _candidates(hk, p, route, N).items():
                runs[f"{route}:{cname}"] = (tune, presorted)
            ms = {}
            for rname, (tune, pre) in runs.items():
                def run(tune=tune, pre=pre):
                    return hk.histogram_cuda(
                        xb, payload, slot, n_slots=S, n_bins=B,
                        packed=packed, feat_bins=fb, scale_exp=se,
                        _variant=route, _tune=tune or None, **pre)
                got, again = run(), run()
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(again, got)):
                    raise AssertionError(
                        f"{name} S={S} {rname}: kernel != plain version or "
                        f"!= its second launch (max |diff| "
                        f"{int((got - want).abs().max())})")
                del got, again
                ms[rname] = cs.cuda_ms(run, hold=True)
            n_in = int(((slot >= 0) & (slot < S)).sum())
            n_bytes = cs.fixed_bytes(N, n_in, packed.shape[1], C, S, F, B,
                                     route)
            rows.append(dict(payload=name, S=S, live_share=share, F=F, C=C,
                             route=route, rows_in_range=n_in,
                             bound_ms=n_bytes / cs.HBM_BYTES_PER_S * 1e3,
                             ms=ms))
            print(f"{name} S={S} 1/{share} {route}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
                  flush=True)
            del want, order, seg, slot
        del packed
    out.write_text(json.dumps(dict(build_s=build_s, shapes=rows,
                                   sass=_integer_sass())))


def _integer_sass() -> dict:
    """The integer routes' kernels in this checkout's built histogram
    library (``cuobjdump -sass``), instruction text only: addresses and
    encodings dropped, constant-bank parameter offsets masked."""
    from mpitree_tpu_torch import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass",
                           str(_build._library_path("histogram"))],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            # <bins, sorted>, or <bins, sorted, fixed> where the integer
            # body still carried the fixed-point mode
            m = re.search(r"hist_tile_kernelI(\w)Lb([01])E(?:Lb([01])E)?E",
                          line)
            cur = f"{m.group(1)}/{m.group(2)}" if m and m.group(3) != "1" \
                else None
            if cur:
                out[cur] = []
            continue
        ins = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if cur and ins:
            out[cur].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]",
                                   ins.group(1)).strip())
    return out


def _fingerprint(est) -> str:
    """A hash of every tree's arrays, leaf values included: equal only for
    equal models."""
    h = hashlib.sha256()
    for t in getattr(est, "trees_", None) or [est.tree_]:
        for k in ("feature", "threshold", "left", "right", "value"):
            h.update(np.ascontiguousarray(getattr(t, k)).tobytes())
    return h.hexdigest()[:16]


def e2e_worker(out: Path) -> None:
    import torch

    from mpitree_tpu_torch import _build
    from mpitree_tpu_torch.ops import hist_kernel as hk
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        DecisionTreeRegressor,
        ExtraTreesRegressor,
        GradientBoostingClassifier,
        GradientBoostingRegressor,
        RandomForestRegressor,
    )
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    cs = _chip_smoke()
    _build.build_all()
    X, y = covtype_like(cs.ROWS, seed=0)
    Xc, yc = california_like(cs.CAL_ROWS, seed=0)
    w = cs.weights(cs.ROWS)
    yb = (y == int(np.bincount(y).argmax())).astype(np.int64)
    reg_forest = dict(cs.REG_FOREST, refine_depth=None)
    # (name, make, X, y, fit kwargs, fits): chip_smoke.py's phases; a
    # boosted fit runs once more at 2 rounds first, as phases 21 and 26 do
    fits = (
        ("13 regressor", lambda: DecisionTreeRegressor(
            max_depth=20, max_bins=256, refine_depth=None), Xc, yc, {}, 2),
        ("15 weighted", lambda: DecisionTreeClassifier(
            criterion="entropy", max_depth=20, max_bins=256,
            refine_depth=None), X, y, dict(sample_weight=w), 2),
        ("17 random forest regressor", lambda: RandomForestRegressor(
            **reg_forest, oob_score=True), Xc, yc, {}, 1),
        ("17 extra trees regressor", lambda: ExtraTreesRegressor(
            **reg_forest), Xc, yc, {}, 1),
        ("21/26 GradientBoostingRegressor(), K = 8 (auto)",
         lambda: GradientBoostingRegressor(max_iter=100), Xc, yc, {}, 2),
        ("21 GradientBoostingClassifier()",
         lambda: GradientBoostingClassifier(max_iter=100), X, y, {}, 1),
        ("25 regressor, 255 leaves", lambda: DecisionTreeRegressor(
            max_leaf_nodes=255, max_bins=256), Xc, yc, {}, 2),
        ("26 GradientBoostingClassifier(max_leaf_nodes=31), K = 8",
         lambda: GradientBoostingClassifier(max_iter=100, max_leaf_nodes=31,
                                            rounds_per_dispatch=8),
         X, yb, {}, 2),
    )
    res = {}
    for name, make, Xd, yd, kw, n in fits:
        if "Boosting" in name:
            warm = make()
            warm.max_iter = 2
            warm.fit(Xd, yd)
        walls, prints = [], set()
        for _ in range(n):
            for k in hk.launches:
                hk.launches[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est = make().fit(Xd, yd, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            prints.add(_fingerprint(est))
        if len(prints) != 1:
            raise AssertionError(f"{name}: fits differ: {prints}")
        launches = {k: v for k, v in hk.launches.items() if v}
        if set(launches) - set(hk.FIXED_ROUTES):
            raise AssertionError(f"{name}: left the fixed-point routes: "
                                 f"{launches}")
        res[name] = dict(walls_s=walls, fingerprint=prints.pop(),
                         launches=launches)
        print(f"{name}: walls {walls}, launches {launches}", flush=True)
        del est
    out.write_text(json.dumps(res))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=False,
                    help="root of the other checkout")
    ap.add_argument("--e2e", action="store_true",
                    help="fit the estimators instead of timing kernels")
    ap.add_argument("--out", type=Path, default=Path("fixed_hist_ab.json"))
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fixed_hist_ab: no CUDA card", file=sys.stderr)
        return 1
    if args.worker:
        root = Path(args.worker[0]).resolve()
        sys.path.insert(0, str(root))
        import mpitree_tpu_torch

        if not Path(mpitree_tpu_torch.__file__).resolve().is_relative_to(
                root):
            raise RuntimeError(f"imported {mpitree_tpu_torch.__file__}, "
                               f"not the package under {root}")
        (e2e_worker if args.e2e else kernels_worker)(Path(args.worker[1]))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    card = _chip_smoke().card_line()
    parent = args.parent.resolve()
    out_path = args.out.resolve()
    order = (("parent", parent), ("change", HERE), ("change", HERE),
             ("parent", parent))
    runs = []
    for i, (who, root) in enumerate(order):
        part = out_path.with_suffix(f".{i}.json")
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(root), str(part)] + (["--e2e"] if args.e2e else [])
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, cwd=root)
        runs.append(dict(who=who, root=str(root),
                         wall_s=time.perf_counter() - t0,
                         result=json.loads(part.read_text())))
    if args.e2e:
        prints = {name: {r["result"][name]["fingerprint"] for r in runs}
                  for name in runs[0]["result"]}
        differ = {k: sorted(v) for k, v in prints.items() if len(v) != 1}
        if differ:
            raise AssertionError(f"models differ between the checkouts: "
                                 f"{differ}")
        print(f"every model's fingerprint equal in all {len(runs)} runs")
    else:
        sass = [r["result"]["sass"] for r in runs]
        same = all(s == sass[0] for s in sass)
        print(f"integer-route SASS equal across checkouts (parameter "
              f"offsets masked): {same}; instructions "
              f"{ {k: len(v) for k, v in sass[0].items()} }")
        for r in runs:
            r["result"]["sass"] = {k: len(v) for k, v in
                                   r["result"]["sass"].items()}
        runs.append(dict(integer_sass_equal=same))
    out_path.write_text(json.dumps(dict(card=card, runs=runs)))
    print(card)
    print(json.dumps({"ok": True, "out": str(out_path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
