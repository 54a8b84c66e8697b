"""The benchmark's fixed arithmetic: peaks, the work a fit needs, and the
rule that names kernels in a trace.

- ``PEAKS``: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
  limit): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of
  HBM3. The run's line records the card's name and power limit beside
  every share of these.
- ``hist_launch_cost``: a frozen copy of ``obs/cost.hist_launch_cost``
  from ``mpitree_tpu_torch`` as it stood when the benchmark was defined.
- ``PROFILE_KINDS``: a frozen copy of ``chip_smoke.py``'s rule that
  sorts device operations into kinds by substrings of their names.
- ``fit_work``: the least histogram and split-search work of a fitted
  model, counted from its own per-node row counts (below).
"""

from __future__ import annotations

import numpy as np

PEAKS = {"flops_f32": 67e12, "hbm_bytes_per_s": 3.35e12}

HIST_TILE_KERNELS = ("hist_tile_kernel", "fixed_tile_kernel")
PROFILE_KINDS = (
    ("histogram kernels", HIST_TILE_KERNELS + ("hist_zero_split_kernel",)),
    ("traversal kernels", ("traverse_kernel",)),
    ("copies", ("Memcpy", "memcpy", "Memset")),
    ("sort/search (binning, level order)",
     ("sort", "Sort", "radix", "Radix", "searchsorted")),
    ("float64 sweep", ("double",)),
)


def kind_of(name: str) -> str:
    return next((k for k, keys in PROFILE_KINDS
                 if any(s in name for s in keys)), "other")


def hist_launch_cost(*, n_rows: int, rows_in: float, n_features: int,
                     n_channels: int, n_bins: int, n_slots: int,
                     cell: int, packed_width: int,
                     sorted_route: bool) -> dict:
    """One histogram launch: ``n_rows`` slot ids read, ``rows_in`` rows
    in range (their byte-wide bins and float32 payload), the sorted
    route's order and segment offsets, and the (S, F, C, B) output
    written once; one add per (row in range, feature)."""
    out = int(n_slots) * n_features * n_channels * n_bins * int(cell)
    b = n_rows * 4 + rows_in * (packed_width + n_channels * 4) + out
    if sorted_route:
        b += rows_in * 4 + (int(n_slots) + 1) * 4
    return {"flops": float(rows_in * n_features), "bytes": float(b)}


def _needs(tree: dict, max_depth: int) -> tuple:
    """``(rows counted, histograms accumulated, histograms searched)`` of
    one tree. Every node above ``max_depth`` is searched for a split, so
    its histogram is read once; only the root's and, below each split,
    the smaller child's are accumulated from rows (the larger child's is
    the parent's less the smaller's), each written once."""
    depth, left, right, rows = (tree[k] for k in ("depth", "left", "right",
                                                 "rows"))
    need = depth < max_depth
    inner = np.flatnonzero((left >= 0))
    inner = inner[need[left[inner]]]
    counted = float(rows[0]) + float(np.minimum(
        rows[left[inner]], rows[right[inner]]).sum())
    return counted, 1 + len(inner), int(need.sum())


def fit_work(trees: list, *, max_depth: int, n_features: int,
             n_channels: int, n_bins: int, cell: int) -> dict:
    """The least work of a fit whose fitted trees are ``trees`` (dicts of
    numpy ``depth``, ``left``, ``right`` and ``rows``, each node's row
    count): ``{"hist": {"flops", "bytes"}, "sweep": {...}}``.

    Histograms: per counted row its slot id, each feature's byte-wide
    bin and its float32 payload read once, one add per feature, and each
    accumulated histogram written once (``hist_launch_cost``). Split
    search: each searched histogram read once, and per (feature, bin,
    class) two operations, one for each side."""
    rows_in = acc = searched = 0.0
    for t in trees:
        r, a, s = _needs(t, max_depth)
        rows_in += r
        acc += a
        searched += s
    hist = hist_launch_cost(
        n_rows=rows_in, rows_in=rows_in, n_features=n_features,
        n_channels=n_channels, n_bins=n_bins, n_slots=acc, cell=cell,
        packed_width=n_features, sorted_route=False)
    slab = n_features * n_channels * n_bins
    sweep = {"flops": 2.0 * searched * slab,
             "bytes": float(searched * slab * cell)}
    return {"hist": hist, "sweep": sweep}


def least_seconds(work: dict) -> float:
    """The larger of operations over the float32 peak and bytes over the
    HBM peak."""
    return max(work["flops"] / PEAKS["flops_f32"],
               work["bytes"] / PEAKS["hbm_bytes_per_s"])
