"""Quantile binning, plainly.

Per feature: the sorted column's distinct values; while a column has at
most ``max_bins`` of them, every distinct value but the largest is a
candidate split (``x <= edge``); otherwise the candidates are the
distinct values among the sorted column's entries at
``floor((n - 1) * q / max_bins)``, ``q = 1 .. max_bins - 1`` (the
positions computed in float64 on the host). A value's bin is the number
of candidates below it (``searchsorted``, left side), so ``bin <= b``
holds exactly when ``x <= edge[b]``. The table is padded with ``+inf``
to ``n_bins - 1`` columns, ``n_bins`` being one more than the most
candidates any feature has.
"""

from __future__ import annotations

import numpy as np
import torch


def quantile_positions(n: int, max_bins: int) -> np.ndarray:
    q = np.arange(1, max_bins, dtype=np.float64) / max_bins
    return np.floor((n - 1) * q).astype(np.int64)


def bin_columns(X: np.ndarray, max_bins: int, device) -> dict:
    """``X`` (N, F) float32 on the host -> ``{"edges": [per-feature
    float32 tensors], "n_cand": (F,) int64, "n_bins": int, "thresholds":
    (F, n_bins - 1) float32 with +inf padding, "xb": (N, F) uint8}``, all
    tensors on ``device``."""
    N, F = X.shape
    pos = torch.from_numpy(quantile_positions(N, max_bins)).to(device)
    xb = torch.empty((N, F), dtype=torch.uint8, device=device)
    edges = []
    for f in range(F):
        col = torch.from_numpy(np.ascontiguousarray(X[:, f])).to(device)
        srt = torch.sort(col).values
        uniq = torch.unique_consecutive(srt)
        if uniq.numel() <= max_bins:
            e = uniq[:-1]
        else:
            e = torch.unique_consecutive(srt[pos])
        edges.append(e)
        xb[:, f] = torch.searchsorted(e, col, side="left").to(torch.uint8)
    n_cand = torch.tensor([e.numel() for e in edges], dtype=torch.int64)
    n_bins = int(n_cand.max()) + 1
    thr = torch.full((F, max(n_bins - 1, 1)), float("inf"),
                     dtype=torch.float32, device=device)
    for f, e in enumerate(edges):
        thr[f, :e.numel()] = e
    return {"edges": edges, "n_cand": n_cand.to(device), "n_bins": n_bins,
            "thresholds": thr, "xb": xb}
