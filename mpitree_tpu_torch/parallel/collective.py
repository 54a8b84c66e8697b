"""Single-device level steps: split search, terminal counts, row reroute.

Counterpart of the one-device case of ``mpitree_tpu/parallel/collective.py``.
With one GPU the histogram ``psum`` over the data axis is the identity, so
no mesh code is ported; each step is a plain function on tensors that live
on the fit's device:

- :func:`split_step` (``make_split_fn``, ``:268``; regression
  ``:470-502``): the frontier chunk's ``(S, F, C, B)`` histogram (the
  Hopper kernel on CUDA tensors, ``ops/hist_kernel.py``) followed by the
  split sweep, packed into one buffer so a level costs one device-to-host
  copy: float32 on the integer route, float64 on the fixed-point route,
  whose node statistics are exact sums;
- :func:`node_sums` (``node_counts_local``, ``:81``): per-slot payload
  sums (class counts or regression moments) for terminal levels, an O(N)
  scatter instead of the O(N*F) histogram, exact in int64 on both routes;
- :func:`y_range` (``regression_y_range``, ``:117``): the per-slot
  ``max(y) - min(y)`` that regression's purity stop reads;
- :func:`update_node_id` (``make_update_fn``, ``:752``): rows of splitting
  nodes move to a child by ``bin(x[:, feat]) <= bin`` (left) or not
  (right); every other row keeps its node id.

The reroute and the counts are XLA code outside any Pallas kernel in the
JAX package, and stay plain torch operations here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mpitree_tpu_torch.ops import histogram as hist_ops
from mpitree_tpu_torch.ops import impurity as imp_ops
from mpitree_tpu_torch.ops.hist_kernel import dequantize


def pack_decision(dec: imp_ops.SplitDecision,
                  dtype=torch.float32) -> torch.Tensor:
    """SplitDecision -> one (K, 7 + C) buffer (feature, bin, cost,
    impurity, n, constant, n_left, counts...), the columns of the JAX
    package's ``_pack_decision``; with a ``y_range`` (regression) it
    follows ``n_left``. float32 on the integer route: feature/bin/constant
    are exact below 2**24, as are the integer-valued counts. float64 on the
    fixed-point route, whose float64 node statistics it keeps whole."""
    cols = [dec.feature, dec.bin, dec.cost, dec.impurity, dec.n,
            dec.constant, dec.n_left]
    if dec.y_range is not None:
        cols.append(dec.y_range)
    head = torch.stack([c.to(dtype) for c in cols], dim=1)
    return torch.cat([head, dec.counts.to(dtype)], dim=1)


def unpack_decision(packed: np.ndarray, n_counts: int) -> dict:
    """Host-side inverse of :func:`pack_decision` (numpy dict); columns
    keep the buffer's dtype. ``n_counts`` is the counts' width; a head
    wider than 7 columns holds ``y_range``."""
    n_head = packed.shape[1] - n_counts
    out = {
        "feature": packed[:, 0].astype(np.int32),
        "bin": packed[:, 1].astype(np.int32),
        "cost": packed[:, 2],
        "impurity": packed[:, 3],
        "n": packed[:, 4],
        "constant": packed[:, 5] > 0,
        "n_left": packed[:, 6],
        "counts": packed[:, n_head:],
    }
    if n_head > 7:
        out["y_range"] = packed[:, 7]
    return out


def split_step(x_binned: torch.Tensor, payload: torch.Tensor,
               node_id: torch.Tensor, cand_mask: torch.Tensor,
               chunk_lo: int, *, n_slots: int, n_bins: int, criterion: str,
               min_child_weight: float, packed: torch.Tensor | None = None,
               order: torch.Tensor | None = None,
               seg_start: torch.Tensor | None = None,
               feat_bins=None, scale_exp=None, task: str = "classification",
               y: torch.Tensor | None = None) -> torch.Tensor:
    """Histogram + split sweep for the frontier chunk of ``n_slots`` nodes
    starting at node id ``chunk_lo``; returns the packed decision buffer.

    ``x_binned`` (N, F) int32, ``payload`` (N, C) float32 (``w *
    onehot(y)``, or regression's ``(w, w*y, w*y^2)``), ``node_id`` (N,)
    int32, ``cand_mask`` (F, B) bool, all on one device. ``scale_exp``
    selects the fixed-point route (always taken for ``task="regression"``,
    which also needs ``y``, the (N,) float32 targets, for the purity
    signal). ``packed`` (the fit's byte-wide copy of the bins), ``order``
    and ``seg_start`` (the level's rows ordered by node, and this chunk's
    ``n_slots + 1`` segment offsets into that order) and ``feat_bins`` go
    to the histogram as they are (``ops/hist_kernel.histogram``).
    """
    slot = (node_id - chunk_lo).to(torch.int32)
    hist = hist_ops.histogram(x_binned, payload, slot, n_slots=n_slots,
                              n_bins=n_bins, packed=packed, order=order,
                              seg_start=seg_start, feat_bins=feat_bins,
                              scale_exp=scale_exp)
    if task == "regression":
        dec = imp_ops.best_split_regression(
            hist, cand_mask, scale_exp=scale_exp,
            min_child_weight=min_child_weight,
        )
        dec = dec._replace(y_range=y_range(
            y, node_id, payload[:, 0], chunk_lo, n_slots=n_slots))
    else:
        dec = imp_ops.best_split_classification(
            hist, cand_mask, criterion=criterion,
            min_child_weight=min_child_weight, scale_exp=scale_exp,
        )
    return pack_decision(
        dec, torch.float32 if scale_exp is None else torch.float64)


def node_sums(q: torch.Tensor, node_id: torch.Tensor, chunk_lo: int, *,
              n_slots: int, scale_exp) -> torch.Tensor:
    """(n_slots, C) float64 per-slot payload sums for terminal levels:
    ``q`` is the fit's (N, C) int64 quantized payload
    (``hist_kernel.quantize``; exponents 0 on the integer route, whose
    values are integers already), summed exactly in int64 (so in any
    order), then scaled by ``2**-k[c]``; rows outside ``[chunk_lo,
    chunk_lo + n_slots)`` add to a spare row that is dropped. Class counts
    or regression moments, the counterpart of ``node_counts_local``."""
    slot = node_id.to(torch.int64) - chunk_lo
    valid = (slot >= 0) & (slot < n_slots)
    h = torch.zeros((n_slots + 1, q.shape[1]), dtype=torch.int64,
                    device=q.device)
    h.index_add_(0, torch.where(valid, slot, n_slots), q)
    return dequantize(h[:n_slots], scale_exp, dim=1)


def y_range(y: torch.Tensor, node_id: torch.Tensor, w: torch.Tensor,
            chunk_lo: int, *, n_slots: int) -> torch.Tensor:
    """(n_slots,) float32 ``max(y) - min(y)`` per slot over rows of
    positive weight (0 for a slot with none): ``regression_y_range``
    (``mpitree_tpu/parallel/collective.py:117``). The float32 moment
    variance cannot resolve near-zero spreads, so regression's purity stop
    reads this instead. min and max do not depend on the order."""
    slot = node_id.to(torch.int64) - chunk_lo
    valid = (slot >= 0) & (slot < n_slots) & (w > 0)
    s = slot[valid]
    yv = y[valid].to(torch.float32)
    lo = torch.full((n_slots,), math.inf, dtype=torch.float32,
                    device=y.device).scatter_reduce(0, s, yv, "amin")
    hi = torch.full((n_slots,), -math.inf, dtype=torch.float32,
                    device=y.device).scatter_reduce(0, s, yv, "amax")
    return torch.where(hi >= lo, hi - lo, torch.zeros_like(hi))


def update_node_id(node_id: torch.Tensor, x_binned: torch.Tensor,
                   chunk_lo: int, is_split: torch.Tensor, feat: torch.Tensor,
                   bin_: torch.Tensor, left_id: torch.Tensor,
                   right_id: torch.Tensor) -> torch.Tensor:
    """Advance row -> node assignments through one table of ``U`` slots.

    The (U,) tables describe nodes ``chunk_lo .. chunk_lo + U - 1``: rows of
    a node with ``is_split`` go to ``left_id`` when
    ``x_binned[r, feat] <= bin`` and to ``right_id`` otherwise. Returns a new
    (N,) int32 tensor.
    """
    U = is_split.shape[0]
    slot = node_id.to(torch.int64) - chunk_lo
    in_chunk = (slot >= 0) & (slot < U)
    s = slot.clamp(0, U - 1)
    active = in_chunk & is_split[s]
    f = feat[s]
    xf = torch.gather(x_binned, 1, f[:, None])[:, 0]
    go_left = xf <= bin_[s]
    nxt = torch.where(go_left, left_id[s], right_id[s])
    return torch.where(active, nxt, node_id)
