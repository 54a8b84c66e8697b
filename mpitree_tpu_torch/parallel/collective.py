"""Single-device level steps: split search, terminal counts, row reroute.

Counterpart of the one-device case of ``mpitree_tpu/parallel/collective.py``.
With one GPU the histogram ``psum`` over the data axis is the identity, so
no mesh code is ported; each step is a plain function on tensors that live
on the fit's device:

- :func:`split_step` (``make_split_fn``, ``:268``): the frontier chunk's
  ``(S, F, C, B)`` class histogram (the Hopper kernel on CUDA tensors,
  ``ops/hist_kernel.py``) followed by the split sweep, packed into one
  ``(S, 7 + C)`` float32 buffer so a level costs one device-to-host copy;
- :func:`node_counts` (``node_counts_local``, ``:81``): per-slot class
  counts for terminal levels, an O(N) scatter instead of the O(N*F)
  histogram;
- :func:`update_node_id` (``make_update_fn``, ``:752``): rows of splitting
  nodes move to a child by ``bin(x[:, feat]) <= bin`` (left) or not
  (right); every other row keeps its node id.

The reroute and the counts are XLA code outside any Pallas kernel in the
JAX package, and stay plain torch operations here.
"""

from __future__ import annotations

import numpy as np
import torch

from mpitree_tpu_torch.ops import histogram as hist_ops
from mpitree_tpu_torch.ops import impurity as imp_ops


def pack_decision(dec: imp_ops.SplitDecision) -> torch.Tensor:
    """SplitDecision -> one (K, 7 + C) float32 buffer (feature, bin, cost,
    impurity, n, constant, n_left, counts...), the classification columns
    of the JAX package's ``_pack_decision``. feature/bin/constant ride as
    f32 — exact below 2**24, as are the integer-valued counts."""
    head = torch.stack(
        [dec.feature.to(torch.float32), dec.bin.to(torch.float32),
         dec.cost, dec.impurity, dec.n, dec.constant.to(torch.float32),
         dec.n_left],
        dim=1,
    )
    return torch.cat([head, dec.counts.to(torch.float32)], dim=1)


def unpack_decision(packed: np.ndarray) -> dict:
    """Host-side inverse of :func:`pack_decision` (numpy dict)."""
    return {
        "feature": packed[:, 0].astype(np.int32),
        "bin": packed[:, 1].astype(np.int32),
        "cost": packed[:, 2],
        "impurity": packed[:, 3],
        "n": packed[:, 4],
        "constant": packed[:, 5] > 0,
        "n_left": packed[:, 6],
        "counts": packed[:, 7:],
    }


def split_step(x_binned: torch.Tensor, payload: torch.Tensor,
               node_id: torch.Tensor, cand_mask: torch.Tensor,
               chunk_lo: int, *, n_slots: int, n_bins: int, criterion: str,
               min_child_weight: float, packed: torch.Tensor | None = None,
               order: torch.Tensor | None = None,
               seg_start: torch.Tensor | None = None,
               feat_bins=None) -> torch.Tensor:
    """Histogram + split sweep for the frontier chunk of ``n_slots`` nodes
    starting at node id ``chunk_lo``; returns the packed decision buffer.

    ``x_binned`` (N, F) int32, ``payload`` (N, C) float32 ``w * onehot(y)``,
    ``node_id`` (N,) int32, ``cand_mask`` (F, B) bool, all on one device.
    ``packed`` (the fit's byte-wide copy of the bins), ``order`` and
    ``seg_start`` (the level's rows ordered by node, and this chunk's
    ``n_slots + 1`` segment offsets into that order) and ``feat_bins`` go
    to the histogram as they are (``ops/hist_kernel.histogram``).
    """
    slot = (node_id - chunk_lo).to(torch.int32)
    hist = hist_ops.histogram(x_binned, payload, slot, n_slots=n_slots,
                              n_bins=n_bins, packed=packed, order=order,
                              seg_start=seg_start, feat_bins=feat_bins)
    dec = imp_ops.best_split_classification(
        hist, cand_mask, criterion=criterion,
        min_child_weight=min_child_weight,
    )
    return pack_decision(dec)


def node_counts(y: torch.Tensor, node_id: torch.Tensor, w: torch.Tensor,
                chunk_lo: int, *, n_slots: int, n_classes: int
                ) -> torch.Tensor:
    """(n_slots, C) float32 per-slot class weight sums (``y`` int64,
    ``w`` float32); rows outside ``[chunk_lo, chunk_lo + n_slots)`` add
    nothing."""
    slot = node_id.to(torch.int64) - chunk_lo
    valid = (slot >= 0) & (slot < n_slots)
    ids = torch.where(valid, slot * n_classes + y, torch.zeros_like(slot))
    wv = torch.where(valid, w, torch.zeros_like(w))
    h = torch.zeros(n_slots * n_classes, dtype=torch.float32,
                    device=w.device)
    h.index_add_(0, ids, wv)
    return h.view(n_slots, n_classes)


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
