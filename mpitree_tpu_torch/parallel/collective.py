"""Single-device level steps: split search, terminal counts, row reroute.

Counterpart of the one-device case of ``mpitree_tpu/parallel/collective.py``.
With one GPU the histogram ``psum`` over the data axis is the identity, so
no mesh code is ported; each step is a plain function on tensors that live
on the fit's device:

- :func:`split_step` (``make_split_fn``, ``:268``; regression
  ``:470-502``; boosting's Newton rounds ``:419-469``): the frontier
  chunk's ``(S, F, C, B)`` histogram (the Hopper kernel on CUDA tensors,
  ``ops/hist_kernel.py``) followed by the split sweep, packed into one
  buffer so a level costs one device-to-host copy: float32 on the integer
  route, float64 on the fixed-point route, whose node statistics are
  exact sums. Its two stages, :func:`split_hist` and :func:`split_sweep`,
  are public so that sibling subtraction can rebuild the histogram
  between them (the JAX fused engine's ``chunk_stats``,
  ``mpitree_tpu/core/fused_builder.py:302-360``);
- :func:`node_sums` (``node_counts_local``, ``:81``): per-slot payload
  sums (class counts, regression moments or boosting's ``(count, G, H)``)
  for terminal levels, an O(N)
  scatter instead of the O(N*F) histogram, exact in int64 on both routes;
- :func:`y_range` (``regression_y_range``, ``:117``): the per-slot
  ``max(y) - min(y)`` that regression's purity stop reads;
- :func:`update_node_id` (``make_update_fn``, ``:752``): rows of splitting
  nodes move to a child by ``bin(x[:, feat]) <= bin`` (left) or not
  (right); every other row keeps its node id;
- the leaf-wise frontier's unit of work (``core/leafwise_builder.py``):
  :func:`reroute_leaf` moves the rows of the one leaf being expanded, and
  :func:`pair_split_stats` (``:555``) builds and sweeps the histogram of
  the new sibling pair; :func:`expand_step` (``make_expand_fn``,
  ``:653``) is the two together. The node ids and the split come as
  tensors on the device, so an expansion needs no host integer.

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
    package's ``_pack_decision``; a ``y_range`` (regression) follows
    ``n_left``, then ``v_left``, ``v_right`` under monotonic constraints.
    float32 on the integer route: feature/bin/constant are exact below
    2**24, as are the integer-valued counts, and the float32 child values
    are exact in either buffer. float64 on the fixed-point route, whose
    float64 node statistics it keeps whole."""
    cols = [dec.feature, dec.bin, dec.cost, dec.impurity, dec.n,
            dec.constant, dec.n_left]
    if dec.y_range is not None:
        cols.append(dec.y_range)
    if dec.v_left is not None:
        cols += [dec.v_left, dec.v_right]
    head = torch.stack([c.to(dtype) for c in cols], dim=1)
    return torch.cat([head, dec.counts.to(dtype)], dim=1)


def unpack_decision(packed: np.ndarray, n_counts: int, *,
                    y_range: bool = False, mono: bool = False) -> dict:
    """Host-side inverse of :func:`pack_decision` (numpy dict); columns
    keep the buffer's dtype, but for ``v_left``/``v_right`` (float32).
    ``n_counts`` is the counts' width; ``y_range`` and ``mono`` say which
    optional head columns the buffer holds."""
    n_head = packed.shape[1] - n_counts
    if n_head != 7 + y_range + 2 * mono:
        raise ValueError(f"decision buffer has {n_head} head columns")
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
    if y_range:
        out["y_range"] = packed[:, 7]
    if mono:
        out["v_left"] = packed[:, n_head - 2].astype(np.float32)
        out["v_right"] = packed[:, n_head - 1].astype(np.float32)
    return out


def split_hist(x_binned: torch.Tensor, payload: torch.Tensor,
               node_id: torch.Tensor, chunk_lo: int, *, n_slots: int,
               n_bins: int, packed: torch.Tensor | None = None,
               order: torch.Tensor | None = None,
               seg_start: torch.Tensor | None = None,
               feat_bins=None, scale_exp=None,
               slot: torch.Tensor | None = None) -> torch.Tensor:
    """The histogram stage of :func:`split_step`: the frontier chunk's
    ``(S, F, C, B)`` histogram, float32 or (``scale_exp``) int64. ``slot``
    replaces ``node_id - chunk_lo`` (sibling subtraction's compact slots,
    ``histogram.sibling_accumulate_slots``); ``order``/``seg_start`` must
    then order those slots."""
    if slot is None:
        slot = (node_id - chunk_lo).to(torch.int32)
    return hist_ops.histogram(x_binned, payload, slot, n_slots=n_slots,
                              n_bins=n_bins, packed=packed, order=order,
                              seg_start=seg_start, feat_bins=feat_bins,
                              scale_exp=scale_exp)


def split_sweep(hist: torch.Tensor, cand_mask: torch.Tensor,
                node_id: torch.Tensor, chunk_lo: int, *, criterion: str,
                min_child_weight: float, scale_exp=None,
                task: str = "classification",
                y: torch.Tensor | None = None,
                payload: torch.Tensor | None = None,
                node_mask: torch.Tensor | None = None,
                draws: torch.Tensor | None = None,
                mono_cst: torch.Tensor | None = None,
                mono_lo: torch.Tensor | None = None,
                mono_hi: torch.Tensor | None = None,
                reg_lambda: float = 0.0,
                min_leaf_rows: float = 0.0) -> torch.Tensor:
    """The sweep stage of :func:`split_step`: the packed decision buffer
    of the chunk whose histogram is ``hist``. Regression also reads
    ``y``, ``payload`` and ``node_id`` for its purity signal."""
    n_slots = hist.shape[0]
    if task == "gbdt":
        dec = imp_ops.best_split_newton(
            hist, cand_mask, scale_exp=scale_exp, reg_lambda=reg_lambda,
            min_child_weight=min_child_weight,
            min_samples_leaf=min_leaf_rows,
        )
    elif task == "regression":
        dec = imp_ops.best_split_regression(
            hist, cand_mask, scale_exp=scale_exp,
            min_child_weight=min_child_weight, node_mask=node_mask,
            forced_draw=draws, mono_cst=mono_cst, mono_lo=mono_lo,
            mono_hi=mono_hi,
        )
        dec = dec._replace(y_range=y_range(
            y, node_id, payload[:, 0], chunk_lo, n_slots=n_slots))
    else:
        dec = imp_ops.best_split_classification(
            hist, cand_mask, criterion=criterion,
            min_child_weight=min_child_weight, scale_exp=scale_exp,
            node_mask=node_mask, forced_draw=draws, mono_cst=mono_cst,
            mono_lo=mono_lo, mono_hi=mono_hi,
        )
    return pack_decision(
        dec, torch.float32 if scale_exp is None else torch.float64)


def split_step(x_binned: torch.Tensor, payload: torch.Tensor,
               node_id: torch.Tensor, cand_mask: torch.Tensor,
               chunk_lo: int, *, n_slots: int, n_bins: int, criterion: str,
               min_child_weight: float, packed: torch.Tensor | None = None,
               order: torch.Tensor | None = None,
               seg_start: torch.Tensor | None = None,
               feat_bins=None, scale_exp=None, task: str = "classification",
               y: torch.Tensor | None = None,
               node_mask: torch.Tensor | None = None,
               draws: torch.Tensor | None = None,
               mono_cst: torch.Tensor | None = None,
               mono_lo: torch.Tensor | None = None,
               mono_hi: torch.Tensor | None = None,
               reg_lambda: float = 0.0,
               min_leaf_rows: float = 0.0) -> torch.Tensor:
    """Histogram + split sweep for the frontier chunk of ``n_slots`` nodes
    starting at node id ``chunk_lo``; returns the packed decision buffer:
    :func:`split_hist`, then :func:`split_sweep`.

    ``x_binned`` (N, F) int32, ``payload`` (N, C) float32 (``w *
    onehot(y)``, or regression's ``(w, w*y, w*y^2)``), ``node_id`` (N,)
    int32, ``cand_mask`` (F, B) bool, all on one device. ``scale_exp``
    selects the fixed-point route (always taken for ``task="regression"``,
    which also needs ``y``, the (N,) float32 targets, for the purity
    signal). ``packed`` (the fit's byte-wide copy of the bins), ``order``
    and ``seg_start`` (the level's rows ordered by node, and this chunk's
    ``n_slots + 1`` segment offsets into that order) and ``feat_bins`` go
    to the histogram as they are (``ops/hist_kernel.histogram``).
    ``node_mask`` ((n_slots, F) bool, the slots' sampled features) and
    ``draws`` ((n_slots, F) int64, ``splitter="random"``) go to the sweep
    (``mpitree_tpu/parallel/collective.py:416``, ``:494``), as do
    ``mono_cst`` ((F,) int32 internal signs) and the chunk's bounds
    ``mono_lo``/``mono_hi`` ((n_slots,) float32), whose winners' child
    values then ride in the buffer (``:372-375``). ``task="gbdt"``
    takes the fixed-point ``(count, g, h)`` payload
    (``histogram.gbdt_payload``) and runs the Newton sweep with
    ``reg_lambda``, ``min_child_weight`` as the hessian floor and
    ``min_leaf_rows`` as the row floor (``:419-421``); its buffer carries
    ``(count, G, H)`` as the counts.
    """
    hist = split_hist(x_binned, payload, node_id, chunk_lo, n_slots=n_slots,
                      n_bins=n_bins, packed=packed, order=order,
                      seg_start=seg_start, feat_bins=feat_bins,
                      scale_exp=scale_exp)
    return split_sweep(
        hist, cand_mask, node_id, chunk_lo, criterion=criterion,
        min_child_weight=min_child_weight, scale_exp=scale_exp, task=task,
        y=y, payload=payload, node_mask=node_mask, draws=draws,
        mono_cst=mono_cst, mono_lo=mono_lo, mono_hi=mono_hi,
        reg_lambda=reg_lambda, min_leaf_rows=min_leaf_rows)


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
    # rows outside go to a spare slot, dropped: no boolean indexing, so
    # no device-to-host synchronisation
    s = torch.where(valid, slot, n_slots)
    yv = y.to(torch.float32)
    lo = torch.full((n_slots + 1,), math.inf, dtype=torch.float32,
                    device=y.device).scatter_reduce(0, s, yv, "amin")
    hi = torch.full((n_slots + 1,), -math.inf, dtype=torch.float32,
                    device=y.device).scatter_reduce(0, s, yv, "amax")
    lo, hi = lo[:n_slots], hi[:n_slots]
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


def reroute_leaf(node_id: torch.Tensor, x_binned: torch.Tensor,
                 e_node: torch.Tensor, feat: torch.Tensor, bin_: torch.Tensor,
                 left_id: torch.Tensor) -> torch.Tensor:
    """The rows of leaf ``e_node`` go to ``left_id`` where
    ``x_binned[:, feat] <= bin_`` and to ``left_id + 1`` otherwise; every
    other row keeps its node. All four are 0-d tensors on the rows'
    device (an ``e_node`` no row carries, such as -2, moves nothing)."""
    col = x_binned.index_select(
        1, feat.clamp(min=0).to(torch.int64).view(1))[:, 0]
    child = torch.where(col <= bin_, left_id, left_id + 1).to(torch.int32)
    return torch.where(node_id == e_node, child, node_id)


def pair_split_stats(x_binned: torch.Tensor, payload: torch.Tensor,
                     node_id: torch.Tensor, cand_mask: torch.Tensor,
                     left_id: torch.Tensor, is_small: torch.Tensor,
                     parent_hist: torch.Tensor | None, *, n_bins: int,
                     criterion: str, min_child_weight: float, scale_exp,
                     task: str, y: torch.Tensor,
                     packed: torch.Tensor | None = None, feat_bins=None,
                     reg_lambda: float = 0.0, min_leaf_rows: float = 0.0,
                     subtraction: bool = False) -> tuple:
    """Histogram and sweep of ONE sibling pair, nodes ``(left_id,
    left_id + 1)`` (``pair_split_stats``,
    ``mpitree_tpu/parallel/collective.py:555``): returns ``(decisions,
    keep)``, the packed (2, ...) decision buffer of :func:`split_sweep`
    and, under ``subtraction``, the pair's histogram for the leaf pool
    (else None). ``left_id`` is a 0-d tensor on the device; the root
    rides the same call with ``left_id == 0`` while every row still sits
    at node 0 (slot 1 empty).

    Without subtraction both slots accumulate (S = 2). With it only the
    smaller child (``is_small`` (2,) bool) accumulates, into one compact
    slot (``histogram.sibling_accumulate_slots`` with ``n_slots=2``), and
    the larger is ``parent_hist - small`` from the expanded leaf's
    resident (1, F, C, B) histogram (``histogram.sibling_reconstruct_pair``):
    exact on both routes, so the pair is the same. Regression's purity
    reads :func:`y_range` over the pair (``regression_y_range(...,
    n_slots=2)``)."""
    if subtraction:
        slot = hist_ops.sibling_accumulate_slots(node_id, left_id, is_small,
                                                 n_slots=2)
        n_acc = 1
    else:
        slot = (node_id - left_id).to(torch.int32)
        n_acc = 2
    hist = split_hist(x_binned, payload, None, 0, n_slots=n_acc,
                      n_bins=n_bins, packed=packed, feat_bins=feat_bins,
                      scale_exp=scale_exp, slot=slot.contiguous())
    if subtraction:
        hist = hist_ops.sibling_reconstruct_pair(hist, parent_hist, is_small)
    dec = split_sweep(hist, cand_mask, node_id, left_id, criterion=criterion,
                      min_child_weight=min_child_weight, scale_exp=scale_exp,
                      task=task, y=y, payload=payload, reg_lambda=reg_lambda,
                      min_leaf_rows=min_leaf_rows)
    return dec, (hist if subtraction else None)


def expand_step(x_binned: torch.Tensor, payload: torch.Tensor,
                node_id: torch.Tensor, cand_mask: torch.Tensor,
                e_node: torch.Tensor, feat: torch.Tensor, bin_: torch.Tensor,
                left_id: torch.Tensor, is_small: torch.Tensor,
                parent_hist: torch.Tensor | None, **kw) -> tuple:
    """One best-first expansion (``make_expand_fn``, ``:653``): reroute the
    rows of leaf ``e_node`` through its split ``(feat, bin_)`` into
    ``(left_id, left_id + 1)`` (:func:`reroute_leaf`), then
    :func:`pair_split_stats` of the new pair (``kw`` its keywords).
    Returns ``(node_id, decisions, keep)``."""
    node_id = reroute_leaf(node_id, x_binned, e_node, feat, bin_, left_id)
    dec, keep = pair_split_stats(x_binned, payload, node_id, cand_mask,
                                 left_id, is_small, parent_hist, **kw)
    return node_id, dec, keep
