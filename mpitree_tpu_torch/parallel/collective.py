"""Level steps and their reductions over the data mesh: split search,
terminal counts, row reroute.

Counterpart of ``mpitree_tpu/parallel/collective.py``. The JAX package
runs each step as one ``shard_map`` program whose ``lax.psum`` over the
``data`` axis makes every device's histogram the global one; here each
step is a plain function on tensors that live on one shard's device, and
the reductions between them are explicit (:func:`psum`, on the
``parallel/mesh.Mesh`` of the fit): the local shards are summed in fixed
shard order onto the lead shard, then ``dist.all_reduce`` crosses the
processes. Only ``all_reduce`` (SUM, MIN, MAX) is used, which gloo offers
for CUDA tensors as NCCL does. Every reduced value is an integer-valued
float32 below 2**24, an int64 or a minimum or maximum, so any summation
order gives the same bits, and a tree is identical at every shard count.
With one shard and no process group a reduction is the identity. The
reduction sites, JAX's psums:

- the split histogram (``:412``, ``:428``, ``:459``, ``:490``): each
  shard's :func:`split_hist` (the Hopper kernel family on CUDA,
  ``ops/hist_kernel.py``), reduced before :func:`split_sweep` (which
  runs on the lead shard, the split search of ``make_split_fn``,
  ``:268``; regression ``:470-502``; boosting's Newton rounds
  ``:419-469``) and, under sibling subtraction, before the larger sibling
  is rebuilt against the reduced carry
  (``core/builder.FrontierHistograms``);
- :func:`node_sums` (``node_counts_local``, ``:81``, psum ``:113``):
  per-slot payload sums (class counts, regression moments or boosting's
  ``(count, G, H)``) for terminal levels, an O(N) scatter instead of the
  O(N*F) histogram, exact in int64 on both routes;
- :func:`y_range` (``regression_y_range``, ``:117``, pmin/pmax ``:136``):
  the per-slot ``max(y) - min(y)`` of rows of positive weight that
  regression's purity stop reads;
- :func:`payload_scale` (no JAX site: the port's fixed-point route): the
  route and exponents of a fit, from every shard's payload (one
  payload without a mesh);
- :func:`pair_split_stats` (``:555``, psums ``:603-643``), the leaf-wise
  frontier's unit of work, reduces every shard's pair histogram over the
  data mesh.

On a ``(data, feature)`` mesh the histograms reduce over the data axis
only (each feature slab's sub-mesh, ``Mesh.axis_mesh``), and two hops
cross the feature axis: :func:`select_global` (``:140-193``) merges the
slabs' split winners (the local slabs, then one stacked all-gather of
``(K, 7)`` float64 records over the axis's processes, through host
memory under gloo), and :func:`route_psum` (``:752-805``) routes the
rows by the owner broadcast. :func:`gather_rows` brings a row-sharded
tensor to every process bit for bit (the leaf ids, the fused rounds'
margins); the forests' tree exchange (``core/fused_builder._exchange``)
and the route sums count in ``mesh.stats`` under their own kinds.

The levelwise engines' dispatches carry the JAX package's chaos seams
(``mpitree_tpu/parallel/collective.py:35-50``: ``split_dispatch``,
``counts_dispatch``, ``update_dispatch``, ``expand_dispatch``;
``resilience/chaos.py``), stepped once per dispatch by their callers in
``core/builder.py`` and ``core/leafwise_builder.py``, so the fused
engines, which share these functions, step none, as JAX's single-program
engines do.

:func:`update_node_id` (``make_update_fn``, ``:752``) moves each shard's
rows of splitting nodes to a child by ``bin(x[:, feat]) <= bin`` with the
split tables copied to the shard (:func:`to_shards`); rows never move
between shards. :func:`reroute_leaf` and :func:`expand_step`
(``make_expand_fn``, ``:653``) are the leaf-wise reroute. The reroute and
the counts are XLA code outside any Pallas kernel in the JAX package, and
stay plain torch operations here.

:func:`split_psum_bytes` and :func:`counts_psum_bytes` (``:59-79``) give
a reduction's logical payload; the mesh's ``stats`` count every
reduction's calls, bytes and seconds for ``fit_stats_``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from mpitree_tpu_torch.ops import hist_kernel
from mpitree_tpu_torch.ops import histogram as hist_ops
from mpitree_tpu_torch.ops import impurity as imp_ops
from mpitree_tpu_torch.ops.hist_kernel import dequantize

_REDUCE_OPS = ("sum", "min", "max")


def split_psum_bytes(*, n_slots: int, n_features: int, n_bins: int,
                     n_channels: int, itemsize: int = 4) -> int:
    """Logical payload of one split-histogram reduction (bytes): the
    (n_slots, n_features, n_channels, n_bins) chunk, 4-byte cells on the
    integer route, 8-byte on the fixed-point one (``:59-73``)."""
    return n_slots * n_features * n_channels * n_bins * itemsize


def counts_psum_bytes(*, n_slots: int, n_channels: int,
                      itemsize: int = 4) -> int:
    """Logical payload of one terminal-sums reduction (bytes,
    ``:76-79``); the port's sums are int64 (``itemsize=8``)."""
    return n_slots * n_channels * itemsize


def to_shards(t: torch.Tensor, mesh) -> list:
    """``t`` (on the lead shard) on every local shard of ``mesh``, in
    shard order: the split tables a reroute reads. No copy where a shard
    shares the lead's device (CPU shards); ``[t]`` without a mesh."""
    if mesh is None:
        return [t]
    return [t if t.device == d else t.to(d) for d in mesh.devices]


def _parts(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def psum(parts, mesh, op: str = "sum", *,
         kind: str = "allreduce") -> torch.Tensor:
    """The reduction of one tensor per local shard (``parts``, in shard
    order) over ``mesh``, on the lead shard's device: the local shards
    summed (or their minimum or maximum taken) in shard order, then
    ``dist.all_reduce`` over the processes. A single part stands for the
    local shards already combined. The first part may be reduced in
    place. The identity with one shard and no process group (or no
    mesh). Records the call, its logical bytes and its seconds (ended
    when the devices are idle) in ``mesh.stats`` under ``kind``
    (``allreduce``, ``route`` or ``tree_exchange``)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduction {op!r}; one of {_REDUCE_OPS}")
    parts = _parts(parts)
    n_local = 1 if mesh is None else mesh.n_local
    if len(parts) not in (1, n_local):
        raise ValueError(f"{len(parts)} parts for {n_local} shards")
    if mesh is None or not mesh.reduces or (
            len(parts) == 1 and mesh.group is None):
        return parts[0]
    import torch.distributed as dist

    def idle():
        for d in dict.fromkeys(p.device for p in parts):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    idle()
    t0 = time.perf_counter()
    acc = parts[0].contiguous()
    for p in parts[1:]:
        p = p.to(acc.device)
        acc = (acc + p if op == "sum" else torch.minimum(acc, p)
               if op == "min" else torch.maximum(acc, p))
    if mesh.group is not None:
        dist.all_reduce(acc, op=getattr(dist.ReduceOp, op.upper()),
                        group=mesh.group)
    idle()
    _count(mesh, kind, acc.numel() * acc.element_size(),
           time.perf_counter() - t0)
    return acc


def _count(mesh, kind: str, n_bytes: int, seconds: float) -> None:
    st = mesh.stats
    st[f"{kind}_calls"] += 1
    st[f"{kind}_bytes"] += int(n_bytes)
    st[f"{kind}_seconds"] += seconds


def gather_rows(parts, mesh, n_rows: int) -> torch.Tensor:
    """Every row of a row-sharded tensor (``parts``, one per local shard
    of the 1-D data ``mesh``, padded rows last) on the lead shard, first
    ``n_rows`` rows, bit for bit: the local shards in order, then across
    processes one all-reduce (SUM) of the whole vector's integer bits in
    which each process fills its own rows. The counterpart of a
    ``jax.device_get`` of a data-sharded array."""
    parts = _parts(parts)
    lead = parts[0].device
    local = torch.cat([p.to(lead) for p in parts])
    if mesh is None or mesh.group is None:
        return local[:n_rows]
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = local.contiguous().view(ints[local.element_size()])
    full = torch.zeros((mesh.n_procs * bits.shape[0],) + bits.shape[1:],
                       dtype=bits.dtype, device=lead)
    a = mesh.rank * bits.shape[0]
    full[a:a + bits.shape[0]] = bits
    return psum([full], mesh)[:n_rows].view(local.dtype)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``(n_procs,) + t.shape``: every process's ``t`` in rank order.
    gloo gathers host tensors only, so under gloo ``t`` is staged through
    host memory (the payloads here are a few KiB); NCCL gathers on the
    card."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    host = dist.get_backend(group) != "nccl"
    src = t.cpu() if host else t
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src.contiguous(), group=group)
    return torch.stack(out).to(t.device)


# the columns of a winner record: rank (hi, lo), cost, global feature,
# bin, left weight, "has a non-constant feature"
_HI, _LO, _COST, _FEAT, _BIN, _NLEFT, _NONCONST = range(7)


def _first_min(recs: list) -> torch.Tensor:
    """The (K, 7) winner records of several feature blocks (in block
    order) merged: per slot the lexicographic ``(hi, lo)`` minimum, the
    earliest block on an exact tie, so the lowest global feature wins as
    in one feature-complete sweep; ``nonconst`` is their maximum."""
    best = recs[0]
    for r in recs[1:]:
        better = (r[:, _HI] < best[:, _HI]) | (
            (r[:, _HI] == best[:, _HI]) & (r[:, _LO] < best[:, _LO]))
        nonconst = torch.maximum(best[:, _NONCONST], r[:, _NONCONST])
        best = torch.where(better[:, None], r, best)
        best[:, _NONCONST] = nonconst
    return best


def select_global(decs: list, fmesh, f_local: int, blocks: list):
    """Merge per-feature-block split winners into the global decision
    (``select_global``, ``mpitree_tpu/parallel/collective.py:140-193``).
    ``decs`` are this process's blocks' SplitDecisions (block ``blocks[k]``
    of width ``f_local``, in block order), ``fmesh`` the feature axis's
    sub-mesh through the lead shard. Each block's winner becomes a record
    (rank, cost, global feature ``f + block * f_local``, bin, left weight,
    non-constant flag); the local blocks merge by a first minimum, then
    the processes of the feature axis gather theirs in one stacked
    all-gather (``(procs, K, 7)`` float64, every value exact) and merge in
    rank order, so the lowest global feature wins a tie. The node-level
    fields (counts, n, impurity, y_range) are every block's own, since
    every row adds to every feature's histogram; the result is on the
    first block's device."""
    lead = decs[0].feature.device
    f64 = torch.float64
    recs = []
    for d, blk in zip(decs, blocks):
        cost = d.cost.to(lead)
        hi = cost.to(torch.float32)
        if d.cost_lo is not None:
            lo = d.cost_lo.to(lead).to(f64)
        elif cost.dtype == f64:
            lo = torch.where(torch.isinf(cost), torch.zeros_like(cost),
                             (cost - hi.to(f64)).to(torch.float32).to(f64))
        else:
            lo = torch.zeros_like(cost, dtype=f64)
        recs.append(torch.stack([
            hi.to(f64), lo, cost.to(f64),
            (d.feature.to(lead).to(torch.int64) + blk * f_local).to(f64),
            d.bin.to(lead).to(f64), d.n_left.to(lead).to(f64),
            (~d.constant.to(lead)).to(f64)], dim=1))
    best = _first_min(recs)
    if fmesh is not None and fmesh.group is not None:
        if lead.type == "cuda":
            torch.cuda.synchronize(lead)
        t0 = time.perf_counter()
        gathered = _all_gather(best, fmesh.group)
        best = _first_min(list(gathered))
        _count(fmesh, "gather", best.numel() * best.element_size(),
               time.perf_counter() - t0)
    d0 = decs[0]
    return d0._replace(
        feature=best[:, _FEAT].to(torch.int32),
        bin=best[:, _BIN].to(torch.int32),
        cost=best[:, _COST].to(d0.cost.dtype),
        n_left=best[:, _NLEFT].to(d0.n_left.dtype),
        constant=best[:, _NONCONST] == 0,
        cost_lo=None)


def payload_scale(payloads, mesh, *, fixed: bool, n_rows: int):
    """The histogram route of a fit over ``mesh`` from every shard's
    ``(n, C)`` payload (``payloads``, one per local shard): None (the
    float32 integer route) when every value of every shard is an integer
    and every channel's ``|v|`` sums below 2**24 over all of them, else
    the fixed-point exponents of the channel maxima over all shards and
    the global row count ``n_rows``; ``fixed`` (regression, boosting)
    always takes exponents. The flags reduce with MIN, the sums with SUM
    and the maxima with MAX, so every shard and process takes the route
    and exponents one shard holding every row would
    (``hist_kernel.float32_exact``, ``fixed_point_exponents``). Raises on
    a non-finite value. Two device-to-host copies."""
    stats = [hist_kernel.payload_stats(p) for p in _parts(payloads)]
    sums = psum([s[1].clone() for s in stats], mesh)
    flag_top = psum([torch.stack([-s[0], s[2]]) for s in stats], mesh,
                    "max")
    integral = bool((flag_top[0] <= -1.0).all())
    return hist_kernel.scale_from_stats(
        integral, sums.cpu().numpy(), flag_top[1].cpu().numpy(),
        n_rows=n_rows, fixed=fixed)


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


def sweep_decision(hist: torch.Tensor, cand_mask: torch.Tensor,
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
                min_leaf_rows: float = 0.0,
                yr: torch.Tensor | None = None) -> imp_ops.SplitDecision:
    """The sweep stage of :func:`split_step`: the SplitDecision of the
    chunk whose histogram is ``hist``. Regression also reads ``y``,
    ``payload`` and ``node_id`` for its purity signal, or takes it as
    ``yr`` (:func:`y_range` over a mesh)."""
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
        if yr is None:
            yr = y_range(y, node_id, payload[:, 0], chunk_lo,
                         n_slots=n_slots)
        return dec._replace(y_range=yr)
    else:
        dec = imp_ops.best_split_classification(
            hist, cand_mask, criterion=criterion,
            min_child_weight=min_child_weight, scale_exp=scale_exp,
            node_mask=node_mask, forced_draw=draws, mono_cst=mono_cst,
            mono_lo=mono_lo, mono_hi=mono_hi,
        )
    return dec


def split_sweep(hist: torch.Tensor, cand_mask: torch.Tensor,
                node_id, chunk_lo: int, *, scale_exp=None, **kw
                ) -> torch.Tensor:
    """:func:`sweep_decision` packed (:func:`pack_decision`): the
    buffer's float32 on the integer route, float64 on the fixed-point
    one."""
    return pack_decision(
        sweep_decision(hist, cand_mask, node_id, chunk_lo,
                       scale_exp=scale_exp, **kw),
        torch.float32 if scale_exp is None else torch.float64)


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


def node_sums(q, node_id, chunk_lo: int, *, n_slots: int, scale_exp,
              mesh=None) -> torch.Tensor:
    """(n_slots, C) float64 per-slot payload sums for terminal levels:
    ``q`` is the fit's (N, C) int64 quantized payload
    (``hist_kernel.quantize``; exponents 0 on the integer route, whose
    values are integers already), summed exactly in int64 (so in any
    order), then scaled by ``2**-k[c]``; rows outside ``[chunk_lo,
    chunk_lo + n_slots)`` add to a spare row that is dropped. Class counts
    or regression moments, the counterpart of ``node_counts_local``. On a
    ``mesh``, ``q`` and ``node_id`` are lists (one per local shard) and
    the int64 sums reduce (:func:`psum`) before the scale, on the lead
    shard."""
    parts = []
    for qi, ni in zip(_parts(q), _parts(node_id)):
        slot = ni.to(torch.int64) - chunk_lo
        valid = (slot >= 0) & (slot < n_slots)
        h = torch.zeros((n_slots + 1, qi.shape[1]), dtype=torch.int64,
                        device=qi.device)
        h.index_add_(0, torch.where(valid, slot, n_slots), qi)
        parts.append(h[:n_slots])
    return dequantize(psum(parts, mesh), scale_exp, dim=1)


def y_range(y, node_id, w, chunk_lo, *, n_slots: int,
            mesh=None) -> torch.Tensor:
    """(n_slots,) float32 ``max(y) - min(y)`` per slot over rows of
    positive weight (0 for a slot with none): ``regression_y_range``
    (``mpitree_tpu/parallel/collective.py:117``). The float32 moment
    variance cannot resolve near-zero spreads, so regression's purity stop
    reads this instead. min and max do not depend on the order. On a
    ``mesh``, ``y``, ``node_id`` and ``w`` are lists (one per local
    shard): padding rows (weight 0, node -1) count nowhere, and the
    minima and maxima reduce (:func:`psum`, MIN) before the difference,
    on the lead shard."""
    parts = []
    for yi, ni, wi in zip(_parts(y), _parts(node_id), _parts(w)):
        slot = ni.to(torch.int64) - chunk_lo
        valid = (slot >= 0) & (slot < n_slots) & (wi > 0)
        # rows outside go to a spare slot, dropped: no boolean indexing,
        # so no device-to-host synchronisation
        s = torch.where(valid, slot, n_slots)
        yv = yi.to(torch.float32)
        lo = torch.full((n_slots + 1,), math.inf, dtype=torch.float32,
                        device=yi.device).scatter_reduce(0, s, yv, "amin")
        hi = torch.full((n_slots + 1,), -math.inf, dtype=torch.float32,
                        device=yi.device).scatter_reduce(0, s, yv, "amax")
        # one MIN reduction for both: (min y, -max y)
        parts.append(torch.stack([lo[:n_slots], -hi[:n_slots]]))
    lo_hi = psum(parts, mesh, "min")
    lo, hi = lo_hi[0], -lo_hi[1]
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


def route_psum(nids: list, xs: list, mesh, chunk_lo: int, is_split,
               feat, bin_, left_id, right_id, *, f_local: int) -> list:
    """:func:`update_node_id` on a ``(data, feature)`` mesh, the owner
    broadcast of ``make_update_fn`` (``mpitree_tpu/parallel/
    collective.py:752-805``): ``nids`` and ``xs`` are every local shard's
    node ids and ``(rows, f_local)`` feature slab, the split tables (on
    the lead) name global features. Only the shard whose slab holds a
    node's split feature reads the column and puts the child id in its
    rows; a sum over the feature axis (the local shards of the same rows,
    then the axis's processes) gives every shard of those rows the child,
    since each moving row has exactly one owner. Returns the new ids."""
    from mpitree_tpu_torch.parallel.mesh import FEATURE_AXIS

    tables = (is_split, feat, bin_, left_id, right_id)
    active, contrib = [], []
    for i, (nid, x) in enumerate(zip(nids, xs)):
        split, f, b, lid, rid = (t.to(nid.device) for t in tables)
        U = split.shape[0]
        slot = nid.to(torch.int64) - chunk_lo
        s = slot.clamp(0, U - 1)
        act = (slot >= 0) & (slot < U) & split[s]
        fl = f[s].to(torch.int64) - mesh.coords(i)[1] * f_local
        owner = (fl >= 0) & (fl < x.shape[1])
        xf = torch.gather(x, 1, fl.clamp(0, x.shape[1] - 1)[:, None])[:, 0]
        child = torch.where(xf <= b[s], lid[s], rid[s]).to(torch.int32)
        active.append(act)
        contrib.append(torch.where(act & owner, child, 0).to(torch.int32))
    out = list(nids)
    done = set()
    for i in range(len(nids)):
        if i in done:
            continue
        row = mesh.axis_mesh(FEATURE_AXIS, i)
        total = psum([contrib[j] for j in row.local], row, kind="route")
        for j in row.local:
            out[j] = torch.where(active[j], total.to(nids[j].device),
                                 nids[j])
            done.add(j)
    return out


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


def pair_split_stats(x_binned, payload, node_id, cand_mask: torch.Tensor,
                     left_id: torch.Tensor, is_small: torch.Tensor,
                     parent_hist: torch.Tensor | None, *, n_bins: int,
                     criterion: str, min_child_weight: float, scale_exp,
                     task: str, y, packed=None, feat_bins=None,
                     reg_lambda: float = 0.0, min_leaf_rows: float = 0.0,
                     subtraction: bool = False, mesh=None) -> tuple:
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
    n_slots=2)``). On a data ``mesh`` ``x_binned``, ``payload``,
    ``node_id``, ``y`` and ``packed`` are lists, one per local shard: each
    shard's pair histogram, then the sum over the mesh (``:603-643``)
    before the reconstruction and the sweep, which run on the lead."""
    xs, qs, nids = _parts(x_binned), _parts(payload), _parts(node_id)
    ys, pk = _parts(y), _parts(packed)
    parts = []
    for i, (x, q, nid) in enumerate(zip(xs, qs, nids)):
        lid = left_id.to(nid.device)
        if subtraction:
            slot = hist_ops.sibling_accumulate_slots(
                nid, lid, is_small.to(nid.device), n_slots=2)
            n_acc = 1
        else:
            slot = (nid - lid).to(torch.int32)
            n_acc = 2
        parts.append(split_hist(
            x, q, None, 0, n_slots=n_acc, n_bins=n_bins,
            packed=pk[i] if i < len(pk) else None, feat_bins=feat_bins,
            scale_exp=scale_exp, slot=slot.contiguous()))
    hist = psum(parts, mesh)
    if subtraction:
        hist = hist_ops.sibling_reconstruct_pair(hist, parent_hist, is_small)
    yr = None
    if mesh is not None and task == "regression":
        yr = y_range(ys, nids, [q[:, 0] for q in qs], left_id, n_slots=2,
                     mesh=mesh)
    dec = split_sweep(hist, cand_mask, nids[0], left_id, criterion=criterion,
                      min_child_weight=min_child_weight, scale_exp=scale_exp,
                      task=task, y=ys[0], payload=qs[0],
                      reg_lambda=reg_lambda, min_leaf_rows=min_leaf_rows,
                      yr=yr)
    return dec, (hist if subtraction else None)


def expand_step(x_binned, payload, node_id, cand_mask: torch.Tensor,
                e_node: torch.Tensor, feat: torch.Tensor, bin_: torch.Tensor,
                left_id: torch.Tensor, is_small: torch.Tensor,
                parent_hist: torch.Tensor | None, **kw) -> tuple:
    """One best-first expansion (``make_expand_fn``, ``:653``): reroute the
    rows of leaf ``e_node`` through its split ``(feat, bin_)`` into
    ``(left_id, left_id + 1)`` (:func:`reroute_leaf`, on every shard of a
    mesh), then :func:`pair_split_stats` of the new pair (``kw`` its
    keywords). Returns ``(node_id, decisions, keep)``; ``node_id`` a list
    where it came as one."""
    nids = [reroute_leaf(nid, x, *(t.to(nid.device)
                                   for t in (e_node, feat, bin_, left_id)))
            for nid, x in zip(_parts(node_id), _parts(x_binned))]
    dec, keep = pair_split_stats(x_binned, payload, nids, cand_mask,
                                 left_id, is_small, parent_hist, **kw)
    return (nids if isinstance(node_id, (list, tuple)) else nids[0],
            dec, keep)
