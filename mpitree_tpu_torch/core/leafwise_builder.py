"""Leaf-wise (best-first) tree growth: the ``max_leaf_nodes`` frontier.

Counterpart of ``mpitree_tpu/core/leafwise_builder.py``. A pool of open
leaves, each with its best split and its gain, grows the tree in the
LightGBM order: every step expands only the open leaf of highest gain
(:func:`ops.impurity.best_leaf_slot`, ties to the lowest node id), which
costs one sibling-pair histogram over the rows
(:func:`parallel.collective.pair_split_stats`; under sibling subtraction
only the smaller child accumulates and the larger is ``parent - small``
against the leaf's histogram kept in the pool). Growth stops at
``max_leaf_nodes`` leaves or when no open leaf may split.

Two engines, one arithmetic (the pair op, :func:`_stop_and_gain` and its
numpy twin :func:`_stop_and_gain_np`, and the priority
``ops/impurity.leaf_gain`` in float32):

- **fused** (default, :class:`_LeafLoop`, ``_make_leafwise_body``,
  ``:143-345``): the pool, the node arrays and the rows' node ids stay on
  the device. The JAX package runs the loop as one ``lax.while_loop``
  whose condition reads the pool on the device; PyTorch launches from the
  host, so the loop here runs expansions whose writes are masked by an
  on-device ``active`` flag and reads that 1-byte flag once every
  ``check_every`` expansions (:data:`CHECK_EVERY`; ``None`` runs the fixed
  trip count of ``P - 1`` expansions and reads nothing, which the fused
  boosting rounds use). A masked expansion after the end changes nothing.
  On the card an expansion is one CUDA graph replay. The finished arrays
  come to the host once.
- **levelwise** (``_build_leafwise_stepped``, ``:692``; chosen by
  ``MPITREE_TPU_ENGINE=levelwise`` or ``BuildConfig(engine="levelwise")``):
  the pool on the host, one :func:`collective.expand_step` per expansion
  and one copy of the pair's decisions.

Node ids are given in expansion order, then renumbered to the
breadth-first order of the level-by-level engines (:func:`bfs_new_ids`),
so a budget of ``2**max_depth`` grows exactly their tree.

The stop rules run in the decision buffer's dtype as the port's
level-by-level engines run them (float32 on the integer route, float64
on the fixed-point route), so that identity holds on every route; only
the priority is float32, from the buffer's float32-rounded fields, as
JAX ranks. Per-node feature sampling and ``monotonic_cst`` are refused
with the JAX package's messages. On a data mesh (``_make_leafwise_fn``,
``:348-372``) both engines shard the rows and reduce every pair histogram
over the mesh; the fused loop then launches each expansion eagerly
(:func:`graph_choice`: a reduction synchronises and crosses processes,
which no CUDA graph captures) and says so in the ``frontier`` decision's
``graph``/``graph_reason``. A
``(data, feature)`` mesh raises, as in the JAX package.

Resilience (``mpitree_tpu/core/leafwise_builder.py:450-455``, ``:617``,
``:640``, ``:820``): the ``leafwise_build`` chaos seam precedes the fused
loop, which takes no snapshot (a call again builds a new loop and
captures a new CUDA graph, so no graph that held a failed launch is
replayed); the host-stepped engine saves its carry into the
``snapshot_slot`` at every expansion and resumes from a pending one, so
a transient failure at expansion e re-runs expansions e and on only. Its
seams are ``expansion`` (each step, reporting its 1-based ordinal) and
``expand_dispatch`` (each pair dispatch); the ``expansion_dispatches``
counter counts the steps run, re-runs included.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from mpitree_tpu_torch.core.builder import (
    BuildConfig,
    FitInputs,
    engine_decision,
    evidence_shape,
    note_subtraction,
    refit_regression_values,
    resolve_hist_subtraction,
)
from mpitree_tpu_torch.core.fused_builder import (
    _class_node_impurity_dev,
    _count_dtype,
    _finalize_tree,
    _row_sum,
)
from mpitree_tpu_torch.obs import accounting as obs_acct
from mpitree_tpu_torch.obs.memory import pool_capacity
from mpitree_tpu_torch.obs.observer import cold_event
from mpitree_tpu_torch.ops import hist_kernel
from mpitree_tpu_torch.ops import impurity as imp_ops
from mpitree_tpu_torch.parallel import collective
from mpitree_tpu_torch.resilience import chaos
from mpitree_tpu_torch.resilience.recovery import resolve_level_retry
from mpitree_tpu_torch.utils.importances import class_node_impurity
from mpitree_tpu_torch.utils.profiling import PhaseTimer

# Expansions between the fused engine's reads of its 1-byte "active" flag
# (chip_smoke.py phase 25 measures it against the fixed trip count).
CHECK_EVERY = 16
# The fused engine's device-to-host copies: its flag reads, counted here.
done_reads = 0


def _pool_capacity(max_leaf_nodes: int, max_depth, n_samples: int) -> int:
    """Open-leaf pool width ``P`` (``:66``;
    ``obs/memory.pool_capacity``, the one copy the ledger prices)."""
    return pool_capacity(max_leaf_nodes, max_depth, n_samples)


def _n_head(task: str) -> int:
    return 7 + int(task == "regression")


def _stop_and_gain(buf: torch.Tensor, child_depth, *, cfg: BuildConfig,
                   fixed: bool) -> tuple:
    """Stop rules and priority of a decided pair, on the device
    (``_stop_and_gain_jnp``, ``:81``): purity, a constant node,
    ``min_samples_split``, no valid candidate, ``min_impurity_decrease``,
    gbdt's ``min_split_gain`` and the depth cap, in the buffer's dtype as
    the level-by-level engines apply them; a stopped child enters the pool
    at ``-inf``. The gain is float32 from float32 fields (one subtract,
    one multiply). Returns ``(n, stop, gain)``."""
    task = cfg.task
    counts = buf[:, _n_head(task):]
    cost, imp = buf[:, 2], buf[:, 3]
    if task == "classification":
        n = _row_sum(counts)
        pure = (counts > 0).sum(dim=1) <= 1
    else:
        n = counts[:, 0]
        pure = (buf[:, 7] <= 0.0 if task == "regression"
                else torch.zeros_like(n, dtype=torch.bool))
    stop = (pure | (buf[:, 5] > 0) | (n < cfg.min_samples_split)
            | torch.isinf(cost))
    if cfg.min_decrease_scaled > 0.0:
        ref = (_class_node_impurity_dev(counts, cfg.criterion)
               if fixed and task == "classification" else imp)
        stop = stop | (n * (ref - cost) < cfg.min_decrease_scaled)
    imp32, cost32 = imp.to(torch.float32), cost.to(torch.float32)
    if task == "gbdt" and cfg.min_split_gain > 0.0:
        stop = stop | (imp32 - cost32 < float(np.float32(cfg.min_split_gain)))
    if cfg.max_depth is not None:
        stop = stop | (child_depth >= cfg.max_depth)
    gain = imp_ops.leaf_gain(n.to(torch.float32), imp32, cost32, task=task)
    gain = torch.where(stop | torch.isnan(gain),
                       torch.full_like(gain, -math.inf), gain)
    return n, stop, gain


def _stop_and_gain_np(buf: np.ndarray, child_depth: int, *,
                      cfg: BuildConfig, fixed: bool) -> tuple:
    """numpy twin of :func:`_stop_and_gain` for the stepped engine
    (``_stop_and_gain_np``, ``:107``), on the copied buffer in its dtype,
    so both engines rank every pair alike."""
    task = cfg.task
    counts = buf[:, _n_head(task):]
    cost, imp = buf[:, 2], buf[:, 3]
    if task == "classification":
        n = counts.sum(axis=1)
        pure = (counts > 0).sum(axis=1) <= 1
    else:
        n = counts[:, 0]
        pure = (buf[:, 7] <= 0.0 if task == "regression"
                else np.zeros(len(buf), bool))
    with np.errstate(invalid="ignore"):
        stop = (pure | (buf[:, 5] > 0) | (n < cfg.min_samples_split)
                | np.isinf(cost))
        if cfg.min_decrease_scaled > 0.0:
            ref = (class_node_impurity(counts, cfg.criterion)
                   if fixed and task == "classification" else imp)
            stop |= n * (ref - cost) < cfg.min_decrease_scaled
        imp32, cost32 = imp.astype(np.float32), cost.astype(np.float32)
        if task == "gbdt" and cfg.min_split_gain > 0.0:
            stop |= imp32 - cost32 < np.float32(cfg.min_split_gain)
        if cfg.max_depth is not None and child_depth >= cfg.max_depth:
            stop[:] = True
        gain = imp_ops.leaf_gain(n.astype(np.float32), imp32, cost32,
                                 task=task)
        gain = np.where(stop | np.isnan(gain), np.float32(-np.inf), gain)
    return n, stop, gain.astype(np.float32)


def bfs_new_ids(left: np.ndarray) -> np.ndarray:
    """Expansion-ordered ids -> breadth-first ids, ``new_id[old_id]``
    (``:378``): replays the level-by-level allocation (children of a level
    in parent-id order, left before right) over the finished structure;
    ``left`` holds expansion-order ids with ``right = left + 1``."""
    n = len(left)
    perm = np.zeros(n, np.int64)
    frontier = np.array([0], np.int64)
    k = 1
    while len(frontier):
        parents = frontier[left[frontier] >= 0]
        if not len(parents):
            break
        kids = np.empty(2 * len(parents), np.int64)
        kids[0::2] = left[parents]
        kids[1::2] = left[parents] + 1
        perm[kids] = k + np.arange(len(kids))
        k += len(kids)
        frontier = kids
    return perm


def _finalize_leafwise(binned, task: str, criterion: str, n_nodes: int,
                       feat, bins, counts, left, parent, depth,
                       count_dtype) -> tuple:
    """Trim, renumber breadth-first and finalize the expansion-ordered
    host arrays into a TreeArrays (``:405``, on
    ``fused_builder._finalize_tree``); returns ``(tree, perm)``, ``perm``
    the old -> new id map for the rows' node ids."""
    feat, bins, left, parent, depth = (
        np.asarray(a[:n_nodes]) for a in (feat, bins, left, parent, depth))
    counts = np.asarray(counts[:n_nodes])
    perm = bfs_new_ids(left)

    def scatter(a):
        out = np.empty_like(a)
        out[perm] = a
        return out

    left_v = np.where(left >= 0, perm[np.maximum(left, 0)], -1)
    parent_v = np.where(parent >= 0, perm[np.maximum(parent, 0)], -1)
    ints = np.stack([scatter(feat), scatter(bins), scatter(left_v),
                     scatter(parent_v)]).astype(np.int32)
    tree = _finalize_tree(binned, task, criterion, int(n_nodes), ints,
                          scatter(counts), scatter(depth), count_dtype)
    return tree, perm


class _LeafGrown(NamedTuple):
    """One leaf-wise tree as it lies on the device when its build ends:
    expansion-ordered arrays of capacity ``2P - 1`` (plus two dump
    slots) and the number of nodes, never read inside the build."""

    n_nodes: torch.Tensor  # 0-d int64
    ints: torch.Tensor  # (5, M + 2) int32: feature, bin, left, parent, depth
    counts: torch.Tensor  # (M + 2, C) float64
    nid: list  # every shard's (n,) int32 final node of each row


def _pair_kw(fit: FitInputs, cfg: BuildConfig, use_sub: bool) -> dict:
    return dict(n_bins=fit.B, criterion=cfg.criterion,
                min_child_weight=cfg.min_child_weight,
                scale_exp=fit.scale_exp, task=cfg.task,
                y=[sh.y for sh in fit.shards],
                packed=[sh.packed for sh in fit.shards],
                feat_bins=fit.feat_bins, reg_lambda=cfg.reg_lambda,
                min_leaf_rows=cfg.min_leaf_rows, subtraction=use_sub,
                mesh=fit.mesh)


def _rows(fit: FitInputs) -> tuple:
    """Every shard's bins and payload, the pair op's row operands."""
    return [sh.xb for sh in fit.shards], [sh.payload for sh in fit.shards]


# captures made in this process (a capture's key is never warm)
_CAPTURES = itertools.count()


def graph_choice(fit: FitInputs) -> tuple:
    """``(graph, reason)``: whether the fused loop replays one CUDA graph
    per expansion. Not on the CPU, and not on a mesh that reduces: a
    reduction waits for the devices and crosses processes (gloo or NCCL),
    and neither can be captured, so each expansion is launched eagerly
    (its launches and reductions as in the graph)."""
    if fit.dev.type != "cuda":
        return False, "cpu: no CUDA graphs"
    if fit.mesh is not None and fit.mesh.reduces:
        return False, (
            f"mesh of {fit.mesh.size} shards: a reduction synchronises and "
            "crosses processes, which a CUDA graph cannot capture; "
            "expansions launch eagerly")
    return True, "one CUDA graph replay per expansion"


class _LeafLoop:
    """The fused best-first loop (``_make_leafwise_body``, ``:143-345``):
    its state on the device at fixed capacity, updated in place, and its
    step. Every expansion is masked by the on-device ``active`` flag
    (``n_leaves < P`` and an open leaf of finite gain), so the same step
    runs whether the loop has ended or not; a step reads nothing.

    On the card the step's launches are captured once into a CUDA graph
    (after one eager step, which fills the histogram plan's and the
    scales' caches) and replayed: the state lives at fixed addresses, so
    a replay is the same expansion at a fraction of the launch cost. A
    replay adds the launches the capture recorded to ``hist_kernel``'s
    counts, as the wrapper would. :meth:`start` resets the state and
    decides the root, so one loop grows tree after tree (the fused
    boosting rounds), on ``fit``'s payload as it then is; a new
    ``fit.scale_exp`` needs :meth:`recapture`.

    On a data mesh (``_make_leafwise_fn``, ``:348-372``) every shard keeps
    its rows' node ids, each expansion reroutes every shard and its pair
    histogram reduces over the mesh; the pool stays on the lead. Such a
    loop steps without a graph (:func:`graph_choice`, ``graph_reason``)."""

    def __init__(self, fit: FitInputs, cfg: BuildConfig, *, pool: int,
                 use_sub: bool, entry: str = "cuda_graph:leafwise"):
        self.fit, self.cfg, self.use_sub = fit, cfg, use_sub
        self.entry = entry  # the capture's name in the compile record
        self.Pn = Pn = int(pool)
        self.M = M = 2 * Pn - 1
        dev, C = fit.dev, fit.C
        i32, i64, f64 = torch.int32, torch.int64, torch.float64

        def arr(dtype, n, *shape):
            return torch.empty((n,) + shape, dtype=dtype, device=dev)

        # node arrays: slots M and M + 1 take the writes of masked
        # expansions; pool arrays: slot Pn does
        self.ints = arr(i32, 5, M + 2)  # feature, bin, left, parent, depth
        self.counts = arr(f64, M + 2, C)
        self.n = arr(f64, M + 2)
        self.pool_gain = arr(torch.float32, Pn + 1)
        self.pool_node = arr(i64, Pn + 1)
        self.pool_feat = arr(i32, Pn + 1)
        self.pool_bin = arr(i32, Pn + 1)
        self.pool_nl = arr(f64, Pn + 1)
        self.pool_hist = None
        if use_sub:
            self.pool_hist = torch.zeros(
                (Pn + 1, fit.F, C, fit.B), device=dev,
                dtype=i64 if fit.fixed else torch.float32)
        self.nids = [n.clone() for n in fit.root_nids()]
        self.n_nodes = arr(i64, 1)[0]
        self.n_leaves = arr(i64, 1)[0]
        self.dump = torch.tensor([M, M + 1], dtype=i64, device=dev)
        self.no_node = torch.tensor(-2, dtype=i64, device=dev)
        self.root_small = torch.tensor([True, False], device=dev)
        self.zero = torch.zeros((), dtype=i64, device=dev)
        self.graph = None
        self.graph_launches = None
        self.use_graph, self.graph_reason = graph_choice(fit)

    def start(self) -> None:
        """Reset the state and decide the root: every row at node 0 puts
        it in slot 0 of the pair op."""
        fit, cfg = self.fit, self.cfg
        f64 = torch.float64
        self.ints.fill_(-1)  # feature, left, parent; bin and depth 0
        self.ints[1].zero_()
        self.ints[4].zero_()
        self.counts.zero_()
        self.n.zero_()
        self.pool_gain.fill_(-math.inf)
        for a in (self.pool_node, self.pool_feat, self.pool_bin,
                  self.pool_nl):
            a.zero_()
        for nid, nid0 in zip(self.nids, self.fit.root_nids()):
            nid.copy_(nid0)
        self.n_nodes.fill_(1)
        self.n_leaves.fill_(1)
        dec, keep = collective.pair_split_stats(
            *_rows(fit), self.nids, fit.cand_mask, self.zero,
            self.root_small,
            None if self.pool_hist is None else self.pool_hist[self.Pn:],
            **_pair_kw(fit, cfg, self.use_sub))
        n0, _, gain0 = _stop_and_gain(dec, 0, cfg=cfg, fixed=fit.fixed)
        self.counts[0] = dec[0, _n_head(cfg.task):].to(f64)
        self.n[0] = n0[0].to(f64)
        self.pool_gain[0] = gain0[0]
        self.pool_feat[0] = dec[0, 0].to(torch.int32)
        self.pool_bin[0] = dec[0, 1].to(torch.int32)
        self.pool_nl[0] = dec[0, 6].to(f64)
        if self.use_sub:
            self.pool_hist[0] = keep[0]

    def active(self) -> torch.Tensor:
        Pn = self.Pn
        return ((self.n_leaves < Pn)
                & (torch.max(self.pool_gain[:Pn]) > -math.inf))

    def expand(self) -> None:
        """One masked expansion, every write in place."""
        fit, cfg, Pn = self.fit, self.cfg, self.Pn
        i32, i64, f64 = torch.int32, torch.int64, torch.float64
        feat_a, bin_a, left_a, parent_a, depth_a = self.ints

        def at(a, i):
            # a[i] for a 0-d index tensor, as a gather: indexing with a
            # 0-d tensor would read the index on the host
            return a.index_select(0, i.view(1)).squeeze(0)

        active = self.active()
        p = imp_ops.best_leaf_slot(self.pool_gain[:Pn], self.pool_node[:Pn])
        enode = at(self.pool_node, p)
        f, b = at(self.pool_feat, p), at(self.pool_bin, p)
        l_id = self.n_nodes.clone()
        kids = torch.where(active, torch.stack([l_id, l_id + 1]), self.dump)
        e_w = torch.where(active, enode, self.dump[0]).view(1)
        feat_a.index_put_((e_w,), f.view(1))
        bin_a.index_put_((e_w,), b.view(1))
        left_a.index_put_((e_w,), l_id.to(i32).view(1))
        parent_a.index_put_((kids,), enode.to(i32).expand(2))
        child_depth = at(depth_a, enode) + 1
        depth_a.index_put_((kids,), child_depth.expand(2))
        e_r = torch.where(active, enode, self.no_node)
        for nid, x in zip(self.nids, _rows(fit)[0]):
            nid.copy_(collective.reroute_leaf(
                nid, x, *(t.to(nid.device) for t in (e_r, f, b, l_id))))
        # the smaller child accumulates; ties go left (the level-by-level
        # carry's rule)
        small_left = at(self.pool_nl, p) * 2.0 <= at(self.n, enode)
        is_small = torch.stack([small_left, ~small_left])
        phist = None if self.pool_hist is None else \
            self.pool_hist.index_select(0, p.view(1))
        dec, keep = collective.pair_split_stats(
            *_rows(fit), self.nids, fit.cand_mask, l_id, is_small,
            phist, **_pair_kw(fit, cfg, self.use_sub))
        n2, _, gain2 = _stop_and_gain(dec, child_depth, cfg=cfg,
                                      fixed=fit.fixed)
        self.counts.index_put_((kids,), dec[:, _n_head(cfg.task):].to(f64))
        self.n.index_put_((kids,), n2.to(f64))
        # the left child takes its parent's pool slot, the right the next
        slots = torch.where(active, torch.stack([p, self.n_leaves]),
                            torch.full((2,), Pn, dtype=i64, device=fit.dev))
        self.pool_gain.index_put_((slots,), gain2)
        self.pool_node.index_put_((slots,), torch.stack([l_id, l_id + 1]))
        self.pool_feat.index_put_((slots,), dec[:, 0].to(i32))
        self.pool_bin.index_put_((slots,), dec[:, 1].to(i32))
        self.pool_nl.index_put_((slots,), dec[:, 6].to(f64))
        if self.use_sub:
            self.pool_hist.index_put_((slots,), keep)
        step = active.to(i64)
        self.n_nodes.add_(2 * step)
        self.n_leaves.add_(step)

    def recapture(self) -> None:
        """Drop the captured step (the fit's exponents changed)."""
        self.graph = self.graph_launches = None

    def step(self) -> None:
        """One expansion: a replay of the captured step on the card, the
        eager step on the CPU (and at the card's first step)."""
        if not self.use_graph:
            self.expand()
            return
        if self.graph is None:
            self.expand()
            before = dict(hist_kernel.launches)
            graph = torch.cuda.CUDAGraph()
            # every capture is a cold event: its static key, made unique
            with cold_event(self.entry, (self.Pn, self.fit.F, self.fit.C,
                                         self.fit.B, self.cfg.task,
                                         self.use_sub, next(_CAPTURES)),
                            churn=False):
                with torch.cuda.graph(graph):
                    self.expand()
            # a capture launches nothing: its counts move to the replays
            self.graph_launches = {k: hist_kernel.launches[k] - before[k]
                                   for k in before}
            hist_kernel.launches.update(before)
            self.graph = graph
            return
        self.graph.replay()
        for k, v in self.graph_launches.items():
            hist_kernel.launches[k] += v

    def grow(self, check_every: int | None = CHECK_EVERY) -> _LeafGrown:
        """One tree from :meth:`start`: at most ``P - 1`` steps; the host
        reads the 1-byte ``active`` flag once every ``check_every`` steps
        (``done_reads``) and stops when it falls; ``None`` runs all
        ``P - 1`` and reads nothing."""
        global done_reads
        self.start()
        total, done = self.Pn - 1, 0
        while done < total:
            for _ in range(min(check_every or total, total - done)):
                self.step()
                done += 1
            if check_every is not None and done < total:
                done_reads += 1
                if not bool(self.active()):  # the 1-byte read
                    break
        return _LeafGrown(self.n_nodes, self.ints, self.counts, self.nids)


def _build_leafwise_stepped(fit: FitInputs, cfg: BuildConfig, *, pool: int,
                            use_sub: bool, snapshot_slot=None,
                            resume: dict | None = None,
                            timer=None) -> tuple:
    """The host-stepped engine (``_build_leafwise_stepped``, ``:692``):
    the pool on the host, one :func:`collective.expand_step` per expansion
    and one copy of its (2, ...) decisions; under subtraction each open
    leaf's pair histogram stays on the device and comes back as the
    parent operand when the leaf is expanded. Returns expansion-ordered
    host arrays ``(n_nodes, ints (5, M), counts (M, C))`` and every
    shard's device node ids.

    With ``snapshot_slot`` the carry is saved before every expansion, by
    reference (``:692-760``): the node buffers' writes before the
    dispatch are the same values again on a re-run, the pool changes only
    after the dispatch's copy succeeded, and the node ids are replaced,
    never written in place; ``resume`` (a pending snapshot's state)
    continues from one."""
    dev, C = fit.dev, fit.C
    Pn = int(pool)
    M = 2 * Pn - 1
    kw = _pair_kw(fit, cfg, use_sub)
    head = _n_head(cfg.task)

    def scalar(v, dtype=torch.int64):
        return torch.tensor(v, dtype=dtype, device=dev)

    def dispatch(e_node, f, b, l_id, small_left, phist):
        chaos.step("expand_dispatch")
        is_small = torch.tensor([small_left, not small_left], device=dev)
        nid_out, dec, keep = collective.expand_step(
            *_rows(fit), nid, fit.cand_mask, scalar(e_node),
            scalar(f, torch.int32), scalar(b, torch.int32), scalar(l_id),
            is_small, phist, **kw)
        return nid_out, dec.cpu().numpy(), keep  # the expansion's one copy

    if resume is not None:
        feat, bins, left, parent, depth, counts, nvec = resume["bufs"]
        (pool_gain, pool_node, pool_feat, pool_bin, pool_nl,
         pool_hist) = resume["pool"]
        nid = resume["nid"]
        n_nodes, n_leaves = resume["n"]
    else:
        feat = np.full(M, -1, np.int32)
        bins = np.zeros(M, np.int32)
        left = np.full(M, -1, np.int32)
        parent = np.full(M, -1, np.int32)
        depth = np.zeros(M, np.int32)
        counts = np.zeros((M, C), np.float64)
        nvec = np.zeros(M, np.float64)
        pool_gain = np.full(Pn, -np.inf, np.float32)
        pool_node = np.zeros(Pn, np.int64)
        pool_feat = np.zeros(Pn, np.int32)
        pool_bin = np.zeros(Pn, np.int32)
        pool_nl = np.zeros(Pn, np.float64)
        pool_hist: list = [None] * Pn  # (pair histogram, 0 | 1)
        # root: the sentinel -2 reroutes nothing, left_id 0 puts every row
        # in slot 0 of the pair (padding rows of a mesh stay at -1)
        nid = fit.root_nids()
        zeros_ph = (torch.zeros((1, fit.F, C, fit.B), device=dev,
                                dtype=torch.int64 if fit.fixed
                                else torch.float32) if use_sub else None)
        nid, dec, keep = dispatch(-2, 0, 0, 0, True, zeros_ph)
        n0, _, gain0 = _stop_and_gain_np(dec, 0, cfg=cfg, fixed=fit.fixed)
        counts[0] = dec[0, head:]
        nvec[0] = n0[0]
        pool_gain[0] = gain0[0]
        pool_feat[0], pool_bin[0] = dec[0, 0], dec[0, 1]
        pool_nl[0] = dec[0, 6]
        if use_sub:
            pool_hist[0] = (keep, 0)
        n_nodes, n_leaves = 1, 1
    while n_leaves < Pn and pool_gain.max() > -np.inf:
        if snapshot_slot is not None:
            snapshot_slot.save("expansion", n_leaves, dict(
                fit=fit, nid=nid, n=(n_nodes, n_leaves),
                bufs=(feat, bins, left, parent, depth, counts, nvec),
                pool=(pool_gain, pool_node, pool_feat, pool_bin, pool_nl,
                      pool_hist)))
        timer.counter("expansion_dispatches")
        t_exp = time.perf_counter() if timer.enabled else 0.0
        chaos.step("expansion", level=n_leaves)
        p = imp_ops.best_leaf_slot_np(pool_gain, pool_node)
        enode = int(pool_node[p])
        f, b = int(pool_feat[p]), int(pool_bin[p])
        l_id = n_nodes
        feat[enode], bins[enode], left[enode] = f, b, l_id
        parent[l_id] = parent[l_id + 1] = enode
        d_child = int(depth[enode]) + 1
        depth[l_id] = depth[l_id + 1] = d_child
        small_left = bool(pool_nl[p] * 2.0 <= nvec[enode])
        phist = None
        if use_sub:
            held, idx = pool_hist[p]
            phist = held[idx:idx + 1]
        nid, dec, keep = dispatch(enode, f, b, l_id, small_left, phist)
        n2, _, gain2 = _stop_and_gain_np(dec, d_child, cfg=cfg,
                                         fixed=fit.fixed)
        counts[l_id:l_id + 2] = dec[:, head:]
        nvec[l_id:l_id + 2] = n2
        q = n_leaves
        pool_gain[p], pool_gain[q] = gain2
        pool_node[p], pool_node[q] = l_id, l_id + 1
        pool_feat[p], pool_feat[q] = dec[:, 0]
        pool_bin[p], pool_bin[q] = dec[:, 1]
        pool_nl[p], pool_nl[q] = dec[:, 6]
        if use_sub:
            pool_hist[p], pool_hist[q] = (keep, 0), (keep, 1)
        timer.level(
            level=d_child, frontier=2, splits=int(np.sum(gain2 > -np.inf)),
            hist_bytes=collective.split_psum_bytes(
                n_slots=1 if use_sub else 2, n_features=fit.F,
                n_bins=fit.B, n_channels=fit.C,
                itemsize=8 if fit.fixed else 4),
            psum_bytes=None,
            rows_scanned=float(n2[0] if small_left else n2[1])
            if use_sub else float(n2.sum()),
            small_child_fraction=None,
            seconds=(round(time.perf_counter() - t_exp, 6)
                     if timer.enabled else None),
            new_lowerings=0)
        n_nodes += 2
        n_leaves += 1
    return n_nodes, np.stack([feat, bins, left, parent, depth]), counts, nid


def replay_leafwise(timer, tree, fit: FitInputs, cfg: BuildConfig,
                    use_sub: bool, *, level_rows: bool,
                    price: str | None = None) -> None:
    """A leaf-wise build's scan counters, per-depth rows (the fused
    loop's, ``level_rows``) and fingerprint rows, replayed from the
    finished ``tree`` into ``timer``; ``price`` names the compute-ledger
    entry the build's launches are priced under (``leafwise_fn`` for the
    fused loop, ``expand_fn`` a host-stepped expansion)."""
    rows, _, counters = obs_acct.leafwise_scan_rows(
        tree, n_features=fit.F, n_bins=fit.B, n_channels=fit.C,
        task=cfg.task, subtraction=use_sub,
        itemsize=8 if fit.fixed else 4)
    for name, v in counters.items():
        timer.counter(name, v)
    if level_rows:
        for r in rows:
            timer.level(**r)
    if price is not None:
        n_exp = int(np.sum(tree.left >= 0))
        obs_acct.price_leafwise(
            timer, price, fit, counters, expansions=n_exp,
            subtraction=use_sub,
            dispatches=n_exp if price == "expand_fn" else 1)
    if timer.wants_fingerprints:
        timer.fingerprint_tree(obs_acct.replay_fingerprints(tree))


def leafwise_subtraction(fit: FitInputs, cfg: BuildConfig, pool: int,
                         obs=None) -> bool:
    """Sibling subtraction for a leaf-wise build: as
    ``builder.resolve_hist_subtraction`` says (``obs`` records its
    evidence consultation), while the pool's resident histograms
    ((P + 1) x F x C x B cells, 8 bytes on the fixed-point route) fit
    ``cfg.hist_budget_bytes``."""
    cell = 8 if fit.fixed else 4
    return (resolve_hist_subtraction(
                cfg, fit.dev, obs=obs,
                shape=evidence_shape(fit.N, fit.F, fit.B))
            and (pool + 1) * fit.F * fit.C * fit.B * cell
            <= cfg.hist_budget_bytes)


def build_tree_leafwise(binned, y: np.ndarray, *, config: BuildConfig,
                        n_classes: int | None = None,
                        sample_weight: np.ndarray | None = None,
                        packed: torch.Tensor | None = None,
                        return_leaf_ids: bool = False,
                        refit_targets: np.ndarray | None = None,
                        feature_sampler=None,
                        feature_mask: np.ndarray | None = None,
                        mono_cst: np.ndarray | None = None,
                        timer=None, mesh=None,
                        x_shards=None, snapshot_slot=None):
    """Grow one tree best-first; ``core/builder.build_tree``'s contract
    (``build_tree_leafwise``, ``:437``), which routes here whenever
    ``cfg.max_leaf_nodes`` is set. The engine comes from
    ``builder.resolve_engine`` (``"auto"`` is fused for every task). Regression refits its node values
    exactly from the rows' final nodes (``refit_regression_values``);
    ``return_leaf_ids`` gives those nodes in the finished tree's ids.
    ``timer`` (``builder.build_tree``'s) receives the JAX package's
    record (``:560-672``): the ``engine``, ``frontier`` (``"leafwise"``,
    with the pool and, for the fused engine, the CUDA-graph choice
    ``graph``/``graph_reason`` among its inputs) and ``hist_subtraction``
    decisions, the spans ``shard``, ``leafwise_build`` and
    ``host_finalize``, the ``expansions``, ``rows_scanned`` and
    ``rows_frontier`` counters and the fingerprint rows replayed from the
    finished tree (``obs/accounting.leafwise_scan_rows``); the fused
    engine's per-depth rows are replayed too, never recorded inside the
    graph, and the stepped engine writes one row an expansion live. On a
    data ``mesh`` the rows shard over it
    and every pair histogram reduces over it (``_make_leafwise_fn``,
    ``:348-372``): the tree is the one-device tree field for field. A
    ``(data, feature)`` mesh raises, as in the JAX package
    (``:481-505``)."""
    cfg = config
    if feature_sampler is not None and feature_sampler.active:
        raise ValueError(
            "max_leaf_nodes does not support per-node feature sampling "
            "(max_features / splitter='random') yet"
        )
    if mono_cst is not None and bool(np.any(np.asarray(mono_cst) != 0)):
        raise ValueError("max_leaf_nodes does not support monotonic_cst yet")
    if mesh is not None:
        from mpitree_tpu_torch.parallel.mesh import feature_shards

        if feature_shards(mesh) > 1:
            raise ValueError(
                "max_leaf_nodes supports 1-D data meshes only "
                "(mesh2d_unsupported: the best-first frontier has no "
                "feature-axis select_global twin)")
    timer = timer if timer is not None else PhaseTimer(enabled=False)
    engine, reason = engine_decision(cfg)
    if cfg.engine == "auto" and engine == "fused":
        reason = ("auto: the best-first loop runs one expansion per step; "
                  "per-expansion host dispatch would put O(max_leaf_nodes) "
                  "round trips on the critical path, so the fused loop "
                  "(one CUDA graph replay an expansion on the card) is the "
                  "default")
    slot = (snapshot_slot if engine != "fused" and snapshot_slot is not None
            and resolve_level_retry() else None)
    resume = None if slot is None else slot.take("expansion")
    if resume is not None:
        fit = resume["fit"]
    else:
        with timer.phase("shard"):
            fit = FitInputs(
                binned, y, cfg, n_classes=n_classes,
                sample_weight=sample_weight, packed=packed,
                feature_mask=feature_mask, mesh=mesh, x_shards=x_shards)
    pool = _pool_capacity(cfg.max_leaf_nodes, cfg.max_depth, fit.N)
    use_sub = leafwise_subtraction(fit, cfg, pool, obs=timer)
    timer.set_mesh(mesh, device=fit.dev)
    timer.decision("engine", engine, reason=reason, rows=int(fit.N),
                   features=int(fit.F), bins=int(fit.B), task=cfg.task)
    frontier_in = dict(max_leaf_nodes=int(cfg.max_leaf_nodes),
                       pool=int(pool))
    if engine == "fused":
        loop = _LeafLoop(fit, cfg, pool=pool, use_sub=use_sub)
        frontier_in.update(graph=loop.use_graph,
                           graph_reason=loop.graph_reason)
    timer.decision(
        "frontier", "leafwise",
        reason=(f"max_leaf_nodes={cfg.max_leaf_nodes}: best-first priority "
                f"pool of {pool} open leaves; each expansion pays one "
                "sibling-pair histogram"
                + (" (smaller child only, larger = parent - small)"
                   if use_sub else "")),
        **frontier_in)
    note_subtraction(timer, use_sub, leafwise=True)
    if engine == "fused":
        chaos.step("leafwise_build")
        with timer.phase("leafwise_build"):
            g = loop.grow()
            flat = torch.cat([g.ints.flatten(),
                              g.n_nodes.view(1).to(torch.int32)])
            flat = flat.cpu().numpy()  # one copy of the structure
        n_nodes = int(flat[-1])
        ints = flat[:-1].reshape(5, -1)
        counts = g.counts.cpu().numpy()
        nid = g.nid
        timer.counter("leafwise_fused_builds")
    else:
        n_nodes, ints, counts, nid = _build_leafwise_stepped(
            fit, cfg, pool=pool, use_sub=use_sub, snapshot_slot=slot,
            resume=resume, timer=timer)
        if slot is not None:
            slot.clear()
        timer.counter("leafwise_stepped_builds")
    with timer.phase("host_finalize"):
        tree, perm = _finalize_leafwise(
            binned, cfg.task, cfg.criterion, n_nodes, *ints[:2], counts,
            ints[2], ints[3], ints[4], _count_dtype(cfg.task, sample_weight))
    replay_leafwise(timer, tree, fit, cfg, use_sub,
                    level_rows=engine == "fused",
                    price="leafwise_fn" if engine == "fused" else "expand_fn")
    leaf_ids = None
    if return_leaf_ids or (cfg.task == "regression"
                           and refit_targets is not None):
        leaf_ids = perm[fit.leaf_ids(nid)].astype(np.int32)
    if cfg.task == "regression" and refit_targets is not None:
        w64 = (np.ones(fit.N) if sample_weight is None
               else np.asarray(sample_weight)).astype(np.float64)
        refit_regression_values(tree, leaf_ids, w64,
                                np.asarray(refit_targets, np.float64))
    if return_leaf_ids:
        return tree, leaf_ids
    return tree

