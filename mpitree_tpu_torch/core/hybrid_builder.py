"""The hybrid build's refine tail: the crown on the card, the deep tail on
the host's cores with exact local candidates.

Counterpart of ``mpitree_tpu/core/hybrid_builder.py``. Quantile bins
starve the deep tail of candidates: a node at depth 10 spans a narrow slice
of each feature, and few of the 256 global edges fall inside it. The
hybrid splits the build:

1. the device engine (``core/builder.py``) grows the tree to the crown
   depth and hands back every row's leaf id (one copy; after a crown on
   a data mesh, ``core/builder.FitInputs.leaf_ids`` gathers them from the
   shards in the caller's row order, padding dropped, and across
   processes by one all-reduce of an N-row int32 vector each process
   fills with its own rows, so every process runs the same tail on the
   same inputs);
2. every still-splittable crown leaf (impure, enough samples, at or above
   the crown depth, including leaves the crown stopped as "constant" under
   the global bins) becomes the root of a host subtree grown with **exact
   local candidates**, every unique value among the node's own rows (the
   reference's semantics, ``mpitree/tree/decision_tree.py:73``);
3. the subtrees graft back into the struct-of-arrays tree; children keep
   larger ids than their parents, so predict, export and pruning work
   unchanged.

Two tail engines, identical trees (each frontier slot's result depends only
on its own rows):

- **batched** (the native C++ sweep is loaded): all subtrees grow together
  in one multi-root levelwise frontier, one sweep call per level, with
  per-(node, feature) candidate counts;
- **per-subtree** (no native library, or ``splitter="random"``, whose
  drawn bins the C++ sweep cannot take): ``build_tree_host`` once per
  candidate leaf, on that leaf's rows binned with ``binning="exact"``.

Feature sampling continues below the crown: each subtree root starts from
its crown leaf's path-derived key (``NodeFeatureSampler.keys_for_tree``),
so the tail draws what a single engine growing the whole tree would. A
forest tree's fixed subspace (``feature_mask``) zeroes the other features'
candidates; their bins still count for the ``constant`` stop.

A regression tail sweeps the moments with the C++ regression sweep and
refits its subtrees' values exactly from their rows
(``core/builder.refit_regression_values``), as the JAX package does.

A streamed fit has no raw matrix: its ``X`` is a row provider
(``ingest/stream.StreamRowProvider``), and the tail replays the chunk
stream once for the sorted union of its candidates' rows
(:class:`_GatheredRows`), so it refines exactly as an in-memory fit does.

The tail runs in its observer's ``refine`` span and commits each refined
subtree's fingerprint rows under the ``refine`` channel, its node ids in
local rank order, as the JAX package's two tail engines do
(``mpitree_tpu/core/hybrid_builder.py:336-353,580-590``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from mpitree_tpu_torch import native
from mpitree_tpu_torch.core.builder import (
    new_tree_buffer,
    refit_regression_values,
)
from mpitree_tpu_torch.core.host_builder import (
    _leaf_stats,
    _native_level_decisions,
    _record_level,
    _split_and_advance,
    build_tree_host,
)
from mpitree_tpu_torch.core.tree_struct import TreeArrays
from mpitree_tpu_torch.obs.fingerprint import subtree_fingerprints
from mpitree_tpu_torch.ops.binning import bin_dataset
from mpitree_tpu_torch.utils.profiling import PhaseTimer


def _alloc_extended(top: TreeArrays, n_total: int) -> TreeArrays:
    """Copy ``top`` into freshly allocated arrays of ``n_total`` nodes
    (shared by both graft engines, so no field is wired into only one)."""

    def alloc(arr, fill):
        shape = (n_total,) + arr.shape[1:]
        out = np.full(shape, fill, arr.dtype) if arr.ndim == 1 else np.zeros(
            shape, arr.dtype
        )
        out[: top.n_nodes] = arr
        return out

    return TreeArrays(
        feature=alloc(top.feature, -1),
        threshold=alloc(top.threshold, np.nan),
        left=alloc(top.left, -1),
        right=alloc(top.right, -1),
        parent=alloc(top.parent, -1),
        depth=alloc(top.depth, 0),
        value=alloc(top.value, 0),
        count=alloc(top.count, 0),
        n_node_samples=alloc(top.n_node_samples, 0),
        impurity=alloc(top.impurity, 0),
    )


def _concat_trees(top: TreeArrays, subtrees: list, attach_at: list) -> TreeArrays:
    """Graft ``subtrees[i]`` in place of leaf ``attach_at[i]`` of ``top``.

    The grafted root reuses the leaf's id; descendants append after all
    existing nodes in discovery order, so children keep larger ids.
    """
    n_total = top.n_nodes
    offsets = []
    for st in subtrees:
        # subtree node 0 maps onto the attach point; nodes 1.. append
        offsets.append(n_total - 1)
        n_total += st.n_nodes - 1

    ext = _alloc_extended(top, n_total)
    for st, at, off in zip(subtrees, attach_at, offsets):
        dst = np.concatenate(
            [[at], off + 1 + np.arange(st.n_nodes - 1, dtype=np.int64)]
        )
        pars = np.where(st.parent >= 0, dst[st.parent], ext.parent[at])
        ext.feature[dst] = st.feature
        ext.threshold[dst] = st.threshold
        ext.left[dst] = np.where(st.left >= 0, dst[st.left], -1)
        ext.right[dst] = np.where(st.right >= 0, dst[st.right], -1)
        # the grafted root keeps the top tree's parent link
        ext.parent[dst[1:]] = pars[1:]
        ext.depth[dst] = st.depth + ext.depth[at]
        ext.value[dst] = st.value.astype(ext.value.dtype)
        ext.count[dst] = st.count.astype(ext.count.dtype)
        ext.n_node_samples[dst] = st.n_node_samples
        ext.impurity[dst] = st.impurity
    return ext


def _bin_per_root(Xr: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Exact local binning per (root, feature) over the gathered rows.

    ``np.unique(col, return_inverse=True)`` gives the bin ids (each value's
    rank among the root's uniques) and the local thresholds
    ``unique[:-1]``. Returns the binned matrix, the per-(root, feature)
    candidate counts and the ragged threshold store (offsets, flat array).
    """
    R, F = len(starts), Xr.shape[1]
    xb = np.empty(Xr.shape, np.int32)
    ncand = np.zeros((R, F), np.int32)
    off = np.zeros((R, F), np.int64)
    chunks = []
    pos = 0
    for i in range(R):
        sl = slice(starts[i], ends[i])
        for f in range(F):
            uniq, inv = np.unique(Xr[sl, f], return_inverse=True)
            xb[sl, f] = inv
            ncand[i, f] = len(uniq) - 1
            off[i, f] = pos
            pos += len(uniq) - 1
            if len(uniq) > 1:
                chunks.append(uniq[:-1])
    thr_flat = (
        np.concatenate(chunks).astype(np.float32) if chunks
        else np.empty(0, np.float32)
    )
    return xb, ncand, off, thr_flat


def _refine_batched(top: TreeArrays, X, y_enc, candidates, rows_per, *,
                    cfg_sub, max_depth_total, root_depth, n_classes,
                    sample_weight, obs,
                    refit_targets=None, feature_mask=None,
                    feature_sampler=None, root_keys=None) -> TreeArrays:
    """Grow every deep subtree together in one multi-root host frontier.

    ``root_depth[i]`` is candidate ``i``'s depth in the crown: candidates
    need not share a depth, so each root has its own budget of
    ``max_depth_total - root_depth[i]`` further levels. ``obs`` (a
    PhaseTimer) keeps the seconds of the exact per-root binning and of the
    C++ sweeps beside its ``refine`` phase (``bin_seconds``,
    ``sweep_seconds``) and each subtree's fingerprint rows. ``root_keys``
    are the candidates' sampling keys when ``feature_sampler`` is
    active.
    """
    R = len(candidates)
    sizes = np.array([len(r) for r in rows_per], np.int64)
    rows_all = np.concatenate(rows_per)
    starts = np.zeros(R, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    ends = starts + sizes
    sub_of = np.repeat(np.arange(R, dtype=np.int32), sizes)

    t0 = time.perf_counter()
    Xr = np.ascontiguousarray(X[rows_all], np.float32)
    xb, ncand, off, thr_flat = _bin_per_root(Xr, starts, ends)
    del Xr
    bin_s = time.perf_counter() - t0
    sweep_s = 0.0
    # sized before the subspace mask zeroes candidates: masked features'
    # bins still reach the sweep (JAX hybrid_builder.py:212-217)
    n_bins = int(ncand.max(initial=0)) + 1
    if feature_mask is not None:
        ncand[:, ~np.asarray(feature_mask, bool)] = 0

    Nr = len(rows_all)
    task = cfg_sub.task
    regression = task == "regression"
    y_r = np.ascontiguousarray(y_enc[rows_all],
                               np.float32 if regression else np.int32)
    C = 3 if regression else int(n_classes)
    w = None if sample_weight is None else np.ascontiguousarray(
        sample_weight[rows_all], np.float64
    )
    w_dense = np.ones(Nr) if w is None else w

    # the crown's dtype rule: the graft's count.astype(...) never truncates
    buf = new_tree_buffer(task, C, w)
    buf.ensure(R)
    buf.n = R
    root_of = np.arange(R, dtype=np.int32)
    sampling = feature_sampler is not None and feature_sampler.active
    keys = feature_sampler.key_store(root_keys) if sampling else None
    root_depth = np.asarray(root_depth, np.int32)
    rem = (
        None if max_depth_total is None
        else (int(max_depth_total) - root_depth)
    )
    nid = sub_of.copy()
    frontier_lo, frontier_size, depth = 0, R, 0

    while frontier_size > 0:
        S = frontier_size
        terminal = rem is not None and depth == int(rem.max())
        slot = nid - frontier_lo
        live = slot >= 0
        ids = frontier_lo + np.arange(S)
        slot_roots = root_of[frontier_lo:frontier_lo + S]

        if terminal:
            # every surviving root is depth-exhausted: leaf stats only
            counts, n, value, node_imp = _leaf_stats(
                slot, live, y_r, w_dense, S, C, criterion=cfg_sub.criterion,
                task=task,
            )
            _record_level(buf, ids, S, True, None, None, value, n, counts,
                          node_imp)
            break

        ncand_slot = np.ascontiguousarray(ncand[slot_roots])
        if sampling:  # a node's unsampled features cannot win
            ncand_slot = np.where(keys.masks(frontier_lo, frontier_lo + S),
                                  ncand_slot, 0).astype(np.int32)
        if rem is not None:
            # Budget-exhausted roots' nodes become leaves this level: zero
            # their candidates so the kernel only counts them.
            exhausted = rem[slot_roots] <= depth
            ncand_slot[exhausted] = 0
        t0 = time.perf_counter()
        if regression:
            nat = native.best_splits_regression(
                xb, y_r, nid, w, n_bins=n_bins, frontier_lo=frontier_lo,
                n_slots=S, n_cand=ncand_slot, n_cand_per_slot=True,
                min_child_weight=cfg_sub.min_child_weight,
            )
        else:
            nat = native.best_splits_classification(
                xb, y_r, nid, w, n_bins=n_bins, n_classes=C,
                frontier_lo=frontier_lo, n_slots=S, n_cand=ncand_slot,
                n_cand_per_slot=True, criterion=cfg_sub.criterion,
                min_child_weight=cfg_sub.min_child_weight,
            )
        sweep_s += time.perf_counter() - t0
        counts, n, value, node_imp, feat_best, bin_best, stop = (
            _native_level_decisions(nat, cfg=cfg_sub)
        )
        if rem is not None:
            stop = stop | (rem[slot_roots] <= depth)
        _record_level(buf, ids, S, False, stop, feat_best, value, n, counts,
                      node_imp)
        thr_values = thr_flat[
            off[slot_roots[~stop], feat_best[~stop]] + bin_best[~stop]
        ]
        n_split = int((~stop).sum())
        nid, frontier_lo, frontier_size, depth = _split_and_advance(
            buf, None, xb, nid, ids, stop, feat_best, bin_best,
            slot, live, S, frontier_lo, depth, thr_values=thr_values,
        )
        if n_split:
            root_of = np.concatenate(
                [root_of, np.repeat(slot_roots[~stop], 2)]
            )
            if sampling:
                split_ids = ids[~stop]
                keys.assign_children(split_ids, buf.left[split_ids],
                                     buf.right[split_ids], buf.n)

    obs.add_phase("refine", bin_seconds=bin_s, sweep_seconds=sweep_s)
    bt = buf.finalize()
    if regression and refit_targets is not None:
        refit_regression_values(
            bt, nid, w_dense, np.asarray(refit_targets, np.float64)[rows_all]
        )
    if obs.wants_fingerprints:
        # each subtree's rows, its ids in local rank order: what the
        # per-subtree engine commits for the same subtree
        for r in range(R):
            ids = np.flatnonzero(root_of == r)
            if len(ids) > 1:
                obs.fingerprint_tree(subtree_fingerprints(
                    bt.depth, bt.n_node_samples, bt.feature, bt.threshold,
                    bt.left, bt.right, ids=ids))
    return _graft_batched(top, bt, candidates, root_depth[root_of])


def _graft_batched(top: TreeArrays, bt: TreeArrays, attach,
                   depth_offset: np.ndarray) -> TreeArrays:
    """Remap the batched tail tree into the crown.

    Batched node ``i < R`` (a root) reuses crown leaf ``attach[i]``'s id;
    nodes ``i >= R`` append after the crown in batched order.
    ``depth_offset[i]`` is batched node ``i``'s root's depth in the crown.
    """
    R = len(attach)
    extra = bt.n_nodes - R
    dst = np.empty(bt.n_nodes, np.int64)
    dst[:R] = np.asarray(attach, np.int64)
    dst[R:] = top.n_nodes + np.arange(extra, dtype=np.int64)

    ext = _alloc_extended(top, top.n_nodes + extra)

    def remap(child):
        return np.where(child >= 0, dst[np.clip(child, 0, None)], -1)

    # A root that did not split keeps the crown leaf byte for byte, as the
    # per-subtree engine (which skips it) does: the host's f64 stats could
    # otherwise move its low-order count or impurity.
    keep = np.ones(bt.n_nodes, bool)
    keep[:R] = np.asarray(bt.left[:R]) >= 0
    src, d = np.arange(bt.n_nodes)[keep], dst[keep]

    ext.feature[d] = bt.feature[src]
    ext.threshold[d] = bt.threshold[src]
    ext.left[d] = remap(bt.left)[src]
    ext.right[d] = remap(bt.right)[src]
    # grafted roots keep the crown's parent link; descendants remap
    ext.parent[dst[R:]] = dst[np.clip(bt.parent[R:], 0, None)]
    ext.depth[d] = (bt.depth + depth_offset)[src]
    ext.value[d] = bt.value[src].astype(ext.value.dtype)
    ext.count[d] = bt.count[src].astype(ext.count.dtype)
    ext.n_node_samples[d] = bt.n_node_samples[src]
    ext.impurity[d] = bt.impurity[src]
    return ext


class _GatheredRows:
    """A gathered block of raw rows standing in for the training matrix
    (``mpitree_tpu/core/hybrid_builder.py:47-65``). The tail engines only
    index ``X`` by arrays of training rows (``X[rows_all]``, ``X[rows]``),
    so one replay of the chunk stream for the sorted union of every
    candidate's rows serves them; the candidates' row sets are disjoint,
    so the block is exactly the tail's working set."""

    def __init__(self, rows: np.ndarray, block: np.ndarray):
        self._rows = rows          # sorted global row ids
        self._block = block        # (len(rows), F) float32

    def __getitem__(self, idx):
        return self._block[np.searchsorted(self._rows, idx)]


def refine_deep_subtrees(tree: TreeArrays, X: np.ndarray, y_enc: np.ndarray,
                         leaf_ids: np.ndarray, *, config, refine_depth: int,
                         n_classes: int | None = None,
                         sample_weight: np.ndarray | None = None,
                         obs=None,
                         refit_targets: np.ndarray | None = None,
                         feature_mask: np.ndarray | None = None,
                         feature_sampler=None) -> TreeArrays:
    """Host-finish every still-splittable leaf of the crown.

    ``tree`` is the crown (grown to ``refine_depth``), ``leaf_ids`` the
    training rows' leaf in it, ``config.max_depth`` the whole tree's depth.
    Candidates are chosen by outcome, not by depth alone: any leaf at depth
    <= ``refine_depth`` with impurity > 0 and enough samples. Rows of
    weight 0 (a bootstrap's undrawn rows) stay with their leaf: they add to
    no count but their values are among its exact candidates, as in the
    JAX package. ``obs`` (a PhaseTimer or ``obs.BuildObserver``) receives
    the ``refine_candidates`` counter, the ``refine_tail`` decision, each
    refined subtree's fingerprint rows (``obs/fingerprint.
    subtree_fingerprints``, the JAX package's commits) and, from the
    batched engine, its seconds. A
    regression tail (``config.task``) takes ``y_enc`` as the float32
    centred targets and ``refit_targets`` as the float64 ones.
    ``feature_mask`` (F,) bool keeps a forest tree's subspace;
    ``feature_sampler`` continues the crown's per-node sampling. ``X``
    may be a streamed fit's row provider (anything with ``gather``).
    """
    cfg = config
    if cfg.max_depth is not None and int(cfg.max_depth) <= refine_depth:
        return tree

    candidates = np.flatnonzero(
        (tree.feature < 0)
        & (tree.depth <= refine_depth)
        & (tree.n_node_samples >= cfg.min_samples_split)
        # pure leaves (exact 0.0 impurity in every engine) cannot split
        & (tree.impurity > 0)
    )
    if len(candidates) == 0:
        return tree

    order = np.argsort(leaf_ids, kind="stable")
    sorted_leaves = leaf_ids[order]
    starts = np.searchsorted(sorted_leaves, candidates, side="left")
    ends = np.searchsorted(sorted_leaves, candidates, side="right")
    keep = ends > starts
    if not keep.any():
        return tree
    candidates, starts, ends = candidates[keep], starts[keep], ends[keep]
    if hasattr(X, "gather"):
        # a streamed fit: one replay of the chunk stream for the sorted
        # union of the candidates' rows, which both tail engines index
        needed = np.sort(
            np.concatenate([order[s:e] for s, e in zip(starts, ends)]))
        X = _GatheredRows(needed, X.gather(needed))
    sampling = feature_sampler is not None and feature_sampler.active
    batched = native.lib() is not None and not (
        feature_sampler is not None and feature_sampler.random_split)
    root_keys = (feature_sampler.keys_for_tree(tree)[candidates]
                 if sampling else None)
    obs = PhaseTimer(enabled=False) if obs is None else obs
    obs.counter("refine_candidates", len(candidates))
    obs.decision(
        "refine_tail", "batched-native" if batched else "per-subtree",
        reason=("C++ kernel available: all subtrees grow in one multi-root "
                "frontier" if batched else
                "no native kernel (or splitter='random'): per-subtree "
                "host builds"),
        refine_depth=int(refine_depth),
    )

    if batched:
        return _refine_batched(
            tree, X, y_enc, candidates,
            [order[s:e] for s, e in zip(starts, ends)],
            cfg_sub=cfg, max_depth_total=cfg.max_depth,
            root_depth=tree.depth[candidates], n_classes=n_classes,
            sample_weight=sample_weight, obs=obs,
            refit_targets=refit_targets, feature_mask=feature_mask,
            feature_sampler=feature_sampler, root_keys=root_keys,
        )

    subtrees, attach = [], []
    for idx, (leaf, s, e) in enumerate(zip(candidates, starts, ends)):
        rows = order[s:e]
        # min_samples_split is a weighted rule: the subtree build applies
        # it itself (a single node means it stopped)
        remaining = (
            None if cfg.max_depth is None
            else int(cfg.max_depth) - int(tree.depth[leaf])
        )
        st = build_tree_host(
            bin_dataset(X[rows], binning="exact"), y_enc[rows],
            config=dataclasses.replace(cfg, max_depth=remaining),
            n_classes=n_classes,
            sample_weight=None if sample_weight is None
            else sample_weight[rows],
            refit_targets=None if refit_targets is None
            else refit_targets[rows],
            feature_mask=feature_mask,
            feature_sampler=dataclasses.replace(
                feature_sampler, root_key_value=int(root_keys[idx]),
            ) if sampling else None,
        )
        if st.n_nodes > 1:  # else immediately stopped: keep the leaf
            subtrees.append(st)
            attach.append(int(leaf))
    if not subtrees:
        return tree
    if obs.wants_fingerprints:
        for st in subtrees:
            obs.fingerprint_tree(subtree_fingerprints(
                st.depth, st.n_node_samples, st.feature, st.threshold,
                st.left, st.right))
    return _concat_trees(tree, subtrees, attach)


def apply_refine(tree, leaf_ids, X, y, *, cfg, max_depth, rd, timer,
                 n_classes=None, sample_weight=None, refit_targets=None,
                 feature_mask=None, feature_sampler=None):
    """The estimators' entry: the refine tail of a crown built with
    ``cfg`` (whose ``max_depth`` is the crown depth ``rd``) down to
    ``max_depth``, in ``timer``'s ``refine`` span; ``timer`` also counts
    ``refine_nodes_added`` (``mpitree_tpu/core/hybrid_builder.py:405``)."""
    with timer.phase("refine"):
        out = refine_deep_subtrees(
            tree, X, y, leaf_ids,
            config=dataclasses.replace(cfg, max_depth=max_depth),
            refine_depth=rd, n_classes=n_classes,
            sample_weight=sample_weight, obs=timer,
            refit_targets=refit_targets, feature_mask=feature_mask,
            feature_sampler=feature_sampler,
        )
    timer.counter("refine_nodes_added", int(out.n_nodes - tree.n_nodes))
    return out
