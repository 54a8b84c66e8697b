"""Minimal cost-complexity pruning (sklearn's ``ccp_alpha``) on a finished
tree, host numpy, whatever engine built it.

Counterpart of ``mpitree_tpu/utils/pruning.py``: the node weight is its
class mass (classification) or its training row count (regression, as the
JAX package keeps it: per-node sample weights are not stored). sklearn's
weakest-link algorithm: with node risk
``R(t) = (w_t / w_root) * impurity(t)`` and subtree risk ``R(T_t)`` (the sum
of leaf risks below ``t``), an interior node's effective alpha is
``(R(t) - R(T_t)) / (|leaves(T_t)| - 1)``; nodes collapse weakest first
while their effective alpha is ``<= ccp_alpha``.
"""

from __future__ import annotations

import heapq

import numpy as np

from mpitree_tpu_torch.core.tree_struct import TreeArrays


class Bunch(dict):
    """A dict whose keys also read as attributes (sklearn's ``Bunch``)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e


def _node_risk(tree: TreeArrays, task: str) -> np.ndarray:
    if task == "classification":
        w = tree.count.sum(axis=1).astype(np.float64)
    elif task == "regression":
        w = tree.n_node_samples.astype(np.float64)
    else:
        raise ValueError(f"unknown task {task!r}")
    return (w / max(w[0], 1e-300)) * np.asarray(tree.impurity, np.float64)


def _subtree_stats(tree: TreeArrays, r: np.ndarray):
    """(r_subtree, n_leaves) per node, one reverse pass (children ids are
    always larger than their parent's, in every engine's allocation)."""
    leaf = tree.feature < 0
    r_sub = np.where(leaf, r, 0.0)
    leaves = np.where(leaf, 1, 0).astype(np.int64)
    for i in range(tree.n_nodes - 1, 0, -1):
        p = tree.parent[i]
        if p >= 0:
            r_sub[p] += r_sub[i]
            leaves[p] += leaves[i]
    return r_sub, leaves


def _descendants(tree: TreeArrays, t: int) -> list:
    out, stack = [], [t]
    while stack:
        i = stack.pop()
        for c in (int(tree.left[i]), int(tree.right[i])):
            if c >= 0:
                out.append(c)
                stack.append(c)
    return out


def ccp_prune(tree: TreeArrays, ccp_alpha: float, *,
              task: str = "classification") -> TreeArrays:
    """The minimal cost-complexity pruning of ``tree`` at ``ccp_alpha``
    (``tree`` itself when ``ccp_alpha == 0`` or it is a single leaf)."""
    if ccp_alpha < 0:
        raise ValueError(f"ccp_alpha must be >= 0, got {ccp_alpha!r}")
    if ccp_alpha == 0 or tree.n_nodes <= 1:
        return tree
    return _prune_impl(tree, ccp_alpha, task)


def _prune_impl(tree: TreeArrays, ccp_alpha: float, task: str,
                path_out: list | None = None) -> TreeArrays:
    """Weakest-link pruning at ``ccp_alpha`` without the zero
    short-circuit: collapses every node whose effective alpha is
    ``<= ccp_alpha``, zero included (``pruning_path`` needs that to pass a
    split of zero gain). ``path_out`` receives
    ``(effective_alpha, total_leaf_risk_after)`` per collapse, in
    ascending alpha, so one sweep at ``inf`` yields the whole path."""
    n = tree.n_nodes
    r = _node_risk(tree, task)
    r_sub, leaves = _subtree_stats(tree, r)
    removed = np.zeros(n, bool)    # inside a cut
    collapsed = np.zeros(n, bool)  # interior node turned leaf

    def alpha_eff(t: int) -> float:
        return (r[t] - r_sub[t]) / max(leaves[t] - 1, 1)

    # Lazy heap: stale entries (outdated alpha, removed or collapsed
    # nodes) are dropped at pop time by re-checking the current value.
    heap = [(alpha_eff(t), int(t)) for t in np.nonzero(tree.feature >= 0)[0]]
    heapq.heapify(heap)
    while heap:
        a, t = heapq.heappop(heap)
        if removed[t] or collapsed[t] or tree.feature[t] < 0:
            continue
        cur = alpha_eff(t)
        if a != cur:  # stale: a descendant's collapse moved its stats
            heapq.heappush(heap, (cur, t))
            continue
        if a > ccp_alpha:
            break
        collapsed[t] = True
        for d in _descendants(tree, t):
            removed[d] = True
        d_r, d_leaves = r[t] - r_sub[t], 1 - leaves[t]
        r_sub[t] = r[t]
        leaves[t] = 1
        p = int(tree.parent[t])
        while p >= 0:
            r_sub[p] += d_r
            leaves[p] += d_leaves
            if not (removed[p] or collapsed[p]):
                heapq.heappush(heap, (alpha_eff(p), p))
            p = int(tree.parent[p])
        if path_out is not None:
            path_out.append((max(a, 0.0), float(r_sub[0])))

    if not collapsed.any():
        return tree

    # Compact: drop removed nodes in their order (children stay after
    # their parents).
    keep = ~removed
    new_id = np.cumsum(keep) - 1
    feature = tree.feature[keep].copy()
    left = tree.left[keep].copy()
    right = tree.right[keep].copy()
    threshold = tree.threshold[keep].copy()
    is_cut = collapsed[keep]
    feature[is_cut] = -1
    left[is_cut] = -1
    right[is_cut] = -1
    threshold[is_cut] = np.nan

    def remap(ids):
        return np.where(ids >= 0, new_id[np.clip(ids, 0, None)], -1).astype(
            np.int32)

    return TreeArrays(
        feature=feature.astype(np.int32),
        threshold=threshold,
        left=remap(left),
        right=remap(right),
        parent=remap(tree.parent[keep]),
        depth=tree.depth[keep].copy(),
        value=tree.value[keep].copy(),
        count=tree.count[keep].copy(),
        n_node_samples=tree.n_node_samples[keep].copy(),
        impurity=tree.impurity[keep].copy(),
    )


def pruning_path(tree: TreeArrays, *, task: str = "classification"):
    """``(ccp_alphas, impurities)``, sklearn's
    ``cost_complexity_pruning_path``: the effective alphas at which the tree
    collapses and the total leaf impurity after each. One weakest-link
    sweep; collapses at an equal alpha merge into one step that keeps the
    last impurity."""
    r_sub, _ = _subtree_stats(tree, _node_risk(tree, task))
    alphas, impurities = [0.0], [float(r_sub[0])]
    steps: list = []
    _prune_impl(tree, np.inf, task, path_out=steps)
    for a, imp in steps:
        if abs(a - alphas[-1]) <= 1e-300:
            impurities[-1] = imp  # simultaneous collapse at equal alpha
        else:
            alphas.append(a)
            impurities.append(imp)
    return np.asarray(alphas), np.asarray(impurities)


def pruning_path_for(estimator, X, y, sample_weight=None) -> Bunch:
    """The estimators' ``cost_complexity_pruning_path``: fit an unpruned
    clone (made from ``get_params``) and return its path as a
    :class:`Bunch` of ``ccp_alphas`` and ``impurities``."""
    est = type(estimator)(**estimator.get_params())
    est.ccp_alpha = 0.0
    est.fit(X, y, sample_weight=sample_weight)
    alphas, impurities = pruning_path(est.tree_, task=estimator._task)
    return Bunch(ccp_alphas=alphas, impurities=impurities)
