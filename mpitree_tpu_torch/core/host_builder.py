"""The host builder tier: one classification or regression tree grown level
by level in numpy and the native C++ sweep, on the host's cores.

Counterpart of ``build_tree_host`` (``mpitree_tpu/core/host_builder.py:242``)
without its sampling and monotonic halves. It grows the same levelwise
histogram tree as the device engine (``core/builder.py``): the same bins,
stopping rules and first-min tie-breaks, the same struct-of-arrays result.
The estimators run it for ``backend="host"``; the hybrid refine tail
(``core/hybrid_builder.py``) shares its level steps.

Each level takes the C++ sweep (``native.best_splits_classification`` or
``best_splits_regression``, ``O(rows + occupied bins)`` per node) when
``native.lib()`` is loaded, else the numpy sweep below, which builds the
dense ``(S, F, C, B)`` histogram: float64 class counts, or float32 moments
with the JAX package's float32 cost (``_child_cost_mse``). A regression
tree ends with the exact float64 refit of its values
(``core/builder.refit_regression_values``).
The C++ sweep accepts a new minimum only when it beats the incumbent by
more than 1e-12 relative, the numpy sweep takes the strict first minimum:
two genuinely distinct costs closer than that could resolve differently,
as in the JAX package.

Not here (``ROADMAP.md``): feature sampling and ``splitter="random"``
(item 10), monotonic bounds (item 10), the build fingerprints and phase
timer (item 18).
"""

from __future__ import annotations

import numpy as np

from mpitree_tpu_torch import native
from mpitree_tpu_torch.core.builder import (
    check_task,
    new_tree_buffer,
    refit_regression_values,
)
from mpitree_tpu_torch.utils.importances import (
    class_node_impurity,
    moment_node_impurity,
)


def _child_impurity_class(hist, criterion: str):
    """(S,F,C,B) class histogram -> (S,F,B) weighted child cost, f64."""
    l = hist.cumsum(axis=3)  # noqa: E741 - left counts per class
    n_l = l.sum(axis=2)
    n_t = n_l[:, :, -1:]
    n_r = n_t - n_l
    r = l[:, :, :, -1:] - l

    def h(counts, n):
        with np.errstate(divide="ignore", invalid="ignore"):
            p = counts / np.maximum(n, 1.0)[:, :, None, :]
            if criterion == "entropy":
                t = np.where(counts > 0, p * np.log2(np.maximum(p, 1e-300)), 0.0)
                return -t.sum(axis=2)
            return np.where(n > 0, 1.0 - (p * p).sum(axis=2), 0.0)

    cost = (n_l * h(l, n_l) + n_r * h(r, n_r)) / np.maximum(n_t, 1.0)
    return cost, n_l, n_r


def _child_cost_mse(hist):
    """(S,F,3,B) moment histogram -> (S,F,B) weighted child variance, in
    float32 end to end as the device sweep computes it
    (``mpitree_tpu/core/host_builder.py:65``)."""
    h32 = hist.astype(np.float32)
    w_l = h32[:, :, 0, :].cumsum(axis=2, dtype=np.float32)
    s_l = h32[:, :, 1, :].cumsum(axis=2, dtype=np.float32)
    q_l = h32[:, :, 2, :].cumsum(axis=2, dtype=np.float32)
    w_t, s_t, q_t = w_l[:, :, -1:], s_l[:, :, -1:], q_l[:, :, -1:]
    w_r, s_r, q_r = w_t - w_l, s_t - s_l, q_t - q_l
    one, zero = np.float32(1.0), np.float32(0.0)

    def sse(w, s, q):
        return np.maximum(q - s * s / np.maximum(w, one), zero)

    cost = (sse(w_l, s_l, q_l) + sse(w_r, s_r, q_r)) / np.maximum(w_t, one)
    return cost, w_l, w_r


def _native_splits(xb, y, nid, sample_weight, binned, cfg, *, frontier_lo,
                   n_slots, n_classes):
    """One level of the C++ sweep; ``None`` when the library is absent."""
    if cfg.task == "regression":
        return native.best_splits_regression(
            xb, np.asarray(y, np.float32), nid, sample_weight,
            n_bins=binned.n_bins, frontier_lo=frontier_lo, n_slots=n_slots,
            n_cand=binned.n_cand, min_child_weight=cfg.min_child_weight,
        )
    return native.best_splits_classification(
        xb, y, nid, sample_weight, n_bins=binned.n_bins,
        n_classes=n_classes, frontier_lo=frontier_lo, n_slots=n_slots,
        n_cand=binned.n_cand, criterion=cfg.criterion,
        min_child_weight=cfg.min_child_weight,
    )


def _native_level_decisions(nat, *, cfg):
    """Node stats and the stopping decision from one C++ sweep's outputs:
    the one stop-rule formula of both consumers of the kernel (this
    builder and the batched refine tail). Regression returns ``counts``
    None (its moments only feed the value and impurity)."""
    if cfg.task == "regression":
        counts = None
        n = nat["counts"][:, 0]
        value = (nat["counts"][:, 1] / np.maximum(n, 1.0)).astype(
            np.float32)
        pure = ~(nat["ymax"] > nat["ymin"])
        node_imp = moment_node_impurity(nat["counts"])
    else:
        counts = nat["counts"]
        n = counts.sum(axis=1)
        pure = (counts > 0).sum(axis=1) <= 1
        value = counts.argmax(axis=1).astype(np.int32)
        node_imp = class_node_impurity(counts, cfg.criterion)
    feat_best = nat["feature"]
    stop = (
        pure | nat["constant"] | (n < cfg.min_samples_split)
        | np.isinf(nat["cost"]) | (feat_best < 0)
    )
    if cfg.min_decrease_scaled > 0.0:
        # sklearn's min_impurity_decrease on the best split only
        with np.errstate(invalid="ignore"):
            stop |= n * (node_imp - nat["cost"]) < cfg.min_decrease_scaled
    return counts, n, value, node_imp, feat_best, nat["bin"], stop


def _leaf_stats(slot, live, y, w_dense, S, C, *, criterion,
                task="classification"):
    """Terminal-level node stats (counts, n, value, impurity) by
    bincounts; regression returns ``counts`` None."""
    if task == "regression":
        flat = slot[live].astype(np.intp)
        wv = w_dense[live]
        n = np.bincount(flat, weights=wv, minlength=S)
        s1 = np.bincount(flat, weights=wv * y[live], minlength=S)
        s2 = np.bincount(
            flat, weights=wv * np.square(y[live], dtype=np.float64),
            minlength=S,
        )
        value = (s1 / np.maximum(n, 1.0)).astype(np.float32)
        return None, n, value, moment_node_impurity(
            np.stack([n, s1, s2], axis=1))
    flat = (slot[live] * C + y[live]).astype(np.intp)
    counts = np.bincount(
        flat, weights=w_dense[live], minlength=S * C
    ).reshape(S, C)
    n = counts.sum(axis=1)
    value = counts.argmax(axis=1).astype(np.int32)
    return counts, n, value, class_node_impurity(counts, criterion)


def _record_level(tree, ids, S, terminal, stop, feat_best, value, n, counts,
                  node_imp):
    """One level's node records; ``counts`` None (regression) stores the
    value as the count column."""
    tree.feature[ids] = (
        np.full(S, -1, np.int32) if terminal
        else np.where(stop, -1, feat_best).astype(np.int32)
    )
    tree.value[ids] = value
    tree.n_node_samples[ids] = n.astype(np.int64)
    tree.impurity[ids] = node_imp
    if counts is None:
        tree.count[ids, 0] = value
    else:
        tree.count[ids] = counts.astype(tree.count.dtype)


def _split_and_advance(tree, binned, xb, nid, ids, stop, feat_best, bin_best,
                       slot, live, S, frontier_lo, depth, thr_values=None):
    """Create children for the splitting nodes and reroute their rows.

    ``thr_values`` (one per splitting node) replaces the shared
    ``binned.thresholds`` lookup: the batched refine tail's roots each
    carry their own local thresholds.
    """
    split_ids = ids[~stop]
    if len(split_ids):
        f_sel = feat_best[~stop].astype(np.int32)
        b_sel = bin_best[~stop].astype(np.int32)
        tree.threshold[split_ids] = (
            binned.thresholds[f_sel, b_sel] if thr_values is None
            else thr_values
        )
        lefts, rights = tree.alloc_children(split_ids.astype(np.int32),
                                            depth + 1)
        tree.left[split_ids] = lefts
        tree.right[split_ids] = rights

        split_mask = np.zeros(S, bool)
        split_mask[~stop] = True
        feat_t = np.zeros(S, np.int32)
        bin_t = np.zeros(S, np.int32)
        left_t = np.zeros(S, np.int32)
        right_t = np.zeros(S, np.int32)
        feat_t[~stop] = f_sel
        bin_t[~stop] = b_sel
        left_t[~stop] = lefts
        right_t[~stop] = rights
        N = len(nid)
        s_cl = np.clip(slot, 0, S - 1)
        active = live & split_mask[s_cl]
        xf = xb[np.arange(N), feat_t[s_cl]]
        go_left = xf <= bin_t[s_cl]
        nid = np.where(
            active, np.where(go_left, left_t[s_cl], right_t[s_cl]), nid
        ).astype(np.int32)
    return nid, frontier_lo + S, 2 * len(split_ids), depth + 1


def _numpy_level(xb, y, w, slot, live, cand, S, C, B, cfg):
    """One non-terminal level of the numpy sweep: node stats, the dense
    ``(S, F, C, B)`` histogram (float32 moments for regression), the best
    split per node and its stop."""
    F = xb.shape[1]
    li = np.flatnonzero(live)
    sl = slot[li][:, None]
    xbl = xb[li]
    rows_feat = np.arange(F, dtype=np.intp)[None, :]
    if cfg.task == "regression":
        counts, n, value, node_imp = _leaf_stats(
            slot, live, y, w, S, C, criterion=cfg.criterion,
            task="regression")
        live_w = live & (w > 0)
        ymin = np.full(S, np.inf)
        ymax = np.full(S, -np.inf)
        np.minimum.at(ymin, slot[live_w].astype(np.intp), y[live_w])
        np.maximum.at(ymax, slot[live_w].astype(np.intp), y[live_w])
        pure = ~(ymax > ymin)
        w32 = w.astype(np.float32)
        hist = np.zeros((S, F, 3, B), np.float32)
        base = (sl * F + rows_feat) * 3 * B + xbl
        for ci, payload in enumerate(
                (w32[li], w32[li] * y[li], w32[li] * y[li] * y[li])):
            np.add.at(
                hist.reshape(-1), (base + ci * B).astype(np.intp).ravel(),
                np.broadcast_to(payload[:, None], xbl.shape).ravel(),
            )
        cost, n_l, n_r = _child_cost_mse(hist)
    else:
        flat = (slot[live] * C + y[live]).astype(np.intp)
        counts = np.bincount(flat, weights=w[live], minlength=S * C)
        counts = counts.reshape(S, C)
        n = counts.sum(axis=1)
        pure = (counts > 0).sum(axis=1) <= 1
        value = counts.argmax(axis=1).astype(np.int32)
        node_imp = class_node_impurity(counts, cfg.criterion)

        hist = np.zeros((S, F, C, B))
        idx = ((sl * F + rows_feat) * C + y[li][:, None]) * B + xbl
        np.add.at(
            hist.reshape(-1), idx.astype(np.intp).ravel(),
            np.broadcast_to(w[li][:, None], xbl.shape).ravel(),
        )
        cost, n_l, n_r = _child_impurity_class(hist, cfg.criterion)
    valid = cand[None, :, :] & (n_l > 0) & (n_r > 0)
    if cfg.min_child_weight > 0.0:
        valid &= (n_l >= cfg.min_child_weight) & (n_r >= cfg.min_child_weight)
    cost = np.where(valid, cost, np.inf)
    bin_f = cost.argmin(axis=2)  # first-min = lowest threshold
    cost_f = np.take_along_axis(cost, bin_f[:, :, None], axis=2)[:, :, 0]
    feat_best = cost_f.argmin(axis=1).astype(np.int32)  # lowest feature
    bin_best = np.take_along_axis(
        bin_f, feat_best[:, None].astype(np.intp), axis=1
    )[:, 0].astype(np.int32)
    best_cost = np.take_along_axis(
        cost_f, feat_best[:, None].astype(np.intp), axis=1
    )[:, 0]
    occupied = (hist.sum(axis=2) > 0).sum(axis=2)  # (S, F)
    constant = (occupied <= 1).all(axis=1)
    stop = (
        pure | constant | (n < cfg.min_samples_split) | np.isinf(best_cost)
    )
    if cfg.min_decrease_scaled > 0.0:
        with np.errstate(invalid="ignore"):
            stop |= n * (node_imp - best_cost) < cfg.min_decrease_scaled
    return counts, n, value, node_imp, feat_best, bin_best, stop


def build_tree_host(binned, y: np.ndarray, *, config,
                    n_classes: int | None = None,
                    sample_weight: np.ndarray | None = None,
                    return_leaf_ids: bool = False,
                    refit_targets: np.ndarray | None = None):
    """Grow one tree on the host; the contract of ``core.builder.build_tree``
    on a host ``BinnedData`` (numpy ``x_binned``): ``y`` class indices, or
    float32 centred targets with ``config.task == "regression"``, whose
    ``refit_targets`` (float64) give the exact leaf values. With
    ``return_leaf_ids`` returns ``(tree, leaf_ids)``, ``leaf_ids`` every
    row's final node as an (N,) int32 array."""
    cfg = config
    check_task(cfg)
    regression = cfg.task == "regression"
    xb = np.ascontiguousarray(binned.x_binned, np.int32)
    y = np.ascontiguousarray(y, np.float32 if regression else np.int32)
    N, F = xb.shape
    B = binned.n_bins
    C = 3 if regression else int(n_classes)
    cand = binned.candidate_mask()  # (F, B)
    w = np.ones(N) if sample_weight is None else sample_weight.astype(np.float64)
    tree = new_tree_buffer(cfg.task, C, sample_weight)
    tree.ensure(1)
    tree.n = 1

    nid = np.zeros(N, np.int32)
    frontier_lo, frontier_size, depth = 0, 1, 0
    while frontier_size > 0:
        S = frontier_size
        terminal = cfg.max_depth is not None and depth == cfg.max_depth
        slot = nid - frontier_lo  # rows are in the frontier or parked (< 0)
        live = slot >= 0
        ids = frontier_lo + np.arange(S)
        if terminal:
            counts, n, value, node_imp = _leaf_stats(
                slot, live, y, w, S, C, criterion=cfg.criterion,
                task=cfg.task,
            )
            _record_level(tree, ids, S, True, None, None, value, n, counts,
                          node_imp)
            break
        nat = _native_splits(
            xb, y, nid, sample_weight, binned, cfg,
            frontier_lo=frontier_lo, n_slots=S, n_classes=C,
        )
        if nat is not None:
            counts, n, value, node_imp, feat_best, bin_best, stop = (
                _native_level_decisions(nat, cfg=cfg)
            )
        else:
            counts, n, value, node_imp, feat_best, bin_best, stop = (
                _numpy_level(xb, y, w, slot, live, cand, S, C, B, cfg)
            )
        _record_level(tree, ids, S, False, stop, feat_best, value, n, counts,
                      node_imp)
        nid, frontier_lo, frontier_size, depth = _split_and_advance(
            tree, binned, xb, nid, ids, stop, feat_best, bin_best,
            slot, live, S, frontier_lo, depth,
        )

    out = tree.finalize()
    if regression and refit_targets is not None:
        refit_regression_values(out, nid, w,
                                np.asarray(refit_targets, np.float64))
    return (out, nid) if return_leaf_ids else out
