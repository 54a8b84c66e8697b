"""The host builder tier: one classification or regression tree grown level
by level in numpy and the native C++ sweep, on the host's cores.

Counterpart of ``build_tree_host`` (``mpitree_tpu/core/host_builder.py:242``).
It grows the same levelwise
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

Feature sampling (``feature_sampler``, ``ops/sampling.py``) threads the
same path-derived node keys as the device engine: a node's sampled
features reach the C++ sweep as per-slot candidate counts (0 for a masked
feature, whose bins still count for the ``constant`` stop), and
``splitter="random"`` runs the numpy sweep with drawn bins, as the JAX
package does (the C++ sweep has no drawn-bin mode). ``feature_mask``
keeps a forest tree's fixed subspace.
The C++ sweep accepts a new minimum only when it beats the incumbent by
more than 1e-12 relative, the numpy sweep takes the strict first minimum:
two genuinely distinct costs closer than that could resolve differently,
as in the JAX package.

Monotonic constraints (``mono_cst``, ``utils/monotonic.py``) are routed
as the JAX host tier routes them (``:370-383``): integer-weight
classification takes the C++ sweep's gate, whose float32 child values are
exact there; fractional weights and ``splitter="random"`` take the numpy
sweep with the gate in the float32 reciprocal-multiply form
(``:465-497``). Constrained regression takes the device engine's
regression sweep on the host's CPU (:class:`_FixedRegressionSweep`: the
fixed-point moment histogram's plain version, then
``ops/impurity.best_split_regression``), so its child means, and with
them its trees, are the device engine's bit for bit; the JAX package's
float32 moment sums equal them wherever they are exact. A ``BoundsStore``
carries the node bounds from level to level.

``timer`` (a ``utils/profiling.PhaseTimer`` or ``obs.BuildObserver``)
receives the JAX host tier's record (``:270-345,559-565``): the
``host_builds`` counter, one level row a level (timing-gated) and the
finished tree's fingerprint rows.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mpitree_tpu_torch import native
from mpitree_tpu_torch.obs.fingerprint import tree_fingerprints
from mpitree_tpu_torch.core.builder import (
    check_task,
    integer_weights,
    new_tree_buffer,
    refit_regression_values,
)
from mpitree_tpu_torch.ops import hist_kernel
from mpitree_tpu_torch.ops.histogram import moment_payload
from mpitree_tpu_torch.ops.impurity import best_split_regression
from mpitree_tpu_torch.utils.importances import (
    class_node_impurity,
    moment_node_impurity,
)
from mpitree_tpu_torch.utils.monotonic import BoundsStore
from mpitree_tpu_torch.utils.profiling import PhaseTimer


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
                   n_slots, n_classes, node_mask=None, mono=None):
    """One level of the C++ sweep; ``None`` when the library is absent.
    ``node_mask`` (n_slots, F) bool becomes per-slot candidate counts.
    ``mono`` ``(signs, lo, hi)`` (classification only) engages the
    kernel's monotonic gate over the frontier's bound windows; the result
    then carries the winners' ``v_left``/``v_right``."""
    per_slot = node_mask is not None
    n_cand = (np.where(node_mask, binned.n_cand[None, :], 0) if per_slot
              else binned.n_cand)
    if cfg.task == "regression":
        return native.best_splits_regression(
            xb, np.asarray(y, np.float32), nid, sample_weight,
            n_bins=binned.n_bins, frontier_lo=frontier_lo, n_slots=n_slots,
            n_cand=n_cand, n_cand_per_slot=per_slot,
            min_child_weight=cfg.min_child_weight,
        )
    return native.best_splits_classification(
        xb, y, nid, sample_weight, n_bins=binned.n_bins,
        n_classes=n_classes, frontier_lo=frontier_lo, n_slots=n_slots,
        n_cand=n_cand, n_cand_per_slot=per_slot, criterion=cfg.criterion,
        min_child_weight=cfg.min_child_weight,
        **({} if mono is None else dict(
            mono_cst=mono[0], mono_lo=mono[1], mono_hi=mono[2])),
    )


class _FixedRegressionSweep:
    """The device engine's regression split sweep, run on the host's CPU
    for constrained fits: the fixed-point ``(w, w*y, w*y^2)`` histogram's
    plain version (``hist_kernel.histogram_reference``, exponents fixed
    once per fit from the whole payload, as ``core/builder.build_tree``
    fixes them) and ``ops/impurity.best_split_regression`` with its
    monotonic gate. Its child means, costs and stops are the device
    engine's, so the two tiers grow the same constrained tree."""

    def __init__(self, xb, y, w, cand):
        self.xb = torch.from_numpy(xb)
        self.payload = moment_payload(
            torch.from_numpy(y), torch.from_numpy(np.asarray(w, np.float32))
        ).contiguous()
        self.scale_exp = hist_kernel.fixed_point_exponents(self.payload)
        self.cand = torch.from_numpy(cand)

    def __call__(self, slot, S, B, cfg, nmask, draws, mono):
        """(feature, bin, cost, constant, impurity, v_left, v_right) per
        slot; ``mono`` as in :func:`_numpy_level`."""
        hist = hist_kernel.histogram_reference(
            self.xb, self.payload, torch.from_numpy(slot.astype(np.int32)),
            n_slots=S, n_bins=B, scale_exp=self.scale_exp)
        kw = {}
        if nmask is not None:
            kw["node_mask"] = torch.from_numpy(nmask)
        if draws is not None:
            kw["forced_draw"] = torch.from_numpy(draws.astype(np.int64))
        if mono is not None:
            kw.update(mono_cst=torch.from_numpy(mono[0]),
                      mono_lo=torch.from_numpy(mono[1]),
                      mono_hi=torch.from_numpy(mono[2]))
        dec = best_split_regression(
            hist, self.cand, scale_exp=self.scale_exp,
            min_child_weight=cfg.min_child_weight, **kw)
        return tuple(None if t is None else t.numpy() for t in (
            dec.feature, dec.bin, dec.cost, dec.constant, dec.impurity,
            dec.v_left, dec.v_right))


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


def _numpy_level(xb, y, w, slot, live, cand, S, C, B, cfg, nmask=None,
                 draws=None, mono=None, fixed=None):
    """One non-terminal level of the numpy sweep: node stats, the dense
    ``(S, F, C, B)`` histogram (float32 moments for regression), the best
    split per node and its stop. ``nmask`` (S, F) bool limits each node to
    its sampled features; ``draws`` (S, F) uint32 picks each feature's bin
    among its valid ones (``splitter="random"``). ``mono`` ``(signs, lo,
    hi)`` ((F,) int32, (S,) float32 bounds) gates the candidates, and the
    result's last item is then the winners' ``(v_left, v_right)`` (else
    None); regression takes ``fixed`` (:class:`_FixedRegressionSweep`)
    for its sweep then."""
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
        if fixed is not None:
            feat_best, bin_best, best_cost, constant, imp32, vl, vr = fixed(
                slot, S, B, cfg, nmask, draws, mono)
            stop = (pure | constant | (n < cfg.min_samples_split)
                    | np.isinf(best_cost))
            if cfg.min_decrease_scaled > 0.0:
                # the device engine's float64 test on its float32 stats
                with np.errstate(invalid="ignore"):
                    stop |= n * (imp32.astype(np.float64) - best_cost.astype(
                        np.float64)) < cfg.min_decrease_scaled
            return (counts, n, value, node_imp, feat_best, bin_best, stop,
                    (vl, vr))
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
    if nmask is not None:
        valid &= nmask[:, :, None]
    if mono is not None:
        # sklearn's gate in the device engine's float32 reciprocal-multiply
        # form (mpitree_tpu/core/host_builder.py:475-497): class-0 mass
        # over weight, from the exact float64 sums cast to float32
        f1 = np.float32(1.0)
        m_l = hist[:, :, 0, :].cumsum(axis=2)
        vl_all = m_l.astype(np.float32) * (
            f1 / np.maximum(n_l.astype(np.float32), f1))
        vr_all = (m_l[:, :, -1:] - m_l).astype(np.float32) * (
            f1 / np.maximum(n_r.astype(np.float32), f1))
        sgn = mono[0][None, :, None].astype(np.float32)
        b_lo = mono[1][:, None, None]
        b_hi = mono[2][:, None, None]
        ok = (((vl_all - vr_all) * sgn <= 0)
              & (vl_all >= b_lo) & (vl_all <= b_hi)
              & (vr_all >= b_lo) & (vr_all <= b_hi))
        valid &= (sgn == 0) | ok
    cost = np.where(valid, cost, np.inf)
    if draws is None:
        bin_f = cost.argmin(axis=2)  # first-min = lowest threshold
    else:  # ops/impurity._drawn_bins, in uint32 as the JAX host tier
        j = draws % np.maximum(valid.sum(axis=2), 1).astype(np.uint32)
        bin_f = (np.cumsum(valid, axis=2) > j[:, :, None].astype(np.int64)
                 ).argmax(axis=2)
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
    values = None
    if mono is not None:
        sel = np.arange(S)
        values = (vl_all[sel, feat_best, bin_best],
                  vr_all[sel, feat_best, bin_best])
    return counts, n, value, node_imp, feat_best, bin_best, stop, values


def build_tree_host(binned, y: np.ndarray, *, config,
                    n_classes: int | None = None,
                    sample_weight: np.ndarray | None = None,
                    return_leaf_ids: bool = False,
                    refit_targets: np.ndarray | None = None,
                    feature_sampler=None,
                    feature_mask: np.ndarray | None = None,
                    mono_cst: np.ndarray | None = None, timer=None):
    """Grow one tree on the host; the contract of ``core.builder.build_tree``
    on a host ``BinnedData`` (numpy ``x_binned``): ``y`` class indices, or
    float32 centred targets with ``config.task == "regression"``, whose
    ``refit_targets`` (float64) give the exact leaf values. With
    ``return_leaf_ids`` returns ``(tree, leaf_ids)``, ``leaf_ids`` every
    row's final node as an (N,) int32 array. ``feature_sampler``,
    ``feature_mask``, ``mono_cst`` and ``timer`` as in ``build_tree``."""
    cfg = config
    check_task(cfg)
    timer = timer if timer is not None else PhaseTimer(enabled=False)
    timer.counter("host_builds")
    # the memory ledger of the host tier: nothing on the card, the host
    # side priced (the raw and binned matrix and the per-row state)
    from mpitree_tpu_torch.obs import accounting as obs_acct

    timer.memory_plan(obs_acct.build_memory_plan(
        mesh_axes=1, rows=int(binned.n_samples),
        features=int(binned.n_features), classes=int(n_classes or 2),
        bins=int(binned.n_bins), task=cfg.task, max_depth=cfg.max_depth,
        max_leaf_nodes=cfg.max_leaf_nodes,
        hist_budget_bytes=cfg.hist_budget_bytes,
        max_frontier_chunk=cfg.max_frontier_chunk,
        max_table_slots=cfg.max_table_slots, engine="host"))
    if feature_mask is not None:
        binned = dataclasses.replace(binned, n_cand=np.where(
            np.asarray(feature_mask, bool), binned.n_cand, 0).astype(
                np.int32))
    sampling = feature_sampler is not None and feature_sampler.active
    rand_split = sampling and feature_sampler.random_split
    keys = feature_sampler.key_store() if sampling else None
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
    mono = mono_cst is not None and bool(np.any(np.asarray(mono_cst) != 0))
    fixed = None
    if mono:
        cst32 = np.ascontiguousarray(mono_cst, np.int32)
        bounds = BoundsStore()
        if regression:
            fixed = _FixedRegressionSweep(xb, y, w, cand)
    # the C++ gate only where its float32 child values are exact
    mono_native = mono and not regression and integer_weights(sample_weight)

    nid = np.zeros(N, np.int32)
    frontier_lo, frontier_size, depth = 0, 1, 0
    def note_level(d, S, splits, t0):
        timer.level(
            level=d, frontier=int(S), splits=int(splits), hist_bytes=0,
            psum_bytes=0,
            seconds=(round(time.perf_counter() - t0, 6)
                     if timer.enabled else None),
            new_lowerings=0,
        )

    while frontier_size > 0:
        t_level = time.perf_counter() if timer.enabled else 0.0
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
            note_level(depth, S, 0, t_level)
            break
        nmask = keys.masks(frontier_lo, frontier_lo + S) if sampling \
            else None
        mono_w = None
        if mono:
            bounds.ensure(frontier_lo + S)
            mono_w = (cst32, *bounds.window(frontier_lo, S, S))
        nat = None if rand_split or (mono and not mono_native) \
            else _native_splits(
                xb, y, nid, sample_weight, binned, cfg,
                frontier_lo=frontier_lo, n_slots=S, n_classes=C,
                node_mask=nmask, mono=mono_w)
        if nat is not None:
            counts, n, value, node_imp, feat_best, bin_best, stop = (
                _native_level_decisions(nat, cfg=cfg)
            )
            values = (nat["v_left"], nat["v_right"]) if mono else None
        else:
            (counts, n, value, node_imp, feat_best, bin_best, stop,
             values) = _numpy_level(
                xb, y, w, slot, live, cand, S, C, B, cfg, nmask=nmask,
                draws=(keys.draws(frontier_lo, frontier_lo + S)
                       if rand_split else None),
                mono=mono_w, fixed=fixed)
        _record_level(tree, ids, S, False, stop, feat_best, value, n, counts,
                      node_imp)
        nid, frontier_lo, frontier_size, depth = _split_and_advance(
            tree, binned, xb, nid, ids, stop, feat_best, bin_best,
            slot, live, S, frontier_lo, depth,
        )
        split_ids = ids[~stop]
        note_level(depth - 1, S, len(split_ids), t_level)
        if sampling and len(split_ids):
            keys.assign_children(split_ids, tree.left[split_ids],
                                 tree.right[split_ids], tree.n)
        if mono and len(split_ids):
            # children of a constrained split are pinned by the winner's
            # mid value (utils/monotonic.BoundsStore)
            bounds.assign_children(
                split_ids, tree.left[split_ids], tree.right[split_ids],
                values[0][~stop], values[1][~stop],
                cst32[feat_best[~stop]], tree.n)

    out = tree.finalize()
    if regression and refit_targets is not None:
        refit_regression_values(out, nid, w,
                                np.asarray(refit_targets, np.float64))
    if timer.wants_fingerprints:
        timer.fingerprint_tree(tree_fingerprints(out))
    return (out, nid) if return_leaf_ids else out
