"""Split evaluation from histograms: entropy / Gini / MSE / Newton costs
and argmin.

Counterpart of ``mpitree_tpu/ops/impurity.py``: its classification and
regression halves (``:39-335``, ``_lex_argmin`` ``:384``,
``best_split_regression`` ``:533``) and boosting's Newton sweep
(``best_split_newton`` ``:449``), with the same selection rules:

- the cost of candidate ``(f, b)`` is the weighted child impurity
  ``(n_l * H(left) + n_r * H(right)) / n``;
- per feature the lowest-cost bin wins, ties to the lowest threshold; across
  features the lowest cost wins, ties to the lowest feature index;
- candidates with an empty side, outside ``cand_mask``, under
  ``min_child_weight`` or on a feature outside the node's sampled subset
  (``node_mask``, ``ops/sampling.py``) cost ``+inf``; a masked feature
  still counts for the ``constant`` stop;
- with ``forced_draw`` (``splitter="random"``) each feature's bin is not
  its best but one drawn among its valid bins (:func:`_drawn_bins`), and
  the features then compete on the cost at their drawn bins;
- with ``mono_cst`` (sklearn's ``monotonic_cst``, ``utils/monotonic.py``)
  a candidate on a constrained feature is valid only when its float32
  child values keep the sign and lie in the node's bounds
  (:func:`_monotonic_ok`); the cost and the argmin are untouched.

The default sweep runs in float64 (:func:`cost_sweep_f64`), on every
device: the H100 has an fp64 unit, and the JAX package ranks in float32
only on TPUs, which lack one. Candidates are ranked by the JAX package's
``(hi, lo)`` float32 pair (``hi = f32(cost)``, ``lo = f32(cost - hi)``)
compared lexicographically, so first-min tie-breaks resolve in the same
order as the reference. ``exact_ties=False`` keeps the float32 sweep.

Fixed-point histograms (int64, ``ops/hist_kernel.py``): the sweeps take
their cumulative sums over bins **in int64**, which is exact and the same on
every device (a float32 ``torch.cumsum`` associates differently on CUDA and
on the CPU), and convert only then: to float64 for the classification
sweep, whose counts then equal the exact float64 sums of the JAX package's
host tier; to float32 for the regression and Newton sweeps, which then run
the JAX package's float32 formulas op for op.

The sweep and the argmin are plain PyTorch operations: in the JAX package
they are XLA code outside any Pallas kernel. ``log2`` is written
``log(x) * (1/ln 2)``, which is the form XLA compiles ``jnp.log2`` to.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mpitree_tpu_torch.ops.hist_kernel import dequantize

_INV_LN2_F64 = 1.0 / math.log(2.0)
_EMPTY_SIDE = 1e-300
_INV_LN2_F32 = float(np.float32(1.0) / np.float32(np.log(np.float32(2.0))))


_f32_consts: dict = {}


def _f32_const(v: float, dev: torch.device) -> torch.Tensor:
    """``float32(v)`` as a 0-d tensor on ``dev``, made once per (value,
    device): a sweep copies nothing to the card (and a captured CUDA
    graph may reuse it)."""
    key = (dev, float(np.float32(v)))
    if key not in _f32_consts:
        _f32_consts[key] = torch.tensor(np.float32(v), device=dev)
    return _f32_consts[key]


class SplitDecision(NamedTuple):
    """Per-frontier-slot split search result, shapes (K,) unless noted.

    ``feature``/``bin`` name the winner; ``cost`` is its weighted child
    impurity as float32 (``+inf`` when no candidate is valid; under the
    float64 sweep the ``hi`` half); ``impurity``/``n`` describe the parent;
    ``counts`` is its (K, C) class-count vector (regression: the (K, 3)
    moments); ``constant`` is True when every feature has at most one
    occupied bin; ``n_left`` is the winner's left-side weight; ``y_range``
    (regression only, else None) is the node's ``max(y) - min(y)`` over
    rows of positive weight, its purity signal. ``v_left``/``v_right``
    (float32, only under ``mono_cst``, else None) are the winner's child
    values, from which the builder bounds the children. ``cost_lo``
    (classification; None is 0) is the winner's low float32 half of its
    ``(hi, lo)`` rank, which a merge of winners across feature shards
    (``parallel/collective.select_global``) compares as the sweep did.
    """

    feature: torch.Tensor
    bin: torch.Tensor
    cost: torch.Tensor
    impurity: torch.Tensor
    n: torch.Tensor
    counts: torch.Tensor
    constant: torch.Tensor
    n_left: torch.Tensor
    y_range: torch.Tensor | None = None
    v_left: torch.Tensor | None = None
    v_right: torch.Tensor | None = None
    cost_lo: torch.Tensor | None = None


def _log2(x: torch.Tensor) -> torch.Tensor:
    inv = _INV_LN2_F64 if x.dtype == torch.float64 else _INV_LN2_F32
    return torch.log(x) * inv


def _entropy(counts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (bits) over the trailing class axis; 0 when empty."""
    p = counts / torch.clamp(n, min=1.0)[..., None]
    terms = torch.where(
        counts > 0, p * _log2(torch.clamp(p, min=1e-38)),
        torch.zeros_like(p),
    )
    return -terms.sum(dim=-1)


def _gini(counts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    p = counts / torch.clamp(n, min=1.0)[..., None]
    return torch.where(n > 0, 1.0 - (p * p).sum(dim=-1),
                       torch.zeros_like(n))


def class_impurity(counts: torch.Tensor, n: torch.Tensor,
                   criterion: str) -> torch.Tensor:
    if criterion == "entropy":
        return _entropy(counts, n)
    if criterion == "gini":
        return _gini(counts, n)
    raise ValueError(f"unknown classification criterion: {criterion!r}")


def cost_sweep_f64(hist: torch.Tensor, criterion: str, scale_exp=None,
                   *, f64_out: bool = False, side_floor: float = _EMPTY_SIDE):
    """(K, F, C, B) histogram -> (cost_hi, cost_lo, n_l, n_r) float32.

    Op for op the JAX package's ``_cost_sweep_f64`` (``ops/impurity.py:97``):
    per-class left cumsums in float64, side totals summed class by class in
    ascending order, division (not a reciprocal multiply), terms
    ``p * log2(max(p, 1e-300))``, and only (K, F, B)-sized float64
    accumulators alive at once (the per-class cumsums are transient). The
    float64 cost leaves as the two-float ``(hi, lo)`` pair the ranking uses.
    One difference, inert for integer weights: the side weights divide
    unclamped where JAX clamps them at 1, so that a fractionally weighted
    fit ranks as the JAX package's host tier (its C++ sweep) and sklearn
    do.

    An int64 fixed-point ``hist`` (with its ``scale_exp``) is cumsummed in
    int64 and converted to float64 after the sum. ``f64_out`` returns
    ``(cost, None, n_l, n_r)`` in float64 instead. ``side_floor=1.0``
    divides by ``max(n, 1)`` instead: the JAX host tier's numpy sweep
    (``_child_impurity_class``), which it runs for constrained fits with
    fractional weights.
    """
    C = hist.shape[2]

    if scale_exp is None:
        def l_of(c):
            return torch.cumsum(hist[:, :, c, :].to(torch.float64), dim=2)
    else:
        def l_of(c):
            return dequantize(torch.cumsum(hist[:, :, c, :], dim=2),
                              scale_exp[c:c + 1], dim=0)

    n_l = l_of(0)
    for c in range(1, C):
        n_l = n_l + l_of(c)
    n_tot = n_l[:, :, -1:]
    n_r = n_tot - n_l

    # A side's weight divides as it is (n * H(side) = n log2 n - sum c
    # log2 c, the C++ sweep's and sklearn's form); the JAX package's
    # max(n, 1) equals it whenever weights are integers and only differs
    # for a side lighter than one unit of weight. The floor only keeps an
    # empty side (whose terms are masked) finite: no positive weight sum
    # of float32 values lies below it.
    div_l = torch.clamp(n_l, min=side_floor)
    div_r = torch.clamp(n_r, min=side_floor)
    div_t = torch.clamp(n_tot, min=side_floor)
    acc_l = acc_r = None
    for c in range(C):
        l_c = l_of(c)
        r_c = l_c[:, :, -1:] - l_c
        p_l = l_c / div_l
        p_r = r_c / div_r
        if criterion == "entropy":
            t_l = torch.where(l_c > 0, p_l * _log2(torch.clamp(p_l, min=1e-300)),
                              torch.zeros_like(p_l))
            t_r = torch.where(r_c > 0, p_r * _log2(torch.clamp(p_r, min=1e-300)),
                              torch.zeros_like(p_r))
        else:
            t_l = p_l * p_l
            t_r = p_r * p_r
        acc_l = t_l if acc_l is None else acc_l + t_l
        acc_r = t_r if acc_r is None else acc_r + t_r
    if criterion == "entropy":
        h_l, h_r = -acc_l, -acc_r
    else:
        h_l = torch.where(n_l > 0, 1.0 - acc_l, torch.zeros_like(acc_l))
        h_r = torch.where(n_r > 0, 1.0 - acc_r, torch.zeros_like(acc_r))

    cost = (n_l * h_l + n_r * h_r) / div_t
    if f64_out:
        return cost, None, n_l, n_r
    hi = cost.to(torch.float32)
    lo = (cost - hi.to(torch.float64)).to(torch.float32)
    return hi, lo, n_l.to(torch.float32), n_r.to(torch.float32)


def _cost_sweep_f32(hist: torch.Tensor, hist_sum: torch.Tensor,
                    criterion: str):
    """float32 twin of :func:`cost_sweep_f64` (reciprocal-multiply form,
    the JAX package's ``exact_ties=False`` branch)."""
    n_l = torch.cumsum(hist_sum, dim=2)
    n_tot = n_l[:, :, -1:]
    n_r = n_tot - n_l
    inv_l = 1.0 / torch.clamp(n_l, min=1.0)
    inv_r = 1.0 / torch.clamp(n_r, min=1.0)
    h_l = torch.zeros_like(n_l)
    h_r = torch.zeros_like(n_l)
    for c in range(hist.shape[2]):
        l_c = torch.cumsum(hist[:, :, c, :], dim=2)
        r_c = l_c[:, :, -1:] - l_c
        p_l = l_c * inv_l
        p_r = r_c * inv_r
        if criterion == "entropy":
            h_l = h_l - torch.where(
                l_c > 0, p_l * _log2(torch.clamp(p_l, min=1e-38)),
                torch.zeros_like(p_l))
            h_r = h_r - torch.where(
                r_c > 0, p_r * _log2(torch.clamp(p_r, min=1e-38)),
                torch.zeros_like(p_r))
        else:
            h_l = h_l + p_l * p_l
            h_r = h_r + p_r * p_r
    if criterion == "gini":
        h_l = 1.0 - h_l
        h_r = 1.0 - h_r
    cost = (n_l * h_l + n_r * h_r) / torch.clamp(n_tot, min=1.0)
    return cost, n_l, n_r


def lex_argmin(hi: torch.Tensor, lo: torch.Tensor, dim: int) -> torch.Tensor:
    """First index of the lexicographic ``(hi, lo)`` minimum along ``dim``
    (``_lex_argmin``, ``mpitree_tpu/ops/impurity.py:384``)."""
    m_hi = hi.amin(dim=dim, keepdim=True)
    cand = hi == m_hi
    lo_m = torch.where(cand, lo, torch.full_like(lo, math.inf))
    m_lo = lo_m.amin(dim=dim, keepdim=True)
    cand = cand & (lo_m == m_lo)
    size = hi.shape[dim]
    shape = [1] * hi.dim()
    shape[dim] = size
    iota = torch.arange(size, device=hi.device).view(shape).expand_as(hi)
    return torch.where(cand, iota, torch.full_like(iota, size)).amin(dim=dim)


def _winner(a: torch.Tensor, best_feature: torch.Tensor,
            best_bin: torch.Tensor) -> torch.Tensor:
    """Winning candidate's entry of a (K, F, B) per-candidate array."""
    a_f = torch.gather(a, 2, best_bin[:, None, None].expand(-1, a.shape[1], 1))
    return torch.gather(a_f[:, :, 0], 1, best_feature[:, None])[:, 0]


def _monotonic_ok(v_l: torch.Tensor, v_r: torch.Tensor,
                  mono_cst: torch.Tensor, mono_lo: torch.Tensor,
                  mono_hi: torch.Tensor) -> torch.Tensor:
    """sklearn's per-candidate monotonicity gate (``_monotonic_ok``,
    ``mpitree_tpu/ops/impurity.py:403``): ``v_l``/``v_r`` (K, F, B)
    float32 child values, ``mono_cst`` (F,) internal signs,
    ``mono_lo``/``mono_hi`` (K,) float32 node bounds. A feature of sign 0
    passes unconditionally, bounds included."""
    cst = mono_cst.to(v_l.dtype)[None, :, None]
    lo = mono_lo[:, None, None]
    hi = mono_hi[:, None, None]
    ok = (((v_l - v_r) * cst <= 0)
          & (v_l >= lo) & (v_l <= hi) & (v_r >= lo) & (v_r <= hi))
    return (cst == 0) | ok


def _child_values(m_l: torch.Tensor, m_r: torch.Tensor, n_l: torch.Tensor,
                  n_r: torch.Tensor):
    """Child values in the float32 reciprocal-multiply form every engine
    computes: ``f32(mass) * (1 / max(f32(n), 1))`` per side."""
    def side(m, n):
        n32 = n.to(torch.float32)
        return m.to(torch.float32) * (1.0 / torch.clamp(n32, min=1.0))
    return side(m_l, n_l), side(m_r, n_r)


def _drawn_bins(valid: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
    """``splitter="random"``: per (slot, feature), the valid bin that
    ``draw`` picks (``_drawn_bins``, ``mpitree_tpu/ops/impurity.py:436``):
    ``j = draw % max(count of valid bins, 1)``, then the first bin whose
    running count of valid bins exceeds ``j``; a feature with no valid bin
    falls to bin 0, whose cost is already ``+inf``. ``valid`` (K, F, B)
    bool, ``draw`` (K, F) int64 holding the uint32 draws, so the modulo
    is exact."""
    cnt = valid.sum(dim=2)
    j = draw % torch.clamp(cnt, min=1)
    hit = torch.cumsum(valid.to(torch.int64), dim=2) > j[:, :, None]
    B = valid.shape[2]
    iota = torch.arange(B, device=valid.device).view(1, 1, B)
    first = torch.where(hit, iota, B).amin(dim=2)
    return torch.where(first < B, first, 0)


def best_split_classification(
    hist: torch.Tensor, cand_mask: torch.Tensor, *,
    criterion: str = "entropy", min_child_weight: float | None = None,
    exact_ties: bool = True, scale_exp=None,
    node_mask: torch.Tensor | None = None,
    forced_draw: torch.Tensor | None = None,
    mono_cst: torch.Tensor | None = None,
    mono_lo: torch.Tensor | None = None,
    mono_hi: torch.Tensor | None = None,
) -> SplitDecision:
    """Pick the best (feature, bin) per frontier slot.

    ``hist`` (K, F, C, B) float32 from :func:`histogram.class_histogram`,
    or its int64 fixed-point form with ``scale_exp``; ``cand_mask`` (F, B)
    bool valid candidate bins. A fixed-point ``hist`` keeps the node's
    statistics in float64: ``counts``, ``n``, ``n_left``, the parent
    ``impurity`` and the winner's ``cost`` (the exact float64 sums the
    JAX package's host tier keeps), and checks ``min_child_weight``
    against float64 side weights. ``node_mask`` (K, F) bool restricts
    each slot to its sampled features; ``forced_draw`` (K, F) int64 picks
    each feature's bin among its valid ones (``splitter="random"``).
    ``mono_cst`` (F,) int32 internal signs (binary classification) with
    ``mono_lo``/``mono_hi`` (K,) float32 bounds engage the monotonic gate
    on the class-0 fraction of each side: from the float32 cumsums of the
    integer route's counts (exact, the JAX device engine's form), or from
    the fixed-point route's exact sums cast to float32 (the JAX host
    tier's form, ``mpitree_tpu/core/host_builder.py:475-497``); there the
    cost divides each side by ``max(n, 1)``, as that tier's numpy sweep,
    which it runs for constrained fits, does.
    """
    if criterion not in ("entropy", "gini"):
        raise ValueError(f"unknown classification criterion: {criterion!r}")
    fixed = scale_exp is not None
    hist_sum = hist.sum(dim=2)  # (K, F, B); exact either way
    if fixed:
        # constrained: the JAX host tier's numpy sweep, as it routes them
        cost64, _, n_l, n_r = cost_sweep_f64(
            hist, criterion, scale_exp, f64_out=True,
            side_floor=_EMPTY_SIDE if mono_cst is None else 1.0)
        cost = cost64.to(torch.float32)
        cost_lo = (cost64 - cost.to(torch.float64)).to(torch.float32)
    elif exact_ties:
        cost, cost_lo, n_l, n_r = cost_sweep_f64(hist, criterion)
    else:
        cost, n_l, n_r = _cost_sweep_f32(hist, hist_sum, criterion)
        cost_lo = torch.zeros_like(cost)

    valid = cand_mask[None, :, :] & (n_l > 0) & (n_r > 0)
    if min_child_weight is not None:
        valid = valid & (n_l >= min_child_weight) & (n_r >= min_child_weight)
    if node_mask is not None:
        valid = valid & node_mask[:, :, None]
    v_l_all = v_r_all = None
    if mono_cst is not None:
        if fixed:  # right side in int64, then one rounding
            l0 = torch.cumsum(hist[:, :, 0, :], dim=2)
            v_l_all, v_r_all = _child_values(
                dequantize(l0, scale_exp[0:1], dim=0),
                dequantize(l0[:, :, -1:] - l0, scale_exp[0:1], dim=0),
                n_l, n_r)
        else:
            n32 = torch.cumsum(hist_sum, dim=2)
            l0 = torch.cumsum(hist[:, :, 0, :], dim=2)
            v_l_all, v_r_all = _child_values(
                l0, l0[:, :, -1:] - l0, n32, n32[:, :, -1:] - n32)
        valid = valid & _monotonic_ok(v_l_all, v_r_all, mono_cst, mono_lo,
                                      mono_hi)
    cost = torch.where(valid, cost, torch.full_like(cost, math.inf))
    cost_lo = torch.where(valid, cost_lo, torch.zeros_like(cost_lo))

    best_bin_f = (lex_argmin(cost, cost_lo, dim=2) if forced_draw is None
                  else _drawn_bins(valid, forced_draw))  # (K, F)
    best_cost_f = torch.gather(cost, 2, best_bin_f[:, :, None])[:, :, 0]
    best_lo_f = torch.gather(cost_lo, 2, best_bin_f[:, :, None])[:, :, 0]
    best_feature = lex_argmin(best_cost_f, best_lo_f, dim=1)  # (K,)
    best_bin = torch.gather(best_bin_f, 1, best_feature[:, None])[:, 0]
    best_cost = torch.gather(best_cost_f, 1, best_feature[:, None])[:, 0]
    constant = ((hist_sum > 0).sum(dim=2) <= 1).all(dim=1)

    if fixed:
        parent_counts = dequantize(hist[:, 0, :, :].sum(dim=-1), scale_exp,
                                   dim=1)  # (K, C) float64
        parent_n = parent_counts.sum(dim=-1)
        best_cost = torch.where(
            torch.isinf(best_cost), best_cost.to(torch.float64),
            _winner(cost64, best_feature, best_bin))
        n_left = _winner(n_l, best_feature, best_bin)
    else:
        parent_counts = hist[:, 0, :, :].sum(dim=-1)  # (K, C)
        parent_n = parent_counts.sum(dim=-1)
        # float32 cumsum of the integer counts (exact), as the reference
        n_left = _winner(torch.cumsum(hist_sum, dim=2), best_feature,
                         best_bin)
    parent_impurity = class_impurity(parent_counts, parent_n, criterion)

    return SplitDecision(
        feature=best_feature.to(torch.int32),
        bin=best_bin.to(torch.int32),
        cost=best_cost,
        impurity=parent_impurity,
        n=parent_n,
        counts=parent_counts,
        constant=constant,
        n_left=n_left,
        cost_lo=torch.gather(best_lo_f, 1, best_feature[:, None])[:, 0],
        **_winner_values(v_l_all, v_r_all, best_feature, best_bin),
    )


def _winner_values(v_l_all, v_r_all, best_feature, best_bin) -> dict:
    """The winner's ``v_left``/``v_right`` when the gate ran, else nothing
    (``_winner_values``, ``mpitree_tpu/ops/impurity.py:421``)."""
    if v_l_all is None:
        return {}
    return {"v_left": _winner(v_l_all, best_feature, best_bin),
            "v_right": _winner(v_r_all, best_feature, best_bin)}


def best_split_regression(
    hist: torch.Tensor, cand_mask: torch.Tensor, *, scale_exp,
    min_child_weight: float | None = None,
    node_mask: torch.Tensor | None = None,
    forced_draw: torch.Tensor | None = None,
    mono_cst: torch.Tensor | None = None,
    mono_lo: torch.Tensor | None = None,
    mono_hi: torch.Tensor | None = None,
) -> SplitDecision:
    """Pick the best squared-error split per frontier slot from an int64
    fixed-point ``(w, w*y, w*y^2)`` moment histogram (K, F, 3, B).

    ``best_split_regression`` (``mpitree_tpu/ops/impurity.py:533``): the
    cost of a candidate is ``(SSE_left + SSE_right) / max(w_total, 1)``,
    ``SSE = max(q - s*s / max(w, 1), 0)``, all in float32 as the JAX
    package computes it, with first-min tie-breaks (lowest threshold, then
    lowest feature). The left and right sums are taken in int64 (exact)
    and rounded to float32 once; the float32 formula then runs op for op.
    ``counts`` is the parent's (K, 3) moments in float64, exact sums of
    the fixed-point values; ``impurity`` the parent's variance in float32.
    ``y_range`` is left to the caller (``collective.split_step``).
    ``node_mask``, ``forced_draw`` and the ``mono_*`` gate as in
    :func:`best_split_classification`; the child means it gates are the
    exact int64 sums cast to float32, ``f32(s) * (1 / max(f32(w), 1))``,
    which equal the JAX package's float32 cumsums wherever those are
    exact.
    """
    w_l, s_l, q_l = (torch.cumsum(hist[:, :, c, :], dim=2)
                     for c in range(3))
    tot = [a[:, :, -1:] for a in (w_l, s_l, q_l)]
    w_r, s_r, q_r = (t - a for t, a in zip(tot, (w_l, s_l, q_l)))

    def f32(a, c):
        return dequantize(a, scale_exp[c:c + 1], dim=0, dtype=torch.float32)

    w_l, s_l, q_l = f32(w_l, 0), f32(s_l, 1), f32(q_l, 2)
    w_r, s_r, q_r = f32(w_r, 0), f32(s_r, 1), f32(q_r, 2)
    w_t = f32(tot[0], 0)
    one = torch.ones((), dtype=torch.float32, device=hist.device)
    zero = torch.zeros((), dtype=torch.float32, device=hist.device)

    def sse(w, s, q):
        return torch.maximum(q - s * s / torch.maximum(w, one), zero)

    cost = (sse(w_l, s_l, q_l) + sse(w_r, s_r, q_r)) / torch.maximum(w_t,
                                                                      one)
    valid = cand_mask[None, :, :] & (w_l > 0) & (w_r > 0)
    if min_child_weight is not None:
        valid = valid & (w_l >= min_child_weight) & (w_r >= min_child_weight)
    if node_mask is not None:
        valid = valid & node_mask[:, :, None]
    v_l_all = v_r_all = None
    if mono_cst is not None:
        v_l_all, v_r_all = _child_values(s_l, s_r, w_l, w_r)
        valid = valid & _monotonic_ok(v_l_all, v_r_all, mono_cst, mono_lo,
                                      mono_hi)
    cost = torch.where(valid, cost, torch.full_like(cost, math.inf))

    best_bin_f = (  # first min: lowest bin
        lex_argmin(cost, torch.zeros_like(cost), dim=2)
        if forced_draw is None else _drawn_bins(valid, forced_draw))
    best_cost_f = torch.gather(cost, 2, best_bin_f[:, :, None])[:, :, 0]
    best_feature = lex_argmin(best_cost_f, torch.zeros_like(best_cost_f),
                              dim=1)
    best_bin = torch.gather(best_bin_f, 1, best_feature[:, None])[:, 0]
    best_cost = torch.gather(best_cost_f, 1, best_feature[:, None])[:, 0]

    parent_q = hist[:, 0, :, :].sum(dim=-1)  # (K, 3) int64
    parent = dequantize(parent_q, scale_exp, dim=1)
    p32 = dequantize(parent_q, scale_exp, dim=1, dtype=torch.float32)
    parent_impurity = sse(p32[:, 0], p32[:, 1], p32[:, 2]) / torch.maximum(
        p32[:, 0], one)
    constant = ((hist[:, :, 0, :] > 0).sum(dim=2) <= 1).all(dim=1)

    return SplitDecision(
        feature=best_feature.to(torch.int32),
        bin=best_bin.to(torch.int32),
        cost=best_cost,
        impurity=parent_impurity,
        n=parent[:, 0],
        counts=parent,
        constant=constant,
        n_left=_winner(w_l, best_feature, best_bin),
        **_winner_values(v_l_all, v_r_all, best_feature, best_bin),
    )


def best_split_newton(
    hist: torch.Tensor, cand_mask: torch.Tensor, *, scale_exp,
    reg_lambda: float, min_child_weight: float | None = None,
    min_samples_leaf: float | None = None,
) -> SplitDecision:
    """Pick the best Newton-gain split per frontier slot (boosting rounds)
    from an int64 fixed-point ``(count, g, h)`` histogram (K, F, 3, B).

    ``best_split_newton`` (``mpitree_tpu/ops/impurity.py:449``): a side's
    structure score is ``G^2 / max(H + lambda, 1e-12)``; a candidate costs
    ``-1/2 (score_l + score_r)`` and the parent's ``impurity`` is ``-1/2
    score_parent``, so ``impurity - cost`` is the Newton gain the
    builder's ``min_split_gain`` gate reads. A candidate needs rows on
    both sides, ``h >= min_child_weight`` (the hessian floor) and ``count
    >= min_samples_leaf`` on each; the argmin takes the first minimum
    (lowest threshold, then lowest feature). The left and right sums are
    taken in int64 (exact) and rounded to float32 once; the float32
    formula then runs as the JAX package's does (which takes float32
    cumulative sums instead: the two differ only where two candidates'
    costs lie within float32 rounding). ``counts`` is the parent's (K, 3)
    ``(count, G, H)`` in float64; ``n_left`` the winner's left row count.
    """
    c_l, g_l, h_l = (torch.cumsum(hist[:, :, c, :], dim=2)
                     for c in range(3))
    tot = [a[:, :, -1:] for a in (c_l, g_l, h_l)]
    c_r, g_r, h_r = (t - a for t, a in zip(tot, (c_l, g_l, h_l)))

    def f32(a, c):
        return dequantize(a, scale_exp[c:c + 1], dim=0, dtype=torch.float32)

    c_l, g_l, h_l = f32(c_l, 0), f32(g_l, 1), f32(h_l, 2)
    c_r, g_r, h_r = f32(c_r, 0), f32(g_r, 1), f32(h_r, 2)

    lam = _f32_const(reg_lambda, hist.device)
    eps = _f32_const(1e-12, hist.device)

    def score(g, h):
        return g * g / torch.maximum(h + lam, eps)

    cost = -0.5 * (score(g_l, h_l) + score(g_r, h_r))
    valid = cand_mask[None, :, :] & (c_l > 0) & (c_r > 0)
    if min_child_weight is not None:
        mcw = _f32_const(min_child_weight, hist.device)
        valid = valid & (h_l >= mcw) & (h_r >= mcw)
    if min_samples_leaf is not None:
        msl = _f32_const(min_samples_leaf, hist.device)
        valid = valid & (c_l >= msl) & (c_r >= msl)
    cost = torch.where(valid, cost, torch.full_like(cost, math.inf))

    best_bin_f = lex_argmin(cost, torch.zeros_like(cost), dim=2)
    best_cost_f = torch.gather(cost, 2, best_bin_f[:, :, None])[:, :, 0]
    best_feature = lex_argmin(best_cost_f, torch.zeros_like(best_cost_f),
                              dim=1)
    best_bin = torch.gather(best_bin_f, 1, best_feature[:, None])[:, 0]
    best_cost = torch.gather(best_cost_f, 1, best_feature[:, None])[:, 0]

    parent_q = hist[:, 0, :, :].sum(dim=-1)  # (K, 3) int64
    parent = dequantize(parent_q, scale_exp, dim=1)
    p32 = dequantize(parent_q, scale_exp, dim=1, dtype=torch.float32)
    parent_impurity = -0.5 * score(p32[:, 1], p32[:, 2])
    constant = ((hist[:, :, 0, :] > 0).sum(dim=2) <= 1).all(dim=1)

    return SplitDecision(
        feature=best_feature.to(torch.int32),
        bin=best_bin.to(torch.int32),
        cost=best_cost,
        impurity=parent_impurity,
        n=parent[:, 0],
        counts=parent,
        constant=constant,
        n_left=_winner(c_l, best_feature, best_bin),
    )


def leaf_gain(n, impurity, cost, *, task: str):
    """Best-first expansion priority of an open leaf (numpy or torch):
    ``leaf_gain`` (``mpitree_tpu/ops/impurity.py:337``). Classification
    and regression rank by the weighted impurity decrease ``n *
    (impurity - cost)``, gbdt by the Newton gain ``impurity - cost``. The
    leaf-wise engines pass float32 decision fields, so one subtract and
    one multiply rank the same on the host, the card and the CPU."""
    gain = impurity - cost
    if task != "gbdt":
        gain = n * gain
    return gain


def best_leaf_slot(gain: torch.Tensor, node_id: torch.Tensor) -> torch.Tensor:
    """Pool slot of the best open leaf, as a 0-d int64 tensor on the
    pool's device (``best_leaf_slot``, ``:357``): the largest ``gain``,
    ties to the lowest node id (ids are unique, so the pick does not
    depend on the pool's layout). No host read: ``torch.max`` and a masked
    ``argmin``."""
    eligible = gain == torch.max(gain)
    return torch.argmin(torch.where(
        eligible, node_id.to(torch.int64),
        torch.full_like(node_id, 2**31 - 1, dtype=torch.int64)))


def best_leaf_slot_np(gain: np.ndarray, node_id: np.ndarray) -> int:
    """numpy twin of :func:`best_leaf_slot` for the host-stepped loop
    (``best_leaf_slot_np``, ``:376``)."""
    top = np.max(gain)
    return int(np.argmin(np.where(gain == top, node_id,
                                  np.int64(2**31 - 1))))
