"""Split evaluation from histograms: entropy / Gini / MSE costs and argmin.

Counterpart of the classification and regression halves of
``mpitree_tpu/ops/impurity.py`` (``:39-335``, ``_lex_argmin`` ``:384``,
``best_split_regression`` ``:533``), with the same selection rules:

- the cost of candidate ``(f, b)`` is the weighted child impurity
  ``(n_l * H(left) + n_r * H(right)) / n``;
- per feature the lowest-cost bin wins, ties to the lowest threshold; across
  features the lowest cost wins, ties to the lowest feature index;
- candidates with an empty side, outside ``cand_mask`` or under
  ``min_child_weight`` cost ``+inf``.

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
host tier; to float32 for the regression sweep, which then runs the JAX
package's float32 formula op for op.

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


class SplitDecision(NamedTuple):
    """Per-frontier-slot split search result, shapes (K,) unless noted.

    ``feature``/``bin`` name the winner; ``cost`` is its weighted child
    impurity as float32 (``+inf`` when no candidate is valid; under the
    float64 sweep the ``hi`` half); ``impurity``/``n`` describe the parent;
    ``counts`` is its (K, C) class-count vector (regression: the (K, 3)
    moments); ``constant`` is True when every feature has at most one
    occupied bin; ``n_left`` is the winner's left-side weight; ``y_range``
    (regression only, else None) is the node's ``max(y) - min(y)`` over
    rows of positive weight, its purity signal.
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
                   *, f64_out: bool = False):
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
    ``(cost, None, n_l, n_r)`` in float64 instead.
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
    div_l = torch.clamp(n_l, min=_EMPTY_SIDE)
    div_r = torch.clamp(n_r, min=_EMPTY_SIDE)
    div_t = torch.clamp(n_tot, min=_EMPTY_SIDE)
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


def best_split_classification(
    hist: torch.Tensor, cand_mask: torch.Tensor, *,
    criterion: str = "entropy", min_child_weight: float | None = None,
    exact_ties: bool = True, scale_exp=None,
) -> SplitDecision:
    """Pick the best (feature, bin) per frontier slot.

    ``hist`` (K, F, C, B) float32 from :func:`histogram.class_histogram`,
    or its int64 fixed-point form with ``scale_exp``; ``cand_mask`` (F, B)
    bool valid candidate bins. A fixed-point ``hist`` keeps the node's
    statistics in float64: ``counts``, ``n``, ``n_left``, the parent
    ``impurity`` and the winner's ``cost`` (the exact float64 sums the
    JAX package's host tier keeps), and checks ``min_child_weight``
    against float64 side weights.
    """
    if criterion not in ("entropy", "gini"):
        raise ValueError(f"unknown classification criterion: {criterion!r}")
    fixed = scale_exp is not None
    hist_sum = hist.sum(dim=2)  # (K, F, B); exact either way
    if fixed:
        cost64, _, n_l, n_r = cost_sweep_f64(hist, criterion, scale_exp,
                                             f64_out=True)
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
    cost = torch.where(valid, cost, torch.full_like(cost, math.inf))
    cost_lo = torch.where(valid, cost_lo, torch.zeros_like(cost_lo))

    best_bin_f = lex_argmin(cost, cost_lo, dim=2)  # (K, F)
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
    )


def best_split_regression(
    hist: torch.Tensor, cand_mask: torch.Tensor, *, scale_exp,
    min_child_weight: float | None = None,
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
    cost = torch.where(valid, cost, torch.full_like(cost, math.inf))

    no_lo = torch.zeros_like(cost)
    best_bin_f = lex_argmin(cost, no_lo, dim=2)  # first min: lowest bin
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
    )
