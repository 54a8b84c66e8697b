"""The port's split sweep against ``mpitree_tpu.ops.impurity`` on the CPU.

Random integer class histograms (the only kind the build feeds it), with
ties built in: a duplicated feature column (equal costs across features:
the lower feature must win), empty bins (equal costs across neighbouring
bins: the lower bin must win) and a constant node. Both sweeps run:
``exact_ties=True`` (float64 costs ranked by the ``(hi, lo)`` float32
pair) and ``exact_ties=False`` (float32).

Tolerances: the winning feature, bin and left weight are equal; the
winning cost agrees within 1e-6 relative for the float32 sweep (float32
``log`` implementations differ by ulps) and the float64 cost ``hi + lo``
within 1e-12 relative (CUDA's, glibc's and XLA's float64 ``log`` may
differ by an ulp).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mpitree_tpu_torch.ops import impurity as port_imp  # noqa: E402


def _hist(seed, K=6, F=5, C=3, B=12, rows=400):
    """(K, F, C, B) counts of real rows, so every feature of a node sees
    the same per-class totals."""
    rng = np.random.default_rng(seed)
    used = np.flatnonzero(rng.random(B) < 0.75)  # the others stay empty
    xb = rng.choice(used, size=(rows, F))
    xb[:, 2] = xb[:, 0]  # duplicated feature: cross-feature ties
    y = rng.integers(0, C, size=rows)
    node = rng.integers(0, K, size=rows)
    xb[node == K - 1] = used[0]  # a constant node: one bin per feature
    h = np.zeros((K, F, C, B), np.float32)
    for f in range(F):
        np.add.at(h, (node, f, y, xb[:, f]), 1.0)
    cand = rng.random((F, B)) < 0.9
    cand[:, -1] = False
    return h, cand


def _jax_split(h, cand, **kw):
    import jax.numpy as jnp

    from mpitree_tpu.ops import impurity as jax_imp

    dec = jax_imp.best_split_classification(
        jnp.asarray(h), jnp.asarray(cand), **kw
    )
    return {k: np.asarray(getattr(dec, k)) for k in
            ("feature", "bin", "cost", "n", "counts", "constant", "n_left",
             "impurity")}


def _port_split(h, cand, **kw):
    dec = port_imp.best_split_classification(
        torch.from_numpy(h), torch.from_numpy(cand), **kw
    )
    return {k: getattr(dec, k).numpy() for k in
            ("feature", "bin", "cost", "n", "counts", "constant", "n_left",
             "impurity")}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("criterion", ["entropy", "gini"])
@pytest.mark.parametrize("exact_ties", [True, False])
@pytest.mark.parametrize("mcw", [0.0, 9.0])
def test_best_split_matches_jax(seed, criterion, exact_ties, mcw):
    h, cand = _hist(seed)
    kw = dict(criterion=criterion, min_child_weight=mcw,
              exact_ties=exact_ties)
    want = _jax_split(h, cand, **kw)
    got = _port_split(h, cand, **kw)
    for k in ("feature", "bin", "n_left", "n", "counts", "constant"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-6)
    np.testing.assert_allclose(got["impurity"], want["impurity"], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("criterion", ["entropy", "gini"])
def test_f64_sweep_matches_jax_within_1e12(criterion):
    """``(hi, lo)`` carries the float64 cost: ``hi + lo`` agrees within
    1e-12 relative, and the per-side totals exactly."""
    import jax.numpy as jnp

    from mpitree_tpu.ops import impurity as jax_imp

    h, _ = _hist(11, K=4, F=4, C=7, B=32)
    jh, jl, jnl, jnr = (np.asarray(a) for a in
                        jax_imp._cost_sweep_f64(jnp.asarray(h), criterion))
    ph, pl, pnl, pnr = (a.numpy() for a in
                        port_imp.cost_sweep_f64(torch.from_numpy(h),
                                                criterion))
    np.testing.assert_array_equal(pnl, jnl)
    np.testing.assert_array_equal(pnr, jnr)
    want = jh.astype(np.float64) + jl.astype(np.float64)
    got = ph.astype(np.float64) + pl.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


def test_lex_argmin_prefers_lo_then_first_index():
    hi = torch.tensor([[1.0, 0.5, 0.5, 0.5]])
    lo = torch.tensor([[0.0, 1e-9, -1e-9, -1e-9]])
    assert port_imp.lex_argmin(hi, lo, dim=1).tolist() == [2]
    inf = torch.full((1, 3), float("inf"))
    assert port_imp.lex_argmin(inf, torch.zeros(1, 3), dim=1).tolist() == [0]
