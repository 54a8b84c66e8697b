"""The port's ``DecisionTreeRegressor`` on the CPU against the JAX package.

``california_like(4_000, seed=0)`` (8 features, ``BASELINE.json`` config
4's shape at a test's size):

- device engine (``refine_depth=None``) against the JAX device engine
  (``backend="cpu"``): the JAX package's own cross-engine contract for
  regression (``tests/test_host_builder.py:75-89``): the same node count,
  at least 90% of the nodes on the same feature, R^2 within 1e-3. The two
  differ in their sums, not their formula: JAX adds the moments in float32
  in scatter order, the port adds exact int64 fixed-point sums and rounds
  them to float32 once, so near-tied costs can resolve differently;
- exact where the contract is exact: every leaf's value is the float64
  mean of its rows (the refit), ``backend="host"`` equals JAX's
  ``backend="host"`` field for field (the same C++ sweep), and at these
  sizes the port's default (crown on the device engine, tail on the host)
  equals the JAX default (the host tier) field for field;
- ``ccp_alpha``, ``cost_complexity_pruning_path``, ``export_text``,
  ``apply``, ``score``, ``from_reference``, fractional weights, the
  sampling options (``tests/test_torch_sampling.py`` holds them in
  depth) and the refusals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("sklearn")

from mpitree_tpu_torch.tree import DecisionTreeRegressor  # noqa: E402
from mpitree_tpu_torch.utils.datasets import california_like  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


def _same_tree(got, want):
    assert got.n_nodes == want.n_nodes
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def data():
    X, y = california_like(4_000, seed=0)
    w = np.random.default_rng(2).uniform(0.5, 2, len(y)).astype(np.float32)
    return X, y, w


def _jax(**kw):
    from mpitree_tpu.tree import DecisionTreeRegressor as JaxReg

    return JaxReg(**kw)


@pytest.mark.parametrize("weighted", [False, True])
def test_device_engine_against_jax_device_engine(data, weighted):
    X, y, w = data
    sw = w if weighted else None
    kw = dict(max_depth=8, refine_depth=None)
    ref = _jax(backend="cpu", **kw).fit(X, y, sample_weight=sw)
    est = DecisionTreeRegressor(device="cpu", **kw).fit(X, y,
                                                        sample_weight=sw)
    assert est.fit_stats_["engine"] == "fused"
    assert est.tree_.n_nodes == ref.tree_.n_nodes
    agree = np.mean(est.tree_.feature == ref.tree_.feature)
    assert agree >= 0.9, f"only {agree:.0%} of nodes agree"
    assert abs(est.score(X, y, sw) - ref.score(X, y, sw)) < 1e-3


def test_leaf_values_are_the_exact_refit(data):
    X, y, w = data
    for sw in (None, w):
        est = DecisionTreeRegressor(max_depth=10, refine_depth=None,
                                    device="cpu").fit(X, y, sample_weight=sw)
        leaf = est.apply(X)
        ww = np.ones(len(y)) if sw is None else sw.astype(np.float64)
        n = est.tree_.n_nodes
        s = np.bincount(leaf, weights=y * ww, minlength=n)
        c = np.bincount(leaf, weights=ww, minlength=n)
        mean = s / np.maximum(c, 1e-300)
        np.testing.assert_array_equal(est.predict(X), mean[leaf])
        assert est.tree_.count.shape == (n, 1)
        assert est.tree_.count.dtype == np.float64
        assert est.tree_.value.dtype == np.float32


@pytest.mark.parametrize("kw", [
    dict(max_depth=8, refine_depth=None), dict(), dict(max_depth=6),
], ids=["depth8", "defaults", "depth6-tail"])
def test_host_tier_equals_jax_host_tier(data, kw):
    X, y, w = data
    for sw in (None, w):
        ref = _jax(backend="host", **kw).fit(X, y, sample_weight=sw)
        est = DecisionTreeRegressor(backend="host", device="cpu", **kw).fit(
            X, y, sample_weight=sw)
        assert est.fit_stats_["engine"] == "host"
        _same_tree(est.tree_, ref.tree_)


def test_default_equals_jax_default(data):
    X, y, _ = data
    ref = _jax().fit(X, y)
    est = DecisionTreeRegressor(device="cpu").fit(X, y)
    assert est.fit_stats_["engine"] == "fused"
    assert est.fit_stats_["refine_nodes_added"] > 0
    _same_tree(est.tree_, ref.tree_)
    # unbounded, the tree memorizes; a leaf may keep several rows of the
    # clipped target (0.15 or 5.0), whose float64 mean is within an ulp
    assert np.abs(est.predict(X) - y).max() <= 1e-15


def test_ccp_alpha_pruning_path_and_export_text(data):
    X, y, _ = data
    kw = dict(max_depth=7, backend="host")
    ref = _jax(**kw)
    est = DecisionTreeRegressor(device="cpu", **kw)
    want = ref.cost_complexity_pruning_path(X, y)
    got = est.cost_complexity_pruning_path(X, y)
    np.testing.assert_array_equal(got.ccp_alphas, want.ccp_alphas)
    np.testing.assert_array_equal(got.impurities, want.impurities)
    alpha = float(want.ccp_alphas[len(want.ccp_alphas) // 2])
    ref.set_params(ccp_alpha=alpha).fit(X, y)
    est.set_params(ccp_alpha=alpha).fit(X, y)
    assert 1 < est.tree_.n_nodes < 2 ** 8
    _same_tree(est.tree_, ref.tree_)
    names = [f"x{i}" for i in range(X.shape[1])]
    assert est.export_text(feature_names=names, precision=3) == \
        ref.export_text(feature_names=names, precision=3)
    assert "value: " in est.export_text()


def test_surface_apply_score_and_reference_carry(data):
    from sklearn.metrics import r2_score

    X, y, w = data
    ref = _jax(max_depth=6, backend="host").fit(X, y)
    est = DecisionTreeRegressor.from_reference(
        dataclasses.asdict(ref.tree_), X.shape[1], device="cpu")
    Xh, yh = california_like(1_000, seed=1)
    np.testing.assert_array_equal(est.predict(Xh), ref.predict(Xh))
    np.testing.assert_array_equal(est.apply(Xh), ref.apply(Xh))
    assert est.apply(Xh).dtype == np.int64
    assert est.score(Xh, yh) == pytest.approx(r2_score(yh, est.predict(Xh)),
                                              rel=1e-12)
    assert est.score(Xh, yh, w[:1_000]) == pytest.approx(
        r2_score(yh, est.predict(Xh), sample_weight=w[:1_000]), rel=1e-12)
    assert est.get_depth() == 6 and est.get_n_leaves() == ref.get_n_leaves()
    with pytest.raises(ValueError, match="features"):
        est.predict(Xh[:, :5])
    params = est.get_params()
    assert params["criterion"] == "squared_error" and params["device"] == "cpu"


@pytest.mark.parametrize("param,value", [
    ("splitter", "random"), ("max_features", "sqrt"),
])
def test_options_now_ported_equal_jax(data, param, value):
    """Once refused, now fitted: the tree equals the JAX default's."""
    X, y, _ = data
    kw = dict(max_depth=6, random_state=2, **{param: value})
    ref = _jax(**kw).fit(X, y)
    est = DecisionTreeRegressor(device="cpu", **kw).fit(X, y)
    _same_tree(est.tree_, ref.tree_)


@pytest.mark.parametrize("param,value", [
    # the 2-D (data, feature) mesh: n_devices=2 is a 1-D mesh since the
    # data mesh was ported, so the case keeps its id on the one refused
    pytest.param("n_devices", (2, 2), id="n_devices-2"),
])
def test_options_off_this_slice_raise(param, value):
    X, y = california_like(100, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecisionTreeRegressor(device="cpu", **{param: value}).fit(X, y)


def test_bad_input_and_no_silent_cpu_fallback(monkeypatch):
    from mpitree_tpu_torch.models.classifier import NotFittedError

    X, y = california_like(100, seed=0)
    with pytest.raises(ValueError, match="criterion"):
        DecisionTreeRegressor(criterion="friedman_mse", device="cpu").fit(
            X, y)
    bad = y.copy()
    bad[3] = np.nan
    with pytest.raises(ValueError, match="finite"):
        DecisionTreeRegressor(device="cpu").fit(X, bad)
    with pytest.raises(NotFittedError):
        DecisionTreeRegressor(device="cpu").predict(X)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecisionTreeRegressor().fit(X, y)
