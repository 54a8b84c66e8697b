"""The port's regression forests on the CPU against the JAX package:
``RandomForestRegressor`` and ``ExtraTreesRegressor``, and serving them.

``california_like(20_000, seed=0)`` (``BASELINE.json`` config 4's 8
features), 4 trees of depth 8:

- at the defaults the JAX forest runs its host tier (``8 x 20,000`` cells
  are under its host-routing bound) and the port each tree's crown on the
  device engine (the fixed-point route's exact sums) and the same C++ or
  numpy tail: every tree equal field for field, ``predict`` and
  ``oob_prediction_`` bit for bit (the same float64 host loops);
- the device engine alone against the JAX device engine (``backend="cpu",
  refine_depth=None``), which adds its moments in float32 in scatter
  order, holds the regressor's cross-engine contract (R4 in
  ``ROADMAP.md``): per tree at least 90% of the nodes on the same feature,
  forest R^2 within 1e-3, and the same node count for the bagged forest.
  An extremely randomized tree draws its split bins per feature and then
  ranks the features by cost, so a float32 near-tie between two features
  changes a subtree: its node count may differ by up to 1%;
- ``compile_model`` of a regression forest (``forest_mean``) equals
  ``predict`` bit for bit, its int8 form stays within its exactness
  report, and a single regression tree serves by ``gather_value``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch.serving import compile_model, quantize  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeRegressor,
    ExtraTreesRegressor,
    RandomForestRegressor,
)
from mpitree_tpu_torch.utils.datasets import california_like  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits: under pytest-xdist's
    parallel workers, torch's intra-op threads oversubscribe the cores;
    the trees do not depend on the thread count (exact sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
PARAMS = dict(n_estimators=4, max_depth=8, random_state=0)


def _same_forest(port, ref):
    assert len(port.trees_) == len(ref.trees_)
    for i, (got, want) in enumerate(zip(port.trees_, ref.trees_)):
        assert got.n_nodes == want.n_nodes, i
        for k in FIELDS:
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype, (i, k)
            np.testing.assert_array_equal(a, b, err_msg=f"tree {i} {k}")


def _jax_class(name):
    from mpitree_tpu.models import forest

    return getattr(forest, name)


@pytest.fixture(scope="module")
def data():
    X, y = california_like(20_000, seed=0)
    Xh, yh = california_like(2_000, seed=1)
    return X, y, Xh, yh


@pytest.fixture(scope="module", params=["RandomForestRegressor",
                                        "ExtraTreesRegressor"])
def defaults(request, data):
    X, y, *_ = data
    kw = dict(PARAMS, oob_score=request.param == "RandomForestRegressor")
    port_cls = {"RandomForestRegressor": RandomForestRegressor,
                "ExtraTreesRegressor": ExtraTreesRegressor}[request.param]
    with (pytest.warns(UserWarning, match="OOB") if kw["oob_score"]
          else contextlib.nullcontext()):
        ref = _jax_class(request.param)(**kw).fit(X, y)
        port = port_cls(device="cpu", **kw).fit(X, y)
    return request.param, ref, port


def test_defaults_equal_jax_field_for_field(defaults, data):
    name, ref, port = defaults
    *_, Xh, yh = data
    assert stats_view(port.fit_report_)["engine"] == "fused"
    assert stats_view(port.fit_report_)["refine_nodes_added"] > 0
    _same_forest(port, ref)
    got = port.predict(Xh)
    np.testing.assert_array_equal(got, ref.predict(Xh))
    assert port.score(Xh, yh) == ref.score(Xh, yh) > 0.5
    np.testing.assert_allclose(port.feature_importances_,
                               ref.feature_importances_, rtol=1e-12)
    if name == "ExtraTreesRegressor":
        assert stats_view(port.fit_report_)["refine_engine"] == "per-subtree"
        assert port.get_params()["bootstrap"] is False
        assert port.get_params()["max_features"] == 1.0


def test_oob_prediction_equals_jax(defaults):
    name, ref, port = defaults
    if name != "RandomForestRegressor":
        assert not hasattr(port, "oob_score_")
        return
    assert port.oob_score_ == ref.oob_score_
    np.testing.assert_array_equal(port.oob_prediction_, ref.oob_prediction_)
    # a row is out of bag of some of 4 trees with p = 1 - (1 - 1/e)**4
    assert 0.8 < np.isfinite(port.oob_prediction_).mean() < 0.9


@pytest.mark.parametrize("name", ["RandomForestRegressor",
                                  "ExtraTreesRegressor"])
def test_device_engine_holds_the_cross_engine_contract(data, name):
    X, y, *_ = data
    port_cls = {"RandomForestRegressor": RandomForestRegressor,
                "ExtraTreesRegressor": ExtraTreesRegressor}[name]
    ref = _jax_class(name)(backend="cpu", refine_depth=None,
                           **PARAMS).fit(X, y)
    port = port_cls(device="cpu", refine_depth=None, **PARAMS).fit(X, y)
    slack = 0.0 if name == "RandomForestRegressor" else 0.01
    for got, want in zip(port.trees_, ref.trees_, strict=True):
        assert abs(got.n_nodes - want.n_nodes) <= slack * want.n_nodes
        n = min(got.n_nodes, want.n_nodes)
        assert np.mean(got.feature[:n] == want.feature[:n]) >= 0.9
    assert abs(port.score(X, y) - ref.score(X, y)) < 1e-3


def test_compiled_regression_forest_serves_predict(defaults, data):
    _, _, port = defaults
    *_, Xh, _ = data
    cm = compile_model(port, buckets=(1, 64, 512))
    assert cm.kind == "forest_mean" and cm.exact
    assert cm.dispatch == "plain version of traverse"
    for n in (1, 64, 700):  # 700 rows: two chunks of the largest bucket
        got = cm.raw(Xh[:n])
        assert got.shape == (n,) and got.dtype == np.float64
        np.testing.assert_array_equal(got, port.predict(Xh[:n]))
    np.testing.assert_array_equal(cm.predict(Xh[:9]), port.predict(Xh[:9]))
    q = compile_model(port, quantize="int8", quantize_tol=0.1)
    rep = q.serve_report_["quantization"]
    assert rep["mode"] == "int8"
    cal = quantize.synthesize_calibration(q.table, Xh.shape[1])
    delta = np.abs(q.raw(cal) - port.predict(cal)).max()
    assert delta <= rep["max_abs_delta"] + 1e-6


def test_compiled_regression_tree_gathers_its_values(data):
    X, y, Xh, _ = data
    est = DecisionTreeRegressor(max_depth=6, device="cpu").fit(X, y)
    cm = compile_model(est)
    assert cm.kind == "gather_value" and cm.dispatch == "plain gather"
    np.testing.assert_array_equal(cm.raw(Xh), est.predict(Xh))
    np.testing.assert_array_equal(cm.predict(Xh[:5]), est.predict(Xh[:5]))
    # int8 tables serve the plain quantized gather within their report
    q = compile_model(est, quantize="int8")
    rep = q.serve_report_["quantization"]
    assert q.kind == "gather_value" and rep["mode"] == "int8" and rep["ok"]
    cal = quantize.synthesize_calibration(q.table, Xh.shape[1])
    got = q.raw(cal)
    assert got.shape == (len(cal),) and got.dtype == np.float32
    assert np.abs(got - est.predict(cal)).max() <= rep["max_abs_delta"] + 1e-6
