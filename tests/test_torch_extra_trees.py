"""The port's sampled classification forests on the CPU against the JAX
package: ``RandomForestClassifier(max_features="sqrt")`` in both
``max_features_mode`` values, ``ExtraTreesClassifier``, forest
``class_weight``, ``oob_score`` and ``warm_start``.

Both packages draw phase A (bootstrap, sampler seed, tree subspace) from
one numpy generator in the same order, and the node keys are uint32
arithmetic, so where the histogram sums are exact (integer bootstrap
multiplicities; ``class_weight`` on the port's fixed-point route against
the JAX host tier's float64 sums) every tree must be equal field for
field, and ``predict_proba`` and the OOB scores (the same float64 host
loops) equal bit for bit.

- ``covtype_like(10_000, seed=0)`` (540,000 cells, past the JAX
  package's host-routing bound), 4 trees of depth 8 at the defaults: the
  JAX default is its fused device forest with the refine tail, the port's
  each tree's crown on the device engine and the same host tail;
- ``ExtraTreesClassifier`` on the device engine alone at that size (JAX
  ``backend="cpu", refine_depth=None``), and at the defaults on
  ``covtype_like(3_000, seed=0)``, whose random-split tail runs the numpy
  sweep per subtree in both packages;
- ``class_weight="balanced"`` and ``warm_start`` on ``covtype_like(3_000,
  seed=1)``, where the JAX default is its host tier.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch.tree import (  # noqa: E402
    ExtraTreesClassifier,
    RandomForestClassifier,
)
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

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


@pytest.fixture(scope="module")
def data():
    X, y = covtype_like(10_000, seed=0)
    Xh, _ = covtype_like(2_000, seed=1)
    return X, y, Xh


@pytest.fixture(scope="module", params=["node", "tree"])
def sqrt_forests(request, data):
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y, _ = data
    kw = dict(PARAMS, max_features="sqrt", max_features_mode=request.param,
              oob_score=True)
    with pytest.warns(UserWarning, match="OOB"):
        ref = JaxForest(**kw).fit(X, y)
    with pytest.warns(UserWarning, match="OOB"):
        port = RandomForestClassifier(device="cpu", **kw).fit(X, y)
    return request.param, ref, port


def test_sqrt_forest_trees_equal_jax(sqrt_forests):
    mode, ref, port = sqrt_forests
    assert stats_view(port.fit_report_)["refine_nodes_added"] > 0
    _same_forest(port, ref)
    used = {int(f) for t in port.trees_ for f in t.feature[t.feature >= 0]}
    if mode == "tree":  # each tree keeps to its 7 features
        for t in port.trees_:
            assert len(set(t.feature[t.feature >= 0].tolist())) <= 7
    assert len(used) > 7


def test_sqrt_forest_oob_and_predictions_equal_jax(sqrt_forests, data):
    _, ref, port = sqrt_forests
    X, y, Xh = data
    assert port.oob_score_ == ref.oob_score_
    np.testing.assert_array_equal(port.oob_decision_function_,
                                  ref.oob_decision_function_)
    assert np.isnan(port.oob_decision_function_).any(axis=1).sum() > 0
    np.testing.assert_array_equal(port.predict_proba(Xh),
                                  ref.predict_proba(Xh))
    np.testing.assert_allclose(port.feature_importances_,
                               ref.feature_importances_, rtol=1e-12)
    assert not hasattr(port, "_oob_masks")


def test_extra_trees_device_engine_equals_jax(data):
    from mpitree_tpu.models.forest import ExtraTreesClassifier as JaxET

    X, y, Xh = data
    ref = JaxET(backend="cpu", refine_depth=None, **PARAMS).fit(X, y)
    port = ExtraTreesClassifier(device="cpu", refine_depth=None,
                                **PARAMS).fit(X, y)
    assert port.get_params()["bootstrap"] is False
    assert port.get_params()["max_features"] == "sqrt"
    assert port.splitter == "random"
    _same_forest(port, ref)
    np.testing.assert_array_equal(port.predict_proba(Xh),
                                  ref.predict_proba(Xh))


def test_extra_trees_defaults_equal_jax():
    from mpitree_tpu.models.forest import ExtraTreesClassifier as JaxET

    X, y = covtype_like(3_000, seed=0)
    kw = dict(n_estimators=2, max_depth=6, random_state=1)
    ref = JaxET(**kw).fit(X, y)
    port = ExtraTreesClassifier(device="cpu", **kw).fit(X, y)
    assert stats_view(port.fit_report_)["refine_engine"] == "per-subtree"
    assert stats_view(port.fit_report_)["refine_nodes_added"] > 0
    _same_forest(port, ref)


@pytest.mark.parametrize("mode", ["node", "tree"])
def test_class_weight_forest_equals_jax(mode):
    """Fractional class weights ride the bootstrap: the port's fixed-point
    route against the JAX host tier's exact float64 sums."""
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(3_000, seed=1)
    kw = dict(n_estimators=3, max_depth=6, random_state=2,
              class_weight="balanced", max_features="sqrt",
              max_features_mode=mode)
    ref = JaxForest(**kw).fit(X, y)
    port = RandomForestClassifier(device="cpu", **kw).fit(X, y)
    assert port.trees_[0].count.dtype == np.float64
    _same_forest(port, ref)


def test_warm_start_continues_to_the_full_forest():
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(3_000, seed=1)
    kw = dict(max_depth=5, random_state=4, max_features="sqrt")
    warm = RandomForestClassifier(device="cpu", n_estimators=4,
                                  warm_start=True, **kw).fit(X, y)
    kept = list(warm.trees_)
    warm.set_params(n_estimators=6).fit(X, y)
    assert all(a is b for a, b in zip(warm.trees_[:4], kept))
    full = RandomForestClassifier(device="cpu", n_estimators=6,
                                  **kw).fit(X, y)
    _same_forest(warm, full)
    _same_forest(warm, JaxForest(n_estimators=6, **kw).fit(X, y))
    with pytest.warns(UserWarning, match="does not fit new trees"):
        warm.fit(X, y)
    with pytest.raises(ValueError, match="larger or equal"):
        warm.set_params(n_estimators=5).fit(X, y)
    with pytest.raises(ValueError, match="integer random_state"):
        warm.set_params(n_estimators=7, random_state=None).fit(X, y)


def test_forest_parameter_refusals():
    X, y = covtype_like(300, seed=0)
    for kw, match in ((dict(oob_score=True, bootstrap=False), "bootstrap"),
                      (dict(max_features_mode="level"), "max_features_mode"),
                      (dict(splitter="best-first"), "splitter"),
                      (dict(max_features="cbrt"), "max_features")):
        with pytest.raises(ValueError, match=match):
            RandomForestClassifier(n_estimators=2, device="cpu",
                                   **kw).fit(X, y)
    # one row: every bootstrap draws it, so no tree leaves a row out
    with pytest.warns(UserWarning, match="no out-of-bag"):
        f = RandomForestClassifier(n_estimators=2, device="cpu",
                                   oob_score=True).fit(X[:1], y[:1])
    assert np.isnan(f.oob_score_)
    assert np.isnan(f.oob_decision_function_).all()
