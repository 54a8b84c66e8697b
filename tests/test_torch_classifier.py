"""The port's ``DecisionTreeClassifier`` on the CPU against the JAX package.

(a) iris, ``max_depth=3, binning="exact"``: ``export_text`` is byte-identical
    to the reference golden ``tests/test_classifier.py::GOLDEN_IRIS_DEPTH3``.
(b) ``covtype_like(20_000, seed=0)`` at ``max_depth=8``: the port's
    device engine (``refine_depth=None``) equals the JAX CPU device
    engine's (``backend="cpu", refine_depth=None``) field for field.
    Integer-valued class histograms are exact in any order and both sweeps
    rank float64 costs, so no tolerance applies.
(c) ``tree_from_reference`` on that JAX tree: the port's predict,
    predict_proba and apply equal JAX's on held-out rows.
(d) ``device=None`` raises ``RuntimeError`` when CUDA is missing: there is
    no silent CPU fallback.

Fractional ``sample_weight`` and ``class_weight`` are held against the JAX
package in ``tests/test_torch_weights.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch.models.classifier import NotFittedError  # noqa: E402
from mpitree_tpu_torch.tree import DecisionTreeClassifier  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: under pytest-xdist's parallel
    workers torch's intra-op threads oversubscribe the cores; the trees do
    not depend on the thread count (exact sums)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_tree(got, want):
    assert got.n_nodes == want.n_nodes
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def covtype_pair():
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(20_000, seed=0)
    jax_clf = JaxTree(max_depth=8, backend="cpu", refine_depth=None).fit(X, y)
    port = DecisionTreeClassifier(max_depth=8, device="cpu",
                                  refine_depth=None).fit(X, y)
    return X, y, jax_clf, port


def test_iris_export_text_is_golden(iris2):
    from test_classifier import GOLDEN_IRIS_DEPTH3

    X, y, data = iris2
    clf = DecisionTreeClassifier(
        max_depth=3, binning="exact", device="cpu"
    ).fit(X, y)
    text = clf.export_text(
        feature_names=data.feature_names, class_names=data.target_names,
        precision=2,
    )
    assert text == GOLDEN_IRIS_DEPTH3


def test_covtype_tree_identical_to_jax(covtype_pair):
    X, y, jax_clf, port = covtype_pair
    _assert_same_tree(port.tree_, jax_clf.tree_)
    assert port.get_depth() == jax_clf.get_depth() == 8
    assert port.get_n_leaves() == jax_clf.get_n_leaves()
    np.testing.assert_array_equal(port.classes_, jax_clf.classes_)


def test_reference_tree_carries_over(covtype_pair, tmp_path):
    X, y, jax_clf, _ = covtype_pair
    Xh, _ = covtype_like(4_000, seed=1)
    for arrays in (dataclasses.asdict(jax_clf.tree_), tmp_path / "t.npz"):
        if not isinstance(arrays, dict):
            jax_clf.tree_.save(arrays)
        port = DecisionTreeClassifier.from_reference(
            arrays, jax_clf.classes_, jax_clf.n_features_, device="cpu"
        )
        np.testing.assert_array_equal(port.predict(Xh), jax_clf.predict(Xh))
        pp, jp = port.predict_proba(Xh), jax_clf.predict_proba(Xh)
        assert pp.dtype == jp.dtype == np.int64
        np.testing.assert_array_equal(pp, jp)
        np.testing.assert_array_equal(port.apply(Xh), jax_clf.apply(Xh))
        assert port.score(Xh, jax_clf.predict(Xh)) == 1.0


@pytest.mark.parametrize("params", [
    dict(criterion="gini", max_depth=6),
    dict(max_depth=7, min_samples_leaf=5, min_samples_split=11,
         min_impurity_decrease=1e-3, max_bins=32),
], ids=["gini", "stopping-rules"])
def test_options_identical_to_jax(params):
    """Gini and the stopping rules (min_child_weight from
    min_samples_leaf, min_samples_split, min_impurity_decrease) with
    integer sample weights, against the JAX CPU engine."""
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(4_000, seed=3)
    w = np.random.default_rng(0).integers(1, 4, size=len(y)).astype(
        np.float32
    )
    jax_clf = JaxTree(backend="cpu", refine_depth=None, **params).fit(
        X, y, sample_weight=w
    )
    port = DecisionTreeClassifier(device="cpu", refine_depth=None,
                                  **params).fit(X, y, sample_weight=w)
    _assert_same_tree(port.tree_, jax_clf.tree_)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = covtype_like(200, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecisionTreeClassifier(max_depth=2).fit(X, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecisionTreeClassifier(max_depth=2, device="cuda").fit(X, y)
    clf = DecisionTreeClassifier(max_depth=2, device="cpu").fit(X, y)
    clf.set_params(device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        clf.predict(X)


def test_estimator_surface():
    X, y = covtype_like(600, seed=2)
    clf = DecisionTreeClassifier(max_depth=3, device="cpu")
    with pytest.raises(NotFittedError):
        clf.predict(X)
    params = clf.get_params()
    assert params["max_depth"] == 3 and params["device"] == "cpu"
    assert clf.set_params(max_depth=4) is clf and clf.max_depth == 4
    with pytest.raises(ValueError, match="Invalid parameter"):
        clf.set_params(nope=1)
    clf.fit(X, y)
    assert clf.get_depth() <= 4 and clf.get_n_leaves() >= 2
    acc = clf.score(X, y)
    assert acc == float(np.mean(clf.predict(X) == y))
    assert clf.predict_proba(X).sum(axis=1).tolist() == \
        clf.tree_.n_node_samples[clf.apply(X)].tolist()
    with pytest.raises(ValueError, match="features"):
        clf.predict(X[:, :5])


@pytest.mark.parametrize("param,value", [
    ("splitter", "random"), ("max_features", "sqrt"), ("max_leaf_nodes", 8),
])
def test_options_now_ported_equal_jax(param, value):
    """Once refused, now fitted: the tree equals the JAX default's."""
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(1_500, seed=0)
    kw = dict(max_depth=5, random_state=2, **{param: value})
    ref = JaxTree(**kw).fit(X, y)
    est = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    assert est.tree_.n_nodes == ref.tree_.n_nodes > 1
    for k in ("feature", "threshold", "left", "right", "count",
              "n_node_samples", "impurity"):
        np.testing.assert_array_equal(getattr(est.tree_, k),
                                      getattr(ref.tree_, k), err_msg=k)


@pytest.mark.parametrize("param,value", [
    # the 2-D (data, feature) mesh: n_devices=2 is a 1-D mesh since the
    # data mesh was ported, so the case keeps its id on the one refused
    pytest.param("n_devices", (2, 2), id="n_devices-2"),
])
def test_options_off_this_slice_raise(param, value):
    """The last option this slice refused, the (data, feature) mesh (item
    14d), is ported: it fits the one-device tree field for field."""
    from mpitree_tpu_torch.parallel import mesh

    X, y = covtype_like(100, seed=0)
    prev = mesh.set_cpu_shards(4)
    try:
        par = DecisionTreeClassifier(device="cpu", **{param: value}).fit(X, y)
    finally:
        mesh.set_cpu_shards(prev)
    one = DecisionTreeClassifier(device="cpu").fit(X, y)
    for k in ("feature", "threshold", "left", "right", "count",
              "n_node_samples", "impurity", "value"):
        np.testing.assert_array_equal(getattr(par.tree_, k),
                                      getattr(one.tree_, k), err_msg=k)
