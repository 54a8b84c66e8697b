"""The port's hybrid refine tail against the JAX package's.

At default settings (``refine_depth="auto"``) both packages grow the crown
on the device engine to ``round(log2(n_rows / 2048))`` when quantile
binning capped a feature and the native C++ sweep builds, then finish
every still-splittable crown leaf on the host with exact local candidates.
The JAX side runs at its defaults (``backend="cpu"``, no
``refine_depth=None``): the port's trees must equal it field for field on
``TreeArrays`` (leaves' NaN thresholds compare equal). The cases of
``tests/test_hybrid_builder.py`` carry over, each also held against JAX.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch import native  # noqa: E402
from mpitree_tpu_torch.core.builder import BuildConfig, build_tree  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_for_engine  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    RandomForestClassifier,
)
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402
from mpitree_tpu_torch.utils.validation import resolve_refine  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


def assert_same_tree(got, want):
    assert got.n_nodes == want.n_nodes
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def check_valid(t):
    """Children after parents, parent links, depths, partition sums."""
    inner = np.flatnonzero(t.feature >= 0)
    left, right = t.left[inner], t.right[inner]
    assert (left > inner).all() and (right > inner).all()
    assert (t.parent[left] == inner).all() and (t.parent[right] == inner).all()
    assert (t.depth[left] == t.depth[inner] + 1).all()
    np.testing.assert_array_equal(
        t.n_node_samples[left] + t.n_node_samples[right],
        t.n_node_samples[inner])
    leaves = t.feature < 0
    assert (t.left[leaves] == -1).all() and (t.right[leaves] == -1).all()
    assert np.isnan(t.threshold[leaves]).all()


@pytest.fixture
def with_native():
    if native.lib() is None:
        pytest.skip("no g++: the refine tail's default engine is absent")


@pytest.fixture
def no_native(monkeypatch):
    """Both packages without the native library (lib() is None)."""
    from mpitree_tpu import native as jax_native

    monkeypatch.setattr(native, "lib", lambda: None)
    monkeypatch.setattr(jax_native, "lib", lambda: None)


# -- the refine decision ----------------------------------------------------

@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("lib", ["present", "absent"])
def test_resolve_refine_identical_to_jax(monkeypatch, lib, quantized):
    from mpitree_tpu import native as jax_native
    from mpitree_tpu.utils.validation import resolve_refine as jax_resolve

    if lib == "absent":
        monkeypatch.setattr(native, "lib", lambda: None)
        monkeypatch.setattr(jax_native, "lib", lambda: None)
    elif native.lib() is None:
        pytest.skip("no g++: the native sweep is absent")
    grid = itertools.product(
        (None, 1, 2, 4, 8, 20),
        (None, "auto", 0, 1, 3, 8),
        (None, 0, 1, 1_000, 2_048, 3_000, 40_000, 581_012),
    )
    seen = set()
    for max_depth, rd, n_rows in grid:
        ours = resolve_refine(max_depth, rd, n_rows=n_rows,
                              quantized=quantized)
        assert ours == jax_resolve(max_depth, rd, n_rows=n_rows,
                                   quantized=quantized), (max_depth, rd,
                                                          n_rows)
        seen.add(ours[1])
    assert seen == {True, False}
    if lib == "present" and quantized:
        assert resolve_refine(20, "auto", n_rows=581_012) == (8, True, 8)


@pytest.mark.parametrize("bad", [3.5, -1, "x", "AUTO"])
def test_refine_depth_validation(bad):
    X, y = covtype_like(300, seed=4)
    with pytest.raises((ValueError, TypeError)):
        DecisionTreeClassifier(max_depth=8, refine_depth=bad,
                               device="cpu").fit(X, y)


# -- the crown's leaf ids -----------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3, 5])
def test_crown_leaf_ids_equal_apply(depth):
    """``build_tree(return_leaf_ids=True)``: every row's final node, rows
    of leaves that stopped early included, as ``apply`` descends to it."""
    X, y = covtype_like(3_000, seed=21)
    w = np.random.default_rng(3).integers(0, 3, len(y)).astype(np.float32)
    binned = bin_for_engine(X, max_bins=64, binning="auto",
                            device=torch.device("cpu"))
    cfg = BuildConfig(max_depth=depth, min_samples_split=40)
    tree, ids = build_tree(binned, y, config=cfg, n_classes=7,
                           sample_weight=w, return_leaf_ids=True)
    assert ids.dtype == np.int32 and ids.shape == (len(y),)
    plain = build_tree(binned, y, config=cfg, n_classes=7, sample_weight=w)
    assert_same_tree(tree, plain)
    clf = DecisionTreeClassifier.from_reference(
        {k: getattr(tree, k) for k in FIELDS}, np.arange(7), X.shape[1],
        device="cpu")
    np.testing.assert_array_equal(ids, clf.apply(X))
    assert (tree.feature[ids] < 0).all()


# -- default fits against the JAX package's defaults -----------------------

FIT_CASES = {
    "defaults": (dict(), 20_000, None),
    "depth-16-40k": (dict(max_depth=16), 40_000, None),
    "refine-2": (dict(max_depth=12, refine_depth=2), 12_000, None),
    "refine-3": (dict(max_depth=12, refine_depth=3), 12_000, None),
    "gini": (dict(max_depth=14, criterion="gini"), 12_000, None),
    "int-weights": (dict(max_depth=14), 12_000, "int"),
    "stopping-rules": (dict(max_depth=14, min_samples_leaf=4,
                            min_samples_split=10, min_impurity_decrease=1e-4,
                            min_weight_fraction_leaf=1e-4), 12_000, None),
    "max-bins-32": (dict(max_depth=10, max_bins=32), 8_000, None),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_default_fit_identical_to_jax(with_native, case):
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    params, n, weights = FIT_CASES[case]
    X, y = covtype_like(n, seed=0)
    w = None if weights is None else np.random.default_rng(5).integers(
        0, 4, size=n).astype(np.float32)
    ref = JaxTree(backend="cpu", **params).fit(X, y, sample_weight=w)
    ours = DecisionTreeClassifier(device="cpu", **params).fit(
        X, y, sample_weight=w)
    assert_same_tree(ours.tree_, ref.tree_)
    check_valid(ours.tree_)
    st = ours.fit_stats_
    assert st["refine_engine"] == "batched-native"
    assert st["crown_depth"] == params.get("refine_depth", max(
        1, round(np.log2(n / 2048))))
    assert st["refine_nodes_added"] > 0 and st["refine_candidates"] > 0
    assert ours.tree_.max_depth <= params.get("max_depth", 10**9)
    Xh, _ = covtype_like(3_000, seed=1)
    np.testing.assert_array_equal(ours.predict_proba(Xh),
                                  ref.predict_proba(Xh))


def test_the_tail_changes_the_default_tree(with_native):
    """The default fit is not the one-engine fit: the tail adds exact
    local candidates below the crown (the fault this slice repairs)."""
    X, y = covtype_like(8_000, seed=0)
    hybrid = DecisionTreeClassifier(max_depth=9, device="cpu").fit(X, y)
    single = DecisionTreeClassifier(max_depth=9, refine_depth=None,
                                    device="cpu").fit(X, y)
    assert hybrid.tree_.n_nodes != single.tree_.n_nodes
    assert "crown_depth" not in single.fit_stats_
    assert hybrid.fit_stats_["crown_depth"] == 2


def test_auto_without_native_is_one_engine(no_native):
    """No library: ``"auto"`` means no refine in both packages."""
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(4_000, seed=2)
    ref = JaxTree(max_depth=7, backend="cpu").fit(X, y)
    ours = DecisionTreeClassifier(max_depth=7, device="cpu").fit(X, y)
    single = DecisionTreeClassifier(max_depth=7, refine_depth=None,
                                    device="cpu").fit(X, y)
    assert_same_tree(ours.tree_, ref.tree_)
    assert_same_tree(ours.tree_, single.tree_)
    assert "crown_depth" not in ours.fit_stats_


# -- forests ------------------------------------------------------------------

FOREST = dict(n_estimators=4, max_depth=10, random_state=0)


@pytest.fixture(scope="module")
def forests():
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    if native.lib() is None:
        pytest.skip("no g++: the refine tail's default engine is absent")
    X, y = covtype_like(20_000, seed=0)
    ref = JaxForest(backend="cpu", **FOREST).fit(X, y)
    ours = RandomForestClassifier(device="cpu", **FOREST).fit(X, y)
    return ref, ours


@pytest.mark.parametrize("i", range(FOREST["n_estimators"]))
def test_forest_tree_identical_to_jax(forests, i):
    """Each member: its bootstrap crown, then the tail on its own rows
    (undrawn rows of weight 0 included, as the JAX package keeps them)."""
    ref, ours = forests
    assert_same_tree(ours.trees_[i], ref.trees_[i])
    check_valid(ours.trees_[i])


def test_forest_proba_identical_to_jax(forests):
    ref, ours = forests
    Xh, _ = covtype_like(3_000, seed=1)
    np.testing.assert_array_equal(ours.predict_proba(Xh),
                                  ref.predict_proba(Xh))
    st = ours.fit_stats_
    assert st["crown_depth"] == 3 and st["refine_nodes_added"] > 0


@pytest.mark.parametrize("params", [
    dict(n_estimators=3, max_depth=12, random_state=3, criterion="gini",
         min_samples_leaf=3),
    dict(n_estimators=2, max_depth=9, random_state=4, bootstrap=False,
         refine_depth=2),
], ids=["gini-leaf-floor", "no-bootstrap-refine-2"])
def test_forest_options_identical_to_jax(with_native, params):
    """Integer user weights riding the bootstrap into the tail, gini, leaf
    floors from the composed weights, bootstrap=False."""
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(8_000, seed=6)
    w = np.random.default_rng(8).integers(1, 3, size=len(y)).astype(
        np.float32)
    ref = JaxForest(backend="cpu", **params).fit(X, y, sample_weight=w)
    ours = RandomForestClassifier(device="cpu", **params).fit(
        X, y, sample_weight=w)
    for a, b in zip(ours.trees_, ref.trees_, strict=True):
        assert_same_tree(a, b)


# -- the two tail engines ------------------------------------------------------

def _preorder(t):
    out, stack = [], [0]
    while stack:
        i = stack.pop()
        out.append(i)
        if t.feature[i] >= 0:
            stack += [int(t.right[i]), int(t.left[i])]
    return np.asarray(out)


TAIL_CASES = {
    "entropy": dict(max_depth=7, refine_depth=2),
    "gini-floors": dict(max_depth=7, refine_depth=3, criterion="gini",
                        min_samples_leaf=2),
}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_per_subtree_tail_identical_to_jax(no_native, case):
    """Without the library an integer ``refine_depth`` runs the
    per-subtree numpy tail in both packages."""
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    X, y = covtype_like(3_000, seed=9)
    kw = TAIL_CASES[case]
    ref = JaxTree(backend="cpu", **kw).fit(X, y)
    ours = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    assert ours.fit_stats_["refine_engine"] == "per-subtree"
    assert_same_tree(ours.tree_, ref.tree_)
    check_valid(ours.tree_)


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_per_subtree_tail_equals_batched_tail(monkeypatch, with_native,
                                              case):
    """The same tree from both engines. The graft numbers nodes in
    another order (subtree by subtree vs level by level), so the trees are
    compared node for node in pre-order, and their predictions."""
    X, y = covtype_like(3_000, seed=9)
    kw = TAIL_CASES[case]
    batched = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    monkeypatch.setattr(native, "lib", lambda: None)
    per = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    assert batched.fit_stats_["refine_engine"] == "batched-native"
    assert per.fit_stats_["refine_engine"] == "per-subtree"
    a, b = batched.tree_, per.tree_
    assert a.n_nodes == b.n_nodes
    pa, pb = _preorder(a), _preorder(b)
    for k in ("feature", "threshold", "depth", "value", "count",
              "n_node_samples", "impurity"):
        np.testing.assert_array_equal(getattr(a, k)[pa], getattr(b, k)[pb],
                                      err_msg=k)
    assert batched.export_text() == per.export_text()
    np.testing.assert_array_equal(batched.predict_proba(X),
                                  per.predict_proba(X))


# -- the JAX package's hybrid cases ------------------------------------------

def _starved_data(n=6000, seed=0):
    """Signal in a narrow value range: few global bin edges land inside
    deep nodes (``tests/test_hybrid_builder.py:16``)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float64)
    X[:, 0] = np.where(X[:, 0] > 0, X[:, 0] * 100, X[:, 0])  # heavy tail
    y = (
        (np.abs(X[:, 0]) < 0.3).astype(int)
        + 2 * ((X[:, 1] > 0.1) & (X[:, 1] < 0.6)).astype(int)
    )
    return X, y.astype(np.int64)


def _bin_starved_constant_data():
    """``max_bins=4`` exhausts the global bins by depth ~2, so the crown
    stops every leaf as constant while raw values still carry signal."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 1, 900),
                        np.repeat([1000.0, 1001.0, 1002.0, 1003.0], 25)])
    y = np.concatenate([np.zeros(900, int), np.repeat([0, 1, 0, 1], 25)])
    return x.reshape(-1, 1), y


def _both(params, X, y, backend="cpu"):
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    ref = JaxTree(backend=backend, **params).fit(X, y)
    ours = DecisionTreeClassifier(
        device="cpu", backend="host" if backend == "host" else None,
        **params).fit(X, y)
    assert_same_tree(ours.tree_, ref.tree_)
    check_valid(ours.tree_)
    return ours


def test_hybrid_valid_and_at_least_as_accurate(with_native):
    X, y = _starved_data()
    plain = _both(dict(max_depth=10, max_bins=8, refine_depth=None), X, y)
    hyb = _both(dict(max_depth=10, max_bins=8, refine_depth=3), X, y)
    acc_p = (plain.predict(X) == y).mean()
    acc_h = (hyb.predict(X) == y).mean()
    assert acc_h >= acc_p and acc_h > 0.9
    assert hyb.export_text().count("\n") + 1 == hyb.tree_.n_nodes
    assert hyb.tree_.count[0].sum() == len(X)


def test_hybrid_deterministic(with_native):
    X, y = _starved_data(seed=3)
    kw = dict(max_depth=8, max_bins=8, refine_depth=3)
    a = _both(kw, X, y)
    b = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    assert_same_tree(a.tree_, b.tree_)
    assert a.get_params()["refine_depth"] == 3


def test_hybrid_respects_max_depth_and_noop_cases(with_native):
    X, y = _starved_data(seed=1)
    h = _both(dict(max_depth=6, max_bins=8, refine_depth=4), X, y)
    assert h.tree_.max_depth <= 6
    # refine_depth >= max_depth: one device build to max_depth
    p = _both(dict(max_depth=4, max_bins=8, refine_depth=4), X, y)
    q = _both(dict(max_depth=4, max_bins=8, refine_depth=None), X, y)
    assert_same_tree(p.tree_, q.tree_)
    assert "crown_depth" not in p.fit_stats_


def test_refine_reaches_leaves_stopped_constant_above_refine_depth(
        with_native):
    """Candidates by outcome (impure leaf at depth <= refine_depth), not
    by depth: crown leaves stopped as bin-constant shallower than the
    crown are refined too."""
    X, y = _bin_starved_constant_data()
    clf = _both(dict(max_depth=10, max_bins=4, refine_depth=4), X, y)
    assert (clf.predict(X) == y).mean() == 1.0
    clf2 = _both(dict(max_depth=10, max_bins=4, refine_depth=2), X, y)
    assert clf.export_text() == clf2.export_text()


def test_host_backend_honors_refine_depth(with_native):
    X, y = _bin_starved_constant_data()
    host = _both(dict(max_depth=10, max_bins=4, refine_depth=4), X, y,
                 backend="host")
    assert (host.predict(X) == y).mean() == 1.0
    dev = DecisionTreeClassifier(max_depth=10, max_bins=4, refine_depth=4,
                                 device="cpu").fit(X, y)
    assert host.export_text() == dev.export_text()


def test_unbounded_depth_tail(with_native):
    """``max_depth=None``: every root grows until its leaves stop."""
    X, y = _starved_data(n=3_000, seed=5)
    clf = _both(dict(max_bins=8, refine_depth=2), X, y)
    assert (clf.predict(X) == y).mean() == 1.0
