"""The port's host builder tier (``backend="host"``) against the JAX
package's.

``build_tree_host`` grows the levelwise tree on the host: the C++ sweep
when ``native.lib()`` is loaded, else the dense numpy sweep. Each is held
against the JAX package's same sweep on the same seeded inputs, field for
field on ``TreeArrays`` (leaves' NaN thresholds compare equal); the
estimators' ``backend="host"`` (host binning, the host build, then the
refine tail and pruning as on the device path) against JAX
``backend="host"`` at its defaults.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from mpitree_tpu_torch import native  # noqa: E402
from mpitree_tpu_torch.core.builder import BuildConfig  # noqa: E402
from mpitree_tpu_torch.core.host_builder import build_tree_host  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_dataset  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    RandomForestClassifier,
)
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


def assert_same_tree(got, want):
    assert got.n_nodes == want.n_nodes
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _weights(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 4, size=n).astype(np.float32)
    if kind == "frac":
        return (rng.random(n) * 2 + 0.1).astype(np.float32)
    return None


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("criterion", ["entropy", "gini"])
@pytest.mark.parametrize("weights", ["none", "int", "frac"])
def test_build_tree_host_identical_to_jax(monkeypatch, engine, criterion,
                                          weights):
    """Both sweeps of the host build, directly, on one host binning."""
    from mpitree_tpu import native as jax_native
    from mpitree_tpu.core.builder import BuildConfig as JaxConfig
    from mpitree_tpu.core.host_builder import build_tree_host as jax_build

    if engine == "numpy":
        monkeypatch.setattr(native, "lib", lambda: None)
        monkeypatch.setattr(jax_native, "lib", lambda: None)
    elif native.lib() is None:
        pytest.skip("no g++: the native sweep is absent")
    X, y = covtype_like(1_500, seed=7)
    y = y.astype(np.int32)
    binned = bin_dataset(X, max_bins=24)
    w = _weights(weights, len(y))
    kw = dict(criterion=criterion, max_depth=7, min_samples_split=4,
              min_child_weight=2.0, min_decrease_scaled=1e-3)
    ours, ids = build_tree_host(binned, y, config=BuildConfig(**kw),
                                n_classes=7, sample_weight=w,
                                return_leaf_ids=True)
    ref, ref_ids = jax_build(binned, y, config=JaxConfig(**kw), n_classes=7,
                             sample_weight=w, return_leaf_ids=True)
    assert_same_tree(ours, ref)
    np.testing.assert_array_equal(ids, ref_ids)
    assert ids.dtype == np.int32 and ours.n_nodes > 20


HOST_CASES = {
    # defaults: quantized covtype, so the refine tail engages
    "defaults": (dict(), 20_000, None),
    "depth-12": (dict(max_depth=12), 20_000, None),
    "no-refine": (dict(max_depth=9, refine_depth=None), 20_000, None),
    "refine-2-gini": (dict(max_depth=10, refine_depth=2, criterion="gini"),
                      8_000, None),
    "int-weights": (dict(max_depth=10), 8_000, "int"),
    "frac-weights": (dict(max_depth=8, refine_depth=None), 4_000, "frac"),
    "stopping-rules": (dict(max_depth=11, min_samples_leaf=3,
                            min_samples_split=9, min_impurity_decrease=2e-4,
                            max_bins=64), 8_000, None),
    "exact-bins": (dict(max_depth=6, binning="exact"), 3_000, None),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_backend_host_identical_to_jax(case):
    from mpitree_tpu.tree import DecisionTreeClassifier as JaxTree

    params, n, weights = HOST_CASES[case]
    X, y = covtype_like(n, seed=11)
    w = _weights(weights, n, seed=1)
    ref = JaxTree(backend="host", **params).fit(X, y, sample_weight=w)
    ours = DecisionTreeClassifier(backend="host", device="cpu",
                                  **params).fit(X, y, sample_weight=w)
    assert_same_tree(ours.tree_, ref.tree_)
    Xh, _ = covtype_like(2_000, seed=12)
    np.testing.assert_array_equal(ours.predict_proba(Xh),
                                  ref.predict_proba(Xh))


def test_backend_host_equals_the_device_engine():
    """The tiers grow the same trees (``backend=None`` is not routed to
    the host tier by size, as the JAX package does)."""
    X, y = covtype_like(4_000, seed=13)
    for kw in (dict(max_depth=10), dict(max_depth=5, refine_depth=None)):
        host = DecisionTreeClassifier(backend="host", device="cpu",
                                      **kw).fit(X, y)
        dev = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
        assert_same_tree(host.tree_, dev.tree_)
        assert host.fit_stats_.keys() == dev.fit_stats_.keys()


def test_forest_backend_host_identical_to_jax():
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(8_000, seed=14)
    kw = dict(n_estimators=3, max_depth=9, random_state=5)
    ref = JaxForest(backend="host", **kw).fit(X, y)
    ours = RandomForestClassifier(backend="host", device="cpu", **kw).fit(
        X, y)
    for a, b in zip(ours.trees_, ref.trees_, strict=True):
        assert_same_tree(a, b)
    assert ours.fit_stats_["refine_nodes_added"] > 0


@pytest.mark.parametrize("backend", ["cpu", "tpu", "gpu", "HOST"])
@pytest.mark.parametrize("est", [DecisionTreeClassifier,
                                 RandomForestClassifier])
def test_other_backends_raise(est, backend):
    """The JAX package's platform names point to ``device=``; anything else
    but None and "host" is refused."""
    X, y = covtype_like(100, seed=0)
    match = "device=" if backend in ("cpu", "tpu") else "None or 'host'"
    with pytest.raises(ValueError, match=match):
        est(backend=backend, device="cpu").fit(X, y)


def test_host_build_on_one_class_and_single_rows():
    """Degenerate inputs end as the JAX host build ends them: one pure
    root, and a root of one row."""
    from mpitree_tpu.core.builder import BuildConfig as JaxConfig
    from mpitree_tpu.core.host_builder import build_tree_host as jax_build

    X = np.arange(12, dtype=np.float32).reshape(6, 2)
    for y in (np.zeros(6, np.int32), np.array([0, 1, 0, 1, 1, 0], np.int32)):
        for rows in (slice(None), slice(0, 1)):
            binned = bin_dataset(X[rows], binning="exact")
            ours = build_tree_host(binned, y[rows], config=BuildConfig(),
                                   n_classes=2)
            ref = jax_build(binned, y[rows], config=JaxConfig(), n_classes=2)
            assert_same_tree(ours, ref)


def test_host_build_refuses_unknown_criterion():
    binned = bin_dataset(np.zeros((4, 1), np.float32))
    cfg = dataclasses.replace(BuildConfig(), criterion="mse")
    with pytest.raises(ValueError, match="criterion"):
        build_tree_host(binned, np.zeros(4, np.int32), config=cfg,
                        n_classes=1)
