"""Streamed ensembles on the CPU: a port of ``tests/test_stream_ensembles.py``.

- the keyed forest draws (``bootstrap_weights``, ``tree_seed``,
  ``feature_subset``) equal the JAX package's bit for bit;
- a streamed forest equals the port's in-memory forest fitted under
  ``MPITREE_TPU_KEYED_BOOTSTRAP=1`` tree for tree (fused and levelwise
  engines, one device and the ``(tree, data)`` mesh of 8 CPU shards,
  the memory guard's data axis too) and the JAX package's streamed
  forest (classification exactly; the regression forest by R4's
  contract, the JAX device engine's float32 moments);
- streamed boosting equals the port's in-memory fit at K = 1 (the host
  round loop) and K = 8 (the fused rounds) bit for bit, and holds R4's
  contract against the JAX package's streamed fit at K = 1 (its device
  engine sums the fractional (g, h) in float32; JAX's streamed fused
  rounds fail under jax 0.9.0, ``ROADMAP.md`` R1);
- the refusals: ``oob_score``, ``early_stopping``, ``colsample_bytree``,
  a separate ``y``, a non-integer ``random_state`` under keyed draws.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu.ops import sampling as jax_sampling  # noqa: E402

from mpitree_tpu_torch import (  # noqa: E402
    ExtraTreesClassifier,
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
    StreamedDataset,
)
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.ops import sampling  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as M  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_eight_shards():
    """One torch thread (six pytest-xdist workers share the cores) and 8
    CPU shards, the JAX tests' 8 virtual devices; both restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = M.set_cpu_shards(8)
    yield
    M.set_cpu_shards(prev)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    N, F = 3000, 9
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[:, 2] = np.round(X[:, 2], 1)
    X[:, 4] = -1.5
    X[:, 6] = rng.integers(0, 3, N)
    y = ((X[:, 0] > 0).astype(int) + (X[:, 1] + X[:, 2] > 0.3)).astype(int)
    return X, y


@pytest.fixture(scope="module")
def yr(data):
    X, _ = data
    return (2.0 * X[:, 0] + np.sin(X[:, 1])).astype(np.float64)


def _same_trees(got, want, what=""):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.n_nodes == b.n_nodes, (what, i)
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=f"{what} tree {i} {k}")


def _jax_streamed(cls_name, X, y, chunk, **kw):
    import mpitree_tpu
    from mpitree_tpu import StreamedDataset as JaxStream
    from mpitree_tpu.models import forest as jax_forest

    cls = getattr(mpitree_tpu, cls_name, None) or getattr(jax_forest,
                                                          cls_name)
    return cls(backend="cpu", n_devices=8, **kw).fit(
        dataset=JaxStream.from_arrays(X, y, chunk_rows=chunk))


def _keyed(cls, X, y, monkeypatch, **kw):
    """The in-memory twin: keyed draws opt in through the knob."""
    monkeypatch.setenv("MPITREE_TPU_KEYED_BOOTSTRAP", "1")
    ref = cls(**kw).fit(X, y)
    monkeypatch.delenv("MPITREE_TPU_KEYED_BOOTSTRAP")
    return ref


# ---------------------------------------------------------------------------
# keyed draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 2**31 + 7, 2**32 - 1])
def test_keyed_draws_equal_jax(seed):
    for t in (0, 1, 7, 1000):
        a = sampling.bootstrap_weights(seed, t, 5000)
        b = jax_sampling.bootstrap_weights(seed, t, 5000)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert sampling.tree_seed(seed, t) == jax_sampling.tree_seed(seed, t)
        for F, k in ((54, 7), (9, 3), (1, 1)):
            np.testing.assert_array_equal(
                sampling.feature_subset(seed, t, F, k),
                jax_sampling.feature_subset(seed, t, F, k))
    np.testing.assert_array_equal(sampling._POISSON1_CUTOFFS,
                                  jax_sampling._POISSON1_CUTOFFS)
    # Poisson(1): mean and zero share of a bootstrap
    w = sampling.bootstrap_weights(seed, 0, 200_000)
    assert abs(w.mean() - 1.0) < 0.01
    assert abs((w == 0).mean() - np.exp(-1.0)) < 0.01


# ---------------------------------------------------------------------------
# forests
# ---------------------------------------------------------------------------

RF_KW = dict(n_estimators=6, max_depth=5, max_bins=32, random_state=3,
             refine_depth=None)


@pytest.fixture(scope="module")
def jax_rf(data):
    X, y = data
    return _jax_streamed("RandomForestClassifier", X, y, 251, **RF_KW)


@pytest.mark.parametrize("engine", ["fused", "levelwise"])
@pytest.mark.parametrize("n_devices", [None, 8])
def test_streamed_forest_identity(data, jax_rf, engine, n_devices,
                                  monkeypatch):
    """Streamed == keyed in-memory (one device, and the (4, 2) tree-data
    mesh of 8 shards), and == JAX's streamed forest."""
    X, y = data
    monkeypatch.setenv("MPITREE_TPU_ENGINE", engine)
    kw = dict(device="cpu", n_devices=n_devices, **RF_KW)
    ref = _keyed(RandomForestClassifier, X, y, monkeypatch, **kw)
    clf = RandomForestClassifier(**kw).fit(
        dataset=StreamedDataset.from_arrays(X, y, chunk_rows=251))
    _same_trees(clf.trees_, ref.trees_, "vs keyed in-memory")
    _same_trees(clf.trees_, jax_rf.trees_, "vs JAX streamed")
    np.testing.assert_array_equal(clf.predict_proba(X),
                                  jax_rf.predict_proba(X))
    if engine == "fused" and n_devices == 8:
        assert stats_view(clf.fit_report_)["forest_mesh"] == [4, 2]


def test_streamed_forest_on_the_guards_data_axis(data, monkeypatch):
    """A one-byte budget forces the (1, 8) tree-data mesh: every tree
    grows over all 8 shards' rows."""
    X, y = data
    monkeypatch.setenv("MPITREE_TPU_FOREST_HBM_BUDGET", "1")
    kw = dict(device="cpu", n_devices=8, **dict(RF_KW, n_estimators=2))
    ref = _keyed(RandomForestClassifier, X, y, monkeypatch, **kw)
    clf = RandomForestClassifier(**kw).fit(
        StreamedDataset.from_arrays(X, y, chunk_rows=1111))
    assert stats_view(clf.fit_report_)["forest_mesh"] == [1, 8]
    _same_trees(clf.trees_, ref.trees_)


def test_streamed_forest_regressor_identity(data, yr, monkeypatch):
    X, _ = data
    kw = dict(device="cpu", n_devices=8, **RF_KW)
    ref = _keyed(RandomForestRegressor, X, yr, monkeypatch, **kw)
    reg = RandomForestRegressor(**kw).fit(
        dataset=StreamedDataset.from_arrays(X, yr, chunk_rows=997))
    _same_trees(reg.trees_, ref.trees_)
    np.testing.assert_array_equal(reg.predict(X), ref.predict(X))
    # JAX's device engine sums float32 moments: R4's contract per tree
    want = _jax_streamed("RandomForestRegressor", X, yr, 997, **RF_KW)
    for a, b in zip(reg.trees_, want.trees_):
        assert a.n_nodes == b.n_nodes
        assert np.mean(a.feature == b.feature) >= 0.9
    pred = want.predict(X)
    r2 = 1 - ((reg.predict(X) - pred) ** 2).sum() / (
        (pred - pred.mean()) ** 2).sum()
    assert r2 > 1 - 1e-3


def test_streamed_extratrees_identity(data, monkeypatch):
    """No bootstrap, random splits, per-node sqrt subsets, all keyed."""
    X, y = data
    kw = dict(device="cpu", n_devices=8, **RF_KW)
    ref = _keyed(ExtraTreesClassifier, X, y, monkeypatch, **kw)
    clf = ExtraTreesClassifier(**kw).fit(
        dataset=StreamedDataset.from_arrays(X, y, chunk_rows=640))
    _same_trees(clf.trees_, ref.trees_)
    want = _jax_streamed("ExtraTreesClassifier", X, y, 640, **RF_KW)
    _same_trees(clf.trees_, want.trees_, "vs JAX streamed")


def test_streamed_forest_tree_subspaces_identity(data, monkeypatch):
    """``max_features_mode="tree"`` draws the keyed ``feature_subset``."""
    X, y = data
    kw = dict(max_features="sqrt", max_features_mode="tree", device="cpu",
              **RF_KW)
    ref = _keyed(RandomForestClassifier, X, y, monkeypatch, **kw)
    clf = RandomForestClassifier(**kw).fit(
        dataset=StreamedDataset.from_arrays(X, y, chunk_rows=499))
    _same_trees(clf.trees_, ref.trees_)
    want = _jax_streamed("RandomForestClassifier", X, y, 499,
                         max_features="sqrt", max_features_mode="tree",
                         **RF_KW)
    _same_trees(clf.trees_, want.trees_, "vs JAX streamed")


def test_keyed_in_memory_forest_differs_from_host_rng(data, monkeypatch):
    """The knob switches the draws: without it the multinomial host RNG
    draws other bootstraps (the JAX package's default)."""
    X, y = data
    kw = dict(device="cpu", **dict(RF_KW, n_estimators=2))
    keyed = _keyed(RandomForestClassifier, X, y, monkeypatch, **kw)
    host = RandomForestClassifier(**kw).fit(X, y)
    assert any(a.n_nodes != b.n_nodes or not np.array_equal(a.count, b.count)
               for a, b in zip(keyed.trees_, host.trees_))


def test_streamed_forest_refusals(data, monkeypatch):
    X, y = data
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=499)
    with pytest.raises(ValueError, match="oob_score"):
        RandomForestClassifier(oob_score=True, device="cpu",
                               **RF_KW).fit(dataset=ds)
    with pytest.raises(ValueError, match="separate y"):
        RandomForestClassifier(device="cpu", **RF_KW).fit(dataset=ds, y=y)
    with pytest.raises(ValueError, match="random_state must be None or an"):
        RandomForestClassifier(
            device="cpu", **dict(RF_KW, random_state=np.random.default_rng(
                0))).fit(dataset=ds)
    with pytest.raises(ValueError, match="device engine only"):
        RandomForestRegressor(backend="host", device="cpu",
                              **RF_KW).fit(dataset=ds)
    monkeypatch.setenv("MPITREE_TPU_KEYED_BOOTSTRAP", "1")
    with pytest.raises(ValueError, match="random_state must be None or an"):
        RandomForestClassifier(
            device="cpu", **dict(RF_KW, random_state=np.random.default_rng(
                0))).fit(X, y)


# ---------------------------------------------------------------------------
# boosting
# ---------------------------------------------------------------------------

GB_KW = dict(max_iter=6, max_depth=3, max_bins=32, random_state=0)


def _r4_ensemble(got, want, X, proba: bool):
    """``ROADMAP.md`` R4 against the JAX device engine, whose boosted
    rounds sum the fractional (g, h) in float32 where the port's sums are
    exact: per tree the same node count and at least 90% of the nodes on
    the same feature, and the answers' R^2 against JAX's within 1e-3."""
    assert len(got.trees_) == len(want.trees_)
    for a, b in zip(got.trees_, want.trees_):
        assert a.n_nodes == b.n_nodes
        assert np.mean(a.feature == b.feature) >= 0.9
    f = (lambda e: e.predict_proba(X)[:, 1]) if proba else (
        lambda e: e.predict(X))
    p, q = f(got), f(want)
    assert 1 - ((p - q) ** 2).sum() / ((q - q.mean()) ** 2).sum() > 1 - 1e-3


def _same_ensembles(got, want, X):
    _same_trees(got.trees_, want.trees_)
    np.testing.assert_array_equal(got._raw_predict(X), want._raw_predict(X))


@pytest.mark.parametrize("chunk", [251, 1000])
@pytest.mark.parametrize("n_devices", [None, 8])
def test_streamed_gbdt_identity_host_loop(data, chunk, n_devices):
    """K = 1: the port's streamed ensemble == its in-memory one, and
    holds R4's contract against the JAX package's streamed one (JAX's
    device engine)."""
    X, y3 = data
    y = (y3 > 0).astype(int)
    kw = dict(rounds_per_dispatch=1, device="cpu", n_devices=n_devices,
              **GB_KW)
    ref = GradientBoostingClassifier(**kw).fit(X, y)
    clf = GradientBoostingClassifier(**kw).fit(
        dataset=StreamedDataset.from_arrays(X, y, chunk_rows=chunk))
    _same_ensembles(clf, ref, X)
    want = _jax_streamed("GradientBoostingClassifier", X, y, chunk,
                         rounds_per_dispatch=1, **GB_KW)
    _r4_ensemble(clf, want, X, proba=True)


@pytest.mark.parametrize("n_devices", [None, 8])
def test_streamed_gbdt_fused_rounds_identity(data, yr, n_devices):
    """K = 8 (the fused rounds) == the port's in-memory K = 8 fit bit for
    bit, binary and regression."""
    X, y3 = data
    y = (y3 > 0).astype(int)
    for cls, target in ((GradientBoostingClassifier, y),
                        (GradientBoostingRegressor, yr)):
        kw = dict(rounds_per_dispatch=8, device="cpu", n_devices=n_devices,
                  **dict(GB_KW, max_iter=10))
        ref = cls(**kw).fit(X, target)
        got = cls(**kw).fit(
            dataset=StreamedDataset.from_arrays(X, target, chunk_rows=600))
        assert stats_view(got.fit_report_)["rounds_per_dispatch"]["value"] == 8
        _same_ensembles(got, ref, X)


def test_streamed_gbdt_subsample_identity(data):
    """Keyed row masks are a function of (seed, round, global row)."""
    X, y = data
    kw = dict(subsample=0.7, device="cpu", n_devices=8, **GB_KW)
    ref = GradientBoostingClassifier(**kw).fit(X, y)
    clf = GradientBoostingClassifier(**kw).fit(
        dataset=StreamedDataset.from_arrays(X, y, chunk_rows=499))
    _same_ensembles(clf, ref, X)


def test_streamed_gbdt_regressor_identity(data, yr):
    X, _ = data
    kw = dict(rounds_per_dispatch=1, **GB_KW)
    reg = GradientBoostingRegressor(device="cpu", n_devices=8, **kw).fit(
        dataset=StreamedDataset.from_arrays(X, yr, chunk_rows=997))
    _same_ensembles(reg, GradientBoostingRegressor(device="cpu",
                                                   **kw).fit(X, yr), X)
    want = _jax_streamed("GradientBoostingRegressor", X, yr, 997, **kw)
    _r4_ensemble(reg, want, X, proba=False)


def test_streamed_gbdt_refusals(data):
    X, y = data
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=500)
    with pytest.raises(ValueError, match="early_stopping"):
        GradientBoostingClassifier(early_stopping=True, device="cpu",
                                   **GB_KW).fit(dataset=ds)
    with pytest.raises(ValueError, match="colsample_bytree"):
        GradientBoostingClassifier(colsample_bytree=0.5, device="cpu",
                                   **GB_KW).fit(dataset=ds)
    with pytest.raises(ValueError, match="separate y"):
        GradientBoostingClassifier(device="cpu", **GB_KW).fit(dataset=ds,
                                                              y=y)
    with pytest.raises(ValueError, match="not both"):
        GradientBoostingRegressor(device="cpu", **GB_KW).fit(X, dataset=ds)


def test_padded_extents_ensembles(data, yr, monkeypatch):
    """2,999 rows on 8 row blocks: the streamed shards carry a padding row
    that the forest's (tree, data) groups, the exchange's row count and
    the fused rounds must not see."""
    X, y = data
    Xp, yp, rp = X[:2999], y[:2999], yr[:2999]
    kw = dict(device="cpu", n_devices=8, **RF_KW)
    ref = _keyed(RandomForestClassifier, Xp, yp, monkeypatch, **kw)
    clf = RandomForestClassifier(**kw).fit(
        StreamedDataset.from_arrays(Xp, yp, chunk_rows=700))
    assert stats_view(clf.fit_report_)["forest_mesh"] == [4, 2]
    _same_trees(clf.trees_, ref.trees_)
    gb = dict(rounds_per_dispatch=8, device="cpu", n_devices=8,
              **dict(GB_KW, max_iter=8))
    got = GradientBoostingRegressor(**gb).fit(
        StreamedDataset.from_arrays(Xp, rp, chunk_rows=700))
    _same_ensembles(got, GradientBoostingRegressor(
        **dict(gb, n_devices=None)).fit(Xp, rp), Xp)
