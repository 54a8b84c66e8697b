"""Streamed tree fits on the CPU: a port of ``tests/test_ingest.py``'s
identity grid and of the streamed refine tests of
``tests/test_stream_ensembles.py``.

Each ``fit(dataset=StreamedDataset...)`` is held to two twins: the port's
in-memory fit of the same rows (field for field, on every mesh, engine
and chunking: the sketch is exact here, so the edges and bins are
``bin_dataset``'s) and the JAX package's streamed fit
(``backend="cpu"``, 8 devices; field for field where its sums are exact,
the regressor's float32 device moments by ``ROADMAP.md`` R4's contract).
Also: ``max_leaf_nodes``, sample weights per chunk, ``.npy`` shards, a
generator factory and a spilled one-shot generator, the refine tail
replaying the stream, padded extents (rows not divisible by the shards,
features not by the feature axis), the host-peak pin under
``tracemalloc``, and the refusals.
"""

from __future__ import annotations

import tracemalloc

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu_torch import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    ParallelDecisionTreeClassifier,
    StreamedDataset,
)
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
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


def _same_tree(got, want, what=""):
    assert got.n_nodes == want.n_nodes, what
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


def _jax_streamed(name, X, y, chunk, **kw):
    """The JAX package's streamed fit on its 8 CPU devices."""
    import mpitree_tpu
    from mpitree_tpu import StreamedDataset as JaxStream

    est = getattr(mpitree_tpu, name)(backend="cpu", n_devices=8, **kw)
    return est.fit(JaxStream.from_arrays(X, y, chunk_rows=chunk))


def _r4(got, want, X):
    """``ROADMAP.md`` R4: the JAX device engine sums the moments in
    float32, so the trees agree in node count, on at least 90% of the
    nodes' features, and in R^2 within 1e-3."""
    assert got.tree_.n_nodes == want.tree_.n_nodes
    agree = np.mean(got.tree_.feature == want.tree_.feature)
    assert agree >= 0.9, f"only {agree:.0%} of nodes agree (R4)"
    y = want.predict(X)
    assert abs(got.score(X, y) - want.score(X, y)) < 1e-3


TREE = dict(max_depth=6, max_bins=32)


@pytest.fixture(scope="module")
def jax_tree(data):
    X, y = data
    return _jax_streamed("DecisionTreeClassifier", X, y, 251, **TREE)


@pytest.fixture(scope="module")
def port_tree(data):
    X, y = data
    return DecisionTreeClassifier(device="cpu", **TREE).fit(X, y)


@pytest.mark.parametrize("n_devices", [None, 8, (4, 2)])
@pytest.mark.parametrize("chunk", [251, 3000])
def test_streamed_fit_identity_meshes(data, jax_tree, port_tree, n_devices,
                                      chunk):
    X, y = data
    clf = DecisionTreeClassifier(device="cpu", n_devices=n_devices,
                                 **TREE).fit(
        StreamedDataset.from_arrays(X, y, chunk_rows=chunk))
    _same_tree(clf.tree_, port_tree.tree_, "vs in-memory")
    _same_tree(clf.tree_, jax_tree.tree_, "vs JAX streamed")
    np.testing.assert_array_equal(clf.predict(X), jax_tree.predict(X))
    st = clf.ingest_stats_
    assert st["rows"] == st["rows_local"] == len(X) and st["sketch_exact"]
    assert st["chunk_rows"] == chunk and st["features"] == X.shape[1]
    assert stats_view(clf.fit_report_)["crown_depth"] == 1  # the tail replayed the stream


@pytest.mark.parametrize("engine", ["fused", "levelwise"])
@pytest.mark.parametrize("binning", ["auto", "quantile"])
def test_streamed_fit_identity_engines(data, engine, binning, monkeypatch):
    X, y = data
    monkeypatch.setenv("MPITREE_TPU_ENGINE", engine)
    kw = dict(max_depth=5, max_bins=32, binning=binning, device="cpu",
              n_devices=8)
    ref = DecisionTreeClassifier(**kw).fit(X, y)
    clf = DecisionTreeClassifier(**kw).fit(
        StreamedDataset.from_arrays(X, y, chunk_rows=777))
    _same_tree(clf.tree_, ref.tree_)
    assert stats_view(clf.fit_report_)["engine"] == engine


@pytest.mark.parametrize("n_devices", [None, 8])
def test_streamed_regressor_identity(data, yr, n_devices):
    """Equal to the port's in-memory fit field for field; to JAX's
    streamed fit by R4's contract (its device engine's float32 moments)."""
    X, _ = data
    kw = dict(max_depth=5, max_bins=32, refine_depth=None)
    ref = DecisionTreeRegressor(device="cpu", n_devices=n_devices,
                                **kw).fit(X, yr)
    reg = DecisionTreeRegressor(device="cpu", n_devices=n_devices, **kw).fit(
        dataset=StreamedDataset.from_arrays(X, yr, chunk_rows=499))
    _same_tree(reg.tree_, ref.tree_)
    np.testing.assert_array_equal(reg.predict(X), ref.predict(X))
    _r4(reg, _jax_streamed("DecisionTreeRegressor", X, yr, 499, **kw), X)


def test_streamed_leafwise_identity(data):
    X, y = data
    kw = dict(max_leaf_nodes=16, max_bins=32, device="cpu", n_devices=8)
    ref = DecisionTreeClassifier(**kw).fit(X, y)
    clf = DecisionTreeClassifier(**kw).fit(
        StreamedDataset.from_arrays(X, y, chunk_rows=640))
    _same_tree(clf.tree_, ref.tree_)
    want = _jax_streamed("DecisionTreeClassifier", X, y, 640,
                         max_leaf_nodes=16, max_bins=32)
    _same_tree(clf.tree_, want.tree_, "vs JAX streamed")


def test_streamed_sample_weight_identity(data):
    """Per-chunk integer weights flow into the same weighted build."""
    X, y = data
    w = np.random.default_rng(3).integers(1, 4, len(X)).astype(np.float32)
    kw = dict(max_depth=5, max_bins=32, device="cpu", n_devices=8)
    ref = DecisionTreeClassifier(**kw).fit(X, y, sample_weight=w)
    chunks = [(X[lo:lo + 500], y[lo:lo + 500], w[lo:lo + 500])
              for lo in range(0, len(X), 500)]
    clf = DecisionTreeClassifier(**kw).fit(
        StreamedDataset.from_chunks(chunks))
    _same_tree(clf.tree_, ref.tree_)
    # the same weights as the fit's argument instead
    arg = DecisionTreeClassifier(**kw).fit(
        StreamedDataset.from_arrays(X, y, chunk_rows=700), sample_weight=w)
    _same_tree(arg.tree_, ref.tree_)


def test_streamed_npy_shards_identity(data, port_tree, tmp_path):
    """Memory-mapped ``.npy`` shards of uneven sizes."""
    X, y = data
    cuts = [0, 700, 1701, 3000]
    xps, yps = [], []
    for i in range(3):
        xp, yp = tmp_path / f"x{i}.npy", tmp_path / f"y{i}.npy"
        np.save(xp, X[cuts[i]:cuts[i + 1]])
        np.save(yp, y[cuts[i]:cuts[i + 1]])
        xps.append(str(xp))
        yps.append(str(yp))
    clf = DecisionTreeClassifier(device="cpu", n_devices=8, **TREE).fit(
        StreamedDataset.from_npy(xps, yps, chunk_rows=311))
    _same_tree(clf.tree_, port_tree.tree_)


def test_streamed_generator_factory_and_spill(data, tmp_path, monkeypatch):
    """A factory streams; a bare generator needs the spill rung, and then
    fits the same tree from the replay, its ``ingest_spill`` decision
    recorded."""
    X, y = data

    def factory():
        for lo in range(0, len(X), 900):
            yield X[lo:lo + 900], y[lo:lo + 900]

    kw = dict(max_depth=4, max_bins=32, device="cpu", n_devices=8)
    clf = DecisionTreeClassifier(**kw).fit(
        StreamedDataset.from_chunks(factory))
    _same_tree(clf.tree_, DecisionTreeClassifier(**kw).fit(X, y).tree_)
    monkeypatch.delenv("MPITREE_TPU_SPILL_DIR", raising=False)
    with pytest.raises(ValueError, match="MPITREE_TPU_SPILL_DIR"):
        DecisionTreeClassifier(**kw).fit(
            StreamedDataset.from_chunks(factory()))
    monkeypatch.setenv("MPITREE_TPU_SPILL_DIR", str(tmp_path))
    spilled = DecisionTreeClassifier(**kw).fit(
        StreamedDataset.from_chunks(factory()))
    _same_tree(spilled.tree_, clf.tree_)
    assert spilled.ingest_stats_["spill_bytes"] > 0
    assert spilled.ingest_stats_["spill_chunks"] == 4
    assert list(tmp_path.iterdir()) == []  # the store closed
    # the rung is the JAX package's typed decision; a factory takes none
    dec = spilled.fit_report_["decisions"]["ingest_spill"]
    assert dec["value"] == "spill" and dec["inputs"]["cap_bytes"] > 0
    assert "ingest_spill" not in clf.fit_report_["decisions"]


REFINE = dict(max_depth=8, max_bins=16, refine_depth=3)


def test_streamed_refine_identity(data):
    """An explicit refine tail gathers its candidates' raw rows from one
    replay of the stream and commits the in-memory fit's subtrees."""
    X, y = data
    ref = DecisionTreeClassifier(device="cpu", n_devices=8, **REFINE).fit(
        X, y)
    clf = DecisionTreeClassifier(device="cpu", n_devices=8, **REFINE).fit(
        StreamedDataset.from_arrays(X, y, chunk_rows=251))
    _same_tree(clf.tree_, ref.tree_)
    assert stats_view(clf.fit_report_)["crown_depth"] == 3
    assert stats_view(clf.fit_report_)["refine_nodes_added"] > 0
    want = _jax_streamed("DecisionTreeClassifier", X, y, 251, **REFINE)
    _same_tree(clf.tree_, want.tree_, "vs JAX streamed")


def test_streamed_refine_per_subtree_identity(data, yr):
    """``splitter="random"`` routes the tail through the per-subtree
    engine: the stream-gathered block indexes identically."""
    X, _ = data
    kw = dict(splitter="random", random_state=5, device="cpu", n_devices=8,
              **REFINE)
    ref = DecisionTreeRegressor(**kw).fit(X, yr)
    reg = DecisionTreeRegressor(**kw).fit(
        StreamedDataset.from_arrays(X, yr, chunk_rows=777))
    _same_tree(reg.tree_, ref.tree_)
    assert stats_view(reg.fit_report_)["refine_engine"] == "per-subtree"


@pytest.mark.parametrize("n_devices", [8, (4, 2)])
def test_padded_extents(data, n_devices):
    """3,001 rows on 8 row blocks and 9 features on a feature axis of 2:
    the shards carry padding, every extent the builders read is real."""
    X, y = data
    X = np.concatenate([X, X[:1] + 0.5])
    y = np.concatenate([y, y[:1]])
    kw = dict(max_depth=6, max_bins=32, device="cpu", n_devices=n_devices,
              refine_depth=None)
    clf = DecisionTreeClassifier(**kw).fit(
        StreamedDataset.from_arrays(X, y, chunk_rows=1000))
    ref = DecisionTreeClassifier(**dict(kw, n_devices=None)).fit(X, y)
    _same_tree(clf.tree_, ref.tree_)
    assert clf.tree_.n_node_samples[0] == len(X)
    assert clf.n_features_in_ == X.shape[1]


def test_padded_extents_leafwise(data, yr):
    X, _ = data
    Xp, yp = X[:2999], yr[:2999]
    kw = dict(max_leaf_nodes=24, max_bins=32, device="cpu", n_devices=8)
    reg = DecisionTreeRegressor(**kw).fit(
        StreamedDataset.from_arrays(Xp, yp, chunk_rows=500))
    ref = DecisionTreeRegressor(**dict(kw, n_devices=None)).fit(Xp, yp)
    _same_tree(reg.tree_, ref.tree_)


def test_parallel_classifier_streamed(data, port_tree):
    X, y = data
    par = ParallelDecisionTreeClassifier(device="cpu", **TREE).fit(
        StreamedDataset.from_arrays(X, y, chunk_rows=600))
    assert stats_view(par.fit_report_)["n_shards"] == 8
    _same_tree(par.tree_, port_tree.tree_)


def test_streamed_fit_host_peak_pin():
    """A warm streamed fit's Python-side peak stays under the raw f32 +
    binned i32 bytes of the whole matrix: the matrix is never held whole
    on the host (``tests/test_ingest.py:322-347``)."""
    rng = np.random.default_rng(11)
    N, F = 60_000, 12
    X = rng.normal(size=(N, F)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=4096,
                                     sketch_capacity=1024)

    def fit():
        return DecisionTreeClassifier(max_depth=5, max_bins=32, device="cpu",
                                      n_devices=8).fit(ds)

    fit()  # warm
    tracemalloc.start()
    clf = fit()
    _, py_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert py_peak < N * F * 8
    assert clf.ingest_stats_["chunk_rows"] == 4096
    assert not clf.ingest_stats_["sketch_exact"]


def test_chunk_rows_from_the_host_budget(data, monkeypatch):
    from mpitree_tpu_torch.obs import memory

    X, y = data
    monkeypatch.setenv(memory.HOST_BUDGET_ENV, str(1 << 20))
    clf = DecisionTreeClassifier(max_depth=3, device="cpu").fit(
        StreamedDataset.from_arrays(X, y))
    assert clf.ingest_stats_["chunk_rows"] == memory.ingest_chunk_rows(9)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_streamed_dataset_arg_validation(data):
    X, y = data
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=1000)
    with pytest.raises(ValueError, match="not both"):
        DecisionTreeClassifier(device="cpu").fit(X, dataset=ds)
    with pytest.raises(TypeError, match="StreamedDataset"):
        DecisionTreeClassifier(device="cpu").fit(dataset=X)
    with pytest.raises(ValueError, match="no separate y"):
        DecisionTreeClassifier(device="cpu").fit(ds, y)
    with pytest.raises(ValueError, match="pick one"):
        DecisionTreeClassifier(device="cpu").fit(
            StreamedDataset.from_chunks([(X, y, np.ones(len(X)))]),
            sample_weight=np.ones(len(X)))
    with pytest.raises(ValueError, match="unknown regression criterion"):
        DecisionTreeRegressor(criterion="gini", device="cpu").fit(ds)


def test_streamed_fit_is_device_only(data):
    X, y = data
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=1000)
    with pytest.raises(ValueError, match="device engine only"):
        DecisionTreeClassifier(backend="host", device="cpu").fit(ds)
    if not torch.cuda.is_available():
        # no silent CPU fallback: device=None means the card
        with pytest.raises(RuntimeError, match="CUDA"):
            DecisionTreeClassifier().fit(ds)
