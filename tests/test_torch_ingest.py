"""The port's streaming ingest against the JAX package's
(``tests/test_ingest.py``'s sketch, chunk-source and sizing half).

- the sketch edges from chunk-merged ``SketchSet``s equal the JAX
  package's ``SketchSet`` and the port's ``bin_dataset`` bit for bit, in
  every binning mode and chunking, and the chunks' bins equal
  ``bin_dataset``'s; merges are associative; past the capacity the
  compacted sketch equals JAX's bit for bit;
- every chunk source yields what the JAX package's yields, the spill
  store round-trips (manifest last, cap enforced), ``shard_for_process``
  and ``ingest_chunk_rows`` equal JAX's;
- the placement (``ingest/place.assemble_binned``) fills each CPU shard
  with its block of ``bin_dataset``'s matrix, zeros in the padding, and
  refuses a stream that does not cover its blocks; ``gather_matrix``
  gives the matrix back whole, ``check_placed`` refuses another mesh;
- the refusals: an empty stream, a NaN chunk, mixed weighted and
  unweighted chunks, a one-shot source with no spill directory, a width
  change.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu.ingest import chunks as jax_chunks  # noqa: E402
from mpitree_tpu.ingest import sketch as jax_sketch  # noqa: E402
from mpitree_tpu.ingest import spill as jax_spill  # noqa: E402
from mpitree_tpu.obs import memory as jax_memory  # noqa: E402

from mpitree_tpu_torch import DecisionTreeClassifier  # noqa: E402
from mpitree_tpu_torch.ingest import (  # noqa: E402
    ArrayChunks,
    FeatureSketch,
    IterChunks,
    NpyShards,
    NpzShards,
    SketchSet,
    StreamedDataset,
    ingest_dataset,
    shard_for_process,
)
from mpitree_tpu_torch.ingest import place, spill  # noqa: E402
from mpitree_tpu_torch.ingest import sketch as port_sketch  # noqa: E402
from mpitree_tpu_torch.obs import memory  # noqa: E402
from mpitree_tpu_torch.ops.binning import (  # noqa: E402
    bin_dataset,
    bin_with_thresholds,
)
from mpitree_tpu_torch.parallel import mesh as M  # noqa: E402


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
    """``tests/test_ingest.py``'s data: 3,000 x 9 with a low-cardinality,
    a constant and a three-valued feature."""
    rng = np.random.default_rng(7)
    N, F = 3000, 9
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[:, 2] = np.round(X[:, 2], 1)
    X[:, 4] = -1.5
    X[:, 6] = rng.integers(0, 3, N)
    y = ((X[:, 0] > 0).astype(int) + (X[:, 1] + X[:, 2] > 0.3)).astype(int)
    return X, y


def _chunked(mod, X, chunk, **kw):
    sk = mod.SketchSet(X.shape[1], **kw)
    for lo in range(0, len(X), chunk):
        sk.update(X[lo:lo + chunk])
    return sk


# ---------------------------------------------------------------------------
# sketch and edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("binning", ["auto", "quantile", "exact"])
@pytest.mark.parametrize("chunk", [1, 37, 1000, 5000])
def test_sketch_edges_bit_identical(data, binning, chunk):
    """Edges of chunk-merged sketches == JAX's sketch's == the port's
    ``bin_dataset``'s, and the chunks' bins == ``bin_dataset``'s."""
    X, _ = data
    ref = bin_dataset(X, max_bins=32, binning=binning)
    got = _chunked(port_sketch, X, chunk)
    thr, n_cand, n_bins, quantized = got.to_thresholds(
        max_bins=32, binning=binning)
    want = _chunked(jax_sketch, X, chunk).to_thresholds(
        max_bins=32, binning=binning)
    for a, b in zip((thr, n_cand, n_bins, quantized), want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(thr, ref.thresholds)
    np.testing.assert_array_equal(n_cand, ref.n_cand)
    assert n_bins == ref.n_bins and quantized == ref.quantized
    xb = np.concatenate([
        bin_with_thresholds(X[lo:lo + chunk], thr, n_cand)
        for lo in range(0, len(X), chunk)
    ])
    np.testing.assert_array_equal(xb, ref.x_binned)


def test_sketch_merge_associative(data):
    """Two half-stream banks merged == one full-stream bank."""
    X, _ = data
    full = SketchSet(X.shape[1])
    full.update(X)
    a, b = SketchSet(X.shape[1]), SketchSet(X.shape[1])
    a.update(X[: len(X) // 2])
    b.update(X[len(X) // 2:])
    a.merge(b)
    for s1, s2 in zip(full.sketches, a.sketches):
        np.testing.assert_array_equal(s1.values, s2.values)
        np.testing.assert_array_equal(s1.counts, s2.counts)
    assert a.n_rows == full.n_rows and a.nbytes() == full.nbytes()


def test_sketch_compaction_equals_jax():
    """Past capacity: the compacted summary, its edges and the refusal of
    exact mode are JAX's bit for bit; weight is kept and every edge is a
    real data value."""
    col = np.arange(5000, dtype=np.float32)
    mine, theirs = FeatureSketch(capacity=32), jax_sketch.FeatureSketch(
        capacity=32)
    for lo in range(0, 5000, 500):
        mine.update(col[lo:lo + 500])
        theirs.update(col[lo:lo + 500])
    assert not mine.exact and mine.n == 5000 and mine.n_unique <= 32
    np.testing.assert_array_equal(mine.values, theirs.values)
    np.testing.assert_array_equal(mine.counts, theirs.counts)
    edges, quantized = mine.edges(max_bins=8, binning="auto")
    np.testing.assert_array_equal(
        edges, theirs.edges(max_bins=8, binning="auto")[0])
    assert quantized and (np.diff(edges) > 0).all()
    assert np.isin(edges, col).all()
    with pytest.raises(ValueError, match="sketch capacity"):
        mine.edges(max_bins=8, binning="exact")


@pytest.mark.parametrize("capacity", [2, 16, 100])
def test_compacted_set_thresholds_equal_jax(data, capacity):
    X, _ = data
    got = _chunked(port_sketch, X, 333, capacity=capacity)
    want = _chunked(jax_sketch, X, 333, capacity=capacity)
    assert got.exact == want.exact
    for a, b in zip(got.to_thresholds(max_bins=16, binning="auto"),
                    want.to_thresholds(max_bins=16, binning="auto")):
        np.testing.assert_array_equal(a, b)


def test_sketch_capacity_knob(monkeypatch):
    resolve_capacity = port_sketch.resolve_capacity
    monkeypatch.setenv("MPITREE_TPU_SKETCH_CAPACITY", "64")
    assert resolve_capacity() == jax_sketch.resolve_capacity() == 64
    assert resolve_capacity(1) == jax_sketch.resolve_capacity(1) == 2
    monkeypatch.setenv("MPITREE_TPU_SKETCH_CAPACITY", "many")
    assert resolve_capacity() == jax_sketch.resolve_capacity() == 1 << 20


# ---------------------------------------------------------------------------
# chunk sources, spill, sizing
# ---------------------------------------------------------------------------

def _same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _npy_shards(tmp_path, X, y, cuts):
    xps, yps = [], []
    for i in range(len(cuts) - 1):
        xp, yp = tmp_path / f"x{i}.npy", tmp_path / f"y{i}.npy"
        np.save(xp, X[cuts[i]:cuts[i + 1]])
        np.save(yp, y[cuts[i]:cuts[i + 1]])
        xps.append(str(xp))
        yps.append(str(yp))
    return xps, yps


def test_every_chunk_source_yields_what_jax_yields(data, tmp_path):
    X, y = data
    w = np.arange(len(X), dtype=np.float32) % 3 + 1
    _same_stream(ArrayChunks(X, y, w).chunks(311),
                 jax_chunks.ArrayChunks(X, y, w).chunks(311))
    xps, yps = _npy_shards(tmp_path, X, y, [0, 700, 1701, 3000])
    src = NpyShards(xps, yps)
    assert src.n_rows == len(X) and src.n_features == X.shape[1]
    _same_stream(src.chunks(311), jax_chunks.NpyShards(xps, yps).chunks(311))
    _same_stream(NpyShards(str(tmp_path / "x*.npy"),
                           str(tmp_path / "y*.npy")).chunks(500),
                 jax_chunks.NpyShards(xps, yps).chunks(500))
    zps = []
    for i, lo in enumerate(range(0, len(X), 1000)):
        zp = tmp_path / f"s{i}.npz"
        np.savez(zp, X=X[lo:lo + 1000], y=y[lo:lo + 1000])
        zps.append(str(zp))
    assert NpzShards(zps).n_features == X.shape[1]
    _same_stream(NpzShards(zps).chunks(), jax_chunks.NpzShards(zps).chunks())
    items = [(X[lo:lo + 900], y[lo:lo + 900]) for lo in range(0, 3000, 900)]
    _same_stream(IterChunks(items).chunks(), jax_chunks.IterChunks(
        items).chunks())
    src = IterChunks(lambda: iter(items))
    _same_stream(src.chunks(), src.chunks())  # a factory repeats
    one = IterChunks(iter(items))
    assert one.one_shot
    list(one.chunks())
    with pytest.raises(RuntimeError, match="already consumed"):
        list(one.chunks())
    with pytest.raises(TypeError, match="factory"):
        IterChunks(3)
    with pytest.raises(ValueError, match="pair up"):
        NpyShards(xps, yps[:2])


@pytest.mark.parametrize("bad", ["shape", "y", "w", "item"])
def test_normalize_checks(data, bad):
    X, y = data
    item = {"shape": (X[0], y[:1]), "y": (X[:5], y[:4]),
            "w": (X[:5], y[:5], np.ones(4)), "item": X[:5]}[bad]
    err = TypeError if bad == "item" else ValueError
    with pytest.raises(err):
        list(IterChunks([item]).chunks())


def test_shard_for_process_equals_jax():
    items = list(range(10))
    for k in (1, 2, 3, 4, 7):
        dealt = [shard_for_process(items, p, k) for p in range(k)]
        assert dealt == [jax_chunks.shard_for_process(items, p, k)
                         for p in range(k)]
        assert sum(dealt, []) == items
    # no process group: this process is 0 of 1 and reads everything
    assert shard_for_process(items) == items


def test_spill_round_trip(data, tmp_path):
    """Chunks land atomically, the manifest is written last, replay
    refuses an uncommitted store, the cap raises, ``close`` cleans up."""
    X, y = data
    items = [(X[lo:lo + 700], y[lo:lo + 700]) for lo in range(0, 3000, 700)]
    store = spill.SpillStore(str(tmp_path / "s"))
    tee = spill.SpillTee(IterChunks(iter(items)), store)
    with pytest.raises(RuntimeError, match="no manifest"):
        list(store.chunks())
    first = list(tee.chunks())
    assert store.committed and store.rows == len(X)
    _same_stream(tee.chunks(), first)  # the replay reads the disk
    _same_stream(tee.chunks(), [(a, b, None) for a, b in items])
    store.close()
    assert not (tmp_path / "s").exists()
    tiny = spill.SpillStore(str(tmp_path / "t"), cap_bytes=1000)
    with pytest.raises(RuntimeError, match="MPITREE_TPU_SPILL_BYTES"):
        tiny.append(X[:500], y[:500], None)
    # the JAX package's store replays the port's spill (same layout)
    store = spill.SpillStore(str(tmp_path / "u"))
    for a, b in items:
        store.append(np.ascontiguousarray(a), b, None)
    store.commit()
    theirs = jax_spill.SpillStore(str(tmp_path / "u"))
    _same_stream(store.chunks(), theirs.chunks())


def test_one_shot_without_spill_dir_refused(data, monkeypatch):
    X, y = data
    monkeypatch.delenv("MPITREE_TPU_SPILL_DIR", raising=False)
    with pytest.raises(ValueError, match="MPITREE_TPU_SPILL_DIR"):
        spill.resolve_spill(IterChunks(iter([(X, y)])))
    src = ArrayChunks(X, y)
    assert spill.resolve_spill(src) == (src, None)


@pytest.mark.parametrize("features,budget", [
    (1, None), (16, 4 << 20), (54, None), (100_000, 1 << 20),
    (12, 123_456_789)])
def test_ingest_chunk_rows_equals_jax(monkeypatch, features, budget):
    if budget is None:
        monkeypatch.delenv(memory.HOST_BUDGET_ENV, raising=False)
    else:
        monkeypatch.setenv(memory.HOST_BUDGET_ENV, str(budget))
    rows = memory.ingest_chunk_rows(features)
    assert rows == jax_memory.ingest_chunk_rows(features)
    assert memory.ingest_row_bytes(features) == \
        jax_memory.ingest_row_bytes(features)
    assert memory.sketch_budget_bytes(features, 1 << 20) == \
        jax_memory.sketch_budget_bytes(features, 1 << 20)
    assert memory.host_ingest_budget() == jax_memory.host_ingest_budget()
    assert memory.host_rss_bytes() > 0


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [None, 8, (4, 2), (2, 4)])
@pytest.mark.parametrize("n,chunk", [(3000, 251), (3001, 3001), (3003, 40)])
def test_assemble_binned_fills_each_shard_with_its_block(data, n_devices, n,
                                                         chunk):
    """Each CPU shard holds its row and column block of ``bin_dataset``'s
    matrix, padded with zeros; the real extents stay the dataclass's."""
    X, y = data
    X = np.concatenate([X, X[:3]])[:n]
    y = np.concatenate([y, y[:3]])[:n]
    mesh = M.resolve_mesh(device="cpu", n_devices=n_devices)
    res = ingest_dataset(StreamedDataset.from_arrays(X, y, chunk_rows=chunk),
                         mesh=mesh, max_bins=32)
    b = res.binned
    ref = bin_dataset(X, max_bins=32)
    assert (b.n_samples, b.n_features) == X.shape
    np.testing.assert_array_equal(b.thresholds, ref.thresholds)
    dr, df = M.data_shards(mesh), M.feature_shards(mesh)
    assert b.rows_pad == n + (-n) % dr and b.feat_pad == 9 + (-9) % df
    full = np.zeros((b.rows_pad, b.feat_pad), np.int32)
    full[:n, :9] = ref.x_binned
    sr, sc = b.rows_pad // dr, b.feat_pad // df
    for (di, fi), shard in zip(place.shard_blocks(mesh), b.x_binned):
        assert shard.dtype == torch.int32
        np.testing.assert_array_equal(
            shard.numpy(), full[di * sr:(di + 1) * sr, fi * sc:(fi + 1) * sc])
    np.testing.assert_array_equal(place.gather_matrix(b, mesh).numpy(),
                                  ref.x_binned)
    M.check_placed(b, mesh)
    np.testing.assert_array_equal(res.y, y)
    assert res.stats["rows"] == n and res.stats["chunk_rows"] == chunk


def test_one_device_stream_is_one_plain_matrix(data):
    X, y = data
    mesh = M.resolve_mesh(device="cpu")
    b = ingest_dataset(StreamedDataset.from_arrays(X, y, chunk_rows=999),
                       mesh=mesh, max_bins=32).binned
    np.testing.assert_array_equal(b.single().x_binned.numpy(),
                                  bin_dataset(X, max_bins=32).x_binned)
    eight = ingest_dataset(StreamedDataset.from_arrays(X, y), max_bins=32,
                           mesh=M.resolve_mesh(device="cpu", n_devices=8))
    with pytest.raises(ValueError, match="not one device's matrix"):
        eight.binned.single()


def test_placement_checked_against_the_build_mesh(data):
    X, y = data
    b = ingest_dataset(StreamedDataset.from_arrays(X[:3001], y[:3001]),
                       mesh=M.resolve_mesh(device="cpu", n_devices=8),
                       max_bins=32).binned
    for other in (4, (4, 2)):
        with pytest.raises(ValueError, match="must use the same mesh"):
            M.check_placed(b, M.resolve_mesh(device="cpu", n_devices=other))


def test_uncovered_row_blocks_refused(data):
    """A stream that starts at the wrong global row leaves a local block
    short: the assembly raises instead of dropping rows."""
    X, _ = data
    mesh = M.resolve_mesh(device="cpu", n_devices=8)
    ref = bin_dataset(X, max_bins=32)
    chunks = [ref.x_binned[lo:lo + 500] for lo in range(0, 2000, 500)]
    with pytest.raises(ValueError, match="row block"):
        place.assemble_binned(mesh, iter(chunks), n_rows=3000,
                              n_features=9)
    with pytest.raises(ValueError, match="features"):
        place.assemble_binned(mesh, iter([ref.x_binned[:, :4]]),
                              n_rows=3000, n_features=9)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_empty_stream_refused():
    with pytest.raises(ValueError, match="empty chunk stream"):
        DecisionTreeClassifier(device="cpu").fit(
            StreamedDataset.from_chunks([]))


def test_nan_chunk_refused(data):
    X, y = data
    Xn = X[:64].copy()
    Xn[3, 1] = np.nan
    with pytest.raises(ValueError, match="finite"):
        DecisionTreeClassifier(device="cpu").fit(
            StreamedDataset.from_chunks([(Xn, y[:64])]))


def test_mixed_weighted_chunks_refused(data):
    X, y = data
    chunks = [(X[:100], y[:100], np.ones(100)), (X[100:200], y[100:200])]
    with pytest.raises(ValueError, match="mixes weighted and unweighted"):
        DecisionTreeClassifier(device="cpu").fit(
            StreamedDataset.from_chunks(chunks))


def test_one_shot_fit_without_spill_refused(data, monkeypatch):
    X, y = data
    monkeypatch.delenv("MPITREE_TPU_SPILL_DIR", raising=False)
    gen = ((X[lo:lo + 500], y[lo:lo + 500]) for lo in range(0, 3000, 500))
    with pytest.raises(ValueError, match="MPITREE_TPU_SPILL_DIR"):
        DecisionTreeClassifier(device="cpu").fit(
            StreamedDataset.from_chunks(gen))


def test_width_change_refused(data):
    X, y = data
    chunks = [(X[:100], y[:100]), (X[100:200, :5], y[100:200])]
    with pytest.raises(ValueError, match="stream started with 9"):
        DecisionTreeClassifier(device="cpu").fit(
            StreamedDataset.from_chunks(chunks))


def test_source_without_chunks_refused():
    with pytest.raises(TypeError, match="must implement .chunks"):
        StreamedDataset(object())
