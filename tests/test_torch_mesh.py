"""The port's data mesh (``parallel/mesh.py``, ``partition.py``, the
reductions of ``collective.py`` and the global route of ``ops/hist_kernel``)
against the JAX package's, on the CPU.

``resolve_mesh``'s grammar and errors, the padding contract and the
partition table's verdict on the data axis equal the JAX package's; the
port's CPU shard count (``mesh.set_cpu_shards``) stands where the JAX tests
force 8 virtual devices (``tests/conftest.py``). The histogram route and
the fixed-point exponents of a sharded fit are those of one shard holding
every row, a payload maximum that lies in one shard only included.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu.parallel import collective as jax_collective  # noqa: E402
from mpitree_tpu.parallel import mesh as jax_mesh  # noqa: E402
from mpitree_tpu.parallel import partition as jax_partition  # noqa: E402

from mpitree_tpu_torch.core.builder import BuildConfig, FitInputs  # noqa: E402
from mpitree_tpu_torch.ops import hist_kernel  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_for_engine  # noqa: E402
from mpitree_tpu_torch.parallel import collective, distributed  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as M  # noqa: E402
from mpitree_tpu_torch.parallel import partition  # noqa: E402
from mpitree_tpu_torch.utils import profiling  # noqa: E402
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

CPU = torch.device("cpu")


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


def _mesh(n):
    return M.resolve_mesh(device="cpu", n_devices=n)


@pytest.mark.parametrize("n_devices", [None, 1, "all", -1, 2, 3, 8, (2, 1),
                                       (8, 1)])
def test_resolve_mesh_grammar_equals_jax(n_devices):
    ref = jax_mesh.resolve_mesh(n_devices=n_devices)
    got = _mesh(n_devices)
    assert M.data_shards(got) == jax_mesh.data_shards(ref) == got.size
    assert M.feature_shards(got) == jax_mesh.feature_shards(ref) == 1
    assert got.n_procs == 1 and got.group is None and got.rank == 0
    assert all(d == CPU for d in got.devices)


@pytest.mark.parametrize("n_devices", [0, -2, 9, 100, (9, 1), (0, 1)])
def test_resolve_mesh_errors_equal_jax(n_devices):
    with pytest.raises(ValueError):
        jax_mesh.resolve_mesh(n_devices=n_devices)
    with pytest.raises(ValueError, match="n_devices"):
        _mesh(n_devices)


@pytest.mark.parametrize("n_devices", [(2, 2), (4, 2), (1, 8), (2, 4)])
def test_two_d_mesh_is_refused_naming_its_item(n_devices):
    """The JAX package builds a (data, feature) mesh here; the port refuses
    it until item 14d."""
    assert jax_mesh.feature_shards(jax_mesh.resolve_mesh(
        n_devices=n_devices)) > 1
    with pytest.raises(NotImplementedError, match="item 14d"):
        _mesh(n_devices)


def test_cpu_shard_count_and_cuda_without_card():
    assert M.cpu_shards() == 8
    assert M.set_cpu_shards(3) == 8
    assert _mesh("all").size == 3
    assert M.set_cpu_shards(8) == 3
    with pytest.raises(ValueError, match=">= 1"):
        M.set_cpu_shards(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            M.resolve_mesh(device=None, n_devices="all")


def test_process_info_and_single_process_initialize():
    """No coordinator and one process: ``initialize`` joins nothing, and
    the rank view is the JAX package's keys for this process alone."""
    distributed.initialize()
    distributed.initialize(None, 1, 0)
    import torch.distributed as dist

    assert not dist.is_initialized()
    info = distributed.process_info(device="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 8, "global_devices": 8}
    from mpitree_tpu.parallel import distributed as jax_distributed

    assert set(jax_distributed.process_info()) == set(info)


@pytest.mark.parametrize("n", [0, 1, 5, 7, 8, 9, 103, 160])
def test_pad_rows_equals_jax(n):
    for shards in range(1, 9):
        assert M.pad_rows(n, shards) == jax_mesh.pad_rows(n, shards)


@pytest.mark.parametrize("n,shards,stacked,with_xb", [
    (103, 8, False, True), (103, 8, True, True), (96, 8, False, True),
    (5, 8, False, False), (17, 3, True, False), (1, 2, False, True),
])
def test_pad_row_arrays_equals_jax(n, shards, stacked, with_xb):
    rng = np.random.default_rng(n)
    xb = rng.integers(0, 255, (n, 6)).astype(np.int32) if with_xb else None
    y = rng.integers(0, 3, n).astype(np.int64)
    w = rng.uniform(0.5, 2, (4, n) if stacked else n).astype(np.float32)
    nid = np.zeros(n, np.int32)
    want = jax_mesh.pad_row_arrays(xb, y, w, nid, shards)
    got = M.pad_row_arrays(xb, y, w, nid, shards)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if with_xb:  # a tensor pads on its device to the same bits
        t = M.pad_row_arrays(torch.from_numpy(xb), y, w, nid, shards)[0]
        np.testing.assert_array_equal(t.numpy(), want[0])


# every build-state name tests/test_partition.py:22 covers, and the rest of
# the JAX table's patterns
NAMES = ("x_binned", "y", "weight", "sample_weight", "node_id", "nid0",
         "cand_mask", "cand_masks", "parent_hist", "hist_keep", "is_small",
         "parent_slot", "node_mask", "draws", "mono_cst", "mono_lo",
         "mono_hi", "is_split", "feat", "bin", "left_id", "right_id",
         "x_rows", "raw_margin", "pair_hist", "tree_weights",
         "tree_node_id", "tree_keys", "counts", "decision", "debug_fp",
         "grad_tot", "chunk_lo")


@pytest.mark.parametrize("name", NAMES)
def test_partition_verdict_equals_jax_data_axis(name):
    spec = jax_partition.match_partition_rules(name)
    want = partition.ROW if jax_mesh.DATA_AXIS in tuple(spec) \
        else partition.REPLICATED
    assert partition.match_partition_rules(name) == want
    assert partition.match_partition_rules(name, ndim=0) == \
        partition.REPLICATED


def test_place_shards_rows_with_the_padding_contract():
    """103 rows over 8 shards: the shards' rows in order are JAX's padded
    arrays; replicated values are whole on every shard."""
    rng = np.random.default_rng(3)
    xb = rng.integers(0, 64, (103, 5)).astype(np.int32)
    y = rng.integers(0, 4, 103)
    w = np.ones(103, np.float32)
    mesh = _mesh(8)
    nid = np.zeros(103, np.int32)
    xbp, yp, wp, nidp = M.pad_row_arrays(torch.from_numpy(xb), y, w, nid, 8)
    parts = partition.place(mesh, {
        "x_binned": xbp, "y": yp, "weight": wp, "node_id": nidp,
        "cand_mask": torch.ones(5, 64, dtype=torch.bool)})
    want = jax_mesh.pad_row_arrays(xb, y, w, nid, 8)
    assert len(parts) == 8 and all(len(p["y"]) == 13 for p in parts)
    for i, key in enumerate(("x_binned", "y", "weight", "node_id")):
        got = np.concatenate([np.asarray(p[key]) for p in parts])
        np.testing.assert_array_equal(got, want[i], err_msg=key)
    assert all(p["cand_mask"].shape == (5, 64) for p in parts)
    with pytest.raises(ValueError, match=r"\[103\] rows for 8 shards"):
        partition.place(mesh, {"y": y})


def _fit(binned, y, task, mesh, w=None):
    cfg = (BuildConfig(task="regression", criterion="mse", max_depth=4)
           if task == "regression" else BuildConfig(max_depth=4))
    return FitInputs(binned, y, cfg, n_classes=None if task == "regression"
                     else int(y.max()) + 1, sample_weight=w, mesh=mesh)


@pytest.mark.parametrize("case", ["classes", "fractional_in_one_shard",
                                  "moments", "max_in_one_shard"])
def test_global_route_and_exponents_equal_one_shard(case):
    """The route and exponents at 8 shards are one shard's: maxima by MAX,
    the integer flag by MIN, the sums by SUM, and the global row count;
    where one shard alone would choose others, it does not."""
    if case in ("classes", "fractional_in_one_shard"):
        X, y = covtype_like(1_000, seed=1)
        task = "classification"
    else:
        X, y = california_like(1_000, seed=1)
        y = (y - y.mean()).astype(np.float32)
        task = "regression"
        if case == "max_in_one_shard":
            y[7] = 1_000.0  # shard 0 of 8 holds rows 0..124
    w = None
    if case == "fractional_in_one_shard":
        w = np.ones(len(y), np.float32)
        w[999] = 0.5  # the last shard's only fractional weight
    binned = bin_for_engine(X, max_bins=64, binning="auto", device=CPU)
    one = _fit(binned, y, task, None, w)
    eight = _fit(binned, y, task, _mesh(8), w)
    assert eight.scale_exp == one.scale_exp
    assert eight.N == one.N and eight.K == one.K and eight.U == one.U
    assert (one.scale_exp is None) == (case == "classes")
    assert len(eight.shards) == 8
    if case in ("fractional_in_one_shard", "max_in_one_shard"):
        # a shard without the odd row decides otherwise on its own rows
        alone = collective.payload_scale(
            [eight.shards[3].payload], None, fixed=task == "regression",
            n_rows=one.N)
        assert alone != one.scale_exp


def test_global_route_raises_on_non_finite():
    X, y = california_like(200, seed=0)
    y = y.astype(np.float32)
    y[150] = np.inf
    binned = bin_for_engine(X, max_bins=32, binning="auto", device=CPU)
    with pytest.raises(ValueError, match="NaN or infinity"):
        _fit(binned, y, "regression", _mesh(8))


def test_psum_folds_shards_and_counts():
    mesh = _mesh(4)
    parts = [torch.tensor([1.0, -2.0, 3.0]) * (i + 1) for i in range(4)]
    assert torch.equal(collective.psum([p.clone() for p in parts], mesh),
                       torch.tensor([10.0, -20.0, 30.0]))
    assert torch.equal(collective.psum([p.clone() for p in parts], mesh,
                                       "min"), torch.tensor([1.0, -8.0, 3.0]))
    assert torch.equal(collective.psum([p.clone() for p in parts], mesh,
                                       "max"), torch.tensor([4.0, -2.0, 12.0]))
    assert mesh.stats["allreduce_calls"] == 3
    assert mesh.stats["allreduce_bytes"] == 3 * 12
    one = parts[0]
    assert collective.psum([one], None) is one
    assert collective.psum([one], _mesh(1)) is one
    with pytest.raises(ValueError, match="parts"):
        collective.psum(parts[:3], mesh)
    with pytest.raises(ValueError, match="unknown reduction"):
        collective.psum(parts, mesh, "prod")
    assert [t.device for t in collective.to_shards(one, mesh)] == [CPU] * 4


def test_psum_bytes_equal_jax():
    for kw in (dict(n_slots=2048, n_features=54, n_bins=256, n_channels=7),
               dict(n_slots=1, n_features=8, n_bins=64, n_channels=3,
                    itemsize=8)):
        assert collective.split_psum_bytes(**kw) == \
            jax_collective.split_psum_bytes(**kw)
    for kw in (dict(n_slots=512, n_channels=7),
               dict(n_slots=3, n_channels=3, itemsize=8)):
        assert collective.counts_psum_bytes(**kw) == \
            jax_collective.counts_psum_bytes(**kw)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_node_sums_and_y_range_reduce_to_the_one_shard_values(shards):
    """Terminal sums (int64 before the scale) and regression's purity
    range (MIN of minima, MAX of maxima, weight-0 and padding rows left
    out) over the shards equal the one-shard values bit for bit."""
    rng = np.random.default_rng(shards)
    n = 301
    nid = torch.from_numpy(rng.integers(-1, 9, n).astype(np.int32))
    y = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 2, n).astype(np.float32))
    w[rng.random(n) < 0.2] = 0.0
    payload = torch.stack([w, w * y, w * y * y], dim=1)
    exp = hist_kernel.fixed_point_exponents(payload)
    q = hist_kernel.quantize(payload, exp)
    cut = np.linspace(0, n, shards + 1).astype(int)

    def split(t):
        return [t[a:b] for a, b in zip(cut[:-1], cut[1:])]

    mesh = _mesh(shards)
    want = collective.node_sums(q, nid, 2, n_slots=5, scale_exp=exp)
    got = collective.node_sums(split(q), split(nid), 2, n_slots=5,
                               scale_exp=exp, mesh=mesh)
    assert torch.equal(got, want)
    want = collective.y_range(y, nid, w, 1, n_slots=7)
    got = collective.y_range(split(y), split(nid), split(w), 1, n_slots=7,
                             mesh=mesh)
    assert torch.equal(got, want)
    assert mesh.stats["allreduce_calls"] == 2


def test_fit_reduction_bytes_are_the_psum_payloads():
    """A depth-1 fit at 8 shards reduces the route's statistics, one S = 1
    histogram and one terminal table, each counted at its logical
    bytes."""
    X, y = covtype_like(500, seed=2)
    binned = bin_for_engine(X, max_bins=32, binning="auto", device=CPU)
    from mpitree_tpu_torch.core.builder import build_tree

    mesh = _mesh(8)
    cfg = BuildConfig(max_depth=1, engine="levelwise")
    build_tree(binned, y, config=cfg, n_classes=7, mesh=mesh)
    F, B, C = binned.n_features, binned.n_bins, 7
    U = 2  # the table width of a depth-1 tree
    want = (C * 8 + 2 * C * 8
            + collective.split_psum_bytes(n_slots=1, n_features=F,
                                          n_bins=B, n_channels=C)
            + collective.counts_psum_bytes(n_slots=U, n_channels=C,
                                           itemsize=8))
    assert mesh.stats["allreduce_calls"] == 4
    assert mesh.stats["allreduce_bytes"] == want
    assert mesh.stats["replication_checks"] == 0


def test_replication_fingerprint_and_check_without_group():
    a = torch.tensor([[1.0, 2.0], [3.0, float("inf")]], dtype=torch.float64)
    b = a.clone()
    b[1, 0] = np.nextafter(3.0, 4.0)
    fa = profiling.replication_fingerprint(a)
    assert int(fa) == int(profiling.replication_fingerprint(a.clone()))
    assert int(fa) != int(profiling.replication_fingerprint(b))
    assert 0 <= int(fa) < 2 ** 62
    mesh = _mesh(8)
    profiling.assert_replicated(a, mesh)  # local shards share one sweep
    profiling.assert_replicated(a, None)
    assert mesh.stats["replication_checks"] == 0


def test_debug_knob_reads_as_jax(monkeypatch):
    for raw, want in (("", False), ("0", False), ("1", True),
                      ("yes", True)):
        monkeypatch.setenv(profiling.DEBUG_ENV, raw)
        assert profiling.debug_checks_enabled() is want
    monkeypatch.delenv(profiling.DEBUG_ENV)
    assert profiling.debug_checks_enabled() is False


@pytest.mark.parametrize("what,item", [
    ("forest", "item 14b"), ("extra_trees", "item 14b"),
    ("boosting", "item 14c"), ("leafwise", "item 14c"),
    ("leafwise_build", "item 14c"), ("pair_split_stats", "item 14c"),
])
def test_what_stays_refused_on_a_mesh_names_its_item(what, item):
    """Forests, boosting and leaf-wise growth on a mesh wait for the later
    parts of item 14; each refusal names its sub-item."""
    import mpitree_tpu_torch as P
    from mpitree_tpu_torch.core.builder import build_tree

    X, y = covtype_like(200, seed=0)
    with pytest.raises(NotImplementedError, match=item):
        if what == "forest":
            P.RandomForestClassifier(n_estimators=2, n_devices=2,
                                     device="cpu").fit(X, y)
        elif what == "extra_trees":
            P.ExtraTreesRegressor(n_estimators=2, n_devices="all",
                                  device="cpu").fit(X, y.astype(float))
        elif what == "boosting":
            P.GradientBoostingClassifier(max_iter=2, n_devices=2,
                                         device="cpu").fit(X, y)
        elif what == "leafwise":
            P.DecisionTreeClassifier(max_leaf_nodes=8, n_devices=2,
                                     device="cpu").fit(X, y)
        else:
            binned = bin_for_engine(X, max_bins=32, binning="auto",
                                    device=CPU)
            if what == "leafwise_build":
                build_tree(binned, y, config=BuildConfig(max_leaf_nodes=8),
                           n_classes=7, mesh=_mesh(2))
            else:
                collective.pair_split_stats(
                    binned.x_binned, None, None, None, None, None, None,
                    n_bins=32, criterion="entropy", min_child_weight=0.0,
                    scale_exp=None, task="classification", y=None,
                    mesh=_mesh(2))
