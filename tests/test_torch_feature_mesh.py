"""The 2-D ``(data, feature)`` mesh against the JAX package's: a port of
``tests/test_feature_mesh.py`` and ``tests/test_partition.py:149``.

The determinism contract extends to the second axis: on 8 CPU shards
(``mesh.set_cpu_shards(8)``) the fitted tree is the same for the shapes
(8, 1), (4, 2), (2, 4) and (1, 8), in both device engines with sibling
subtraction on and off, for classification, regression and the boosting
rounds, and equals the one-device tree and the JAX package's. Each shard
sweeps its feature slab, the slabs' winners merge by
``collective.select_global`` (first minimum over the blocks, so the
lowest feature wins a tie) and the rows route by the owner broadcast
(``collective.route_psum``). Feature padding is inert; monotone
constraints, per-node sampling, leaf-wise growth and the fused rounds
raise there, as JAX's do. The shape policy (``data_feature_shape``,
``resolve_mesh_2d``) and the grid (``partition.layout``) are JAX's. Two
gloo processes fit on (1, 2), (1, 4) and (2, 2) meshes.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch
from _torch_twoproc import run_procs

pytest.importorskip("jax")

from mpitree_tpu.parallel import mesh as jax_mesh  # noqa: E402
from mpitree_tpu.parallel import partition as jax_partition  # noqa: E402

from mpitree_tpu_torch.core.builder import BuildConfig, build_tree  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.ops import impurity as imp_ops  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_for_engine  # noqa: E402
from mpitree_tpu_torch.parallel import collective  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as M  # noqa: E402
from mpitree_tpu_torch.parallel import partition  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    GradientBoostingClassifier,
)
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
MESH_SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
CPU = torch.device("cpu")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _same_tree(got, want, what=""):
    assert got.n_nodes == want.n_nodes, what
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


def _data(seed=0, n=300, f=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] > 0) + 2 * (X[:, 3] + X[:, 7] > 0.5)).astype(np.int64)
    return X, y


@pytest.fixture(scope="module")
def base_clf():
    X, y = _data()
    return DecisionTreeClassifier(max_depth=6, device="cpu").fit(X, y)


@pytest.fixture(scope="module")
def jax_clf():
    from mpitree_tpu import DecisionTreeClassifier as JaxDT

    X, y = _data()
    return JaxDT(max_depth=6, n_devices=(4, 2)).fit(X, y)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_classifier_identical_across_mesh_shapes(base_clf, jax_clf, shape):
    X, y = _data()
    meshed = DecisionTreeClassifier(max_depth=6, n_devices=shape,
                                    device="cpu").fit(X, y)
    _same_tree(meshed.tree_, base_clf.tree_, f"{shape} vs one device")
    _same_tree(meshed.tree_, jax_clf.tree_, f"{shape} vs JAX (4, 2)")
    assert meshed.export_text() == jax_clf.export_text()
    if shape[1] > 1:
        assert stats_view(meshed.fit_report_)["route_calls"] > 0


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_regressor_identical_across_mesh_shapes(shape):
    from mpitree_tpu import DecisionTreeRegressor as JaxDR

    X, _ = _data(seed=1)
    rng = np.random.default_rng(2)
    yr = (2 * X[:, 0] - X[:, 3] + 0.1 * rng.normal(size=len(X))).astype(
        np.float64)
    base = DecisionTreeRegressor(max_depth=5, device="cpu").fit(X, yr)
    meshed = DecisionTreeRegressor(max_depth=5, n_devices=shape,
                                   device="cpu").fit(X, yr)
    _same_tree(meshed.tree_, base.tree_, f"{shape}")
    ref = JaxDR(max_depth=5, n_devices=shape).fit(X, yr)
    _same_tree(meshed.tree_, ref.tree_, f"{shape} vs JAX")


def test_feature_padding_inert():
    """F = 10 over 4 feature shards pads to 12 columns; padding is never
    chosen and the tree is the unpadded one-device tree."""
    X, y = _data(n=257, f=10)  # odd row count: data padding too
    base = DecisionTreeClassifier(max_depth=5, device="cpu").fit(X, y)
    meshed = DecisionTreeClassifier(max_depth=5, n_devices=(2, 4),
                                    device="cpu").fit(X, y)
    _same_tree(meshed.tree_, base.tree_)
    assert int(meshed.tree_.feature.max()) < 10


def _build(X, y, *, engine, shape, sub, max_depth=5, task="classification",
           **kw):
    binned = bin_for_engine(X, max_bins=256, binning="auto", device=CPU)
    cfg = BuildConfig(engine=engine, max_depth=max_depth,
                      hist_subtraction=sub, task=task,
                      criterion="mse" if task == "regression" else "entropy")
    mesh = None if shape is None else M.resolve_mesh(device="cpu",
                                                     n_devices=shape)
    return build_tree(binned, y, config=cfg, mesh=mesh,
                      n_classes=int(y.max()) + 1, **kw)


_REF: dict = {}


@pytest.mark.parametrize("engine", ["fused", "levelwise"])
@pytest.mark.parametrize("f", [2, 4])
@pytest.mark.parametrize("sub", ["on", "off"])
def test_mesh_identity_both_engines_sub_toggle(engine, f, sub):
    """(8 / f, f) against (8, 1) and one device, each engine and
    subtraction setting (``tests/test_feature_mesh.py:100``)."""
    X, y = _data(n=240)
    if (engine, sub) not in _REF:
        _REF[engine, sub] = _build(X, y, engine=engine, shape=(8, 1),
                                   sub=sub)
        _same_tree(_REF[engine, sub], _build(X, y, engine=engine,
                                             shape=None, sub=sub))
    two_d = _build(X, y, engine=engine, shape=(8 // f, f), sub=sub)
    _same_tree(two_d, _REF[engine, sub], f"{engine}/{sub}/{f}")


@pytest.mark.parametrize("f", [2, 4])
def test_gbdt_identity_across_feature_shards(f):
    """Boosted ensembles on (8 / f, f) equal the 1-D data mesh's, as
    JAX's do (``tests/test_feature_mesh.py:114``), and, their sums being
    exact, the JAX package's exact default tier's (its device engine sums
    (g, h) in float32 on any mesh: ``ROADMAP.md`` R4)."""
    from mpitree_tpu import GradientBoostingClassifier as JaxGB

    X, y = covtype_like(3_000, seed=4)  # test_torch_boosting.py's data
    y = (y == np.bincount(y).argmax()).astype(np.int64)
    kw = dict(max_iter=4, max_depth=3, random_state=0)
    ref = GradientBoostingClassifier(n_devices=8, device="cpu",
                                     **kw).fit(X, y)
    two_d = GradientBoostingClassifier(n_devices=(8 // f, f), device="cpu",
                                       **kw).fit(X, y)
    for a, b in zip(two_d.trees_, ref.trees_):
        _same_tree(a, b, f"gbdt f={f}")
    np.testing.assert_array_equal(ref.predict_proba(X),
                                  two_d.predict_proba(X))
    jax_exact = JaxGB(**kw).fit(X, y)
    for a, b in zip(two_d.trees_, jax_exact.trees_):
        _same_tree(a, b, f"gbdt f={f} vs JAX")
    np.testing.assert_array_equal(two_d.predict_proba(X),
                                  jax_exact.predict_proba(X))


@pytest.mark.parametrize("sub", ["on", "off"])
def test_gbdt_subtraction_toggle_on_feature_mesh(sub, monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_HIST_SUBTRACTION", sub)
    X, y = _data(n=240)
    kw = dict(max_iter=3, max_depth=4, random_state=0, device="cpu")
    ref = GradientBoostingClassifier(n_devices=8, **kw).fit(X, y)
    two_d = GradientBoostingClassifier(n_devices=(4, 2), **kw).fit(X, y)
    np.testing.assert_array_equal(ref.predict_proba(X),
                                  two_d.predict_proba(X))


def test_refusals_as_jax():
    """monotonic_cst and per-node sampling on a feature mesh raise in
    the builder (``mpitree_tpu/core/builder.py:837-850``), leaf-wise
    growth and the fused rounds at their own checks."""
    from mpitree_tpu_torch.ops.sampling import sampler_for

    X, y = _data(n=200)
    yb = (y > 1).astype(np.int64)
    cst = np.zeros(X.shape[1], np.int8)
    cst[0] = 1
    with pytest.raises(ValueError, match="monotonic_cst"):
        _build(X, yb, engine="fused", shape=(4, 2), sub="off",
               mono_cst=cst)
    with pytest.raises(ValueError, match="sampling"):
        _build(X, y, engine="levelwise", shape=(4, 2), sub="off",
               feature_sampler=sampler_for(3, 0, X.shape[1]))
    with pytest.raises(ValueError, match="sampling"):
        DecisionTreeClassifier(max_features=3, random_state=0,
                               n_devices=(2, 4), device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="mesh2d_unsupported"):
        DecisionTreeClassifier(max_leaf_nodes=8, n_devices=(2, 4),
                               device="cpu").fit(X, y)


@pytest.mark.parametrize("n_devices,n_features,hist_bytes,budget", [
    (8, 54, 4 << 20, 1 << 20), (8, 54, 0, None), (8, 3, 64 << 20, 1 << 20),
    (1, 54, 0, 1), (8, 54, 1 << 20, 1 << 20), (6, 54, 10 << 20, 1 << 20),
    (4, 2, 1 << 30, 1),
])
def test_data_feature_shape_equals_jax(n_devices, n_features, hist_bytes,
                                       budget):
    kw = dict(hist_bytes=hist_bytes, hist_budget=budget)
    assert M.data_feature_shape(n_devices, n_features, **kw) == \
        jax_mesh.data_feature_shape(n_devices, n_features, **kw)


def test_resolve_mesh_2d_applies_policy():
    """``tests/test_partition.py:149``: the policy split, an explicit
    tuple bypassing it, and df == 1 the 1-D data mesh."""
    m = M.resolve_mesh_2d(n_features=54, hist_bytes=4 << 20,
                          hist_budget=1 << 20, device="cpu", n_devices=8)
    assert dict(zip(m.axis_names, m.shape)) == {M.DATA_AXIS: 2,
                                               M.FEATURE_AXIS: 4}
    m2 = M.resolve_mesh_2d(n_features=54, device="cpu", n_devices=(4, 2))
    assert dict(zip(m2.axis_names, m2.shape)) == {M.DATA_AXIS: 4,
                                                 M.FEATURE_AXIS: 2}
    m3 = M.resolve_mesh_2d(n_features=54, device="cpu", n_devices=8)
    assert m3.axis_names == (M.DATA_AXIS,)
    priced = M.resolve_mesh_2d(n_features=54, chunk_slots=64, n_classes=7,
                               n_bins=256, hist_budget=1 << 20,
                               device="cpu", n_devices=8)
    ref = jax_mesh.resolve_mesh_2d(n_features=54, chunk_slots=64,
                                   n_classes=7, n_bins=256,
                                   hist_budget=1 << 20, n_devices=8)
    assert priced.shape == tuple(ref.devices.shape)
    assert M.slab_bytes(64, 54, 7, 256) == 64 * 54 * 7 * 256 * 4


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)])
def test_layout_and_slab_placement_equal_jax(shape):
    """The (di, fi) grid and extents of ``ingest_layout``, and each
    shard's block of ``x_binned`` and ``cand_mask`` by its coordinates."""
    mesh = M.resolve_mesh(device="cpu", n_devices=shape)
    got = partition.layout(mesh, 103, 10)
    want = jax_partition.ingest_layout(
        jax_mesh.resolve_mesh(n_devices=shape), 103, 10)
    for k in ("rows_pad", "feat_pad", "shard_rows", "shard_cols"):
        assert got[k] == want[k], k
    assert got["grid"].shape == want["grid"].shape
    rng = np.random.default_rng(0)
    xb = rng.integers(0, 9, (103, 10)).astype(np.int32)
    cand = rng.random((10, 9)) < 0.5
    parts = M.shard_build_inputs(mesh, torch.from_numpy(xb),
                                 np.zeros(103, np.int64), None,
                                 cand_mask=cand)
    r, c = got["shard_rows"], got["shard_cols"]
    xp = np.zeros((got["rows_pad"], got["feat_pad"]), np.int32)
    xp[:103, :10] = xb
    cp = np.zeros((got["feat_pad"], 9), bool)
    cp[:10] = cand
    for i, part in enumerate(parts):
        di, fi = mesh.coords(i)
        assert got["grid"][di, fi] == mesh.shard_index(i)
        np.testing.assert_array_equal(
            part["x_binned"].numpy(), xp[di * r:(di + 1) * r,
                                         fi * c:(fi + 1) * c])
        np.testing.assert_array_equal(part["cand_mask"],
                                      cp[fi * c:(fi + 1) * c])
        assert (part["node_id"] == -1).sum() == (
            max(0, (di + 1) * r - 103) - max(0, di * r - 103))
    assert partition.spec_for("x_binned") == ("data", "feature")
    assert partition.spec_for("cand_mask") == ("feature", None)
    assert partition.spec_for("parent_hist") == (None, "feature", None,
                                                 None)


def test_select_global_is_the_feature_complete_first_minimum():
    """The merge of block winners equals one sweep over every feature,
    ties to the lowest feature, ``constant`` only when every block is,
    on both routes."""
    rng = np.random.default_rng(4)
    K, F, C, B, df = 16, 8, 3, 6, 4
    hist = torch.from_numpy(rng.integers(0, 3, (K, F, C, B)).astype(
        np.float32))
    hist[:, 5] = hist[:, 1]  # feature 5 ties feature 1 exactly
    hist[3] = 0
    hist[3, :, 0, 0] = 4.0  # a constant slot
    cand = torch.ones((F, B), dtype=torch.bool)
    cand[:, -1] = False
    fl = F // df
    for scale in (None, (0, 0, 0)):
        h = hist if scale is None else hist.to(torch.int64)
        whole = imp_ops.best_split_classification(h, cand, scale_exp=scale)
        decs = [imp_ops.best_split_classification(
            h[:, b * fl:(b + 1) * fl].contiguous(),
            cand[b * fl:(b + 1) * fl], scale_exp=scale) for b in range(df)]
        got = collective.select_global(decs, None, fl, list(range(df)))
        for k in ("feature", "bin", "cost", "n_left", "constant", "counts",
                  "n", "impurity"):
            assert torch.equal(getattr(got, k), getattr(whole, k)), (scale,
                                                                     k)



_WORKER = """
import sys
sys.path.insert(0, {repo!r})
import os
import torch
torch.set_num_threads(1)
port, pid, nloc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
from mpitree_tpu_torch.parallel import distributed, mesh
from mpitree_tpu_torch.obs import stats_view
mesh.set_cpu_shards(nloc)
distributed.initialize(f"localhost:{{port}}", 2, pid, backend="gloo",
                       timeout=60)
import numpy as np
from mpitree_tpu_torch.tree import (DecisionTreeClassifier,
                                    GradientBoostingRegressor)
from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

X, y = covtype_like(1_500, seed=6)
Xc, yc = california_like(1_500, seed=7)
shapes = [(1, 2)] if nloc == 1 else [(1, 4), (2, 2)]
one = DecisionTreeClassifier(max_depth=6, device="cpu").fit(X, y)
gb1 = GradientBoostingRegressor(max_iter=3, max_depth=3, device="cpu",
                                rounds_per_dispatch=1).fit(Xc, yc)
for shape in shapes:
    for engine in ("fused", "levelwise"):
        os.environ["MPITREE_TPU_ENGINE"] = engine
        par = DecisionTreeClassifier(max_depth=6, device="cpu",
                                     n_devices=shape).fit(X, y)
        for k in ("feature", "threshold", "left", "right", "count",
                  "n_node_samples", "impurity", "value"):
            assert np.array_equal(getattr(par.tree_, k),
                                  getattr(one.tree_, k),
                                  equal_nan=True), (shape, engine, k)
    os.environ.pop("MPITREE_TPU_ENGINE")
    st = stats_view(par.fit_report_)
    assert st["route_calls"] > 0, st
    if shape[1] > nloc:  # the feature axis spans the processes
        assert st["gather_calls"] > 0 and st["replication_checks"] > 0, st
    gb = GradientBoostingRegressor(max_iter=3, max_depth=3, device="cpu",
                                   rounds_per_dispatch=1,
                                   n_devices=shape).fit(Xc, yc)
    assert np.array_equal(gb.predict(Xc), gb1.predict(Xc)), shape
print(f"PROC{{pid}} OK", flush=True)
distributed.shutdown()
"""


@pytest.mark.parametrize("n_local", [1, 2])
def test_two_gloo_processes_on_a_feature_mesh(tmp_path, n_local):
    """Two processes with 1 CPU shard each ((1, 2): the feature axis spans
    them, so the winner gather and the route sum cross processes) and 2
    each ((1, 4) across them, (2, 2) within each): the one-device tree
    and ensemble in both, with the replication check on."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=_REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1", MPITREE_TPU_DEBUG="1")
    results, _ = run_procs(
        lambda ports, pid: [sys.executable, str(worker), str(ports[0]),
                            str(pid), str(n_local)],
        2, timeout=300, env=env, cwd=str(tmp_path))
    if results is None:
        pytest.fail("two-process feature mesh hung")
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"proc {pid}:\n{out[-3000:]}"
        assert f"PROC{pid} OK" in out


@pytest.mark.parametrize("what", ["tree", "forest", "boosting"])
def test_mesh_fitted_models_save_and_load_in_both_packages(tmp_path, what):
    """A tree on (2, 4), a forest on 8 shards and boosting on (4, 2) save
    in the JAX format; the file loads in both packages and predicts the
    one-device answers (``n_devices`` rides the header as a list, and the
    port's resolver takes it)."""
    from mpitree_tpu.utils.serialize import load_model as jax_load

    from mpitree_tpu_torch.tree import RandomForestClassifier
    from mpitree_tpu_torch.utils.serialize import load_model, save_model

    X, y = _data(n=240)
    cls, kw = {
        "tree": (DecisionTreeClassifier, dict(max_depth=5,
                                              n_devices=(2, 4))),
        "forest": (RandomForestClassifier, dict(n_estimators=3, max_depth=5,
                                                random_state=0,
                                                n_devices=8)),
        "boosting": (GradientBoostingClassifier, dict(max_iter=3,
                                                      max_depth=3,
                                                      n_devices=(4, 2))),
    }[what]
    est = cls(device="cpu", **kw).fit(X, y)
    one = cls(device="cpu", **dict(kw, n_devices=None)).fit(X, y)
    path = tmp_path / f"{what}.npz"
    save_model(est, path)
    port = load_model(path, device="cpu")
    nd = kw["n_devices"]
    assert port.n_devices == (list(nd) if isinstance(nd, tuple) else nd)
    ref = jax_load(path)
    np.testing.assert_array_equal(port.predict_proba(X),
                                  one.predict_proba(X))
    ref.n_devices = None  # the JAX resolver takes only tuples
    np.testing.assert_array_equal(ref.predict(X), one.predict(X))
