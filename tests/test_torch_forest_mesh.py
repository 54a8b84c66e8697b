"""The forests' tree and ``(tree, data)`` meshes against the JAX package's:
a port of ``tests/test_forest_mesh.py``, ``tests/test_sharding.py:109``
and ``tests/test_baseline_configs.py:76``.

``parallel/mesh.tree_data_shape`` is JAX's policy, table for table and
under the memory guard. ``core/fused_builder.build_forest_fused`` on a
mesh of 8 CPU shards (``mesh.set_cpu_shards(8)``, the JAX tests' 8
virtual devices) grows every tree field for field as on one shard, its
leaf ids too, whatever shape the policy or the guard
(``MPITREE_TPU_FOREST_HBM_BUDGET``) picks, and equals the JAX package's
forest on its 8 devices. The estimators take ``n_devices`` with bagging,
``max_features="sqrt"``, ExtraTrees, regression, the default refine tail,
``oob_score`` and ``warm_start``; two gloo processes fit the same forests.
Exact throughout: integer bootstrap counts sum exactly on both packages,
and the regression forests are held to the port's one-device forest.
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

from mpitree_tpu_torch.core.builder import BuildConfig  # noqa: E402
from mpitree_tpu_torch.obs import BuildObserver, stats_view  # noqa: E402
from mpitree_tpu_torch.core.fused_builder import build_forest_fused  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_for_engine  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as M  # noqa: E402
from mpitree_tpu_torch.parallel import partition  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    ExtraTreesClassifier,
    ExtraTreesRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
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


def _same_forest(got, want, what=""):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        _same_tree(a, b, f"{what} tree {i}")


@pytest.mark.parametrize("d,trees,nbytes,budget", [
    (8, 8, 0, None), (8, 100, 0, None), (8, 2, 0, None), (8, 1, 0, None),
    (8, 3, 0, None), (8, 5, 0, None), (1, 4, 0, None), (8, 8, 100, 30),
    (8, 8, 10**9, 1), (6, 4, 0, None), (6, 50, 700, 100), (2, 50, 0, None),
    (2, 2, 43_200_000, 1), (4, 3, 0, None),
])
def test_tree_data_shape_equals_jax(d, trees, nbytes, budget):
    kw = dict(dataset_bytes=nbytes, hbm_budget=budget)
    assert M.tree_data_shape(d, trees, **kw) == \
        jax_mesh.tree_data_shape(d, trees, **kw)


def test_tree_data_shape_policy_table():
    """The JAX test's table (``tests/test_forest_mesh.py:20``)."""
    assert M.tree_data_shape(8, 8) == (8, 1)
    assert M.tree_data_shape(8, 100) == (8, 1)
    assert M.tree_data_shape(8, 2) == (2, 4)
    assert M.tree_data_shape(8, 1) == (1, 8)
    assert M.tree_data_shape(8, 3) == (2, 4)
    assert M.tree_data_shape(8, 5) == (4, 2)
    assert M.tree_data_shape(1, 4) == (1, 1)
    t, d = M.tree_data_shape(8, 8, dataset_bytes=100, hbm_budget=30)
    assert (t, d) == (2, 4) and 100 <= 30 * d * 2
    assert M.tree_data_shape(8, 8, dataset_bytes=10**9, hbm_budget=1) == \
        (1, 8)


def test_forest_budget_knob_and_the_device_rule(monkeypatch):
    """``MPITREE_TPU_FOREST_HBM_BUDGET`` when set; else half the device's
    memory, JAX's rule (its 8 GiB is half of a v5e chip's 16 GiB)."""
    monkeypatch.setenv(M.FOREST_HBM_BUDGET_ENV, "12345")
    assert M.forest_hbm_budget(CPU) == 12345
    monkeypatch.delenv(M.FOREST_HBM_BUDGET_ENV)
    half = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2
    assert M.forest_hbm_budget(CPU) == half
    from mpitree_tpu.config import knobs as jax_knobs

    assert jax_knobs.REGISTRY[M.FOREST_HBM_BUDGET_ENV].default == 16 << 29


@pytest.mark.parametrize("shape", [(8, 1), (2, 4), (4, 2), (1, 8)])
def test_tree_data_mesh_groups_and_tree_rules(shape):
    """The (tree, data) mesh's groups are JAX's row-major reshape, and the
    partition table places the tree rules by it: ``tree_weights`` over
    (tree, data), other ``tree_*`` arrays over tree."""
    mesh = M.as_tree_data_mesh(M.resolve_mesh(device="cpu", n_devices=8),
                               shape)
    assert mesh.axis_names == ("tree", "data") and mesh.shape == shape
    groups = mesh.axis_groups(M.DATA_AXIS)
    assert [g.local for g in groups] == [
        list(range(t * shape[1], (t + 1) * shape[1]))
        for t in range(shape[0])]
    assert all(g.size == shape[1] and g.group is None for g in groups)
    assert partition.spec_for("tree_weights") == ("tree", "data")
    assert partition.spec_for("tree_node_id") == ("tree", "data")
    assert partition.spec_for("tree_cand_masks") == ("tree",)
    T, N = shape[0] * 3, shape[1] * 5
    w = np.arange(T * N, dtype=np.float32).reshape(T, N)
    parts = partition.place(mesh, {"tree_weights": w,
                                   "tree_mcw": np.arange(T, dtype=float)})
    for i, part in enumerate(parts):
        t, d = mesh.coords(i)
        np.testing.assert_array_equal(
            part["tree_weights"], w[t * 3:(t + 1) * 3, d * 5:(d + 1) * 5])
        np.testing.assert_array_equal(part["tree_mcw"],
                                      np.arange(t * 3, t * 3 + 3))


def _forest_inputs(n=600, f=6, trees=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] > 0) + 2 * (X[:, 1] > 0.3)).astype(np.int64)
    binned = bin_for_engine(X, max_bins=64, binning="auto", device=CPU)
    weights = rng.multinomial(n, np.full(n, 1 / n), size=trees).astype(
        np.float32)
    masks = np.broadcast_to(binned.candidate_mask(),
                            (trees,) + binned.candidate_mask().shape).copy()
    return X, binned, y, weights, masks


def _jax_forest(X, y, weights, masks, cfg_kw, **kw):
    from mpitree_tpu.core.builder import BuildConfig as JaxConfig
    from mpitree_tpu.core.fused_builder import (
        build_forest_fused as jax_forest,
    )
    from mpitree_tpu.ops.binning import bin_dataset

    return jax_forest(bin_dataset(X, max_bins=64), y,
                      config=JaxConfig(**cfg_kw),
                      mesh=jax_mesh.resolve_mesh(n_devices="all"),
                      weights=weights, cand_masks=masks, n_classes=4, **kw)


@pytest.mark.parametrize("trees", [1, 2, 3])
def test_data_sharded_forest_matches_single_device(trees):
    """Forests whose mesh engages the data axis (fewer trees than shards)
    grow one shard's trees, and JAX's on its 8 devices."""
    X, binned, y, weights, masks = _forest_inputs(trees=trees)
    cfg_kw = dict(task="classification", criterion="entropy", max_depth=6)
    mesh8 = M.resolve_mesh(device="cpu", n_devices="all")
    assert M.tree_data_shape(mesh8.size, trees)[1] > 1
    obs = BuildObserver()
    sharded = build_forest_fused(
        binned, y, config=BuildConfig(**cfg_kw), mesh=mesh8,
        weights=weights, cand_masks=masks, n_classes=4, timer=obs)
    stats = stats_view(obs.report())
    single = build_forest_fused(
        binned, y, config=BuildConfig(**cfg_kw), weights=weights,
        cand_masks=masks, n_classes=4)
    _same_forest(sharded, single, "sharded vs one shard")
    assert stats["forest_mesh"] == list(M.tree_data_shape(8, trees))
    assert mesh8.stats["allreduce_calls"] > 0
    _same_forest(sharded, _jax_forest(X, y, weights, masks, cfg_kw),
                 "vs JAX")


def test_data_sharded_leaf_ids_match():
    """Row -> leaf assignments of the sharded forest equal one shard's
    and JAX's (they feed the refine tail)."""
    X, binned, y, weights, masks = _forest_inputs(trees=2)
    cfg = BuildConfig(max_depth=5)
    _, ids8 = build_forest_fused(
        binned, y, config=cfg, mesh=M.resolve_mesh(device="cpu",
                                                   n_devices="all"),
        weights=weights, cand_masks=masks, n_classes=4,
        return_leaf_ids=True)
    _, ids1 = build_forest_fused(binned, y, config=cfg, weights=weights,
                                 cand_masks=masks, n_classes=4,
                                 return_leaf_ids=True)
    np.testing.assert_array_equal(ids8, ids1)
    _, jids = _jax_forest(X, y, weights, masks,
                          dict(task="classification", criterion="entropy",
                               max_depth=5), return_leaf_ids=True)
    np.testing.assert_array_equal(ids8, np.asarray(jids))


def test_hbm_guard_forces_data_axis(monkeypatch):
    """A one-byte budget pushes a full-width ensemble onto the data axis,
    and the forest is the same trees."""
    _, binned, y, weights, masks = _forest_inputs(trees=8)
    cfg = BuildConfig(max_depth=4)
    mesh8 = M.resolve_mesh(device="cpu", n_devices="all")
    monkeypatch.setenv(M.FOREST_HBM_BUDGET_ENV, "1")
    obs_g, obs_p = BuildObserver(), BuildObserver()
    guarded = build_forest_fused(binned, y, config=cfg, mesh=mesh8,
                                 weights=weights, cand_masks=masks,
                                 n_classes=4, timer=obs_g)
    monkeypatch.setenv(M.FOREST_HBM_BUDGET_ENV, str(8 << 30))
    plain = build_forest_fused(binned, y, config=cfg, mesh=mesh8,
                               weights=weights, cand_masks=masks,
                               n_classes=4, timer=obs_p)
    st_g = stats_view(obs_g.report())
    st_p = stats_view(obs_p.report())
    assert (st_g["forest_mesh"], st_p["forest_mesh"]) == ([1, 8], [8, 1])
    _same_forest(guarded, plain, "guarded vs plain")


@pytest.fixture(scope="module")
def cov():
    return covtype_like(2_000, seed=3)


@pytest.fixture(scope="module")
def jax_wide(cov):
    """The JAX package's 3-tree forest on its 8-device mesh."""
    from mpitree_tpu import RandomForestClassifier as JaxRF

    X, y = cov
    return JaxRF(n_estimators=3, max_depth=6, random_state=0,
                 backend="cpu", n_devices="all").fit(X, y)


def test_forest_estimator_on_wide_mesh_small_ensemble(cov, jax_wide):
    """End to end: a 3-tree forest on 8 shards engages the data axis and
    predicts as the one-shard forest and JAX's 8-device forest."""
    X, y = cov
    kw = dict(n_estimators=3, max_depth=6, random_state=0, device="cpu")
    wide = RandomForestClassifier(n_devices="all", **kw).fit(X, y)
    one = RandomForestClassifier(**kw).fit(X, y)
    assert stats_view(wide.fit_report_)["forest_mesh"] == [2, 4]
    assert stats_view(wide.fit_report_)["n_shards"] == 8
    _same_forest(wide.trees_, one.trees_, "wide vs one")
    _same_forest(wide.trees_, jax_wide.trees_, "wide vs JAX")
    np.testing.assert_array_equal(wide.predict(X), one.predict(X))
    np.testing.assert_array_equal(wide.predict_proba(X),
                                  jax_wide.predict_proba(X))


def test_config5_forest_tree_sharded(cov):
    """BASELINE config 5: a bagged forest with its trees sharded over 8
    shards ((8, 1): one tree a shard), the one-shard forest field for
    field, and JAX's forest sharded alike."""
    from mpitree_tpu import RandomForestClassifier as JaxRF

    X, y = cov
    kw = dict(n_estimators=8, max_depth=10, random_state=0)
    sharded = RandomForestClassifier(n_devices=8, device="cpu",
                                     **kw).fit(X, y)
    # one process holds every tree group: no exchange to make
    assert stats_view(sharded.fit_report_)["forest_mesh"] == [8, 1]
    assert stats_view(sharded.fit_report_)["tree_exchange_calls"] == 0
    one = RandomForestClassifier(device="cpu", **kw).fit(X, y)
    _same_forest(sharded.trees_, one.trees_, "sharded vs one")
    ref = JaxRF(n_devices=8, backend="cpu", **kw).fit(X, y)
    _same_forest(sharded.trees_, ref.trees_, "vs JAX")


ESTIMATORS = {
    "bagged": (RandomForestClassifier, "cov", {}),
    "sqrt": (RandomForestClassifier, "cov", dict(max_features="sqrt")),
    "extra": (ExtraTreesClassifier, "cov", {}),
    "defaults": (RandomForestClassifier, "cov", dict(max_depth=None)),
    "regressor": (RandomForestRegressor, "cal", {}),
    "extra_regressor": (ExtraTreesRegressor, "cal", {}),
    "oob": (RandomForestClassifier, "cov", dict(oob_score=True)),
}


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_forest_estimators_equal_one_device(cov, name, n_devices):
    """Each estimator on 2 and 8 shards: every tree field for field, the
    predictions bit for bit (the default forest's refine tail reads the
    gathered leaf ids; the OOB score is the one-device score)."""
    cls, data, extra = ESTIMATORS[name]
    X, y = cov if data == "cov" else california_like(2_000, seed=5)
    kw = dict(dict(n_estimators=3, max_depth=7, random_state=0), **extra)
    one = cls(device="cpu", **kw).fit(X, y)
    par = cls(device="cpu", n_devices=n_devices, **kw).fit(X, y)
    _same_forest(par.trees_, one.trees_, name)
    np.testing.assert_array_equal(par.predict(X[:300]), one.predict(X[:300]))
    if name == "oob":
        assert par.oob_score_ == one.oob_score_
    if name == "defaults":
        assert stats_view(par.fit_report_)["refine_nodes_added"] > 0


def test_warm_start_shapes_the_mesh_for_the_new_trees(cov):
    """A warm start on 8 shards keeps the fitted trees and shards only the
    new ones (2 new trees: the (2, 4) mesh), equal to one device's."""
    X, y = cov
    kw = dict(n_estimators=3, max_depth=6, random_state=0,
              warm_start=True, device="cpu")
    par = RandomForestClassifier(n_devices=8, **kw).fit(X, y)
    one = RandomForestClassifier(**kw).fit(X, y)
    kept = list(par.trees_)
    par.set_params(n_estimators=5).fit(X, y)
    one.set_params(n_estimators=5).fit(X, y)
    assert stats_view(par.fit_report_)["forest_mesh"] == [2, 4]
    assert all(a is b for a, b in zip(par.trees_[:3], kept))
    _same_forest(par.trees_, one.trees_, "warm")


def test_levelwise_forest_builds_each_tree_on_the_data_mesh(cov,
                                                            monkeypatch):
    """The per-tree path (``MPITREE_TPU_ENGINE=levelwise``) grows each
    tree on the 8-shard data mesh, as JAX's ``build_one_device``."""
    X, y = cov
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    kw = dict(n_estimators=2, max_depth=6, random_state=1, device="cpu")
    par = RandomForestClassifier(n_devices=8, **kw).fit(X, y)
    assert stats_view(par.fit_report_)["ensemble_path"] == "per-tree"
    assert stats_view(par.fit_report_)["n_shards"] == 8
    _same_forest(par.trees_, RandomForestClassifier(**kw).fit(X, y).trees_)



_WORKER = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
port, pid = sys.argv[1], int(sys.argv[2])
from mpitree_tpu_torch.parallel import distributed, mesh
from mpitree_tpu_torch.obs import stats_view
mesh.set_cpu_shards(2)
distributed.initialize(f"localhost:{{port}}", 2, pid, backend="gloo",
                       timeout=60)
import numpy as np
from mpitree_tpu_torch.tree import RandomForestClassifier, RandomForestRegressor
from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

X, y = covtype_like(1_500, seed=1)
Xc, yc = california_like(1_500, seed=2)
for T, cls, XX, yy, extra in ((1, RandomForestClassifier, X, y, {{}}),
                              (2, RandomForestClassifier, X, y, {{}}),
                              (5, RandomForestClassifier, X, y, {{}}),
                              (3, RandomForestRegressor, Xc, yc,
                               dict(max_depth=None))):
    kw = dict(dict(n_estimators=T, max_depth=6, random_state=0,
                   device="cpu"), **extra)
    par = cls(n_devices="all", **kw).fit(XX, yy)
    one = cls(**kw).fit(XX, yy)
    for a, b in zip(par.trees_, one.trees_):
        for k in ("feature", "threshold", "left", "count", "value",
                  "n_node_samples", "impurity"):
            assert np.array_equal(getattr(a, k), getattr(b, k),
                                  equal_nan=True), (T, k)
    st = stats_view(par.fit_report_)
    assert st["n_shards"] == 4 and st["tree_exchange_calls"] > 0, st
    assert st["replication_checks"] > 0, st
    print(pid, T, st["forest_mesh"], flush=True)
print(f"PROC{{pid}} OK", flush=True)
distributed.shutdown()
"""


def test_two_gloo_processes_fit_the_one_device_forests(tmp_path):
    """Two processes x 2 CPU shards: (1, 4), (2, 2) and (4, 1) tree
    meshes and a default regression forest, each equal to one device's
    forest in both processes, the exchanged forest checked replicated."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=_REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    results, _ = run_procs(
        lambda ports, pid: [sys.executable, str(worker), str(ports[0]),
                            str(pid)],
        2, timeout=300, env=env, cwd=str(tmp_path))
    if results is None:
        pytest.fail("two-process forests hung")
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"proc {pid}:\n{out[-3000:]}"
        assert f"PROC{pid} OK" in out
        assert f"{pid} 1 [1, 4]" in out and f"{pid} 2 [2, 2]" in out
        assert f"{pid} 5 [4, 1]" in out
