"""Leaf-wise growth on a data mesh against the JAX package's: a port of
``tests/test_leafwise.py:204`` (``test_regressor_identity_mesh``) and of
the leaf-wise mesh refusals.

On 2 and 8 CPU shards (``mesh.set_cpu_shards(8)``) both leaf-wise engines
(the fused ``_LeafLoop`` and the host-stepped one), with sibling
subtraction on and off, grow the one-device tree field for field: every
shard keeps its rows' node ids and each expansion's pair histogram
reduces over the mesh. A budget of ``2**max_depth`` on 8 shards is the
level-wise tree of the same depth, as in JAX; binding budgets equal the
JAX package's leaf-wise trees where its sums are exact. On a ``(data,
feature)`` mesh leaf-wise growth raises, as JAX's does. Two gloo
processes grow the same trees.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch
from _torch_twoproc import run_procs

pytest.importorskip("jax")

from mpitree_tpu_torch.core.builder import BuildConfig, build_tree  # noqa: E402
from mpitree_tpu_torch.obs import BuildObserver, stats_view  # noqa: E402
from mpitree_tpu_torch.ops.binning import bin_for_engine  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as M  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    ParallelDecisionTreeClassifier,
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


def _reg_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 6)).astype(np.float32)
    y = (X[:, 0] - 2 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
         + 0.1 * rng.normal(size=600))
    return X, y


@pytest.fixture(scope="module")
def reg_level8():
    """The level-wise depth-4 regressor on 8 shards (JAX's reference)."""
    X, y = _reg_data()
    return DecisionTreeRegressor(max_depth=4, refine_depth=None,
                                 device="cpu", n_devices=8).fit(X, y).tree_


@pytest.mark.parametrize("n_devices", [1, 8])
def test_regressor_identity_mesh(reg_level8, n_devices):
    """A budget of ``2**max_depth`` grows the level-wise tree on any
    mesh (``tests/test_leafwise.py:204``)."""
    X, y = _reg_data()
    lw = DecisionTreeRegressor(max_depth=4, max_leaf_nodes=16, device="cpu",
                               n_devices=n_devices).fit(X, y)
    _same_tree(lw.tree_, reg_level8, f"mesh={n_devices}")
    assert stats_view(lw.fit_report_)["frontier"] == "leafwise"


@pytest.fixture(scope="module")
def cov():
    return covtype_like(2_500, seed=5)


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("sub", ["on", "off"])
@pytest.mark.parametrize("engine", ["fused", "levelwise"])
def test_binding_budget_on_mesh_equals_one_device(cov, engine, sub,
                                                  n_devices, monkeypatch):
    """Both engines, subtraction on and off, a binding budget of 31: the
    one-device tree field for field, its leaf ids too; the fused engine
    says it stepped without a graph."""
    X, y = cov
    monkeypatch.setenv("MPITREE_TPU_ENGINE", engine)
    binned = bin_for_engine(X, max_bins=64, binning="auto", device=CPU)
    cfg = BuildConfig(max_leaf_nodes=31, hist_subtraction=sub)
    one, ids1 = build_tree(binned, y, config=cfg, n_classes=7,
                           return_leaf_ids=True)
    obs = BuildObserver()
    mesh = M.resolve_mesh(device="cpu", n_devices=n_devices)
    par, ids = build_tree(binned, y, config=cfg, n_classes=7,
                          return_leaf_ids=True, mesh=mesh, timer=obs)
    stats = stats_view(obs.report())
    _same_tree(par, one, f"{engine}/{sub}/{n_devices}")
    np.testing.assert_array_equal(ids, ids1)
    assert stats["engine"] == engine and stats["n_shards"] == n_devices
    assert mesh.stats["allreduce_calls"] >= stats["expansions"]
    if engine == "fused":
        assert stats["graph"] is False


@pytest.fixture(scope="module")
def jax_budget(cov):
    """The JAX package's 31-leaf tree on its 8-device mesh."""
    from mpitree_tpu import DecisionTreeClassifier as JaxDT

    X, y = cov
    return JaxDT(max_leaf_nodes=31, max_bins=64, backend="cpu",
                 n_devices=8).fit(X, y).tree_


def test_binding_budget_on_mesh_equals_jax(cov, jax_budget):
    X, y = cov
    par = ParallelDecisionTreeClassifier(max_leaf_nodes=31, max_bins=64,
                                         device="cpu").fit(X, y)
    assert stats_view(par.fit_report_)["n_shards"] == 8
    _same_tree(par.tree_, jax_budget, "vs JAX on 8 devices")


def test_leafwise_regressor_and_gbdt_round_on_mesh():
    """A binding regression budget and a boosting round's best-first tree
    (``task="gbdt"``) on 8 shards: the one-device trees."""
    X, y = california_like(1_500, seed=8)
    kw = dict(max_leaf_nodes=20, device="cpu")
    _same_tree(DecisionTreeRegressor(n_devices=8, **kw).fit(X, y).tree_,
               DecisionTreeRegressor(**kw).fit(X, y).tree_, "regressor")
    binned = bin_for_engine(X, max_bins=64, binning="auto", device=CPU)
    rng = np.random.default_rng(1)
    g = rng.normal(size=len(y)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=len(y)).astype(np.float32)
    h[rng.random(len(y)) < 0.2] = 0.0  # rows outside the subsample
    cfg = BuildConfig(task="gbdt", max_leaf_nodes=12, max_depth=6,
                      min_leaf_rows=5.0)
    one = build_tree(binned, g, config=cfg, sample_weight=h)
    par = build_tree(binned, g, config=cfg, sample_weight=h,
                     mesh=M.resolve_mesh(device="cpu", n_devices=8))
    _same_tree(par, one, "gbdt round")


def test_leafwise_refuses_a_feature_mesh_as_jax():
    """JAX's refusals: at parameter validation
    (``mpitree_tpu/utils/validation.py:349-359``) and in the builder
    (``mpitree_tpu/core/leafwise_builder.py:481-505``)."""
    from mpitree_tpu import DecisionTreeClassifier as JaxDT

    X, y = covtype_like(300, seed=0)
    for cls in (JaxDT, DecisionTreeClassifier):
        with pytest.raises(ValueError, match="mesh2d_unsupported"):
            kw = {} if cls is JaxDT else dict(device="cpu")
            cls(max_leaf_nodes=8, n_devices=(4, 2), **kw).fit(X, y)
    binned = bin_for_engine(X, max_bins=32, binning="auto", device=CPU)
    with pytest.raises(ValueError, match="mesh2d_unsupported"):
        build_tree(binned, y, config=BuildConfig(max_leaf_nodes=8),
                   n_classes=7,
                   mesh=M.resolve_mesh(device="cpu", n_devices=(4, 2)))



_WORKER = """
import sys
sys.path.insert(0, {repo!r})
import os
import torch
torch.set_num_threads(1)
port, pid = sys.argv[1], int(sys.argv[2])
from mpitree_tpu_torch.parallel import distributed, mesh
from mpitree_tpu_torch.obs import stats_view
mesh.set_cpu_shards(2)
distributed.initialize(f"localhost:{{port}}", 2, pid, backend="gloo",
                       timeout=60)
import numpy as np
from mpitree_tpu_torch.tree import DecisionTreeClassifier
from mpitree_tpu_torch.utils.datasets import covtype_like

X, y = covtype_like(1_800, seed=2)
for engine in ("fused", "levelwise"):
    os.environ["MPITREE_TPU_ENGINE"] = engine
    kw = dict(max_leaf_nodes=25, device="cpu")
    par = DecisionTreeClassifier(n_devices="all", **kw).fit(X, y)
    one = DecisionTreeClassifier(**kw).fit(X, y)
    for k in ("feature", "threshold", "left", "right", "count",
              "n_node_samples", "impurity", "value"):
        assert np.array_equal(getattr(par.tree_, k), getattr(one.tree_, k),
                              equal_nan=True), (engine, k)
    st = stats_view(par.fit_report_)
    assert st["n_shards"] == 4 and st["allreduce_calls"] > 0, st
print(f"PROC{{pid}} OK", flush=True)
distributed.shutdown()
"""


def test_two_gloo_processes_grow_the_one_device_leafwise_tree(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=_REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    results, _ = run_procs(
        lambda ports, pid: [sys.executable, str(worker), str(ports[0]),
                            str(pid)],
        2, timeout=300, env=env, cwd=str(tmp_path))
    if results is None:
        pytest.fail("two-process leaf-wise fit hung")
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"proc {pid}:\n{out[-3000:]}"
        assert f"PROC{pid} OK" in out
