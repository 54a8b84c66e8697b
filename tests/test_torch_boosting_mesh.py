"""Boosting on a data mesh against the JAX package's: a port of
``tests/test_boosting.py:232-250`` and ``tests/test_leafwise.py:482``.

On 2 and 8 CPU shards (``mesh.set_cpu_shards(8)``, the JAX tests' 8
virtual devices) the host round loop grows every round's tree on the
mesh (``build_tree(task="gbdt")``): its int64 fixed-point sums are exact
and its exponents come from every row, so each tree, refit and margin is
the one-device ensemble's bit for bit, as JAX's sharded ensembles are its
one-device ones; where JAX's own sums are exact (the binary classifier
at integer weights) the port's ensemble equals JAX's too. The fused
rounds (``rounds_per_dispatch=4``) on the mesh equal the port's
one-device fused rounds bit for bit (R1: they are held to the host loop
by ``tests/test_torch_fused_rounds.py``), and step without a CUDA graph.
Two gloo processes fit the same ensembles.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch
from _torch_twoproc import run_procs

pytest.importorskip("jax")

from mpitree_tpu_torch.boosting import fused_rounds  # noqa: E402
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as M  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    GradientBoostingClassifier,
    GradientBoostingRegressor,
)
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
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


def _same_ensemble(got, want, what=""):
    assert len(got.trees_) == len(want.trees_), what
    for i, (a, b) in enumerate(zip(got.trees_, want.trees_)):
        for k in FIELDS:
            x, z = getattr(a, k), getattr(b, k)
            assert x.dtype == z.dtype, (what, i, k)
            np.testing.assert_array_equal(x, z, err_msg=f"{what} {i} {k}")


@pytest.fixture(scope="module")
def binary():
    """``tests/test_torch_boosting.py``'s binary covtype, on which the
    port's one-device ensembles equal the JAX package's default ones."""
    X, y = covtype_like(3_000, seed=4)
    return X, (y == np.bincount(y).argmax()).astype(np.int64)


@pytest.fixture(scope="module")
def toy_regression():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 5)).astype(np.float32)
    y = (X[:, 0] * 2 - X[:, 1] + 0.3 * rng.normal(size=400)).astype(
        np.float64)
    return X, y


CLF_KW = dict(max_iter=8, max_depth=4, subsample=0.8, random_state=0)


@pytest.fixture(scope="module")
def jax_clf(binary):
    """The JAX package's classifier at its default (exact) tier; its
    sharded ensembles equal its one-device ones
    (``tests/test_boosting.py:232``)."""
    from mpitree_tpu import GradientBoostingClassifier as JaxGB

    X, y = binary
    return JaxGB(**CLF_KW).fit(X, y)


@pytest.fixture(scope="module")
def port_clf(binary):
    X, y = binary
    return GradientBoostingClassifier(device="cpu", **CLF_KW).fit(X, y)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_fit_bit_identical(binary, port_clf, jax_clf, n_devices):
    X, y = binary
    many = GradientBoostingClassifier(device="cpu", n_devices=n_devices,
                                      **CLF_KW).fit(X, y)
    assert stats_view(many.fit_report_)["n_shards"] == n_devices
    assert stats_view(many.fit_report_)["allreduce_calls"] > 0
    _same_ensemble(many, port_clf, f"{n_devices} shards vs one")
    _same_ensemble(many, jax_clf, f"{n_devices} shards vs JAX")
    np.testing.assert_array_equal(many.predict_proba(X),
                                  jax_clf.predict_proba(X))
    np.testing.assert_array_equal(many.train_score_, jax_clf.train_score_)


def test_sharded_regressor_bit_identical(toy_regression):
    X, y = toy_regression
    kw = dict(max_iter=8, max_depth=3, random_state=0, device="cpu")
    one = GradientBoostingRegressor(n_devices=1, **kw).fit(X, y)
    many = GradientBoostingRegressor(n_devices=8, **kw).fit(X, y)
    _same_ensemble(many, one, "regressor")
    np.testing.assert_array_equal(one.predict(X), many.predict(X))
    np.testing.assert_array_equal(one.train_score_, many.train_score_)


@pytest.mark.parametrize("extra", [
    dict(max_leaf_nodes=8), dict(colsample_bytree=0.5),
    dict(early_stopping=True, n_iter_no_change=3),
], ids=["leafwise", "colsample", "early_stopping"])
def test_sharded_options_bit_identical(extra):
    """Best-first rounds, per-round column slices and early stopping on
    8 shards: the one-device ensemble."""
    X, y = covtype_like(1_500, seed=4)
    kw = dict(dict(max_iter=6, max_depth=3, random_state=1, device="cpu"),
              **extra)
    one = GradientBoostingClassifier(**kw).fit(X, y)
    many = GradientBoostingClassifier(n_devices=8, **kw).fit(X, y)
    _same_ensemble(many, one, str(extra))
    np.testing.assert_array_equal(one.predict_proba(X),
                                  many.predict_proba(X))


GBF_KW = dict(max_iter=10, max_depth=4, learning_rate=0.2, random_state=0,
              subsample=0.8)


@pytest.fixture(scope="module")
def fused_one():
    X, y = california_like(1_200, seed=6)
    return X, y, GradientBoostingRegressor(
        device="cpu", rounds_per_dispatch=4, **GBF_KW).fit(X, y)


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_fused_rounds_mesh_invariant(fused_one, n_devices):
    """K = 4 rounds a dispatch on 1, 2 and 8 shards: the one-device fused
    ensemble bit for bit (trees and margins), each dispatch's exponents
    from the bound reduced over the mesh (MAX)."""
    X, y, ref = fused_one
    other = GradientBoostingRegressor(
        device="cpu", n_devices=n_devices, rounds_per_dispatch=4,
        **GBF_KW).fit(X, y)
    st = stats_view(other.fit_report_)
    assert st["rounds_per_dispatch"]["value"] == 4
    assert st["dispatches"] == 3
    assert st["graph"] is False and st["graph_reason"]
    _same_ensemble(other, ref, f"fused {n_devices}")
    np.testing.assert_array_equal(ref.predict(X), other.predict(X))
    np.testing.assert_allclose(ref.train_score_, other.train_score_,
                               rtol=1e-12, atol=0)


def test_fused_classifier_on_mesh_equals_one_device():
    X, y = covtype_like(1_500, seed=7)
    yb = (y == 1).astype(np.int64)
    kw = dict(max_iter=6, max_leaf_nodes=7, random_state=2, device="cpu",
              rounds_per_dispatch=3, subsample=0.7)
    one = GradientBoostingClassifier(**kw).fit(X, yb)
    many = GradientBoostingClassifier(n_devices=8, **kw).fit(X, yb)
    _same_ensemble(many, one, "fused classifier")
    np.testing.assert_array_equal(one.decision_function(X),
                                  many.decision_function(X))


def test_graph_choice_names_its_reason():
    """The leaf loop keeps a CUDA graph only on the card without a
    reducing mesh; otherwise ``fit_stats_`` says why not."""
    from mpitree_tpu_torch.core import leafwise_builder as lw

    class Fit:
        def __init__(self, dev, mesh):
            self.dev, self.mesh = torch.device(dev), mesh

    assert lw.graph_choice(Fit("cpu", None))[0] is False
    mesh = M.resolve_mesh(device="cpu", n_devices=2)
    graph, reason = lw.graph_choice(Fit("cuda", mesh))
    assert graph is False and "2 shards" in reason
    assert lw.graph_choice(Fit("cuda", None))[0] is True


def test_fused_rounds_refuse_a_feature_mesh():
    """JAX's refusal (``mpitree_tpu/boosting/fused_rounds.py:146-155``):
    an explicit K > 1 raises on a (data, feature) mesh, "auto" falls to
    the host loop naming it."""
    from mpitree_tpu.boosting import fused_rounds as jax_fr

    kw = dict(device_type="cpu", loss_kind="squared_error", loss_K=1,
              early_stopping=False, colsample=1.0, max_depth=4,
              max_leaf_nodes=None)
    with pytest.raises(ValueError, match="mesh2d_unsupported"):
        fused_rounds.resolve_rounds_per_dispatch(4, feature_shards=2, **kw)
    k, reason = fused_rounds.resolve_rounds_per_dispatch(
        "auto", feature_shards=2, **kw)
    assert k == 1 and "mesh2d_unsupported" in reason
    with pytest.raises(ValueError, match="mesh2d_unsupported"):
        jax_fr.resolve_rounds_per_dispatch(
            4, platform="cpu", feature_shards=2,
            **{k: v for k, v in kw.items() if k != "device_type"})
    X, y = california_like(400, seed=1)
    with pytest.raises(ValueError, match="mesh2d_unsupported"):
        GradientBoostingRegressor(max_iter=2, n_devices=(4, 2),
                                  rounds_per_dispatch=4,
                                  device="cpu").fit(X, y)



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
from mpitree_tpu_torch.tree import GradientBoostingRegressor
from mpitree_tpu_torch.utils.datasets import california_like

X, y = california_like(1_200, seed=3)
for k in (1, 4):
    kw = dict(max_iter=6, max_depth=3, random_state=0, subsample=0.8,
              rounds_per_dispatch=k, device="cpu")
    par = GradientBoostingRegressor(n_devices="all", **kw).fit(X, y)
    one = GradientBoostingRegressor(**kw).fit(X, y)
    assert np.array_equal(par.predict(X), one.predict(X)), k
    for a, b in zip(par.trees_, one.trees_):
        for f in ("feature", "threshold", "left", "count", "value"):
            assert np.array_equal(getattr(a, f), getattr(b, f),
                                  equal_nan=True), (k, f)
    assert stats_view(par.fit_report_)["n_shards"] == 4, stats_view(par.fit_report_)
    assert stats_view(par.fit_report_)["allreduce_calls"] > 0
print(f"PROC{{pid}} OK", flush=True)
distributed.shutdown()
"""


def test_two_gloo_processes_boost_the_one_device_ensembles(tmp_path):
    """Two processes x 2 CPU shards, the host loop and K = 4: both equal
    the one-device ensembles in both processes."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=_REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    results, _ = run_procs(
        lambda ports, pid: [sys.executable, str(worker), str(ports[0]),
                            str(pid)],
        2, timeout=300, env=env, cwd=str(tmp_path))
    if results is None:
        pytest.fail("two-process boosting hung")
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"proc {pid}:\n{out[-3000:]}"
        assert f"PROC{pid} OK" in out


_OVER_WORKER = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
port, pid = sys.argv[1], int(sys.argv[2])
from mpitree_tpu_torch.parallel import distributed, mesh
mesh.set_cpu_shards(2)
distributed.initialize(f"localhost:{{port}}", 2, pid, backend="gloo",
                       timeout=60)
from mpitree_tpu_torch.boosting import fused_rounds
from mpitree_tpu_torch.tree import GradientBoostingRegressor
from mpitree_tpu_torch.utils.datasets import california_like

if pid == 0:  # this process's count channel passes its bound of 1
    payload = fused_rounds.gbdt_payload
    fused_rounds.gbdt_payload = lambda g, h: payload(g, h) * torch.tensor(
        [2.0, 1.0, 1.0])
X, y = california_like(1_200, seed=3)
try:
    GradientBoostingRegressor(max_iter=8, max_depth=3, random_state=0,
                              rounds_per_dispatch=4, n_devices="all",
                              device="cpu").fit(X, y)
except RuntimeError as e:
    assert "passed its dispatch's bounds" in str(e), e
    print(f"PROC{{pid}} RAISED", flush=True)
distributed.shutdown()
"""


def test_payload_bound_passed_on_one_process_raises_on_both(tmp_path):
    """A fused dispatch whose payload passes its bounds on one process
    only raises the same error in both processes, and neither waits on
    the other's next collective."""
    worker = tmp_path / "worker.py"
    worker.write_text(_OVER_WORKER.format(repo=_REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    results, _ = run_procs(
        lambda ports, pid: [sys.executable, str(worker), str(ports[0]),
                            str(pid)],
        2, timeout=120, env=env, cwd=str(tmp_path))
    if results is None:
        pytest.fail("a process waited on its peer after the bound passed")
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"proc {pid}:\n{out[-3000:]}"
        assert f"PROC{pid} RAISED" in out, f"proc {pid}:\n{out[-3000:]}"
