"""Public helpers of the JAX package the port lacked, against it.

- ``obs.metrics.MetricsRegistry.snapshot`` equals the JAX package's after
  the same observations, exemplars on and off;
- ``utils.datasets.load_covtype`` and ``load_california`` mirror
  ``tests/test_datasets.py``: a cached sklearn copy is preferred and read
  with ``download_if_missing=False`` (never a download), else the
  generators' data under ``covtype_like``/``california_like``; both
  packages return the same arrays and name;
- ``parallel.distributed.initialize`` takes the JAX package's
  ``initialization_timeout`` (the join's bound) and
  ``heartbeat_timeout_seconds`` (the collectives'), refuses any other
  keyword by name, and is a no-op on one process; two processes join
  with separate bounds on ``tcp://`` and on a launcher's environment,
  also where a ``torchrun`` agent already hosts the store.
"""

from __future__ import annotations

import os
import sys
import time
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu.obs import metrics as jax_metrics  # noqa: E402
from mpitree_tpu.utils import datasets as jax_datasets  # noqa: E402

from mpitree_tpu_torch.obs import metrics  # noqa: E402
from mpitree_tpu_torch.parallel import distributed  # noqa: E402
from mpitree_tpu_torch.utils import datasets  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_twoproc import free_port, run_procs  # noqa: E402

EXEMPLARS = "MPITREE_TPU_METRICS_EXEMPLARS"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _observe(mod, seed: int = 0):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    reg.counter("mpitree_registry_publish_total", model="rf").inc()
    reg.counter("mpitree_registry_publish_total", model='a"b').inc(2)
    reg.counter("mpitree_serving_rows_total").inc(4096.5)
    reg.gauge("mpitree_sched_queue_depth", qos="batch").set(-3)
    for bucket in ("1", "oversize"):
        h = reg.histogram("mpitree_serving_request_seconds", bucket=bucket)
        for v in rng.lognormal(-7.0, 1.5, size=200):
            h.observe(float(v))
    reg.histogram("mpitree_registry_warm_seconds").observe(0.0)
    return reg


@pytest.mark.parametrize("exemplars", ["", "3"])
def test_snapshot_equals_jax(monkeypatch, exemplars):
    monkeypatch.setenv(EXEMPLARS, exemplars)
    got, want = _observe(metrics).snapshot(), _observe(jax_metrics).snapshot()
    assert got == want
    assert got["mpitree_registry_publish_total"] == {
        '{model="rf"}': 1.0, '{model="a\\"b"}': 2.0}
    assert metrics.MetricsRegistry().snapshot() == {}


def _fake_covtype_bunch(n=1000):
    rng = np.random.default_rng(0)
    return types.SimpleNamespace(
        data=rng.random((n, 54)).astype(np.float64),
        target=rng.integers(1, 8, size=n).astype(np.int32),
    )


def _both(call):
    """``call(module)`` for the port's and the JAX package's datasets."""
    return call(datasets), call(jax_datasets)


def test_covtype_prefers_the_sklearn_cache_and_never_downloads(monkeypatch):
    import sklearn.datasets

    calls = []

    def fake_fetch(download_if_missing=True):
        calls.append(download_if_missing)
        return _fake_covtype_bunch()

    monkeypatch.setattr(sklearn.datasets, "fetch_covtype", fake_fetch)
    (X, y, name), (Xj, yj, namej) = _both(lambda m: m.load_covtype(500))
    assert calls == [False, False]
    assert name == namej == "covtype"
    assert X.shape == (500, 54) and X.dtype == np.float32
    assert y.min() >= 0 and y.max() <= 6
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("fault", [OSError, ImportError])
def test_covtype_falls_back_to_the_generator(monkeypatch, fault):
    import sklearn.datasets

    def no_cache(download_if_missing=True):
        assert download_if_missing is False
        raise fault("covtype cache missing and download disabled")

    monkeypatch.setattr(sklearn.datasets, "fetch_covtype", no_cache)
    (X, y, name), (Xj, yj, namej) = _both(
        lambda m: m.load_covtype(2000, seed=3))
    assert name == namej == "covtype_like"
    Xg, yg = datasets.covtype_like(2000, seed=3)
    for a, b in ((X, Xj), (X, Xg), (y, yj), (y, yg)):
        np.testing.assert_array_equal(a, b)


def test_california_prefers_the_sklearn_cache(monkeypatch):
    import sklearn.datasets

    rng = np.random.default_rng(1)
    fake = types.SimpleNamespace(data=rng.random((800, 8)),
                                 target=rng.random(800) * 5)
    calls = []

    def fetch(download_if_missing=True):
        calls.append(download_if_missing)
        return fake

    monkeypatch.setattr(sklearn.datasets, "fetch_california_housing", fetch)
    (X, y, name), (Xj, yj, namej) = _both(lambda m: m.load_california(300))
    assert calls == [False, False]
    assert name == namej == "california_housing"
    assert X.shape == (300, 8) and y.dtype == np.float64
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


def test_california_falls_back(monkeypatch):
    import sklearn.datasets

    monkeypatch.setattr(
        sklearn.datasets, "fetch_california_housing",
        lambda download_if_missing=True: (_ for _ in ()).throw(OSError()))
    (X, y, name), (Xj, yj, namej) = _both(lambda m: m.load_california(1000))
    assert name == namej == "california_like"
    assert X.shape == (1000, 8)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


def test_initialize_takes_jax_timeouts_and_refuses_other_names():
    import torch.distributed as dist

    distributed.initialize(initialization_timeout=5)
    distributed.initialize(None, 1, 0, initialization_timeout=5,
                           heartbeat_timeout_seconds=7)
    assert not dist.is_initialized()
    with pytest.raises(TypeError, match="'shutdown_timeout_seconds'"):
        distributed.initialize(shutdown_timeout_seconds=3)
    with pytest.raises(TypeError, match="'bogus'"):
        distributed.initialize("localhost:1", 2, 0, bogus=1,
                               initialization_timeout=1)
    assert not dist.is_initialized()


def test_a_missing_peer_fails_the_join_within_initialization_timeout():
    """Rank 0 of two, alone: the join gives up after
    ``initialization_timeout``, not after the collectives' bound."""
    import torch.distributed as dist

    t0 = time.monotonic()
    with pytest.raises(Exception):
        distributed.initialize(f"localhost:{free_port()}", 2, 0,
                               backend="gloo", initialization_timeout=2,
                               heartbeat_timeout_seconds=600)
    assert time.monotonic() - t0 < 60
    assert not dist.is_initialized()


_PAIR = """
import sys
sys.path.insert(0, {repo!r})
import torch
port, pid = sys.argv[1], int(sys.argv[2])
from mpitree_tpu_torch.parallel import distributed
distributed.initialize(f"localhost:{{port}}", 2, pid, backend="gloo",
                       initialization_timeout=60,
                       heartbeat_timeout_seconds=30)
import torch.distributed as dist
t = torch.tensor([float(pid + 1)])
dist.all_reduce(t)
assert t.item() == 3.0, t
print(f"PROC{{pid}} OK", flush=True)
distributed.shutdown()
"""


def test_two_processes_join_with_separate_bounds(tmp_path):
    worker = tmp_path / "pair.py"
    worker.write_text(_PAIR.format(repo=_REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    results, _ = run_procs(
        lambda ports, rank: [sys.executable, str(worker), str(ports[0]),
                             str(rank)], 2, timeout=120, env=env)
    assert results is not None, "the pair hung"
    for rank, (rc, out) in enumerate(results):
        assert rc == 0 and f"PROC{rank} OK" in out, out


_ENV_PAIR = """
import os
import sys
sys.path.insert(0, {repo!r})
import torch
port, pid, agent = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2",
                  RANK=pid)
if agent:
    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
from mpitree_tpu_torch.parallel import distributed
distributed.initialize(initialization_timeout=60,
                       heartbeat_timeout_seconds=30)
import torch.distributed as dist
t = torch.tensor([float(pid) + 1.0])
dist.all_reduce(t)
assert t.item() == 3.0, t
print(f"PROC{{pid}} OK", flush=True)
distributed.shutdown()
"""


@pytest.mark.parametrize("agent", [False, True], ids=["env", "agent-store"])
def test_two_processes_join_from_the_environment_with_separate_bounds(
        tmp_path, agent):
    """A launcher's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) with the two bounds apart. With
    ``TORCHELASTIC_USE_AGENT_STORE`` (as ``torchrun`` sets it) the agent
    hosts the store on ``MASTER_PORT`` (here this process) and every
    rank joins it as a client: none binds a second server there."""
    import torch.distributed as dist

    worker = tmp_path / "env_pair.py"
    worker.write_text(_ENV_PAIR.format(repo=_REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "TORCHELASTIC_USE_AGENT_STORE"):
        env.pop(k, None)
    ports, store = None, None
    if agent:
        port = free_port()
        store = dist.TCPStore("localhost", port, 2, True,
                              wait_for_workers=False)
        ports = [port]
    try:
        results, _ = run_procs(
            lambda ports, rank: [sys.executable, str(worker), str(ports[0]),
                                 str(rank), "1" if agent else "0"],
            2, timeout=120, env=env, ports=ports,
            attempts=1 if agent else 2)
    finally:
        del store
    assert results is not None, "the pair hung"
    for rank, (rc, out) in enumerate(results):
        assert rc == 0 and f"PROC{rank} OK" in out, out
        # torch logs, and under the agent's variable ignores, a rank's
        # attempt to host a second store on the agent's port
        assert "failed to bind" not in out, out
