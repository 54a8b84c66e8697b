"""Several processes on one data mesh: ports of
``tests/test_distributed_twoprocess.py`` and
``tests/test_distributed_failures.py``.

Two processes join a localhost gloo group through
``parallel/distributed.initialize`` (the counterpart of
``jax.distributed.initialize``, and of the reference's ``mpirun -n k``),
each with 2 CPU shards: a 4-shard mesh. The trees they fit equal the host
tier's, as the JAX package's two-process test requires, the default fit's
refine tail included (every process gathers every row's leaf id), with the
replication check on. The failures are bounded: a peer that never arrives
fails ``initialize`` within its timeout, and a peer that dies after
joining fails the survivor's next collective; neither hangs. Every
subprocess has a timeout of its own; the ports and the launches come
from ``tests/_torch_twoproc.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
from _torch_twoproc import free_port, run_procs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    """One torch thread per process; replication checks on."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MPITREE_TPU_DEBUG="1")
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    return env


def _run_pair(tmp_path, source: str, timeout: float) -> list:
    """Both processes' ``(returncode, output)``; the pair runs once more
    on a fresh port if its rendezvous port was taken (``_torch_twoproc``).
    """
    worker = tmp_path / "worker.py"
    worker.write_text(source.format(repo=_REPO))
    results, _ = run_procs(
        lambda ports, pid: [sys.executable, str(worker), str(ports[0]),
                            str(pid)],
        2, timeout=timeout, env=_env(), cwd=str(tmp_path))
    if results is None:
        pytest.fail("two-process run hung")
    return results


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
info = distributed.process_info(device="cpu")
assert info == {{"process_index": pid, "process_count": 2,
                 "local_devices": 2, "global_devices": 4}}, info

import numpy as np
from mpitree_tpu_torch import DecisionTreeClassifier, DecisionTreeRegressor
from mpitree_tpu_torch.tree import ParallelDecisionTreeClassifier
from mpitree_tpu_torch.utils import profiling
from mpitree_tpu_torch.utils.datasets import covtype_like

assert ParallelDecisionTreeClassifier.WORLD_SIZE == 4
assert ParallelDecisionTreeClassifier.WORLD_RANK == pid

rng = np.random.default_rng(0)
X = rng.normal(size=(160, 4)).astype(np.float32)
y = ((X[:, 0] > 0) + (X[:, 1] > 0.3)).astype(np.int64)

dist = ParallelDecisionTreeClassifier(max_depth=4, device="cpu").fit(X, y)
host = DecisionTreeClassifier(max_depth=4, backend="host",
                              device="cpu").fit(X, y)
assert dist.export_text() == host.export_text(), "distributed tree differs"
st = stats_view(dist.fit_report_)
assert st["n_shards"] == 4 and st["allreduce_calls"] > 0, st
assert st["replication_checks"] > 0, st
assert (dist.predict_proba(X) == host.predict_proba(X)).all()

yr = (2 * X[:, 0] - X[:, 2]).astype(np.float64)
reg = DecisionTreeRegressor(max_depth=4, n_devices="all",
                            device="cpu").fit(X, yr)
href = DecisionTreeRegressor(max_depth=4, backend="host",
                             device="cpu").fit(X, yr)
assert reg.export_text() == href.export_text(), "regression tree differs"

# the default fit: a sharded crown, every row's leaf id gathered, the
# same host tail in both processes
Xc, yc = covtype_like(6_000, seed=5)
dflt = ParallelDecisionTreeClassifier(device="cpu").fit(Xc, yc)
assert stats_view(dflt.fit_report_)["refine_nodes_added"] > 0
one = DecisionTreeClassifier(device="cpu").fit(Xc, yc)
for k in ("feature", "threshold", "left", "right", "count",
          "n_node_samples", "impurity", "value"):
    assert np.array_equal(getattr(dflt.tree_, k), getattr(one.tree_, k),
                          equal_nan=True), k

# the replication check itself: the same bits pass, different ones raise
m = mesh.resolve_mesh(device="cpu", n_devices="all")
profiling.assert_replicated(torch.arange(5.0), m)
try:
    profiling.assert_replicated(torch.tensor([float(pid)]), m)
    raise SystemExit("divergent decisions passed the replication check")
except RuntimeError as e:
    assert "diverged" in str(e), e
print(f"PROC{{pid}} OK", flush=True)
distributed.shutdown()
"""


def test_two_process_gloo_fit_equals_host_tier(tmp_path):
    for pid, (rc, out) in enumerate(_run_pair(tmp_path, _WORKER, 300)):
        assert rc == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"PROC{pid} OK" in out


_LONE_WORKER = """
import sys
sys.path.insert(0, {repo!r})
from mpitree_tpu_torch.parallel import distributed

port = sys.argv[1]
try:
    distributed.initialize(f"localhost:{{port}}", 2, 0, backend="gloo",
                           timeout=10)
except Exception as e:  # noqa: BLE001 - the bounded failure is the test
    print(f"CLEAN_INIT_FAILURE {{type(e).__name__}}")
    sys.exit(3)
print("UNEXPECTED_SUCCESS")
"""


def test_missing_peer_fails_init_within_bound(tmp_path):
    """Process 0 of a declared 2-process job, its peer never arrives: the
    join fails within its timeout instead of waiting forever."""
    worker = tmp_path / "lone.py"
    worker.write_text(_LONE_WORKER.format(repo=_REPO))
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, str(worker), str(free_port())],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=_env(),
    )
    took = time.monotonic() - t0
    blob = out.stdout + out.stderr
    assert out.returncode == 3, blob[-2000:]
    assert "CLEAN_INIT_FAILURE" in blob and "UNEXPECTED" not in blob
    assert took < 90, f"init failure took {took:.0f}s: not bounded"


_SURVIVOR = """
import os, sys, time
sys.path.insert(0, {repo!r})
port, pid = sys.argv[1], int(sys.argv[2])
from mpitree_tpu_torch.parallel import distributed, mesh
mesh.set_cpu_shards(2)
distributed.initialize(f"localhost:{{port}}", 2, pid, backend="gloo",
                       timeout=30)
print(f"PROC{{pid}} JOINED", flush=True)
if pid == 1:
    time.sleep(2)
    os._exit(9)  # the host is lost after the join

time.sleep(5)  # the peer dies first
import numpy as np
from mpitree_tpu_torch.tree import ParallelDecisionTreeClassifier

rng = np.random.default_rng(0)
X = rng.normal(size=(200, 4)).astype(np.float32)
y = ((X[:, 0] > 0) + (X[:, 1] > 0.3)).astype(np.int64)
try:
    ParallelDecisionTreeClassifier(max_depth=4, device="cpu").fit(X, y)
    print("UNEXPECTED_FIT_SUCCESS", flush=True)
except RuntimeError as e:
    print(f"CLEAN_MIDFIT_FAILURE {{type(e).__name__}}", flush=True)
    sys.exit(4)
"""


def test_peer_death_after_join_is_bounded(tmp_path):
    """A process dying after the join fails the survivor's fit within a
    bound (its collective raises), never an indefinite hang."""
    t0 = time.monotonic()
    (rc0, out0), (rc1, _) = _run_pair(tmp_path, _SURVIVOR, 150)
    took = time.monotonic() - t0
    assert "PROC0 JOINED" in out0, out0[-2000:]
    assert rc1 == 9
    assert rc0 == 4 and "CLEAN_MIDFIT_FAILURE" in out0, out0[-2000:]
    assert "UNEXPECTED_FIT_SUCCESS" not in out0
    assert took < 120, f"detection took {took:.0f}s"


_REJOIN = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)

ports, pid = sys.argv[1].split(","), int(sys.argv[2])
from mpitree_tpu_torch.parallel import collective, distributed, mesh
mesh.set_cpu_shards(1)
for port in ports:
    distributed.initialize(f"localhost:{{port}}", 4, pid, backend="gloo",
                           timeout=60)
    m = mesh.as_tree_data_mesh(
        mesh.resolve_mesh(device="cpu", n_devices="all"), (2, 2))
    # the data axis pairs processes (0, 1) and (2, 3): partial subgroups
    got = collective.psum([torch.tensor([float(pid)])],
                          m.axis_mesh(mesh.DATA_AXIS))
    assert got.item() == (1.0 if pid < 2 else 5.0), got
    distributed.shutdown()
print(f"PROC{{pid}} OK", flush=True)
"""


def test_rejoined_world_gets_its_own_subgroups(tmp_path):
    """Four processes join, reduce over a (2, 2) mesh's data axis (two
    partial subgroups), leave, and join a new world: the second world's
    reductions run in its own subgroups, not the first world's."""
    worker = tmp_path / "worker.py"
    worker.write_text(_REJOIN.format(repo=_REPO))
    results, _ = run_procs(
        lambda ports, pid: [sys.executable, str(worker),
                            ",".join(map(str, ports)), str(pid)],
        4, timeout=120, env=_env(), cwd=str(tmp_path), n_ports=2)
    if results is None:
        pytest.fail("the rejoined world hung")
    for pid, (rc, out) in enumerate(results):
        assert rc == 0 and f"PROC{pid} OK" in out, \
            f"proc {pid}:\n{out[-3000:]}"
