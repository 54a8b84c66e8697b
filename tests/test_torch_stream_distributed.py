"""Streamed fits across two processes (``tests/test_ingest.py``'s
multi-host contract, on ``torch.distributed`` with gloo).

Two processes join a localhost gloo group, each with 2 CPU shards (a
4-shard data mesh), and each streams only its half of the shard files
(``shard_for_process``). The sketches merge in rank order, the targets
are all-gathered, and each process places only its row blocks:

- the tree and the forest equal the one-process fits (the forest's keyed
  in-memory twin) field for field in both processes;
- a process whose rows do not cover its row blocks raises, and the other
  goes on;
- non-numeric labels across processes raise in both.

Every subprocess has a timeout of its own; the ports and the launches
come from ``tests/_torch_twoproc.py``.
"""

from __future__ import annotations

import os
import sys

import pytest
from _torch_twoproc import run_procs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_pair(tmp_path, source: str, timeout: float) -> list:
    """Both processes' ``(returncode, output)``; the pair runs once more
    on a fresh port if its rendezvous port was taken (``_torch_twoproc``).
    """
    worker = tmp_path / "worker.py"
    worker.write_text(source.format(repo=_REPO))
    env = dict(os.environ, OMP_NUM_THREADS="1", MPITREE_TPU_DEBUG="1")
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    env.pop("MPITREE_TPU_KEYED_BOOTSTRAP", None)
    results, _ = run_procs(
        lambda ports, pid: [sys.executable, str(worker), str(ports[0]),
                            str(pid)],
        2, timeout=timeout, env=env, cwd=str(tmp_path))
    if results is None:
        pytest.fail("two-process run hung")
    return results


_HEAD = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)

port, pid = sys.argv[1], int(sys.argv[2])
from mpitree_tpu_torch.parallel import distributed, mesh
from mpitree_tpu_torch.obs import stats_view
mesh.set_cpu_shards(2)
distributed.initialize(f"localhost:{{port}}", 2, pid, backend="gloo",
                       timeout=60)
from mpitree_tpu_torch import (DecisionTreeClassifier,
                               ParallelDecisionTreeClassifier,
                               RandomForestClassifier, StreamedDataset)
from mpitree_tpu_torch.ingest import shard_for_process

rng = np.random.default_rng(7)
N, F = 4000, 7
X = rng.normal(size=(N, F)).astype(np.float32)
X[:, 2] = np.round(X[:, 2], 1)
y = ((X[:, 0] > 0).astype(int) + (X[:, 1] + X[:, 2] > 0.3)).astype(int)
FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


def same(a, b, what):
    for k in FIELDS:
        assert np.array_equal(getattr(a, k), getattr(b, k),
                              equal_nan=True), (what, k)
"""

_FITS = _HEAD + """
# four shard files of 1,000 rows; each process streams its two
xps, yps = [], []
for i in range(4):
    xp, yp = f"x{{i}}.npy", f"y{{i}}.npy"
    if pid == 0:
        np.save(xp + ".tmp.npy", X[i * 1000:(i + 1) * 1000])
        np.save(yp + ".tmp.npy", y[i * 1000:(i + 1) * 1000])
        os.replace(xp + ".tmp.npy", xp)
        os.replace(yp + ".tmp.npy", yp)
    xps.append(xp)
    yps.append(yp)
torch.distributed.barrier()
mine_x, mine_y = shard_for_process(xps), shard_for_process(yps)
assert mine_x == xps[2 * pid:2 * pid + 2], mine_x

kw = dict(max_depth=5, max_bins=32, device="cpu", refine_depth=None)
par = ParallelDecisionTreeClassifier(**kw).fit(
    StreamedDataset.from_npy(mine_x, mine_y, chunk_rows=333))
one = DecisionTreeClassifier(**kw).fit(X, y)
same(par.tree_, one.tree_, "tree")
st = par.ingest_stats_
assert st["rows"] == N and st["rows_local"] == N // 2, st
assert stats_view(par.fit_report_)["n_shards"] == 4

rf = dict(n_estimators=4, max_depth=4, max_bins=32, random_state=3,
          device="cpu", refine_depth=None)
forest = RandomForestClassifier(n_devices="all", **rf).fit(
    dataset=StreamedDataset.from_npy(mine_x, mine_y, chunk_rows=500))
os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"] = "1"
twin = RandomForestClassifier(**rf).fit(X, y)
del os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"]
for i, (a, b) in enumerate(zip(forest.trees_, twin.trees_)):
    same(a, b, f"forest tree {{i}}")
assert stats_view(forest.fit_report_)["exchange_calls"] > 0
print("OK", pid)
"""


def test_two_processes_stream_disjoint_shards(tmp_path):
    out = _run_pair(tmp_path, _FITS, timeout=300)
    for rc, text in out:
        assert rc == 0, text
        assert "OK" in text, text


_REFUSALS = _HEAD + """
from mpitree_tpu_torch.ingest import ingest_dataset

m = mesh.resolve_mesh(device="cpu", n_devices="all")
# uneven halves: process 1's first rows belong to process 0's last block
half = 1800 if pid == 0 else 2200
lo = 0 if pid == 0 else 1800
ds = StreamedDataset.from_arrays(X[lo:lo + half], y[lo:lo + half],
                                 chunk_rows=700)
try:
    ingest_dataset(ds, mesh=m, max_bins=32)
    print("PLACED", pid)
except ValueError as e:
    assert "row block 1 got 800 rows, expected 1000" in str(e), e
    print("REFUSED", pid)

labels = np.array(["a", "b"])[y[2000 * pid:2000 * (pid + 1)] % 2]
ds = StreamedDataset.from_arrays(X[2000 * pid:2000 * (pid + 1)], labels)
try:
    ingest_dataset(ds, mesh=m, max_bins=32)
    print("GATHERED", pid)
except TypeError as e:
    assert "numeric targets" in str(e), e
    print("NONNUMERIC", pid)
"""


def test_uncovered_blocks_and_text_labels_refused(tmp_path):
    (rc0, out0), (rc1, out1) = _run_pair(tmp_path, _REFUSALS, timeout=180)
    assert rc0 == 0, out0
    assert rc1 == 0, out1
    assert "REFUSED 0" in out0 and "PLACED 1" in out1
    assert "NONNUMERIC 0" in out0 and "NONNUMERIC 1" in out1
