"""A streamed forest on a ``(tree, data)`` mesh across two processes
grows from the row blocks its tree groups need, not from the whole
matrix (``ingest/place.regroup_matrix``).

Two processes join a localhost gloo group, one CPU shard each, and each
streams its half of the rows (3,001 rows: the last block carries a
padding row). Three forests:

- **aligned**: ``MPITREE_TPU_FOREST_HBM_BUDGET=1`` forces the ``(1, 2)``
  mesh, whose data axis is the ingest's: each process grows from its own
  block and receives no matrix byte (``exchange_bytes == 0``);
- **unaligned**: the default ``(2, 1)`` tree mesh, each tree group on one
  process needing every row: each process receives exactly the rows the
  other placed, never the whole ``N * F * 4`` bytes;
- **two shards a process**: a ``(2, 2)`` mesh over the 4-shard ingest,
  whose second data block of each group lies on the other process;
- **checkpointed** (one shard a process): the unaligned forest of 10
  trees with ``checkpoint=``, grown in two groups (8 and 2 trees, the
  checkpoint's floor), each a build of its own: the rows still cross
  once a fit, not once a group.

Each forest equals its in-memory keyed twin field for field in both
processes, and no ``x_binned`` a shard grows from has more rows than its
block (padded). Every subprocess has a timeout of its own; the ports
and the launches come from ``tests/_torch_twoproc.py``.
"""

from __future__ import annotations

import json
import os
import sys

import pytest
from _torch_twoproc import run_procs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F = 3001, 7

_WORKER = """
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)

port, pid, shards = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
from mpitree_tpu_torch.parallel import distributed, mesh
from mpitree_tpu_torch.obs import stats_view
mesh.set_cpu_shards(shards)
distributed.initialize(f"localhost:{{port}}", 2, pid, backend="gloo",
                       timeout=60)
from mpitree_tpu_torch import RandomForestClassifier, StreamedDataset
from mpitree_tpu_torch.ingest import place

seen = []
regroup = place.regroup_matrix


def spy(*a, **k):
    out = regroup(*a, **k)
    seen.extend(int(x.shape[0]) for x in out)
    return out


place.regroup_matrix = spy

rng = np.random.default_rng(11)
N, F = {n}, {f}
X = rng.normal(size=(N, F)).astype(np.float32)
X[:, 3] = np.round(X[:, 3], 1)
y = ((X[:, 0] > 0).astype(int) + (X[:, 1] + X[:, 3] > 0.2)).astype(int)
FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
# the ingest's blocks: rows padded to the 2 * shards data axis
block = (N + (-N) % (2 * shards)) // (2 * shards)
lo, hi = pid * shards * block, min((pid + 1) * shards * block, N)
rf = dict(n_estimators=2, max_depth=4, max_bins=32, random_state=5,
          device="cpu", refine_depth=None)
os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"] = "1"
twin = RandomForestClassifier(**rf).fit(X, y)
del os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"]
cases = [("aligned", "1", 2), ("default", None, 2)]
if shards == 1:
    os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"] = "1"
    twin10 = RandomForestClassifier(**dict(rf, n_estimators=10)).fit(X, y)
    del os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"]
    cases.append(("checkpoint", None, 10))
for case, budget, n_trees in cases:
    if budget is None:
        os.environ.pop("MPITREE_TPU_FOREST_HBM_BUDGET", None)
    else:
        os.environ["MPITREE_TPU_FOREST_HBM_BUDGET"] = budget
    seen.clear()
    kw = dict(rf, n_estimators=n_trees)
    if case == "checkpoint":
        kw["checkpoint"] = os.path.join(os.getcwd(), f"forest{{pid}}.ckpt")
    forest = RandomForestClassifier(n_devices="all", **kw).fit(
        dataset=StreamedDataset.from_arrays(X[lo:hi], y[lo:hi],
                                            chunk_rows=400))
    want = twin10 if case == "checkpoint" else twin
    same = all(np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)
               for a, b in zip(forest.trees_, want.trees_) for k in FIELDS)
    st = stats_view(forest.fit_report_)
    print("RESULT " + json.dumps(dict(
        case=case, pid=pid, shards=shards, same=bool(same),
        n_trees=len(forest.trees_), forest_mesh=st["forest_mesh"],
        exchange_bytes=int(st["exchange_bytes"]),
        exchange_calls=int(st["exchange_calls"]),
        lacking_bytes=int((N - (hi - lo)) * F * 4), rows=seen,
        regroups=len(seen) // shards)),
        flush=True)
distributed.shutdown()
"""


def _run_pair(tmp_path, shards: int) -> list:
    worker = tmp_path / f"worker{shards}.py"
    worker.write_text(_WORKER.format(repo=_REPO, n=N, f=F))
    env = dict(os.environ, OMP_NUM_THREADS="1", MPITREE_TPU_DEBUG="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "MPITREE_TPU_KEYED_BOOTSTRAP",
              "MPITREE_TPU_FOREST_HBM_BUDGET", "MPITREE_TPU_ENGINE"):
        env.pop(k, None)
    runs, _ = run_procs(
        lambda ports, pid: [sys.executable, str(worker), str(ports[0]),
                            str(pid), str(shards)],
        2, timeout=240, env=env, cwd=str(tmp_path))
    if runs is None:
        pytest.fail("two-process run hung")
    results = []
    for rc, out in runs:
        assert rc == 0, out
        results += [json.loads(line[len("RESULT "):])
                    for line in out.splitlines() if line.startswith("RESULT ")]
    assert len(results) == (6 if shards == 1 else 4), [o for _, o in runs]
    return results


@pytest.fixture(scope="module")
def one_shard(tmp_path_factory):
    """The three cases, one CPU shard a process."""
    return _run_pair(tmp_path_factory.mktemp("one"), 1)


@pytest.fixture(scope="module")
def two_shards(tmp_path_factory):
    """The default case on two CPU shards a process."""
    return _run_pair(tmp_path_factory.mktemp("two"), 2)


def _case(results, case):
    out = [r for r in results if r["case"] == case]
    assert sorted(r["pid"] for r in out) == [0, 1]
    return out


@pytest.mark.parametrize("case", ["aligned", "default"])
def test_streamed_forest_equals_in_memory_twin(one_shard, case):
    for r in _case(one_shard, case):
        assert r["same"] and r["n_trees"] == 2, r


def test_aligned_mesh_exchanges_no_matrix_byte(one_shard):
    for r in _case(one_shard, "aligned"):
        assert r["forest_mesh"] == [1, 2], r
        assert r["exchange_bytes"] == 0 and r["exchange_calls"] == 0, r


def test_unaligned_mesh_exchanges_only_the_missing_rows(one_shard):
    for r in _case(one_shard, "default"):
        assert r["forest_mesh"] == [2, 1], r
        assert 0 < r["exchange_bytes"] <= r["lacking_bytes"], r
        assert r["exchange_bytes"] < N * F * 4, r


@pytest.mark.parametrize("case,block", [("aligned", (N + 1) // 2),
                                        ("default", N)])
def test_each_shard_grows_from_its_block_only(one_shard, case, block):
    """The (1, 2) groups' shards hold half the padded rows; a (2, 1)
    group's one shard holds every row, its block."""
    for r in _case(one_shard, case):
        assert r["rows"] and max(r["rows"]) <= block, r


def test_two_shards_a_process_regroup(two_shards):
    """(2, 2) over the 4-shard ingest: equal to the twin; each process
    receives the other's half, once, for its second data block."""
    for r in _case(two_shards, "default"):
        assert r["same"] and r["forest_mesh"] == [2, 2], r
        assert 0 < r["exchange_bytes"] <= r["lacking_bytes"], r
        assert max(r["rows"]) <= -(-N // 2), r
    for r in _case(two_shards, "aligned"):
        assert r["same"] and r["forest_mesh"] == [1, 4], r
        assert r["exchange_bytes"] == 0, r
        assert max(r["rows"]) <= -(-N // 4), r


def test_checkpointed_groups_exchange_the_rows_once(one_shard):
    """Two checkpoint groups, one regroup: the forest equals its 10-tree
    twin, and the bytes received stay within the rows this process
    lacks (a regroup per group would receive them twice)."""
    for r in _case(one_shard, "checkpoint"):
        assert r["same"] and r["n_trees"] == 10, r
        assert r["forest_mesh"] == [2, 1] and r["regroups"] == 1, r
        assert 0 < r["exchange_bytes"] <= r["lacking_bytes"], r
