"""The port's checkpoints (``resilience/checkpoint.py``) against the JAX
package's (``tests/test_elastic.py``, ``tests/test_resilience.py``,
``tests/test_resilience_v2.py``), on the same seeded inputs.

- the file layout: one shard an append (never rewritten), the manifest
  last, a crash between shard and manifest recovers to the previous
  manifest, a damaged shard or another fingerprint restarts fresh,
  compaction merges with the manifest as the commit point; files written
  by either package load in the other, and the fingerprints are equal;
- forests: a fit killed after two flushed groups resumes to the forest an
  uninterrupted fit grows, which is JAX's forest field for field; a
  checkpointed fit equals a plain one; the fingerprint guards the
  inputs; a fit without a fixed seed disables it; ``warm_start`` with it
  raises; compaction;
- boosting: a fit killed at round 1, 3 or 5 resumes to the uninterrupted
  ensemble bit for bit (every staged prediction and the training
  scores), which is JAX's; early stopping resumes mid-patience and at its
  stopping round; the fingerprint, the seed rule, the parent directory,
  compaction under a kill; the fused rounds killed mid-fit resume to
  their own uninterrupted fit bit for bit (JAX's fused rounds fail on
  this container, ``ROADMAP.md`` R1).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu as J  # noqa: E402
from mpitree_tpu.resilience import checkpoint as jax_ckpt  # noqa: E402
from mpitree_tpu_torch import (  # noqa: E402
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
)
from mpitree_tpu_torch.obs import stats_view  # noqa: E402
from mpitree_tpu_torch.resilience import (  # noqa: E402
    BoostCheckpoint,
    BuildCheckpoint,
    ForestCheckpoint,
    chaos,
)
from mpitree_tpu_torch.resilience import checkpoint as ckpt_mod  # noqa: E402
from mpitree_tpu_torch.resilience.chaos import (  # noqa: E402
    ChaosKilled,
    Fault,
)

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread under the parallel test workers (the results do
    not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    chaos.clear()
    monkeypatch.delenv("MPITREE_TPU_CHAOS", raising=False)
    monkeypatch.setenv("MPITREE_TPU_BACKOFF_S", "0")
    yield
    chaos.clear()


def _data(n=400, seed=0, f=5):
    """The JAX tests' inputs."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] > 0) + 2 * (X[:, 1] > 0.3)).astype(np.int64)
    return X, y


def _same_trees(got, want, what=""):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        for k in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, k)), np.asarray(getattr(b, k)),
                err_msg=f"{what} tree {i} {k}")


@pytest.fixture(scope="module")
def trees():
    X, y = _data(300, seed=5)
    rf = RandomForestClassifier(n_estimators=6, max_depth=3, random_state=0,
                                device="cpu").fit(X, y)
    return list(rf.trees_)


# -- the file layout -------------------------------------------------------

def test_appends_are_per_group_shards(tmp_path, trees):
    path = str(tmp_path / "ck.npz")
    ck = BuildCheckpoint(path, "fp")
    ck.append(trees[:2])
    shard0 = tmp_path / "ck.npz.shard-0000.npz"
    first = shard0.read_bytes()
    ck.append(trees[2:4])
    ck.append(trees[4:6])
    assert (tmp_path / "ck.npz.shard-0002.npz").exists()
    assert shard0.read_bytes() == first, "shard 0 was rewritten"
    ck3 = BuildCheckpoint(path, "fp")
    ck3._load()
    _same_trees(ck3.trees, trees)
    with pytest.warns(UserWarning, match="not resumable"):
        ck2 = BuildCheckpoint.open(path, {"p": 1}, *_data(10), None)
    assert ck2.trees == []
    ck.done()
    assert not any(tmp_path.iterdir()), "done() sweeps manifest + shards"


def test_crash_between_shard_and_manifest(tmp_path, trees):
    path = str(tmp_path / "ck.npz")
    ck = BuildCheckpoint(path, "fp")
    ck.append(trees[:2])
    good = (tmp_path / "ck.npz").read_bytes()
    ck.append(trees[2:4])
    (tmp_path / "ck.npz").write_bytes(good)  # the manifest never moved
    ck2 = BuildCheckpoint(path, "fp")
    ck2._load()
    assert len(ck2.trees) == 2
    ck2.append(trees[2:4])  # overwrites the orphan's slot
    ck3 = BuildCheckpoint(path, "fp")
    ck3._load()
    _same_trees(ck3.trees, trees[:4])


def test_corrupt_shard_restarts_fresh(tmp_path, trees):
    path = str(tmp_path / "ck.npz")
    X, y = _data(50, seed=6)
    ck = BuildCheckpoint.open(path, {"a": 1}, X, y, None)
    ck.append(trees[:2])
    (tmp_path / "ck.npz.shard-0000.npz").write_bytes(b"garbage")
    with pytest.warns(UserWarning, match="not resumable"):
        fresh = BuildCheckpoint.open(path, {"a": 1}, X, y, None)
    assert fresh.trees == []


def test_compaction_merges_and_survives_a_crash(tmp_path, trees,
                                                monkeypatch):
    path = str(tmp_path / "c.ckpt")
    ck = BuildCheckpoint(path, "fp")
    for i in range(3):
        ck.append(trees[2 * i:2 * i + 2], {"cursor": np.int64(i)})
    assert ck.shard_count == 3 and ck.compact() and ck.shard_count == 1
    ck2 = BuildCheckpoint(path, "fp")
    ck2._load()
    _same_trees(ck2.trees, trees)
    assert int(ck2.state["cursor"]) == 2
    shards = [p for p in os.listdir(tmp_path) if ".shard-" in p]
    assert len(shards) == 1 and "merged" in shards[0]
    assert not ck.compact()
    # a crash between the merged shard and the manifest flip
    other = str(tmp_path / "d.ckpt")
    ck = BuildCheckpoint(other, "fp")
    ck.append(trees[:2])
    ck.append(trees[2:4])

    def boom(p, data):
        raise OSError("disk died mid-compaction")

    monkeypatch.setattr(ckpt_mod, "_atomic_bytes", boom)
    with pytest.raises(OSError):
        ck.compact()
    monkeypatch.undo()
    ck3 = BuildCheckpoint(other, "fp")
    ck3._load()
    assert len(ck3.trees) == 4 and ck3.shard_count == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_load_in_the_other_package(tmp_path, trees, writer):
    """One layout and ``_FORMAT``: the port reads JAX's files and JAX the
    port's, trees and state alike; the fingerprints are equal."""
    X, y = _data(80, seed=3)
    params = {"n_estimators": 6, "task": "classification"}
    assert ckpt_mod._fingerprint(params, X, y, None) == \
        jax_ckpt._fingerprint(params, X, y, None)
    path = str(tmp_path / "x.ckpt")
    W, R = ((ForestCheckpoint, jax_ckpt.ForestCheckpoint) if writer == "port"
            else (jax_ckpt.ForestCheckpoint, ForestCheckpoint))
    w = W.open(path, params, X, y, None)
    w.append(trees[:3], {"raw_tr": np.arange(3.0)})
    w.append(trees[3:], {"raw_tr": np.arange(4.0)})
    r = R.open(path, params, X, y, None)
    _same_trees(r.trees, trees, writer)
    np.testing.assert_array_equal(r.state["raw_tr"], np.arange(4.0))
    with pytest.warns(UserWarning, match="not resumable"):
        other = (BoostCheckpoint if R is ForestCheckpoint
                 else jax_ckpt.BoostCheckpoint).open(path, params, X, y,
                                                     None)
    assert other.trees == []  # another kind never resumes


# -- forests ---------------------------------------------------------------

FOREST_KW = dict(n_estimators=18, max_depth=4, random_state=7)


@pytest.fixture(scope="module")
def forest_ref():
    X, y = _data(600, seed=1)
    port = RandomForestClassifier(device="cpu", **FOREST_KW).fit(X, y)
    jax = J.RandomForestClassifier(backend="cpu", **FOREST_KW).fit(X, y)
    return X, y, port, jax


def test_forest_resume_equals_uninterrupted_and_jax(tmp_path, forest_ref,
                                                     monkeypatch):
    """18 trees flush in groups of 8; a kill after the second append
    resumes after 16 trees to the uninterrupted forest (``:148``)."""
    X, y, ref, jax_ref = forest_ref
    _same_trees(ref.trees_, jax_ref.trees_, "port vs JAX")
    ckpt = str(tmp_path / "forest.ckpt.npz")
    real = ForestCheckpoint.append
    calls = {"n": 0}

    def dying(self, new, state=None):
        real(self, new, state)
        calls["n"] += 1
        if calls["n"] >= 2:
            raise KeyboardInterrupt("preempted")

    monkeypatch.setattr(ForestCheckpoint, "append", dying)
    with pytest.raises(KeyboardInterrupt):
        RandomForestClassifier(checkpoint=ckpt, device="cpu",
                               **FOREST_KW).fit(X, y)
    monkeypatch.undo()
    assert json.loads(open(ckpt).read())["n_items"] == 16
    resumed = RandomForestClassifier(checkpoint=ckpt, device="cpu",
                                     **FOREST_KW).fit(X, y)
    assert not os.path.exists(ckpt), "a finished fit removes its checkpoint"
    _same_trees(resumed.trees_, ref.trees_, "resumed")
    np.testing.assert_array_equal(resumed.predict_proba(X),
                                  jax_ref.predict_proba(X))


def test_forest_checkpoint_fingerprint_guards_inputs(tmp_path):
    X, y = _data(500, seed=2)
    ckpt = str(tmp_path / "f.npz")
    kw = dict(n_estimators=2, max_depth=4, random_state=0, device="cpu")
    rf = RandomForestClassifier(checkpoint=ckpt, **kw).fit(X, y)
    ck = ForestCheckpoint(ckpt, "deadbeef")
    ck.append(list(rf.trees_))
    with pytest.warns(UserWarning, match="not resumable"):
        fresh = RandomForestClassifier(checkpoint=ckpt, **kw).fit(X, y)
    _same_trees(fresh.trees_, rf.trees_)
    # device and the path are not fingerprinted: the card's checkpoint
    # resumes on the CPU
    a = RandomForestClassifier(checkpoint=str(tmp_path / "a"), **kw)
    b = RandomForestClassifier(checkpoint=str(tmp_path / "b"),
                               **dict(kw, device=None))
    fa = a._open_checkpoint("classification", False, X, None, y, None)
    fb = b._open_checkpoint("classification", False, X, None, y, None)
    assert fa.fingerprint == fb.fingerprint
    fc = RandomForestClassifier(checkpoint=str(tmp_path / "c"),
                                **dict(kw, max_depth=5))._open_checkpoint(
        "classification", False, X, None, y, None)
    assert fc.fingerprint != fa.fingerprint


def test_forest_checkpoint_requires_fixed_seed_and_no_warm_start(tmp_path):
    X, y = _data(300, seed=4)
    ckpt = str(tmp_path / "no-seed.npz")
    with pytest.warns(UserWarning, match="fixed integer random_state"):
        RandomForestClassifier(n_estimators=2, max_depth=3, checkpoint=ckpt,
                               device="cpu").fit(X, y)
    assert not os.path.exists(ckpt)
    with pytest.raises(ValueError, match="mutually exclusive"):
        RandomForestClassifier(n_estimators=2, checkpoint=ckpt,
                               warm_start=True, random_state=0,
                               device="cpu").fit(X, y)


@pytest.mark.parametrize("engine", ["fused", "levelwise"])
def test_checkpointed_equals_uncheckpointed(tmp_path, monkeypatch, engine):
    """Both build paths (the batched fused groups and the per-tree
    levelwise builds) flush in groups and grow the plain forest."""
    monkeypatch.setenv("MPITREE_TPU_ENGINE", engine)
    X, y = _data(500, seed=3)
    kw = dict(n_estimators=11, max_depth=5, random_state=1, device="cpu")
    plain = RandomForestClassifier(**kw).fit(X, y)
    ck = RandomForestClassifier(checkpoint=str(tmp_path / "c.npz"),
                                **kw).fit(X, y)
    _same_trees(ck.trees_, plain.trees_)
    assert stats_view(ck.fit_report_)["ensemble_path"] == (
        "batched-fused" if engine == "fused" else "per-tree")


def test_forest_checkpoint_compact_every(tmp_path):
    X, y = _data(300, seed=4)
    kw = dict(n_estimators=17, max_depth=3, random_state=0, device="cpu")
    ref = RandomForestClassifier(**kw).fit(X, y)
    path = str(tmp_path / "forest.ckpt")
    clf = RandomForestClassifier(checkpoint=path, checkpoint_compact_every=2,
                                 **kw).fit(X, y)
    assert stats_view(clf.fit_report_).get("checkpoint_compactions", 0) >= 1
    assert not os.path.exists(path)
    np.testing.assert_array_equal(clf.predict(X), ref.predict(X))


# -- boosting --------------------------------------------------------------

GB_KW = dict(max_iter=6, max_depth=3, random_state=3, subsample=0.8,
             colsample_bytree=0.8, checkpoint_every=2)


@pytest.fixture(scope="module")
def gb_ref():
    X, y = _data(500, seed=2)
    y = (y >= 2).astype(np.int64)  # binary: JAX's ensemble field for field
    port = GradientBoostingClassifier(device="cpu", **GB_KW).fit(X, y)
    jax = J.GradientBoostingClassifier(backend="cpu", **GB_KW).fit(X, y)
    return X, y, port, jax


@pytest.mark.parametrize("kill_round", [1, 3, 5])
def test_gbdt_resume_bit_identical(tmp_path, gb_ref, kill_round):
    """Killed at round k (``:408``), resumed: every staged probability and
    the training scores equal the uninterrupted fit's bit for bit, whose
    trees are JAX's."""
    X, y, ref, jax_ref = gb_ref
    _same_trees(ref.trees_, jax_ref.trees_, "port vs JAX")
    path = str(tmp_path / "gb.ckpt")
    chaos.install([Fault("round", kill_round + 1, "kill")])
    with pytest.raises(ChaosKilled):
        GradientBoostingClassifier(checkpoint=path, device="cpu",
                                   **GB_KW).fit(X, y)
    chaos.clear()
    assert os.path.exists(path) == (kill_round >= 2)
    resumed = GradientBoostingClassifier(checkpoint=path, device="cpu",
                                         **GB_KW).fit(X, y)
    assert not os.path.exists(path)
    assert resumed.n_iter_ == ref.n_iter_
    assert stats_view(resumed.fit_report_).get("resumed_rounds", 0) == (
        kill_round // 2 * 2)
    for a, b in zip(resumed.staged_predict_proba(X),
                    ref.staged_predict_proba(X)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(resumed.train_score_, ref.train_score_)
    np.testing.assert_array_equal(resumed.decision_function(X),
                                  jax_ref.decision_function(X))


def test_gbdt_multiclass_resume_bit_identical(tmp_path):
    X, y = _data(400, seed=9)
    kw = dict(GB_KW, max_iter=4)
    ref = GradientBoostingClassifier(device="cpu", **kw).fit(X, y)
    path = str(tmp_path / "mc.ckpt")
    chaos.install([Fault("round", 4, "kill")])
    with pytest.raises(ChaosKilled):
        GradientBoostingClassifier(checkpoint=path, device="cpu",
                                   **kw).fit(X, y)
    chaos.clear()
    resumed = GradientBoostingClassifier(checkpoint=path, device="cpu",
                                         **kw).fit(X, y)
    np.testing.assert_array_equal(resumed.decision_function(X),
                                  ref.decision_function(X))


ES_KW = dict(max_iter=25, max_depth=2, random_state=5, early_stopping=True,
             validation_fraction=0.25, n_iter_no_change=3)


def test_gbdt_resume_early_stopping_state(tmp_path):
    X, y = _data(500, seed=7)
    kw = dict(ES_KW, checkpoint_every=2)
    ref = GradientBoostingClassifier(device="cpu", **kw).fit(X, y)
    path = str(tmp_path / "gb-es.ckpt")
    chaos.install([Fault("round", 5, "kill")])
    with pytest.raises(ChaosKilled):
        GradientBoostingClassifier(checkpoint=path, device="cpu",
                                   **kw).fit(X, y)
    chaos.clear()
    resumed = GradientBoostingClassifier(checkpoint=path, device="cpu",
                                         **kw).fit(X, y)
    assert resumed.n_iter_ == ref.n_iter_
    np.testing.assert_array_equal(resumed.validation_score_,
                                  ref.validation_score_)
    np.testing.assert_array_equal(resumed.predict_proba(X),
                                  ref.predict_proba(X))


def test_gbdt_resume_at_early_stop_round_does_not_overtrain(tmp_path,
                                                            monkeypatch):
    X, y = _data(500, seed=12)
    kw = dict(ES_KW, checkpoint_every=1)
    ref = GradientBoostingClassifier(device="cpu", **kw).fit(X, y)
    assert ref.n_iter_ < 25, "the workload must stop early"
    path = str(tmp_path / "gb-window.ckpt")
    monkeypatch.setattr(BoostCheckpoint, "done", lambda self: None)
    GradientBoostingClassifier(checkpoint=path, device="cpu",
                               **kw).fit(X, y)
    assert os.path.exists(path), "a kill before the cleanup"
    monkeypatch.undo()
    resumed = GradientBoostingClassifier(checkpoint=path, device="cpu",
                                         **kw).fit(X, y)
    assert resumed.n_iter_ == ref.n_iter_, "resume must not overtrain"
    np.testing.assert_array_equal(resumed.validation_score_,
                                  ref.validation_score_)


def test_gbdt_checkpoint_guards(tmp_path):
    """The fingerprint (other targets restart), the seed rule (a numpy
    generator disables it) and the parent directory (made at open)."""
    X, y = _data(300, seed=8)
    path = str(tmp_path / "gb-fp.ckpt")
    kw = dict(max_iter=4, max_depth=2, random_state=1, checkpoint_every=1,
              device="cpu")
    chaos.install([Fault("round", 3, "kill")])
    with pytest.raises(ChaosKilled):
        GradientBoostingClassifier(checkpoint=path, **kw).fit(X, y)
    chaos.clear()
    y2 = (y + 1) % 3
    with pytest.warns(UserWarning, match="not resumable"):
        fresh = GradientBoostingClassifier(checkpoint=path, **kw).fit(X, y2)
    ref = GradientBoostingClassifier(**kw).fit(X, y2)
    np.testing.assert_array_equal(fresh.predict_proba(X),
                                  ref.predict_proba(X))
    rng_path = str(tmp_path / "gb-rng.ckpt")
    with pytest.warns(UserWarning, match="reproducible"):
        GradientBoostingClassifier(
            max_iter=2, max_depth=2, device="cpu", checkpoint=rng_path,
            random_state=np.random.default_rng(0)).fit(X, y)
    assert not os.path.exists(rng_path)
    deep = str(tmp_path / "not" / "yet" / "there" / "gb.ckpt")
    est = GradientBoostingClassifier(
        max_iter=2, max_depth=2, random_state=0, device="cpu",
        checkpoint=deep, checkpoint_every=1).fit(X, y)
    assert est.n_iter_ == 2


def test_gbdt_compaction_survives_kill(tmp_path):
    X, y = _data(400, seed=9)
    yr = X[:, 0] * 2.0 + np.sin(X[:, 1])
    kw = dict(max_iter=10, max_depth=2, random_state=0, checkpoint_every=1,
              device="cpu")
    ref = GradientBoostingRegressor(**kw).fit(X, yr)
    path = str(tmp_path / "gb.ckpt")
    chaos.install([Fault("round", 8, "kill")])
    with pytest.raises(ChaosKilled):
        GradientBoostingRegressor(checkpoint=path,
                                  checkpoint_compact_every=3,
                                  **kw).fit(X, yr)
    chaos.clear()
    manifest = json.loads(open(path).read())
    assert len(manifest["shards"]) < 7
    assert any("merged" in sh["file"] for sh in manifest["shards"])
    resumed = GradientBoostingRegressor(checkpoint=path,
                                        checkpoint_compact_every=3,
                                        **kw).fit(X, yr)
    assert not os.path.exists(path)
    for a, b in zip(resumed.staged_predict(X), ref.staged_predict(X)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kill_dispatch", [2, 3])
def test_fused_rounds_resume_bit_identical(tmp_path, kill_dispatch):
    """K = 4 rounds a dispatch, a flush after every dispatch that crosses
    a multiple of 4 rounds: killed in dispatch 2 or 3, resumed, every
    staged margin equals the uninterrupted fused fit's bit for bit."""
    X, _ = _data(500, seed=8)
    yr = X[:, 0] * 2.0 + np.sin(X[:, 1])
    kw = dict(max_iter=12, max_depth=3, rounds_per_dispatch=4,
              random_state=0, subsample=0.8, checkpoint_every=4,
              device="cpu")
    ref = GradientBoostingRegressor(**kw).fit(X, yr)
    assert stats_view(ref.fit_report_)["dispatches"] == 3
    path = str(tmp_path / "fused.ckpt")
    chaos.install([Fault("fused_rounds", kill_dispatch, "kill")])
    with pytest.raises(ChaosKilled):
        GradientBoostingRegressor(checkpoint=path, **kw).fit(X, yr)
    chaos.clear()
    resumed = GradientBoostingRegressor(checkpoint=path, **kw).fit(X, yr)
    assert stats_view(resumed.fit_report_)["resumed_rounds"] == 4 * (kill_dispatch - 1)
    assert stats_view(resumed.fit_report_)["dispatches"] == 4 - kill_dispatch
    for a, b in zip(resumed.staged_predict(X), ref.staged_predict(X)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(resumed.train_score_, ref.train_score_)
