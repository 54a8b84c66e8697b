"""The port's resilience ladder (``mpitree_tpu_torch.resilience``) against
the JAX package's (``tests/test_elastic.py``, ``tests/test_resilience.py``,
``tests/test_resilience_v2.py``), on the same seeded inputs.

- classification: the chain-walk cases of ``tests/test_resilience.py``
  with CUDA and ``torch.distributed`` shapes in place of gRPC ones, and
  the fault-class table of ``resilience/failure.py`` on real torch
  exception types with CUDA/NCCL message text;
- the config: ``backoff_delay`` equals JAX's for the same salt,
  ``ResilienceConfig.from_env``, the knobs' registry entries and
  ``resolve_level_retry`` read the environment alike, and
  ``SnapshotSlot``'s per-position budget;
- under the same chaos plan (each package's own), the port's tree,
  forest or ensemble equals JAX's field for field and the rung counts
  (``device_retries``, ``level_retries``, ``device_failovers``) are
  equal: a transient blip retried, a spent budget, a terminal fault to
  the host rung, single trees, regressors and forest groups, the retry
  budget knob, ``MPITREE_TPU_ELASTIC=0``, a collective seam (every test
  sets ``MPITREE_TPU_ELASTIC=1``, JAX's default, unless it says
  otherwise); with the knob unset, the port's default, a terminal fault
  or a spent budget raises its classified error and nothing runs on the
  host tier; the
  levelwise engine resumed from a killed level on an 8-shard and a
  ``(4, 2)`` mesh and the host-stepped best-first engine from a killed
  expansion, each re-running only the levels or expansions from there;
  a boosting round's build resumed at its level; the non-finite guard;
- the fused rounds, held against themselves (JAX's fail here, R1): a
  blip inside dispatch 2 re-runs that dispatch only, bit for bit;
- serving: a ``serving_dispatch`` blip answers bit for bit and counts one
  in ``mpitree_serving_retries_total``; a ``sched_dispatch`` blip
  requeues once and every answer equals a direct ``raw``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu as J  # noqa: E402
from mpitree_tpu.config import knobs as jax_knobs  # noqa: E402
from mpitree_tpu.resilience import chaos as jax_chaos  # noqa: E402
from mpitree_tpu.resilience import config as jax_config  # noqa: E402
from mpitree_tpu.resilience import recovery as jax_recovery  # noqa: E402
from mpitree_tpu_torch import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
    compile_model,
)
from mpitree_tpu_torch.config import knobs  # noqa: E402
from mpitree_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from mpitree_tpu_torch.resilience import (  # noqa: E402
    ResilienceConfig,
    SnapshotSlot,
    backoff_delay,
    chaos,
    device_failover,
    is_device_failure,
    is_oom_failure,
    is_transient_failure,
    resolve_level_retry,
    retry_device,
)
from mpitree_tpu_torch.resilience.chaos import Fault  # noqa: E402
from mpitree_tpu_torch.resilience.config import (  # noqa: E402
    elastic_enabled,
    host_failover_enabled,
)
from mpitree_tpu_torch.serving.scheduler import Scheduler  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")
RUNGS = ("device_retries", "level_retries", "device_failovers")
AcceleratorError = getattr(torch, "AcceleratorError", RuntimeError)
DistNetworkError = torch.distributed.DistNetworkError
DistBackendError = torch.distributed.DistBackendError


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No plan, zero backoff, the whole ladder in both packages (JAX's
    default, the port's ``MPITREE_TPU_ELASTIC=1``); the outer env's
    knobs must not leak in."""
    for mod in (chaos, jax_chaos):
        mod.clear()
    for k in ("MPITREE_TPU_CHAOS", "MPITREE_TPU_ENGINE",
              "MPITREE_TPU_RETRIES", "MPITREE_TPU_LEVEL_RETRY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MPITREE_TPU_ELASTIC", "1")
    monkeypatch.setenv("MPITREE_TPU_BACKOFF_S", "0")
    yield
    for mod in (chaos, jax_chaos):
        mod.clear()


@pytest.fixture
def shards8():
    prev = mesh_lib.set_cpu_shards(8)
    yield
    mesh_lib.set_cpu_shards(prev)


def _data(n=400, seed=0, f=5):
    """``tests/test_resilience.py``'s inputs."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = ((X[:, 0] > 0) + 2 * (X[:, 1] > 0.3)).astype(np.int64)
    return X, y


def _noise(n=600, f=6, seed=0):
    """``tests/test_resilience_v2.py``'s: a noise target grows full-depth
    trees (every level runs)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    return X, rng.integers(0, 4, size=n)


def _same_tree(a, b, what=""):
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)),
                                      err_msg=f"{what} {k}")


def _rungs(stats) -> dict:
    return {k: stats.get(k, 0) for k in RUNGS}


def _jax_rungs(est) -> dict:
    c = est.fit_report_["counters"]
    return {k: c.get(k, 0) for k in RUNGS}


def _both(spec, port_fit, jax_fit):
    """Fit under ``spec`` in each package (each its own chaos plan)."""
    chaos.install(spec)
    jax_chaos.install(spec)
    with pytest.warns(UserWarning):
        p = port_fit()
        j = jax_fit()
    chaos.clear()
    jax_chaos.clear()
    return p, j


# -- classification -------------------------------------------------------

def _chained(outer, inner, cause=True):
    if cause:
        outer.__cause__ = inner
    else:
        outer.__context__ = inner
    return outer


def test_chained_device_failure_recovers_cause():
    wrapped = _chained(RuntimeError("dispatch failed"),
                       DistNetworkError("Connection reset by peer"))
    assert is_device_failure(wrapped) and is_transient_failure(wrapped)
    ctx = _chained(RuntimeError("while handling"),
                   DistBackendError("Watchdog caught collective operation "
                                    "timeout: WorkNCCL(SeqNum=7) ran for "
                                    "600000 milliseconds"), cause=False)
    assert is_device_failure(ctx) and is_transient_failure(ctx)
    deep = _chained(RuntimeError("outer"), _chained(
        RuntimeError("mid"), AcceleratorError(
            "CUDA error: an illegal memory access was encountered")))
    assert is_device_failure(deep) and not is_transient_failure(deep)


def test_chained_walk_never_swallows_user_errors():
    bug = _chained(ValueError("bad reshape in recovery path"),
                   DistNetworkError("Connection reset by peer"), cause=False)
    assert not is_device_failure(bug) and not is_transient_failure(bug)
    mid = _chained(KeyError("missing"),
                   DistNetworkError("Connection reset by peer"), cause=False)
    assert not is_device_failure(_chained(RuntimeError("wrapper"), mid))


def test_chained_walk_honors_suppressed_context():
    try:
        try:
            raise DistNetworkError("Connection reset by peer")
        except DistNetworkError:
            raise RuntimeError("invalid tree state") from None
    except RuntimeError as e:
        severed = e
    assert severed.__context__ is not None
    assert not is_device_failure(severed)
    assert not is_transient_failure(severed)


def test_chained_walk_is_cycle_safe_and_bounded():
    e = RuntimeError("self-referential")
    e.__cause__ = e
    assert not is_device_failure(e)
    head = node = RuntimeError("link 0")
    for i in range(1, 12):
        nxt = RuntimeError(f"link {i}")
        node.__cause__ = nxt
        node = nxt
    node.__cause__ = DistNetworkError("Connection reset by peer")
    assert not is_device_failure(head)


@pytest.mark.parametrize("exc,dev,transient,oom", [
    (DistNetworkError("Connection reset by peer"), True, True, False),
    (RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] "
                  "Connection closed by peer [127.0.0.1]:29500"),
     True, True, False),
    (DistBackendError("NCCL error in: ProcessGroupNCCL.cpp:1970, remote "
                      "process exited or there was a network error"),
     True, True, False),
    (DistBackendError("Watchdog caught collective operation timeout: "
                      "WorkNCCL(SeqNum=1, OpType=ALLREDUCE) ran for 600009 "
                      "milliseconds before timing out."), True, True, False),
    (RuntimeError("[../third_party/gloo/gloo/transport/tcp/unbound_buffer."
                  "cc:81] Timed out waiting 60000ms for recv operation to "
                  "complete"), True, True, False),
    (ConnectionResetError("peer"), True, True, False),
    (DistBackendError("NCCL communicator was aborted on rank 1."),
     True, False, False),
    (AcceleratorError("CUDA error: an illegal memory access was "
                      "encountered\nCUDA kernel errors might be "
                      "asynchronously reported"), True, False, False),
    (AcceleratorError("CUDA error: unspecified launch failure"),
     True, False, False),
    (AcceleratorError("CUDA error: uncorrectable ECC error encountered"),
     True, False, False),
    (RuntimeError("CUDA error: misaligned address"), True, False, False),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 "
                            "GiB. GPU 0 has a total capacity of 79.19 GiB"),
     True, False, True),
    (AcceleratorError("CUDA error: out of memory"), True, False, True),
    # program bugs and user errors re-raise
    (AcceleratorError("CUDA error: device-side assert triggered"),
     False, False, False),
    (AcceleratorError("CUDA error: invalid configuration argument"),
     False, False, False),
    (DistBackendError("NCCL error: invalid usage"), False, False, False),
    (RuntimeError("some logic bug"), False, False, False),
    (OSError("No space left on device"), False, False, False),
    (ValueError("Connection reset by peer"), False, False, False),
    (KeyError("x"), False, False, False),
])
def test_fault_classes(exc, dev, transient, oom):
    assert (is_device_failure(exc), is_transient_failure(exc),
            is_oom_failure(exc)) == (dev, transient, oom)


def test_terminal_wins_over_a_transient_token():
    """A sticky error that also names the socket it was reading is still
    terminal, as JAX's INTERNAL over its PJRT token."""
    e = AcceleratorError("CUDA error: an illegal memory access was "
                         "encountered (Connection reset by peer)")
    assert is_device_failure(e) and not is_transient_failure(e)


# -- config, knobs, recovery units ----------------------------------------

@pytest.mark.parametrize("base,cap,key", [(0.5, 2.0, 0), (0.5, 8.0, 3),
                                          (0.0, 8.0, 0), (1.25, 4.0, 11)])
@pytest.mark.parametrize("salt", ["", "s", "gbdt round 3 tree build#sub"])
def test_backoff_delay_equals_jax(base, cap, key, salt):
    for a in range(6):
        assert backoff_delay(
            ResilienceConfig(backoff_base_s=base, backoff_cap_s=cap,
                             jitter_key=key), a, salt=salt) == \
            jax_config.backoff_delay(jax_config.ResilienceConfig(
                backoff_base_s=base, backoff_cap_s=cap, jitter_key=key),
                a, salt=salt)


@pytest.mark.parametrize("retries,backoff", [
    (None, None), ("0", "0"), ("5", "1.5"), ("-1", "x"), ("abc", "")])
def test_config_from_env_equals_jax(monkeypatch, retries, backoff):
    for name, v in (("MPITREE_TPU_RETRIES", retries),
                    ("MPITREE_TPU_BACKOFF_S", backoff)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = ResilienceConfig.from_env()
        n = len(seen)
        want = jax_config.ResilienceConfig.from_env()
    assert (got.max_retries, got.backoff_base_s) == (
        want.max_retries, want.backoff_base_s)
    assert n == len(seen) - n, "a malformed value warns alike"


@pytest.mark.parametrize("name", [
    "MPITREE_TPU_ELASTIC", "MPITREE_TPU_RETRIES", "MPITREE_TPU_BACKOFF_S",
    "MPITREE_TPU_LEVEL_RETRY", "MPITREE_TPU_CHAOS"])
def test_knobs_registered_like_jax(monkeypatch, name):
    """Every field as in JAX but ELASTIC's default: JAX's True takes the
    host rung, the port's None leaves it to an explicit ``1``."""
    a, b = knobs.REGISTRY[name], jax_knobs.REGISTRY[name]
    if name == "MPITREE_TPU_ELASTIC":
        assert (a.default, b.default) == (None, True)
    else:
        assert a.default == b.default
    assert (a.kind, a.choices, a.doc) == (b.kind, b.choices, b.doc)
    for raw in ("0", "1", "2", "on", "off"):
        monkeypatch.setenv(name, raw)
        try:
            want = jax_knobs.value(name)
        except ValueError:
            with pytest.raises(ValueError):
                knobs.value(name)
            continue
        assert knobs.value(name) == want


def test_level_retry_and_elastic_steer_like_jax(monkeypatch):
    """The knob alone steers the snapshots, as it steers JAX's "auto";
    the ladder's on/off reads ``MPITREE_TPU_ELASTIC`` as JAX's does once
    it is set, while unset keeps the retry rungs and drops the host rung
    (the port's default)."""
    assert resolve_level_retry()
    for raw in ("off", "on", "auto"):
        monkeypatch.setenv("MPITREE_TPU_LEVEL_RETRY", raw)
        assert resolve_level_retry() == jax_recovery.resolve_level_retry(
            "auto") == (raw != "off")
    monkeypatch.setenv("MPITREE_TPU_LEVEL_RETRY", "maybe")
    for resolve in (resolve_level_retry,
                    lambda: jax_recovery.resolve_level_retry("auto")):
        with pytest.raises(ValueError):
            resolve()
    monkeypatch.delenv("MPITREE_TPU_ELASTIC", raising=False)
    assert elastic_enabled() and not host_failover_enabled()
    for raw in ("1", "0", "true"):
        monkeypatch.setenv("MPITREE_TPU_ELASTIC", raw)
        assert elastic_enabled() == host_failover_enabled() == \
            jax_config.elastic_enabled()


def test_snapshot_slot_budget_equals_jax():
    for Slot in (SnapshotSlot, jax_recovery.SnapshotSlot):
        slot = Slot()
        slot.save("level", 3, {})
        seq = [slot.note_retry(2), slot.note_retry(2)]
        slot.save("level", 5, {})  # progress: a fresh budget
        seq += [slot.note_retry(2), slot.note_retry(2), slot.note_retry(2)]
        assert seq == [True, True, True, True, False]
        assert slot.total_retries == 4 and slot.snapshot is None


def test_user_error_reraises_through_ladder():
    def dev():
        raise ValueError("user bug")

    with pytest.raises(ValueError, match="user bug"):
        device_failover(dev, lambda: None, what="test")
    with pytest.raises(ValueError, match="user bug"):
        retry_device(dev, what="test")


def test_unclassified_error_reraises_and_host_rung_needs_failure():
    calls = []

    def dev():
        raise RuntimeError("some logic bug")

    with pytest.raises(RuntimeError, match="logic bug"):
        device_failover(dev, lambda: calls.append(1), what="test")
    assert not calls


# -- the ladder on fits, against JAX ---------------------------------------

TREE_KW = dict(max_depth=5, refine_depth=None)


@pytest.fixture(scope="module")
def tree_ref():
    X, y = _data()
    port = DecisionTreeClassifier(device="cpu", **TREE_KW).fit(X, y)
    jax = J.DecisionTreeClassifier(backend="cpu", **TREE_KW).fit(X, y)
    _same_tree(port.tree_, jax.tree_, "healthy")
    return X, y, port


@pytest.mark.parametrize("spec,rungs,engine", [
    ("dispatch:1:unavailable", (1, 0, 0), "fused"),
    ("dispatch:1:deadline", (1, 0, 0), "fused"),
    ("dispatch:1:unavailable;dispatch:2:unavailable;dispatch:3:unavailable",
     (2, 0, 1), "host"),
    ("dispatch:1:internal", (0, 0, 1), "host"),
    ("dispatch:1:data_loss", (0, 0, 1), "host"),
    ("dispatch:1:oom", (0, 0, 1), "host"),
])
def test_single_tree_ladder_equals_jax(tree_ref, spec, rungs, engine):
    """``tests/test_elastic.py:66`` and ``tests/test_resilience.py:217-281``
    under one plan each: same tree, same rung counts."""
    X, y, healthy = tree_ref
    p, j = _both(spec,
                 lambda: DecisionTreeClassifier(device="cpu",
                                                **TREE_KW).fit(X, y),
                 lambda: J.DecisionTreeClassifier(backend="cpu",
                                                  **TREE_KW).fit(X, y))
    _same_tree(p.tree_, healthy.tree_, spec)
    _same_tree(p.tree_, j.tree_, spec)
    assert _rungs(p.fit_stats_) == _jax_rungs(j) == dict(zip(RUNGS, rungs))
    assert p.fit_stats_["engine"] == engine


def test_single_tree_failover_regressor(tree_ref):
    """``tests/test_elastic.py:86``: DATA_LOSS, the host rung, the same
    predictions as the healthy fits."""
    X, _, _ = tree_ref
    yr = (X[:, 0] * 2 + np.sin(X[:, 1])).astype(np.float64)
    kw = dict(max_depth=5, refine_depth=None)
    healthy = J.DecisionTreeRegressor(backend="cpu", **kw).fit(X, yr)
    p, j = _both("dispatch:1:data_loss",
                 lambda: DecisionTreeRegressor(device="cpu", **kw).fit(X, yr),
                 lambda: J.DecisionTreeRegressor(backend="cpu",
                                                 **kw).fit(X, yr))
    np.testing.assert_array_equal(p.predict(X), healthy.predict(X))
    np.testing.assert_array_equal(p.predict(X), j.predict(X))
    assert _rungs(p.fit_stats_) == _jax_rungs(j)
    assert p.fit_stats_["engine"] == "host"


def test_retries_env_and_elastic_off(tree_ref, monkeypatch):
    X, y, healthy = tree_ref
    monkeypatch.setenv("MPITREE_TPU_RETRIES", "0")
    p, j = _both("dispatch:1:unavailable",
                 lambda: DecisionTreeClassifier(device="cpu",
                                                **TREE_KW).fit(X, y),
                 lambda: J.DecisionTreeClassifier(backend="cpu",
                                                  **TREE_KW).fit(X, y))
    assert _rungs(p.fit_stats_) == _jax_rungs(j) == dict(
        device_retries=0, level_retries=0, device_failovers=1)
    _same_tree(p.tree_, healthy.tree_)
    monkeypatch.delenv("MPITREE_TPU_RETRIES")
    monkeypatch.setenv("MPITREE_TPU_ELASTIC", "0")
    chaos.install("dispatch:1:unavailable")
    with pytest.raises(DistNetworkError):
        DecisionTreeClassifier(device="cpu", **TREE_KW).fit(X, y)


@pytest.mark.parametrize("est", ["tree", "regressor", "forest"])
@pytest.mark.parametrize("spec,exc", [
    ("dispatch:1:internal", AcceleratorError),
    ("dispatch:1:data_loss", AcceleratorError),
    ("dispatch:1:oom", torch.OutOfMemoryError),
    ("dispatch:1:unavailable", DistNetworkError),  # a spent budget
])
def test_host_rung_is_opt_in(tree_ref, monkeypatch, est, spec, exc):
    """With ``MPITREE_TPU_ELASTIC`` unset (the port's default) a terminal
    fault, or a spent retry budget, raises its classified error: no host
    rung runs, and no warning says the fit moved to the host tier."""
    X, y, _ = tree_ref
    monkeypatch.delenv("MPITREE_TPU_ELASTIC")
    monkeypatch.setenv("MPITREE_TPU_RETRIES", "0")
    fit = {
        "tree": lambda: DecisionTreeClassifier(device="cpu",
                                               **TREE_KW).fit(X, y),
        "regressor": lambda: DecisionTreeRegressor(
            device="cpu", **TREE_KW).fit(X, X[:, 0].astype(np.float64)),
        "forest": lambda: RandomForestClassifier(
            device="cpu", n_estimators=3, max_depth=4,
            random_state=0).fit(X, y),
    }[est]
    chaos.install(spec)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="device failure during")
        with pytest.raises(exc, match="chaos-injected"):
            fit()


def test_default_ladder_retries_on_the_device(tree_ref, monkeypatch):
    """Unset, the retry rungs still run: a blip retries in place and the
    tree is the healthy one, grown by the device engine."""
    X, y, healthy = tree_ref
    monkeypatch.delenv("MPITREE_TPU_ELASTIC")
    chaos.install("dispatch:1:unavailable")
    with pytest.warns(UserWarning, match="retrying on the device tier"):
        clf = DecisionTreeClassifier(device="cpu", **TREE_KW).fit(X, y)
    _same_tree(clf.tree_, healthy.tree_)
    assert _rungs(clf.fit_stats_) == dict(device_retries=1, level_retries=0,
                                          device_failovers=0)
    assert clf.fit_stats_["engine"] != "host"


def test_forest_group_failover_equals_jax():
    """``tests/test_elastic.py:125``: a terminal fault of the batched
    group rebuilds every tree on the host tier: the healthy forest, and
    JAX's, with the same rung counts."""
    X, y = _data(600)
    kw = dict(n_estimators=3, max_depth=5, random_state=0)
    healthy = RandomForestClassifier(device="cpu", **kw).fit(X, y)
    p, j = _both("dispatch:1:internal",
                 lambda: RandomForestClassifier(device="cpu", **kw).fit(X, y),
                 lambda: J.RandomForestClassifier(backend="cpu",
                                                  **kw).fit(X, y))
    for a, b, c in zip(p.trees_, healthy.trees_, j.trees_):
        _same_tree(a, b, "vs healthy")
        np.testing.assert_array_equal(a.feature, c.feature)
        np.testing.assert_allclose(a.count, c.count, rtol=1e-6)
    assert _rungs(p.fit_stats_) == _jax_rungs(j)
    assert p.fit_stats_["device_failovers"] == 1
    assert p.fit_stats_["engine"] == "host"


def test_forest_per_tree_ladder(monkeypatch):
    """Under the levelwise engine each tree has its own ladder: a blip at
    tree 2's first level resumes there."""
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    X, y = _data(500, seed=3)
    kw = dict(n_estimators=3, max_depth=4, random_state=1, device="cpu")
    healthy = RandomForestClassifier(**kw).fit(X, y)
    chaos.install([Fault("level", 2, "unavailable", at_level=1)])
    with pytest.warns(UserWarning, match="resuming from level 1"):
        rf = RandomForestClassifier(**kw).fit(X, y)
    for a, b in zip(rf.trees_, healthy.trees_):
        _same_tree(a, b)
    assert _rungs(rf.fit_stats_) == dict(device_retries=0, level_retries=1,
                                         device_failovers=0)


def test_collective_seam_blip_recovers():
    """``tests/test_resilience.py:299``: a fault at the levelwise split
    dispatch resumes from its level, in both packages."""
    X, y = _data(600, seed=1)
    os.environ["MPITREE_TPU_ENGINE"] = "levelwise"
    try:
        kw = dict(max_depth=4, refine_depth=None)
        healthy = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
        p, j = _both("split_dispatch:2:unavailable",
                     lambda: DecisionTreeClassifier(device="cpu",
                                                    **kw).fit(X, y),
                     lambda: J.DecisionTreeClassifier(backend="cpu",
                                                      **kw).fit(X, y))
    finally:
        del os.environ["MPITREE_TPU_ENGINE"]
    _same_tree(p.tree_, healthy.tree_)
    _same_tree(p.tree_, j.tree_)
    assert _rungs(p.fit_stats_) == _jax_rungs(j) == dict(
        device_retries=0, level_retries=1, device_failovers=0)


@pytest.mark.parametrize("site", ["counts_dispatch", "update_dispatch"])
def test_other_levelwise_seams_resume(site, monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    X, y = _noise(seed=3)  # a full-depth tree: its last level is terminal
    kw = dict(max_depth=4, refine_depth=None, device="cpu")
    healthy = DecisionTreeClassifier(**kw).fit(X, y)
    chaos.install(f"{site}:1:unavailable")
    with pytest.warns(UserWarning, match="resuming from level"):
        clf = DecisionTreeClassifier(**kw).fit(X, y)
    _same_tree(clf.tree_, healthy.tree_)
    assert clf.fit_stats_["level_retries"] == 1


@pytest.fixture(scope="module")
def level_refs():
    """JAX's levelwise and host-stepped best-first fits on 8 shards and a
    (4, 2) mesh, with their level and expansion counts."""
    os.environ["MPITREE_TPU_ENGINE"] = "levelwise"
    try:
        X, y = _noise(seed=3)
        out = {}
        for nd in (8, (4, 2)):
            j = J.DecisionTreeClassifier(max_depth=5, refine_depth=None,
                                         n_devices=nd).fit(X, y)
            out[nd] = (j, j.fit_report_["counters"]["level_dispatches"])
        X4, y4 = _noise(seed=4)
        j = J.DecisionTreeClassifier(max_leaf_nodes=16, refine_depth=None,
                                     n_devices=8).fit(X4, y4)
        out["leafwise"] = (j, j.fit_report_["counters"][
            "expansion_dispatches"])
    finally:
        del os.environ["MPITREE_TPU_ENGINE"]
    return out


@pytest.mark.parametrize("n_devices", [8, (4, 2)])
@pytest.mark.parametrize("kill_level", [1, 3, "last"])
def test_levelwise_resumes_from_killed_level(monkeypatch, shards8, level_refs,
                                             n_devices, kill_level):
    """``tests/test_resilience_v2.py:178``: only levels >= k run again (the
    level count is ``levels + 1``), and the tree is JAX's."""
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    X, y = _noise(seed=3)
    jax_tree, levels = level_refs[n_devices]
    kw = dict(max_depth=5, refine_depth=None, n_devices=n_devices,
              device="cpu")
    healthy = DecisionTreeClassifier(**kw).fit(X, y)
    assert healthy.fit_stats_["level_dispatches"] == levels
    k = levels - 1 if kill_level == "last" else kill_level
    chaos.install([Fault("level", 1, "unavailable", at_level=k)])
    with pytest.warns(UserWarning, match=f"resuming from level {k}"):
        clf = DecisionTreeClassifier(**kw).fit(X, y)
    st = clf.fit_stats_
    assert _rungs(st) == dict(device_retries=0, level_retries=1,
                              device_failovers=0)
    assert st["level_dispatches"] == levels + 1
    _same_tree(clf.tree_, jax_tree.tree_, "vs JAX")


@pytest.mark.parametrize("kill_expansion", [1, 5, "last"])
def test_leafwise_stepped_resumes_from_killed_expansion(
        monkeypatch, shards8, level_refs, kill_expansion):
    """``tests/test_resilience_v2.py:211``, at expansion granularity."""
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    X, y = _noise(seed=4)
    jax_tree, exps = level_refs["leafwise"]
    kw = dict(max_leaf_nodes=16, refine_depth=None, n_devices=8,
              device="cpu")
    healthy = DecisionTreeClassifier(**kw).fit(X, y)
    assert healthy.fit_stats_["expansion_dispatches"] == exps
    k = exps - 1 if kill_expansion == "last" else kill_expansion
    chaos.install([Fault("expansion", 1, "unavailable", at_level=k)])
    with pytest.warns(UserWarning, match=f"resuming from expansion {k}"):
        clf = DecisionTreeClassifier(**kw).fit(X, y)
    st = clf.fit_stats_
    assert st["level_retries"] == 1 and "device_retries" not in st
    assert st["expansion_dispatches"] == exps + 1
    _same_tree(clf.tree_, jax_tree.tree_, "vs JAX")


def test_level_retry_off_restores_whole_build_retry(monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    monkeypatch.setenv("MPITREE_TPU_LEVEL_RETRY", "off")
    X, y = _noise(seed=3)
    kw = dict(max_depth=4, refine_depth=None, device="cpu")
    healthy = DecisionTreeClassifier(**kw).fit(X, y)
    levels = healthy.fit_stats_["level_dispatches"]
    chaos.install([Fault("level", 1, "unavailable", at_level=2)])
    with pytest.warns(UserWarning, match="retrying on the device tier"):
        clf = DecisionTreeClassifier(**kw).fit(X, y)
    st = clf.fit_stats_
    assert st["device_retries"] == 1 and "level_retries" not in st
    assert st["level_dispatches"] == levels + 3
    _same_tree(clf.tree_, healthy.tree_)


def test_leafwise_fused_build_retries_whole(tree_ref):
    """The fused best-first build takes no snapshot: its seam's blip
    retries the whole build (a new loop, a new graph), the same tree."""
    X, y, _ = tree_ref
    kw = dict(max_leaf_nodes=12, device="cpu")
    healthy = DecisionTreeClassifier(**kw).fit(X, y)
    chaos.install("leafwise_build:1:unavailable")
    with pytest.warns(UserWarning, match="leaf-wise build"):
        clf = DecisionTreeClassifier(**kw).fit(X, y)
    _same_tree(clf.tree_, healthy.tree_)
    assert _rungs(clf.fit_stats_) == dict(device_retries=1, level_retries=0,
                                          device_failovers=0)
    chaos.install("leafwise_build:1:internal")
    with pytest.raises(AcceleratorError):  # no host twin: it raises
        DecisionTreeClassifier(**kw).fit(X, y)


# -- boosting --------------------------------------------------------------

def test_gbdt_host_loop_resumes_round_build_at_level(monkeypatch):
    """``tests/test_resilience_v2.py:260``: a blip at level 2 of round 1's
    build resumes there; the ensemble is JAX's."""
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    X, _ = _noise(500, seed=6)
    yr = X[:, 0] * 2.0 + np.sin(X[:, 1])
    kw = dict(max_iter=3, max_depth=3, random_state=0)
    ref = GradientBoostingRegressor(device="cpu", **kw).fit(X, yr)
    spec = "level:2:unavailable:at_level=2"
    p, j = _both(spec,
                 lambda: GradientBoostingRegressor(device="cpu",
                                                   **kw).fit(X, yr),
                 lambda: J.GradientBoostingRegressor(backend="cpu",
                                                     **kw).fit(X, yr))
    assert _rungs(p.fit_stats_) == _jax_rungs(j) == dict(
        device_retries=0, level_retries=1, device_failovers=0)
    np.testing.assert_array_equal(p.predict(X), ref.predict(X))
    np.testing.assert_array_equal(p.predict(X), j.predict(X))


def test_gbdt_round_blip_retries():
    X, _ = _data(300, seed=10)
    # a target of several features: no exact zero-gain ties (R8)
    yb = (X[:, 0] + np.sin(3 * X[:, 1]) + 0.3 * X[:, 2] > 0).astype(np.int64)
    kw = dict(max_iter=3, max_depth=2, random_state=0)
    ref = GradientBoostingClassifier(device="cpu", **kw).fit(X, yb)
    p, j = _both("dispatch:2:deadline",
                 lambda: GradientBoostingClassifier(device="cpu",
                                                    **kw).fit(X, yb),
                 lambda: J.GradientBoostingClassifier(backend="cpu",
                                                      **kw).fit(X, yb))
    assert _rungs(p.fit_stats_) == _jax_rungs(j)
    np.testing.assert_array_equal(p.predict_proba(X), ref.predict_proba(X))
    for a, b in zip(p.trees_, j.trees_):
        _same_tree(a, b, "vs JAX")
    np.testing.assert_array_equal(p.decision_function(X),
                                  j.decision_function(X))


def test_fused_rounds_retry_at_dispatch_boundary():
    """``tests/test_resilience_v2.py:279`` against the port's own
    uninterrupted fused fit (R1): a blip inside dispatch 2 re-runs that
    dispatch only (rounds 4..7), bit for bit. The retry rung does it and
    counts it as a device retry (JAX's dispatch snapshot counts the
    same re-run as a level retry)."""
    X, _ = _noise(500, seed=8)
    yr = X[:, 0] * 2.0 + np.sin(X[:, 1])
    kw = dict(max_iter=8, max_depth=3, rounds_per_dispatch=4,
              random_state=0, device="cpu")
    ref = GradientBoostingRegressor(**kw).fit(X, yr)
    chaos.install([Fault("fused_rounds", 2, "unavailable")])
    with pytest.warns(UserWarning, match=r"(?s)fused rounds 4\.\.7.*retrying "
                      "on the device tier"):
        gb = GradientBoostingRegressor(**kw).fit(X, yr)
    st = gb.fit_stats_
    assert _rungs(st) == dict(device_retries=1, level_retries=0,
                              device_failovers=0)
    assert st["dispatches"] == 2
    for a, b in zip(gb.staged_predict(X), ref.staged_predict(X)):
        np.testing.assert_array_equal(a, b)
    chaos.install([Fault("fused_rounds", 1, "internal")])
    with pytest.raises(AcceleratorError):  # no host twin of the rounds
        GradientBoostingRegressor(**kw).fit(X, yr)


@pytest.mark.parametrize("est,at,rnd", [("regressor", 2, 1),
                                        ("classifier", 1, 0),
                                        ("fused", 1, 0)])
def test_nonfinite_grad_fails_fast(est, at, rnd):
    """``tests/test_resilience.py:548,565``; the fused rounds corrupt the
    margins a dispatch starts from, which the guard refuses likewise."""
    X, y = _data(300, seed=10 if est != "classifier" else 11)
    yr = (X[:, 0] * 2 + np.sin(X[:, 1])).astype(np.float64)
    chaos.install([Fault("grad_hess", at, "nan")])
    with pytest.raises(FloatingPointError, match=f"round {rnd}") as ei:
        if est == "classifier":
            GradientBoostingClassifier(max_iter=3, max_depth=2,
                                       device="cpu").fit(X, y)
        else:
            GradientBoostingRegressor(
                max_iter=4, max_depth=2, device="cpu",
                rounds_per_dispatch=2 if est == "fused" else 1).fit(X, yr)
    assert "learning_rate" in str(ei.value)


# -- serving ---------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    X, y = _data(500, seed=2)
    rf = RandomForestClassifier(n_estimators=4, max_depth=5, random_state=0,
                                device="cpu").fit(X, y)
    jrf = J.RandomForestClassifier(n_estimators=4, max_depth=5,
                                   random_state=0, backend="cpu").fit(X, y)
    return X, rf, jrf


def test_serving_retry_answers_bit_for_bit(served):
    X, rf, jrf = served
    cm = compile_model(rf, buckets=(16, 64))
    want = cm.raw(X[:100])
    chaos.install("serving_dispatch:1:unavailable")
    with pytest.warns(UserWarning, match="serving traversal dispatch"):
        got = cm.raw(X[:100])
    chaos.clear()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jrf.predict_proba(X[:100]))
    assert cm.metrics.counter("mpitree_serving_retries_total").value == 1
    assert "mpitree_serving_retries_total 1" in cm.metrics_text()
    chaos.install("serving_dispatch:1:aborted")
    with pytest.raises(DistBackendError):  # terminal: to the caller
        cm.raw(X[:10])


class _Registry:
    def __init__(self, models):
        self._models = dict(models)

    def get(self, name):
        return self._models[name]

    def metrics_families(self):
        return []


def test_scheduler_blip_requeues_once(served):
    X, rf, _ = served
    cm = compile_model(rf, buckets=(16, 64))
    chaos.install("sched_dispatch:1:unavailable")
    with Scheduler(_Registry({"rf": cm}), qos="q:30000:64", shed_depth=64,
                   margin_ms=5, wait_ms=1) as s:
        futs = [s.submit("rf", X[i]) for i in range(5)]
        got = np.stack([f.result(timeout=30) for f in futs])
        st = s.stats()
    chaos.clear()
    assert 1 <= st["requeues"] <= 5
    np.testing.assert_array_equal(got, cm.raw(X[:5]))
