"""The port's build records (``mpitree_tpu_torch.obs``) against the JAX
package's.

``obs/events.py``, ``record.py``, ``fingerprint.py``, ``accounting.py``
and ``observer.py`` are the counterparts of ``mpitree_tpu.obs``'s; the
estimators write into a ``BuildObserver`` per fit. On the same seeded data
and the same engine (both packages pinned to it: the JAX package sends
small ``backend=None`` fits to its host tier, ``ROADMAP.md`` R3), this
file holds:

- the schema (``SCHEMA_VERSION`` 9, the top-level fields, the digest's
  keys) and the event and decision registries;
- ``engine.value``, every decision's value, ``result``, the level rows'
  ``level``/``frontier``/``splits`` and the fingerprints (``trees`` and
  ``fit``, with the port's ``obs.diff.localize_divergence`` finding no
  divergence, and agreeing with the JAX package's on a perturbed copy)
  for the fused, levelwise, host, hybrid, leaf-wise and
  regression engines, a forest and a boosted ensemble;
- boosting's ``rounds`` rows against the JAX host round loop;
- F8: ``fit_stats_`` is None with ``MPITREE_TPU_PROFILE`` unset and the
  phase summary, with JAX's phase names, under ``MPITREE_TPU_PROFILE=1``;
  every key the port's ``fit_stats_`` used to hold reads back from
  ``fit_report_`` (``obs.record.STATS_MOVES``);
- the resilience ladder's typed events beside their counters, as JAX's;
- ``wire_estimate``, the level-row cap and its spill, ``dump_report``'s
  round trip, the degrades of unwritable sinks, the knobs' registry
  entries, and the structure of the disabled path (no wall-clock bound:
  that number is ``chip_smoke.py`` phase 32's).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu as J  # noqa: E402
from mpitree_tpu import obs as jax_obs  # noqa: E402
from mpitree_tpu.config import knobs as jax_knobs  # noqa: E402
from mpitree_tpu.obs import events as jax_events  # noqa: E402
from mpitree_tpu.obs.diff import (  # noqa: E402
    localize_divergence as jax_localize_divergence,
)
from mpitree_tpu.resilience import chaos as jax_chaos  # noqa: E402
from mpitree_tpu_torch import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    GradientBoostingRegressor,
    RandomForestClassifier,
)
from mpitree_tpu_torch import obs  # noqa: E402
from mpitree_tpu_torch.config import knobs  # noqa: E402
from mpitree_tpu_torch.obs import accounting, events, fingerprint  # noqa: E402
from mpitree_tpu_torch.obs.diff import localize_divergence  # noqa: E402
from mpitree_tpu_torch.resilience import chaos  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

PROFILE = "MPITREE_TPU_PROFILE"

# (port kwargs, JAX kwargs, env) per engine: each pair runs the same
# engine in both packages
CASES = {
    "fused": (dict(max_depth=6, refine_depth=None),
              dict(max_depth=6, refine_depth=None, backend="cpu"), {}),
    "levelwise": (dict(max_depth=6, refine_depth=None),
                  dict(max_depth=6, refine_depth=None, backend="cpu"),
                  {"MPITREE_TPU_ENGINE": "levelwise"}),
    "host": (dict(max_depth=6, backend="host"),
             dict(max_depth=6, backend="host"), {}),
    "hybrid": (dict(max_depth=8, refine_depth=3),
               dict(max_depth=8, refine_depth=3, backend="cpu"), {}),
    "leafwise": (dict(max_leaf_nodes=15),
                 dict(max_leaf_nodes=15, backend="cpu"), {}),
    "regression": (dict(max_depth=5, refine_depth=None),
                   dict(max_depth=5, refine_depth=None, backend="cpu"), {}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits (the boosting files'
    fixture: xdist workers would otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Env:
    """Set environment variables for a block, restoring them after."""

    def __init__(self, **env):
        self.env, self.old = env, {}

    def __enter__(self):
        for k, v in self.env.items():
            self.old[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def data():
    return covtype_like(4_000, seed=0)


def _fit_pair(name, X, y, profile: bool):
    pkw, jkw, env = CASES[name]
    with _Env(**{PROFILE: "1" if profile else None,
                 "MPITREE_TPU_ENGINE": env.get("MPITREE_TPU_ENGINE")}):
        cls_p = (DecisionTreeRegressor if name == "regression"
                 else DecisionTreeClassifier)
        cls_j = (J.DecisionTreeRegressor if name == "regression"
                 else J.DecisionTreeClassifier)
        port = cls_p(device="cpu", **pkw).fit(X, y)
        ref = cls_j(**jkw).fit(X, y)
    return port, ref


@pytest.fixture(scope="module")
def pairs(data):
    """Every case fitted in both packages under MPITREE_TPU_PROFILE=1
    (level rows are timing-gated) and without it."""
    X, y = data
    yr = (X[:, 0] * 2.0 + np.sin(X[:, 1] / 500.0)).astype(np.float64)
    out = {}
    for name in CASES:
        yy = yr if name == "regression" else y
        out[name] = {p: _fit_pair(name, X, yy, p) for p in (True, False)}
    return out


# -- schema and registries ----------------------------------------------------

def test_schema_and_top_level_fields_equal_jax():
    rep = obs.BuildObserver(timing=False).report()
    assert obs.SCHEMA_VERSION == jax_obs.SCHEMA_VERSION == 9
    assert obs.TOP_LEVEL_FIELDS == jax_obs.TOP_LEVEL_FIELDS
    assert tuple(sorted(rep)) == tuple(sorted(jax_obs.TOP_LEVEL_FIELDS))
    assert tuple(f.name for f in dataclasses.fields(obs.BuildRecord)) \
        == jax_obs.TOP_LEVEL_FIELDS
    assert rep["schema"] == 9
    # a record with no plan and no priced dispatch keeps both ledgers empty
    assert rep["memory"] == {} and rep["compute"] == {}


def test_digest_keys_equal_jax(pairs):
    port, ref = pairs["fused"][True]
    assert sorted(obs.digest(port.fit_report_)) == sorted(
        jax_obs.digest(ref.fit_report_))
    d = obs.digest(port.fit_report_)
    assert d["engine"] == "fused" and d["fingerprint"] == \
        port.fit_report_["fingerprints"]["fit"]


def test_event_and_decision_registries_equal_jax():
    """The JAX package's catalog, but for ``serving_kernel``'s text,
    which names the port's values (the body a served model's launches
    take) where JAX's names its TPU tiers."""
    assert events.EVENTS == tuple(
        events.Event(e.kind, e.severity, e.doc) for e in jax_events.EVENTS)
    own = {"serving_kernel"}
    assert [d.key for d in events.DECISIONS] == [
        d.key for d in jax_events.DECISIONS]
    assert tuple(d for d in events.DECISIONS if d.key not in own) == tuple(
        events.Decision(d.key, d.doc) for d in jax_events.DECISIONS
        if d.key not in own)
    doc = events.DECISION_KEYS["serving_kernel"].doc
    for body in ("traverse", "traverse_q", "margin", "margin_q", "plain"):
        assert body in doc
    differ = [(a, b) for a, b in zip(
        events.markdown_table().splitlines(),
        jax_events.markdown_table().splitlines()) if a != b]
    assert [a.split("|")[1].strip() for a, _ in differ] == ["`serving_kernel`"]


@pytest.mark.parametrize("name", ["MPITREE_TPU_PROFILE",
                                  "MPITREE_TPU_DEBUG",
                                  "MPITREE_TPU_TRACE_DIR",
                                  "MPITREE_TPU_OBS_STREAM_DIR"])
def test_observability_knobs_registered_as_in_jax(name, monkeypatch):
    got = knobs.REGISTRY[name]
    want = jax_knobs.REGISTRY[name]
    assert (got.name, got.kind, got.default, got.doc, got.choices) == (
        want.name, want.kind, want.default, want.doc, want.choices)
    for raw in ("", "0", "1", "yes", "/tmp/x"):
        monkeypatch.setenv(name, raw)
        assert knobs.value(name) == jax_knobs.value(name)


# -- the record of each engine against JAX's ---------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_engine_decisions_result_equal_jax(pairs, name):
    port, ref = pairs[name][False]
    p, j = port.fit_report_, ref.fit_report_
    assert p["engine"]["value"] == j["engine"]["value"]
    assert p["engine"]["reason"]
    assert {k: v["value"] for k, v in p["decisions"].items()} == {
        k: v["value"] for k, v in j["decisions"].items()}
    assert p["result"] == j["result"]
    assert p["schema"] == j["schema"]


@pytest.mark.parametrize("name", list(CASES))
def test_level_rows_equal_jax(pairs, name):
    port, ref = pairs[name][True]
    cols = ("level", "frontier", "splits")
    got = [tuple(r[c] for c in cols) for r in port.fit_report_["levels"]]
    want = [tuple(r[c] for c in cols) for r in ref.fit_report_["levels"]]
    assert got == want and got
    # rows are timing-gated
    assert pairs[name][False][0].fit_report_["levels"] == []


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("profile", [True, False])
def test_fingerprints_equal_jax(pairs, name, profile):
    port, ref = pairs[name][profile]
    p, j = port.fit_report_["fingerprints"], ref.fit_report_["fingerprints"]
    assert p["version"] == j["version"] == fingerprint.FINGERPRINT_VERSION
    assert p["trees"] == j["trees"]
    assert p["fit"] == j["fit"]
    assert localize_divergence(p, j) is None


def test_localize_divergence_agrees_with_jax(pairs):
    """The port's bisection and the JAX package's name the same first
    divergent (tree, level, channel) on a perturbed copy of a fit's
    rows, and both find none on the equal pair."""
    import copy

    p = pairs["hybrid"][False][0].fit_report_["fingerprints"]
    j = pairs["hybrid"][False][1].fit_report_["fingerprints"]
    assert localize_divergence(p, j) is None
    assert jax_localize_divergence(p, j) is None
    bad = copy.deepcopy(p)
    bad["trees"][0][2]["winner"] = "0" * 16
    got = localize_divergence(p, bad)
    assert got == jax_localize_divergence(p, bad)
    assert (got["tree"], got["level"], got["channel"]) == (0, 2, "winner")


def test_counters_of_the_fused_engine_equal_jax(pairs):
    port, ref = pairs["fused"][False]
    for k in ("fused_builds", "rows_scanned", "rows_frontier"):
        assert port.fit_report_["counters"][k] == \
            ref.fit_report_["counters"][k], k


def test_forest_record_equals_jax(data, monkeypatch):
    X, y = data
    monkeypatch.delenv(PROFILE, raising=False)
    kw = dict(n_estimators=3, max_depth=5, random_state=0)
    port = RandomForestClassifier(device="cpu", **kw).fit(X, y)
    ref = J.RandomForestClassifier(backend="cpu", **kw).fit(X, y)
    p, j = port.fit_report_, ref.fit_report_
    assert p["result"] == j["result"] and p["trees"] == j["trees"]
    assert p["fingerprints"]["trees"] == j["fingerprints"]["trees"]
    assert p["fingerprints"]["fit"] == j["fingerprints"]["fit"]
    for k in ("build_path", "refine", "bootstrap", "ensemble_path",
              "refine_tail", "serving"):
        assert p["decisions"][k]["value"] == j["decisions"][k]["value"], k
    assert port.fit_stats_ is None and ref.fit_stats_ is None


def test_boosting_rounds_equal_the_jax_host_loop(data, monkeypatch):
    """The port's host round loop (``rounds_per_dispatch`` 1 on the CPU)
    against JAX's host loop (never its fused rounds: R1)."""
    X, y = data
    monkeypatch.delenv(PROFILE, raising=False)
    yr = (X[:, 0] / 1000.0 + (y == 1)).astype(np.float64)
    kw = dict(max_iter=4, max_depth=3, random_state=0, subsample=0.8)
    port = GradientBoostingRegressor(device="cpu", **kw).fit(X, yr)
    ref = J.GradientBoostingRegressor(backend="cpu", rounds_per_dispatch=1,
                                      **kw).fit(X, yr)
    p, j = port.fit_report_, ref.fit_report_
    assert len(p["rounds"]) == len(j["rounds"]) == 4
    for a, b in zip(p["rounds"], j["rounds"]):
        for k in ("round", "trees", "subsample", "colsample", "val_loss",
                  "stale", "early_stop"):
            assert a[k] == b[k], k
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-12)
        assert a["seconds"] is None and b["seconds"] is None
    assert p["fingerprints"] == j["fingerprints"]
    for k in ("rounds_per_dispatch", "engine", "early_stop", "serving"):
        assert p["decisions"][k]["value"] == j["decisions"][k]["value"], k
    assert p["counters"]["level_dispatches"] == \
        j["counters"]["level_dispatches"]


# -- F8: fit_stats_ -----------------------------------------------------------

def _forest_and_boost(X, y, profile):
    yr = (X[:, 0] / 1000.0 + (y == 1)).astype(np.float64)
    with _Env(**{PROFILE: "1" if profile else None}):
        pf = RandomForestClassifier(n_estimators=2, max_depth=4,
                                    random_state=0, device="cpu").fit(X, y)
        jf = J.RandomForestClassifier(n_estimators=2, max_depth=4,
                                      random_state=0,
                                      backend="cpu").fit(X, y)
        pb = GradientBoostingRegressor(max_iter=2, max_depth=3,
                                       device="cpu").fit(X, yr)
        jb = J.GradientBoostingRegressor(max_iter=2, max_depth=3,
                                         backend="cpu",
                                         rounds_per_dispatch=1).fit(X, yr)
    return {"forest": (pf, jf), "boosting": (pb, jb)}


@pytest.fixture(scope="module")
def ensembles(data):
    X, y = data
    return {p: _forest_and_boost(X, y, p) for p in (True, False)}


@pytest.mark.parametrize("name", list(CASES) + ["forest", "boosting"])
def test_fit_stats_is_the_phase_summary_as_in_jax(pairs, ensembles, name):
    """F8 closed: ``fit_stats_`` is None with profiling off in both
    packages, and under ``MPITREE_TPU_PROFILE=1`` it has the same phase
    names on the same engine."""
    src = ensembles if name in ("forest", "boosting") else pairs
    for profile in (False, True):
        if name in ("forest", "boosting"):
            port, ref = src[profile][name]
        else:
            port, ref = src[name][profile]
        if not profile:
            assert port.fit_stats_ is None and ref.fit_stats_ is None
            assert port.fit_report_["phases"] == {}
            continue
        assert set(port.fit_stats_) == set(ref.fit_stats_), name
        for v in port.fit_stats_.values():
            assert v["seconds"] >= 0.0 and v["calls"] >= 1
        assert port.fit_report_["phases"] == port.fit_stats_


def test_moved_keys_read_back_from_the_report(pairs):
    """Every key the port's ``fit_stats_`` held reads from
    ``fit_report_`` at the place ``STATS_MOVES`` names."""
    port, _ = pairs["hybrid"][True]
    v = obs.stats_view(port.fit_report_)
    assert v["engine"] == "fused" and v["crown_depth"] == 3
    assert v["refine_engine"] in ("batched-native", "per-subtree")
    assert v["refine_nodes_added"] == \
        port.fit_report_["counters"]["refine_nodes_added"] > 0
    assert v["n_shards"] == 1
    assert v["bin_seconds"] == port.fit_stats_["bin"]["seconds"]
    assert v["tail_seconds"] == port.fit_stats_["refine"]["seconds"]
    assert v["crown_seconds"] == pytest.approx(sum(
        port.fit_stats_[k]["seconds"]
        for k in ("shard", "fused_build", "host_finalize")))
    assert v["allreduce_calls"] == 0  # one device reduces nothing
    off, _ = pairs["fused"][False]
    w = obs.stats_view(off.fit_report_)
    assert "crown_depth" not in w and "bin_seconds" not in w
    with pytest.raises(KeyError):
        obs.moved_stat(off.fit_report_, "tail_seconds")
    assert set(obs.STATS_MOVES) >= {
        "engine", "refine_nodes_added", "n_shards", "ensemble_path",
        "device_retries", "level_retries", "device_failovers",
        "level_dispatches", "expansion_dispatches",
        "checkpoint_compactions", "allreduce_calls", "exchange_bytes",
        "route_calls", "gather_bytes", "tree_exchange_calls"}


# -- the resilience ladder's typed events ------------------------------------

@pytest.mark.parametrize("spec,kinds", [
    ("dispatch:1:unavailable", ["device_retry"]),
    ("dispatch:1:data_loss", ["device_failover"]),
])
def test_ladder_events_beside_their_counters_as_in_jax(data, monkeypatch,
                                                       spec, kinds):
    X, y = data
    X, y = X[:1_000], y[:1_000]
    monkeypatch.setenv("MPITREE_TPU_ELASTIC", "1")
    monkeypatch.setenv("MPITREE_TPU_BACKOFF_S", "0")
    kw = dict(max_depth=4, refine_depth=None)
    chaos.install(spec)
    jax_chaos.install(spec)
    try:
        with pytest.warns(UserWarning):
            p = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
            j = J.DecisionTreeClassifier(backend="cpu", **kw).fit(X, y)
    finally:
        chaos.clear()
        jax_chaos.clear()
    pk = [e["kind"] for e in p.fit_report_["events"]]
    jk = [e["kind"] for e in j.fit_report_["events"]]
    assert pk == jk == kinds
    counter = {"device_retry": "device_retries",
               "device_failover": "device_failovers"}[kinds[0]]
    assert p.fit_report_["counters"][counter] == \
        j.fit_report_["counters"][counter] == 1
    if kinds == ["device_retry"]:
        ev = p.fit_report_["events"][0]
        assert ev["attempt"] == 1 and ev["delay_s"] == 0.0


def test_level_retry_event_as_in_jax(data, monkeypatch):
    X, y = data
    X, y = X[:1_000], y[:1_000]
    monkeypatch.setenv("MPITREE_TPU_ELASTIC", "1")
    monkeypatch.setenv("MPITREE_TPU_BACKOFF_S", "0")
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    kw = dict(max_depth=4, refine_depth=None)
    spec = [chaos.Fault("level", 1, "unavailable", at_level=2)]
    chaos.install(spec)
    jax_chaos.install([jax_chaos.Fault("level", 1, "unavailable",
                                       at_level=2)])
    try:
        with pytest.warns(UserWarning):
            p = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
            j = J.DecisionTreeClassifier(backend="cpu", **kw).fit(X, y)
    finally:
        chaos.clear()
        jax_chaos.clear()
    pe, je = p.fit_report_["events"], j.fit_report_["events"]
    assert [e["kind"] for e in pe] == [e["kind"] for e in je] == [
        "level_retry"]
    for k in ("granularity", "resume_at", "attempt"):
        assert pe[0][k] == je[0][k], k
    assert p.fit_report_["counters"]["level_retries"] == 1
    assert p.fit_report_["fingerprints"] == j.fit_report_["fingerprints"]


def test_nonfinite_grad_event_from_a_poisoned_round(data, monkeypatch):
    X, y = data
    X, y = X[:800], y[:800]
    monkeypatch.setenv("MPITREE_TPU_BACKOFF_S", "0")
    chaos.install("grad_hess:2:nan")
    try:
        est = GradientBoostingRegressor(max_iter=3, max_depth=2,
                                        device="cpu")
        with pytest.raises(FloatingPointError):
            est.fit(X, y.astype(np.float64))
    finally:
        chaos.clear()
    assert [e["kind"] for e in est.fit_report_["events"]] == [
        "nonfinite_grad"]
    assert len(est.fit_report_["rounds"]) == 1


# -- accounting, sinks, degrades ------------------------------------------

@pytest.mark.parametrize("axes", [1, 4, {"data": 4, "feature": 2},
                                  {"tree": 2, "data": 4}])
def test_wire_estimate_equals_jax(axes):
    coll = {"split_hist_psum": {"calls": 3, "bytes": 3_000_003},
            "route_psum": {"calls": 1, "bytes": 40_000},
            "feature_merge_all_gather": {"calls": 2, "bytes": 160},
            "tree_exchange": {"calls": 3, "bytes": 9_999}}
    assert obs.wire_estimate(coll, axes) == jax_obs.wire_estimate(coll, axes)


def test_collective_byte_helpers_equal_jax():
    from mpitree_tpu.parallel import collective as jc

    from mpitree_tpu_torch.parallel import collective as pc

    for kw in (dict(n_slots=8, n_features=54, n_bins=256, n_channels=7),
               dict(n_slots=1, n_features=3, n_bins=2, n_channels=3,
                    itemsize=8)):
        assert pc.split_psum_bytes(**kw) == jc.split_psum_bytes(**kw)
    assert pc.counts_psum_bytes(n_slots=64, n_channels=7) == \
        jc.counts_psum_bytes(n_slots=64, n_channels=7)
    assert pc.select_global_bytes(n_slots=64) == \
        jc.select_global_bytes(n_slots=64)
    assert pc.gbdt_leaf_psum_bytes(n_slots=61, itemsize=8) == \
        jc.gbdt_leaf_psum_bytes(n_slots=61, itemsize=8)


def test_replayed_rows_equal_jax_on_the_same_tree(pairs):
    """``fused_level_rows``/``leafwise_scan_rows`` on one finished tree
    (the JAX package's, carried over) give JAX's rows."""
    from mpitree_tpu.obs import accounting as jax_acct

    port, ref = pairs["fused"][False]
    kw = dict(n_slots=64, tiers=(8, 64), n_features=54, n_bins=256,
              n_channels=7, counts_channels=7, max_depth=6,
              task="classification")
    got = accounting.fused_scan_rows(port.tree_, **kw)
    want = jax_acct.fused_scan_rows(ref.tree_, **kw)
    assert got == want
    lw, lref = pairs["leafwise"][False]
    kw = dict(n_features=54, n_bins=256, n_channels=7,
              task="classification", subtraction=False)
    assert accounting.leafwise_scan_rows(lw.tree_, **kw) == \
        jax_acct.leafwise_scan_rows(lref.tree_, **kw)
    assert accounting.replay_fingerprints(port.tree_) == \
        port.fit_report_["fingerprints"]["trees"][0]


def test_level_rows_gated_capped_and_spilled(tmp_path, monkeypatch):
    off = obs.BuildObserver(timing=False)
    off.level(level=0, frontier=1)
    assert off.record.levels == []
    on = obs.BuildObserver(timing=True)
    for i in range(on.MAX_LEVEL_ROWS + 5):
        on.level(level=i, frontier=1)
    assert len(on.record.levels) == on.MAX_LEVEL_ROWS
    assert on.record.counters["levels_dropped"] == 5
    spill = tmp_path / "levels.jsonl"
    sp = obs.BuildObserver(timing=True)
    sp.stream_levels_to(spill)
    for i in range(sp.MAX_LEVEL_ROWS + 7):
        sp.level(level=i, rows_scanned=np.int64(i))
    rep = sp.report()
    assert rep["level_stream"] == {"path": str(spill), "rows": 7}
    rows = [json.loads(ln) for ln in spill.read_text().splitlines()]
    assert [r["level"] for r in rows] == list(
        range(sp.MAX_LEVEL_ROWS, sp.MAX_LEVEL_ROWS + 7))
    assert sp._level_stream_file is None  # closed at report
    monkeypatch.setenv("MPITREE_TPU_OBS_STREAM_DIR", str(tmp_path / "amb"))
    amb = obs.BuildObserver(timing=True)
    for i in range(amb.MAX_LEVEL_ROWS + 2):
        amb.level(level=i)
    assert amb.report()["level_stream"]["rows"] == 2
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    monkeypatch.setenv("MPITREE_TPU_OBS_STREAM_DIR", str(blocker / "sub"))
    bad = obs.BuildObserver(timing=True)
    for i in range(bad.MAX_LEVEL_ROWS + 3):
        bad.level(level=i)  # must not raise
    rep = bad.report()
    assert rep["counters"]["levels_dropped"] == 3
    assert [e["kind"] for e in rep["events"]] == ["level_stream_failed"]


def test_record_json_round_trip_with_tensors():
    o = obs.BuildObserver(timing=False)
    o.counter("x", 3)
    o.decision("engine", "fused", reason="r", rows=np.int64(10),
               width=torch.tensor(7), cells=torch.arange(3))
    o.event("f32_ceiling", "msg", n=np.float32(0.5))
    rep = o.report()
    assert json.loads(json.dumps(rep)) == rep
    assert rep["decisions"]["engine"]["inputs"] == {
        "rows": 10, "width": 7, "cells": [0, 1, 2]}
    rec = obs.BuildRecord.from_json(json.dumps(rep))
    assert rec.counters == {"x": 3} and rec.engine["value"] == "fused"


def test_dump_report_round_trips_and_degrades(pairs, tmp_path):
    port, _ = pairs["hybrid"][False]
    dest = tmp_path / "deep" / "nested" / "report.json"
    assert port.dump_report(dest) == str(dest)
    assert json.load(open(dest)) == port.fit_report_
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    before = list(port.fit_report_["events"])
    with pytest.warns(UserWarning, match="dump_report sink unwritable"):
        assert port.dump_report(blocker / "sub" / "r.json") is None
    assert port.fit_report_["events"][-1]["kind"] == "trace_failed"
    port.fit_report_["events"] = before
    with pytest.raises(ValueError, match="call fit"):
        DecisionTreeClassifier(device="cpu").dump_report(tmp_path / "x")


def test_disabled_path_records_no_rows_and_no_phases(data):
    """Structure only (the overhead number is ``chip_smoke.py`` phase
    32's): with profiling off and no sink, a levelwise build through a
    ``BuildObserver`` keeps no level rows, no phases and no trace, and
    its always-on channels are filled."""
    from mpitree_tpu_torch.core.builder import BuildConfig, build_tree
    from mpitree_tpu_torch.ops.binning import bin_for_engine

    X, y = data
    binned = bin_for_engine(X[:2_000], max_bins=64, binning="quantile",
                            device=torch.device("cpu"))
    o = obs.BuildObserver(timing=False)
    assert not o.enabled and o._trace is None
    build_tree(binned, y[:2_000], config=BuildConfig(
        max_depth=6, engine="levelwise"), n_classes=7, timer=o)
    rep = o.report()
    assert rep["levels"] == [] and rep["phases"] == {}
    assert o.seconds == {} and o.calls == {}
    assert rep["engine"]["value"] == "levelwise"
    assert rep["counters"]["level_dispatches"] >= 1
    assert len(rep["fingerprints"]["trees"]) == 1


def test_compile_registry_counts_cold_events():
    reg = obs.CompileRegistry()
    assert reg.note("ext:x", "a") and not reg.note("ext:x", "a")
    assert reg.note("ext:x", "b") and reg.count("ext:x") == 2
    for i in range(3):
        reg.note("lru", i, cache_size=2)
    assert reg.note("lru", 0, cache_size=2)  # evicted: cold again
    o = obs.BuildObserver(timing=False)
    from mpitree_tpu_torch.obs.observer import cold_event, observing

    with observing(o):
        with cold_event("cuda_graph:test", ("k", 1)) as fresh:
            assert fresh
        with cold_event("cuda_graph:test", ("k", 1)) as fresh:
            assert not fresh
    rec = o.report()["compile"]["cuda_graph:test"]
    assert rec["new"] == 1 and rec["lowerings"] >= 1 and rec["seconds"] >= 0


def test_graph_captures_are_cold_without_a_churn_warning():
    """Every CUDA-graph capture is a cold event (its key made unique), so
    the recompile-churn warning, whose premise is a static key carrying a
    runtime value, is not for them; other entries still warn."""
    import warnings

    from mpitree_tpu_torch.obs import observer

    reg = observer.CompileRegistry()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for i in range(observer.RECOMPILE_WARN_AFTER + 2):
            assert reg.note("cuda_graph:leafwise", ("k", i), churn=False)
    with pytest.warns(UserWarning, match="cold events"):
        for i in range(observer.RECOMPILE_WARN_AFTER):
            reg.note("ext:churny", i)
