"""The OOM rescue (``resilience/recovery.OomRescue``) and the postmortem
(``resilience/retry._oom_postmortem``) of the port, driven through the
chaos ``oom`` seam (a real ``torch.OutOfMemoryError`` with CUDA's text,
``resilience/chaos.py``).

- a shrinkable OOM runs again on the card under the port's default: the
  rescue halves ``max_frontier_chunk`` (or drops the subtraction carry),
  the shrunk plan is re-priced, and the tree equals the unrescued one
  field for field;
- the ladder is bounded at three shrinks;
- an OOM no shrink clears (a resident array) raises by default, takes
  the host rung under ``MPITREE_TPU_ELASTIC=1``, and leaves one
  ``oom_postmortem``;
- a fused-rounds OOM degrades ``rounds_per_dispatch`` to 1 and the
  remaining rounds run in the port's own host loop (the JAX package's
  fused rounds fail on this CPU, ``ROADMAP.md`` R1), equal to a
  ``rounds_per_dispatch=1`` fit bit for bit;
- the forests (per tree and batched) and a streamed fit are rescued too.

Event and counter names are the JAX package's
(``tests/test_resilience_v2.py``).
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mpitree_tpu.obs import events as jax_events  # noqa: E402
from mpitree_tpu.resilience import recovery as jax_recovery  # noqa: E402

from mpitree_tpu_torch import (  # noqa: E402
    DecisionTreeClassifier,
    GradientBoostingRegressor,
    RandomForestClassifier,
    StreamedDataset,
)
from mpitree_tpu_torch import obs  # noqa: E402
from mpitree_tpu_torch.core import fused_builder  # noqa: E402
from mpitree_tpu_torch.models import classifier as clf_mod  # noqa: E402
from mpitree_tpu_torch.resilience import (  # noqa: E402
    MAX_SHRINKS,
    OomRescue,
    _oom_postmortem,
    chaos,
    device_failover,
    retry_device,
)
from mpitree_tpu_torch.resilience.chaos import Fault  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
          "value", "count", "n_node_samples", "impurity")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_BACKOFF_S", "0")
    monkeypatch.delenv("MPITREE_TPU_ELASTIC", raising=False)
    chaos.clear()
    yield
    chaos.clear()


@pytest.fixture(scope="module")
def data():
    return covtype_like(4_000, seed=3)


def _same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def _kinds(rep):
    return [e["kind"] for e in rep["events"]]


def test_names_are_the_jax_packages():
    from mpitree_tpu_torch.obs import events

    for kind in ("oom_rescue", "oom_postmortem", "oom_predicted"):
        assert events.EVENT_KINDS[kind] == \
            events.Event(**vars(jax_events.EVENT_KINDS[kind]))
    assert MAX_SHRINKS == jax_recovery.MAX_SHRINKS == 3


# -- the rescue object ----------------------------------------------------------

class _Rec:
    def __init__(self, arrays, **inputs):
        self.memory = {"arrays": arrays, "inputs": inputs,
                       "hbm_peak_bytes": 1 << 30}
        self.events = []


class _Obs:
    def __init__(self, rec):
        self.record = rec
        self.counters = {}

    def counter(self, name, inc=1):
        self.counters[name] = self.counters.get(name, 0) + inc

    def event(self, kind, message, **data):
        self.record.events.append({"kind": kind, "message": message, **data})


def _arr(name, nbytes, phase="split"):
    return {"name": name, "shape": [1], "itemsize": 1, "phase": phase,
            "bytes_per_device": nbytes}


@pytest.mark.parametrize("case", ["chunk", "carry", "pool", "rounds",
                                  "resident", "no_plan", "spent"])
def test_rescue_picks_the_priced_knob(case):
    e = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    if case == "no_plan":
        assert not OomRescue(obs=None).attempt(e, what="t")
        return
    arrays = {
        "chunk": [_arr("x_binned", 9, "resident"),
                  _arr("split_hist_chunk", 8)],
        "carry": [_arr("parent_hist", 10), _arr("split_hist_chunk", 1)],
        "pool": [_arr("pair_hist", 10, "leafwise"),
                 _arr("pool_hist", 5, "leafwise")],
        "rounds": [_arr("margin_carry", 10, "fused_rounds")],
        "resident": [_arr("x_binned", 10, "resident"),
                     _arr("node_id", 5, "resident")],
        "spent": [_arr("split_hist_chunk", 8)],
    }[case]
    engine = {"pool": "leafwise", "rounds": "fused_rounds"}.get(case)
    o = _Obs(_Rec(arrays, chunk_slots=8, engine=engine))
    r = OomRescue(obs=o)
    if case == "resident":
        assert not r.attempt(e, what="t")
        assert not o.record.events
        return
    if case == "spent":
        assert [r.attempt(e, what="t") for _ in range(4)] == \
            [True, True, True, False]
        assert r.overrides["max_frontier_chunk"] == 1
        assert o.counters["oom_rescues"] == 3
        return
    assert r.attempt(e, what="t")
    knob, value = {"chunk": ("max_frontier_chunk", 4),
                   "carry": ("hist_subtraction", "off"),
                   "pool": ("hist_subtraction", "off"),
                   "rounds": ("rounds_per_dispatch", 1)}[case]
    assert r.overrides == {knob: value}
    ev = o.record.events[0]
    assert ev["kind"] == "oom_rescue" and ev["knob"] == knob
    assert ev["new_value"] == value
    cfg = r.apply(clf_mod.BuildConfig())
    if knob == "rounds_per_dispatch":
        assert r.rounds_per_dispatch == 1 and cfg == clf_mod.BuildConfig()
    else:
        assert getattr(cfg, knob) == value


# -- the ladder -----------------------------------------------------------------

def _oom():
    raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB")


@pytest.mark.parametrize("ladder", ["failover", "retry"])
@pytest.mark.parametrize("elastic", [None, "1"])
def test_resident_oom_postmortem_then_raise_or_host(ladder, elastic,
                                                    monkeypatch):
    if elastic:
        monkeypatch.setenv("MPITREE_TPU_ELASTIC", elastic)
    o = obs.BuildObserver(timing=False)
    o.memory_plan({"arrays": [_arr("x_binned", 10, "resident")],
                   "inputs": {}, "hbm_peak_bytes": 10,
                   "peak_phase": "resident"})
    rescue = OomRescue(obs=o)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if ladder == "failover" and elastic:
            assert device_failover(_oom, lambda: "host", what="t", obs=o,
                                   rescue=rescue) == "host"
            assert o.record.counters["device_failovers"] == 1
        else:
            call = (retry_device if ladder == "retry" else
                    lambda f, **k: device_failover(f, lambda: "host", **k))
            with pytest.raises(torch.OutOfMemoryError):
                call(_oom, what="t", obs=o, rescue=rescue)
    assert _kinds(o.report()).count("oom_postmortem") == 1
    assert o.record.counters["device_ooms"] == 1
    assert "oom_rescues" not in o.record.counters
    post = next(e for e in o.record.events if e["kind"] == "oom_postmortem")
    assert post["top"] == [{"name": "x_binned", "bytes": 10}]
    # a second OOM of the same record adds no second postmortem
    _oom_postmortem(torch.OutOfMemoryError("CUDA out of memory"), "t", o)
    assert _kinds(o.report()).count("oom_postmortem") == 1


def test_the_ladder_off_raises_untouched(monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_ELASTIC", "0")
    o = obs.BuildObserver(timing=False)
    with pytest.raises(torch.OutOfMemoryError):
        device_failover(_oom, lambda: "host", what="t", obs=o,
                        rescue=OomRescue(obs=o))
    assert "oom_rescues" not in o.record.counters


# -- fits -----------------------------------------------------------------------

KW = dict(max_depth=5, refine_depth=None)


@pytest.fixture(scope="module")
def healthy(data):
    X, y = data
    mp = pytest.MonkeyPatch()
    mp.setenv("MPITREE_TPU_ENGINE", "levelwise")
    try:
        return DecisionTreeClassifier(device="cpu", **KW).fit(X, y)
    finally:
        mp.undo()


def test_clearing_oom_rescued_on_the_card(data, healthy, monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    X, y = data
    chunk0 = healthy.fit_report_["memory"]["inputs"]["chunk_slots"]
    chaos.install([Fault("level", 1, "oom", at_level=1, clears_after=1)])
    clf = DecisionTreeClassifier(device="cpu", **KW).fit(X, y)
    rep = clf.fit_report_
    assert rep["counters"]["oom_rescues"] == 1
    assert "device_failovers" not in rep["counters"]
    assert "device_failover" not in _kinds(rep)
    ev = next(e for e in rep["events"] if e["kind"] == "oom_rescue")
    assert ev["knob"] == "max_frontier_chunk"
    assert ev["binding_array"] == "split_hist_chunk"
    assert ev["old_bytes"] > ev["new_bytes"] > 0
    assert ev["new_value"] == chunk0 // 2
    # the winning dispatch re-priced the shrunk plan
    assert rep["memory"]["inputs"]["chunk_slots"] == chunk0 // 2
    _same(clf.tree_, healthy.tree_)
    assert rep["fingerprints"]["fit"] == \
        healthy.fit_report_["fingerprints"]["fit"]


def test_rescue_drops_the_subtraction_carry(data, monkeypatch):
    """The host-stepped best-first engine with subtraction on: the pool's
    histograms are the shrinkable array, and the rescue runs it again
    with direct pair accumulation, the same tree."""
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    monkeypatch.setenv("MPITREE_TPU_HIST_SUBTRACTION", "on")
    X, y = data
    kw = dict(max_leaf_nodes=15)
    ref = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    assert ref.fit_report_["decisions"]["hist_subtraction"]["value"] == "on"
    chaos.install([Fault("expansion", 3, "oom", clears_after=1)])
    clf = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    rep = clf.fit_report_
    ev = [e for e in rep["events"] if e["kind"] == "oom_rescue"]
    assert len(ev) == 1 and ev[0]["knob"] == "hist_subtraction"
    assert ev[0]["binding_array"] == "pool_hist"
    assert rep["decisions"]["hist_subtraction"]["value"] == "off"
    assert not rep["memory"]["inputs"]["subtraction"]
    _same(clf.tree_, ref.tree_)


def test_the_ladder_is_bounded_at_three(data, healthy, monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    X, y = data
    made = []
    real = clf_mod.fit_observer
    monkeypatch.setattr(clf_mod, "fit_observer",
                        lambda *a, **k: made.append(real(*a, **k))
                        or made[-1])
    chaos.install([Fault("level", 1, "oom", at_level=1, clears_after=99)])
    with pytest.raises(torch.OutOfMemoryError):
        DecisionTreeClassifier(device="cpu", **KW).fit(X, y)
    rec = made[-1].record
    assert rec.counters["oom_rescues"] == 3
    assert [e["kind"] for e in rec.events] == \
        ["oom_rescue"] * 3 + ["oom_postmortem"]
    assert [e["new_value"] for e in rec.events[:3]] == [16, 8, 4]
    # under MPITREE_TPU_ELASTIC=1 the host rung saves the fit
    monkeypatch.setenv("MPITREE_TPU_ELASTIC", "1")
    chaos.install([Fault("level", 1, "oom", at_level=1, clears_after=99)])
    with pytest.warns(UserWarning, match="host tier"):
        clf = DecisionTreeClassifier(device="cpu", **KW).fit(X, y)
    rep = clf.fit_report_
    assert rep["counters"]["oom_rescues"] == 3
    assert rep["counters"]["device_failovers"] == 1
    assert _kinds(rep).count("oom_postmortem") == 1
    assert rep["engine"]["value"] == "host"
    _same(clf.tree_, healthy.tree_)


def test_fused_rounds_oom_degrades_to_the_host_loop(data):
    X, _ = data
    yr = X[:, 0] * 2.0 + np.sin(X[:, 1] / 500.0)
    kw = dict(max_iter=8, max_depth=3, random_state=0, device="cpu")
    ref = GradientBoostingRegressor(rounds_per_dispatch=1, **kw).fit(X, yr)
    chaos.install([Fault("fused_rounds", 1, "oom")])
    gb = GradientBoostingRegressor(rounds_per_dispatch=4, **kw).fit(X, yr)
    rep = gb.fit_report_
    assert rep["counters"]["oom_rescues"] == 1
    assert "device_failovers" not in rep["counters"]
    ev = next(e for e in rep["events"] if e["kind"] == "oom_rescue")
    assert ev["knob"] == "rounds_per_dispatch" and ev["new_value"] == 1
    assert ev["binding_array"] in ("pair_hist", "pool_nodes", "grad_hess",
                                   "margin_carry", "pool_scalars")
    assert "rounds_fused" not in rep["counters"]
    assert gb.n_iter_ == 8
    assert rep["memory"]["inputs"]["rounds_per_dispatch"] == 1
    np.testing.assert_array_equal(gb.predict(X), ref.predict(X))
    for a, b in zip(gb.staged_predict(X), ref.staged_predict(X)):
        np.testing.assert_array_equal(a, b)


def test_fused_rounds_oom_after_a_dispatch(data):
    """Struck at the second dispatch: rounds 0-3 fused, 4-7 on the host
    loop, from the first dispatch's margins."""
    X, _ = data
    yr = X[:, 0] * 2.0 + np.sin(X[:, 1] / 500.0)
    kw = dict(max_iter=8, max_depth=3, random_state=0, device="cpu")
    chaos.install([Fault("fused_rounds", 2, "oom")])
    gb = GradientBoostingRegressor(rounds_per_dispatch=4, **kw).fit(X, yr)
    rep = gb.fit_report_
    assert rep["counters"]["oom_rescues"] == 1
    assert rep["counters"]["rounds_fused"] == 4
    assert gb.n_iter_ == 8 and len(gb.trees_) == 8
    ref = GradientBoostingRegressor(rounds_per_dispatch=4, **kw).fit(X, yr)
    for a, b in zip(gb.trees_[:4], ref.trees_[:4]):
        _same(a, b)


def test_per_tree_forest_rescued(data, monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    X, y = data
    kw = dict(n_estimators=3, max_depth=4, random_state=0,
              refine_depth=None, device="cpu")
    ref = RandomForestClassifier(**kw).fit(X, y)
    chaos.install([Fault("level", 1, "oom", at_level=1, clears_after=1)])
    rf = RandomForestClassifier(**kw).fit(X, y)
    rep = rf.fit_report_
    assert rep["counters"]["oom_rescues"] == 1
    assert "device_failovers" not in rep["counters"]
    for a, b in zip(rf.trees_, ref.trees_):
        _same(a, b)


def test_batched_forest_rescued(data, monkeypatch):
    """The batched forest's build: an OOM in its first group's build
    (injected at the build itself: the fused engine has no level seam)
    runs the group again with the chunk halved."""
    X, y = data
    kw = dict(n_estimators=3, max_depth=4, random_state=0,
              refine_depth=None, device="cpu")
    ref = RandomForestClassifier(**kw).fit(X, y)
    real = fused_builder._grow_sharded
    seen = []

    def once(*a, **k):
        if not seen:
            seen.append(1)
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB (injected)")
        return real(*a, **k)

    monkeypatch.setattr(fused_builder, "_grow_sharded", once)
    rf = RandomForestClassifier(**kw).fit(X, y)
    rep = rf.fit_report_
    ev = [e for e in rep["events"] if e["kind"] == "oom_rescue"]
    assert len(ev) == 1 and ev[0]["binding_array"] == "split_hist_chunk"
    assert rep["memory"]["kind"] == "forest"
    assert rep["memory"]["inputs"]["chunk_slots"] == ev[0]["new_value"]
    for a, b in zip(rf.trees_, ref.trees_):
        _same(a, b)


def test_streamed_fit_rescued(data, monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    X, y = data
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=1_000)
    ref = DecisionTreeClassifier(device="cpu", **KW).fit(dataset=ds)
    chaos.install([Fault("level", 1, "oom", at_level=1, clears_after=1)])
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=1_000)
    clf = DecisionTreeClassifier(device="cpu", **KW).fit(dataset=ds)
    rep = clf.fit_report_
    assert rep["counters"]["oom_rescues"] == 1
    assert rep["memory"]["inputs"].get("streamed") is True
    _same(clf.tree_, ref.tree_)
