"""The port's Chrome traces (``mpitree_tpu_torch.obs.trace``) and
``utils.profiling.trace`` against the JAX package's contracts.

- ``fit(trace_to=...)`` is accepted wherever the JAX package accepts it
  (the tree estimators, ``ParallelDecisionTreeClassifier``, the forests,
  boosting, a streamed fit), and its file passes **JAX's**
  ``mpitree_tpu.obs.trace.validate_trace`` and the port's;
- live engine spans (levelwise) and replayed level spans inside the fused
  build's window (fused), a shared sink over fits and a served model's
  ``serving`` track, re-reports that replace rather than duplicate;
- ``MPITREE_TPU_TRACE_DIR``, the unwritable sink's ``trace_failed``
  degrade, ``merge_trace_files``;
- ``utils.profiling.trace``: a ``torch.profiler`` trace file, and the
  entry-failure contract (a half-started profiler stopped, a
  ``trace_unavailable`` event, the block still runs);
- the served model's record: counters, spans and the ensemble
  fingerprint equal to JAX's ``serve_report_``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import mpitree_tpu as J  # noqa: E402
from mpitree_tpu.obs import trace as jax_trace  # noqa: E402
from mpitree_tpu_torch import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    ExtraTreesClassifier,
    ExtraTreesRegressor,
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    ParallelDecisionTreeClassifier,
    RandomForestClassifier,
    RandomForestRegressor,
    StreamedDataset,
)
from mpitree_tpu_torch.obs import (  # noqa: E402
    BuildObserver,
    ensemble_fingerprint,
)
from mpitree_tpu_torch.obs import trace as trace_mod  # noqa: E402
from mpitree_tpu_torch.serving import compile_model  # noqa: E402
from mpitree_tpu_torch.utils import profiling  # noqa: E402
from mpitree_tpu_torch.utils.datasets import covtype_like  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module's fits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    X, y = covtype_like(2_000, seed=1)
    return X, y, (X[:, 0] / 1000.0 + (y == 1)).astype(np.float64)


def _valid(path) -> dict:
    tr = json.load(open(path))
    assert jax_trace.validate_trace(tr) == []
    assert trace_mod.validate_trace(tr) == []
    return tr


ESTIMATORS = {
    "tree": lambda: DecisionTreeClassifier(max_depth=4, device="cpu"),
    "parallel": lambda: ParallelDecisionTreeClassifier(
        max_depth=4, n_devices=None, device="cpu"),
    "regressor": lambda: DecisionTreeRegressor(max_depth=4, device="cpu"),
    "forest": lambda: RandomForestClassifier(n_estimators=2, max_depth=3,
                                             random_state=0, device="cpu"),
    "forest_regressor": lambda: RandomForestRegressor(
        n_estimators=2, max_depth=3, random_state=0, device="cpu"),
    "extra_trees": lambda: ExtraTreesClassifier(
        n_estimators=2, max_depth=3, random_state=0, device="cpu"),
    "extra_trees_regressor": lambda: ExtraTreesRegressor(
        n_estimators=2, max_depth=3, random_state=0, device="cpu"),
    "boosting": lambda: GradientBoostingClassifier(max_iter=2, max_depth=3,
                                                   device="cpu"),
    "boosting_regressor": lambda: GradientBoostingRegressor(
        max_iter=2, max_depth=3, device="cpu"),
}


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_trace_to_on_every_estimator_validates_in_jax(data, tmp_path, name):
    X, y, yr = data
    est = ESTIMATORS[name]()
    regress = "regressor" in name
    path = tmp_path / f"{name}.trace.json"
    est.fit(X, yr if regress else y, trace_to=path)
    tr = _valid(path)
    names = {e["name"] for e in tr["traceEvents"]}
    assert "bin" in names
    # tracing implies timing: the phase summary is kept
    assert est.fit_stats_ and "bin" in est.fit_stats_


def test_streamed_fit_takes_trace_to(data, tmp_path):
    X, y, _ = data
    ds = StreamedDataset.from_arrays(X, y, chunk_rows=512)
    path = tmp_path / "stream.json"
    clf = DecisionTreeClassifier(max_depth=4, device="cpu").fit(
        dataset=ds, trace_to=path)
    _valid(path)
    assert clf.fit_report_["decisions"]["ingest"]["value"] == "streamed"


def test_levelwise_trace_has_live_spans_and_level_rows(data, tmp_path,
                                                       monkeypatch):
    X, y, _ = data
    monkeypatch.setenv("MPITREE_TPU_ENGINE", "levelwise")
    path = tmp_path / "lw.json"
    DecisionTreeClassifier(max_depth=4, refine_depth=None, device="cpu").fit(
        X, y, trace_to=path)
    tr = _valid(path)
    names = {e["name"] for e in tr["traceEvents"]}
    assert {"shard", "split", "update", "counts"} <= names
    assert any(n.startswith("level ") for n in names)
    assert any(e["ph"] == "C" for e in tr["traceEvents"])


def test_fused_replay_spans_inside_the_build_window(data, tmp_path):
    X, y, _ = data
    path = tmp_path / "fz.json"
    DecisionTreeClassifier(max_depth=4, refine_depth=None, device="cpu").fit(
        X, y, trace_to=path)
    evs = _valid(path)["traceEvents"]
    build = [e for e in evs if e["name"] == "fused_build"]
    assert len(build) == 1
    lo = min(e["ts"] for e in evs if e["name"] in ("shard", "fused_build",
                                                   "host_finalize"))
    hi = max(e["ts"] + e["dur"] for e in evs
             if e["name"] in ("shard", "fused_build", "host_finalize"))
    replay = [e for e in evs if e.get("cat") == "replay"
              and e["name"].startswith("level ")]
    assert len(replay) == 5  # depth 4: levels 0..4
    for e in replay:
        assert lo - 1 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1
        assert "frontier" in e["args"]


def test_shared_sink_holds_fits_levels_rounds_and_serving(data, tmp_path):
    X, y, yr = data
    sink = trace_mod.TraceSink(str(tmp_path / "shared.json"))
    rf = RandomForestClassifier(n_estimators=2, max_depth=3, random_state=0,
                                device="cpu").fit(X, y, trace_to=sink)
    gb = GradientBoostingRegressor(max_iter=2, max_depth=3,
                                   device="cpu").fit(X, yr, trace_to=sink)
    tree = DecisionTreeClassifier(max_depth=3, refine_depth=None,
                                  device="cpu").fit(X, y, trace_to=sink)
    cm = compile_model(rf)
    cm.trace_to(sink)
    cm.raw(X[:64])
    rep = cm.serve_report_
    assert rep["counters"]["serving_dispatches"] >= 1
    assert rep["counters"]["serving_requests"] == 1
    path = sink.write()
    tr = _valid(path)
    tracks = {e["args"]["name"] for e in tr["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "serving" in tracks
    assert any(t.endswith(":levels") for t in tracks)
    assert any(t.endswith(":rounds") for t in tracks)
    spans = [e for e in tr["traceEvents"] if e["ph"] == "X"]
    assert any(e["name"] == "serving_dispatch" for e in spans)
    assert any(e["name"] == "forest_build" for e in spans)
    assert rf.fit_report_ and gb.fit_report_ and tree.fit_report_
    n = len(sink.events())
    cm.serve_report_  # a re-report replaces its replay, never duplicates
    assert len(sink.events()) == n


def test_serve_report_fingerprint_and_counters_equal_jax(data):
    from mpitree_tpu.serving import compile_model as jax_compile

    X, y, _ = data
    kw = dict(n_estimators=2, max_depth=3, random_state=0)
    port = RandomForestClassifier(device="cpu", **kw).fit(X, y)
    ref = J.RandomForestClassifier(backend="cpu", **kw).fit(X, y)
    cp, cj = compile_model(port), jax_compile(ref)
    cp.raw(X[:10])
    cj.raw(X[:10])
    p, j = cp.serve_report_, cj.serve_report_
    # the whole model's stamp: every finished member's level rows
    assert p["fingerprints"]["fit"] == j["fingerprints"]["fit"] == \
        ensemble_fingerprint(port.trees_)
    for k in ("serving_requests", "serving_rows"):
        assert p["counters"][k] == j["counters"][k], k
    assert p["schema"] == j["schema"] == 9


def test_re_report_replaces_the_replay(tmp_path):
    sink = trace_mod.TraceSink(str(tmp_path / "s.json"))
    o = BuildObserver(timing=False)
    o.trace_to(sink)
    with o.span("split"):
        pass
    o.level(level=0, frontier=1, psum_bytes=10, seconds=0.001)
    o.level(level=1, frontier=2, psum_bytes=20, seconds=None)
    o.round(round=0, trees=1)
    n1 = len(sink.events())
    o.report()
    n2 = len(sink.events())
    assert n2 > n1
    o.report()
    assert len(sink.events()) == n2
    _valid(sink.write())


def test_trace_dir_env_traces_every_fit(data, tmp_path, monkeypatch):
    X, y, _ = data
    monkeypatch.setenv(trace_mod.TRACE_DIR_ENV, str(tmp_path))
    clf = DecisionTreeClassifier(max_depth=3, device="cpu").fit(X, y)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    _valid(files[0])
    assert clf.fit_stats_ is not None  # tracing implies timing


def test_unwritable_trace_sink_degrades(data, tmp_path):
    X, y, _ = data
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    clf = DecisionTreeClassifier(max_depth=3, device="cpu").fit(
        X, y, trace_to=blocker / "sub" / "t.json")
    assert hasattr(clf, "tree_")
    assert [e["kind"] for e in clf.fit_report_["events"]] == ["trace_failed"]


def test_merge_trace_files_validates_in_jax(tmp_path):
    import time

    s1 = trace_mod.TraceSink(str(tmp_path / "a.json"))
    s1.complete("t", "x", time.perf_counter(), 0.001)
    s1.write()
    s2 = trace_mod.TraceSink(str(tmp_path / "b.json"))
    s2.instant("t", "y")
    s2.write()
    (tmp_path / "broken.json").write_text("{nope")
    out = trace_mod.merge_trace_files(
        [str(tmp_path / p) for p in ("a.json", "b.json", "broken.json")],
        str(tmp_path / "merged.json"))
    merged = _valid(out)
    assert {e["pid"] for e in merged["traceEvents"]} == {1, 2}
    assert trace_mod.merge_trace_files(
        [str(tmp_path / "broken.json")], str(tmp_path / "m2.json")) is None


def test_validate_trace_equals_jax_on_broken_traces():
    bad = [
        {"traceEvents": [{"ph": "X", "pid": 1, "tid": 1, "name": "a",
                          "ts": -1, "dur": 1}]},
        {"traceEvents": [{"ph": "Q", "pid": 1, "tid": 1, "name": "a"}]},
        {"traceEvents": [
            {"ph": "M", "pid": 1, "tid": 1, "ts": 0, "name": "thread_name",
             "args": {"name": "t"}},
            {"ph": "X", "pid": 1, "tid": 1, "name": "a", "ts": 5, "dur": 1},
            {"ph": "X", "pid": 1, "tid": 1, "name": "b", "ts": 2, "dur": 1},
            {"ph": "C", "pid": 1, "tid": 1, "name": "c", "ts": 9,
             "args": {"v": "x"}}]},
        [],
    ]
    for tr in bad:
        got = trace_mod.validate_trace(tr)
        assert got and got == jax_trace.validate_trace(tr)


def test_profiler_trace_writes_a_torch_trace(tmp_path, data):
    X, y, _ = data
    o = BuildObserver(timing=False)
    with profiling.trace(str(tmp_path / "prof"), on_event=o.event):
        DecisionTreeClassifier(max_depth=2, refine_depth=None,
                               device="cpu").fit(X[:500], y[:500])
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    assert json.load(open(files[0]))["traceEvents"]
    assert o.record.events == []


def test_profiler_trace_entry_failure_contract(monkeypatch):
    """A start that fails after the profiler half-started: the session is
    stopped, a ``trace_unavailable`` event goes to ``on_event``, the block
    runs; a later trace works again (nothing stays active)."""
    import torch.profiler as tp

    real = tp.profile.__enter__

    def boom(self):
        real(self)  # the profiler is live now
        raise RuntimeError("log dir unwritable")

    monkeypatch.setattr(tp.profile, "__enter__", boom)
    o = BuildObserver(timing=False)
    ran = False
    with profiling.trace("/nonexistent/dir", on_event=o.event):
        ran = True
    assert ran
    assert not torch.autograd._profiler_enabled()
    assert o.record.events == [{
        "kind": "trace_unavailable",
        "message": "RuntimeError: log dir unwritable",
    }]
    # without a callback it is silent
    with profiling.trace("/nonexistent/dir"):
        pass
    assert not torch.autograd._profiler_enabled()


def test_profiler_trace_propagates_the_block_error(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with profiling.trace(str(tmp_path / "p")):
            raise ValueError("inside")
    assert not torch.autograd._profiler_enabled()
