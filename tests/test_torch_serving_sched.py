"""The port's host-side serving tier on the CPU against the JAX package.

``serving/scheduler.py`` (EDF continuous batching with QoS admission),
``serving/staging.py`` (``StreamStage``), the request-path metrics of
``CompiledModel`` and ``ModelRegistry``, and ``compile_model`` of a single
regression tree with ``quantize="int8"``.

The scheduler's behaviours are driven as the JAX package's
``tests/test_serving_sched.py`` drives them, with stub models where that
file uses its chaos plans (the port has no chaos seams yet): a ``raw``
held on a ``threading.Event`` is a busy worker, a ``raw`` that raises is
a dispatch blip. Deadlines are seconds, not milliseconds, so a loaded
test runner cannot turn a pass into a miss. Every future is awaited with
a timeout and every scheduler is closed by its ``with`` block or a
``finally``.

Tolerances: one small JAX forest (``covtype_like(3_000, seed=0)``, 4
trees, depth 5) and one JAX regression tree are carried over to the port
(``from_reference``), so both packages serve the same trees. The float64
forest's answers, scheduled, staged or direct, equal JAX's CPU tier's
bit for bit; int8 forest answers equal the port's own direct ones bit for
bit and JAX's within 1e-6 (both float32, in another order, as in
``tests/test_torch_serving.py``). The quantized regression tree ends in
the float32 ``vbase + g * vscale`` of both packages: the port rounds the
product and the sum apart (as its exactness report's numpy oracle does,
and as the card does), and is held bit for bit to that two-rounding
oracle; XLA's CPU backend contracts the expression into one fused
multiply-add (one rounding of the exact value), so JAX's answers are held
bit for bit to that one-rounding oracle wherever the two packages differ,
and within half an ulp of the float32 product plus one ulp of the answer
everywhere. One ulp of the answer alone is not enough: where ``vbase``
and ``g * vscale`` nearly cancel, the product's rounding is several ulps
of the answer (2 on five of these 500 rows).
Metrics text, merged or per model, equals JAX's byte for byte on every
line that does not carry a measured wall time.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mpitree_tpu_torch.serving import (  # noqa: E402
    REJECT_REASONS,
    ModelRegistry,
    QuantizationError,
    RejectedRequest,
    Scheduler,
    StreamStage,
    compile_model,
    parse_qos,
)
from mpitree_tpu_torch.serving import model as model_lib  # noqa: E402
from mpitree_tpu_torch.serving import quantize  # noqa: E402
from mpitree_tpu_torch.tree import (  # noqa: E402
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    GradientBoostingClassifier,
    RandomForestClassifier,
    RandomForestRegressor,
)
from mpitree_tpu_torch.utils.datasets import (  # noqa: E402
    california_like,
    covtype_like,
)

# CPU-scale QoS spec, as in the JAX package's scheduler tests: the knob's
# default targets the card's latency.
_QOS = "interactive:10000:64;batch:60000:64"
BUCKETS = (1, 8, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread, as in the other port test files: under
    pytest-xdist's parallel workers torch's intra-op threads oversubscribe
    the cores; the answers do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(query rows, JAX forest, the port's copy of it)."""
    from mpitree_tpu.tree import RandomForestClassifier as JaxForest

    X, y = covtype_like(3_000, seed=0)
    jax_f = JaxForest(n_estimators=4, max_depth=5, random_state=0,
                      backend="cpu", refine_depth=None).fit(X, y)
    port = RandomForestClassifier.from_reference(
        [dataclasses.asdict(t) for t in jax_f.trees_], jax_f.classes_,
        jax_f.n_features_, device="cpu",
    )
    Xq, _ = covtype_like(300, seed=1)
    return Xq, jax_f, port


@pytest.fixture(scope="module")
def reg_pair():
    """(query rows, JAX regression tree, the port's copy of it)."""
    from mpitree_tpu.tree import DecisionTreeRegressor as JaxRegressor

    X, y = california_like(2_000, seed=0)
    ref = JaxRegressor(max_depth=7, backend="host").fit(X, y)
    port = DecisionTreeRegressor.from_reference(
        dataclasses.asdict(ref.tree_), X.shape[1], device="cpu")
    Xq, _ = california_like(500, seed=1)
    return Xq, ref, port


def _dequant_oracles(cm, X):
    """(two roundings, one rounding, the float32 product) of the
    quantized tree's ``vbase + g * vscale`` at each row's leaf: numpy's
    float32, as the exactness report takes it, and a fused
    multiply-add's (the product of an int8 code and a float32 scale is
    exact in float64, and on these rows so is the sum)."""
    q = cm._quant
    leaf = quantize._host_descend(
        X, cm.table.feature,
        q.threshold.to(torch.float32).numpy(), cm.table.left,
        cm.table.right, cm.table.root, cm.table.n_steps)[:, 0]
    g = q.qvals.numpy()[leaf, 0]
    vb, vs = q.qbase.numpy()[0], q.qscale.numpy()[0]
    prod = g.astype(np.float32) * vs
    two = vb + prod
    one = (np.float64(vb) + g.astype(np.float64) * np.float64(vs)).astype(
        np.float32)
    return two, one, prod


def _assert_quantized_tree(got, jax_got, cm, X):
    """The port bit for bit the two-rounding oracle; JAX the fused
    (one-rounding) result wherever they differ, and within the bound of
    the module docstring everywhere."""
    two, one, prod = _dequant_oracles(cm, X)
    np.testing.assert_array_equal(got, two)
    diff = got != jax_got
    np.testing.assert_array_equal(jax_got[diff], one[diff])
    bound = (0.5 * np.spacing(np.abs(prod)).astype(np.float64)
             + np.spacing(np.maximum(np.abs(got), np.abs(jax_got))))
    assert (np.abs(got.astype(np.float64) - jax_got) <= bound).all()


def _no_walls(text: str) -> list:
    """The exposition's lines without a measured wall time (the
    ``*_seconds`` histograms)."""
    return [ln for ln in text.splitlines() if "_seconds" not in ln]


# ---------------------------------------------------------------------------
# stub models: the deterministic levers
# ---------------------------------------------------------------------------

class _GateModel:
    """Stub model: echoes row ids, blocks in raw() while the gate is
    cleared (the deterministic 'worker is busy' lever)."""

    n_features = 2

    def __init__(self, buckets=(1, 2), delay=0.0, n_out=1):
        self.buckets = tuple(buckets)
        self.delay = delay
        self.n_out = n_out
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.calls = []   # list of per-dispatch row-id lists
        self.missed = 0

    def raw(self, X):
        self.entered.set()
        self.gate.wait(10)
        if self.delay:
            time.sleep(self.delay)
        self.calls.append([int(r[0]) for r in X])
        return np.repeat(np.asarray(X[:, :1], np.float32), self.n_out,
                         axis=1)

    def note_deadline_miss(self, n=1):
        self.missed += n


class _Proxy:
    """A real compiled model whose ``raw`` can be held on a gate, delayed,
    or made to raise on its first ``fail`` calls (a dispatch blip)."""

    def __init__(self, model, *, fail=0, delay=0.0):
        self.model = model
        self.fail = fail
        self.delay = delay
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def raw(self, X):
        self.entered.set()
        self.gate.wait(10)
        self.calls += 1
        if self.calls <= self.fail:
            raise RuntimeError("dispatch blip")
        if self.delay:
            time.sleep(self.delay)
        return self.model.raw(X)


class _StubRegistry:
    def __init__(self, models):
        self._models = dict(models)

    def get(self, name):
        if name not in self._models:
            raise KeyError(f"no model published as {name!r}")
        return self._models[name]

    def metrics_families(self):
        return []


def _hold(sched, model, row, name="m"):
    """Park the worker inside model.raw: clear the gate, submit one
    request, wait until the worker has entered raw()."""
    model.gate.clear()
    model.entered.clear()
    f = sched.submit(name, row, deadline_ms=30000)
    assert model.entered.wait(10), "worker never reached raw()"
    return f


# ---------------------------------------------------------------------------
# QoS grammar and knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "interactive:50:256;batch:2000:4096",
    "interactive:50:256; batch:2000:4096;",
    " gold : 1.5 : 3 ",
    "", ";;", "a:b:c", "a:10", "a:-5:4", "a:10:0", "a:10:2.5", "a:1:2:3",
])
def test_parse_qos_equals_jax(spec):
    from mpitree_tpu.serving import parse_qos as jax_parse_qos

    def run(fn):
        try:
            return [dataclasses.astuple(c) for c in fn(spec)]
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(parse_qos) == run(jax_parse_qos)


def test_scheduler_reads_its_knobs(monkeypatch):
    monkeypatch.setenv("MPITREE_TPU_SERVING_QOS", "gold:1000:4;bronze:9000:8")
    monkeypatch.setenv("MPITREE_TPU_SERVING_SHED_DEPTH", "16")
    monkeypatch.setenv("MPITREE_TPU_SERVING_MARGIN_MS", "7")
    monkeypatch.setenv("MPITREE_TPU_SERVING_WAIT_MS", "3")
    with Scheduler(_StubRegistry({})) as s:
        assert [c.name for c in s.qos] == ["gold", "bronze"]
        assert s.default_qos == "gold" and s.shed_depth == 16
        assert (s.margin_s, s.wait_s) == (7e-3, 3e-3)
    monkeypatch.setenv("MPITREE_TPU_SERVING_QOS", "gold:0:4")
    with pytest.raises(ValueError, match="positive"):
        Scheduler(_StubRegistry({}))
    assert set(REJECT_REASONS) == {"queue_full", "deadline_infeasible",
                                   "unknown_model", "unknown_class",
                                   "shutdown"}


# ---------------------------------------------------------------------------
# scheduling behaviour, stub models
# ---------------------------------------------------------------------------

def test_edf_tight_deadline_jumps_queued_backlog():
    m = _GateModel(buckets=(1, 2))
    with Scheduler(_StubRegistry({"m": m}), qos=_QOS, shed_depth=64,
                   margin_ms=5, wait_ms=1) as s:
        f0 = _hold(s, m, [0, 0.0])
        loose = [s.submit("m", [i, 0.0], deadline_ms=20000 - i * 1000)
                 for i in (1, 2, 3, 4)]
        tight = s.submit("m", [9, 0.0], deadline_ms=1000)  # arrives last
        m.gate.set()
        for f in [f0, tight, *loose]:
            assert f.result(timeout=10).shape == (1,)
        order = [i for batch in m.calls for i in batch]
        # earliest deadline first, not first in
        assert order == [0, 9, 4, 3, 2, 1]
        assert s.stats()["dispatches"] == len(m.calls)


def test_qos_depth_bound_sheds_only_that_class():
    m = _GateModel(buckets=(1, 64))
    spec = "interactive:10000:3;batch:60000:64"
    with Scheduler(_StubRegistry({"m": m}), qos=spec, shed_depth=64,
                   margin_ms=5, wait_ms=1) as s:
        f0 = _hold(s, m, [0, 0.0])
        admitted = [s.submit("m", [i, 0.0], qos="interactive")
                    for i in (1, 2, 3)]
        with pytest.raises(RejectedRequest) as ei:
            s.submit("m", [4, 0.0], qos="interactive")
        assert ei.value.reason == "queue_full"
        assert s.queue_depth("m") == 3 and s.queue_depth() == 3
        b = s.submit("m", [5, 0.0], qos="batch")  # the other class admits
        m.gate.set()
        for f in [f0, b, *admitted]:
            f.result(timeout=10)
        assert s.stats()["shed"] == {"queue_full": 1}


def test_typed_rejects_global_depth_unknowns_shutdown():
    m = _GateModel(buckets=(1, 2))
    s = Scheduler(_StubRegistry({"m": m}), qos=_QOS, shed_depth=2,
                  margin_ms=5, wait_ms=1)
    try:
        with pytest.raises(RejectedRequest) as ei:
            s.submit("ghost", [0.0, 0.0])
        assert ei.value.reason == "unknown_model"
        with pytest.raises(RejectedRequest) as ei:
            s.submit("m", [0.0, 0.0], qos="premium")
        assert ei.value.reason == "unknown_class"
        with pytest.raises(ValueError, match="features"):
            s.submit("m", [0.0, 0.0, 0.0])
        f0 = _hold(s, m, [0, 0.0])
        f1 = s.submit("m", [1, 0.0])
        f2 = s.submit("m", [2, 0.0])
        with pytest.raises(RejectedRequest) as ei:  # global in-flight bound
            s.submit("m", [3, 0.0])
        assert ei.value.reason == "queue_full"
        m.gate.set()
        for f in (f0, f1, f2):
            f.result(timeout=10)
    finally:
        m.gate.set()
        s.close()
    with pytest.raises(RejectedRequest) as ei:
        s.submit("m", [0.0, 0.0])
    assert ei.value.reason == "shutdown"
    shed = s.stats()["shed"]
    assert shed == {"queue_full": 1, "shutdown": 1, "unknown_model": 1,
                    "unknown_class": 1}


def test_close_without_drain_fails_the_backlog():
    m = _GateModel(buckets=(1, 2))
    s = Scheduler(_StubRegistry({"m": m}), qos=_QOS, shed_depth=8,
                  margin_ms=5, wait_ms=1)
    try:
        f0 = _hold(s, m, [0, 0.0])
        queued = [s.submit("m", [i, 0.0]) for i in (1, 2)]
    finally:
        m.gate.set()
        s.close(drain=False)
    f0.result(timeout=10)
    for f in queued:
        with pytest.raises(RejectedRequest) as ei:
            f.result(timeout=10)
        assert ei.value.reason == "shutdown"


def test_deadline_feasibility_sheds_and_recovers():
    m = _GateModel(buckets=(1, 2), delay=0.3)
    with Scheduler(_StubRegistry({"m": m}), qos=_QOS, shed_depth=64,
                   margin_ms=100, wait_ms=1) as s:
        # inside the close margin: infeasible even on an idle queue
        with pytest.raises(RejectedRequest) as ei:
            s.submit("m", [0, 0.0], deadline_ms=50)
        assert ei.value.reason == "deadline_infeasible"
        s.submit("m", [1, 0.0]).result(timeout=10)  # the EWMA: >= 0.3 s
        f0 = _hold(s, m, [2, 0.0])
        q = s.submit("m", [3, 0.0])  # queued ahead of the next arrival
        with pytest.raises(RejectedRequest) as ei:
            s.submit("m", [4, 0.0], deadline_ms=200)  # 0.2 s < the EWMA
        assert ei.value.reason == "deadline_infeasible"
        m.gate.set()
        f0.result(timeout=10)
        q.result(timeout=10)
        assert s.drain(10)
        # recovery: the same deadline on an idle queue is admitted
        m.delay = 0.0
        out = s.submit("m", [5, 0.0], deadline_ms=200).result(timeout=10)
        assert out[0] == 5.0
        assert s.stats()["shed"]["deadline_infeasible"] == 2


def test_deadline_miss_counted_and_reported_to_model():
    m = _GateModel(buckets=(1, 2), delay=0.5)
    with Scheduler(_StubRegistry({"m": m}), qos=_QOS, shed_depth=8,
                   margin_ms=5, wait_ms=1) as s:
        # no estimate yet: admitted; the dispatch overruns the deadline
        s.submit("m", [0, 0.0], deadline_ms=200).result(timeout=10)
        st = s.stats()
    assert st["deadline_misses"] == 1
    assert m.missed == 1
    assert st["class_latency_ms"]["interactive"]["count"] == 1


# ---------------------------------------------------------------------------
# real compiled models
# ---------------------------------------------------------------------------

def test_deadline_miss_lands_in_the_model_metrics(pair):
    Xq, _, port = pair
    cm = compile_model(port, buckets=BUCKETS)
    proxy = _Proxy(cm, delay=0.5)
    with Scheduler(_StubRegistry({"rf": proxy}), qos=_QOS, shed_depth=8,
                   margin_ms=5, wait_ms=1) as s:
        got = s.submit("rf", Xq[0], deadline_ms=200).result(timeout=10)
    np.testing.assert_array_equal(got, cm.raw(Xq[:1])[0])
    assert "mpitree_serving_deadline_misses_total 1\n" in cm.metrics_text()


def test_burst_sheds_queue_full_and_answers_every_admitted(pair):
    """2 x ``shed_depth`` submissions at once behind a held worker: the
    first ``shed_depth`` are admitted and answered right, the rest shed
    with ``queue_full``; both classes admit again after the burst."""
    Xq, _, port = pair
    cm = compile_model(port, buckets=BUCKETS)
    proxy = _Proxy(cm)
    shed_depth = 8
    with Scheduler(_StubRegistry({"rf": proxy}), qos=_QOS,
                   shed_depth=shed_depth, margin_ms=5, wait_ms=1) as s:
        f0 = _hold(s, proxy, Xq[0], name="rf")
        admitted, reasons = {}, []
        for i in range(1, 2 * shed_depth + 1):
            try:
                admitted[i] = s.submit(
                    "rf", Xq[i], qos="interactive" if i % 2 else "batch")
            except RejectedRequest as e:
                reasons.append(e.reason)
        assert sorted(admitted) == list(range(1, shed_depth + 1))
        assert reasons == ["queue_full"] * shed_depth
        proxy.gate.set()
        f0.result(timeout=10)
        want = cm.raw(Xq[:2 * shed_depth + 1])
        for i, f in admitted.items():
            np.testing.assert_array_equal(f.result(timeout=10), want[i])
        assert s.stats()["shed"] == {"queue_full": shed_depth}
        for q in ("interactive", "batch"):
            s.submit("rf", Xq[0], qos=q).result(timeout=10)


def test_failed_dispatch_requeues_once_with_correct_results(pair):
    Xq, _, port = pair
    cm = compile_model(port, buckets=BUCKETS)
    proxy = _Proxy(cm, fail=1)
    with Scheduler(_StubRegistry({"rf": proxy}), qos=_QOS, shed_depth=64,
                   margin_ms=5, wait_ms=1) as s:
        futs = [s.submit("rf", Xq[i]) for i in range(3)]
        got = np.stack([f.result(timeout=10) for f in futs])
        assert s.stats()["requeues"] >= 1
    np.testing.assert_array_equal(got, cm.raw(Xq[:3]))


def test_dispatch_failing_twice_fails_its_futures(pair):
    Xq, _, port = pair
    proxy = _Proxy(compile_model(port, buckets=BUCKETS), fail=10 ** 6)
    with Scheduler(_StubRegistry({"rf": proxy}), qos=_QOS, shed_depth=64,
                   margin_ms=5, wait_ms=1) as s:
        f = s.submit("rf", Xq[0])
        with pytest.raises(RuntimeError, match="dispatch blip"):
            f.result(timeout=10)
        st = s.stats()
    assert st["requeues"] == 1 and st["dispatches"] == 0
    assert proxy.calls == 2


@pytest.mark.parametrize("quant", [None, "int8"])
def test_scheduled_results_equal_direct_raw_and_jax(pair, quant):
    from mpitree_tpu.serving import compile_model as jax_compile

    Xq, jax_f, port = pair
    reg = ModelRegistry(buckets=BUCKETS)
    cm = reg.publish("rf", port, quantize=quant)
    assert cm.quantize == quant
    with Scheduler(reg, qos=_QOS, shed_depth=256, margin_ms=5,
                   wait_ms=2) as s:
        futs = [s.submit("rf", Xq[i], qos="interactive" if i % 3 else "batch")
                for i in range(40)]
        got = np.stack([f.result(timeout=30) for f in futs])
        assert s.drain(10) and s.queue_depth() == 0
    # coalescing is invisible: each row equals the direct batch answer
    np.testing.assert_array_equal(got, cm.raw(Xq[:40]))
    want = jax_compile(jax_f, buckets=BUCKETS, quantize=quant).raw(Xq[:40])
    if quant is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_metrics_text_merges_families_like_jax(pair):
    from mpitree_tpu.serving import ModelRegistry as JaxRegistry
    from mpitree_tpu.serving import Scheduler as JaxScheduler

    Xq, jax_f, port = pair
    texts = []
    for Reg, Sched, est in ((ModelRegistry, Scheduler, port),
                            (JaxRegistry, JaxScheduler, jax_f)):
        reg = Reg(buckets=BUCKETS)
        reg.publish("rf", est)
        reg.publish("rf_b", est)
        with Sched(reg, qos=_QOS, shed_depth=64, margin_ms=5,
                   wait_ms=1) as s:
            s.submit("rf", Xq[0]).result(timeout=30)
            with pytest.raises(RuntimeError, match="no model published"):
                s.submit("ghost", Xq[0])  # each package's RejectedRequest
            texts.append(s.metrics_text())
    got, want = texts
    for needle in ('mpitree_sched_shed_total{reason="unknown_model"} 1',
                   "mpitree_sched_dispatches_total 1",
                   'mpitree_sched_queue_depth{model="rf",qos="interactive"}',
                   "mpitree_sched_class_latency_seconds",
                   'mpitree_serving_request_seconds_count{bucket="1",'
                   'model="rf"} 1',
                   'mpitree_serving_retries_total{model="rf_b"} 0'):
        assert needle in got, needle
    types = [ln for ln in got.splitlines() if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))
    assert types == [ln for ln in want.splitlines()
                     if ln.startswith("# TYPE")]
    assert _no_walls(got) == _no_walls(want)


def test_registry_metrics_text_stamps_each_slot(pair):
    Xq, _, port = pair
    reg = ModelRegistry(buckets=BUCKETS)
    reg.publish("rf", port)
    reg.publish("rf", port)
    reg.publish("rf8", port, quantize="int8")
    reg.raw("rf8", Xq[:5])
    text = reg.metrics_text()
    assert 'mpitree_registry_publish_total{model="rf"} 2\n' in text
    assert 'mpitree_registry_warm_seconds_count{model="rf8"} 1\n' in text
    assert 'mpitree_serving_latency_rows_total{model="rf8"} 5\n' in text
    assert 'mpitree_serving_requests_total{model="rf"} 3\n' in text
    types = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))


def test_raw_latency_lands_in_its_bucket_like_jax(pair):
    from mpitree_tpu.serving import compile_model as jax_compile

    Xq, jax_f, port = pair
    sizes = (1, 5, 37, 64, 200)  # 200: four chunks of the largest bucket
    summaries, texts = [], []
    for cm in (compile_model(port, buckets=BUCKETS),
               jax_compile(jax_f, buckets=BUCKETS)):
        cm.warmup()  # counted, never clocked
        for n in sizes:
            cm.raw(Xq[:n])
        cm.note_deadline_miss(2)
        summaries.append(cm.latency_summary())
        texts.append(cm.metrics_text({"model": "m"}))
    got, want = summaries
    assert {k: v["count"] for k, v in got["buckets"].items()} == \
        {k: v["count"] for k, v in want["buckets"].items()} == \
        {"1": 1, "8": 1, "64": 2, "oversize": 1}
    for key in ("requests", "rows", "rows_latency_clocked"):
        assert got[key] == want[key]
    assert got["rows_latency_clocked"] == sum(sizes)
    assert got["rows_per_s_sustained"] > 0
    assert _no_walls(texts[0]) == _no_walls(texts[1])


# ---------------------------------------------------------------------------
# the stream stage
# ---------------------------------------------------------------------------

def test_stream_stage_parity_and_backpressure():
    X, y = covtype_like(300, seed=2)
    g = GradientBoostingClassifier(max_iter=6, max_depth=3, random_state=0,
                                   device="cpu").fit(X, (y == 1).astype(int))
    cm = compile_model(g, buckets=(64,))
    stage = StreamStage(cm, depth=2)
    results = []
    for lo in range(0, 300, 30):
        results += stage.submit(X[lo:lo + 30])
        assert len(stage._inflight) <= 2  # backpressure bound
    results += stage.drain()
    assert [t for t, _ in results] == list(range(10))  # order preserved
    got = np.concatenate([r for _, r in results], axis=0)
    assert np.array_equal(got, cm.raw(X))


def test_stream_stage_forest_mean_shape():
    X, y = california_like(400, seed=2)
    f = RandomForestRegressor(n_estimators=4, max_depth=4, random_state=0,
                              device="cpu").fit(X, y)
    cm = compile_model(f, buckets=(64,))
    stage = StreamStage(cm, depth=2)
    [(_, out)] = stage.submit(X[:50]) + stage.drain()
    assert out.shape == (50,)
    assert np.array_equal(out, f.predict(X[:50]))


def test_stream_stage_rejects_bad_depth():
    X, y = covtype_like(300, seed=2)
    t = DecisionTreeClassifier(max_depth=3, device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="depth"):
        StreamStage(compile_model(t), depth=0)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_stream_stage_equals_jax_stage(pair, depth):
    """The same batches (in a bucket, padded, oversize) through the port's
    stage and JAX's: the same tickets and answers bit for bit, and the
    same metrics text (nothing clocked), inflight gauge and staged count
    included."""
    from mpitree_tpu.serving import StreamStage as JaxStage
    from mpitree_tpu.serving import compile_model as jax_compile

    Xq, jax_f, port = pair
    cms = (compile_model(port, buckets=BUCKETS),
           jax_compile(jax_f, buckets=BUCKETS))
    sizes = (1, 8, 37, 64, 100, 3, 1)
    runs = []
    for cm, Stage in zip(cms, (StreamStage, JaxStage)):
        stage = Stage(cm, depth=depth)
        done, lo = [], 0
        for n in sizes:
            done += stage.submit(Xq[lo:lo + n])
            lo += n
        assert len(stage._inflight) == min(depth, len(sizes))
        done += stage.drain()
        runs.append(done)
    got, want = runs
    assert [t for t, _ in got] == [t for t, _ in want] == \
        list(range(len(sizes)))
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    text = cms[0].metrics_text()
    assert text == cms[1].metrics_text()
    assert f"mpitree_serving_staged_batches_total {len(sizes)}\n" in text
    assert "mpitree_serving_inflight 0\n" in text


# ---------------------------------------------------------------------------
# quantize= for a single regression tree
# ---------------------------------------------------------------------------

def test_quantized_regression_tree_equals_jax(reg_pair):
    """``compile_model(DecisionTreeRegressor(), quantize="int8")``: the
    report equal to JAX's; the answers as the module docstring states
    (JAX's fused multiply-add: one ulp at most) and within the report of
    the float64 tree."""
    from mpitree_tpu.serving import compile_model as jax_compile

    Xq, ref, port = reg_pair
    cm = compile_model(port, quantize="int8", buckets=BUCKETS)
    jcm = jax_compile(ref, quantize="int8", buckets=BUCKETS)
    assert cm.quantize == jcm.quantize == "int8"
    assert not cm.exact and cm.dispatch == "plain gather"
    rep = cm.serve_report_["quantization"]
    assert rep == jcm.serve_report_["quantization"]
    got = cm.raw(Xq)
    assert got.dtype == np.float32 and got.shape == (len(Xq),)
    _assert_quantized_tree(got, jcm.raw(Xq), cm, Xq)
    _assert_quantized_tree(cm.predict(Xq[:7]), jcm.predict(Xq[:7]), cm,
                           Xq[:7])
    cal = quantize.synthesize_calibration(cm.table, Xq.shape[1])
    assert np.abs(cm.raw(cal) - port.predict(cal)).max() <= \
        rep["max_abs_delta"] + 1e-6


def test_q_traverse_gather_equals_jax(reg_pair):
    from mpitree_tpu.serving import quantize as jax_quantize
    from mpitree_tpu.serving.tables import tables_for as jax_tables_for

    Xq, ref, port = reg_pair
    cm = compile_model(port, quantize="int8")
    q = cm._quant
    [jt] = jax_tables_for([ref.tree_], group_bytes=None)
    flat = np.asarray(ref.tree_.count[:, 0], np.float64)[jt.scatter_order()]
    js = jax_quantize.build_state(
        jt, flat[:, None], kind="gather_value", scale=1.0,
        n_steps=jt.n_steps, tol=1e-2, n_features=Xq.shape[1])
    want = jax_quantize.q_traverse_gather(
        Xq, js.feature, js.threshold, js.left, js.right, js.root, js.qvals,
        js.vscale, js.vbase, n_steps=jt.n_steps)
    got = quantize.q_traverse_gather(
        torch.from_numpy(Xq), q.feature, q.threshold, q.left, q.right,
        q.root, q.qvals, q.qscale, q.qbase, n_steps=cm.table.n_steps)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(q.qvals.numpy(), np.asarray(js.qvals))
    np.testing.assert_array_equal(q.qscale.numpy(), np.asarray(js.vscale))
    np.testing.assert_array_equal(q.qbase.numpy(), np.asarray(js.vbase))
    _assert_quantized_tree(got.numpy(), np.asarray(want), cm, Xq)


def test_quantize_knobs_steer_compile_like_jax(reg_pair, monkeypatch):
    from mpitree_tpu.serving import compile_model as jax_compile
    from mpitree_tpu.serving.quantize import (
        QuantizationError as JaxQuantizationError,
    )

    Xq, ref, port = reg_pair
    monkeypatch.setenv("MPITREE_TPU_SERVING_QUANTIZE", "int8")
    cm, jcm = compile_model(port), jax_compile(ref)
    assert cm.quantize == jcm.quantize == "int8"
    _assert_quantized_tree(cm.raw(Xq[:9]), jcm.raw(Xq[:9]), cm, Xq[:9])
    assert compile_model(port, quantize="off").quantize is None
    reg = ModelRegistry(buckets=BUCKETS)
    assert reg.publish("t", port).quantize == "int8"
    monkeypatch.setenv("MPITREE_TPU_SERVING_QUANTIZE_TOL", "1e-12")
    with pytest.raises(QuantizationError):
        compile_model(port)
    with pytest.raises(JaxQuantizationError):
        jax_compile(ref)
    # the integer channel passes through unquantized
    X, y = covtype_like(300, seed=2)
    t = DecisionTreeClassifier(max_depth=3, device="cpu").fit(X, y)
    assert compile_model(t).quantize is None


# ---------------------------------------------------------------------------
# the pinned-slot pool's reuse discipline (host logic; the card's path
# itself is in tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

def test_pinned_slot_is_reused_only_after_its_event(monkeypatch):
    class _Event:
        def __init__(self):
            self.done = True

        def query(self):
            return self.done

    class _FakeSlot:
        def __init__(self, shape, dtype):
            self.tensor = torch.empty(shape, dtype=dtype)
            self.event = _Event()

    monkeypatch.setattr(model_lib, "_Slot", _FakeSlot)
    pool = model_lib.PinnedSlots(cap=model_lib.SLOTS_PER_SHAPE)
    a = pool.take((4, 2), torch.float32)
    a.event.done = False  # a copy still reads it
    pool.give(a)
    b = pool.take((4, 2), torch.float32)
    assert b is not a and pool.allocated == 2
    assert pool.take((8, 2), torch.float32) is not a  # another shape
    a.event.done = True
    assert pool.take((4, 2), torch.float32) is a
    pool.give(b)
    assert pool.take((4, 2), torch.float32) is b and pool.allocated == 3


def test_pinned_pool_keeps_at_most_cap_free_slots_per_shape(monkeypatch):
    """A burst that takes many slots of one shape leaves at most ``cap``
    of them pooled once they come back; each shape has its own cap."""
    class _Done:
        def query(self):
            return True

    class _FakeSlot:
        def __init__(self, shape, dtype):
            self.tensor = torch.empty(shape, dtype=dtype)
            self.event = _Done()

    monkeypatch.setattr(model_lib, "_Slot", _FakeSlot)
    pool = model_lib.PinnedSlots(cap=3)
    burst = [pool.take((4, 2), torch.float32) for _ in range(10)]
    other = [pool.take((1, 2), torch.float64) for _ in range(2)]
    for slot in burst + other:
        pool.give(slot)
    assert pool.allocated == 12 and pool.kept == 3 + 2
    again = [pool.take((4, 2), torch.float32) for _ in range(5)]
    assert sum(s in burst for s in again) == 3 and pool.allocated == 14
