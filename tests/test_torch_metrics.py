"""The port's serving metrics and knobs against the JAX package's.

``mpitree_tpu_torch.obs.metrics`` and ``mpitree_tpu_torch.config.knobs``
are copies of ``mpitree_tpu.obs.metrics`` and ``mpitree_tpu.config.knobs``
(the port never imports the JAX package), so they are held to them
exactly: the same sequence of counter, gauge and histogram operations
gives byte-identical Prometheus text and equal quantiles, the registered
knobs have the JAX package's names, defaults, parse rules and choices, and
their values and parse errors under the same environment are equal.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mpitree_tpu.config import knobs as jax_knobs  # noqa: E402
from mpitree_tpu.obs import metrics as jax_metrics  # noqa: E402

from mpitree_tpu_torch.config import knobs  # noqa: E402
from mpitree_tpu_torch.obs import metrics  # noqa: E402

EXEMPLARS = "MPITREE_TPU_METRICS_EXEMPLARS"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread, as in the other port test files: under
    pytest-xdist's parallel workers torch's intra-op threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(mod, seed: int = 0):
    """One registry of module ``mod`` through a fixed sequence of
    operations (made from ``seed`` with numpy): labels that need escaping,
    fractional and integral counters, a mirrored total, negative gauges,
    histograms over zero, negative, tiny and large values."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    reg.counter("mpitree_serving_requests_total").inc()
    reg.counter("mpitree_serving_rows_total").inc(4096)
    reg.counter("mpitree_odd_total", model='a"b\\c\nd').inc(2.5)
    reg.counter("mpitree_odd_total", model="plain").inc(3)
    reg.counter("mpitree_serving_retries_total").set_total(7)
    reg.counter("mpitree_serving_retries_total").set_total(2)
    g = reg.gauge("mpitree_serving_inflight", qos="interactive")
    g.set(3)
    g.inc(0.25)
    g.dec(10)
    reg.gauge("mpitree_sched_queue_depth", model="rf", qos="batch").set(17)
    for bucket, scale in (("1", 1e-4), ("64", 1e-3), ("oversize", 0.05)):
        h = reg.histogram("mpitree_serving_request_seconds", bucket=bucket)
        for v in rng.lognormal(np.log(scale), 1.0, size=300):
            h.observe(float(v))
    h = reg.histogram("mpitree_sched_class_latency_seconds", qos="batch")
    for v in (0.0, -1.0, 1e-12, 3.5e3, 1.0, 1.0, 2 ** 0.25):
        h.observe(v)
    return reg


@pytest.mark.parametrize("exemplars", ["", "0", "3"])
@pytest.mark.parametrize("extra", [None, {"model": 'slot "x"'}])
def test_metrics_text_byte_identical_to_jax(monkeypatch, exemplars, extra):
    monkeypatch.setenv(EXEMPLARS, exemplars)
    port, ref = _drive(metrics), _drive(jax_metrics)
    got, want = port.metrics_text(extra), ref.metrics_text(extra)
    assert got == want
    assert ("# exemplars" in got) == (exemplars == "3")
    assert port.render_families(extra) == ref.render_families(extra)


def test_merged_exposition_byte_identical_to_jax():
    """Two registries merged: one ``# TYPE`` line per family, samples of
    both under it, in the JAX module's order."""
    port = metrics.render_text([
        _drive(metrics, 1).render_families({"model": "a"}),
        _drive(metrics, 2).render_families({"model": "b"}),
    ])
    ref = jax_metrics.render_text([
        _drive(jax_metrics, 1).render_families({"model": "a"}),
        _drive(jax_metrics, 2).render_families({"model": "b"}),
    ])
    assert port == ref
    types = [ln for ln in port.splitlines() if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))
    assert metrics.render_text([]) == jax_metrics.render_text([]) == ""


@pytest.mark.parametrize("q", [0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0])
def test_quantiles_equal_jax(q):
    port, ref = _drive(metrics), _drive(jax_metrics)
    for bucket in ("1", "64", "oversize"):
        a = port.histogram("mpitree_serving_request_seconds", bucket=bucket)
        b = ref.histogram("mpitree_serving_request_seconds", bucket=bucket)
        assert a.quantile(q) == b.quantile(q)
        assert (a.count, a.sum) == (b.count, b.sum)
    a = port.histogram("mpitree_sched_class_latency_seconds", qos="batch")
    b = ref.histogram("mpitree_sched_class_latency_seconds", qos="batch")
    assert a.quantile(q) == b.quantile(q)
    assert metrics.Histogram(metrics.MetricsRegistry()._lock).quantile(
        q) is None


def test_refusals_equal_jax():
    for mod in (metrics, jax_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(TypeError, match="already registered as counter"):
            reg.gauge("x_total")
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("x_total").inc(-1)
        with pytest.raises(ValueError, match="quantile must be in"):
            reg.histogram("h").quantile(1.5)
        other = mod.MetricsRegistry()
        other.gauge("x_total")
        with pytest.raises(TypeError, match="exposed as both"):
            mod.render_text([reg.render_families(),
                             other.render_families()])


def test_concurrent_updates_are_not_lost():
    reg = metrics.MetricsRegistry()
    n_threads, n_ops = 8, 2_000
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait()
        c = reg.counter("mpitree_serving_requests_total")
        h = reg.histogram("mpitree_serving_request_seconds",
                          bucket=str(i % 2))
        g = reg.gauge("mpitree_serving_inflight")
        for j in range(n_ops):
            c.inc()
            h.observe(1e-3 * (j % 7 + 1))
            g.inc()
            g.dec()

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert reg.counter("mpitree_serving_requests_total").value == \
        n_threads * n_ops
    counts = [reg.histogram("mpitree_serving_request_seconds",
                            bucket=str(b)).count for b in (0, 1)]
    assert counts == [n_threads // 2 * n_ops] * 2
    assert reg.gauge("mpitree_serving_inflight").value == 0


def test_module_level_exposition_is_the_default_registry():
    assert metrics.metrics_text() == metrics.DEFAULT.metrics_text()


@pytest.mark.parametrize("name", sorted(knobs.REGISTRY))
def test_knob_registered_as_in_jax(name):
    """Every field as in JAX, but the forests' budget, whose default
    comes from the device (None) where JAX's is 8 GiB, half a TPU v5e
    chip, and ``MPITREE_TPU_ELASTIC``, whose unset None keeps the host
    rung off where JAX's True runs it. A parse rule of the package's own
    (the strict ``_one`` and the everything-but-"0" ``_flag`` of the
    boolean knobs) is the port's copy: the same name, the same
    answers."""
    got = dataclasses.asdict(knobs.REGISTRY[name])
    want = dataclasses.asdict(jax_knobs.REGISTRY[name])
    if name == "MPITREE_TPU_FOREST_HBM_BUDGET":
        assert want.pop("default") == 8 << 30
        assert got.pop("default") is None
    if name == "MPITREE_TPU_ELASTIC":
        assert want.pop("default") is True
        assert got.pop("default") is None
    for own in ("_one", "_flag"):
        if got.get("parse") is getattr(knobs, own):
            assert want.pop("parse") is getattr(jax_knobs, own)
            got.pop("parse")
            for raw in ("1", "0", "true", "", " 1"):
                assert getattr(knobs, own)(raw) == getattr(jax_knobs,
                                                           own)(raw)
    assert got == want


def _read(mod, name):
    """(value, raw) of a knob, or the type and text of its parse error."""
    try:
        return mod.value(name), mod.raw(name)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e), str(e)


@pytest.mark.parametrize("name,raw", [
    ("MPITREE_TPU_SERVING_QUANTIZE", None),
    ("MPITREE_TPU_SERVING_QUANTIZE", "int8"),
    ("MPITREE_TPU_SERVING_QUANTIZE", ""),
    ("MPITREE_TPU_SERVING_QUANTIZE_TOL", "0.25"),
    ("MPITREE_TPU_SERVING_QUANTIZE_TOL", "tight"),
    ("MPITREE_TPU_SERVING_QOS", "gold:5:8"),
    ("MPITREE_TPU_SERVING_SHED_DEPTH", None),
    ("MPITREE_TPU_SERVING_SHED_DEPTH", "128"),
    ("MPITREE_TPU_SERVING_SHED_DEPTH", "1.5"),
    ("MPITREE_TPU_SERVING_MARGIN_MS", "0.5"),
    ("MPITREE_TPU_SERVING_MARGIN_MS", "5ms"),
    ("MPITREE_TPU_SERVING_WAIT_MS", "1e-3"),
    ("MPITREE_TPU_METRICS_EXEMPLARS", "4"),
    ("MPITREE_TPU_METRICS_EXEMPLARS", "four"),
    ("MPITREE_TPU_HOST_BYTES", None),
    ("MPITREE_TPU_HOST_BYTES", "4194304"),
    ("MPITREE_TPU_HOST_BYTES", "4MiB"),
    ("MPITREE_TPU_SKETCH_CAPACITY", "64"),
    ("MPITREE_TPU_SPILL_DIR", None),
    ("MPITREE_TPU_SPILL_DIR", "/tmp/spill"),
    ("MPITREE_TPU_SPILL_BYTES", "1000"),
    ("MPITREE_TPU_KEYED_BOOTSTRAP", None),
    ("MPITREE_TPU_KEYED_BOOTSTRAP", "1"),
    ("MPITREE_TPU_KEYED_BOOTSTRAP", "true"),
])
def test_knob_values_and_errors_equal_jax(monkeypatch, name, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    assert _read(knobs, name) == _read(jax_knobs, name)


def test_unregistered_knob_is_refused():
    with pytest.raises(KeyError, match="unregistered env knob"):
        knobs.value("MPITREE_TPU_NO_SUCH_KNOB")
    with pytest.raises(KeyError, match="unregistered env knob"):
        knobs.raw("MPITREE_TPU_ENGINE")  # JAX's, not the port's yet
