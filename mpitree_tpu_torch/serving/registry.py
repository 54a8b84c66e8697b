"""ModelRegistry: named model slots, swapped only once the new model is warm.

Counterpart of ``mpitree_tpu/serving/registry.py``. ``publish`` takes a
fitted estimator, which it compiles (``compile_model``), or a
:class:`CompiledModel` as it is, and warms it (``warm=False`` skips that)
entirely before it flips the slot under a lock, so requests racing a
publish keep hitting the old model; a quantization refusal
(``QuantizationError``) raises before the flip and leaves the old model
serving. Each publish records the ``registry_publish`` decision (its
generation and ``warm``) on the model's ``serve_report_``. The dispatch
itself runs outside the lock. ``metrics_text`` is one Prometheus
exposition of the registry's publish metrics and every published model's
families, each stamped ``model=<slot>``, under one ``# TYPE`` line per
family; the scheduler (``serving/scheduler.py``) merges its own families
into the same text.
"""

from __future__ import annotations

import threading
import time

from mpitree_tpu_torch.obs.metrics import MetricsRegistry, render_text
from mpitree_tpu_torch.serving.model import (
    DEFAULT_BUCKETS,
    CompiledModel,
    compile_model,
)


class ModelRegistry:
    """Named slots of :class:`CompiledModel`; see module docstring."""

    def __init__(self, *, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self._slots: dict[str, CompiledModel] = {}
        self._meta: dict[str, dict] = {}
        self._lock = threading.Lock()
        # the registry's own metrics: publish counts and warm seconds
        self.metrics = MetricsRegistry()

    def publish(self, name: str, model, *, warm: bool = True,
                quantize=None, quantize_tol=None,
                calibration=None) -> CompiledModel:
        """Compile a fitted estimator (``compile_model``, with
        ``quantize``, ``quantize_tol`` and ``calibration``;
        ``quantize=None`` follows the ``MPITREE_TPU_SERVING_QUANTIZE``
        knob), or take a :class:`CompiledModel` as it is, warm it
        (``warm=True``: every bucket once), then swap it into slot
        ``name``."""
        if not isinstance(model, CompiledModel):
            model = compile_model(
                model, buckets=self.buckets, quantize=quantize,
                quantize_tol=quantize_tol, calibration=calibration,
            )
        t0 = time.perf_counter()
        if warm:
            model.warmup()
        warm_s = time.perf_counter() - t0
        self.metrics.counter(
            "mpitree_registry_publish_total", model=name).inc()
        self.metrics.histogram(
            "mpitree_registry_warm_seconds", model=name).observe(warm_s)
        with self._lock:
            generation = self._meta.get(name, {}).get("generation", 0) + 1
            self._slots[name] = model
            self._meta[name] = {
                "generation": generation,
                "warm_s": round(warm_s, 3),
                "buckets": model.buckets,
                "kind": model.kind,
            }
        with model._state_lock:
            model._obs.decision(
                "registry_publish", name,
                reason=f"generation {generation}, warmed in {warm_s:.3f}s",
                warm=bool(warm))
        return model

    def get(self, name: str) -> CompiledModel:
        with self._lock:
            try:
                return self._slots[name]
            except KeyError:
                raise KeyError(
                    f"no model published under {name!r}; "
                    f"published: {sorted(self._slots)}"
                ) from None

    def drop(self, name: str) -> None:
        with self._lock:
            self._slots.pop(name, None)
            self._meta.pop(name, None)

    def models(self) -> dict:
        """Snapshot of slot metadata (generation, warm time, buckets)."""
        with self._lock:
            return {k: dict(v) for k, v in self._meta.items()}

    def metrics_families(self) -> list:
        """The family maps of the registry's own metrics and of every
        published model, stamped ``model=<slot>``: what ``metrics_text``
        renders and the scheduler merges with its own."""
        with self._lock:
            slots = dict(self._slots)
        maps = [self.metrics.render_families()]
        for name in sorted(slots):
            maps.append(slots[name].metrics_families({"model": name}))
        return maps

    def metrics_text(self) -> str:
        """One Prometheus exposition for the whole registry, one ``# TYPE``
        line per family."""
        return render_text(self.metrics_families())

    def predict(self, name: str, X):
        return self.get(name).predict(X)

    def predict_proba(self, name: str, X):
        return self.get(name).predict_proba(X)

    def raw(self, name: str, X):
        return self.get(name).raw(X)
