"""ModelRegistry: named model slots, swapped only once the new model is warm.

Counterpart of ``mpitree_tpu/serving/registry.py``. ``publish`` compiles
(``compile_model``) and warms a new model entirely before it flips the
slot under a lock, so requests racing a publish keep hitting the old
model; a quantization refusal (``QuantizationError``) raises before the
flip and leaves the old model serving. The dispatch itself runs outside
the lock. Metrics and the scheduler are not ported (``ROADMAP.md``).
"""

from __future__ import annotations

import threading
import time

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

    def publish(self, name: str, estimator, *, quantize=None,
                quantize_tol=None, calibration=None) -> CompiledModel:
        """Compile (``compile_model``) and warm a fitted estimator, then
        swap it into slot ``name``."""
        model = compile_model(
            estimator, buckets=self.buckets, quantize=quantize,
            quantize_tol=quantize_tol, calibration=calibration,
        )
        t0 = time.perf_counter()
        model.warmup()
        warm_s = time.perf_counter() - t0
        with self._lock:
            generation = self._meta.get(name, {}).get("generation", 0) + 1
            self._slots[name] = model
            self._meta[name] = {
                "generation": generation,
                "warm_s": warm_s,
                "buckets": model.buckets,
                "kind": model.kind,
            }
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

    def predict(self, name: str, X):
        return self.get(name).predict(X)

    def predict_proba(self, name: str, X):
        return self.get(name).predict_proba(X)

    def raw(self, name: str, X):
        return self.get(name).raw(X)
