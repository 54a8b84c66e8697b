"""Serving: flat node tables, the traversal kernels, compiled models and
a registry of published models (counterpart of ``mpitree_tpu.serving``).

``ModelRegistry().publish("rf", forest)`` compiles and warms a fitted
forest, then ``registry.predict_proba("rf", X)`` answers through the
Hopper traversal kernel on the card (``serve_kernel.py``).
"""

from mpitree_tpu_torch.serving.model import (
    DEFAULT_BUCKETS,
    CompiledModel,
    compile_model,
)
from mpitree_tpu_torch.serving.quantize import QuantizationError
from mpitree_tpu_torch.serving.registry import ModelRegistry

__all__ = [
    "DEFAULT_BUCKETS",
    "CompiledModel",
    "ModelRegistry",
    "QuantizationError",
    "compile_model",
]
