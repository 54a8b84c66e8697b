"""Serving: flat node tables, the traversal kernels, compiled models, a
registry of published models, the streaming stage and the EDF scheduler
(counterpart of ``mpitree_tpu.serving``).

``ModelRegistry().publish("rf", forest)`` compiles and warms a fitted
forest (or publishes a ``compile_model`` result as it is), then
``registry.predict_proba("rf", X)`` answers through the Hopper traversal
kernel on the card (``serve_kernel.py``);
``StreamStage(model, depth=2)`` keeps batches in flight so one batch's
copy overlaps another's kernel, and ``Scheduler(registry)`` coalesces
single requests into bucket batches by deadline, with QoS admission.
``NodeTable``/``tables_for`` are the depth-packed tables every tier
descends, and ``note_serving`` records their plan on a fit's observer.
"""

from mpitree_tpu_torch.serving.model import (
    DEFAULT_BUCKETS,
    CompiledModel,
    compile_model,
)
from mpitree_tpu_torch.serving.quantize import QuantizationError
from mpitree_tpu_torch.serving.registry import ModelRegistry
from mpitree_tpu_torch.serving.scheduler import (
    REJECT_REASONS,
    QoSClass,
    RejectedRequest,
    Scheduler,
    parse_qos,
)
from mpitree_tpu_torch.serving.staging import StreamStage
from mpitree_tpu_torch.serving.tables import (
    NodeTable,
    note_serving,
    tables_for,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "REJECT_REASONS",
    "CompiledModel",
    "ModelRegistry",
    "NodeTable",
    "QoSClass",
    "QuantizationError",
    "RejectedRequest",
    "Scheduler",
    "StreamStage",
    "compile_model",
    "note_serving",
    "parse_qos",
    "tables_for",
]
