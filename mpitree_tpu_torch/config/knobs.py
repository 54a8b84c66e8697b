"""Typed registry of the ``MPITREE_TPU_*`` environment knobs the port reads.

Counterpart of ``mpitree_tpu/config/knobs.py``, with the same registry
mechanism (:class:`Knob`, :data:`REGISTRY`, :func:`value`, :func:`raw`)
and, for each knob registered here, the JAX package's name, default,
parse rule and choices. Only the knobs of the serving tier are registered
so far: table quantization, the scheduler's QoS classes and window, and
the metrics exemplar ring. The rest, and the README table generator,
come with ``ROADMAP.md`` Queue 1 item 18; the port's other env reads
(``core/builder.py``, ``boosting/fused_rounds.py``,
``utils/profiling.py``) stay where they are until then.

Two read paths:

- :func:`value` — the typed read: an unset or empty raw value resolves to
  the default; anything else goes through the knob's parse rule (whose
  errors propagate: a typo'd knob fails loudly);
- :func:`raw` — the raw string (or None) of a registered knob.

Reading a name that is not registered raises ``KeyError``. Stdlib only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class Knob:
    """One registered env knob: its type, default, parse rule, doc line."""

    name: str
    kind: str                     # "bool" | "str" | "int" | "float" | "path"
    default: Any
    doc: str
    parse: Callable[[str], Any] | None = None
    choices: tuple | None = None  # documented domain (informational)

    def read(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default
        if self.parse is not None:
            return self.parse(raw)
        return raw


KNOBS: tuple = (
    # -- serving: scheduler + quantization --------------------------------
    Knob("MPITREE_TPU_SERVING_QUANTIZE", "str", "off",
         "default table form for `compile_model`/`publish` when the"
         " caller passes no `quantize=`: `int8` serves bf16-threshold /"
         " int16-feature / int8-delta-value tables",
         choices=("off", "int8")),
    Knob("MPITREE_TPU_SERVING_QUANTIZE_TOL", "float", 1e-2,
         "max prediction delta vs the f32 tables on the calibration"
         " batch before quantized compilation REFUSES", parse=float),
    Knob("MPITREE_TPU_SERVING_QOS", "str",
         "interactive:50:256;batch:2000:4096",
         "scheduler QoS classes as `name:deadline_ms:queue_depth;...`"
         " (first class is the default for unlabeled requests)"),
    Knob("MPITREE_TPU_SERVING_SHED_DEPTH", "int", 4096,
         "total in-flight request bound across all scheduler queues;"
         " admissions past it shed with reason `queue_full`", parse=int),
    Knob("MPITREE_TPU_SERVING_MARGIN_MS", "float", 5.0,
         "dispatch-window close margin before the head-of-line deadline"
         " (the EDF batching budget)", parse=float),
    Knob("MPITREE_TPU_SERVING_WAIT_MS", "float", 2.0,
         "max batching window the scheduler holds a non-full bucket open",
         parse=float),
    # -- observability ----------------------------------------------------
    Knob("MPITREE_TPU_METRICS_EXEMPLARS", "int", 0,
         "per-bucket exemplar reservoir size K for obs.metrics"
         " histograms (surfaced as `metrics_text()` comments; 0 = off,"
         " zero cost)", parse=int),
)

REGISTRY: dict = {k.name: k for k in KNOBS}


def _lookup(name: str) -> Knob:
    knob = REGISTRY.get(name)
    if knob is None:
        raise KeyError(
            f"unregistered env knob {name!r} — add it to "
            "mpitree_tpu_torch/config/knobs.py (the registry is the "
            "port's os.environ read path for its knobs)"
        )
    return knob


def value(name: str):
    """Typed read: default when unset/empty, else the knob's parse rule."""
    return _lookup(name).read()


def raw(name: str) -> str | None:
    """Raw environ string (or None) for a registered knob."""
    return os.environ.get(_lookup(name).name)
