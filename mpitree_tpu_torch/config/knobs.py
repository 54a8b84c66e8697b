"""Typed registry of the ``MPITREE_TPU_*`` environment knobs the port reads.

Counterpart of ``mpitree_tpu/config/knobs.py``, with the same registry
mechanism (:class:`Knob`, :data:`REGISTRY`, :func:`value`, :func:`raw`)
and, for each knob registered here, the JAX package's name, default,
parse rule and choices. Registered so far: the serving tier's knobs
(table quantization, the scheduler's QoS classes and window, the metrics
exemplar ring), the forests' ``MPITREE_TPU_FOREST_HBM_BUDGET`` and the
ladder's ``MPITREE_TPU_ELASTIC``, whose defaults alone differ (see their
entries), the streaming ingest's five
(host budget, sketch capacity, spill directory and cap, keyed bootstrap)
and the resilience ladder's five (``ELASTIC``, ``RETRIES``,
``BACKOFF_S``, ``LEVEL_RETRY``, ``CHAOS``; ``resilience/``).
The rest, and the README table generator,
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


def _flag(raw: str) -> bool:
    """The package's boolean convention: everything but "0" enables."""
    return raw != "0"


def _one(raw: str) -> bool:
    """Strict opt-in: only the literal "1" enables."""
    return raw == "1"


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
    # -- forests -----------------------------------------------------------
    # The JAX package's default, 8 GiB, is half a TPU v5e chip's 16 GiB;
    # the port's None keeps the rule, not the number: half the device's
    # memory (parallel/mesh.forest_hbm_budget).
    Knob("MPITREE_TPU_FOREST_HBM_BUDGET", "int", None,
         "per-device budget (bytes) for the replicated binned matrix in"
         " tree-sharded forest builds", parse=int),
    # -- ingest ------------------------------------------------------------
    Knob("MPITREE_TPU_HOST_BYTES", "int", 1 << 30,
         "host-RAM budget streamed-ingest chunk sizing derives from",
         parse=int),
    Knob("MPITREE_TPU_SKETCH_CAPACITY", "int", 1 << 20,
         "per-feature unique-value cap before the quantile sketch"
         " compacts", parse=int),
    Knob("MPITREE_TPU_SPILL_DIR", "path", None,
         "spill rung for one-shot chunk iterators: the first ingest pass"
         " tees every chunk here (atomic files, manifest-last commit) so"
         " later passes replay from disk; unset = one-shot sources are"
         " refused"),
    Knob("MPITREE_TPU_SPILL_BYTES", "int", 16 << 30,
         "spill-store size cap in bytes; a stream that would exceed it"
         " raises before the offending chunk is kept", parse=int),
    Knob("MPITREE_TPU_KEYED_BOOTSTRAP", "bool", False,
         "`1` switches in-memory forest bootstrap/feature draws to the"
         " keyed counter-based sampler streamed forests always use —"
         " the fingerprint twin of a streamed forest fit", parse=_one),
    # -- observability ----------------------------------------------------
    Knob("MPITREE_TPU_METRICS_EXEMPLARS", "int", 0,
         "per-bucket exemplar reservoir size K for obs.metrics"
         " histograms (surfaced as `metrics_text()` comments; 0 = off,"
         " zero cost)", parse=int),
    # -- resilience -------------------------------------------------------
    # The JAX package's default, True, takes the whole ladder, host rung
    # included. The port's None keeps the retry rungs and leaves the host
    # rung to an explicit `1`: a fit asked for on the card stays there, or
    # raises its classified error (resilience/config.host_failover_enabled).
    Knob("MPITREE_TPU_ELASTIC", "bool", None,
         "`0` turns the whole resilience ladder off — device failures"
         " raise", parse=_flag),
    Knob("MPITREE_TPU_RETRIES", "int", 2,
         "transient re-dispatch budget (also the per-position level-retry"
         " budget)", parse=int),
    Knob("MPITREE_TPU_BACKOFF_S", "float", 0.5,
         "retry backoff base seconds (exponential, deterministic jitter)",
         parse=float),
    Knob("MPITREE_TPU_LEVEL_RETRY", "str", "auto",
         "snapshot the loop carry per level/expansion and resume there on"
         " a blip (`auto` = on)", choices=("auto", "on", "off")),
    Knob("MPITREE_TPU_CHAOS", "str", None,
         "fault-injection plan spec"
         " (`site:at:kind[:arg][:key=value...];...`)"),
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
