"""Typed registry of the ``MPITREE_TPU_*`` environment knobs the port reads.

Counterpart of ``mpitree_tpu/config/knobs.py``, with the same registry
mechanism (:class:`Knob`, :data:`REGISTRY`, :func:`value`, :func:`raw`,
:func:`markdown_table`) and, for each knob registered here, the JAX
package's name, kind, default, parse rule, choices and doc line. It is
the port's one read path for its knobs: no module of the port reads an
``MPITREE_TPU_*`` name from ``os.environ`` itself. Two defaults differ on
purpose, each with its reason at its entry: ``MPITREE_TPU_FOREST_HBM_BUDGET``
and ``MPITREE_TPU_ELASTIC``.

The JAX package's other knobs, and why the port has none of them:
:data:`NOT_ON_THE_CARD` (TPU/XLA choices without a counterpart here);
:data:`NEXT_SLICE` (knobs whose reader the port does not have yet) is
empty.
``python -m mpitree_tpu_torch.config`` renders :data:`KNOBS` as the
README's port knob table (between its own markers).

Two read paths:

- :func:`value` — the typed read: an unset or empty raw value resolves to
  the default; anything else goes through the knob's parse rule (whose
  errors propagate: a typo'd knob fails loudly);
- :func:`raw` — the raw string (or None) of a registered knob, for the
  sites whose parsing is site policy (``auto``-steering forces).

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
    # -- engine policy ------------------------------------------------------
    Knob("MPITREE_TPU_ENGINE", "str", "auto",
         "build engine when `BuildConfig(engine='auto')`",
         choices=("auto", "fused", "levelwise")),
    Knob("MPITREE_TPU_HIST_SUBTRACTION", "str", "auto",
         "sibling-subtraction histogram carry override",
         choices=("auto", "on", "off")),
    Knob("MPITREE_TPU_ROUNDS_PER_DISPATCH", "str", "auto",
         "boosting rounds fused per dispatch; an integer K forces, `auto`"
         " prices from the memory planner"),
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
    Knob("MPITREE_TPU_PROFILE", "bool", False,
         "per-phase timing spans + per-level rows (`fit_stats_`)",
         parse=_flag),
    Knob("MPITREE_TPU_DEBUG", "bool", False,
         "on-device determinism assertions + debug checks", parse=_flag),
    Knob("MPITREE_TPU_TRACE_DIR", "path", None,
         "ambient Chrome-trace capture: every observer traces to a unique"
         " file in this directory"),
    Knob("MPITREE_TPU_MEM_SAMPLE", "bool", False,
         "`1` samples live memory watermarks at span boundaries",
         parse=_one),
    Knob("MPITREE_TPU_MEM_DRIFT_TOL", "float", 8.0,
         "ledger-vs-live drift-event threshold (x)", parse=float),
    Knob("MPITREE_TPU_HBM_BYTES", "int", None,
         "per-device HBM preflight budget (wins over the backend's"
         " reported `bytes_limit`)", parse=int),
    Knob("MPITREE_TPU_OBS_STREAM_DIR", "path", None,
         "spill directory for long-run level-row streaming"),
    Knob("MPITREE_TPU_RUN_DIR", "path", None,
         "ambient flight store: every fit/serve record appends an"
         " envelope"),
    Knob("MPITREE_TPU_RUN_MAX_BYTES", "int", 0,
         "flight-store size cap in bytes (0/unset = unbounded)",
         parse=int),
    Knob("MPITREE_TPU_RUN_KEEP", "int", 16,
         "per-lineage record tail length kept when the store rotates",
         parse=int),
    Knob("MPITREE_TPU_PEAK_FLOPS", "float", None,
         "per-device peak f32 FLOP/s the compute ledger prices"
         " optimal-seconds floors from (overrides the obs.cost platform"
         " table; unset + unknown platform = honest `None` floors)",
         parse=float),
    Knob("MPITREE_TPU_PEAK_HBM_GBPS", "float", None,
         "per-device peak HBM bandwidth (GB/s) for the compute ledger's"
         " memory-bound floor (overrides the obs.cost platform table)",
         parse=float),
    Knob("MPITREE_TPU_POLICY_EVIDENCE", "str", "auto",
         "evidence-driven `resolve_*` auto policies (obs.advisor): `auto`"
         " consults the ambient flight store's A/B lineage history when"
         " one exists, `off` keeps every static policy",
         choices=("auto", "off")),
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
    # -- native -------------------------------------------------------------
    Knob("MPITREE_TPU_NO_NATIVE", "bool", False,
         "disable the C++ host split kernel (numpy fallback)",
         parse=_flag),
)

# The JAX package's knobs that choose among TPU or XLA implementations
# the port does not have: name -> why there is nothing to steer on the
# card. None of them may come back as a switch from a hand-written kernel
# to its plain version.
NOT_ON_THE_CARD: dict = {
    "MPITREE_TPU_HIST_KERNEL":
        "picks XLA or Pallas for the histogram; the port has one"
        " histogram, the CUDA kernel (csrc/histogram.cu), and its plain"
        " version only on CPU tensors",
    "MPITREE_TPU_WIDE_HIST":
        "forces or disables the TPU's sorted window-packed wide tier; the"
        " CUDA kernel's sorted route serves every width, picked by its"
        " planner (ops/hist_kernel.py)",
    "MPITREE_TPU_WIDE_KERNEL":
        "picks the Pallas or XLA-scan wide kernel; there is one wide"
        " route on the card, the same CUDA kernel",
    "MPITREE_TPU_SERVING_KERNEL":
        "picks the Pallas traversal or the XLA gather loop; the card"
        " always serves through csrc/traverse.cu (boosted margins through"
        " csrc/margin.cu where their pack serves)",
    "MPITREE_TPU_DEVICE_BIN":
        "gates on-device binning on real TPUs only; the port bins on the"
        " fit's device always (ops/binning.bin_for_engine)",
    "MPITREE_TPU_EXACT_TIES":
        "CPU-mesh float64 tie sweep escape hatch; the port's split sweep"
        " is always float64",
    "MPITREE_TPU_GBDT_X64":
        "CPU-mesh float64 gradient accumulation escape hatch; the port's"
        " gradients always sum exactly in int64 fixed point",
    "MPITREE_TPU_COMPILE_CACHE":
        "the persistent XLA executable cache; the port compiles no XLA"
        " (its kernels build once per checkout under build/)",
    "MPITREE_TPU_NATIVE_CACHE":
        "steers the JAX package's native build directory; the port builds"
        " its native sweep into the checkout's build/native/, named by a"
        " hash of source, flags and host CPU, and steers no directory",
}

# The JAX package's knobs whose reader the port does not have yet: none
# (the port reads every knob of the JAX package it does not list in
# NOT_ON_THE_CARD).
NEXT_SLICE: dict = {}

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


def markdown_table() -> str:
    """The README's port knob table, generated from the registry (the
    JAX package's rendering)."""
    lines = [
        "| knob | type | default | effect |",
        "|---|---|---|---|",
    ]
    for k in KNOBS:
        if k.default is None:
            default = "unset"
        elif k.default is True:
            default = "on"
        elif k.default is False:
            default = "off"
        else:
            default = f"`{k.default}`"
        doc = k.doc
        if k.choices:
            doc = f"{doc} (one of {', '.join(f'`{c}`' for c in k.choices)})"
        lines.append(f"| `{k.name}` | {k.kind} | {default} | {doc} |")
    return "\n".join(lines) + "\n"
