"""Typed registry of every structured event kind and decision key.

Counterpart of ``mpitree_tpu/obs/events.py``, copied entry for entry: the
same kinds, severities, decision keys and doc lines, so a port record and
a JAX record name the same facts alike. Each entry carries its severity
and the one doc line the README events table is generated from
(:func:`markdown_table`).

Severity is the emission contract, not a log level:

- ``warn`` — the site raises a visible Python warning (``warn_event``)
  AND records the typed event; something degraded that the user should
  see once, interactively.
- ``info`` — record-only (``obs.event``): a structured fact for the
  ``fit_report_`` consumers, silent on the console.

Stdlib only, like the knob registry.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Event:
    """One registered event kind: its severity and doc line."""

    kind: str
    severity: str                 # "warn" | "info"
    doc: str


@dataclasses.dataclass(frozen=True)
class Decision:
    """One registered typed-decision key and what the value records."""

    key: str
    doc: str


EVENTS: tuple = (
    # -- training-path degradations (visible warnings) --------------------
    Event("checkpoint_disabled", "warn",
          "requested boosting/forest checkpointing could not engage"
          " (spec/engine combination) — the fit continues without resume"
          " protection"),
    Event("exact_ties_gap", "warn",
          "the f64 tie-exact cost sweep is memory-gated off for wide"
          " frontier chunks; ties there rank in f32 and may resolve"
          " differently from the host tier"),
    Event("f32_ceiling", "warn",
          "a weight/count channel can exceed 2**24 in float32 —"
          " sibling-subtraction (or the requested accumulation mode) is"
          " disabled to keep sums exact"),
    Event("fused_no_determinism_check", "warn",
          "debug mode requested the on-device determinism check but the"
          " fused engine cannot run it — use engine='levelwise'"),
    Event("oob_empty", "warn",
          "no out-of-bag rows at all (tiny data or unlucky bootstrap) —"
          " `oob_score_` is unavailable"),
    Event("oob_partial", "warn",
          "some rows were in-bag for every tree; the OOB score covers"
          " only the rows with at least one vote"),
    # -- training-path facts (record-only) --------------------------------
    Event("checkpoint_resume", "info",
          "the fit resumed from a checkpoint instead of starting at"
          " round/tree zero"),
    Event("determinism_check_failed", "info",
          "the debug determinism probe saw split decisions diverge"
          " across mesh devices (the fit then raises)"),
    Event("nonfinite_grad", "info",
          "non-finite gradients/hessians at a boosting round — the fit"
          " refuses to continue (the event precedes the raise)"),
    Event("sub_carry_over_budget", "info",
          "keeping a level's chunk histograms for sibling subtraction"
          " would exceed hist_budget_bytes; the next level accumulates"
          " directly"),
    Event("mesh2d_unsupported", "info",
          "the leaf-wise engine fell back to a 1-D data mesh — its pair"
          " program does not shard the feature axis"),
    Event("leafwise_pallas_fallback", "info",
          "the leaf-wise pair histogram dropped from the Pallas kernel"
          " to the XLA path (unsupported shape/platform)"),
    Event("serving_pallas_fallback", "info",
          "the serving tier dropped from the Pallas traversal kernel to"
          " the XLA path (unsupported shape/platform, or forced off)"),
    # -- resilience ladder ------------------------------------------------
    Event("device_retry", "info",
          "a transient device error was re-dispatched after backoff"
          " (the MPITREE_TPU_RETRIES budget)"),
    Event("level_retry", "info",
          "a mid-build blip resumed from the per-level/per-expansion"
          " carry snapshot instead of restarting the tree"),
    Event("device_failover", "info",
          "a device failure rode the resilience ladder onto a fallback"
          " device set or the CPU backend"),
    Event("oom_predicted", "info",
          "the memory preflight predicted an out-of-memory dispatch and"
          " triggered a pre-emptive degrade"),
    Event("oom_rescue", "info",
          "an actual OOM was caught and rescued by degrading the plan"
          " (smaller chunks / host path / engine exit)"),
    Event("oom_postmortem", "info",
          "an OOM's allocation postmortem was attached to the record"
          " naming the binding arrays"),
    # -- observability self-reporting -------------------------------------
    Event("cost_unavailable", "info",
          "the compute ledger could not price optimal-seconds floors"
          " (unknown platform peaks and no override knobs)"),
    Event("mem_estimate_drift", "info",
          "sampled live memory watermarks drifted from the ledger's"
          " estimate beyond MPITREE_TPU_MEM_DRIFT_TOL"),
    Event("level_stream_failed", "info",
          "spilling per-level rows to MPITREE_TPU_OBS_STREAM_DIR failed;"
          " rows stay in memory for this run"),
    Event("trace_failed", "info",
          "writing/finalizing a Chrome trace capture failed — the fit is"
          " unaffected, the trace file is not"),
    Event("trace_unavailable", "info",
          "the ambient MPITREE_TPU_TRACE_DIR capture could not start"
          " (profiler unavailable or already active)"),
)

DECISIONS: tuple = (
    Decision("engine",
             "which build engine ran (fused / levelwise / leafwise /"
             " host) and why the resolver picked it"),
    Decision("build_path",
             "host vs device build for a single-device tree (workload"
             " threshold, explicit backend, or mesh width)"),
    Decision("frontier",
             "frontier policy: best-first leaf-wise pool vs level-wise"
             " breadth sweep"),
    Decision("hist_subtraction",
             "sibling-subtraction histogram carry on/off and the gate"
             " that decided it"),
    Decision("leafwise_mesh",
             "mesh the leaf-wise engine actually ran on (it refuses the"
             " feature axis)"),
    Decision("refine",
             "exact-local-candidate refine depth (quantile-binning"
             " accuracy recovery) or None when off"),
    Decision("refine_tail",
             "refine tail execution: batched native kernel vs"
             " per-subtree host recursion"),
    Decision("ingest",
             "ingest path: streamed chunked sketch+bin vs materialized"
             " host matrix"),
    Decision("ingest_spill",
             "spill-to-disk rung engaged for a one-shot chunk iterator"
             " (store directory and size cap recorded)"),
    Decision("bootstrap",
             "forest bootstrap draw scheme: keyed counter-based"
             " per-chunk masks vs the host RNG multinomial"),
    Decision("ensemble_path",
             "forest build sharding: tree-parallel vs data-parallel (and"
             " the HBM budget verdict)"),
    Decision("rounds_per_dispatch",
             "boosting rounds fused per device dispatch (priced from the"
             " memory planner or forced by knob)"),
    Decision("early_stop",
             "boosting early-stop verdict: the round it triggered at and"
             " the patience evidence"),
    Decision("serving",
             "serving-table plan recorded at fit time (depth-packed flat"
             " node table shape)"),
    Decision("serving_compile",
             "serving tier compiled for a published model (XLA vs Pallas"
             " kernel, bucket widths)"),
    Decision("serving_kernel",
             "the body a served model's launches take, by its launch"
             " counter's name (traverse, traverse_q, margin, margin_q;"
             " plain where no kernel launches: on the CPU, a single"
             " tree's gather)"),
    Decision("serving_quantize",
             "quantized serving tables on/off and the calibration"
             " tolerance verdict"),
    Decision("registry_publish",
             "a model generation was published to the serving registry"
             " (warm-compile timing rides along)"),
)

EVENT_KINDS: dict = {e.kind: e for e in EVENTS}
DECISION_KEYS: dict = {d.key: d for d in DECISIONS}


def markdown_table() -> str:
    """The README events section, generated from the registry."""
    lines = [
        "| event | severity | meaning |",
        "|---|---|---|",
    ]
    for e in EVENTS:
        lines.append(f"| `{e.kind}` | {e.severity} | {e.doc} |")
    lines.append("")
    lines.append("| decision | records |")
    lines.append("|---|---|")
    for d in DECISIONS:
        lines.append(f"| `{d.key}` | {d.doc} |")
    return "\n".join(lines) + "\n"
