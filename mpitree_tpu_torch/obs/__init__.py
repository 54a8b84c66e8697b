"""Observability, counterpart of ``mpitree_tpu.obs``.

Every estimator writes its fit into a :class:`BuildObserver` and exposes
the finalized :class:`BuildRecord` as ``fit_report_`` (the JAX package's
schema 9 and top-level fields) and ``dump_report(path)``;
``fit(trace_to=...)`` and ``CompiledModel.trace_to(...)`` render spans,
events and replayed level rows as Chrome-trace timelines
(:class:`TraceSink`); ``obs.fingerprint`` stamps every fit with per-level
build-state fingerprints equal to the JAX package's on equal trees;
``obs.metrics`` is the serving metrics registry; ``obs.memory`` the
memory ledger and preflight (``MemoryPlan``, ``plan_fit``, ``MemWatch``)
and ``obs.cost`` the compute ledger against the card's peaks;
``obs.flight`` appends every finalized record to a persistent run store
under ``MPITREE_TPU_RUN_DIR`` (:class:`FlightStore`), ``obs.diff``
compares two runs with noise-aware verdicts and bisects fingerprint
divergences to the first divergent (tree, level, channel)
(``python -m mpitree_tpu_torch.obs.benchdiff`` is its CLI), and
``obs.advisor`` turns the store's A/B history into evidence-driven
``auto`` resolutions.
"""

from mpitree_tpu_torch.obs.advisor import (
    advise_hist_subtraction,
    advise_mesh_2d,
    advise_rounds_per_dispatch,
    advise_serving_kernel,
)

from mpitree_tpu_torch.obs.cost import (
    ENTRY_JOIN,
    PEAK_TABLE,
    compute_section,
    platform_peaks,
)
from mpitree_tpu_torch.obs.diff import (
    diff_envelopes,
    diff_payloads,
    localize_divergence,
)
from mpitree_tpu_torch.obs.fingerprint import (
    FINGERPRINT_VERSION,
    ensemble_fingerprint,
    tree_fingerprints,
)
from mpitree_tpu_torch.obs.flight import RUN_DIR_ENV, FlightStore
from mpitree_tpu_torch.obs.memory import (
    MEMORY_SCHEMA,
    MemoryPlan,
    MemoryPlanError,
    MemWatch,
    aggregate_plans,
    drift_check,
    plan_fit,
    plan_forest,
    plan_ingest,
    plan_serve,
    preflight,
)
from mpitree_tpu_torch.obs.metrics import MetricsRegistry, metrics_text
from mpitree_tpu_torch.obs.observer import (
    REGISTRY,
    BuildObserver,
    CompileRegistry,
    mesh_info,
    note_build_path,
    note_refine,
    warn_event,
)
from mpitree_tpu_torch.obs.record import (
    SCHEMA_VERSION,
    STATS_MOVES,
    TOP_LEVEL_FIELDS,
    BuildRecord,
    ReportMixin,
    digest,
    moved_stat,
    stats_view,
    wire_estimate,
)
from mpitree_tpu_torch.obs.trace import (
    TRACE_DIR_ENV,
    TraceSink,
    merge_trace_files,
    validate_trace,
)

__all__ = [
    "ENTRY_JOIN",
    "FINGERPRINT_VERSION",
    "MEMORY_SCHEMA",
    "PEAK_TABLE",
    "RUN_DIR_ENV",
    "SCHEMA_VERSION",
    "STATS_MOVES",
    "TOP_LEVEL_FIELDS",
    "TRACE_DIR_ENV",
    "BuildRecord",
    "BuildObserver",
    "CompileRegistry",
    "FlightStore",
    "MemWatch",
    "MemoryPlan",
    "MemoryPlanError",
    "MetricsRegistry",
    "REGISTRY",
    "ReportMixin",
    "TraceSink",
    "advise_hist_subtraction",
    "advise_mesh_2d",
    "advise_rounds_per_dispatch",
    "advise_serving_kernel",
    "aggregate_plans",
    "compute_section",
    "diff_envelopes",
    "diff_payloads",
    "digest",
    "drift_check",
    "ensemble_fingerprint",
    "localize_divergence",
    "merge_trace_files",
    "mesh_info",
    "metrics_text",
    "moved_stat",
    "note_build_path",
    "note_refine",
    "plan_fit",
    "platform_peaks",
    "plan_forest",
    "plan_ingest",
    "plan_serve",
    "preflight",
    "stats_view",
    "tree_fingerprints",
    "validate_trace",
    "warn_event",
    "wire_estimate",
]
