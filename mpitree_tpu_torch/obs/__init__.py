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
and ``obs.cost`` the compute ledger against the card's peaks. The flight
store, ``obs.diff`` and the advisor are ``ROADMAP.md`` Queue 1 (18d,
18f).
"""

from mpitree_tpu_torch.obs.fingerprint import (
    FINGERPRINT_VERSION,
    ensemble_fingerprint,
    tree_fingerprints,
)
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
    "FINGERPRINT_VERSION",
    "MEMORY_SCHEMA",
    "SCHEMA_VERSION",
    "STATS_MOVES",
    "TOP_LEVEL_FIELDS",
    "TRACE_DIR_ENV",
    "BuildRecord",
    "BuildObserver",
    "CompileRegistry",
    "MemWatch",
    "MemoryPlan",
    "MemoryPlanError",
    "MetricsRegistry",
    "REGISTRY",
    "ReportMixin",
    "TraceSink",
    "aggregate_plans",
    "digest",
    "drift_check",
    "ensemble_fingerprint",
    "merge_trace_files",
    "mesh_info",
    "metrics_text",
    "moved_stat",
    "note_build_path",
    "note_refine",
    "plan_fit",
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
