"""BuildRecord: the schema-versioned structured run record every fit emits.

Counterpart of ``mpitree_tpu/obs/record.py``: the same ``SCHEMA_VERSION``,
``TOP_LEVEL_FIELDS``, field semantics, :func:`wire_estimate`,
:func:`digest` and :class:`ReportMixin` (``dump_report`` with its degrade
contract), so a port record reads like a JAX record.

- **JSON-serializable and schema-versioned.** ``to_dict()`` returns plain
  Python containers (numpy scalars, 0-d tensors and arrays coerced).
- **Cheap when observability is off.** Counters, decisions, events and
  collective accounting are always on (host dict updates); wall-clock
  spans and per-level rows only exist under ``MPITREE_TPU_PROFILE=1``.

``memory`` is the memory ledger (``obs/memory.py``) and ``compute`` the
compute ledger (``obs/cost.py``), each ``{}`` until a fit records one.

:data:`STATS_MOVES` is the table of where each key that the port's
``fit_stats_`` held before it took the JAX package's contract lives in
``fit_report_`` now; :func:`moved_stat` reads one back and
:func:`stats_view` gives a report a read-only mapping of them.
Stdlib only.
"""

from __future__ import annotations

import dataclasses
import json
from collections.abc import Mapping

# The JAX package's schema, field for field: v9 is its current record
# (v3 added ``level_stream``, v4 ``wire``, v6 ``memory``, v7
# ``fingerprints``, v9 ``compute``). The port writes the same version so
# a consumer of either package's records gates on one number.
SCHEMA_VERSION = 9

# Which mesh axis each collective site reduces/gathers over — the wire
# ledger's per-axis attribution. Every histogram/counts/y-range reduction
# rides the data axis; the split-winner merge (collective.select_global)
# and the update step's owner-broadcast of child ids are the only
# feature-axis collectives. Unknown sites default to "data".
COLLECTIVE_AXES = {
    "feature_merge_all_gather": "feature",
    "route_psum": "feature",
}

# The golden field set, the JAX package's: a rename is a version bump.
TOP_LEVEL_FIELDS = (
    "schema",
    "engine",
    "mesh",
    "decisions",
    "phases",
    "levels",
    "counters",
    "compile",
    "collectives",
    "events",
    "rounds",
    "trees",
    "result",
    "level_stream",
    "wire",
    "memory",
    "fingerprints",
    "compute",
)


def _jsonable(obj):
    """Coerce numpy scalars and arrays, torch tensors and containers to
    plain JSON-serializable Python."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, bool)) or obj is None:
        return obj
    if isinstance(obj, int):
        return obj
    if isinstance(obj, float):
        return obj
    # numpy scalars and arrays, torch tensors (0-d or not) land here
    if getattr(obj, "ndim", 0) and hasattr(obj, "tolist"):
        return _jsonable(obj.tolist())
    if hasattr(obj, "item"):
        return _jsonable(obj.item())
    return str(obj)


@dataclasses.dataclass
class BuildRecord:
    """One fit's structured run record (see module docstring).

    Field semantics:

    - ``engine``: ``{"value", "reason", "inputs"}`` — the resolved build
      engine AND why (``core/builder.py``'s "auto" resolution inputs).
    - ``mesh``: ``{"platform", "n_devices", "axes"}``.
    - ``decisions``: every other recorded routing decision
      (``build_path``, ``refine``, ``early_stop``, ...), same shape as
      ``engine``.
    - ``phases``: PhaseTimer summary (``{name: {seconds, calls}}``) —
      populated only under ``MPITREE_TPU_PROFILE=1``.
    - ``levels``: per-level rows ``{level, frontier, splits, hist_bytes,
      psum_bytes, rows_scanned, small_child_fraction, seconds,
      new_lowerings}`` (levelwise/host: live; fused: reconstructed
      post-hoc from the finished tree's depth histogram, where the two
      row-scan fields are ``None`` — depth counts carry no per-node row
      totals). ``rows_scanned`` is the weight actually accumulated into
      split histograms (under sibling subtraction: the smaller siblings
      only); ``small_child_fraction = rows_scanned / frontier rows``.
      Profile-gated; capped (see BuildObserver).
    - ``counters``: always-on integer counters.
    - ``compile``: per jit entry point ``{"lowerings": lowering events
      seen process-wide (distinct keys, plus re-lowerings of keys the
      factory lru evicted), "new": lowerings triggered during this
      fit}`` — the runtime twin of graftlint GL02.
    - ``collectives``: per psum/gather site ``{"calls", "bytes"}`` — the
      LOGICAL payload computed from static shapes (zero device cost;
      multiply by (shards-1)/shards for wire traffic on an N-wide axis).
    - ``events``: typed events ``{"kind", "message"}`` — the structured
      form of what previously only went to stderr via ``warnings.warn``.
      The resilience ladder (``mpitree_tpu.resilience``) reports through
      here: ``device_retry`` (transient loss re-dispatched on the
      accelerator; paired counter ``device_retries``),
      ``device_failover`` (final rung, host rebuild; counter
      ``device_failovers``), ``checkpoint_resume`` (rounds/groups
      restored), ``nonfinite_grad`` (poisoned gbdt loss channel,
      fail-fast), ``checkpoint_disabled``.
    - ``rounds``: boosting per-round records (train/val loss, subsample
      fraction, early-stop state).
    - ``trees``: ensemble per-member summaries ``{"n_nodes", "depth"}``.
    - ``result``: ``{"n_nodes", "depth"}`` of the fitted tree (aggregates
      for ensembles).
    - ``level_stream``: ``{"path", "rows"}`` when per-level/per-expansion
      rows past the in-record cap were streamed to a JSONL spill file
      (``BuildObserver.stream_levels_to`` / ``MPITREE_TPU_OBS_STREAM_DIR``)
      instead of dropped; ``{}`` otherwise.
    - ``wire``: the collective ledger (:func:`wire_estimate`) — per-site
      and total wire-traffic estimates derived from the LOGICAL psum
      payloads above and the PER-AXIS mesh widths: a ring all-reduce of
      B logical bytes over an n-shard axis moves ``B*(n-1)/n`` per
      shard, ``B*(n-1)`` per concurrent ring across the fabric. Each
      site entry carries the ``axis`` it crosses
      (:data:`COLLECTIVE_AXES`) and the top level breaks fabric bytes
      down as ``data_bytes``/``feature_bytes`` (v5). Zero on a single
      device (no ICI hop exists). Populated by
      ``BuildObserver.report()``.
    - ``memory`` (v6): the device/host memory ledger
      (``obs.memory.MemoryPlan.to_dict()``) — per-array per-device byte
      rows with per-phase watermarks, ``hbm_peak_bytes``/
      ``host_peak_bytes``, the pricing inputs, and (with sampling on) a
      ``live`` section of span-boundary watermarks; ``{}`` when the
      engine recorded no plan. Host-loop multi-round fits add
      ``aggregate`` (v7): the whole-fit plan aggregation drift checking
      compares against.
    - ``fingerprints`` (v7): ``{"version", "trees": [[{level, nodes,
      hist, winner, alloc}, ...], ...], "fit"}`` — per-level u64 state
      fingerprints per built tree/round (``obs/fingerprint.py``) plus
      the whole-fit fold; ``{}`` when no engine committed any (plain
      PhaseTimer callers). ``obs.diff.localize_divergence`` bisects two
      records' trees to the first divergent (tree, level, channel).
    - ``compute`` (v9): the XLA cost-model compute ledger
      (``obs/cost.py``) — ``{"peak", "n_shards", "entries", "levels",
      "optimal_s", "measured_s", "util_pct", "roofline", "bounds_s"}``.
      ``entries`` maps each jit entry point to its captured whole-program
      flops/bytes (once per fresh compile cache key), the per-shard
      division, the optimal-seconds floor from the platform peak table,
      and achieved utilization joined against the measured span wall;
      ``levels`` carries per-level HBM/ICI floors against the per-level
      walls; ``roofline`` names the resource the fit's floor sits on
      (``"compute"``/``"hbm"``/``"ici"``). Everything unpriceable
      (unknown platform, legacy wheel, missing dispatch counts) is
      ``None``; ``{}`` when no entry was captured.
    """

    schema: int = SCHEMA_VERSION
    engine: dict = dataclasses.field(default_factory=dict)
    mesh: dict = dataclasses.field(default_factory=dict)
    decisions: dict = dataclasses.field(default_factory=dict)
    phases: dict = dataclasses.field(default_factory=dict)
    levels: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    compile: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)
    rounds: list = dataclasses.field(default_factory=list)
    trees: list = dataclasses.field(default_factory=list)
    result: dict = dataclasses.field(default_factory=dict)
    level_stream: dict = dataclasses.field(default_factory=dict)
    wire: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)
    fingerprints: dict = dataclasses.field(default_factory=dict)
    compute: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return _jsonable(dataclasses.asdict(self))

    def to_json(self, **kwargs) -> str:
        kwargs.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_json(cls, text: str) -> "BuildRecord":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


def wire_estimate(collectives: dict, axes) -> dict:
    """The collective ledger: wire-traffic estimates per psum/gather site.

    ``collectives`` holds LOGICAL payloads (static-shape bytes per call
    site); on an ``n``-shard axis a ring all-reduce of B logical bytes
    moves ``B*(n-1)/n`` per shard and ``B*(n-1)`` across the fabric —
    the per-shard/per-fit ICI wire estimates the ROADMAP obs follow-up
    asked for. One device means no ICI hop: everything is zero, honestly.

    ``axes``: the mesh's axis widths (``record.mesh['axes']``, e.g.
    ``{"data": 4, "feature": 2}``) — each site's ring width is the width
    of ITS axis (:data:`COLLECTIVE_AXES`), not the flat device count: a
    data-axis psum on a (4, 2) mesh runs df=2 independent 4-shard rings,
    and the recorded logical payload is already per feature group. A
    plain int (legacy callers) means a 1-D data axis of that width. An
    axis the mesh does not carry has width 1 — zero wire. The per-axis
    breakdown (``data_bytes``/``feature_bytes``) sums fabric wire bytes
    by the axis they cross.
    """
    if not isinstance(axes, dict):
        axes = {"data": int(axes or 1)}
    axes = {str(k): int(v) for k, v in axes.items()}
    n = 1
    for v in axes.values():
        n *= max(v, 1)
    sites = {}
    total_logical = 0
    total_wire = 0
    total_shard = 0
    per_axis = {"data": 0, "feature": 0}
    for site, v in sorted(collectives.items()):
        b = int(v.get("bytes", 0))
        axis = COLLECTIVE_AXES.get(site, "data")
        w = max(int(axes.get(axis, 1)), 1)
        # The fabric total counts every concurrent ring: a data-axis
        # reduction on a (dr, df) mesh runs df independent dr-shard rings
        # (one per feature group), each moving the recorded per-group
        # payload; each SHARD still sits in exactly one ring.
        groups = max(n // w, 1)
        wire = b * (w - 1) * groups
        total_logical += b
        total_wire += wire
        total_shard += b * (w - 1) // w
        per_axis[axis] = per_axis.get(axis, 0) + wire
        sites[site] = {
            "bytes": b,
            "axis": axis,
            "wire_bytes": wire,
            "wire_bytes_per_shard": b * (w - 1) // w,
        }
    return {
        "n_shards": n,
        "axes": axes,
        "sites": sites,
        "bytes": total_logical,
        "wire_bytes": total_wire,
        "wire_bytes_per_shard": total_shard,
        "data_bytes": per_axis["data"],
        "feature_bytes": per_axis["feature"],
    }


def digest(report: dict) -> dict:
    """Compact summary of a report dict — what bench section lines embed.

    Small by construction (~10 scalar fields), so a log line can carry
    one per fit.
    """
    total_psum = sum(
        int(v.get("bytes", 0)) for v in report.get("collectives", {}).values()
    )
    wall = sum(
        float(v.get("seconds", 0.0)) for v in report.get("phases", {}).values()
    )
    # Realized sibling-subtraction savings: the fraction of interior
    # frontier weight that was actually accumulated into histograms
    # (1.0 = direct accumulation everywhere; ~0.5 + 1/levels is the
    # steady-state floor — the root always scans fully). None when the
    # engine recorded no row counters (fused replay, host tiers).
    counters = report.get("counters", {})
    scanned = counters.get("rows_scanned")
    frontier = counters.get("rows_frontier")
    return {
        "engine": report.get("engine", {}).get("value"),
        "reason": (report.get("engine", {}).get("reason") or "")[:120],
        "n_nodes": report.get("result", {}).get("n_nodes"),
        "depth": report.get("result", {}).get("depth"),
        "levels": len(report.get("levels", [])),
        "compile_new": sum(
            int(v.get("new", 0)) for v in report.get("compile", {}).values()
        ),
        "psum_bytes": total_psum,
        "sub_frac": (
            round(scanned / frontier, 4) if scanned is not None and frontier
            else None
        ),
        # Leaf-wise growth: interior expansions the best-first
        # frontier actually paid for (None for level-wise builds), and
        # the fused multi-round GBDT dispatch width (None for
        # host-per-round loops and non-boosting fits).
        "expansions": counters.get("expansions"),
        "rounds_per_dispatch": (
            report.get("decisions", {}).get("rounds_per_dispatch") or {}
        ).get("value"),
        "events": len(report.get("events", [])),
        # The collective ledger's per-fit/per-shard ICI wire estimates
        # (v4): zero on one device — a nonzero number here is real fabric
        # traffic, not logical payload (that's psum_bytes).
        "wire_bytes": report.get("wire", {}).get("wire_bytes"),
        "wire_shard_bytes": report.get("wire", {}).get(
            "wire_bytes_per_shard"
        ),
        # Feature-axis width of the build mesh (v5): 1 on every 1-D data
        # mesh — a >1 value says histograms were feature-sharded and
        # psum_bytes is per-slab, not per-F.
        "feature_shards": (
            report.get("mesh", {}).get("axes", {}) or {}
        ).get("feature", 1),
        # The memory ledger's predicted per-device peak HBM and host RAM
        # (v6): None when the engine recorded no plan (plain-PhaseTimer
        # callers, pre-v6 records).
        "hbm_peak_bytes": (report.get("memory") or {}).get(
            "hbm_peak_bytes"
        ),
        "host_peak_bytes": (report.get("memory") or {}).get(
            "host_peak_bytes"
        ),
        # The whole-fit build-state fingerprint (v7): one u64 over every
        # level of every tree (obs/fingerprint.py). Two lineage entries
        # whose fingerprints differ built DIFFERENT trees — obs.diff then
        # bisects the per-level rows to the first divergent
        # (tree, level, channel). None when no engine committed rows.
        "fingerprint": (report.get("fingerprints") or {}).get("fit"),
        # Fine-grained recovery counters (v8, resilience v2): sub-build
        # re-dispatches (level/expansion/dispatch granularity) and
        # on-device OOM rescues. None when the fit needed neither — a
        # nonzero value on a bench line says the capture SURVIVED
        # something, which the noise model should know about.
        "level_retries": counters.get("level_retries"),
        "oom_rescues": counters.get("oom_rescues"),
        # The compute ledger's headline pair (v9, obs/cost.py): achieved
        # utilization of the optimal-seconds floor and the roofline
        # verdict naming which resource that floor sits on. None where
        # the card could not be priced (the CPU, an unknown part).
        "util_pct": (report.get("compute") or {}).get("util_pct"),
        "roofline": (report.get("compute") or {}).get("roofline"),
        "wall_s": round(wall, 3),
    }


class ReportMixin:
    """Adds ``dump_report(path)`` to estimators carrying ``fit_report_``."""

    def dump_report(self, path) -> str | None:
        """Write the fitted ``fit_report_`` as JSON to ``path``.

        Round-trip contract: ``json.load(open(path)) == self.fit_report_``
        Returns ``path``.

        Sink contract (same as checkpoints, the obs level-stream spill,
        and ``trace_to``): the parent directory is created up front, and
        an unwritable path DEGRADES — a warning plus a typed
        ``trace_failed`` event appended to ``fit_report_['events']``,
        returning None — instead of aborting the caller's post-fit flow
        over a telemetry sink.
        """
        import os
        import warnings

        report = getattr(self, "fit_report_", None)
        if report is None:
            raise ValueError(
                "no fit_report_ on this estimator — call fit() first"
            )
        try:
            parent = os.path.dirname(os.path.abspath(str(path)))
            os.makedirs(parent, exist_ok=True)
            with open(path, "w") as f:
                json.dump(report, f, indent=2, sort_keys=True)
        except OSError as e:
            msg = (
                f"dump_report sink unwritable ({e}); report kept in "
                "memory only (fit_report_)"
            )
            warnings.warn(msg, stacklevel=2)
            report.setdefault("events", []).append(
                {"kind": "trace_failed", "message": msg, "path": str(path)}
            )
            return None
        return str(path)


# -- the keys the port's fit_stats_ used to hold ------------------------------

# Collective sites by the kind the port's mesh counted them under before
# they took the JAX package's site names (``parallel/collective.py``):
# every other site is an all-reduce.
SITE_KINDS = {
    "feature_merge_all_gather": "gather",
    "route_psum": "route",
    "row_exchange": "exchange",
    "tree_exchange": "tree_exchange",
    "replication_check": "replication",
}

# The engine spans a tree's crown build covers (what ``crown_seconds``
# timed): the device engines' and the host tier's.
CROWN_PHASES = ("shard", "split", "counts", "update", "fused_build",
                "leafwise_build", "forest_build", "host_finalize",
                "host_build")

# Old ``fit_stats_`` key -> where ``fit_report_`` keeps it: a path of
# keys, or one of the aggregates :func:`moved_stat` computes ("sum of
# ..."). Timing keys exist only under ``MPITREE_TPU_PROFILE=1``, as every
# span does.
STATS_MOVES = {
    "engine": ("engine", "value"),
    "frontier": ("decisions", "frontier", "value"),
    "pool": ("decisions", "frontier", "inputs", "pool"),
    "graph": ("decisions", "frontier", "inputs", "graph"),
    "graph_reason": ("decisions", "frontier", "inputs", "graph_reason"),
    "hist_subtraction": ("decisions", "hist_subtraction", "value"),
    "ensemble_path": ("decisions", "ensemble_path", "value"),
    "crown_depth": ("decisions", "refine", "value"),
    "refine_engine": ("decisions", "refine_tail", "value"),
    "rounds_per_dispatch": ("decisions", "rounds_per_dispatch"),
    "early_stop": ("decisions", "early_stop", "value"),
    "n_rounds": ("decisions", "early_stop", "inputs", "n_iter"),
    "n_shards": ("mesh", "n_devices"),
    "forest_mesh": "[mesh.axes.tree, mesh.axes.data]",
    "expansions": ("counters", "expansions"),
    "refine_candidates": ("counters", "refine_candidates"),
    "refine_nodes_added": ("counters", "refine_nodes_added"),
    "level_dispatches": ("counters", "level_dispatches"),
    "expansion_dispatches": ("counters", "expansion_dispatches"),
    "dispatches": ("counters", "fused_round_dispatches"),
    "device_retries": ("counters", "device_retries"),
    "level_retries": ("counters", "level_retries"),
    "device_failovers": ("counters", "device_failovers"),
    "checkpoint_compactions": ("counters", "checkpoint_compactions"),
    "resumed_rounds": ("counters", "resumed_rounds"),
    "replication_checks": ("collectives", "replication_check", "calls"),
    "bin_seconds": ("phases", "bin", "seconds"),
    "crown_seconds": "sum of phases[CROWN_PHASES].seconds",
    "tail_seconds": ("phases", "refine", "seconds"),
    "tail_bin_seconds": ("phases", "refine", "bin_seconds"),
    "tail_sweep_seconds": ("phases", "refine", "sweep_seconds"),
    "prune_seconds": ("phases", "prune", "seconds"),
    "loss_seconds": "sum of rounds[].loss_seconds",
    "build_seconds": ("sum of rounds[].build_seconds"
                      " + phases.fused_rounds.seconds"),
    "refit_seconds": "sum of rounds[].refit_seconds",
}
for _kind in ("allreduce", "gather", "route", "exchange", "tree_exchange"):
    for _f in ("calls", "bytes", "seconds"):
        STATS_MOVES[f"{_kind}_{_f}"] = (
            f"sum of collectives[site].{_f} over the {_kind} sites")

_MISSING = object()


def _path(report: dict, path: tuple):
    cur = report
    for k in path:
        if not isinstance(cur, dict) or k not in cur:
            return _MISSING
        cur = cur[k]
    return cur


def moved_stat(report: dict, key: str, default=_MISSING):
    """The value ``fit_report_`` (``report``) keeps for ``key``, a key of
    the port's old ``fit_stats_`` (:data:`STATS_MOVES`). An aggregate
    over no entries is 0 (a count) or 0.0 (seconds); a missing path (or
    a None decision value) returns ``default``, else raises ``KeyError``.
    """
    where = STATS_MOVES[key]
    if isinstance(where, tuple) and where[0] == "collectives":
        got = _path(report, where)
        got = 0 if got is _MISSING else got  # no such reduction ran
    elif isinstance(where, tuple):
        got = _path(report, where)
    elif key == "forest_mesh":
        axes = (report.get("mesh") or {}).get("axes") or {}
        got = ([int(axes["tree"]), int(axes.get("data", 1))]
               if "tree" in axes else _MISSING)
    elif key == "crown_seconds":
        ph = report.get("phases") or {}
        got = (sum(float(ph[p]["seconds"]) for p in CROWN_PHASES if p in ph)
               if ph else _MISSING)
    elif key.endswith(("loss_seconds", "build_seconds", "refit_seconds")):
        rows = [r.get(key) for r in report.get("rounds") or []]
        rows = [float(v) for v in rows if v is not None]
        fused = (report.get("phases") or {}).get("fused_rounds")
        if key == "build_seconds" and fused:
            rows.append(float(fused["seconds"]))
        # timed fits only (their phases exist), a fused fit's loss laps
        # then 0
        got = sum(rows) if rows or report.get("phases") else _MISSING
    else:
        kind, field = key.rsplit("_", 1)
        vals = [v.get(field, 0) for site, v in
                (report.get("collectives") or {}).items()
                if SITE_KINDS.get(site, "allreduce") == kind]
        got = sum(vals) if vals else (0.0 if field == "seconds" else 0)
    if got is _MISSING or got is None:
        if default is _MISSING:
            raise KeyError(f"{key!r}: not in this fit_report_ "
                           f"({STATS_MOVES[key]})")
        return default
    return got


class StatsView(Mapping):
    """A read-only view of a ``fit_report_`` under the port's old
    ``fit_stats_`` keys (:data:`STATS_MOVES`): ``view["engine"]`` is
    ``report["engine"]["value"]``. A key whose place is missing (or a
    None decision value) is absent, as it was from the old dict."""

    def __init__(self, report: dict):
        self._report = report

    def __getitem__(self, key):
        if key not in STATS_MOVES:
            raise KeyError(key)
        return moved_stat(self._report, key)

    def __iter__(self):
        return (k for k in STATS_MOVES
                if moved_stat(self._report, k, None) is not None)

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"


def stats_view(report: dict) -> StatsView:
    """:class:`StatsView` of ``report`` (an estimator's ``fit_report_``)."""
    return StatsView(report)
