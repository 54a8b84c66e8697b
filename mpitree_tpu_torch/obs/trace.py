"""Chrome-trace-event (Perfetto-loadable) span timelines for fits + serving.

Counterpart of ``mpitree_tpu/obs/trace.py``, the same format and rules:
every live ``BuildObserver`` span, typed event (resilience retry and
failover rungs, checkpoint notes) and serving dispatch becomes a Chrome
trace event collected by a :class:`TraceSink`; the fused engines, whose
build runs on the device with no per-level host clock (a CUDA graph, or
one host loop that reads the frontier only), get spans *synthesized*
after the fact from the record's replayed level rows
(:func:`synthesize_record_tracks` lays them inside the live engine span's
window, weighted by their reduction payloads).

Format: the JSON object form of the Trace Event Format
(``{"traceEvents": [...], "displayTimeUnit": "ms"}``), loadable in
https://ui.perfetto.dev or ``chrome://tracing``. Tracks are (pid, tid)
pairs named through ``"M"`` (``thread_name``) metadata events; timestamps
are microseconds from sink creation, monotonic per track
(:func:`validate_trace` checks all of this).

Stdlib only (no torch, no numpy, no package imports), so a trace file can
be merged or validated anywhere.

Gating: nothing here runs unless a sink is configured —
``fit(trace_to=...)`` / ``CompiledModel.trace_to(...)`` for one sink
shared across fits, or ``MPITREE_TPU_TRACE_DIR=<dir>`` ambiently (one
file per observer). With no sink the observer's per-span work is one
``is None`` check.
"""

from __future__ import annotations

import json
import os
import threading
import time

# Ambient gate: every BuildObserver created while this is set traces to a
# uniquely named file in the directory (the estimator-internal-observer
# twin of fit(trace_to=...), same contract as MPITREE_TPU_OBS_STREAM_DIR).
TRACE_DIR_ENV = "MPITREE_TPU_TRACE_DIR"

# Phases a valid sink emits (the golden trace schema test whitelists
# these): X = complete span, i = instant, C = counter, M = metadata.
_VALID_PH = ("X", "i", "C", "M")

# The engine-loop phase names: synthesized level/round replay spans are
# laid inside the union of THESE spans' windows, so a replayed "level 3"
# nests under fused_build/split on the timeline instead of overlapping
# the bin/shard preamble.
BUILD_PHASES = frozenset((
    "split", "counts", "update", "fused_build", "leafwise_build",
    "forest_build", "fused_rounds", "host_build", "expand",
))


def _plain(obj):
    """JSON-coerce event args (numpy scalars arrive from record rows)."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item"):  # numpy scalar
        return _plain(obj.item())
    return str(obj)


class TraceSink:
    """Thread-safe Chrome-trace-event collector; one file per sink.

    Multiple observers may share one sink (the ``examples/obs_trace_run``
    fit+serve timeline): each registers its own named tracks via
    :meth:`tid`, and each replaces its *synthesized* replay events
    wholesale through :meth:`set_synth` (keyed by owner), so a repeated
    ``report()`` re-synthesizes instead of duplicating.
    """

    def __init__(self, path=None):
        self.path = None if path is None else str(path)
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._events: list = []
        self._synth: dict = {}
        self._tids: dict = {}
        self._meta: list = []
        self._meta.append({
            "ph": "M", "pid": self.pid, "tid": 0, "ts": 0,
            "name": "process_name", "args": {"name": "mpitree_tpu"},
        })

    # -- timebase ----------------------------------------------------------
    def ts(self, t: float) -> float:
        """perf_counter seconds -> trace microseconds (sink-relative)."""
        return round((t - self._t0) * 1e6, 3)

    def tid(self, track: str) -> int:
        """The tid for a named track (registers thread_name metadata once)."""
        with self._lock:
            tid = self._tids.get(track)
            if tid is None:
                tid = self._tids[track] = len(self._tids) + 1
                self._meta.append({
                    "ph": "M", "pid": self.pid, "tid": tid, "ts": 0,
                    "name": "thread_name", "args": {"name": track},
                })
            return tid

    # -- event channels ----------------------------------------------------
    def complete(self, track: str, name: str, t_start: float, dur_s: float,
                 *, cat: str = "span", args=None) -> None:
        ev = {
            "ph": "X", "pid": self.pid, "tid": self.tid(track),
            "name": str(name), "cat": cat, "ts": self.ts(t_start),
            "dur": round(max(float(dur_s), 0.0) * 1e6, 3),
        }
        if args:
            ev["args"] = _plain(args)
        with self._lock:
            self._events.append(ev)

    def instant(self, track: str, name: str, t: float | None = None,
                *, cat: str = "event", args=None) -> None:
        t = time.perf_counter() if t is None else t
        ev = {
            "ph": "i", "pid": self.pid, "tid": self.tid(track),
            "name": str(name), "cat": cat, "ts": self.ts(t), "s": "t",
        }
        if args:
            ev["args"] = _plain(args)
        with self._lock:
            self._events.append(ev)

    def counter(self, track: str, name: str, t: float, values: dict) -> None:
        ev = {
            "ph": "C", "pid": self.pid, "tid": self.tid(track),
            "name": str(name), "cat": "counter", "ts": self.ts(t),
            "args": {str(k): float(v) for k, v in values.items()},
        }
        with self._lock:
            self._events.append(ev)

    def set_synth(self, owner: str, events: list) -> None:
        """Replace ``owner``'s synthesized replay events wholesale."""
        with self._lock:
            self._synth[owner] = list(events)

    # -- output ------------------------------------------------------------
    def events(self) -> list:
        """Metadata first, then all events sorted by (tid, ts) — ts stays
        monotonic per track whatever order threads appended in."""
        with self._lock:
            body = list(self._events)
            for lst in self._synth.values():
                body.extend(lst)
            meta = list(self._meta)
        body.sort(key=lambda e: (e.get("tid", 0), e.get("ts", 0.0)))
        return meta + body

    def to_dict(self) -> dict:
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "mpitree_tpu.obs.trace"},
        }

    def write(self, path=None) -> str:
        """Write the trace JSON; makedirs the parent up front.

        Raises ``OSError`` on an unwritable sink — the *observer* owns the
        degrade-to-``trace_failed``-event contract (it has the record to
        put the event in); library callers holding a bare sink get the
        honest error.
        """
        path = self.path if path is None else str(path)
        if path is None:
            raise ValueError("TraceSink has no path; pass write(path=...)")
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


# ---------------------------------------------------------------------------
# post-hoc synthesis: replay record rows into timeline spans
# ---------------------------------------------------------------------------

def _layout(rows, t0: float, t1: float, weight_key: str):
    """Lay ``rows`` sequentially inside [t0, t1].

    Rows carrying real ``seconds`` (live level-wise loops, boosting
    rounds) keep their true durations; rows without (the fused engines'
    post-hoc replay — one compiled program has no per-level host clock)
    share the remaining window proportionally to ``weight_key`` (their
    psum payload: the replay's best static proxy for realized work).
    Returns [(start, dur, row)] in row order.
    """
    known = sum(float(r["seconds"]) for r in rows if r.get("seconds"))
    blind = [r for r in rows if not r.get("seconds")]
    wsum = sum(float(r.get(weight_key) or 0) + 1.0 for r in blind)
    remaining = max((t1 - t0) - known, 0.0)
    out, cur = [], t0
    for r in rows:
        if r.get("seconds"):
            dur = float(r["seconds"])
        elif wsum > 0:
            dur = remaining * (float(r.get(weight_key) or 0) + 1.0) / wsum
        else:
            dur = 0.0
        dur = max(dur, 1e-6)
        out.append((cur, dur, r))
        cur += dur
    return out


def synthesize_record_tracks(sink: TraceSink, owner: str, track: str,
                             report: dict, window=None) -> int:
    """Replay a finalized record dict into ``<track>:levels`` /
    ``<track>:rounds`` span tracks plus an ``ici`` counter track.

    ``window``: the observer's live span coverage ``[t0, t1]`` in
    perf_counter seconds — replay spans are laid inside it so they nest
    under the engine's real ``fused_build``/``split`` spans. ``owner``
    keys wholesale replacement (repeated ``report()`` calls re-synthesize
    instead of duplicating). Returns the number of events synthesized.
    """
    if window is None:
        t0 = sink._t0
        t1 = t0 + max(
            sum(float(r.get("seconds") or 0)
                for r in report.get("levels", [])),
            1e-3,
        )
    else:
        t0, t1 = window
    events: list = []
    n_shards = int((report.get("mesh") or {}).get("n_devices") or 1)
    cum_logical = 0.0

    levels = report.get("levels") or []
    if levels:
        tid = sink.tid(f"{track}:levels")
        ici_tid = sink.tid("ici")
        for start, dur, r in _layout(levels, t0, t1, "psum_bytes"):
            events.append({
                "ph": "X", "pid": sink.pid, "tid": tid,
                "name": f"level {r.get('level')}", "cat": "replay",
                "ts": sink.ts(start), "dur": round(dur * 1e6, 3),
                "args": _plain(r),
            })
            cum_logical += float(r.get("psum_bytes") or 0)
            events.append({
                "ph": "C", "pid": sink.pid, "tid": ici_tid,
                "name": "ici_psum_bytes", "cat": "counter",
                "ts": sink.ts(start + dur),
                "args": {
                    "logical": cum_logical,
                    "wire": cum_logical * (n_shards - 1),
                },
            })

    rounds = report.get("rounds") or []
    if rounds:
        tid = sink.tid(f"{track}:rounds")
        for start, dur, r in _layout(rounds, t0, t1, "trees"):
            events.append({
                "ph": "X", "pid": sink.pid, "tid": tid,
                "name": f"round {r.get('round')}", "cat": "replay",
                "ts": sink.ts(start), "dur": round(dur * 1e6, 3),
                "args": _plain(r),
            })

    # Utilization counter track (v9, obs/cost.py) next to the ici/mem
    # tracks: the whole-fit achieved utilization at the window edges plus
    # one sample per priced level, laid on the same replay layout as the
    # level spans. Only priced values are emitted (C-event args must be
    # numeric — the golden validate_trace rule); an unpriced record adds
    # no track at all.
    compute = report.get("compute") or {}
    fit_util = compute.get("util_pct")
    level_utils = {
        r.get("level"): r.get("util_pct")
        for r in compute.get("levels") or []
        if isinstance(r.get("util_pct"), (int, float))
    }
    if isinstance(fit_util, (int, float)) or level_utils:
        util_tid = sink.tid("util")
        if isinstance(fit_util, (int, float)):
            events.append({
                "ph": "C", "pid": sink.pid, "tid": util_tid,
                "name": "util_pct", "cat": "counter",
                "ts": sink.ts(t0), "args": {"pct": float(fit_util)},
            })
        t_last = t0
        if level_utils and levels:
            for start, dur, r in _layout(levels, t0, t1, "psum_bytes"):
                u = level_utils.get(r.get("level"))
                if u is None:
                    continue
                events.append({
                    "ph": "C", "pid": sink.pid, "tid": util_tid,
                    "name": "util_pct", "cat": "counter",
                    "ts": sink.ts(start + dur), "args": {"pct": float(u)},
                })
                t_last = max(t_last, start + dur)
        if isinstance(fit_util, (int, float)):
            # The closing sample sits at the window edge — or past it
            # when live level seconds overran the span window (the
            # monotonic-per-track golden rule wins over the edge).
            events.append({
                "ph": "C", "pid": sink.pid, "tid": util_tid,
                "name": "util_pct", "cat": "counter",
                "ts": sink.ts(max(t1, t_last)),
                "args": {"pct": float(fit_util)},
            })

    sink.set_synth(owner, events)
    return len(events)


# ---------------------------------------------------------------------------
# validation + merge (stdlib-only: the watcher and trace-smoke ride these)
# ---------------------------------------------------------------------------

def validate_trace(obj) -> list:
    """Schema problems with a trace dict; ``[]`` means Perfetto-loadable.

    Checks the trace contract: the
    trace-event envelope, required per-event fields, known phases,
    non-negative microsecond timestamps monotonic per (pid, tid) track,
    and a ``thread_name`` metadata event for every track that carries
    events (the pid/tid -> track mapping Perfetto renders by).
    """
    problems = []
    if not isinstance(obj, dict) or not isinstance(
        obj.get("traceEvents"), list
    ):
        return ["top level must be a dict with a traceEvents list"]
    named = set()
    last_ts: dict = {}
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for field in ("ph", "pid", "tid", "name"):
            if field not in ev:
                problems.append(f"event {i}: missing {field!r}")
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph == "M":
            if ev.get("name") == "thread_name":
                named.add((ev.get("pid"), ev.get("tid")))
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        key = (ev.get("pid"), ev.get("tid"))
        if ts < last_ts.get(key, 0.0):
            problems.append(
                f"event {i}: ts {ts} not monotonic on track {key}"
            )
        last_ts[key] = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event bad dur {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                problems.append(f"event {i}: C event needs numeric args")
    for key in last_ts:
        if key not in named:
            problems.append(f"track {key} has no thread_name metadata")
    return problems


def merge_trace_files(paths: list, out: str) -> str | None:
    """Merge per-observer trace files into ONE Perfetto-loadable file.

    Each source file becomes its own pid (its filename is the
    process_name), so a bench section's many fits render side by side.
    Unreadable/invalid sources are skipped (the watcher merges whatever a
    killed section managed to write). Returns ``out``, or None when no
    source contributed events.
    """
    merged: list = []
    pid = 0
    for p in sorted(paths):
        try:
            with open(p) as f:
                data = json.load(f)
            events = data["traceEvents"]
        except (OSError, ValueError, KeyError, TypeError):
            continue
        if not isinstance(events, list) or not events:
            continue
        pid += 1
        merged.append({
            "ph": "M", "pid": pid, "tid": 0, "ts": 0,
            "name": "process_name",
            "args": {"name": os.path.basename(p)},
        })
        for ev in events:
            if isinstance(ev, dict):
                ev = dict(ev)
                ev["pid"] = pid
                if ev.get("name") == "process_name":
                    continue
                merged.append(ev)
    if not pid:
        return None
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
    return out
