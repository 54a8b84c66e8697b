"""BuildObserver: the span()/counter() API every engine writes into.

Counterpart of ``mpitree_tpu/obs/observer.py``. A superset of
``utils/profiling.PhaseTimer`` (which it subclasses): the timer's phase
spans keep working unchanged, and the observer adds the always-on cheap
channels (counters, decisions, typed events, compile and collective
accounting, build-state fingerprints) plus the profile-gated per-level
rows.

Cost model:

- observability OFF (no ``MPITREE_TPU_PROFILE``, no trace sink): spans are
  the timer's no-op ``yield`` (no clock read, no synchronisation); level
  rows are never kept; counters, events and decisions are host dict
  updates;
- observability ON: spans accumulate wall-clock, each ending with
  ``torch.cuda.synchronize`` on a CUDA ``device`` so that it times the
  work and not its launches, and per-level rows are appended (capped at
  :attr:`BuildObserver.MAX_LEVEL_ROWS`; rows past the cap stream to a
  JSONL spill file when a sink is configured,
  :meth:`BuildObserver.stream_levels_to` or
  ``MPITREE_TPU_OBS_STREAM_DIR``; with no sink ``levels_dropped`` counts
  them).

Collective accounting: a fit's ``collectives`` are the reductions the
port ran, per site (``parallel/collective.psum``'s ``site``, the JAX
package's site names where it has one): calls, bytes and seconds from
each mesh the fit registered (:meth:`BuildObserver.set_mesh`), read at
:meth:`BuildObserver.report`. A fit on one device reduces nothing.

Compile accounting is a process-wide cache-key registry of the port's
cold events (:data:`REGISTRY`): ``ext:<name>`` is the first build and
load of a CUDA extension (``_build.load``), ``native:split_kernel`` the
host sweep's, ``cuda_graph:leafwise`` and ``cuda_graph:fused_rounds`` a
CUDA-graph capture of the leaf loop's step by its static key
(``core/leafwise_builder._LeafLoop``). Such an event notes itself into
the observer of the fit it happens in (:func:`observing`,
:func:`cold_event`).

The memory ledger (``obs/memory.py``): every engine records its plan
(:meth:`BuildObserver.memory_plan`, before its first launch) into
``record.memory``; ``MPITREE_TPU_MEM_SAMPLE=1`` (or
:meth:`BuildObserver.watch_memory`) samples the live watermark at every
span close (on the card the caching allocator's peak since the last
sample), renders it as the trace's ``mem`` counter track, and checks the
ledger against it at :meth:`BuildObserver.report` (typed
``mem_estimate_drift``). A fit of several plans (the host boosting loop's
rounds) is checked against their aggregate.

The compute ledger (``obs/cost.py``): each engine notes its dispatches
(:meth:`BuildObserver.price_dispatch`), priced once per static key from
the port's own count (:meth:`BuildObserver.price_compile`, kept in
:data:`REGISTRY` for later fits), and :meth:`BuildObserver.report` joins
them with the span walls and the card's peak row into
``record.compute``; the CPU prices to None, and an unknown card to None
with one typed ``cost_unavailable`` event per entry.

The flight recorder (``obs/flight.py``): under ``MPITREE_TPU_RUN_DIR``
the first :meth:`BuildObserver.report` of a fit appends the finalized
record to the run store, once (``flight_kind`` labels it: ``"fit"``, or
``"serve"`` for a served model's observer). A set ``RUN_DIR`` turns span
timing on, as a trace sink does: the sentinel's headline metric is the
digest's ``wall_s``, which untimed spans would leave at 0.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
import warnings
from collections import OrderedDict

from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.obs import cost as cost_mod
from mpitree_tpu_torch.obs import fingerprint as fingerprint_mod
from mpitree_tpu_torch.obs import flight as flight_mod
from mpitree_tpu_torch.obs import memory as memory_mod
from mpitree_tpu_torch.obs import trace as trace_mod
from mpitree_tpu_torch.obs.record import (
    BuildRecord,
    _jsonable,
    wire_estimate,
)
from mpitree_tpu_torch.obs.record import digest as record_digest
from mpitree_tpu_torch.utils.profiling import PhaseTimer, profiling_enabled

# Per-process spill-file and trace sequences: distinguish observers
# sharing a PID without relying on id(self) (heap addresses recycle).
_STREAM_SEQ = itertools.count()
_TRACE_SEQ = itertools.count()

# Cold events per entry point beyond which we warn (recompile churn: a
# static key carrying a runtime-varying value).
RECOMPILE_WARN_AFTER = 32


class CompileRegistry:
    """Process-wide cold-event counts per entry point.

    Each entry point's key set is an LRU of ``cache_size`` keys: a key
    seen before but since evicted is cold again. ``count`` totals cold
    events (>= distinct keys)."""

    def __init__(self):
        self._lru: dict = {}
        self._lowerings: dict = {}
        self._seconds: dict = {}
        self._lock = threading.Lock()
        self._warned: set = set()
        # the compute ledger's captures: per entry, an LRU of static key ->
        # {flops, bytes[, note]}
        self._costs: dict = {}

    def note(self, entry: str, key, cache_size: int = 64, *,
             churn: bool = True) -> bool:
        """Record one resolution; True when ``key`` is cold (first sight
        or evicted), False when it is warm. ``churn=False`` (an entry
        whose every event is cold by nature, a CUDA-graph capture) skips
        the recompile-churn warning."""
        with self._lock:
            lru = self._lru.setdefault(entry, OrderedDict())
            if key in lru:
                lru.move_to_end(key)
                return False
            lru[key] = True
            while len(lru) > cache_size:
                lru.popitem(last=False)
            n = self._lowerings.get(entry, 0) + 1
            self._lowerings[entry] = n
        if churn and n == RECOMPILE_WARN_AFTER and entry not in self._warned:
            self._warned.add(entry)
            warnings.warn(
                f"entry point {entry!r} has had {RECOMPILE_WARN_AFTER} "
                "cold events this process — a static key is probably "
                "carrying a runtime-varying value; see "
                "fit_report_['compile']",
                stacklevel=4,
            )
        return True

    def count(self, entry: str) -> int:
        with self._lock:
            return self._lowerings.get(entry, 0)

    def attribute(self, entry: str, seconds: float) -> None:
        """Attribute cold seconds to ``entry`` (a build, a load, a
        capture)."""
        with self._lock:
            self._seconds[entry] = (
                self._seconds.get(entry, 0.0) + float(seconds))

    def seconds(self, entry: str) -> float:
        with self._lock:
            return self._seconds.get(entry, 0.0)

    def price(self, entry: str, info: dict, key=None,
              cache_size: int = 64) -> None:
        """Store ``entry``'s per-dispatch count at static ``key``."""
        with self._lock:
            lru = self._costs.setdefault(entry, OrderedDict())
            lru[key] = dict(info)
            lru.move_to_end(key)
            while len(lru) > cache_size:
                lru.popitem(last=False)

    def cost(self, entry: str, key=None) -> dict | None:
        """``entry``'s count at ``key`` (a copy, with ``variants``: the
        keys priced), or None when that key has none."""
        with self._lock:
            lru = self._costs.get(entry)
            if not lru or key not in lru:
                return None
            return dict(lru[key], variants=len(lru))


REGISTRY = CompileRegistry()

# The observer of the fit running in this thread (or task), so that a
# process-wide cold event (an extension's first build, a graph capture)
# lands in the record of the fit it happened in.
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "mpitree_tpu_torch_observer", default=None)


@contextlib.contextmanager
def observing(obs):
    """Make ``obs`` the active observer of this thread for the block."""
    token = _ACTIVE.set(obs)
    try:
        yield obs
    finally:
        _ACTIVE.reset(token)


def active():
    """The active observer (:func:`observing`), or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def cold_event(entry: str, key, cache_size: int = 64, *, churn: bool = True):
    """Note one resolution of ``entry`` at static ``key`` and, when it is
    cold, time the block as its cost: into :data:`REGISTRY` always, and
    into the active observer's ``compile`` section (and trace) when a fit
    is running. A warm key passes through untouched. ``churn`` as in
    :meth:`CompileRegistry.note`."""
    obs = active()
    if obs is not None:
        fresh = obs.compile_note(entry, key, cache_size=cache_size,
                                 churn=churn)
    else:
        fresh = REGISTRY.note(entry, key, cache_size=cache_size,
                              churn=churn)
    if not fresh:
        yield False
        return
    if obs is not None:
        with obs.compile_attribution(entry, True):
            yield True
        return
    t0 = time.perf_counter()
    try:
        yield True
    finally:
        REGISTRY.attribute(entry, time.perf_counter() - t0)


def mesh_info(mesh, device=None) -> dict:
    """JSON-able mesh description for the record: a
    ``parallel/mesh.Mesh`` (its lead device's type, global shard count
    and axis widths), or one ``device`` as a one-shard data mesh."""
    if mesh is None:
        import torch

        return {"platform": torch.device(device).type, "n_devices": 1,
                "axes": {"data": 1}}
    return {
        "platform": mesh.lead.type,
        "n_devices": int(mesh.size),
        "axes": {str(n): int(w) for n, w in
                 zip(mesh.axis_names, mesh.shape)},
    }


def warn_event(obs, kind: str, message: str, *, stacklevel: int = 2) -> None:
    """``warnings.warn`` + typed record event — one call per site, so the
    warning and the ``fit_report_`` event say the same thing. ``obs`` may
    be any PhaseTimer (the base class's ``event`` is a no-op) or None."""
    warnings.warn(message, stacklevel=stacklevel + 1)
    if obs is not None:
        obs.event(kind, message)


def note_build_path(obs, *, host: bool, backend, n_rows: int,
                    n_features: int) -> None:
    """Record the host-vs-device routing decision. Unlike the JAX
    package, the port routes no fit to the host tier by its size: only
    ``backend="host"`` does (``ROADMAP.md`` R3)."""
    if backend == "host":
        reason = "backend='host' forces the numpy tier"
    elif host:
        reason = "the host tier"
    else:
        reason = (
            "backend=None: the device engine on `device` (the port keeps "
            "every size on the card; only backend='host' takes the host "
            "tier)"
        )
    obs.decision(
        "build_path", "host" if host else "device", reason=reason,
        rows=int(n_rows), features=int(n_features),
    )


def note_refine(obs, *, refine: bool, rd, crown_depth,
                refine_depth_param, constrained: bool = False,
                leafwise: bool = False, streamed: bool = False) -> None:
    """Record the hybrid-refine decision (estimator-level routing), with
    the JAX package's reasons."""
    if streamed:
        reason = (
            "streamed ingest: hybrid tail skipped — single-tree fits "
            "replay the chunk stream to gather refine rows, but "
            "ensembles would replay it once per tree and multi-host "
            "fits only stream their own shard (single-engine full "
            "depth)"
        )
    elif leafwise:
        reason = (
            "max_leaf_nodes: hybrid tail skipped — the best-first frontier "
            "owns the leaf budget end to end (a host tail would re-grow "
            "past it)"
        )
    elif constrained:
        reason = (
            "monotonic_cst: hybrid tail skipped — constraint bounds do not "
            "thread across the graft seam (single-engine full depth)"
        )
    elif not refine:
        reason = (
            "no hybrid tail (refine_depth=None, exact candidates, or "
            "max_depth within the crown)"
        )
    elif refine_depth_param == "auto":
        reason = (
            "auto: quantile binning capped some feature's candidate set — "
            "exact-local-candidate host tail recovers deep-node accuracy"
        )
    else:
        reason = f"explicit refine_depth={refine_depth_param!r}"
    obs.decision(
        "refine", int(rd) if refine and rd is not None else None,
        reason=reason,
        crown_depth=(None if crown_depth is None else int(crown_depth)),
    )


class BuildObserver(PhaseTimer):
    """Structured run-record collector; see the module docstring.

    ``timing=None`` reads ``MPITREE_TPU_PROFILE`` (the PhaseTimer gate);
    pass an explicit bool to override. The record is always created;
    spans and level rows are timing-gated. ``device`` (set by the
    estimator) is where the fit's device work runs: enabled spans end
    when it is idle.
    """

    MAX_LEVEL_ROWS = 512
    MAX_EVENTS = 128
    MAX_ROUNDS = 1024

    def __init__(self, timing: bool | None = None):
        super().__init__(
            enabled=profiling_enabled() if timing is None else timing
        )
        self.record = BuildRecord()
        self._level_stream_path: str | None = None
        self._level_stream_file = None
        self._level_stream_failed = False
        self._trace: trace_mod.TraceSink | None = None
        self._trace_owned = False
        self._trace_failed = False
        self._trace_seq = next(_TRACE_SEQ)
        self._trace_track = f"fit{self._trace_seq}"
        self._trace_window: list | None = None
        self._trace_windows: dict = {}  # phase name -> [t0, t1]
        tdir = knobs.raw(trace_mod.TRACE_DIR_ENV)
        if tdir:
            self.trace_to(os.path.join(
                tdir, f"trace_{os.getpid()}_{self._trace_seq}.json"
            ))
        self._fp_hash = None
        self._meshes: dict = {}  # id -> Mesh whose stats the report reads
        self._notes: dict = {}  # collective() notes, by site
        self._phase_extra: dict = {}  # add_phase fields, by phase
        # every plan recorded (a host round loop records one a round)
        self._fit_plans: list = []
        # compute ledger: the entries this fit dispatched, and those whose
        # cost_unavailable event is out
        self._dispatched: dict = {}  # entry -> its latest static key
        self._cost_unavailable: set = set()
        self._memwatch: memory_mod.MemWatch | None = None
        if knobs.value(memory_mod.MEM_SAMPLE_ENV):
            self.watch_memory()
        # the flight recorder: one append at the first report()
        self._flight_logged = False
        self.flight_kind = "fit"
        if flight_mod.enabled():
            self.enabled = True

    # ``device`` (PhaseTimer's): where the fit runs. A memory watch that
    # has taken only its baseline moves there (the estimator sets the
    # device right after making the observer); a later move (the host
    # rung's) leaves the card's watermark as it is.
    @property
    def device(self):
        return self._device

    @device.setter
    def device(self, dev) -> None:
        self._device = dev
        mw = getattr(self, "_memwatch", None)
        if (mw is not None and dev is not None and mw.samples <= 1
                and mw.device != dev):
            self._memwatch = memory_mod.MemWatch(dev)
            self._memwatch.sample()

    # -- the memory ledger ----------------------------------------------------
    def watch_memory(self, watch=None) -> None:
        """Sample live memory at every span close (the ambient form is
        ``MPITREE_TPU_MEM_SAMPLE=1``); implies timing. The first sample is
        the baseline: what the process held before the fit."""
        dev = getattr(self, "_device", None)
        self._memwatch = (watch if watch is not None
                          else memory_mod.MemWatch(dev))
        if self._memwatch.device is None and dev is not None:
            self._memwatch.device = dev
        self._memwatch.sample()
        self.enabled = True

    @property
    def watching_memory(self) -> bool:
        return self._memwatch is not None

    def memory_plan(self, plan) -> None:
        """Record the analytical ledger (a ``obs.memory.MemoryPlan`` or its
        dict) under ``record.memory``, before the first launch; every plan
        is kept for the whole-fit aggregate."""
        d = plan if isinstance(plan, dict) else plan.to_dict()
        self._fit_plans.append(d)
        live = self.record.memory.get("live")
        self.record.memory = dict(d)
        if live is not None:
            self.record.memory["live"] = live

    # -- the compute ledger ---------------------------------------------------
    def price_compile(self, entry: str, lower, key=None) -> None:
        """Store ``lower()``'s count (``{"flops", "bytes"}``) as ``entry``'s
        per-dispatch cost at static ``key``; a count that fails degrades
        to one typed ``cost_unavailable`` event per entry, never a crash."""
        info = cost_mod.capture(lower)
        if info is None:
            self._cost_unavailable_event(
                entry, f"the port's count for entry {entry!r} failed; its "
                "compute-ledger floors stay None")
            return
        REGISTRY.price(entry, info, key)

    def price_dispatch(self, entry: str, key, cost_fn) -> None:
        """Note that this fit dispatched ``entry`` at static ``key``, and
        price it (:meth:`price_compile` of ``cost_fn``) when the process
        has no count for that key yet; the record joins this key's."""
        self._dispatched[entry] = key
        if REGISTRY.cost(entry, key) is None:
            self.price_compile(entry, cost_fn, key)

    def _cost_unavailable_event(self, entry: str, message: str) -> None:
        if entry not in self._cost_unavailable:
            self._cost_unavailable.add(entry)
            self.event("cost_unavailable", message, entry=entry)

    # -- build-state fingerprints ------------------------------------------
    wants_fingerprints = True

    def fingerprint_tree(self, rows) -> None:
        """Commit one built tree's (or refine subtree's) per-level
        fingerprint rows; every commit folds into the whole-fit hash,
        beyond the row cap too."""
        rows = list(rows)
        self._fp_hash = fingerprint_mod.fold(rows, self._fp_hash)
        fp = self.record.fingerprints
        if not fp:
            fp["version"] = fingerprint_mod.FINGERPRINT_VERSION
            fp["trees"] = []
        if len(fp["trees"]) >= self.MAX_ROUNDS:
            self.counter("fingerprint_trees_dropped")
            return
        fp["trees"].append(rows)

    # -- sinks ---------------------------------------------------------------
    def trace_to(self, sink, *, track: str | None = None) -> None:
        """Emit this observer's timeline into ``sink`` (a path, or a
        :class:`~mpitree_tpu_torch.obs.trace.TraceSink` shared across fits
        and served models). Tracing implies timing. An unwritable path
        degrades to a typed ``trace_failed`` event with tracing off: a
        telemetry sink never aborts a fit."""
        if track is not None:
            self._trace_track = str(track)
        if isinstance(sink, trace_mod.TraceSink):
            self._trace, self._trace_owned = sink, False
        else:
            path = str(sink)
            try:
                parent = os.path.dirname(os.path.abspath(path))
                os.makedirs(parent, exist_ok=True)
                with open(path, "a"):
                    pass
            except OSError as e:
                self._trace_failed = True
                self.event(
                    "trace_failed",
                    f"trace sink unwritable ({e}); tracing disabled for "
                    "this fit",
                    path=path,
                )
                return
            self._trace, self._trace_owned = trace_mod.TraceSink(path), True
        self.enabled = True

    def stream_levels_to(self, path) -> None:
        """Spill per-level/per-expansion rows past ``MAX_LEVEL_ROWS`` to
        ``path`` (JSONL, append) instead of dropping them;
        ``record.level_stream`` then says where the tail lives.
        ``MPITREE_TPU_OBS_STREAM_DIR=<dir>`` sets the same sink ambiently
        (one uniquely named file per observer, made at its first spill)."""
        self._level_stream_path = str(path)

    def _level_sink(self):
        """The open spill file, or None when no sink is configured. An
        unwritable sink degrades to ``levels_dropped`` with a typed
        ``level_stream_failed`` event."""
        if self._level_stream_file is not None:
            return self._level_stream_file
        if self._level_stream_failed:
            return None
        path = self._level_stream_path
        try:
            if path is None:
                stream_dir = knobs.raw("MPITREE_TPU_OBS_STREAM_DIR")
                if not stream_dir:
                    return None
                os.makedirs(stream_dir, exist_ok=True)
                path = os.path.join(
                    stream_dir,
                    f"levels_{os.getpid()}_{next(_STREAM_SEQ)}.jsonl",
                )
            self._level_stream_file = open(path, "a")
        except OSError as e:
            self._level_stream_failed = True
            self.event(
                "level_stream_failed",
                f"level-row spill sink unwritable ({e}); rows past the "
                "cap are dropped instead",
                path=path,
            )
            return None
        self._level_stream_path = path
        return self._level_stream_file

    # -- spans ---------------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str):
        tr = self._trace
        mw = self._memwatch
        if not self.enabled and tr is None and mw is None:
            yield
            return
        t0 = time.perf_counter()
        ok = False
        try:
            yield
            ok = True
        finally:
            if ok:
                self._idle()
            dt = time.perf_counter() - t0
            if self.enabled:
                self.seconds[name] += dt
                self.calls[name] += 1
            if mw is not None and ok:
                # a span-close sample (never inside a launch sequence),
                # drawn as the trace's mem counter track: current bytes,
                # so the track shows memory being released too
                mw.sample(name)
                if tr is not None:
                    tr.counter(
                        "mem", "mem_hbm_bytes", time.perf_counter(),
                        {"hbm": mw.hbm_last, "host": mw.host_last},
                    )
            if tr is not None:
                tr.complete(self._trace_track, name, t0, dt)
                w = self._trace_window
                if w is None:
                    self._trace_window = [t0, t0 + dt]
                else:
                    w[0] = min(w[0], t0)
                    w[1] = max(w[1], t0 + dt)
                pw = self._trace_windows.get(name)
                if pw is None:
                    self._trace_windows[name] = [t0, t0 + dt]
                else:
                    pw[0] = min(pw[0], t0)
                    pw[1] = max(pw[1], t0 + dt)

    span = phase

    def add_phase(self, name: str, **fields) -> None:
        """Add fields beside a phase's ``seconds`` and ``calls`` (a
        quantity the JAX package does not record, kept beside its nearest
        phase: the refine tail's binning and sweep seconds). Timing-gated
        like the phase."""
        if self.enabled:
            extra = self._phase_extra.setdefault(name, {})
            for k, v in fields.items():
                extra[k] = extra.get(k, 0.0) + v

    def summary(self) -> dict:
        out = super().summary()
        for name, extra in self._phase_extra.items():
            if name in out:
                out[name].update({k: round(v, 4) for k, v in extra.items()})
        return out

    @contextlib.contextmanager
    def compile_attribution(self, entry: str, fresh: bool = True):
        """Time the block following a cold ``compile_note`` and attribute
        its wall to ``entry``: in :data:`REGISTRY`, in
        ``fit_report_['compile'][entry]['seconds']`` and as a
        ``compile:{entry}`` trace span. A warm key passes through."""
        if not fresh:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            REGISTRY.attribute(entry, dt)
            rec = self.record.compile.setdefault(
                entry, {"lowerings": 0, "new": 0}
            )
            rec["seconds"] = round(rec.get("seconds", 0.0) + dt, 6)
            if self._trace is not None:
                self._trace.complete(
                    "compile", f"compile:{entry}", t0, dt, cat="compile"
                )

    # -- always-on channels ------------------------------------------------
    def counter(self, name: str, inc=1) -> None:
        c = self.record.counters
        c[name] = c.get(name, 0) + inc

    def event(self, kind: str, message: str, **data) -> None:
        if self._trace is not None:
            self._trace.instant(
                f"{self._trace_track}:events", kind, cat="event",
                args={"message": message, **data},
            )
        ev = self.record.events
        if len(ev) >= self.MAX_EVENTS:
            self.counter("events_dropped")
            return
        row = {"kind": kind, "message": message}
        if data:
            row.update(data)
        ev.append(row)

    def decision(self, key: str, value, reason: str | None = None,
                 **inputs) -> None:
        entry = {"value": value, "reason": reason}
        if inputs:
            entry["inputs"] = inputs
        self.record.decisions[key] = entry
        if key == "engine":
            self.record.engine = entry

    def set_mesh(self, mesh, device=None) -> None:
        """Record the fit's mesh (a ``parallel/mesh.Mesh``, or None and
        the one ``device``); a Mesh's collective counts join the record
        at :meth:`report`."""
        self.record.mesh = mesh_info(mesh, device)
        if mesh is not None:
            self._meshes[id(mesh.stats)] = mesh

    def collective(self, site: str, *, calls: int = 1, nbytes: int = 0) -> None:
        entry = self._notes.setdefault(site, {"calls": 0, "bytes": 0})
        entry["calls"] += int(calls)
        entry["bytes"] += int(nbytes)
        if self._trace is not None:
            self._trace.counter(
                "ici", f"ici:{site}", time.perf_counter(),
                {"bytes": entry["bytes"]},
            )

    def compile_note(self, entry: str, key, cache_size: int = 64, *,
                     churn: bool = True) -> bool:
        new = REGISTRY.note(entry, key, cache_size=cache_size, churn=churn)
        rec = self.record.compile.setdefault(entry, {"lowerings": 0, "new": 0})
        rec["lowerings"] = REGISTRY.count(entry)
        if new:
            rec["new"] += 1
        return new

    def round(self, **row) -> None:
        r = self.record.rounds
        if len(r) >= self.MAX_ROUNDS:
            self.counter("rounds_dropped")
            return
        r.append(row)

    # -- profile-gated channels --------------------------------------------
    def level(self, **row) -> None:
        if not self.enabled:
            return
        rows = self.record.levels
        if len(rows) >= self.MAX_LEVEL_ROWS:
            sink = self._level_sink()
            if sink is None:
                self.counter("levels_dropped")
                return
            sink.write(json.dumps(_jsonable(row), sort_keys=True) + "\n")
            ls = self.record.level_stream
            ls["path"] = self._level_stream_path
            ls["rows"] = ls.get("rows", 0) + 1
            return
        rows.append(row)

    # -- finalization ------------------------------------------------------
    def _collectives(self) -> dict:
        """The notes plus every registered mesh's per-site counts and
        replication checks (``parallel/mesh.new_stats``)."""
        out = {k: dict(v) for k, v in self._notes.items()}
        for mesh in self._meshes.values():
            st = mesh.stats
            for site, v in st.get("sites", {}).items():
                e = out.setdefault(site, {"calls": 0, "bytes": 0})
                e["calls"] += int(v["calls"])
                e["bytes"] += int(v["bytes"])
                e["seconds"] = round(e.get("seconds", 0.0)
                                     + float(v["seconds"]), 6)
            n = int(st.get("replication_checks", 0))
            if n:
                e = out.setdefault("replication_check",
                                   {"calls": 0, "bytes": 0})
                e["calls"] += n
                e["bytes"] += 16 * n
        return out

    def _compute(self, rec) -> None:
        """``record.compute``: the priced entries this fit dispatched,
        joined with its spans and the card's peak row, plus the host
        tier's counted, unpriced rows (idempotent)."""
        captures = {}
        for entry, key in sorted(self._dispatched.items()):
            cap = REGISTRY.cost(entry, key)
            if cap:
                captures[entry] = cap
        if captures:
            # a served model prices its card without timing on it
            dev = getattr(self, "cost_device", None) or self.device
            peaks = cost_mod.platform_peaks(cost_mod.device_kind(
                dev if dev is not None and str(dev).startswith("cuda")
                else "cpu"))
            # a card without a peak row says so; the CPU prices to None
            # silently, as the JAX package's CPU backend does
            if peaks["device_kind"] and not cost_mod.priceable(peaks):
                for entry in captures:
                    self._cost_unavailable_event(
                        entry,
                        f"no peak row for device {peaks['device_kind']!r} "
                        f"(obs.cost.PEAK_TABLE; {cost_mod.PEAK_FLOPS_ENV}/"
                        f"{cost_mod.PEAK_HBM_ENV} unset): entry {entry!r}'s "
                        "compute-ledger floors stay None")
            rec.compute = cost_mod.compute_section(
                {"phases": rec.phases, "collectives": rec.collectives,
                 "counters": rec.counters, "levels": rec.levels,
                 "wire": rec.wire, "mesh": rec.mesh}, captures, peaks)
        host_rows = cost_mod.host_entries(
            {"phases": rec.phases, "counters": rec.counters})
        if host_rows:
            if rec.compute:
                rec.compute["entries"].update(host_rows)
            else:
                rec.compute = cost_mod.host_only_section(host_rows)

    def _memory_live(self, rec) -> None:
        """The whole-fit aggregate of a multi-plan fit, the final live
        sample and the ledger-against-live verdict."""
        agg = None
        if len(self._fit_plans) > 1:
            agg = memory_mod.aggregate_plans(self._fit_plans)
            rec.memory["aggregate"] = agg
        if self._memwatch is None:
            return
        self._memwatch.sample()
        live = self._memwatch.summary()
        rec.memory["live"] = live
        estimate = (agg["hbm_peak_bytes"] if agg is not None
                    else rec.memory.get("hbm_peak_bytes"))
        drift = memory_mod.drift_check(
            estimate, live.get("hbm_peak_delta_bytes"),
            live.get("source", "none"))
        if drift is not None and not any(
                e.get("kind") == "mem_estimate_drift" for e in rec.events):
            self.event(
                "mem_estimate_drift",
                "analytical memory ledger and live watermark diverge: "
                f"estimate {drift['estimate_bytes']} B vs live delta "
                f"{drift['live_delta_bytes']} B ({drift['direction']}, "
                f"ratio {drift['ratio']}; tolerance {drift['tolerance']}x)",
                **drift,
            )

    def report(self, *, tree=None, trees=None) -> dict:
        """Finalize into a plain JSON-able dict (the ``fit_report_``
        value). ``tree``: a fitted TreeArrays (fills ``result``);
        ``trees``: an ensemble's members (per-member summaries and the
        aggregate ``result``). Callable repeatedly."""
        rec = self.record
        if self._level_stream_file is not None:
            self._level_stream_file.close()
            self._level_stream_file = None
        rec.phases = self.summary() if self.enabled else {}
        if tree is not None:
            rec.result = {
                "n_nodes": int(tree.n_nodes),
                "depth": int(tree.max_depth),
            }
        if trees is not None:
            rec.trees = [
                {"n_nodes": int(t.n_nodes), "depth": int(t.max_depth)}
                for t in trees
            ]
            if rec.trees:
                rec.result = {
                    "n_trees": len(rec.trees),
                    "n_nodes": sum(t["n_nodes"] for t in rec.trees),
                    "depth": max(t["depth"] for t in rec.trees),
                }
        rec.collectives = self._collectives()
        rec.wire = wire_estimate(
            rec.collectives,
            rec.mesh.get("axes") or rec.mesh.get("n_devices"),
        )
        self._compute(rec)
        if self._fp_hash is not None:
            rec.fingerprints["fit"] = self._fp_hash.hexdigest()
        self._memory_live(rec)
        out = rec.to_dict()
        if self._trace is not None:
            build = [
                w for n, w in self._trace_windows.items()
                if n in trace_mod.BUILD_PHASES
            ]
            window = (
                [min(w[0] for w in build), max(w[1] for w in build)]
                if build else self._trace_window
            )
            trace_mod.synthesize_record_tracks(
                self._trace, f"obs{self._trace_seq}", self._trace_track,
                out, window=window,
            )
            if self._trace_owned and not self._trace_failed:
                try:
                    self._trace.write()
                except OSError as e:
                    self._trace_failed = True
                    self.event(
                        "trace_failed",
                        f"trace sink unwritable at report ({e}); trace "
                        "kept in memory only",
                        path=self._trace.path,
                    )
                    out = rec.to_dict()
        if not self._flight_logged and flight_mod.enabled():
            # once per fit: repeated report() calls refresh `out` but
            # append nothing; an unwritable store warns in flight.append
            self._flight_logged = True
            flight_mod.append_record(
                out, kind=self.flight_kind, digest=record_digest(out))
        return out
