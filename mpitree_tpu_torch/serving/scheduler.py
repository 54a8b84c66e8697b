"""EDF continuous-batching scheduler with admission control.

Counterpart of ``mpitree_tpu/serving/scheduler.py``: a scheduler that owns
a deadline heap of in-flight requests per model, coalesces them into the
compiled models' existing bucket shapes, and refuses work it cannot serve
instead of letting a burst miss every deadline at once.

**EDF with a bounded window.** Requests are earliest-deadline-first per
model (a FIFO sequence number breaks deadline ties); a non-full batch is
held open at most ``wait_ms`` past its head's arrival, and always closed
``margin_ms`` before the head's deadline. Coalesced batches go through
``CompiledModel.raw`` unchanged, so on the card they reach the traversal
kernels (K4, or K5 for int8 tables) through the model's pinned, overlapped
request path.

**QoS classes.** Each request names a class (``interactive``/``batch`` by
default — the ``MPITREE_TPU_SERVING_QOS`` grammar
``name:deadline_ms:queue_depth;...``): the class carries the default
deadline and a per-(model, class) queue bound, so a flooded class sheds
against its own bound before it can starve another class's admissions.

**Admission control.** ``submit`` refuses (typed :class:`RejectedRequest`,
``reason`` in :data:`REJECT_REASONS`) rather than queueing work it cannot
serve: past the global ``shed_depth`` or the class's queue bound
(``queue_full``), or when the deadline is already infeasible — inside the
close margin, or, with work queued ahead, sooner than the model's
observed EWMA service time (``deadline_infeasible``). A dispatch that
raises requeues its requests once, then fails their futures. Deadline
misses are counted here and reported to the model.

**Metrics.** Queue depths, shed counts by reason, misses, dispatches,
requeues and per-class latency live in ``obs.metrics``; ``metrics_text()``
merges them with the registry's per-model families under one ``# TYPE``
line each.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from concurrent.futures import Future

from concurrent.futures import InvalidStateError

import numpy as np

from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.obs.metrics import MetricsRegistry, render_text

REJECT_REASONS = (
    "queue_full", "deadline_infeasible", "unknown_model",
    "unknown_class", "shutdown",
)

# EWMA weight for the per-model service-time estimate the feasibility
# gate reads (newest dispatch counts ~1/4 — reactive, but one slow cold
# outlier can't condemn every later admission).
_EWMA_ALPHA = 0.25


def _resolve(future: Future, value, *, is_error: bool = False) -> bool:
    """Resolve a request future, tolerating the close/requeue races
    where two paths reach the same future (close() failing the backlog
    while a racing dispatch serves it): first resolution wins, the
    second is a no-op."""
    try:
        if not future.set_running_or_notify_cancel():
            return False
        if is_error:
            future.set_exception(value)
        else:
            future.set_result(value)
        return True
    except InvalidStateError:
        return False


class RejectedRequest(RuntimeError):
    """Typed admission refusal; ``reason`` is one of REJECT_REASONS."""

    def __init__(self, message: str, *, reason: str):
        super().__init__(message)
        assert reason in REJECT_REASONS
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """One scheduling class: its default deadline + per-(model, class)
    admission bound."""

    name: str
    deadline_ms: float
    queue_depth: int


def parse_qos(spec: str) -> tuple[QoSClass, ...]:
    """``name:deadline_ms:queue_depth;...`` -> classes (first = default).

    The grammar is the ``MPITREE_TPU_SERVING_QOS`` knob's; parse errors
    are loud — a typo'd QoS spec silently admitting everything at one
    depth is exactly the overload it exists to prevent."""
    classes = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            name, deadline_ms, depth = part.split(":")
            cls = QoSClass(name.strip(), float(deadline_ms), int(depth))
        except ValueError:
            raise ValueError(
                f"bad QoS class {part!r} (grammar: "
                "`name:deadline_ms:queue_depth;...`)"
            ) from None
        if cls.deadline_ms <= 0 or cls.queue_depth <= 0:
            raise ValueError(
                f"QoS class {cls.name!r} needs positive deadline_ms and "
                f"queue_depth (got {part!r})"
            )
        classes.append(cls)
    if not classes:
        raise ValueError("empty QoS spec")
    return tuple(classes)


@dataclasses.dataclass
class _Request:
    """One queued row. Orderable by (deadline, seq) via the heap tuple —
    this body just carries the payload."""

    row: np.ndarray
    qos: str
    deadline: float     # absolute perf_counter() seconds
    arrival: float
    future: Future
    retried: bool = False


class Scheduler:
    """EDF continuous-batching front of a :class:`ModelRegistry`."""

    def __init__(self, registry, *, qos=None, shed_depth=None,
                 margin_ms=None, wait_ms=None):
        self.registry = registry
        spec = qos if qos is not None else knobs.value(
            "MPITREE_TPU_SERVING_QOS"
        )
        self.qos = (spec if isinstance(spec, tuple) else parse_qos(spec))
        self._qos_by_name = {c.name: c for c in self.qos}
        self.default_qos = self.qos[0].name
        self.shed_depth = int(
            shed_depth if shed_depth is not None
            else knobs.value("MPITREE_TPU_SERVING_SHED_DEPTH")
        )
        self.margin_s = float(
            margin_ms if margin_ms is not None
            else knobs.value("MPITREE_TPU_SERVING_MARGIN_MS")
        ) / 1e3
        self.wait_s = float(
            wait_ms if wait_ms is not None
            else knobs.value("MPITREE_TPU_SERVING_WAIT_MS")
        ) / 1e3
        self.metrics = MetricsRegistry()
        self._lock = threading.Condition()
        # Per-model EDF heaps of (deadline, seq, _Request); seq breaks
        # deadline ties FIFO and keeps the heap total-ordered without
        # comparing request bodies.
        self._heaps: dict[str, list] = {}
        self._depth: dict[tuple[str, str], int] = {}
        self._total = 0
        self._seq = itertools.count()
        # Per-model EWMA of observed per-dispatch service seconds — the
        # feasibility gate's estimate (None until the first dispatch:
        # admission never guesses before it has evidence).
        self._service_s: dict[str, float] = {}
        self._closed = False
        self._m_shed = {
            r: self.metrics.counter("mpitree_sched_shed_total", reason=r)
            for r in REJECT_REASONS
        }
        self._m_miss = self.metrics.counter(
            "mpitree_sched_deadline_misses_total"
        )
        self._m_dispatch = self.metrics.counter(
            "mpitree_sched_dispatches_total"
        )
        self._m_requeue = self.metrics.counter(
            "mpitree_sched_requeues_total"
        )
        self._m_lat = {
            c.name: self.metrics.histogram(
                "mpitree_sched_class_latency_seconds", qos=c.name
            )
            for c in self.qos
        }
        self._worker = threading.Thread(
            target=self._run, name="mpitree-sched", daemon=True
        )
        self._worker.start()

    # -- admission ---------------------------------------------------------
    def _shed(self, reason: str, message: str):
        self._m_shed[reason].inc()
        return RejectedRequest(message, reason=reason)

    def submit(self, model: str, row, *, qos: str | None = None,
               deadline_ms: float | None = None) -> Future:
        """Admit one request row, or raise a typed
        :class:`RejectedRequest`. The future resolves to the model's
        ``raw`` output row for this request."""
        qos = qos if qos is not None else self.default_qos
        cls = self._qos_by_name.get(qos)
        if cls is None:
            raise self._shed(
                "unknown_class",
                f"unknown QoS class {qos!r} (have "
                f"{sorted(self._qos_by_name)})",
            )
        try:
            compiled = self.registry.get(model)
        except KeyError as e:
            raise self._shed("unknown_model", str(e)) from None
        row = np.ascontiguousarray(np.asarray(row, np.float32)).reshape(-1)
        if row.shape[0] != compiled.n_features:
            raise ValueError(
                f"expected {compiled.n_features} features, got "
                f"{row.shape[0]}"
            )
        now = time.perf_counter()
        budget_s = (deadline_ms if deadline_ms is not None
                    else cls.deadline_ms) / 1e3
        deadline = now + budget_s
        with self._lock:
            if self._closed:
                raise self._shed("shutdown", "scheduler is closed")
            if self._total >= self.shed_depth:
                raise self._shed(
                    "queue_full",
                    f"scheduler at shed_depth {self.shed_depth} "
                    f"in-flight requests",
                )
            depth_key = (model, qos)
            if self._depth.get(depth_key, 0) >= cls.queue_depth:
                raise self._shed(
                    "queue_full",
                    f"class {qos!r} at queue_depth {cls.queue_depth} "
                    f"for model {model!r}",
                )
            # Feasibility: refuse a deadline the window margin already
            # eats, or — when work is already queued ahead — one sooner
            # than the model's observed service time. No estimate yet ->
            # admit (never guess). The depth>0 condition is what lets
            # the estimate RECOVER: one slow burst (a stall, a cold
            # kernel build) inflates the EWMA, and if it also gated an
            # idle scheduler nothing would ever dispatch to pull it back
            # down — an accepted request on an idle queue dispatches
            # immediately, so the worst case is one recorded deadline
            # miss, not a permanent lockout.
            est = self._service_s.get(model)
            if budget_s <= self.margin_s or (
                est is not None and budget_s < est and self._total > 0
            ):
                raise self._shed(
                    "deadline_infeasible",
                    f"deadline {budget_s * 1e3:.1f}ms is inside the "
                    f"{self.margin_s * 1e3:.1f}ms close margin"
                    if budget_s <= self.margin_s else
                    f"deadline {budget_s * 1e3:.1f}ms < observed "
                    f"service time {est * 1e3:.1f}ms for {model!r}",
                )
            req = _Request(row=row, qos=qos, deadline=deadline,
                           arrival=now, future=Future())
            heapq.heappush(
                self._heaps.setdefault(model, []),
                (deadline, next(self._seq), req),
            )
            self._depth[depth_key] = self._depth.get(depth_key, 0) + 1
            self._total += 1
            self._gauge_depth(model, qos)
            self._lock.notify_all()
        return req.future

    def _gauge_depth(self, model: str, qos: str) -> None:
        self.metrics.gauge(
            "mpitree_sched_queue_depth", model=model, qos=qos
        ).set(self._depth.get((model, qos), 0))

    # -- the worker --------------------------------------------------------
    def _head(self):
        """(model, head_deadline) of the earliest head-of-line request
        across models, or (None, None). Caller holds the lock."""
        best, best_dl = None, None
        for model, heap in self._heaps.items():
            if heap and (best_dl is None or heap[0][0] < best_dl):
                best, best_dl = model, heap[0][0]
        return best, best_dl

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._closed and self._head()[0] is None:
                    self._lock.wait()
                if self._closed and self._head()[0] is None:
                    return
                model, head_dl = self._head()
                heap = self._heaps[model]
                head = heap[0][2]
                cap = self.registry.get(model).buckets[-1]
                # The window rule: hold a non-full batch open at most
                # wait_s past the head's arrival, but ALWAYS close
                # margin_s before its deadline.
                window_end = min(
                    head.arrival + self.wait_s, head_dl - self.margin_s
                )
                changed = False
                while (not self._closed and len(heap) < cap
                       and time.perf_counter() < window_end):
                    self._lock.wait(
                        max(window_end - time.perf_counter(), 0.0)
                    )
                    # A tighter deadline may have arrived at the head of
                    # any heap; restart selection (and the window rule)
                    # rather than serving a stale pick.
                    if self._head() != (model, head_dl):
                        changed = True
                        break
                if changed:
                    continue
                batch = [
                    heapq.heappop(heap)[2]
                    for _ in range(min(len(heap), cap))
                ]
                if not batch:
                    continue
                for r in batch:
                    self._depth[(model, r.qos)] -= 1
                self._total -= len(batch)
                for q in {r.qos for r in batch}:
                    self._gauge_depth(model, q)
            self._dispatch(model, batch)

    def _dispatch(self, model: str, batch: list) -> None:
        """Serve one coalesced batch; resolve/requeue/fail its futures.

        Runs OUTSIDE the lock — admissions and other submissions proceed
        while the model dispatches (the registry's concurrency
        contract)."""
        compiled = self.registry.get(model)
        t0 = time.perf_counter()
        try:
            # the sched_dispatch chaos seam comes with ROADMAP.md item 17
            out = compiled.raw(np.stack([r.row for r in batch]))
        except Exception as e:
            fresh = [r for r in batch if not r.retried]
            stale = [r for r in batch if r.retried]
            for r in stale:
                _resolve(r.future, e, is_error=True)
            if fresh:
                self._m_requeue.inc(len(fresh))
                with self._lock:
                    for r in fresh:
                        r.retried = True
                        heapq.heappush(
                            self._heaps.setdefault(model, []),
                            (r.deadline, next(self._seq), r),
                        )
                        key = (model, r.qos)
                        self._depth[key] = self._depth.get(key, 0) + 1
                        self._total += 1
                    self._lock.notify_all()
            return
        done = time.perf_counter()
        self._m_dispatch.inc()
        # EWMA service estimate for the feasibility gate. The read-
        # modify-write must hold the lock: the admission path reads
        # _service_s concurrently, and two racing dispatch threads would
        # otherwise drop one sample's worth of smoothing.
        with self._lock:
            prev = self._service_s.get(model)
            self._service_s[model] = (
                done - t0 if prev is None
                else (1 - _EWMA_ALPHA) * prev + _EWMA_ALPHA * (done - t0)
            )
        misses = 0
        for i, r in enumerate(batch):
            if not _resolve(r.future, out[i]):
                continue
            self._m_lat[r.qos].observe(done - r.arrival)
            if done > r.deadline:
                misses += 1
        if misses:
            self._m_miss.inc(misses)
            compiled.note_deadline_miss(misses)

    # -- lifecycle / observability ----------------------------------------
    def queue_depth(self, model: str | None = None) -> int:
        with self._lock:
            if model is None:
                return self._total
            return sum(len(h) for m, h in self._heaps.items()
                       if m == model)

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every queued request resolved (True) or timeout."""
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            with self._lock:
                if self._total == 0:
                    return True
            time.sleep(0.002)
        return False

    def close(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admitting; optionally drain the backlog first. Queued
        requests after a drainless close fail with reason ``shutdown``."""
        if drain:
            self.drain(timeout)
        with self._lock:
            self._closed = True
            pending = [
                r for heap in self._heaps.values() for _, _, r in heap
            ]
            self._heaps.clear()
            self._depth = {k: 0 for k in self._depth}
            self._total = 0
            self._lock.notify_all()
        for r in pending:
            _resolve(
                r.future, self._shed("shutdown", "scheduler closed"),
                is_error=True,
            )
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stats(self) -> dict:
        """Host-side snapshot for reports/benches (no scrape needed)."""
        with self._lock:
            depth = {f"{m}/{q}": d for (m, q), d in self._depth.items()
                     if d}
        return {
            "queued": self.queue_depth(),
            "queue_depth": depth,
            "dispatches": int(self._m_dispatch.value),
            "requeues": int(self._m_requeue.value),
            "deadline_misses": int(self._m_miss.value),
            "shed": {r: int(c.value) for r, c in self._m_shed.items()
                     if c.value},
            "class_latency_ms": {
                name: {
                    "count": h.count,
                    "p50": round((h.quantile(0.5) or 0) * 1e3, 3),
                    "p99": round((h.quantile(0.99) or 0) * 1e3, 3),
                }
                for name, h in self._m_lat.items() if h.count
            },
        }

    def metrics_text(self) -> str:
        """One Prometheus exposition: scheduler families merged with the
        registry's per-model families under single ``# TYPE`` lines."""
        return render_text(
            [self.metrics.render_families()]
            + self.registry.metrics_families()
        )
