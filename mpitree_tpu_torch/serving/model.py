"""CompiledModel: a fitted estimator flattened for the request path.

Counterpart of ``mpitree_tpu/serving/model.py``. ``compile_model(est)``
turns a fitted tree, forest or boosted ensemble
(``DecisionTreeClassifier``, ``DecisionTreeRegressor``,
``RandomForestClassifier``, ``RandomForestRegressor``,
``ExtraTreesClassifier``, ``ExtraTreesRegressor``,
``GradientBoostingClassifier``, ``GradientBoostingRegressor``) into a
serving handle:

- the depth-packed node table and its leaf-value channel are on the
  model's device from compile time (``serving/tables.py``), so a request
  uploads only its query batch;
- a batch pads to the smallest covering bucket (default 1/64/4096) and
  an oversize batch is served in chunks of the largest bucket;
- a forest (kind ``forest_proba``) is served by the traversal kernel K4
  on CUDA (``serve_kernel.traverse``, float64, equal bit for bit to the
  estimator's ``predict_proba``) in ``sum`` mode over a leaf channel
  normalized once when the model is compiled (``traversal.normalize_rows``,
  the same IEEE quotients ``norm`` mode takes per row and request), or
  with ``quantize="int8"`` by K5
  (``quantize.q_traverse_accumulate``); on the CPU by their plain
  versions. A regression forest (kind ``forest_mean``) is K4 in ``sum``
  mode over the trees' float64 leaf means, ``/ T``: the estimator's
  ``predict`` bit for bit. A classification forest with
  ``monotonic_cst`` (kind ``forest_values``) is K4 (or K5) in ``sum``
  mode over each tree's rows ``[p0, 1 - p0]`` of bound-clipped class-0
  fractions, ``/ T``: its ``predict_proba`` bit for bit (the JAX
  package's ``:665-696``). A boosted ensemble (kind ``margin``,
  ``:645-662``) is K4 in ``percls`` mode over its leaf values pre-scaled
  by the learning rate in host float64, tree ``t`` into class column ``t
  mod K``, each row's accumulator starting at the baseline margins: the
  estimator's ``decision_function`` (``predict`` for a regressor) bit for
  bit; ``quantize="int8"`` serves it by K5 in ``percls`` mode. A single
  classification tree (kind
  ``gather_counts``, int32 counts; with ``monotonic_cst``
  ``gather_value`` over its int32 clipped labels, ``:710-720``) or
  regression tree (``gather_value``, float64 leaf means, already clipped
  under constraints) is a plain gather on every device, as in the JAX
  package; a regression tree with ``quantize="int8"`` is the plain
  quantized gather (``quantize.q_traverse_gather``), as the JAX package's
  is XLA. The integer channels pass through unquantized.

The request path on CUDA is asynchronous, the counterpart of the JAX
package's async dispatch with donated buffers: a request's rows, padded
to the bucket, are written into a free pinned host slot of the model's
pool (:class:`PinnedSlots`), copied to the card on the model's own copy
stream, and the current stream waits on that copy's event before K4 or
K5 launches; each chunk's answer comes back into a pinned output slot of
the bucket's shape, with an event recorded behind the request's last
copy. ``raw_async`` returns without waiting, and ``finalize`` waits on
that request's event only and returns an owned numpy copy, so no pinned
slot escapes; a slot is handed out again only once its event has
completed, and the pool keeps at most ``SLOTS_PER_SHAPE`` free slots of
a shape. So a caller that keeps two batches in flight
(``staging.StreamStage``) can overlap one batch's copy with the other's
kernel, where the host keeps ahead of the card. On the CPU the copy is
the plain synchronous one. There is no fallback: a failed pin or copy on
the card raises.

Metrics (``obs.metrics``, the JAX package's families and labels):
per-bucket request latency histograms (``bucket="oversize"`` for a
chunked batch), request, row, clocked-row and deadline-miss counters,
the retry counter ``mpitree_serving_retries_total`` and the fallback
counter, which stays 0 (there is no fallback).
``serve_report_`` is a plain dict: kind, exactness, the dispatch, the
quantization report, buckets, requests and rows served, and the latency
summary. Fingerprints are not ported (``ROADMAP.md`` item 18).

Every traversal's launch runs through the retry rung of the resilience
ladder (``resilience.retry_device``; the JAX package's ``:286-326``)
behind the ``serving_dispatch`` chaos seam: a transient failure launches
it again, and each retry adds one to ``mpitree_serving_retries_total``.
The closure does not wait for the card (so that a staged caller keeps
two batches in flight), so the rung covers the failures raised on the
host at launch and the injected ones; an asynchronous CUDA fault of the
kernel surfaces at the answer's copy, outside the rung, and raises to
the caller, as a terminal failure does.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from mpitree_tpu_torch._device import resolve_device
from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.obs.metrics import MetricsRegistry
from mpitree_tpu_torch.resilience import chaos
from mpitree_tpu_torch.resilience.retry import retry_device
from mpitree_tpu_torch.serving import quantize as quantize_lib
from mpitree_tpu_torch.serving import serve_kernel, traversal
from mpitree_tpu_torch.serving.tables import table_notes, tables_for
from mpitree_tpu_torch.utils.monotonic import clipped_class0

DEFAULT_BUCKETS = (1, 64, 4096)
# free pinned slots kept per (shape, dtype): a few requests in flight
# from a stage or concurrent callers reuse them; past that, slots go back
# to PyTorch's pinned allocator
SLOTS_PER_SHAPE = 8


def _pad_rows(X: np.ndarray, b: int) -> np.ndarray:
    """Zero-pad ``X`` up to ``b`` rows (identity at the exact bucket)."""
    k = X.shape[0]
    if k == b:
        return X
    return np.concatenate([X, np.zeros((b - k, X.shape[1]), np.float32)])


class _RetrySink:
    """The retry rung's counter sink: its ``device_retries`` go to the
    model's ``mpitree_serving_retries_total``."""

    def __init__(self, counter):
        self._counter = counter

    def counter(self, name: str, n: int = 1) -> None:
        if name == "device_retries":
            self._counter.inc(n)


class _Slot:
    """One pinned host buffer, its numpy view and the CUDA event recorded
    after its last use on the card."""

    __slots__ = ("tensor", "array", "event")

    def __init__(self, shape: tuple, dtype: torch.dtype):
        self.tensor = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.array = self.tensor.numpy()
        self.event = torch.cuda.Event()


class PinnedSlots:
    """A lock-guarded pool of pinned host buffers, keyed by (shape,
    dtype): a bucket's input rows or a chunk's answer. :meth:`take` hands
    out a free slot whose event has completed (a new one when none has);
    :meth:`give` returns a slot, whose event then guards its reuse, and
    drops it when ``cap`` free slots of its key are kept already (PyTorch's
    pinned allocator reuses a dropped buffer only once the copies recorded
    on it are done). ``allocated`` counts the slots made."""

    def __init__(self, cap: int):
        self._lock = threading.Lock()
        self._free: dict = {}
        self.cap = int(cap)
        self.allocated = 0

    def take(self, shape: tuple, dtype: torch.dtype) -> _Slot:
        with self._lock:
            free = self._free.get((shape, dtype), [])
            for i, slot in enumerate(free):
                if slot.event.query():
                    return free.pop(i)
            self.allocated += 1
        return _Slot(shape, dtype)

    def give(self, slot: _Slot) -> None:
        key = (tuple(slot.tensor.shape), slot.tensor.dtype)
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.cap:
                free.append(slot)

    @property
    def kept(self) -> int:
        """Free slots the pool holds."""
        with self._lock:
            return sum(len(v) for v in self._free.values())


def _channel(trees, per_tree, table, dtype) -> np.ndarray:
    """Concatenate a per-tree leaf channel and depth-pack it."""
    flat = np.concatenate(
        [np.asarray(per_tree(t)).reshape(t.n_nodes, -1) for t in trees],
        axis=0,
    )
    return np.ascontiguousarray(flat[table.scatter_order()], dtype=dtype)


class CompiledModel:
    """One published model: flat table on the device + buckets."""

    def __init__(self, trees, *, kind, n_features, n_out, values_fn,
                 device, classes=None, scale=1.0, buckets=DEFAULT_BUCKETS,
                 value_dtype=np.float64, quantize=None, quantize_tol=None,
                 calibration=None, channel_salt="", loss=None,
                 baseline=None):
        self.trees = list(trees)
        self.kind = kind
        self.n_features = int(n_features)
        self.n_out = int(n_out)
        self.classes = classes
        self.device = device
        self.buckets = tuple(sorted(int(b) for b in buckets))
        # request-path metrics, private per model so slot swaps never mix
        # distributions; an oversize batch's wall is a chunk loop's total
        self.metrics = MetricsRegistry()
        self._lat = {
            b: self.metrics.histogram(
                "mpitree_serving_request_seconds", bucket=str(b))
            for b in self.buckets
        }
        self._lat_over = self.metrics.histogram(
            "mpitree_serving_request_seconds", bucket="oversize")
        self._m_requests = self.metrics.counter(
            "mpitree_serving_requests_total")
        self._m_rows = self.metrics.counter("mpitree_serving_rows_total")
        # rows that went through raw()'s clock: the sustained rate's
        # numerator (warm-up and raw_async rows are counted, not timed)
        self._m_lat_rows = self.metrics.counter(
            "mpitree_serving_latency_rows_total")
        self._m_deadline = self.metrics.counter(
            "mpitree_serving_deadline_misses_total")
        # the JAX package's retry and fallback families: the retry rung
        # counts here (_RetrySink); there is no fallback, so 0
        self._retries = _RetrySink(
            self.metrics.counter("mpitree_serving_retries_total"))
        self.metrics.counter("mpitree_serving_fallbacks_total")
        if device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(device)
            self._slots = PinnedSlots(SLOTS_PER_SHAPE)
        self.scale = torch.tensor(float(scale), dtype=torch.float64,
                                  device=device)
        # a boosted model's loss (class probabilities) and baseline row
        self._loss = loss
        self._baseline = (None if baseline is None else torch.from_numpy(
            np.ascontiguousarray(baseline, np.float64).reshape(-1)).to(
                device))
        int_channel = np.dtype(value_dtype).kind in "iu"
        qmode = quantize_lib.resolve_quantize(
            knobs.value("MPITREE_TPU_SERVING_QUANTIZE") if quantize is None
            else quantize)
        # An integer channel (single-tree counts) is exact and minimal
        # already: an int8 affine could only add error.
        if int_channel:
            qmode = None
        self.quantize = qmode
        self.exact = qmode is None
        # The table cache lives on the caller's container (a forest's
        # TreeList), so predict and serving share one table.
        [self.table] = tables_for(trees, group_bytes=None)
        self._dev_table = self.table.dev_arrays(device)[:5]
        self._quant = None
        self._values = None
        self._record = None
        self._agg = traversal.ACC_AGG.get(kind)
        if qmode is not None:
            flat = _channel(self.trees, values_fn, self.table, np.float64)
            self._quant = quantize_lib.build_state(
                self.table, quantize_lib.prepare_channel(kind, flat),
                kind=kind, scale=scale, n_steps=self.table.n_steps,
                tol=float(
                    knobs.value("MPITREE_TPU_SERVING_QUANTIZE_TOL")
                    if quantize_tol is None else quantize_tol),
                device=device, calibration=calibration,
                n_features=self.n_features,
                n_out=self.n_out if kind == "margin" else None,
            )
        else:
            # norm's per-tree row division, taken once per leaf here: the
            # kernel then only adds (sum mode), to the same bits.
            normalize = self._agg == "norm"
            # the salt keys channels the tree arrays alone do not fix
            self._values = self.table.dev_values(
                f"serve:{kind}:normalized" if normalize
                else f"serve:{kind}{channel_salt}",
                lambda tb: _channel(self.trees, values_fn, tb, value_dtype),
                dtype=value_dtype, device=device,
                prepare=traversal.normalize_rows if normalize else None,
            )
            if normalize:
                self._agg = "sum"
            if device.type == "cuda" and self._agg is not None:
                self._record = self.table.dev_record(device)
        kernel = "traverse_q" if qmode else "traverse"
        if kind in traversal.GATHER_KINDS:
            self.dispatch = "plain gather"
        elif device.type == "cuda":
            self.dispatch = f"kernel {kernel}"
        else:
            self.dispatch = f"plain version of {kernel}"

    def note_deadline_miss(self, n: int = 1) -> None:
        """Count requests answered past their deadline (the scheduler
        reports them here)."""
        self._m_deadline.inc(n)

    # -- dispatch ----------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _serve(self, X: torch.Tensor) -> torch.Tensor:
        """:meth:`_compute`'s launch through the retry rung, behind the
        ``serving_dispatch`` seam (module docstring: the launch does not
        wait for the card, so a fault of the kernel raises later, at the
        copy)."""
        def dev():
            chaos.step("serving_dispatch")
            return self._compute(X)

        return retry_device(dev, what="serving traversal dispatch",
                            obs=self._retries)

    def _compute(self, X: torch.Tensor) -> torch.Tensor:
        """One bucket-shaped batch on the model's device -> its answer
        there, on the current stream."""
        n_steps = self.table.n_steps
        if self.kind in traversal.GATHER_KINDS:
            if self._quant is not None:
                q = self._quant  # one tree: qbase is the affine's base
                return quantize_lib.q_traverse_gather(
                    X, q.feature, q.threshold, q.left, q.right, q.root,
                    q.qvals, q.qscale, q.qbase, n_steps=n_steps,
                )
            return traversal.traverse_gather(
                X, *self._dev_table, self._values, kind=self.kind,
                n_steps=n_steps,
            )
        if self._quant is not None:
            return quantize_lib.q_traverse_accumulate(
                X, self._quant, kind=self.kind, n_steps=n_steps,
                n_features=self.n_features, scale=self.scale,
                baseline=self._baseline,
            )
        out = serve_kernel.traverse(
            X, *self._dev_table, self._values, n_steps=n_steps,
            agg=self._agg, n_out=self.n_out, n_features=self.n_features,
            record=self._record, baseline=self._baseline,
        )
        return traversal.finish(out, self.kind, self.scale)

    def _dispatch_cpu(self, X: np.ndarray, b: int) -> list:
        """The request in chunks of at most ``b`` rows, each zero-padded
        to ``b``, on the CPU: [(answer tensor, rows)]."""
        n = X.shape[0]
        return [(self._serve(torch.from_numpy(_pad_rows(X[lo:lo + b], b))),
                 min(b, n - lo)) for lo in range(0, max(n, 1), b)]

    def _dispatch_cuda(self, X: np.ndarray, b: int) -> list:
        """The request on the card, without waiting: each chunk of at most
        ``b`` rows staged through a pinned input slot and the copy stream,
        its answer copied into a pinned output slot of the bucket's shape;
        the event of the last output slot is recorded behind the last
        copy. Returns [(output slot, rows)]."""
        n = X.shape[0]
        compute = torch.cuda.current_stream(self.device)
        outs = []
        for lo in range(0, max(n, 1), b):
            k = min(b, n - lo)
            src = self._slots.take((b, self.n_features), torch.float32)
            src.array[:k] = X[lo:lo + k]
            src.array[k:] = 0
            with torch.cuda.stream(self._copy_stream):
                # allocated on the copy stream, read on the compute stream:
                # record_stream keeps its memory until that read is done
                Xd = torch.empty((b, self.n_features), dtype=torch.float32,
                                 device=self.device)
                Xd.copy_(src.tensor, non_blocking=True)
                src.event.record(self._copy_stream)
            # wait before the slot can be handed out (and re-recorded)
            compute.wait_event(src.event)
            self._slots.give(src)
            Xd.record_stream(compute)
            out = self._serve(Xd)
            dst = self._slots.take(tuple(out.shape), out.dtype)
            dst.tensor[:k].copy_(out[:k], non_blocking=True)
            outs.append((dst, k))
        outs[-1][0].event.record(compute)
        return outs

    def raw_async(self, X) -> tuple:
        """Dispatch without waiting: (result, true row count). A batch
        pads to its bucket; past the largest bucket it is served in chunks
        of the largest, the tail padded. The result is the list of (chunk
        answer, rows): on the card each answer is the pinned slot it is on
        its way to, on the CPU a tensor; :meth:`finalize` takes either."""
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"expected (n, {self.n_features}) query batch, got "
                f"{X.shape}"
            )
        n = X.shape[0]
        self._m_requests.inc()
        self._m_rows.inc(n)
        b = self._bucket(n)
        if self.device.type == "cuda":
            return self._dispatch_cuda(X, b), n
        return self._dispatch_cpu(X, b), n

    def finalize(self, out, n: int) -> np.ndarray:
        """A ``raw_async`` result as the estimator-shaped host array (a
        regression forest's (N, 1) accumulator as its (N,) column). On the
        card it waits on this request's event only; the array is an owned
        copy, and the pinned slots go back to the pool."""
        if isinstance(out[0][0], _Slot):
            out[-1][0].event.synchronize()
            host = np.concatenate([s.array[:k] for s, k in out], axis=0)
            for s, _ in out:
                self._slots.give(s)
        else:
            host = np.concatenate([o[:k].numpy() for o, k in out], axis=0)
        return host[:, 0] if self.kind == "forest_mean" else host

    def raw(self, X) -> np.ndarray:
        """Probabilities for a classification forest, raw leaf counts for
        a single classification tree, values for a regressor, (N, K)
        margins for a boosted ensemble, as a host array. The request's
        wall clock lands in its bucket's latency histogram."""
        t0 = time.perf_counter()
        out, n = self.raw_async(X)
        host = self.finalize(out, n)
        dt = time.perf_counter() - t0
        b = self._bucket(n)
        (self._lat[b] if n <= b else self._lat_over).observe(dt)
        self._m_lat_rows.inc(n)
        return host

    def warmup(self, buckets=None) -> None:
        """Run every bucket shape once off the request path and off the
        latency clock: uploads what is not on the device yet and, on
        CUDA, builds and loads the kernel and pins the bucket's slots."""
        for b in buckets or self.buckets:
            self.finalize(*self.raw_async(
                np.zeros((int(b), self.n_features), np.float32)))

    # -- estimator-equivalent surface -------------------------------------
    def predict(self, X):
        out = self.raw(X)
        if self.kind == "margin":
            if self.classes is None:
                return out[:, 0]
            return self.classes[
                self._loss.proba(out.astype(np.float64)).argmax(axis=1)]
        if self.classes is None:  # regressors: the values themselves
            return out
        if self.kind == "gather_value":  # a constrained tree's labels
            return self.classes[out.astype(np.int64)]
        return self.classes[out.argmax(axis=1)]

    def predict_proba(self, X):
        if self.kind == "gather_value" and self.classes is not None:
            raise AttributeError(
                "predict_proba is undefined for a constrained tree's "
                "serving kind 'gather_value' (its labels)")
        if self.kind == "margin":
            if self.classes is None:
                raise AttributeError(
                    "predict_proba is undefined for a boosted regressor")
            return self._loss.proba(self.raw(X).astype(np.float64))
        out = self.raw(X)
        if self.kind == "gather_counts":
            return out.astype(np.int64)  # the reference quirk: raw counts
        return out

    def decision_function(self, X):
        """A boosted classifier's margins, shaped as its
        ``decision_function``: (N,) for two classes, else (N, K)."""
        if self.kind != "margin" or self.classes is None:
            raise AttributeError(
                "decision_function is a boosting-classifier surface")
        raw = self.raw(X)
        return raw[:, 0] if raw.shape[1] == 1 else raw

    def latency_summary(self) -> dict:
        """Per-bucket p50/p95/p99 and mean (ms, histogram estimates) of the
        requests ``raw`` clocked, and the sustained rows/s over their wall.
        ``oversize`` collects chunked batches (a loop's total); ``rows``
        counts every row served, the rate only the clocked ones."""
        out: dict = {"buckets": {}}
        total_s, total_n = 0.0, 0
        hists = [(str(b), self._lat[b]) for b in self.buckets]
        hists.append(("oversize", self._lat_over))
        for label, h in hists:
            if h.count == 0:
                continue
            out["buckets"][label] = {
                "count": h.count,
                "p50_ms": round(h.quantile(0.5) * 1e3, 4),
                "p95_ms": round(h.quantile(0.95) * 1e3, 4),
                "p99_ms": round(h.quantile(0.99) * 1e3, 4),
                "mean_ms": round(h.sum / h.count * 1e3, 4),
            }
            total_s += h.sum
            total_n += h.count
        rows = int(self._m_rows.value)
        clocked = int(self._m_lat_rows.value)
        out["requests"] = total_n
        out["rows"] = rows
        out["rows_latency_clocked"] = clocked
        out["rows_per_s_sustained"] = (
            round(clocked / total_s, 1) if total_s > 0 else None)
        return out

    def metrics_text(self, extra_labels: dict | None = None) -> str:
        """Prometheus text exposition of this model's registry."""
        return self.metrics.metrics_text(extra_labels)

    def metrics_families(self, extra_labels: dict | None = None) -> dict:
        """``render_families`` of this model's registry: what
        ``ModelRegistry`` merges under one ``# TYPE`` line per family."""
        return self.metrics.render_families(extra_labels)

    @property
    def serve_report_(self) -> dict:
        return {
            "kind": self.kind,
            "exact": bool(self.exact),
            "device": str(self.device),
            "dispatch": self.dispatch,
            "quantization": (dict(self._quant.report)
                             if self._quant is not None else {"mode": "off"}),
            "buckets": self.buckets,
            "requests": int(self._m_requests.value),
            "rows": int(self._m_rows.value),
            "latency": self.latency_summary(),
            **table_notes(self.trees),
        }


def compile_model(estimator, *, buckets=DEFAULT_BUCKETS, quantize=None,
                  quantize_tol=None, calibration=None) -> CompiledModel:
    """Flatten a fitted estimator into a :class:`CompiledModel` on the
    estimator's ``device`` (``None`` = ``"cuda"``, raising without CUDA;
    ``"cpu"`` serves by the plain versions). ``quantize="int8"`` (None:
    the ``MPITREE_TPU_SERVING_QUANTIZE`` knob) serves compressed tables,
    refusing past ``quantize_tol`` (None: the
    ``MPITREE_TPU_SERVING_QUANTIZE_TOL`` knob, 1e-2) on the
    ``calibration`` batch (synthesized from the table's thresholds when
    omitted). A fitted estimator from ``load_model`` compiles as a fitted
    one does."""
    from mpitree_tpu_torch.boosting.gradient_boosting import (
        _BaseGradientBoosting,
    )
    from mpitree_tpu_torch.models.classifier import DecisionTreeClassifier
    from mpitree_tpu_torch.models.forest import (
        RandomForestClassifier,
        RandomForestRegressor,
    )
    from mpitree_tpu_torch.models.regressor import DecisionTreeRegressor

    if not isinstance(estimator, (
            RandomForestClassifier, RandomForestRegressor,
            DecisionTreeClassifier, DecisionTreeRegressor,
            _BaseGradientBoosting)):
        raise TypeError(
            f"compile_model: unsupported estimator {type(estimator).__name__}"
        )
    estimator._check_fitted()
    kw = dict(buckets=buckets, quantize=quantize, quantize_tol=quantize_tol,
              calibration=calibration,
              device=resolve_device(estimator.device))
    if isinstance(estimator, _BaseGradientBoosting):
        classes = getattr(estimator, "classes_", None)
        lr = float(estimator.learning_rate)
        # leaf values pre-scaled by the learning rate in host float64, the
        # estimator's own product, so each round is one add
        return CompiledModel(
            estimator.trees_, kind="margin",
            n_features=estimator.n_features_in_,
            n_out=int(estimator.n_trees_per_iteration_),
            values_fn=lambda t: lr * np.asarray(t.count[:, 0], np.float64),
            channel_salt=f":lr={lr!r}", classes=classes,
            loss=estimator._loss() if classes is not None else None,
            baseline=np.asarray(estimator._baseline_raw, np.float64), **kw,
        )
    if isinstance(estimator, RandomForestRegressor):  # and ExtraTrees
        return CompiledModel(
            estimator.trees_, kind="forest_mean",
            n_features=estimator.n_features_, n_out=1,
            values_fn=lambda t: np.asarray(t.count[:, 0], np.float64),
            scale=float(len(estimator.trees_)), **kw,
        )
    if isinstance(estimator, DecisionTreeRegressor):
        return CompiledModel(
            [estimator.tree_], kind="gather_value",
            n_features=estimator.n_features_, n_out=1,
            values_fn=lambda t: np.asarray(t.count[:, 0], np.float64), **kw,
        )
    if isinstance(estimator, RandomForestClassifier):  # and ExtraTrees
        cst = estimator.mono_signs()
        if cst is not None:
            # each tree's clipped fractions, final per node, ride the
            # pure-add kind; salted: the clip depends on the signs
            def rows(t):
                p0 = clipped_class0(t, cst).astype(np.float64)
                return np.stack([p0, 1.0 - p0], axis=1)

            return CompiledModel(
                estimator.trees_, kind="forest_values",
                n_features=estimator.n_features_,
                n_out=len(estimator.classes_), values_fn=rows,
                channel_salt=f":cst={np.asarray(cst).tolist()!r}",
                classes=estimator.classes_,
                scale=float(len(estimator.trees_)), **kw,
            )
        return CompiledModel(
            estimator.trees_, kind="forest_proba",
            n_features=estimator.n_features_,
            n_out=len(estimator.classes_),
            values_fn=lambda t: np.asarray(t.count, np.float64),
            classes=estimator.classes_, scale=float(len(estimator.trees_)),
            **kw,
        )
    if estimator.monotonic_cst is not None:
        # the bound-clipped labels predict reads
        return CompiledModel(
            [estimator.tree_], kind="gather_value",
            n_features=estimator.n_features_, n_out=1,
            values_fn=lambda t: np.asarray(t.value, np.int32),
            classes=estimator.classes_, value_dtype=np.int32, **kw,
        )
    counts = np.asarray(estimator.tree_.count)
    if counts.max(initial=0) >= 2**31:
        raise OverflowError("leaf counts exceed int32 on the serving table")
    return CompiledModel(
        [estimator.tree_], kind="gather_counts",
        n_features=estimator.n_features_, n_out=len(estimator.classes_),
        values_fn=lambda t: np.asarray(t.count, np.int32),
        classes=estimator.classes_, value_dtype=np.int32, **kw,
    )
