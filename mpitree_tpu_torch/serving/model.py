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
  package.

``serve_report_`` is a plain dict: kind, exactness, the dispatch, the
quantization report, buckets, and requests and rows served. Metrics,
the retry rung, chaos seams and fingerprints are not ported
(``ROADMAP.md`` Queue 1 items 17-18).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from mpitree_tpu_torch._device import resolve_device
from mpitree_tpu_torch.serving import quantize as quantize_lib
from mpitree_tpu_torch.serving import serve_kernel, traversal
from mpitree_tpu_torch.serving.tables import table_notes, tables_for
from mpitree_tpu_torch.utils.monotonic import clipped_class0

DEFAULT_BUCKETS = (1, 64, 4096)


def _pad_rows(X: np.ndarray, b: int) -> np.ndarray:
    """Zero-pad ``X`` up to ``b`` rows (identity at the exact bucket)."""
    k = X.shape[0]
    if k == b:
        return X
    return np.concatenate([X, np.zeros((b - k, X.shape[1]), np.float32)])


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
        self._lock = threading.Lock()
        self.trees = list(trees)
        self.kind = kind
        self.n_features = int(n_features)
        self.n_out = int(n_out)
        self.classes = classes
        self.device = device
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.scale = torch.tensor(float(scale), dtype=torch.float64,
                                  device=device)
        # a boosted model's loss (class probabilities) and baseline row
        self._loss = loss
        self._baseline = (None if baseline is None else torch.from_numpy(
            np.ascontiguousarray(baseline, np.float64).reshape(-1)).to(
                device))
        self._counts = {"requests": 0, "rows": 0}
        int_channel = np.dtype(value_dtype).kind in "iu"
        qmode = quantize_lib.resolve_quantize(quantize)
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
                tol=(quantize_lib.DEFAULT_TOLERANCE if quantize_tol is None
                     else float(quantize_tol)),
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

    # -- dispatch ----------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _dispatch(self, Xp: np.ndarray) -> torch.Tensor:
        """One bucket-shaped dispatch; the result stays on the device."""
        X = torch.from_numpy(Xp).to(self.device)
        n_steps = self.table.n_steps
        if self.kind in traversal.GATHER_KINDS:
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

    def raw_async(self, X) -> tuple:
        """Dispatch without waiting: (device result or list of (chunk
        result, rows), true row count)."""
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"expected (n, {self.n_features}) query batch, got "
                f"{X.shape}"
            )
        n = X.shape[0]
        with self._lock:
            self._counts["requests"] += 1
            self._counts["rows"] += n
        b = self._bucket(n)
        if n <= b:
            return self._dispatch(_pad_rows(X, b)), n
        return [
            (self._dispatch(_pad_rows(X[lo:lo + b], b)), min(b, n - lo))
            for lo in range(0, n, b)
        ], n

    def finalize(self, out, n: int) -> np.ndarray:
        """A ``raw_async`` result as the estimator-shaped host array (a
        regression forest's (N, 1) accumulator as its (N,) column)."""
        if isinstance(out, list):
            host = np.concatenate(
                [o[:k].cpu().numpy() for o, k in out], axis=0
            )
        else:
            host = out[:n].cpu().numpy()
        return host[:, 0] if self.kind == "forest_mean" else host

    def raw(self, X) -> np.ndarray:
        """Probabilities for a classification forest, raw leaf counts for
        a single classification tree, values for a regressor, (N, K)
        margins for a boosted ensemble, as a host array."""
        return self.finalize(*self.raw_async(X))

    def warmup(self, buckets=None) -> None:
        """Run every bucket shape once off the request path: uploads what
        is not on the device yet and, on CUDA, builds and loads the
        kernel."""
        for b in buckets or self.buckets:
            self.raw(np.zeros((int(b), self.n_features), np.float32))

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

    @property
    def serve_report_(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
        return {
            "kind": self.kind,
            "exact": bool(self.exact),
            "device": str(self.device),
            "dispatch": self.dispatch,
            "quantization": (dict(self._quant.report)
                             if self._quant is not None else {"mode": "off"}),
            "buckets": self.buckets,
            **counts,
            **table_notes(self.trees),
        }


def compile_model(estimator, *, buckets=DEFAULT_BUCKETS, quantize=None,
                  quantize_tol=None, calibration=None) -> CompiledModel:
    """Flatten a fitted estimator into a :class:`CompiledModel` on the
    estimator's ``device`` (``None`` = ``"cuda"``, raising without CUDA;
    ``"cpu"`` serves by the plain versions). ``quantize="int8"`` serves
    compressed tables, refusing past ``quantize_tol`` (default 1e-2) on the
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
        if quantize is not None:
            raise NotImplementedError(
                "quantize= for a single regression tree is not ported yet "
                "(ROADMAP.md Queue 1 item 15)")
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
