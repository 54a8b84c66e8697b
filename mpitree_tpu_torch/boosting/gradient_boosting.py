"""Histogram gradient-boosted trees with sklearn's ``HistGradientBoosting*``
surface, on the card.

Counterpart of ``mpitree_tpu/boosting/gradient_boosting.py`` on its host
round loop (``:588-735``). Each round fits one tree (one per class for the
multinomial softmax) to the current Newton residuals:

1. the gradients and hessians come from ``boosting/losses.py`` (host
   float64, O(N) a round), times ``sample_weight`` and the round's keyed
   row mask (``ops/sampling.row_subsample_mask``: rows outside it carry
   ``h == 0`` and add to no histogram channel);
2. the tree grows on the levelwise device engine every estimator uses,
   ``core/builder.build_tree(task="gbdt")``: the ``(count, g, h)``
   histograms take the fixed-point route of the histogram kernels (exact
   int64 sums, so the card's tree equals the CPU's) and the Newton sweep
   picks the splits (``ops/impurity.best_split_newton``);
3. every node's value is refit on the host in exact float64 from the rows'
   final nodes (:func:`_newton_refit`), and the training margins move by
   ``learning_rate`` times the leaf values of each row's own leaf (every
   row's node id advances, subsampled or not, so no descent is needed).

``X`` is binned once for the ensemble, on the card, with one byte-wide
copy of the bins for the histogram kernels; ``colsample_bytree < 1``
slices both once per round (:func:`_column_slice`) and maps the tree's
features back. ``early_stopping`` holds out a keyed slice of the rows
before binning and scores it every round by a numpy descent
(:func:`_host_leaf_ids`). A round whose (g, h) totals are not finite
raises ``FloatingPointError`` before its tree is built.

Prediction descends every tree at once over the flat serving table
(``ops/predict.stacked_leaf_ids``) and accumulates the margins on the host
in the JAX package's order (``_staged_raw``, ``:772-789``), so the card's
answers equal the CPU's and the JAX package's bit for bit wherever the
trees are the same. ``compile_model`` serves the margins through the
traversal kernel K4 (``serving/model.py``, kind ``margin``).

``max_leaf_nodes`` grows every round's tree best-first
(``core/leafwise_builder.py``). ``rounds_per_dispatch`` (resolved by
``boosting/fused_rounds.resolve_rounds_per_dispatch``, as the JAX
package's ``:524-590``) runs K > 1 rounds per dispatch on the device
(``fused_rounds.run_fused_rounds``: float32 margins, best-first trees, no
copy inside a dispatch) for binary logistic and squared error without
early stopping or ``colsample_bytree``; ``"auto"`` engages it where
measured faster (K = 8 on the card, the host loop on the CPU), an
explicit K raises on a blocker.

``fit_stats_`` holds the phase seconds, each ending when the card is idle
(``bin_seconds``; ``loss_seconds``, the host's masks, (g, h), guards and
losses; ``build_seconds``, the tree builds, or the fused dispatches;
``refit_seconds``, the leaf refits and margin updates), ``n_rounds``, the
``rounds_per_dispatch`` decision with its reason, and for fused rounds
``dispatches``, ``pool`` and ``hist_subtraction``; a leaf-wise round
adds its ``engine``, ``frontier`` and ``expansions``.

``n_devices`` (``:391-393``, ``:542``) runs every round on a mesh: the
host loop's trees on the data mesh (or a ``(dr, df)`` mesh's feature
slabs) through ``build_tree``, whose int64 fixed-point sums are exact
and whose exponents come from every row, so each tree, refit and margin
is the one-device ensemble's bit for bit; the fused rounds on a data
mesh (``fused_rounds.run_fused_rounds``). ``predict`` splits its rows
over the local shards. ``fit_stats_`` then holds ``n_shards`` and the
collectives' counts.

``fit(dataset=StreamedDataset...)`` (or the dataset as ``X``) boosts
from a chunk stream (``mpitree_tpu_torch.ingest``; ``:253-360``), on the
host loop and the fused rounds alike: the matrix is placed once on the
mesh (one shard for one device) and every round reads it there; the
subsample's row masks are keyed by the global row, so the rounds are the
in-memory fit's. ``early_stopping`` and ``colsample_bytree < 1`` raise
there, as in the JAX package.

Resilience (``:594-660``; ``mpitree_tpu_torch.resilience``): every
round's tree build runs through ``retry_device`` (boosting has no host
twin; below the retries the rung is the round checkpoint), resuming a
transient failure of a levelwise build from its failed level; each fused
dispatch retries likewise (``fused_rounds.py``). The chaos seams
``round`` (each round of the host loop) and ``grad_hess`` (its (g, h),
which the non-finite guard then refuses) are the JAX package's.
``checkpoint=path`` keeps a ``BoostCheckpoint``: every
``checkpoint_every`` rounds (for fused rounds, after the dispatch that
crosses the multiple) the new trees and the resume state (the float64
margins, the score history, the early-stopping counters) are flushed,
``checkpoint_compact_every`` merges the shards, and a fit killed and run
again with the same inputs resumes there and ends with the same
ensemble, margins bit for bit. A ``random_state`` that is a numpy
generator would draw other masks on the rerun: the checkpoint is then
disabled with a warning. ``backend="host"`` raises ``ValueError``:
boosting rounds run the device engine only, as in the JAX package.
"""

from __future__ import annotations

import numbers
import warnings

import numpy as np
import torch

from mpitree_tpu_torch._device import resolve_device
from mpitree_tpu_torch.boosting import fused_rounds
from mpitree_tpu_torch.boosting.losses import loss_for
from mpitree_tpu_torch.core.builder import (
    BuildConfig,
    build_tree,
    pack_for_fit,
    shard_matrix,
)
from mpitree_tpu_torch.models._streamed import (
    ingest_for,
    is_streamed,
    stream_of,
    stream_weight,
)
from mpitree_tpu_torch.models.classifier import (
    ClassifierBase,
    EstimatorBase,
    FitClock,
    host_tier,
    fit_mesh,
    predict_mesh,
)
from mpitree_tpu_torch.models.regressor import RegressorBase
from mpitree_tpu_torch.ops.binning import BinnedData, bin_for_engine
from mpitree_tpu_torch.ops.hist_kernel import LANE_FEATURES
from mpitree_tpu_torch.ops.predict import stacked_leaf_ids
from mpitree_tpu_torch.ops.sampling import (
    feature_subsample_mask,
    row_subsample_mask,
    seed_from,
)
from mpitree_tpu_torch.parallel.mesh import feature_shards
from mpitree_tpu_torch.resilience import chaos
from mpitree_tpu_torch.resilience.checkpoint import BoostCheckpoint
from mpitree_tpu_torch.resilience.recovery import SnapshotSlot
from mpitree_tpu_torch.resilience.retry import retry_device, sync
from mpitree_tpu_torch.serving.tables import TreeList
from mpitree_tpu_torch.utils.validation import (
    resolve_min_samples_leaf,
    validate_fit_data,
    validate_fit_targets,
    validate_max_leaf_nodes,
    validate_predict_data,
    validate_sample_weight,
)

def _newton_refit(tree, leaf_ids: np.ndarray, g64: np.ndarray,
                  h64: np.ndarray, reg_lambda: float) -> np.ndarray:
    """Exact float64 Newton values from the rows' final nodes, in place
    (``mpitree_tpu/boosting/gradient_boosting.py:78``): per-leaf (G, H)
    sums rolled up the tree in one descending pass (children have larger
    ids than their parent), then every node's value ``-G/(H + lambda)``
    (returned, and stored in ``value`` as float32 and ``count[:, 0]`` as
    float64, which predict reads) and structure score ``1/2 G^2/(H +
    lambda)`` as ``impurity``."""
    G = np.bincount(leaf_ids, weights=g64, minlength=tree.n_nodes)
    H = np.bincount(leaf_ids, weights=h64, minlength=tree.n_nodes)
    for i in range(tree.n_nodes - 1, 0, -1):
        p = tree.parent[i]
        if p < 0:
            continue
        G[p] += G[i]
        H[p] += H[i]
    denom = np.maximum(H + reg_lambda, 1e-12)
    vals = -G / denom
    tree.value = vals.astype(np.float32)
    tree.count[:, 0] = vals
    tree.impurity = 0.5 * G * G / denom
    return vals


def _host_leaf_ids(tree, X: np.ndarray) -> np.ndarray:
    """Vectorized numpy descent of the held-out rows, once a round
    (``mpitree_tpu/boosting/gradient_boosting.py:109``)."""
    node = np.zeros(X.shape[0], np.int32)
    for _ in range(max(tree.max_depth, 1)):
        f = tree.feature[node]
        leaf = f < 0
        xf = X[np.arange(X.shape[0]), np.maximum(f, 0)]
        nxt = np.where(
            xf <= tree.threshold[node], tree.left[node], tree.right[node]
        )
        node = np.where(leaf, node, nxt).astype(np.int32)
    return node


def _column_slice(binned: BinnedData, packed: torch.Tensor | None,
                  kept: np.ndarray):
    """One round's ``colsample_bytree`` view: the binned matrix's columns
    ``kept`` and its byte-wide copy's, both on the card, its rows padded
    to ``LANE_FEATURES`` bytes again
    (``mpitree_tpu/boosting/gradient_boosting.py:129``). Every round keeps
    the same number of features, so the histogram's plan stays the
    same."""
    xb = binned.x_binned
    idx = torch.from_numpy(kept.astype(np.int64)).to(xb.device)
    sliced = BinnedData(
        x_binned=xb.index_select(1, idx).contiguous(),
        thresholds=binned.thresholds[kept],
        n_cand=binned.n_cand[kept],
        n_bins=binned.n_bins,
        quantized=binned.quantized,
    )
    if packed is None:
        return sliced, None
    width = -(-len(kept) // LANE_FEATURES) * LANE_FEATURES
    out = torch.zeros((xb.shape[0], width), dtype=torch.uint8,
                      device=xb.device)
    out[:, :len(kept)] = packed.index_select(1, idx)
    return sliced, out


class _BaseGradientBoosting(EstimatorBase):
    """Shared fit and predict; the subclasses bind the task and the loss."""

    def __init__(self, *, loss, learning_rate=0.1, max_iter=100, max_depth=6,
                 max_leaf_nodes=None, rounds_per_dispatch="auto",
                 max_bins=256, binning="auto", subsample=1.0,
                 colsample_bytree=1.0,
                 min_samples_split=2, min_samples_leaf=20,
                 min_child_weight=1e-3, reg_lambda=0.0, min_split_gain=0.0,
                 early_stopping=False, validation_fraction=0.1,
                 n_iter_no_change=10, tol=1e-7, random_state=None,
                 n_devices=None, backend=None, verbose=0,
                 checkpoint=None, checkpoint_every=10,
                 checkpoint_compact_every=None, device=None):
        self.loss = loss
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.max_depth = max_depth
        self.max_leaf_nodes = max_leaf_nodes
        self.rounds_per_dispatch = rounds_per_dispatch
        self.max_bins = max_bins
        self.binning = binning
        self.subsample = subsample
        self.colsample_bytree = colsample_bytree
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.min_child_weight = min_child_weight
        self.reg_lambda = reg_lambda
        self.min_split_gain = min_split_gain
        self.early_stopping = early_stopping
        self.validation_fraction = validation_fraction
        self.n_iter_no_change = n_iter_no_change
        self.tol = tol
        self.random_state = random_state
        self.n_devices = n_devices
        self.backend = backend
        self.verbose = verbose
        self.checkpoint = checkpoint
        self.checkpoint_every = checkpoint_every
        self.checkpoint_compact_every = checkpoint_compact_every
        self.device = device

    # -- fit ---------------------------------------------------------------
    def _validate_params_(self) -> None:
        """The JAX package's parameter checks (``:208-251``)."""
        if not self.learning_rate > 0:
            raise ValueError(
                f"learning_rate must be > 0, got {self.learning_rate!r}"
            )
        if int(self.max_iter) < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter!r}")
        for name in ("reg_lambda", "min_split_gain", "min_child_weight"):
            if float(getattr(self, name)) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)!r}"
                )
        if not 0.0 < float(self.subsample) <= 1.0:
            raise ValueError(
                f"subsample must be in (0, 1], got {self.subsample!r}"
            )
        if not 0.0 < float(self.colsample_bytree) <= 1.0:
            raise ValueError(
                "colsample_bytree must be in (0, 1], got "
                f"{self.colsample_bytree!r}"
            )
        if int(self.checkpoint_every) < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {self.checkpoint_every!r}"
            )
        cce = self.checkpoint_compact_every
        if cce is not None and int(cce) < 2:
            raise ValueError(
                "checkpoint_compact_every must be >= 2 shards or None, "
                f"got {cce!r}"
            )
        if host_tier(self.backend):
            raise ValueError(
                "backend='host': boosting rounds run the device engine "
                "only; drop backend= (device= picks the card or the CPU)"
            )
        rpd = self.rounds_per_dispatch
        if rpd not in (None, "auto"):
            if (not isinstance(rpd, numbers.Integral)
                    or isinstance(rpd, bool) or int(rpd) < 1):
                raise ValueError(
                    "rounds_per_dispatch must be an integer >= 1 or "
                    f"'auto', got {rpd!r}"
                )

    def _streamed_refusals_(self, X, y, dataset):
        """The combinations a streamed round loop cannot honour
        (``:253-280``), refused with the JAX package's words."""
        stream_of(X, dataset, y)
        if self.early_stopping:
            raise ValueError(
                "early_stopping scores a held-out raw-feature slice by "
                "host descent every round; a streamed fit never "
                "materializes raw rows — disable early_stopping or fit "
                "in memory"
            )
        if float(self.colsample_bytree) < 1.0:
            raise ValueError(
                "colsample_bytree < 1 re-slices the binned matrix on "
                "host every round; the streamed matrix lives sharded on "
                "device — use subsample (keyed row masks stay streamed) "
                "or fit in memory"
            )

    def _fit(self, X, y, sample_weight, *, task, dataset=None):
        self._validate_params_()
        mln = validate_max_leaf_nodes(self)
        streamed = is_streamed(X, dataset)
        if streamed:
            # the mesh first: the chunks land on it as they are binned
            self._streamed_refusals_(None if dataset is None else X, y,
                                     dataset)
            res, mesh, clock, stats = ingest_for(
                self, X if dataset is None else dataset)
            binned = res.binned
            device = clock.device
            y_t, classes = validate_fit_targets(res.y, task=task)
            sw = stream_weight(res, sample_weight)
            F = binned.n_features
        else:
            mesh = fit_mesh(self, False)
            device = (resolve_device(self.device) if mesh is None
                      else mesh.lead)
            X, y_t, classes = validate_fit_data(X, y, task=task)
            sw = validate_sample_weight(sample_weight, X.shape[0])
            F = X.shape[1]
        self.n_features_ = F
        self.n_features_in_ = F
        self.n_outputs_ = 1
        if task == "classification":
            if len(classes) < 2:
                raise ValueError(
                    "gradient boosting needs at least 2 classes; got "
                    f"{len(classes)}"
                )
            self.classes_ = classes
            self.n_classes_ = len(classes)
        loss = loss_for(self.loss, task,
                        len(classes) if classes is not None else None)
        K = loss.K
        self.n_trees_per_iteration_ = K
        seed = seed_from(self.random_state)

        # Held-out rows come off a keyed permutation before binning, so
        # they reach neither the bin edges nor the trees.
        if streamed:
            # early_stopping was refused: every row trains
            X_tr, y_tr, sw_tr = None, y_t, sw
            X_val = y_val = sw_val = None
        elif self.early_stopping:
            if not 0.0 < float(self.validation_fraction) < 1.0:
                raise ValueError(
                    "validation_fraction must be in (0, 1), got "
                    f"{self.validation_fraction!r}"
                )
            perm = np.random.default_rng(seed).permutation(X.shape[0])
            n_val = max(1, int(round(self.validation_fraction * X.shape[0])))
            if n_val >= X.shape[0]:
                raise ValueError("validation_fraction leaves no training rows")
            val_idx, tr_idx = perm[:n_val], perm[n_val:]
            X_tr, X_val = X[tr_idx], X[val_idx]
            y_tr, y_val = y_t[tr_idx], y_t[val_idx]
            sw_tr = sw[tr_idx] if sw is not None else None
            sw_val = sw[val_idx] if sw is not None else None
        else:
            X_tr, y_tr, sw_tr = X, y_t, sw
            X_val = y_val = sw_val = None
        if streamed:
            n_tr = binned.n_samples
        else:
            n_tr = X_tr.shape[0]
            clock = FitClock(device)
            binned = bin_for_engine(X_tr, max_bins=self.max_bins,
                                    binning=self.binning, device=device)
            stats = {"bin_seconds": clock.lap()}
        # a mesh's shards pack their own bins (FitInputs, shard_matrix)
        packed = pack_for_fit(binned) if mesh is None else None
        stats.update(loss_seconds=0.0, build_seconds=0.0, refit_seconds=0.0)
        cfg = BuildConfig(
            task="gbdt",
            max_depth=self.max_depth,
            max_leaf_nodes=mln,
            min_samples_split=int(self.min_samples_split),
            min_child_weight=float(self.min_child_weight),
            reg_lambda=float(self.reg_lambda),
            min_split_gain=float(self.min_split_gain),
            min_leaf_rows=float(
                resolve_min_samples_leaf(self.min_samples_leaf, n_tr)
            ),
        )

        ck = self._open_checkpoint(
            task, None if streamed else X, binned, y_t, sw)
        baseline = loss.init_raw(y_tr, sw_tr)  # (K,) float64
        self._baseline_raw = np.asarray(baseline, np.float64)
        raw_tr = np.tile(baseline, (n_tr, 1))
        raw_val = (np.tile(baseline, (len(X_val), 1))
                   if X_val is not None else None)
        lr = float(self.learning_rate)
        subsample = float(self.subsample)
        colsample = float(self.colsample_bytree)
        trees: list = []
        train_scores = [-loss.loss(raw_tr, y_tr, sw_tr)]
        val_scores = ([-loss.loss(raw_val, y_val, sw_val)]
                      if X_val is not None else None)
        best_val = -np.inf if val_scores is None else val_scores[0]
        stale = 0
        n_iter = 0
        stopped_early = False
        start_round = 0
        if ck is not None and ck.trees:
            # resume (:470-520): the completed rounds' trees, the exact
            # float64 margins and the score and early-stopping state they
            # left; every later round re-derives from the keyed masks
            st = ck.state or {}
            n_done, rem = divmod(len(ck.trees), K)
            rt, ts = st.get("raw_tr"), st.get("train_scores")
            resumable = (
                rem == 0
                and rt is not None and rt.shape == raw_tr.shape
                and ts is not None and len(ts) == n_done + 1
                and (X_val is None) == ("raw_val" not in st)
                and (X_val is None or (
                    st["raw_val"].shape == raw_val.shape
                    and all(k in st for k in
                            ("val_scores", "best_val", "stale")))))
            if not resumable:
                warnings.warn(
                    f"boosting checkpoint at {self.checkpoint} carries "
                    "inconsistent round state (crash inside a flush "
                    "window, or tampering); starting fresh",
                    stacklevel=3,
                )
                ck = BoostCheckpoint(self.checkpoint, ck.fingerprint)
            else:
                trees = list(ck.trees)
                raw_tr[:] = rt
                train_scores = [float(v) for v in ts]
                if X_val is not None:
                    raw_val[:] = st["raw_val"]
                    val_scores = [float(v) for v in st["val_scores"]]
                    best_val = float(st["best_val"])
                    stale = int(st["stale"])
                    # a kill between the flush of the stopping round and
                    # the checkpoint's removal: stop again, train nothing
                    stopped_early = stale >= int(self.n_iter_no_change)
                start_round = n_iter = n_done
                stats["resumed_rounds"] = n_done
        # one slot a fit: a round's levelwise build resumes from its failed
        # level
        slot = SnapshotSlot()
        # K rounds per dispatch on the card (boosting/fused_rounds.py),
        # resolved as the JAX package's :524-590: "auto" where measured
        # faster, an explicit K forces it or raises on a blocker; K == 1
        # is the host round loop below
        k_dispatch, reason = fused_rounds.resolve_rounds_per_dispatch(
            self.rounds_per_dispatch, device_type=device.type,
            loss_kind=loss.kind, loss_K=K,
            early_stopping=bool(self.early_stopping), colsample=colsample,
            max_depth=self.max_depth, max_leaf_nodes=mln,
            n_samples=binned.n_samples, n_features=binned.n_features,
            n_bins=binned.n_bins, hist_budget_bytes=cfg.hist_budget_bytes,
            feature_shards=1 if mesh is None else feature_shards(mesh))
        stats["rounds_per_dispatch"] = {"value": int(k_dispatch),
                                        "reason": reason}
        stats["loss_seconds"] += clock.lap()
        if k_dispatch > 1:
            stats.update(fused_rounds.run_fused_rounds(
                binned=binned, packed=packed, y_tr=y_tr, sw_tr=sw_tr,
                raw_tr=raw_tr, trees=trees, train_scores=train_scores,
                max_iter=int(self.max_iter), cfg=cfg, seed=seed, lr=lr,
                loss_kind=loss.kind, rounds_per_dispatch=int(k_dispatch),
                subsample=subsample, verbose=bool(self.verbose),
                mesh=mesh, start_round=start_round, ck=ck,
                checkpoint_every=int(self.checkpoint_every),
                checkpoint_compact_every=self.checkpoint_compact_every,
                stats=stats))
            n_iter = int(self.max_iter)
            stats["build_seconds"] += clock.lap()
        # the bins' shards, placed once for every round that keeps all
        # features
        x_shards = (None if mesh is None or n_iter >= int(self.max_iter)
                    else shard_matrix(binned, mesh))
        for r in range(n_iter, int(self.max_iter)):
            if stopped_early:
                break  # resumed at (or past) the early-stopping round
            chaos.step("round")
            mask = row_subsample_mask(seed, r, n_tr, subsample)
            if colsample < 1.0:
                kept = np.flatnonzero(feature_subsample_mask(
                    seed, r, binned.n_features, colsample
                )).astype(np.int32)
                binned_r, packed_r = _column_slice(binned, packed, kept)
            else:
                kept = None
                binned_r, packed_r = binned, packed
            g, h = loss.grad_hess(raw_tr, y_tr)  # (N, K) float64 each
            if sw_tr is not None:
                g = g * sw_tr[:, None]
                h = h * sw_tr[:, None]
            if subsample < 1.0:
                g = g * mask[:, None]
                h = h * mask[:, None]
            # one poisoned row would poison every histogram total and
            # every split after it: refuse before building
            g, h = chaos.corrupt("grad_hess", g, h)
            g_total, h_total = float(np.sum(g)), float(np.sum(h))
            if not (np.isfinite(g_total) and np.isfinite(h_total)):
                raise FloatingPointError(
                    f"non-finite gradient/hessian totals at boosting round "
                    f"{r} (G_total={g_total}, H_total={h_total}): the raw "
                    "predictions have overflowed or the inputs carry "
                    "non-finite values; lower learning_rate, rescale "
                    "targets/sample_weight, or enable early_stopping — "
                    "refusing to fit garbage rounds"
                )
            stats["loss_seconds"] += clock.lap()
            for k in range(K):
                def round_build(binned_r=binned_r, packed_r=packed_r,
                                g32=np.ascontiguousarray(g[:, k], np.float32),
                                h32=np.ascontiguousarray(h[:, k], np.float32),
                                xs=None if kept is not None else x_shards):
                    out = build_tree(
                        binned_r, g32, config=cfg, sample_weight=h32,
                        packed=packed_r, return_leaf_ids=True, stats=stats,
                        mesh=mesh, x_shards=xs, snapshot_slot=slot)
                    sync(device)
                    return out

                tree, leaf_ids = retry_device(
                    round_build, what=f"gbdt round {r} tree build",
                    obs=stats, resume=slot)
                stats["build_seconds"] += clock.lap()
                if kept is not None:
                    # back to the full matrix's feature ids
                    interior = tree.feature >= 0
                    tree.feature[interior] = kept[tree.feature[interior]]
                vals = _newton_refit(tree, leaf_ids, g[:, k], h[:, k],
                                     float(self.reg_lambda))
                raw_tr[:, k] += lr * vals[leaf_ids]
                if X_val is not None:
                    raw_val[:, k] += lr * vals[_host_leaf_ids(tree, X_val)]
                trees.append(tree)
                stats["refit_seconds"] += clock.lap()
            n_iter = r + 1
            train_scores.append(-loss.loss(raw_tr, y_tr, sw_tr))
            if self.verbose and (r % 10 == 0 or r + 1 == int(self.max_iter)):
                print(f"[gbdt] round {r + 1}/{self.max_iter} "
                      f"train_loss={-train_scores[-1]:.6f}")
            if val_scores is not None:
                val_scores.append(-loss.loss(raw_val, y_val, sw_val))
                if val_scores[-1] > best_val + float(self.tol):
                    best_val = val_scores[-1]
                    stale = 0
                else:
                    stale += 1
                    stopped_early = stale >= int(self.n_iter_no_change)
            if ck is not None and (r + 1) % int(self.checkpoint_every) == 0:
                # this round group's trees as one shard, then the state
                state = {"raw_tr": raw_tr,
                         "train_scores": np.asarray(train_scores,
                                                    np.float64)}
                if val_scores is not None:
                    state.update(
                        raw_val=raw_val,
                        val_scores=np.asarray(val_scores, np.float64),
                        best_val=np.float64(best_val),
                        stale=np.int64(stale))
                ck.append(trees[len(ck.trees):], state)
                ck.maybe_compact(self.checkpoint_compact_every, stats)
            stats["loss_seconds"] += clock.lap()
            if stopped_early:
                break
        if ck is not None:
            ck.done()
        stats["n_rounds"] = n_iter
        stats["early_stop"] = stopped_early
        if mesh is not None:
            stats.update(n_shards=mesh.size, **mesh.stats)
        self.trees_ = TreeList(trees)
        self.n_iter_ = n_iter
        self.train_score_ = np.asarray(train_scores)
        self.validation_score_ = (np.asarray(val_scores)
                                  if val_scores is not None else None)
        self._loss_obj = loss
        self.fit_stats_ = stats
        if streamed:
            res.close()  # the spill store, if the ingest opened one
        return self

    def _open_checkpoint(self, task, X, binned, y, sample_weight):
        """The fit's :class:`BoostCheckpoint` (``:411-445``), or None
        when ``checkpoint`` is unset or, with a warning, when the
        ``random_state`` would not replay the masks. Its fingerprint
        covers every parameter but ``checkpoint``, ``checkpoint_every``
        and ``device``, the task, and the validated raw rows (or a
        streamed fit's bin table and row count), targets and weights."""
        if not self.checkpoint:
            return None
        if isinstance(self.random_state,
                      (np.random.Generator, np.random.RandomState)):
            warnings.warn(
                "boosting checkpointing requires a reproducible "
                "random_state (None or a fixed integer) so a resumed "
                "fit replays the same subsample/validation draws; "
                "checkpoint disabled",
                stacklevel=4,
            )
            return None
        params = {k: v for k, v in self.get_params().items()
                  if k not in ("checkpoint", "checkpoint_every", "device")}
        params["task"] = task
        if X is None:
            params["streamed_rows"] = int(binned.n_samples)
            params["streamed_n_cand"] = np.asarray(binned.n_cand).tolist()
            X = np.ascontiguousarray(binned.thresholds)
        return BoostCheckpoint.open(self.checkpoint, params, X, y,
                                    sample_weight)

    # -- predict -----------------------------------------------------------
    def _check_fitted(self) -> None:
        if not isinstance(getattr(self, "trees_", None), TreeList):
            raise self._not_fitted()

    def _loss(self):
        """The fitted loss; a loaded model rebuilds it from its
        parameters (without caching it on the estimator)."""
        loss = getattr(self, "_loss_obj", None)
        if loss is None:
            task = ("classification" if hasattr(self, "classes_")
                    else "regression")
            loss = loss_for(self.loss, task, getattr(self, "n_classes_", None))
        return loss

    def _staged_raw(self, X):
        """Yield the (N, K) margins after each round: one stacked descent
        of every tree on the card, then the host's float64 accumulation in
        round order (``mpitree_tpu/boosting/gradient_boosting.py:772``)."""
        self._check_fitted()
        X = validate_predict_data(X, self)
        K = self.n_trees_per_iteration_
        mesh = predict_mesh(self)
        ids = stacked_leaf_ids(
            self.trees_, X, resolve_device(self.device) if mesh is None
            else mesh.lead, mesh=mesh)
        raw = np.tile(self._baseline_raw, (X.shape[0], 1))
        lr = float(self.learning_rate)
        for r in range(len(self.trees_) // K):
            for k in range(K):
                t = self.trees_[r * K + k]
                raw[:, k] += lr * t.count[ids[r * K + k], 0]
            yield raw

    def _raw_predict(self, X):
        raw = None
        for raw in self._staged_raw(X):
            pass
        return raw


class GradientBoostingRegressor(RegressorBase, _BaseGradientBoosting):
    """Histogram gradient-boosted regression trees (squared error),
    grown depth-wise (``max_depth``, default 6) on the card.

    Parameters are those of ``mpitree_tpu.GradientBoostingRegressor``,
    plus ``device`` (``None`` = ``"cuda"``; ``"cpu"`` runs the plain
    versions of the kernels)."""

    def __init__(self, *, loss="squared_error", learning_rate=0.1,
                 max_iter=100, max_depth=6, max_leaf_nodes=None,
                 rounds_per_dispatch="auto", max_bins=256, binning="auto",
                 subsample=1.0, colsample_bytree=1.0,
                 min_samples_split=2, min_samples_leaf=20,
                 min_child_weight=1e-3, reg_lambda=0.0, min_split_gain=0.0,
                 early_stopping=False, validation_fraction=0.1,
                 n_iter_no_change=10, tol=1e-7, random_state=None,
                 n_devices=None, backend=None, verbose=0,
                 checkpoint=None, checkpoint_every=10,
                 checkpoint_compact_every=None, device=None):
        super().__init__(
            loss=loss, learning_rate=learning_rate, max_iter=max_iter,
            max_depth=max_depth, max_leaf_nodes=max_leaf_nodes,
            rounds_per_dispatch=rounds_per_dispatch,
            max_bins=max_bins, binning=binning,
            subsample=subsample, colsample_bytree=colsample_bytree,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_child_weight=min_child_weight, reg_lambda=reg_lambda,
            min_split_gain=min_split_gain, early_stopping=early_stopping,
            validation_fraction=validation_fraction,
            n_iter_no_change=n_iter_no_change, tol=tol,
            random_state=random_state, n_devices=n_devices, backend=backend,
            verbose=verbose, checkpoint=checkpoint,
            checkpoint_every=checkpoint_every,
            checkpoint_compact_every=checkpoint_compact_every, device=device,
        )

    def fit(self, X=None, y=None, sample_weight=None, *, dataset=None):
        return self._fit(X, y, sample_weight, task="regression",
                         dataset=dataset)

    def predict(self, X):
        return self._raw_predict(X)[:, 0]

    def staged_predict(self, X):
        """The prediction after each boosting round (sklearn's staged
        API)."""
        for raw in self._staged_raw(X):
            yield raw[:, 0].copy()


class GradientBoostingClassifier(ClassifierBase, _BaseGradientBoosting):
    """Histogram gradient-boosted classification trees (log loss): one
    tree per round for two classes, one per class per round for more
    (the softmax's diagonal Newton residuals).

    Parameters are those of ``mpitree_tpu.GradientBoostingClassifier``,
    plus ``device``; see :class:`GradientBoostingRegressor`."""

    def __init__(self, *, loss="log_loss", learning_rate=0.1, max_iter=100,
                 max_depth=6, max_leaf_nodes=None,
                 rounds_per_dispatch="auto",
                 max_bins=256, binning="auto", subsample=1.0,
                 colsample_bytree=1.0,
                 min_samples_split=2, min_samples_leaf=20,
                 min_child_weight=1e-3, reg_lambda=0.0, min_split_gain=0.0,
                 early_stopping=False, validation_fraction=0.1,
                 n_iter_no_change=10, tol=1e-7, random_state=None,
                 n_devices=None, backend=None, verbose=0,
                 checkpoint=None, checkpoint_every=10,
                 checkpoint_compact_every=None, device=None):
        super().__init__(
            loss=loss, learning_rate=learning_rate, max_iter=max_iter,
            max_depth=max_depth, max_leaf_nodes=max_leaf_nodes,
            rounds_per_dispatch=rounds_per_dispatch,
            max_bins=max_bins, binning=binning,
            subsample=subsample, colsample_bytree=colsample_bytree,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_child_weight=min_child_weight, reg_lambda=reg_lambda,
            min_split_gain=min_split_gain, early_stopping=early_stopping,
            validation_fraction=validation_fraction,
            n_iter_no_change=n_iter_no_change, tol=tol,
            random_state=random_state, n_devices=n_devices, backend=backend,
            verbose=verbose, checkpoint=checkpoint,
            checkpoint_every=checkpoint_every,
            checkpoint_compact_every=checkpoint_compact_every, device=device,
        )

    def fit(self, X=None, y=None, sample_weight=None, *, dataset=None):
        return self._fit(X, y, sample_weight, task="classification",
                         dataset=dataset)

    def decision_function(self, X):
        raw = self._raw_predict(X)
        return raw[:, 0] if raw.shape[1] == 1 else raw

    def predict_proba(self, X):
        return self._loss().proba(self._raw_predict(X))

    def predict(self, X):
        return self.classes_[self.predict_proba(X).argmax(axis=1)]

    def staged_predict_proba(self, X):
        loss = self._loss()
        for raw in self._staged_raw(X):
            yield loss.proba(raw)

    def staged_predict(self, X):
        for proba in self.staged_predict_proba(X):
            yield self.classes_[proba.argmax(axis=1)]
