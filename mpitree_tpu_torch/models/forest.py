"""Random forests and extremely randomized trees, built tree by tree.

Counterpart of ``mpitree_tpu/models/forest.py`` on its per-tree route
(``_fit_forest``, ``:272-765``; ``build_one_device``, ``:533-576``):
``RandomForestClassifier``, ``RandomForestRegressor``,
``ExtraTreesClassifier`` and ``ExtraTreesRegressor``.

- the matrix is binned once (``ops/binning.bin_for_engine``), its
  byte-wide copy for the histogram kernels is made once, and every tree is
  built on that one device-resident binned matrix: by default all of them
  in one call of the fused engine (``core/fused_builder.build_forest_fused``,
  the JAX package's batched path, ``:578-620``, ``:696-775``), under
  ``MPITREE_TPU_ENGINE=levelwise`` one levelwise build a tree
  (``core/builder.build_tree``); ``fit_stats_["ensemble_path"]`` says
  which (``"batched-fused"``, ``"per-tree"`` or ``"host"``), and the trees
  are the same; ``backend="host"`` builds every tree on the host tier
  from one host binning (``host_raw``, ``:519-528``);
- phase A draws every per-tree random number up front, in the JAX
  package's order (``:437-492``): ``rng = np.random.default_rng(
  random_state)``, then per tree the multinomial bootstrap
  ``rng.multinomial(n, np.full(n, 1/n))`` as float32 multiplicities (when
  ``bootstrap``), the tree's sampler seed ``int(rng.integers(2**32))``
  (when sampling per node or ``splitter="random"``), and the tree's
  subspace ``np.sort(rng.choice(F, k, replace=False))`` (when
  ``max_features_mode="tree"``); one draw out of order would change every
  later tree. The multiplicities multiply any user ``sample_weight``
  (which ``class_weight`` scales first). Integer weights sum exactly on
  the card; fractional ones take the histogram's fixed-point route;
- each tree's leaf floors read its own composed weights (``tree_cfg``,
  ``:388-405``), and each tree is finished as ``finish`` does it
  (``:495-517``): the refine tail with that tree's weights, subspace and
  sampler when ``resolve_refine`` engages it, then ``ccp_alpha`` pruning;
- ``predict_proba`` descends all trees at once over the flat serving
  table (``ops/predict.stacked_leaf_ids``) and runs the JAX package's host
  float64 loop, ``acc += counts / max(rowsum, 1)`` in tree order, ``/ T``
  (``:924-962``); the regression forest's ``predict`` is the float64 mean
  of the trees' exact leaf means (``:1048-1055``);
- ``oob_score`` scores each training row by the trees whose bootstrap left
  it out (``oob_score_``, with ``oob_decision_function_`` or
  ``oob_prediction_``), warning when some rows, or all, have no such tree
  (``:896-922``, ``:1028-1046``); ``warm_start`` keeps the fitted trees
  and, with an integer ``random_state``, replays phase A so the new trees
  draw what an uninterrupted fit would (``:158-204``).

``monotonic_cst`` (``:362-370``) gates every tree's splits, builds each
tree to its full depth in one engine, clips each tree's values
(``clip_tree_values``, ``:513-516``); a constrained classification
forest's ``predict_proba`` averages its trees' bound-clipped class-0
fractions ``[p0, 1 - p0]`` (``clipped_class0``, ``:924-960``), cached per
fit, which is what makes the average monotone.

``trees_`` is a :class:`~mpitree_tpu_torch.serving.tables.TreeList`,
which carries the flat table that predict and ``compile_model`` share.
``fit_stats_`` sums the phase seconds and tail counts over the trees and
names the ``engine`` (see ``models/classifier.py``).

``n_devices`` shards the forest (``:330-360``, ``:700-760``): the
batched path grows the trees on a ``(tree, data)`` mesh of the devices
(``core/fused_builder.build_forest_fused``: tree groups, each growing its
block of trees with its rows sharded over its data axis, the trees then
exchanged so every process holds the forest), the per-tree path grows
each tree on the data mesh (``grow_tree``); either way every tree is the
one-device tree field for field, and the refine tail, ``oob_score`` and
``warm_start`` (whose new trees alone shape the mesh) run as on one
device. ``fit_stats_`` then holds ``n_shards``, ``forest_mesh`` and the
collectives' counts. ``predict`` splits its rows over the local shards.

``fit(dataset=StreamedDataset...)`` (or the dataset as ``X``) fits from
a chunk stream (``mpitree_tpu_torch.ingest``; ``:204-260``): the draws of
phase A are then keyed by (seed, tree, row or feature)
(``ops/sampling.bootstrap_weights``, ``tree_seed``, ``feature_subset``),
every tree grows to its full depth on the device (no tail), and
``oob_score`` and ``backend="host"`` raise. An in-memory fit under
``MPITREE_TPU_KEYED_BOOTSTRAP=1`` draws the same and grows the streamed
forest's trees. A stream placed on a data mesh reaches the ``(tree,
data)`` mesh block by block: each tree group's shards take the row
blocks they grow from, and only rows another process placed cross
between processes (``ingest/place.regroup_matrix``, counted under
``exchange``; none where the forest's data axis is the ingest's).

Resilience (``:494-770``; ``mpitree_tpu_torch.resilience``): the trees
grow in groups, each through the ladder. A batched group is one call of
the fused engine: a transient failure runs it again, a terminal one
raises, or, with ``MPITREE_TPU_ELASTIC=1``, rebuilds its trees one by
one on the host tier from the re-binned raw rows (``device_failover``;
a streamed forest and one on a mesh across
processes have no host rung, ``retry_device`` only); a per-tree build
runs ``grow_tree``'s ladder.
``checkpoint=path`` (with a fixed integer ``random_state``, or keyed
draws: otherwise it warns and is disabled; never with ``warm_start``)
flushes each group's finished trees as it lands, in groups of the tree
axis's width, at least :data:`CHECKPOINT_GROUP_FLOOR`, and a fit of the
same inputs that was killed resumes after the last group and ends with
the forest an uninterrupted fit grows; ``checkpoint_compact_every``
merges the shard files. The counters (``device_retries``,
``device_failovers``, ``checkpoint_compactions``) land in
``fit_stats_``.
"""

from __future__ import annotations

import dataclasses
import numbers
import warnings

import numpy as np
import torch

from mpitree_tpu_torch._device import resolve_device
from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.core.builder import (
    BuildConfig,
    pack_for_fit,
    resolve_engine,
)
from mpitree_tpu_torch.core.fused_builder import build_forest_fused
from mpitree_tpu_torch.core.host_builder import build_tree_host
from mpitree_tpu_torch.models._streamed import (
    ingest_for,
    is_streamed,
    refuse_host,
    stream_of,
    stream_weight,
)
from mpitree_tpu_torch.models.classifier import (
    ClassifierBase,
    EstimatorBase,
    FitClock,
    finish_tree,
    grow_tree,
    host_tier,
    fit_mesh,
    predict_mesh,
)
from mpitree_tpu_torch.models.regressor import RegressorBase
from mpitree_tpu_torch.ops.binning import bin_dataset, bin_for_engine
from mpitree_tpu_torch.ops.predict import stacked_leaf_ids
from mpitree_tpu_torch.ops.sampling import (
    NodeFeatureSampler,
    bootstrap_weights,
    feature_subset,
    n_subspace_features,
    seed_from,
    tree_seed,
)
from mpitree_tpu_torch.parallel.mesh import (
    forest_hbm_budget,
    tree_data_shape,
)
from mpitree_tpu_torch.resilience.checkpoint import ForestCheckpoint
from mpitree_tpu_torch.resilience.retry import (
    device_failover,
    retry_device,
    sync,
)
from mpitree_tpu_torch.serving.tables import TreeList
from mpitree_tpu_torch.utils.carry import forest_from_reference
from mpitree_tpu_torch.utils.importances import feature_importances
from mpitree_tpu_torch.utils.monotonic import (
    clipped_class0,
    validate_monotonic_cst,
)
from mpitree_tpu_torch.utils.validation import (
    apply_class_weight,
    min_child_weight,
    min_decrease_scaled,
    resolve_refine,
    validate_fit_data,
    validate_fit_targets,
    validate_predict_data,
    validate_sample_weight,
)

# A checkpointed forest flushes at least this many trees at a time
# (mpitree_tpu/models/forest.py:711-728).
CHECKPOINT_GROUP_FLOOR = 8


class _BaseForest(EstimatorBase):
    """The forests' shared fit: parameter checks, phase A's draws, the
    tree builds in groups with their failover and checkpoints, warm start
    and the OOB masks."""

    def _check_slice(self) -> None:
        cce = self.checkpoint_compact_every
        if cce is not None and int(cce) < 2:
            raise ValueError(
                "checkpoint_compact_every must be >= 2 shards or None, "
                f"got {cce!r}"
            )
        if self.max_features_mode not in ("node", "tree"):
            raise ValueError(
                f"max_features_mode must be 'node' or 'tree', "
                f"got {self.max_features_mode!r}"
            )
        if self.splitter not in ("best", "random"):
            raise ValueError(
                f"splitter must be 'best' or 'random', got {self.splitter!r}"
            )
        if int(self.n_estimators) < 1:
            raise ValueError(
                f"n_estimators must be >= 1, got {self.n_estimators!r}"
            )
        if self.oob_score and not self.bootstrap:
            raise ValueError("oob_score=True requires bootstrap=True")

    def _warm_start_trees(self):
        """The fitted trees a ``warm_start`` fit keeps, or None."""
        if self.warm_start and self.checkpoint:
            # both say where a fit resumes from: refused on the first fit
            raise ValueError(
                "warm_start and checkpoint are mutually exclusive: both "
                "define where a fit resumes from"
            )
        if not self.warm_start or not isinstance(
                getattr(self, "trees_", None), TreeList):
            return None
        if not isinstance(self.random_state, numbers.Integral):
            raise ValueError(
                "warm_start requires a fixed integer random_state so the "
                "continued fit replays the prior trees' bootstrap/feature "
                "draws before drawing new ones"
            )
        prev = list(self.trees_)
        if self.n_estimators < len(prev):
            raise ValueError(
                f"n_estimators={self.n_estimators} must be larger or "
                f"equal to len(trees_)={len(prev)} when warm_start==True"
            )
        if self.n_estimators == len(prev):
            warnings.warn(
                "Warm-start fitting without increasing n_estimators does "
                "not fit new trees.",
                stacklevel=4,
            )
        return prev

    def _open_stream(self, X, dataset, y) -> tuple:
        """A streamed fit's preamble (``:206-247``): the refusals, then the
        ingest on the mesh resolved first. Returns what
        :meth:`_fit_forest` takes as ``stream``: ``(IngestResult, build
        mesh or None, FitClock, stats)``."""
        ds = stream_of(X, dataset, y)
        if self.oob_score:
            raise ValueError(
                "oob_score=True needs a raw-X descent over the training "
                "rows, which a streamed fit never materializes — score "
                "on a held-out stream instead"
            )
        refuse_host(self)
        return ingest_for(self, ds)

    def _fit_forest(self, X, y, *, task, criterion, n_classes=None,
                    refit_targets=None, sample_weight=None,
                    stream=None) -> TreeList:
        """Grow the forest; sets ``fit_stats_`` and, with ``oob_score``,
        the per-tree out-of-bag masks that :meth:`_pop_oob_masks` takes.
        ``stream`` (:meth:`_open_stream`'s) makes it a streamed fit from
        the placed matrix (``X`` None)."""
        prev = self._warm_start_trees()
        streamed = stream is not None
        if streamed:
            res, mesh, clock, stats = stream
            host = False
            binned = res.binned
            n, F = binned.n_samples, binned.n_features
        else:
            host = host_tier(self.backend)
            mesh = fit_mesh(self, host)
            device = (resolve_device(self.device) if mesh is None
                      else mesh.lead)
            n, F = X.shape
            clock = FitClock(device)
            if host:
                binned = bin_dataset(X, max_bins=self.max_bins,
                                     binning=self.binning)
            else:
                binned = bin_for_engine(X, max_bins=self.max_bins,
                                        binning=self.binning, device=device)
            stats = {"bin_seconds": clock.lap()}
        # keyed draws (ops/sampling): always for a stream, whose rows a
        # host RNG cannot replay in order; opt-in in memory, which makes
        # the in-memory forest the streamed one's twin
        keyed = streamed or bool(knobs.value("MPITREE_TPU_KEYED_BOOTSTRAP"))
        if keyed:
            if self.random_state is not None and not isinstance(
                    self.random_state, numbers.Integral):
                raise ValueError(
                    "keyed bootstrap draws (streamed fits and "
                    "MPITREE_TPU_KEYED_BOOTSTRAP=1) are a pure function "
                    "of (seed, tree, row); random_state must be None or "
                    "an int"
                )
            kseed = seed_from(self.random_state)
        if streamed:
            # T tails would each replay the chunk stream: a streamed
            # forest grows every tree to its full depth on the device
            rd, refine, crown_depth = None, False, self.max_depth
        else:
            rd, refine, crown_depth = resolve_refine(
                self.max_depth, self.refine_depth,
                n_rows=n, quantized=binned.quantized,
            )
        mono = validate_monotonic_cst(self.monotonic_cst, F, task=task,
                                      n_classes=n_classes)
        if mono is not None:  # one engine for each tree's whole depth
            rd, refine, crown_depth = None, False, self.max_depth
        cfg = BuildConfig(task=task, criterion=criterion,
                          max_depth=crown_depth,
                          min_samples_split=self.min_samples_split)

        def tree_cfg(w):
            """Per-tree leaf floors from the tree's composed bootstrap x
            user weights (multinomial totals are exactly n)."""
            return dataclasses.replace(
                cfg,
                min_child_weight=min_child_weight(
                    self.min_weight_fraction_leaf, w, n,
                    self.min_samples_leaf,
                ),
                min_decrease_scaled=min_decrease_scaled(
                    self.min_impurity_decrease, w, n
                ),
            )

        # Phase A: every per-tree draw up front, in the JAX package's order.
        k = n_subspace_features(self.max_features, F)
        rand_split = self.splitter == "random"
        node_sampling = self.max_features_mode == "node" and k < F
        rng = np.random.default_rng(self.random_state)
        tree_w, tree_mask, tree_sampler = [], [], []
        self._oob_masks = [] if self.oob_score else None
        for i in range(int(self.n_estimators)):
            w = sample_weight
            if self.bootstrap:
                boot = (bootstrap_weights(kseed, i, n) if keyed
                        else rng.multinomial(n, np.full(n, 1.0 / n))
                        .astype(np.float32))
                if self._oob_masks is not None:
                    self._oob_masks.append(boot == 0)
                w = boot if w is None else boot * w
            sampler = fmask = None
            if node_sampling or rand_split:
                # tree mode keeps its subspace below; the sampler then
                # only carries the bin draws
                sampler = NodeFeatureSampler(
                    k=k if node_sampling else F, n_features=F,
                    seed=(tree_seed(kseed, i) if keyed
                          else int(rng.integers(2**32))),
                    random_split=rand_split,
                )
            if not node_sampling and k < F:
                fmask = np.zeros(F, bool)
                fmask[feature_subset(kseed, i, F, k) if keyed else
                      np.sort(rng.choice(F, size=k, replace=False))] = True
            tree_w.append(w)
            tree_mask.append(fmask)
            tree_sampler.append(sampler)

        trees = list(prev or [])
        self.fit_stats_ = stats
        ck = self._open_checkpoint(
            task, keyed, X if not streamed else None, binned, y,
            sample_weight)
        if ck is not None:
            trees = list(ck.trees[:int(self.n_estimators)])
        idxs = list(range(len(trees), int(self.n_estimators)))
        batched = not host and resolve_engine(cfg) == "fused"
        stats["ensemble_path"] = ("host" if host else
                                  "batched-fused" if batched else "per-tree")
        # the host rung re-bins the raw rows
        host_bins: list = []

        def host_binned():
            if not host_bins:
                host_bins.append(bin_dataset(X, max_bins=self.max_bins,
                                             binning=self.binning))
            return host_bins[0]

        if host or streamed or (mesh is not None and mesh.n_procs > 1):
            host_binned = None  # no host rung (see grow_tree)
        # packed once for every tree (a mesh's shards pack their own)
        packed = (None if host or batched or not idxs or mesh is not None
                  else pack_for_fit(binned))

        def finish(i, t, ids):
            return finish_tree(
                t, ids, X, y, cfg=tree_cfg(tree_w[i]),
                max_depth=self.max_depth, rd=rd, refine=refine,
                n_classes=n_classes, sample_weight=tree_w[i],
                ccp_alpha=self.ccp_alpha, clock=clock, stats=stats,
                refit_targets=refit_targets,
                feature_sampler=tree_sampler[i], feature_mask=tree_mask[i],
                mono_cst=mono)

        def host_raw(i, hb):
            """Tree ``i`` on the host tier from host bins ``hb``: (tree,
            leaf ids or None)."""
            res = build_tree_host(
                hb, y, config=tree_cfg(tree_w[i]), n_classes=n_classes,
                sample_weight=tree_w[i], return_leaf_ids=refine,
                refit_targets=refit_targets,
                feature_sampler=tree_sampler[i], feature_mask=tree_mask[i],
                mono_cst=mono)
            return res if refine else (res, None)

        def build_one(i):
            return grow_tree(
                binned, X, y, host=host, cfg=tree_cfg(tree_w[i]),
                max_depth=self.max_depth, rd=rd, refine=refine,
                n_classes=n_classes, sample_weight=tree_w[i],
                ccp_alpha=self.ccp_alpha, clock=clock, stats=stats,
                packed=packed, refit_targets=refit_targets,
                feature_sampler=tree_sampler[i],
                feature_mask=tree_mask[i], mono_cst=mono, mesh=mesh,
                host_binned=host_binned, what=f"forest tree {i}")

        def build_group(grp):
            """One call grows the group's trees on the card
            (``build_group``, ``:578-620``), inside the ladder: a terminal
            failure raises, or, with ``MPITREE_TPU_ELASTIC=1``, rebuilds
            the group tree by tree on the host tier."""
            cand = binned.candidate_mask()
            cfgs = [tree_cfg(tree_w[i]) for i in grp]

            def dev():
                out = build_forest_fused(
                    binned, y, config=cfg, n_classes=n_classes,
                    weights=np.stack([
                        np.ones(n, np.float32) if tree_w[i] is None
                        else np.asarray(tree_w[i], np.float32)
                        for i in grp]),
                    cand_masks=np.stack([
                        cand if tree_mask[i] is None
                        else cand & tree_mask[i][:, None] for i in grp]),
                    refit_targets=refit_targets, return_leaf_ids=refine,
                    min_child_weights=[c.min_child_weight for c in cfgs],
                    min_decrease_scaleds=[c.min_decrease_scaled
                                          for c in cfgs],
                    samplers=[tree_sampler[i] for i in grp], mono_cst=mono,
                    mesh=mesh, stats=stats,
                )
                sync(clock.device)
                gt, ids = out if refine else (out, [None] * len(grp))
                return [(t, g) for t, g in zip(gt, ids)], "fused"

            def host_fn():
                clock.device = torch.device("cpu")
                hb = host_binned()
                return [host_raw(i, hb) for i in grp], "host"

            if host_binned is None:
                built, engine = retry_device(
                    dev, what="forest group streamed device build",
                    obs=stats)
            else:
                built, engine = device_failover(
                    dev, host_fn, what="forest group device build",
                    obs=stats)
            stats["engine"] = engine
            if mesh is not None:
                stats.update(n_shards=mesh.size, **mesh.stats)
            stats["crown_seconds"] = stats.get("crown_seconds", 0.0) \
                + clock.lap()
            return [finish(i, t, ids) for i, (t, ids) in zip(grp, built)]

        if ck is None:
            groups = [idxs] if idxs else []
        else:
            # a group is one card program, flushed as it lands
            # (:711-728): the tree axis's width, at least the floor
            g = CHECKPOINT_GROUP_FLOOR
            if batched:
                g = max(g, tree_data_shape(
                    1 if mesh is None else mesh.size, int(self.n_estimators),
                    dataset_bytes=4 * n * F,
                    hbm_budget=forest_hbm_budget(clock.device))[0])
            groups = [idxs[j:j + g] for j in range(0, len(idxs), g)]
        for grp in groups:
            new = (build_group(grp) if batched
                   else [build_one(i) for i in grp])
            trees.extend(new)
            if ck is not None:
                ck.append(new)
                ck.maybe_compact(self.checkpoint_compact_every, stats)
        if ck is not None:
            ck.done()
        return TreeList(trees)

    def _open_checkpoint(self, task, keyed, X, binned, y, sample_weight):
        """The fit's :class:`ForestCheckpoint` (``:679-707``), or None when
        ``checkpoint`` is unset, or, with a warning, when the draws would
        not replay (a forest drawn from a host RNG needs a fixed integer
        ``random_state``). Its fingerprint covers every parameter but
        ``checkpoint`` and ``device``, the task, and the raw rows, or a
        streamed fit's bin table and row count (no raw matrix exists),
        the targets and the weights."""
        if not self.checkpoint:
            return None
        if not keyed and not isinstance(self.random_state,
                                        numbers.Integral):
            warnings.warn(
                "forest checkpointing requires a fixed integer "
                "random_state so a resumed fit replays the same "
                "bootstrap/feature draws; checkpoint disabled",
                stacklevel=4,
            )
            return None
        params = {k: v for k, v in self.get_params().items()
                  if k not in ("checkpoint", "device")}
        params["task"] = task
        if X is None:
            params["streamed_rows"] = int(binned.n_samples)
            params["streamed_n_cand"] = np.asarray(binned.n_cand).tolist()
            X = np.ascontiguousarray(binned.thresholds)
        return ForestCheckpoint.open(self.checkpoint, params, X, y,
                                     sample_weight)

    def _pop_oob_masks(self) -> list:
        """The fit's out-of-bag masks, dropped from the model (they would
        pin T x n booleans on it)."""
        masks = self._oob_masks
        del self._oob_masks
        return masks

    @staticmethod
    def _warn_partial_oob(seen) -> None:
        if not seen.all():
            warnings.warn(
                "Some inputs do not have OOB scores (too few trees); their "
                "OOB estimates are NaN",
                stacklevel=3,
            )

    @staticmethod
    def _warn_no_oob() -> float:
        warnings.warn(
            "no out-of-bag rows (too few trees); oob_score_ is nan",
            stacklevel=3,
        )
        return float("nan")

    # -- inference ---------------------------------------------------------
    def _check_fitted(self) -> None:
        if not isinstance(getattr(self, "trees_", None), TreeList):
            raise self._not_fitted()

    def _leaf_ids(self, X) -> np.ndarray:
        """(T, N) per-tree leaf ids of validated rows, their rows split
        over the fit's local shards on a mesh."""
        mesh = predict_mesh(self)
        return stacked_leaf_ids(
            self.trees_, X, resolve_device(self.device) if mesh is None
            else mesh.lead, mesh=mesh)

    @property
    def feature_importances_(self) -> np.ndarray:
        """Mean of the trees' normalized importances, renormalized to 1
        (``:793-808``)."""
        self._check_fitted()
        acc = np.zeros(self.n_features_)
        for t in self.trees_:
            acc += feature_importances(
                t, self.n_features_, task=self._task,
                criterion=getattr(self, "criterion", "entropy"),
            )
        s = acc.sum()
        return acc / s if s > 0 else acc


class RandomForestClassifier(ClassifierBase, _BaseForest):
    """Bagged classification forest (soft voting over per-tree class
    distributions).

    Parameters are those of ``mpitree_tpu.tree.RandomForestClassifier``,
    plus ``device`` (``None`` = ``"cuda"``; ``"cpu"`` runs the plain
    versions of the kernels). ``max_features`` samples a fresh subset at
    every node (``max_features_mode="node"``) or one per tree
    (``"tree"``). See the module docstring for the options this slice
    refuses.
    """

    def __init__(self, *, n_estimators=10, criterion="entropy",
                 max_depth=None, min_samples_split=2, max_bins=256,
                 binning="auto", bootstrap=True, max_features=None,
                 max_features_mode="node", oob_score=False,
                 class_weight=None, min_weight_fraction_leaf=0.0,
                 min_samples_leaf=1, random_state=None, n_devices=None,
                 backend=None, refine_depth="auto", checkpoint=None,
                 checkpoint_compact_every=None, ccp_alpha=0.0,
                 min_impurity_decrease=0.0, splitter="best",
                 monotonic_cst=None, warm_start=False, device=None):
        self.n_estimators = n_estimators
        self.criterion = criterion
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.max_bins = max_bins
        self.binning = binning
        self.bootstrap = bootstrap
        self.max_features = max_features
        self.max_features_mode = max_features_mode
        self.oob_score = oob_score
        self.class_weight = class_weight
        self.min_weight_fraction_leaf = min_weight_fraction_leaf
        self.min_samples_leaf = min_samples_leaf
        self.random_state = random_state
        self.n_devices = n_devices
        self.backend = backend
        self.refine_depth = refine_depth
        self.checkpoint = checkpoint
        self.checkpoint_compact_every = checkpoint_compact_every
        self.ccp_alpha = ccp_alpha
        self.min_impurity_decrease = min_impurity_decrease
        self.splitter = splitter
        self.monotonic_cst = monotonic_cst
        self.warm_start = warm_start
        self.device = device

    # -- fitting -----------------------------------------------------------
    def fit(self, X=None, y=None, sample_weight=None, *, dataset=None):
        self._check_slice()
        if self.criterion not in ("entropy", "gini"):
            raise ValueError(
                f"unknown classification criterion: {self.criterion!r}"
            )
        if is_streamed(X, dataset):
            stream = self._open_stream(X, dataset, y)
            res = stream[0]
            y_enc, classes = validate_fit_targets(res.y)
            sw = apply_class_weight(self.class_weight, y_enc, classes,
                                    stream_weight(res, sample_weight))
            self.trees_ = self._fit_forest(
                None, y_enc, task="classification", criterion=self.criterion,
                n_classes=len(classes), sample_weight=sw, stream=stream,
            )
            self._mono_p0 = None
            self._set_fitted(classes, res.binned.n_features)
            res.close()
            return self
        X, y_enc, classes = validate_fit_data(X, y)
        sw = apply_class_weight(
            self.class_weight, y_enc, classes,
            validate_sample_weight(sample_weight, X.shape[0]),
        )
        self.trees_ = self._fit_forest(
            X, y_enc, task="classification", criterion=self.criterion,
            n_classes=len(classes), sample_weight=sw,
        )
        self._mono_p0 = None  # predict_proba's clipped-fraction cache
        self._set_fitted(classes, X.shape[1])
        if self.oob_score:
            self._oob(X, y_enc, len(classes))
        return self

    def _oob(self, X, y_enc, C: int) -> None:
        """Each row scored by the trees whose bootstrap left it out."""
        votes = np.zeros((len(X), C))
        seen = np.zeros(len(X), bool)
        for t, ids, oob in zip(self.trees_, self._leaf_ids(X),
                               self._pop_oob_masks()):
            counts = t.count[ids[oob]].astype(np.float64)
            votes[oob] += counts / np.maximum(
                counts.sum(axis=1, keepdims=True), 1.0)
            seen |= oob
        if not seen.any():
            self.oob_score_ = self._warn_no_oob()
            self.oob_decision_function_ = np.full((len(X), C), np.nan)
            return
        self._warn_partial_oob(seen)
        df = votes / np.maximum(votes.sum(axis=1, keepdims=True), 1e-300)
        df[~seen] = np.nan  # sklearn marks uncovered rows NaN
        self.oob_decision_function_ = df
        self.oob_score_ = float(
            (votes[seen].argmax(axis=1) == y_enc[seen]).mean())

    @classmethod
    def from_reference(cls, trees, classes, n_features: int, **params):
        """A fitted forest from the JAX package's: ``trees`` a sequence of
        per-tree arrays as :func:`utils.carry.forest_from_reference` takes
        them, ``classes`` the reference's ``classes_``, ``n_features`` its
        ``n_features_``; ``params`` go to the constructor."""
        est = cls(**params)
        est.trees_ = TreeList(forest_from_reference(trees))
        est.n_estimators = len(est.trees_)
        est._set_fitted(classes, n_features)
        return est

    # -- inference ---------------------------------------------------------
    def mono_signs(self):
        """The internal monotonicity signs of ``monotonic_cst``, or None."""
        return validate_monotonic_cst(
            self.monotonic_cst, self.n_features_, task="classification",
            n_classes=len(self.classes_))

    def _clipped_p0(self) -> list:
        """Per tree, the (n_nodes,) float64 bound-clipped class-0
        fractions of a constrained forest, computed once per fit."""
        cache = getattr(self, "_mono_p0", None)
        if cache is None or len(cache) != len(self.trees_):
            mono = self.mono_signs()
            cache = [clipped_class0(t, mono).astype(np.float64)
                     for t in self.trees_]
            self._mono_p0 = cache
        return cache

    def predict_proba(self, X):
        """Mean of the per-tree leaf class distributions (float64): the
        normalized counts, or under ``monotonic_cst`` each tree's clipped
        ``[p0, 1 - p0]``."""
        self._check_fitted()
        X = validate_predict_data(X, self)
        p0 = self._clipped_p0() if self.mono_signs() is not None else None
        acc = np.zeros((X.shape[0], len(self.classes_)))
        for i, (t, leaf) in enumerate(zip(self.trees_, self._leaf_ids(X))):
            if p0 is not None:
                p = p0[i][leaf]
                acc += np.stack([p, 1.0 - p], axis=1)
            else:
                counts = t.count[leaf].astype(np.float64)
                acc += counts / np.maximum(
                    counts.sum(axis=1, keepdims=True), 1.0)
        return acc / len(self.trees_)

    def predict(self, X):
        idx = self.predict_proba(X).argmax(axis=1)
        return self.classes_[idx]


class RandomForestRegressor(RegressorBase, _BaseForest):
    """Bagged regression forest: the mean of the trees' exact leaf means.

    Parameters are those of ``mpitree_tpu.tree.RandomForestRegressor``,
    plus ``device``. The targets are centred on their float64 mean and
    cast to float32 for the moment histograms (the fixed-point route on
    the card); each tree's values are refit exactly in float64 from the
    float64 targets (``:1017-1027``).
    """

    def __init__(self, *, n_estimators=10, max_depth=None,
                 min_samples_split=2, max_bins=256, binning="auto",
                 bootstrap=True, max_features=None, max_features_mode="node",
                 oob_score=False, min_weight_fraction_leaf=0.0,
                 min_samples_leaf=1, random_state=None, n_devices=None,
                 backend=None, refine_depth="auto", checkpoint=None,
                 checkpoint_compact_every=None, ccp_alpha=0.0,
                 min_impurity_decrease=0.0, splitter="best",
                 monotonic_cst=None, warm_start=False, device=None):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.max_bins = max_bins
        self.binning = binning
        self.bootstrap = bootstrap
        self.max_features = max_features
        self.max_features_mode = max_features_mode
        self.oob_score = oob_score
        self.min_weight_fraction_leaf = min_weight_fraction_leaf
        self.min_samples_leaf = min_samples_leaf
        self.random_state = random_state
        self.n_devices = n_devices
        self.backend = backend
        self.refine_depth = refine_depth
        self.checkpoint = checkpoint
        self.checkpoint_compact_every = checkpoint_compact_every
        self.ccp_alpha = ccp_alpha
        self.min_impurity_decrease = min_impurity_decrease
        self.splitter = splitter
        self.monotonic_cst = monotonic_cst
        self.warm_start = warm_start
        self.device = device

    def fit(self, X=None, y=None, sample_weight=None, *, dataset=None):
        self._check_slice()
        if is_streamed(X, dataset):
            stream = self._open_stream(X, dataset, y)
            res = stream[0]
            y64, _ = validate_fit_targets(res.y, task="regression")
            self._y_mean = float(y64.mean()) if len(y64) else 0.0
            self.trees_ = self._fit_forest(
                None, (y64 - self._y_mean).astype(np.float32),
                task="regression", criterion="mse", refit_targets=y64,
                sample_weight=stream_weight(res, sample_weight),
                stream=stream,
            )
            self._set_fitted(res.binned.n_features)
            res.close()
            return self
        X, y64, _ = validate_fit_data(X, y, task="regression")
        sw = validate_sample_weight(sample_weight, X.shape[0])
        self._y_mean = float(y64.mean()) if len(y64) else 0.0
        self.trees_ = self._fit_forest(
            X, (y64 - self._y_mean).astype(np.float32), task="regression",
            criterion="mse", refit_targets=y64, sample_weight=sw,
        )
        self._set_fitted(X.shape[1])
        if self.oob_score:
            self._oob(X, y64)
        return self

    def _oob(self, X, y64) -> None:
        """Each row predicted by the trees whose bootstrap left it out."""
        pred = np.zeros(len(X))
        cnt = np.zeros(len(X))
        for t, ids, oob in zip(self.trees_, self._leaf_ids(X),
                               self._pop_oob_masks()):
            pred[oob] += t.count[ids[oob], 0]
            cnt[oob] += 1
        seen = cnt > 0
        if not seen.any():
            self.oob_score_ = self._warn_no_oob()
            self.oob_prediction_ = np.full(len(X), np.nan)
            return
        self._warn_partial_oob(seen)
        self.oob_prediction_ = np.where(seen, pred / np.maximum(cnt, 1),
                                        np.nan)
        resid = y64[seen] - self.oob_prediction_[seen]
        tot = y64[seen] - y64[seen].mean()
        self.oob_score_ = float(
            1.0 - (resid @ resid) / max(tot @ tot, 1e-300))

    def predict(self, X):
        """The float64 mean over the trees of each row's leaf mean."""
        self._check_fitted()
        X = validate_predict_data(X, self)
        acc = np.zeros(X.shape[0])
        for t, leaf in zip(self.trees_, self._leaf_ids(X)):
            acc += t.count[leaf, 0]
        return acc / len(self.trees_)


class ExtraTreesClassifier(RandomForestClassifier):
    """Extremely randomized classification forest (sklearn's ExtraTrees,
    ``:1057-1094``): ``splitter="random"`` (one keyed uniform pick among a
    node's valid bins per feature), ``bootstrap=False`` and
    ``max_features="sqrt"`` by default."""

    def __init__(self, *, n_estimators=10, criterion="entropy",
                 max_depth=None, min_samples_split=2, max_bins=256,
                 binning="auto", bootstrap=False, max_features="sqrt",
                 max_features_mode="node", oob_score=False, class_weight=None,
                 min_weight_fraction_leaf=0.0, min_samples_leaf=1,
                 random_state=None, n_devices=None, backend=None,
                 refine_depth="auto", checkpoint=None,
                 checkpoint_compact_every=None, ccp_alpha=0.0,
                 min_impurity_decrease=0.0, monotonic_cst=None,
                 warm_start=False, device=None):
        super().__init__(
            n_estimators=n_estimators, criterion=criterion,
            max_depth=max_depth, min_samples_split=min_samples_split,
            max_bins=max_bins, binning=binning, bootstrap=bootstrap,
            max_features=max_features, max_features_mode=max_features_mode,
            oob_score=oob_score, class_weight=class_weight,
            min_weight_fraction_leaf=min_weight_fraction_leaf,
            min_samples_leaf=min_samples_leaf, random_state=random_state,
            n_devices=n_devices, backend=backend, refine_depth=refine_depth,
            checkpoint=checkpoint,
            checkpoint_compact_every=checkpoint_compact_every,
            ccp_alpha=ccp_alpha,
            min_impurity_decrease=min_impurity_decrease, splitter="random",
            monotonic_cst=monotonic_cst, warm_start=warm_start,
            device=device,
        )


class ExtraTreesRegressor(RandomForestRegressor):
    """Extremely randomized regression forest (``:1096-1122``):
    ``splitter="random"``, ``bootstrap=False`` and ``max_features=1.0``
    by default."""

    def __init__(self, *, n_estimators=10, max_depth=None,
                 min_samples_split=2, max_bins=256, binning="auto",
                 bootstrap=False, max_features=1.0, max_features_mode="node",
                 oob_score=False, min_weight_fraction_leaf=0.0,
                 min_samples_leaf=1, random_state=None, n_devices=None,
                 backend=None, refine_depth="auto", checkpoint=None,
                 checkpoint_compact_every=None, ccp_alpha=0.0,
                 min_impurity_decrease=0.0, monotonic_cst=None,
                 warm_start=False, device=None):
        super().__init__(
            n_estimators=n_estimators, max_depth=max_depth,
            min_samples_split=min_samples_split, max_bins=max_bins,
            binning=binning, bootstrap=bootstrap, max_features=max_features,
            max_features_mode=max_features_mode, oob_score=oob_score,
            min_weight_fraction_leaf=min_weight_fraction_leaf,
            min_samples_leaf=min_samples_leaf, random_state=random_state,
            n_devices=n_devices, backend=backend, refine_depth=refine_depth,
            checkpoint=checkpoint,
            checkpoint_compact_every=checkpoint_compact_every,
            ccp_alpha=ccp_alpha,
            min_impurity_decrease=min_impurity_decrease, splitter="random",
            monotonic_cst=monotonic_cst, warm_start=warm_start,
            device=device,
        )
