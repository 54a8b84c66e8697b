"""Bagged random forest classifier, built tree by tree on the GPU.

Counterpart of ``RandomForestClassifier`` in ``mpitree_tpu/models/
forest.py`` on its per-tree device route (``_fit_forest``, ``:272-765``;
``build_one_device``, ``:533-576``), bagging only:

- the matrix is binned once (``ops/binning.bin_for_engine``), its
  byte-wide copy for the histogram kernels is made once, and every
  tree is built by the levelwise engine (``core/builder.build_tree``) on
  that one device-resident binned matrix;
- the bootstrap draws are the JAX package's, in the same order:
  ``rng = np.random.default_rng(random_state)``, then per tree
  ``rng.multinomial(n, np.full(n, 1/n))`` as float32 multiplicities
  (``:309, 445-458``), times any user ``sample_weight``. They are integers,
  so the card's histograms sum them exactly;
- each tree's leaf floors read its own composed weights (``tree_cfg``,
  ``:388-405``);
- each tree is finished as the JAX package's ``finish`` does it
  (``:495-515``): the refine tail with that tree's composed weights when
  ``resolve_refine`` engages it (``:358-361``), then ``ccp_alpha``
  pruning; ``backend="host"`` builds every tree on the host tier from one
  host binning (``host_raw``, ``:519-528``);
- ``predict_proba`` descends all trees at once over the flat serving table
  (``ops/predict.stacked_leaf_ids``) and then runs the JAX package's host
  float64 loop, ``acc += counts / max(rowsum, 1)`` in tree order, ``/ T``
  (``:924-962``); ``predict`` is its argmax.

``trees_`` is a :class:`~mpitree_tpu_torch.serving.tables.TreeList`,
which carries the flat table that predict and ``compile_model`` share.

``fit_stats_`` sums the phase seconds and tail counts over the trees and
names the ``engine`` (see ``models/classifier.py``). A fractional
``sample_weight`` composes into fractional tree weights, which the card
sums on the histogram's fixed-point route.

Options off this path raise ``NotImplementedError`` naming their
``ROADMAP.md`` item: ``max_features`` other than ``None``,
``splitter="random"``, ``oob_score``, ``class_weight``, ``checkpoint``,
``warm_start``, ``monotonic_cst``, ``n_devices > 1`` and ``dataset=``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpitree_tpu_torch._device import resolve_device
from mpitree_tpu_torch.core.builder import BuildConfig, pack_for_fit
from mpitree_tpu_torch.models.classifier import (
    ClassifierBase,
    FitClock,
    grow_tree,
    host_tier,
    refuse_later,
)
from mpitree_tpu_torch.ops.binning import bin_dataset, bin_for_engine
from mpitree_tpu_torch.ops.predict import stacked_leaf_ids
from mpitree_tpu_torch.serving.tables import TreeList
from mpitree_tpu_torch.utils.carry import forest_from_reference
from mpitree_tpu_torch.utils.validation import (
    min_child_weight,
    min_decrease_scaled,
    resolve_refine,
    validate_fit_data,
    validate_predict_data,
    validate_sample_weight,
)

# (parameter, value the slice supports, ROADMAP.md item that ports it)
_LATER = (
    ("max_features", None, "Queue 1 item 10 (ops/sampling.py)"),
    ("splitter", "best", "Queue 1 item 10 (ops/sampling.py)"),
    ("oob_score", False, "Queue 1 item 11 (forest oob_score)"),
    ("class_weight", None, "Queue 1 item 11 (forest class_weight)"),
    ("checkpoint", None, "Queue 1 item 17 (resilience/checkpoint.py)"),
    ("checkpoint_compact_every", None,
     "Queue 1 item 17 (resilience/checkpoint.py)"),
    ("warm_start", False, "Queue 1 item 11 (forest warm_start)"),
    ("monotonic_cst", None, "Queue 1 item 10 (utils/monotonic.py)"),
)


class RandomForestClassifier(ClassifierBase):
    """Bagged classification forest (soft voting over per-tree class
    distributions).

    Parameters are those of ``mpitree_tpu.tree.RandomForestClassifier``,
    plus ``device`` (``None`` = ``"cuda"``; ``"cpu"`` runs the plain
    versions of the kernels). See the module docstring for the options
    this slice refuses.
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

    def _check_slice(self) -> None:
        refuse_later(self, _LATER)
        if self.criterion not in ("entropy", "gini"):
            raise ValueError(
                f"unknown classification criterion: {self.criterion!r}"
            )
        if self.max_features_mode not in ("node", "tree"):
            raise ValueError(
                f"max_features_mode must be 'node' or 'tree', "
                f"got {self.max_features_mode!r}"
            )
        if int(self.n_estimators) < 1:
            raise ValueError(
                f"n_estimators must be >= 1, got {self.n_estimators!r}"
            )

    # -- fitting -----------------------------------------------------------
    def fit(self, X, y, sample_weight=None, *, dataset=None):
        if dataset is not None:
            raise NotImplementedError(
                "fit(dataset=...) is not ported yet (ROADMAP.md Queue 1 "
                "item 16, streaming)"
            )
        self._check_slice()
        host = host_tier(self.backend)
        device = resolve_device(self.device)
        X, y_enc, classes = validate_fit_data(X, y)
        n = X.shape[0]
        sample_weight = validate_sample_weight(sample_weight, n)
        clock = FitClock(device)
        if host:
            binned = bin_dataset(X, max_bins=self.max_bins,
                                 binning=self.binning)
            packed = None
        else:
            binned = bin_for_engine(X, max_bins=self.max_bins,
                                    binning=self.binning, device=device)
            packed = pack_for_fit(binned)  # once, next to the one binning
        stats = {"bin_seconds": clock.lap()}
        rd, refine, crown_depth = resolve_refine(
            self.max_depth, self.refine_depth,
            n_rows=n, quantized=binned.quantized,
        )
        cfg = BuildConfig(criterion=self.criterion, max_depth=crown_depth,
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

        # Every draw up front, in the JAX package's order.
        rng = np.random.default_rng(self.random_state)
        tree_w = []
        for _ in range(int(self.n_estimators)):
            w = sample_weight
            if self.bootstrap:
                boot = rng.multinomial(n, np.full(n, 1.0 / n)).astype(
                    np.float32)
                w = boot if w is None else boot * w
            tree_w.append(w)

        self.trees_ = TreeList(
            grow_tree(
                binned, X, y_enc, host=host, cfg=tree_cfg(w),
                max_depth=self.max_depth, rd=rd, refine=refine,
                n_classes=len(classes), sample_weight=w,
                ccp_alpha=self.ccp_alpha, clock=clock, stats=stats,
                packed=packed,
            )
            for w in tree_w
        )
        self.fit_stats_ = stats
        self._set_fitted(classes, X.shape[1])
        return self

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
    def _check_fitted(self) -> None:
        if not isinstance(getattr(self, "trees_", None), TreeList):
            raise self._not_fitted()

    def predict_proba(self, X):
        """Mean of the per-tree leaf class distributions (float64)."""
        self._check_fitted()
        X = validate_predict_data(X, self)
        ids = stacked_leaf_ids(self.trees_, X, resolve_device(self.device))
        acc = np.zeros((X.shape[0], len(self.classes_)))
        for t, leaf in zip(self.trees_, ids):
            counts = t.count[leaf].astype(np.float64)
            acc += counts / np.maximum(counts.sum(axis=1, keepdims=True), 1.0)
        return acc / len(self.trees_)

    def predict(self, X):
        idx = self.predict_proba(X).argmax(axis=1)
        return self.classes_[idx]
