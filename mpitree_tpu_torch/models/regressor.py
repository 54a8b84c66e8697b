"""Decision-tree regressor (squared error) with the JAX package's surface.

Counterpart of ``mpitree_tpu/models/regressor.py:60-350``: the same
constructor parameters plus ``device``, and the same fitted attributes. A
fit follows the JAX package's order (``:96-278``): binning, the refine
decision (``utils/validation.resolve_refine``), the build to the crown
depth, the hybrid refine tail and ``ccp_alpha`` pruning. The targets are
centred on their float64 mean and cast to float32 for the moment
histograms (``:177``); every node's value is then refit exactly in float64
from the rows' final nodes, so ``predict`` returns exact leaf means
(``count[leaf, 0]``).

- ``backend=None`` runs the device engine (task ``"regression"``; fused,
  or levelwise under ``MPITREE_TPU_ENGINE=levelwise``: the same tree) on
  ``device`` (``None`` means ``"cuda"``; only an
  explicit ``device="cpu"`` runs the plain CPU path). Its moment
  histograms take the fixed-point route (``ops/hist_kernel.py``): exact,
  order-independent int64 sums, so the card's tree equals the CPU's.
- ``backend="host"`` runs the host tier (the C++ regression sweep, else
  numpy), as the JAX package's ``backend="host"``.

``max_features`` and ``splitter="random"`` sample per node as in the
classifier (``ops/sampling.sampler_for``, the JAX package's ``:178-183``).
``monotonic_cst`` gates every split on its child means, builds the whole
depth in one engine (``:149-153``) and clips the exact leaf means in
``count[:, 0]`` into their bounds (``:269-272``), which ``predict``
returns. ``decision_path``, ``export_dot`` and ``nodes_`` as in the
classifier.

``max_leaf_nodes`` grows the tree best-first (``core/leafwise_builder.py``)
in one engine with no refine tail; ``backend="host"`` refuses it.
``n_devices`` builds on a data mesh, or a ``(dr, df)`` ``(data,
feature)`` mesh, as in the classifier: the moments take the fixed-point
route with exponents from every row's payload and the global row count,
so the int64 sums add across shards and processes and the tree equals
the one-device tree field for field. ``fit(dataset=StreamedDataset...)``
fits from a chunk stream as the classifier does (``models/_streamed.py``).
"""

from __future__ import annotations

import numpy as np

from mpitree_tpu_torch._device import resolve_device
from mpitree_tpu_torch.core.builder import BuildConfig
from mpitree_tpu_torch.core.tree_struct import TreeArrays
from mpitree_tpu_torch.models._streamed import is_streamed, streamed_fit
from mpitree_tpu_torch.models.classifier import (
    EstimatorBase,
    FitClock,
    fit_mesh,
    grow_tree,
    host_tier,
    predict_mesh,
)
from mpitree_tpu_torch.ops.binning import bin_dataset, bin_for_engine
from mpitree_tpu_torch.ops.predict import predict_leaf_ids
from mpitree_tpu_torch.ops.sampling import sampler_for
from mpitree_tpu_torch.utils.carry import tree_from_reference
from mpitree_tpu_torch.utils.export import (
    export_tree_dot,
    export_tree_text,
    tree_decision_path,
)
from mpitree_tpu_torch.utils.importances import feature_importances
from mpitree_tpu_torch.utils.monotonic import validate_monotonic_cst
from mpitree_tpu_torch.utils.profiling import debug_checks_enabled
from mpitree_tpu_torch.utils.pruning import pruning_path_for
from mpitree_tpu_torch.utils.validation import (
    min_child_weight,
    min_decrease_scaled,
    resolve_refine,
    validate_fit_data,
    validate_max_leaf_nodes,
    validate_predict_data,
    validate_sample_weight,
)


class RegressorBase(EstimatorBase):
    """The regressors' shared surface: ``score`` is the (weighted) R^2 of
    ``predict``."""

    _task = "regression"

    def score(self, X, y, sample_weight=None) -> float:
        """R^2 of ``predict`` (weighted by ``sample_weight`` when given),
        sklearn's ``r2_score``: 1.0 for a perfect fit, and for a constant
        ``y`` 1.0 when predicted exactly, else 0.0."""
        y = np.asarray(y, np.float64).ravel()
        w = (np.ones_like(y) if sample_weight is None
             else np.asarray(sample_weight, np.float64))
        resid = float(np.sum(w * (y - self.predict(X)) ** 2))
        total = float(np.sum(w * (y - np.average(y, weights=w)) ** 2))
        if total == 0.0:
            return 1.0 if resid == 0.0 else 0.0
        return 1.0 - resid / total

    def _set_fitted(self, n_features: int) -> None:
        self.n_features_ = int(n_features)
        self.n_features_in_ = int(n_features)
        self.n_outputs_ = 1


class DecisionTreeRegressor(RegressorBase):
    """Regression tree (squared-error criterion) built on the GPU.

    Parameters are those of ``mpitree_tpu.tree.DecisionTreeRegressor``
    (``criterion`` "squared_error" or its alias "mse"), plus ``device``
    (``None`` = ``"cuda"``; ``"cpu"`` runs the plain versions of the
    kernels). See the module docstring for the options this slice
    refuses.
    """

    def __init__(self, *, max_depth=None, max_leaf_nodes=None,
                 min_samples_split=2,
                 criterion="squared_error", splitter="best", max_bins=256,
                 binning="auto",
                 max_features=None, min_weight_fraction_leaf=0.0,
                 min_samples_leaf=1, random_state=None,
                 n_devices=None, backend=None, refine_depth="auto",
                 ccp_alpha=0.0, min_impurity_decrease=0.0,
                 monotonic_cst=None, device=None):
        self.max_depth = max_depth
        self.max_leaf_nodes = max_leaf_nodes
        self.min_samples_split = min_samples_split
        self.criterion = criterion
        self.splitter = splitter
        self.max_bins = max_bins
        self.binning = binning
        self.max_features = max_features
        self.min_weight_fraction_leaf = min_weight_fraction_leaf
        self.min_samples_leaf = min_samples_leaf
        self.random_state = random_state
        self.n_devices = n_devices
        self.backend = backend
        self.refine_depth = refine_depth
        self.ccp_alpha = ccp_alpha
        self.min_impurity_decrease = min_impurity_decrease
        self.monotonic_cst = monotonic_cst
        self.device = device

    # -- fitting -----------------------------------------------------------
    def fit(self, X=None, y=None, sample_weight=None, *, dataset=None):
        if is_streamed(X, dataset):
            return streamed_fit(self, X, dataset, y, sample_weight)
        if self.criterion not in ("squared_error", "mse"):
            raise ValueError(
                f"unknown regression criterion: {self.criterion!r}")
        host = host_tier(self.backend)
        mesh = fit_mesh(self, host)
        device = resolve_device(self.device) if mesh is None else mesh.lead
        X, y64, _ = validate_fit_data(X, y, task="regression")
        mono = validate_monotonic_cst(self.monotonic_cst, X.shape[1],
                                      task="regression")
        mln = validate_max_leaf_nodes(self)
        sw = validate_sample_weight(sample_weight, X.shape[0])
        self._y_mean = float(y64.mean())
        clock = FitClock(device)
        binned = (
            bin_dataset(X, max_bins=self.max_bins, binning=self.binning)
            if host else bin_for_engine(
                X, max_bins=self.max_bins, binning=self.binning,
                device=device,
            )
        )
        stats = {"bin_seconds": clock.lap()}
        rd, refine, crown_depth = resolve_refine(
            self.max_depth, self.refine_depth,
            n_rows=X.shape[0], quantized=binned.quantized,
        )
        if mono is not None or mln is not None:
            # one engine for the whole depth (no tail past the leaf budget)
            rd, refine, crown_depth = None, False, self.max_depth
        cfg = BuildConfig(
            task="regression",
            criterion="mse",
            max_depth=crown_depth,
            max_leaf_nodes=mln,
            min_samples_split=self.min_samples_split,
            min_child_weight=min_child_weight(
                self.min_weight_fraction_leaf, sw, X.shape[0],
                self.min_samples_leaf,
            ),
            min_decrease_scaled=min_decrease_scaled(
                self.min_impurity_decrease, sw, X.shape[0]
            ),
            debug=debug_checks_enabled(),
        )
        y_c = (y64 - self._y_mean).astype(np.float32)
        self.tree_ = grow_tree(
            binned, X, y_c, host=host, cfg=cfg, max_depth=self.max_depth,
            rd=rd, refine=refine, n_classes=None, sample_weight=sw,
            ccp_alpha=self.ccp_alpha, clock=clock, stats=stats,
            refit_targets=y64,
            feature_sampler=sampler_for(self.max_features, self.random_state,
                                        X.shape[1], splitter=self.splitter),
            mono_cst=mono, mesh=mesh, what=f"{type(self).__name__}.fit",
            host_binned=lambda: bin_dataset(X, max_bins=self.max_bins,
                                            binning=self.binning),
        )
        self.fit_stats_ = stats
        self._set_fitted(X.shape[1])
        return self

    def cost_complexity_pruning_path(self, X, y, sample_weight=None):
        """sklearn's diagnostic: the effective alphas and total leaf
        impurities along the minimal cost-complexity pruning path of an
        unpruned fit (``utils/pruning.py``; node weights are row
        counts)."""
        return pruning_path_for(self, X, y, sample_weight=sample_weight)

    @classmethod
    def from_reference(cls, arrays, n_features: int, **params):
        """A fitted estimator from the JAX package's fitted regression
        tree: ``arrays`` as :func:`utils.carry.tree_from_reference` takes
        them, ``n_features`` its ``n_features_``; ``params`` go to the
        constructor (``device``)."""
        est = cls(**params)
        est.tree_ = tree_from_reference(arrays, task="regression")
        est._set_fitted(n_features)
        return est

    # -- inference ---------------------------------------------------------
    def _check_fitted(self) -> None:
        if not isinstance(getattr(self, "tree_", None), TreeArrays):
            raise self._not_fitted()

    def _leaf_ids(self, X) -> np.ndarray:
        self._check_fitted()
        X = validate_predict_data(X, self)
        mesh = predict_mesh(self)
        return predict_leaf_ids(
            X, self.tree_, resolve_device(self.device) if mesh is None
            else mesh.lead, mesh=mesh)

    def predict(self, X):
        """The exact float64 mean of each row's leaf (``count[:, 0]``)."""
        ids = self._leaf_ids(X)
        return self.tree_.count[ids, 0]

    def apply(self, X):
        """The leaf index each sample lands in (int64)."""
        return self._leaf_ids(X).astype(np.int64)

    def decision_path(self, X):
        """sklearn's ``decision_path``: the (n_samples, n_nodes) CSR
        indicator of the nodes each sample passes (``scipy.sparse``)."""
        return tree_decision_path(self.tree_, self._leaf_ids(X))

    # -- introspection -----------------------------------------------------
    def export_text(self, *, feature_names=None, precision=2):
        self._check_fitted()
        return export_tree_text(
            self.tree_, feature_names=feature_names, precision=precision,
            task="regression",
        )

    def export_dot(self, *, feature_names=None, precision=2):
        """Graphviz source of the fitted tree (``utils/export.py``)."""
        self._check_fitted()
        return export_tree_dot(
            self.tree_, feature_names=feature_names, precision=precision,
            task="regression", n_features=self.n_features_,
        )

    @property
    def nodes_(self):
        """The reference's linked ``Node`` view of the fitted tree (its
        root; ``TreeArrays.to_nodes``)."""
        self._check_fitted()
        return self.tree_.to_nodes()

    @property
    def feature_importances_(self) -> np.ndarray:
        """Normalized total variance decrease per feature (sklearn's)."""
        self._check_fitted()
        return feature_importances(self.tree_, self.n_features_,
                                   task="regression")

    def get_depth(self) -> int:
        self._check_fitted()
        return self.tree_.max_depth

    def get_n_leaves(self) -> int:
        self._check_fitted()
        return self.tree_.n_leaves
