"""Decision-tree classifier with the JAX package's estimator surface.

Counterpart of ``mpitree_tpu/models/classifier.py``: the same constructor
parameters (``:161-190``) plus ``device``, and the same fitted attributes
(``n_features_``, ``classes_``, ``tree_``). ``predict_proba`` returns the
reference's **raw class counts** (``:398-403``), ``predict`` their argmax.

Every fit runs the device engine (``core/builder.py``) on ``device``:
``None`` means ``"cuda"`` and raises when CUDA is missing; only an explicit
``device="cpu"`` runs the plain CPU path. sklearn is not a dependency:
``get_params``/``set_params`` read the ``__init__`` signature and ``score``
is the (weighted) mean accuracy.

Options that live off this slice's path raise ``NotImplementedError``
naming their ``ROADMAP.md`` item: ``max_leaf_nodes`` (leaf-wise growth),
``splitter="random"``/``max_features`` (sampling), ``class_weight``,
``ccp_alpha`` (pruning), ``monotonic_cst``, multi-device ``n_devices``,
``backend``, and an integer ``refine_depth`` (the hybrid refine tail).
``refine_depth="auto"`` resolves to a single device build, as the JAX
package does when its native tail is absent.
"""

from __future__ import annotations

import inspect

import numpy as np

from mpitree_tpu_torch._device import resolve_device
from mpitree_tpu_torch.core.builder import BuildConfig, build_tree
from mpitree_tpu_torch.core.tree_struct import TreeArrays
from mpitree_tpu_torch.ops.binning import bin_for_engine
from mpitree_tpu_torch.ops.predict import predict_leaf_ids
from mpitree_tpu_torch.utils.carry import tree_from_reference
from mpitree_tpu_torch.utils.export import export_tree_text
from mpitree_tpu_torch.utils.validation import (
    min_child_weight,
    min_decrease_scaled,
    resolve_refine,
    validate_fit_data,
    validate_predict_data,
    validate_sample_weight,
)


class NotFittedError(ValueError, AttributeError):
    """Raised by predict-time methods before ``fit`` (sklearn's contract)."""


# (parameter, value the slice supports, ROADMAP.md item that ports it)
_LATER = (
    ("max_leaf_nodes", None, "Queue 1 item 13 (leaf-wise growth)"),
    ("splitter", "best", "Queue 1 item 10 (ops/sampling.py)"),
    ("max_features", None, "Queue 1 item 10 (ops/sampling.py)"),
    ("class_weight", None, "Queue 1 item 9 (utils/validation.py class_weight)"),
    ("ccp_alpha", 0.0, "Queue 1 item 9 (utils/pruning.py)"),
    ("monotonic_cst", None, "Queue 1 item 10 (utils/monotonic.py)"),
    ("backend", None, "Queue 1 item 9 (host small-fit tier)"),
)


def refuse_later(est, later) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for the first
    ``(parameter, supported value, item)`` of ``later`` that ``est`` sets
    to anything else (``None`` supported means "must be None")."""
    for name, supported, item in later:
        value = getattr(est, name)
        if (value is not None) if supported is None else (
                value != supported):
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (ROADMAP.md {item})"
            )
    if est.n_devices not in (None, 1):
        raise NotImplementedError(
            f"n_devices={est.n_devices!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 14, multi-GPU)"
        )


class ClassifierBase:
    """The classifiers' shared surface without sklearn: ``get_params`` and
    ``set_params`` read the ``__init__`` signature; ``score`` is the
    (weighted) mean accuracy of ``predict``."""

    @classmethod
    def _param_names(cls) -> list:
        sig = inspect.signature(cls.__init__)
        return sorted(p.name for p in sig.parameters.values()
                      if p.name != "self")

    def get_params(self, deep=True) -> dict:
        return {k: getattr(self, k) for k in self._param_names()}

    def set_params(self, **params):
        valid = set(self._param_names())
        for k, v in params.items():
            if k not in valid:
                raise ValueError(
                    f"Invalid parameter {k!r} for estimator "
                    f"{type(self).__name__}. Valid parameters are: "
                    f"{sorted(valid)!r}."
                )
            setattr(self, k, v)
        return self

    def score(self, X, y, sample_weight=None) -> float:
        """Mean accuracy (weighted by ``sample_weight`` when given)."""
        hit = (self.predict(X) == np.asarray(y)).astype(np.float64)
        if sample_weight is None:
            return float(hit.mean())
        return float(np.average(hit, weights=np.asarray(sample_weight)))

    def _set_fitted(self, classes, n_features: int) -> None:
        self.classes_ = np.asarray(classes)
        self.n_classes_ = len(self.classes_)
        self.n_features_ = int(n_features)
        self.n_features_in_ = int(n_features)
        self.n_outputs_ = 1

    def _not_fitted(self):
        return NotFittedError(
            f"This {type(self).__name__} instance is not fitted yet. "
            "Call 'fit' with appropriate arguments before using this "
            "estimator."
        )


class DecisionTreeClassifier(ClassifierBase):
    """Decision-tree classifier (entropy or Gini) built on the GPU.

    Parameters are those of ``mpitree_tpu.tree.DecisionTreeClassifier``,
    plus ``device`` (``None`` = ``"cuda"``; ``"cpu"`` runs the plain
    versions of the kernels). See the module docstring for the options
    this slice refuses.
    """

    def __init__(self, *, max_depth=None, max_leaf_nodes=None,
                 min_samples_split=2,
                 criterion="entropy", splitter="best", max_bins=256,
                 binning="auto",
                 max_features=None, class_weight=None,
                 min_weight_fraction_leaf=0.0, min_samples_leaf=1,
                 random_state=None,
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
        self.class_weight = class_weight
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

    def _check_slice(self) -> None:
        refuse_later(self, _LATER)
        if self.criterion not in ("entropy", "gini"):
            raise ValueError(
                f"unknown classification criterion: {self.criterion!r}"
            )

    # -- fitting -----------------------------------------------------------
    def fit(self, X, y, sample_weight=None):
        self._check_slice()
        device = resolve_device(self.device)
        X, y_enc, classes = validate_fit_data(X, y)
        sw = validate_sample_weight(sample_weight, X.shape[0])
        rd, _refine, crown_depth = resolve_refine(
            self.max_depth, self.refine_depth, n_rows=X.shape[0],
        )
        if rd is not None:
            raise NotImplementedError(
                f"refine_depth={self.refine_depth!r}: the hybrid refine "
                "tail is not ported yet (ROADMAP.md Queue 1, the refine "
                "tail); use refine_depth='auto' or None"
            )
        binned = bin_for_engine(
            X, max_bins=self.max_bins, binning=self.binning, device=device
        )
        cfg = BuildConfig(
            criterion=self.criterion,
            max_depth=crown_depth,
            min_samples_split=self.min_samples_split,
            min_child_weight=min_child_weight(
                self.min_weight_fraction_leaf, sw, X.shape[0],
                self.min_samples_leaf,
            ),
            min_decrease_scaled=min_decrease_scaled(
                self.min_impurity_decrease, sw, X.shape[0]
            ),
        )
        self.tree_ = build_tree(
            binned, y_enc, config=cfg, n_classes=len(classes),
            sample_weight=sw,
        )
        self._set_fitted(classes, X.shape[1])
        return self

    @classmethod
    def from_reference(cls, arrays, classes, n_features: int, **params):
        """A fitted estimator from the JAX package's fitted tree:
        ``arrays`` as :func:`utils.carry.tree_from_reference` takes them,
        ``classes`` the reference's ``classes_``, ``n_features`` its
        ``n_features_``; ``params`` go to the constructor (``device``)."""
        est = cls(**params)
        est.tree_ = tree_from_reference(arrays)
        est._set_fitted(classes, n_features)
        return est

    # -- inference ---------------------------------------------------------
    def _check_fitted(self) -> None:
        if not isinstance(getattr(self, "tree_", None), TreeArrays):
            raise self._not_fitted()

    def _leaf_ids(self, X) -> np.ndarray:
        self._check_fitted()
        X = validate_predict_data(X, self)
        return predict_leaf_ids(X, self.tree_, resolve_device(self.device))

    def predict_proba(self, X):
        """Raw per-class leaf counts — the reference's quirk."""
        ids = self._leaf_ids(X)
        return self.tree_.count[ids]

    def apply(self, X):
        """The leaf index each sample lands in (int64)."""
        return self._leaf_ids(X).astype(np.int64)

    def predict(self, X):
        idx = self.predict_proba(X).argmax(axis=1)
        return self.classes_[idx]

    # -- introspection -----------------------------------------------------
    def export_text(self, *, feature_names=None, class_names=None,
                    precision=2):
        self._check_fitted()
        return export_tree_text(
            self.tree_, feature_names=feature_names, class_names=class_names,
            precision=precision,
        )

    def get_depth(self) -> int:
        self._check_fitted()
        return self.tree_.max_depth

    def get_n_leaves(self) -> int:
        self._check_fitted()
        return self.tree_.n_leaves
