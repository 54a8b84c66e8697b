"""Input validation for the estimators, without sklearn.

Counterpart of ``mpitree_tpu/utils/validation.py``. The JAX package
validates with sklearn's ``check_X_y``/``check_array`` and weighs classes
with sklearn's ``compute_sample_weight``; the port runs where sklearn is
not installed, so what it needs is written here, with sklearn's wording
and exception types: numeric 2-D X with at least one row and one
feature, finite values (sparse and complex input refused, 1-D X told to
reshape), 1-D y of matching length (a column vector is raveled with a
``DataConversionWarning``) with discrete labels, encoded against
``classes_`` (for ``0..C-1`` integer labels the encoding is the identity,
as in the reference), or finite float64 regression targets;
``class_weight`` as sklearn computes it; the fitted attributes
``feature_names_in_``, ``n_outputs_``, ``n_classes_`` and
``max_features_`` (:func:`record_sklearn_attributes`) and the predict-time
feature-name checks.

:class:`NotFittedError` and :class:`DataConversionWarning` are the port's
own. Where the caller has imported sklearn, :func:`sklearn_flavoured`
raises or warns with a subclass of both the port's class and sklearn's, so
sklearn's checks recognise it; the port never imports sklearn itself.
"""

from __future__ import annotations

import numbers
import sys
import warnings

import numpy as np

from mpitree_tpu_torch import native
from mpitree_tpu_torch.ops.sampling import n_subspace_features


class NotFittedError(ValueError, AttributeError):
    """Raised by predict-time methods before ``fit`` (sklearn's contract)."""


class DataConversionWarning(UserWarning):
    """Warns that input data was converted: a column-vector ``y``."""


_FLAVOURED: dict = {}


def sklearn_flavoured(cls):
    """``cls``, or, when ``sklearn.exceptions`` is already imported, one
    subclass of both ``cls`` and sklearn's class of its name (made once,
    then cached), so that sklearn's ``except`` clauses and warning filters
    recognise what the port raises. Never imports sklearn."""
    base = getattr(sys.modules.get("sklearn.exceptions"), cls.__name__,
                   None)
    if not isinstance(base, type) or issubclass(cls, base):
        return cls
    key = (cls, base)
    if key not in _FLAVOURED:
        _FLAVOURED[key] = type(cls.__name__, (cls, base), {
            "__module__": cls.__module__, "__doc__": cls.__doc__})
    return _FLAVOURED[key]


def feature_names_of(X):
    """sklearn's ``feature_names_in_`` source, duck-typed on ``.columns``
    (a DataFrame's): all-string column names as an object array, None
    otherwise; mixed string and non-string names raise sklearn's
    TypeError."""
    cols = getattr(X, "columns", None)
    if cols is None:
        return None
    names = np.asarray(cols, dtype=object)
    str_mask = [isinstance(c, str) for c in names]
    if all(str_mask):
        return names
    if any(str_mask):
        raise TypeError(
            "Feature names are only supported if all input features have "
            "string names, but your input has mixed types."
        )
    return None


def record_sklearn_attributes(est, names, n_features, *,
                              n_classes=None) -> None:
    """The sklearn fitted attributes, as the JAX package's
    ``record_sklearn_attributes`` (``:73``) sets them: ``feature_names_in_``
    on a fit with names, deleted on one without; ``n_outputs_`` (always
    1); ``n_classes_`` (classifiers); and, for estimators with a
    ``max_features`` parameter, ``max_features_``, its grammar resolved to
    a count (``ops/sampling.n_subspace_features``)."""
    if names is not None:
        est.feature_names_in_ = names
    elif hasattr(est, "feature_names_in_"):
        del est.feature_names_in_
    est.n_outputs_ = 1
    if n_classes is not None:
        est.n_classes_ = n_classes
    if hasattr(est, "max_features"):
        est.max_features_ = n_subspace_features(est.max_features, n_features)


def _is_sparse(X) -> bool:
    """A scipy sparse matrix or array, known by its methods (scipy is not
    imported)."""
    return (isinstance(getattr(X, "format", None), str)
            and callable(getattr(X, "toarray", None))
            and callable(getattr(X, "tocsr", None)))


def _as_float_matrix(X, what: str = "X") -> np.ndarray:
    if _is_sparse(X):
        raise TypeError(
            "Sparse data was passed for X, but dense data is required. "
            "Use '.toarray()' to convert to a dense numpy array."
        )
    arr = np.asarray(X)
    if arr.dtype.kind == "c":
        raise ValueError(f"Complex data not supported\n{arr}\n")
    if arr.dtype == object or arr.dtype.kind in "USV":
        try:
            arr = arr.astype(np.float64)
        except ValueError as e:
            raise ValueError(
                f"{what} must be numeric; got dtype {arr.dtype} ({e})"
            ) from e
        except TypeError as e:  # a cell float() refuses: sklearn's type
            raise TypeError(
                f"{what} must be numeric; got dtype {arr.dtype} ({e})"
            ) from e
    elif arr.dtype.kind not in "biuf":
        raise ValueError(f"{what} must be numeric; got dtype {arr.dtype}")
    if arr.ndim in (0, 1):
        raise ValueError(
            f"Expected 2D array, got "
            f"{'scalar' if arr.ndim == 0 else '1D'} array instead:\n"
            f"array={arr}.\nReshape your data either using "
            "array.reshape(-1, 1) if your data has a single feature or "
            "array.reshape(1, -1) if it contains a single sample."
        )
    if arr.ndim != 2:
        raise ValueError(
            f"Expected 2D array, got {arr.ndim}D array instead: {what} has "
            f"shape {arr.shape}"
        )
    if arr.shape[0] < 1:
        raise ValueError(
            f"Found array with 0 sample(s) (shape={arr.shape}) while a "
            "minimum of 1 is required."
        )
    if arr.shape[1] < 1:
        raise ValueError(
            f"Found array with 0 feature(s) (shape={arr.shape}) while a "
            "minimum of 1 is required."
        )
    if not np.isfinite(arr).all():
        raise ValueError(f"Input {what} contains NaN or infinity.")
    return np.ascontiguousarray(arr, dtype=np.float32)


def validate_fit_data(X, y, *, task: str = "classification"):
    """Returns (X float32 (N, F), y, classes_): y encoded int32 (N,) and
    the classes, or for ``task="regression"`` float64 targets and None.
    ``y=None`` raises, and a column vector ``(N, 1)`` is raveled with a
    ``DataConversionWarning``, as sklearn's ``check_X_y`` does."""
    if y is None:
        raise ValueError(
            "estimator requires y to be passed, but the target y is None"
        )
    X = _as_float_matrix(X)
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        warnings.warn(
            sklearn_flavoured(DataConversionWarning)(
                "A column-vector y was passed when a 1d array was "
                "expected. Please change the shape of y to (n_samples, ), "
                "for example using ravel()."),
            stacklevel=3,
        )
        y = y[:, 0]
    if y.ndim != 1:
        raise ValueError(
            f"y should be a 1d array, got an array of shape {y.shape} "
            "instead."
        )
    if y.shape[0] != X.shape[0]:
        raise ValueError(
            "Found input variables with inconsistent numbers of samples: "
            f"[{X.shape[0]}, {y.shape[0]}]"
        )
    y_enc, classes = validate_fit_targets(y, task=task)
    return X, y_enc, classes


def validate_fit_targets(y, *, task: str = "classification"):
    """(y_encoded, classes_ or None), the target half of
    :func:`validate_fit_data` (``validate_fit_targets``,
    ``mpitree_tpu/utils/validation.py:52``): 1-D discrete labels encoded
    against their sorted classes, or finite float64 regression targets.
    Callers that need two classes (boosting) check ``len(classes_)``."""
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError(f"y must be 1-D, got shape {y.shape}")
    if task == "regression":
        # float64 on the host: the estimator centres in float64 and casts
        # to float32 only for the moments; leaves are refit in float64
        try:
            y64 = np.ascontiguousarray(y, dtype=np.float64)
        except (TypeError, ValueError) as e:
            raise ValueError(f"regression targets must be numeric ({e})") \
                from e
        if not np.isfinite(y64).all():
            raise ValueError("regression targets must be finite")
        return y64, None
    if y.dtype.kind == "f":
        if not np.isfinite(y).all():
            raise ValueError("Input y contains NaN or infinity.")
        if not np.array_equal(y, np.round(y)):
            raise ValueError(
                "Unknown label type: continuous. Classification targets "
                "must be discrete"
            )
    classes, y_enc = np.unique(y, return_inverse=True)
    return y_enc.astype(np.int32), classes


def validate_max_leaf_nodes(est):
    """An estimator's ``max_leaf_nodes`` -> an int budget or None
    (``mpitree_tpu/utils/validation.py:327``): sklearn's grammar (None or
    an int > 1); ``backend="host"`` cannot grow best-first and raises, as
    does a ``(dr, df)`` mesh request with ``df > 1`` (``:349-359``)."""
    mln = getattr(est, "max_leaf_nodes", None)
    if mln is None:
        return None
    mln = int(mln)
    if mln < 2:
        raise ValueError(
            f"max_leaf_nodes {mln} must be either None or larger than 1"
        )
    if getattr(est, "backend", None) == "host":
        raise ValueError(
            "max_leaf_nodes requires a device engine (the host tier grows "
            "level-wise only); drop backend='host'"
        )
    nd = getattr(est, "n_devices", None)
    if isinstance(nd, (tuple, list)) and len(nd) == 2 and int(nd[1]) > 1:
        raise ValueError(
            "max_leaf_nodes supports 1-D data meshes only "
            f"(mesh2d_unsupported: n_devices={tuple(nd)!r} requests "
            f"{int(nd[1])} feature shards, and the best-first frontier "
            "has no feature-axis select_global twin)"
        )
    return mln


def validate_sample_weight(sample_weight, n_samples: int):
    if sample_weight is None:
        return None
    w = np.asarray(sample_weight, dtype=np.float32)
    if w.shape != (n_samples,):
        raise ValueError(
            f"sample_weight has shape {w.shape}, expected ({n_samples},)"
        )
    if (w < 0).any() or not np.isfinite(w).all():
        raise ValueError("sample_weight must be finite and non-negative")
    if n_samples and not (w > 0).any():
        raise ValueError("sample_weight is all zero: nothing to fit")
    return w


def compute_sample_weight(class_weight, y) -> np.ndarray:
    """sklearn's ``compute_sample_weight(class_weight, y)`` for one output,
    in float64: ``"balanced"`` weighs class ``c`` by ``n / (n_classes *
    count_c)``; a dict maps original labels to weights, labels it does not
    name weigh 1, and a key that names no class raises; None weighs every
    row 1. As in sklearn, a label is looked up as ``int(label)`` wherever
    ``int()`` takes it (strings of digits and non-integral floats
    included), else as ``str(label)``."""
    y = np.asarray(y)
    classes = np.unique(y)
    if class_weight is None or (isinstance(class_weight, dict)
                                and not class_weight):
        weight = np.ones(len(classes))
    elif isinstance(class_weight, str) and class_weight == "balanced":
        counts = np.bincount(np.searchsorted(classes, y),
                             minlength=len(classes)).astype(np.float64)
        weight = counts.sum() / (len(classes) * counts)
    elif isinstance(class_weight, dict):
        weight = np.ones(len(classes))
        unweighted = []
        for i, c in enumerate(classes):
            try:
                key = int(c)
            except ValueError:  # string labels
                key = str(c)
            if key in class_weight:
                weight[i] = class_weight[key]
            else:
                unweighted.append(key)
        if unweighted and len(classes) - len(unweighted) != len(
                class_weight):
            raise ValueError(
                f"The classes, {unweighted}, are not in class_weight")
    else:
        raise ValueError(
            "class_weight must be 'balanced', a dict or None, got "
            f"{class_weight!r}")
    return weight[np.searchsorted(classes, y)]


def apply_class_weight(class_weight, y_enc, classes, sample_weight):
    """``class_weight`` composed into per-sample weights, as
    ``apply_class_weight`` (``mpitree_tpu/utils/validation.py:187``) does
    it: float32 :func:`compute_sample_weight` over the original labels,
    times ``sample_weight`` when given; ``sample_weight`` unchanged when
    ``class_weight`` is None."""
    if class_weight is None:
        return sample_weight
    try:
        cw = compute_sample_weight(
            class_weight, np.asarray(classes)[y_enc]).astype(np.float32)
    except (ValueError, TypeError) as e:
        raise ValueError(f"invalid class_weight: {e}") from e
    return cw if sample_weight is None else cw * sample_weight


def resolve_min_samples_leaf(min_samples_leaf, n_samples: int) -> int:
    """sklearn's ``min_samples_leaf`` grammar -> a row count (int >= 1)."""
    if isinstance(min_samples_leaf, numbers.Real) and not isinstance(
        min_samples_leaf, numbers.Integral
    ):
        if not 0.0 < min_samples_leaf < 1.0:
            raise ValueError(
                f"float min_samples_leaf must be in (0, 1), "
                f"got {min_samples_leaf!r}"
            )
        return int(np.ceil(min_samples_leaf * n_samples))
    msl = int(min_samples_leaf)
    if msl != min_samples_leaf or msl < 1:
        raise ValueError(
            f"int min_samples_leaf must be a positive integer, "
            f"got {min_samples_leaf!r}"
        )
    return msl


def min_child_weight(min_weight_fraction_leaf, sample_weight, n_samples,
                     min_samples_leaf=1):
    """sklearn's leaf floors -> one absolute per-child weight floor (the
    max of the fraction of total fit weight and the sample count)."""
    frac = float(min_weight_fraction_leaf)
    if not 0.0 <= frac <= 0.5:
        raise ValueError(
            f"min_weight_fraction_leaf must be in [0, 0.5], got {frac!r}"
        )
    msl = resolve_min_samples_leaf(min_samples_leaf, n_samples)
    floor = 0.0 if msl == 1 else float(msl)
    if frac > 0.0:
        total = float(n_samples) if sample_weight is None else float(
            np.sum(sample_weight)
        )
        floor = max(floor, frac * total)
    return floor


def min_decrease_scaled(min_impurity_decrease, sample_weight, n_samples):
    """sklearn's ``min_impurity_decrease`` pre-scaled by the total fit
    weight: the builder compares ``n_t * (imp_t - cost_t)`` against it."""
    d = float(min_impurity_decrease)
    if d < 0.0:
        raise ValueError(
            f"min_impurity_decrease must be >= 0, got {min_impurity_decrease!r}"
        )
    if d == 0.0:
        return 0.0
    total = (
        float(n_samples) if sample_weight is None
        else float(np.sum(sample_weight))
    )
    return d * total


def validate_predict_data(X, estimator):
    """Numeric finite (N, F) float32 with the fitted feature count, after
    sklearn's feature-name checks (``mpitree_tpu/utils/validation.py:
    210-257``): names on both sides that differ raise ValueError, names on
    one side only warn (UserWarning), mixed-type names raise TypeError."""
    name = type(estimator).__name__
    fitted_names = getattr(estimator, "feature_names_in_", None)
    pred_names = feature_names_of(X)
    if fitted_names is not None and pred_names is not None:
        if list(pred_names) != list(fitted_names):
            raise ValueError(
                "The feature names should match those that were passed "
                "during fit.\n"
                f"Feature names seen at fit time: {list(fitted_names)}\n"
                f"Feature names seen now: {list(pred_names)}"
            )
    elif fitted_names is not None:
        warnings.warn(
            f"X does not have valid feature names, but {name} was fitted "
            "with feature names",
            stacklevel=2,
        )
    elif pred_names is not None:
        warnings.warn(
            f"X has feature names, but {name} was fitted without feature "
            "names",
            stacklevel=2,
        )
    X = _as_float_matrix(X)
    n_features = estimator.n_features_
    if X.shape[1] != n_features:
        raise ValueError(
            f"X has {X.shape[1]} features, but {name} "
            f"is expecting {n_features} features as input."
        )
    return X


def validate_refine_depth(refine_depth):
    """None, ``"auto"``, or an exact int >= 0."""
    if refine_depth is None:
        return None
    if isinstance(refine_depth, str):
        if refine_depth == "auto":
            return "auto"
        raise ValueError(
            f"refine_depth must be None, 'auto', or a non-negative "
            f"integer, got {refine_depth!r}"
        )
    rd = int(refine_depth)
    if rd != refine_depth or rd < 0:
        raise ValueError(
            f"refine_depth must be None, 'auto', or a non-negative "
            f"integer, got {refine_depth!r}"
        )
    return rd


# Crown leaves of about this many rows are where the hybrid crossover
# pays: small enough for exact local candidates on the host, large enough
# that the card still amortizes the levels above.
_AUTO_REFINE_LEAF_ROWS = 2048


def resolve_refine(max_depth, refine_depth, *, n_rows=None, quantized=True):
    """``(rd, refine, crown_max_depth)`` as ``mpitree_tpu/utils/
    validation.py:292`` decides it: the crossover depth, whether the refine
    tail runs (it needs room below the crown) and the crown build's depth.

    ``refine_depth="auto"`` engages the tail only when quantile binning
    capped some feature (``quantized``; exact global candidates already are
    the reference's) and the native C++ sweep is loaded
    (``native.lib()``), at the crown depth whose average leaf holds about
    2,048 rows: ``max(1, round(log2(n_rows / 2048)))``. Without the
    library ``"auto"`` means no refine; an explicit integer still runs the
    per-subtree numpy tail.
    """
    rd = validate_refine_depth(refine_depth)
    if rd == "auto":
        if not quantized or not n_rows or native.lib() is None:
            rd = None
        else:
            rd = max(
                1, round(np.log2(max(n_rows, 2) / _AUTO_REFINE_LEAF_ROWS))
            )
    refine = rd is not None and (max_depth is None or max_depth > rd)
    return rd, refine, (rd if refine else max_depth)
