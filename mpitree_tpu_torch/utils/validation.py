"""Input validation for the estimators, without sklearn.

Counterpart of the subset of ``mpitree_tpu/utils/validation.py`` the
estimators use. The JAX package validates with sklearn's ``check_X_y``/
``check_array`` and weighs classes with sklearn's
``compute_sample_weight``; the port runs where sklearn is not installed, so
what it needs is written here: numeric 2-D X with at least one row and
one feature, finite values, 1-D y of matching length with discrete labels,
encoded against ``classes_`` (for ``0..C-1`` integer labels the encoding is
the identity, as in the reference), or finite float64 regression targets;
``class_weight`` as sklearn computes it.
"""

from __future__ import annotations

import numbers

import numpy as np

from mpitree_tpu_torch import native


def _as_float_matrix(X, what: str = "X") -> np.ndarray:
    arr = np.asarray(X)
    if arr.dtype == object or arr.dtype.kind in "USV":
        try:
            arr = arr.astype(np.float64)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"{what} must be numeric; got dtype {arr.dtype} ({e})"
            ) from e
    elif arr.dtype.kind not in "biuf":
        raise ValueError(f"{what} must be numeric; got dtype {arr.dtype}")
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
    the classes, or for ``task="regression"`` float64 targets and None."""
    X = _as_float_matrix(X)
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim != 1:
        raise ValueError(f"y must be 1-D, got shape {y.shape}")
    if y.shape[0] != X.shape[0]:
        raise ValueError(
            "Found input variables with inconsistent numbers of samples: "
            f"[{X.shape[0]}, {y.shape[0]}]"
        )
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
        return X, y64, None
    if y.dtype.kind == "f":
        if not np.isfinite(y).all():
            raise ValueError("Input y contains NaN or infinity.")
        if not np.array_equal(y, np.round(y)):
            raise ValueError(
                "Unknown label type: continuous. Classification targets "
                "must be discrete"
            )
    classes, y_enc = np.unique(y, return_inverse=True)
    return X, y_enc.astype(np.int32), classes


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
    """Numeric finite (N, F) float32 with the fitted feature count."""
    X = _as_float_matrix(X)
    n_features = estimator.n_features_
    if X.shape[1] != n_features:
        raise ValueError(
            f"X has {X.shape[1]} features, but {type(estimator).__name__} "
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
