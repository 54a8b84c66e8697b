"""Per-node impurity from class counts or regression moments (host numpy).

Copies of ``class_node_impurity`` and ``moment_node_impurity``
(``mpitree_tpu/utils/importances.py:24,36``): the f64 values the builders
store in ``TreeArrays.impurity``.
"""

from __future__ import annotations

import numpy as np


def class_node_impurity(counts: np.ndarray, criterion: str) -> np.ndarray:
    """(M, C) class counts -> (M,) entropy/gini impurity per node, f64."""
    counts = counts.astype(np.float64)
    n = counts.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = counts / np.maximum(n, 1.0)
        if criterion == "gini":
            return np.where(n[:, 0] > 0, 1.0 - (p * p).sum(axis=1), 0.0)
        t = np.where(counts > 0, p * np.log2(np.maximum(p, 1e-300)), 0.0)
        return -t.sum(axis=1)


def moment_node_impurity(moments: np.ndarray) -> np.ndarray:
    """(M, 3) ``(w, w*y, w*y^2)`` moments -> (M,) variance per node, f64.

    The value a build stores before its exact refit
    (``core/builder.refit_regression_values``) overwrites it."""
    m = moments.astype(np.float64)
    w = np.maximum(m[:, 0], 1e-300)
    mean = m[:, 1] / w
    return np.maximum(m[:, 2] / w - mean * mean, 0.0)
