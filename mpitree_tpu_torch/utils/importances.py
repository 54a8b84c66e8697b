"""Per-node impurity and feature importances (host numpy).

Copies of ``class_node_impurity``, ``moment_node_impurity`` and
``feature_importances`` (``mpitree_tpu/utils/importances.py:24,36,48``):
the f64 values the builders store in ``TreeArrays.impurity``, and the
estimators' ``feature_importances_``. The JAX package's fallback for
regression trees saved without per-node impurity is not copied: every
tree of the port carries it.
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


def feature_importances(tree, n_features: int, *, criterion: str = "entropy",
                        task: str = "classification") -> np.ndarray:
    """Normalized mean-decrease-in-impurity importances, (n_features,):
    per split node ``n * imp - n_l * imp_l - n_r * imp_r`` over the root's
    weight, floored at 0, summed by feature and normalized to 1 (all
    zeros for a single leaf)."""
    imp = np.zeros(n_features, np.float64)
    interior = np.flatnonzero(tree.feature >= 0)
    if len(interior) == 0:
        return imp
    n = tree.n_node_samples.astype(np.float64)
    total = max(n[0], 1.0)
    node_imp = (class_node_impurity(tree.count, criterion)
                if task == "classification" else tree.impurity)
    left, right = tree.left[interior], tree.right[interior]
    decrease = (
        n[interior] * node_imp[interior]
        - n[left] * node_imp[left]
        - n[right] * node_imp[right]
    ) / total
    np.add.at(imp, tree.feature[interior], np.maximum(decrease, 0.0))
    s = imp.sum()
    return imp / s if s > 0 else imp
