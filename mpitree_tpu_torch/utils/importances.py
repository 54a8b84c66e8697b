"""Per-node impurity from class counts (host numpy).

A copy of ``class_node_impurity`` (``mpitree_tpu/utils/importances.py:24``):
the f64 value the builder stores in ``TreeArrays.impurity``.
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
