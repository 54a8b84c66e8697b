"""State carried across from the JAX package: fitted trees' arrays.

A fitted decision tree's "weights" are its ``TreeArrays`` fields. The JAX
package's tree (``mpitree_tpu.core.tree_struct.TreeArrays``) carries over
as plain numpy: ``dataclasses.asdict(jax_clf.tree_)`` or the ``.npz`` that
``TreeArrays.save`` writes; a forest carries over as the list of its
trees' arrays, a gradient-boosted ensemble as its trees' arrays and its
baseline margins. Nothing here imports the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from mpitree_tpu_torch.core.tree_struct import TreeArrays

_DTYPES = {
    "feature": np.int32,
    "threshold": np.float32,
    "left": np.int32,
    "right": np.int32,
    "parent": np.int32,
    "depth": np.int32,
    "value": np.int32,
    "n_node_samples": np.int64,
    "impurity": np.float64,
}


def tree_from_reference(arrays, *, task: str = "classification"
                        ) -> TreeArrays:
    """A mapping of ``TreeArrays`` field names to arrays (or a path to a
    ``TreeArrays.save`` ``.npz``) -> the port's :class:`TreeArrays`.

    Fields are cast to the struct's dtypes; for classification ``count``
    stays int64 when it is integral and float64 otherwise; a regression
    tree (``task="regression"``) keeps ``value`` float32 (the node means)
    and ``count`` float64 of shape (n, 1). A missing ``impurity`` loads as
    zeros. Raises ``ValueError`` on a missing field or ragged lengths.
    """
    if task not in ("classification", "regression"):
        raise ValueError(f"unknown task {task!r}")
    if isinstance(arrays, (str, os.PathLike)):
        with np.load(arrays) as z:
            arrays = {k: z[k] for k in z.files}
    missing = [k for k in (*_DTYPES, "count")
               if k not in arrays and k != "impurity"]
    if missing:
        raise ValueError(f"reference tree lacks fields {missing}")
    dtypes = dict(_DTYPES)
    if task == "regression":
        dtypes["value"] = np.float32
    fields = {
        k: np.ascontiguousarray(np.asarray(arrays[k]), dtype=dt)
        for k, dt in dtypes.items() if k in arrays
    }
    count = np.asarray(arrays["count"])
    if task == "regression":
        fields["count"] = np.ascontiguousarray(
            count, dtype=np.float64).reshape(-1, 1)
    else:
        fields["count"] = np.ascontiguousarray(
            count, dtype=np.int64 if np.array_equal(count, np.round(count))
            else np.float64,
        )
    n = fields["feature"].shape[0]
    bad = {k: v.shape[0] for k, v in fields.items() if v.shape[0] != n}
    if bad:
        raise ValueError(f"ragged reference tree: {n} nodes but {bad}")
    return TreeArrays(**fields)


def forest_from_reference(trees) -> list:
    """A fitted forest's trees, in member order: each element of
    ``trees`` as :func:`tree_from_reference` takes it (for a JAX forest,
    ``[dataclasses.asdict(t) for t in jax_forest.trees_]``). Raises
    ``ValueError`` on an empty forest."""
    out = [tree_from_reference(a) for a in trees]
    if not out:
        raise ValueError("reference forest has no trees")
    return out


def boosting_from_reference(trees, baseline_raw, *, n_features: int,
                            classes=None, params: dict | None = None):
    """A fitted gradient-boosted ensemble from the JAX package's: its
    trees in round-major, class-minor order (each as
    :func:`tree_from_reference` takes it, with ``value`` float32 and
    ``count`` the (n, 1) float64 Newton values), its ``_baseline_raw``
    (K,) float64, its ``classes_`` (None for a regressor) and its
    ``n_features_in_``; ``params`` go to the constructor (the JAX
    estimator's ``get_params()``, plus ``device``). Returns the port's
    ``GradientBoostingClassifier`` or ``GradientBoostingRegressor``, which
    then predicts and serves the same numbers. Raises ``ValueError`` when
    the trees are not whole rounds of ``len(baseline_raw)`` trees."""
    from mpitree_tpu_torch.boosting.gradient_boosting import (
        GradientBoostingClassifier,
        GradientBoostingRegressor,
    )
    from mpitree_tpu_torch.serving.tables import TreeList

    base = np.ascontiguousarray(baseline_raw, dtype=np.float64).reshape(-1)
    K = base.shape[0]
    out = [tree_from_reference(a, task="regression") for a in trees]
    if not out or K < 1 or len(out) % K:
        raise ValueError(
            f"{len(out)} reference trees are not whole rounds of {K}")
    cls = (GradientBoostingRegressor if classes is None
           else GradientBoostingClassifier)
    est = cls(**(params or {}))
    est.trees_ = TreeList(out)
    est._baseline_raw = base
    est.n_trees_per_iteration_ = K
    est.n_iter_ = len(out) // K
    est.n_features_ = est.n_features_in_ = int(n_features)
    est.n_outputs_ = 1
    if classes is not None:
        est.classes_ = np.asarray(classes)
        est.n_classes_ = len(est.classes_)
    return est
