"""State carried across from the JAX package: fitted trees' arrays.

A fitted decision tree's "weights" are its ``TreeArrays`` fields. The JAX
package's tree (``mpitree_tpu.core.tree_struct.TreeArrays``) carries over
as plain numpy: ``dataclasses.asdict(jax_clf.tree_)`` or the ``.npz`` that
``TreeArrays.save`` writes; a forest carries over as the list of its
trees' arrays. Nothing here imports the JAX package.
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


def tree_from_reference(arrays) -> TreeArrays:
    """A mapping of ``TreeArrays`` field names to arrays (or a path to a
    ``TreeArrays.save`` ``.npz``) -> the port's :class:`TreeArrays`.

    Fields are cast to the struct's dtypes; ``count`` stays int64 when it
    is integral and float64 otherwise; a missing ``impurity`` loads as
    zeros. Raises ``ValueError`` on a missing field or ragged lengths.
    """
    if isinstance(arrays, (str, os.PathLike)):
        with np.load(arrays) as z:
            arrays = {k: z[k] for k in z.files}
    missing = [k for k in (*_DTYPES, "count")
               if k not in arrays and k != "impurity"]
    if missing:
        raise ValueError(f"reference tree lacks fields {missing}")
    fields = {
        k: np.ascontiguousarray(np.asarray(arrays[k]), dtype=dt)
        for k, dt in _DTYPES.items() if k in arrays
    }
    count = np.asarray(arrays["count"])
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
