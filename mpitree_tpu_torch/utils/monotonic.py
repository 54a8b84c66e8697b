"""sklearn ``monotonic_cst``: validation, bound propagation, value clipping.

A copy of the JAX package's host numpy module
(``mpitree_tpu/utils/monotonic.py``), operation for operation, since the
gate is a hard binary that no tie tolerance absorbs. It implements
sklearn's (>= 1.4) semantics (sklearn/tree/_classes.py validation and the
class-0 sign flip; _criterion.pyx ``_check_monotonicity``,
``middle_value``, ``clip_node_value``; _tree.pyx bound propagation):

- a candidate split on a constrained feature is valid only when
  ``(v_left - v_right) * cst <= 0`` and both child values lie inside the
  node's propagated ``[lower, upper]`` bounds;
- children of a constrained split are bounded by
  ``mid = (v_left + v_right) / 2``;
- node values are clipped into their bounds for prediction.

"Value" is sklearn's internal convention: mean target for regression, and
the *class-0* fraction for binary classification; the estimator flips the
user-facing signs (which constrain the positive class) so the internal
arithmetic matches regression. All value arithmetic is float32
reciprocal-multiply (``f32(mass) * f32(1/n)``) on every engine.

The fused engine (``core/fused_builder.py``) keeps the bounds on the
device and propagates them with :func:`child_bounds_dev`, the torch twin
of :meth:`BoundsStore.assign_children` (the JAX fused engine's
``mpitree_tpu/core/fused_builder.py:591-602``).

Bounds are a pure function of the finished tree (each split's child values
are its children's own aggregates), so clipping recomputes them here
instead of threading build-time state out of every engine.
"""

from __future__ import annotations

import numpy as np
import torch


def validate_monotonic_cst(monotonic_cst, n_features: int, *, task: str,
                           n_classes: int | None = None):
    """User array -> INTERNAL (F,) int8 signs, or None when unconstrained.

    Mirrors sklearn's validation (sklearn/tree/_classes.py): shape must be
    (n_features,), values in {-1, 0, 1}; classification must be binary and
    flips the signs (user signs constrain the positive class, internal
    arithmetic tracks the class-0 fraction).
    """
    if monotonic_cst is None:
        return None
    cst = np.asarray(monotonic_cst)
    if cst.ndim != 1 or cst.shape[0] != n_features:
        raise ValueError(
            f"monotonic_cst has shape {cst.shape} but the input data "
            f"X has {n_features} features."
        )
    if not np.isin(cst, (-1, 0, 1)).all():
        raise ValueError(
            "monotonic_cst must be None or an array-like of -1, 0 or 1, "
            f"but got {np.unique(cst)}"
        )
    cst = cst.astype(np.int8)
    if not cst.any():
        return None
    if task == "classification":
        if n_classes is not None and n_classes > 2:
            raise ValueError(
                "Monotonicity constraints are not supported with multiclass "
                "classification"
            )
        cst = -cst
    return cst


class BoundsStore:
    """Growable per-node ``[lower, upper]`` value bounds: the one
    bound-propagation implementation (sklearn/_tree.pyx rule) that both
    level loops (``core/builder.py``, ``core/host_builder.py``) thread
    bounds through, so the two tiers cannot diverge."""

    def __init__(self) -> None:
        self.lo = np.full(256, -np.inf, np.float32)
        self.hi = np.full(256, np.inf, np.float32)

    def ensure(self, n: int) -> None:
        if n <= len(self.lo):
            return
        g_lo = np.full(max(n, 2 * len(self.lo)), -np.inf, np.float32)
        g_hi = np.full(len(g_lo), np.inf, np.float32)
        g_lo[: len(self.lo)] = self.lo
        g_hi[: len(self.hi)] = self.hi
        self.lo, self.hi = g_lo, g_hi

    def window(self, lo: int, take: int, size: int):
        """(size,) padded f32 lo/hi operands for frontier [lo, lo+take)."""
        lo_t = np.full(size, -np.inf, np.float32)
        hi_t = np.full(size, np.inf, np.float32)
        lo_t[:take] = self.lo[lo:lo + take]
        hi_t[:take] = self.hi[lo:lo + take]
        return lo_t, hi_t

    def assign_children(self, parent_ids, lefts, rights, v_left, v_right,
                        sign, n_total: int) -> None:
        """sklearn's bound propagation: a split on a constrained feature
        pins ``mid = (v_left + v_right)/2`` between the children; sign-0
        splits inherit the parent bounds."""
        self.ensure(n_total)
        mid = (v_left.astype(np.float32) + v_right.astype(np.float32)) \
            * np.float32(0.5)
        plo = self.lo[parent_ids].copy()
        phi = self.hi[parent_ids].copy()
        self.lo[lefts] = np.where(sign == -1, mid, plo)
        self.hi[lefts] = np.where(sign == 1, mid, phi)
        self.lo[rights] = np.where(sign == 1, mid, plo)
        self.hi[rights] = np.where(sign == -1, mid, phi)


def child_bounds_dev(plo, phi, v_left, v_right, sign):
    """:meth:`BoundsStore.assign_children` on tensors: the parents'
    float32 bounds ``plo``/``phi``, the winners' child values and the
    split features' signs -> ``(left_lo, left_hi, right_lo, right_hi)``;
    the float32 ``mid`` pins the children of a constrained split."""
    mid = (v_left.float() + v_right.float()) * 0.5
    return (
        torch.where(sign == -1, mid, plo), torch.where(sign == 1, mid, phi),
        torch.where(sign == 1, mid, plo), torch.where(sign == -1, mid, phi),
    )


def _node_values_f32(tree, task: str) -> np.ndarray:
    """Per-node internal value: class-0 fraction or mean target (f32).

    The reciprocal-multiply form matches the build engines bit for bit on
    integer-weight classification (counts and totals are exact in f32).
    """
    if task == "classification":
        c0 = tree.count[:, 0].astype(np.float32)
        n = tree.count.sum(axis=1).astype(np.float32)
        return c0 * (np.float32(1.0) / np.maximum(n, np.float32(1.0)))
    return tree.count[:, 0].astype(np.float32)


def tree_bounds(tree, cst: np.ndarray, task: str):
    """Recompute every node's ``[lower, upper]`` value bounds (f32).

    Vectorized by depth level (parents precede children in id order).
    """
    n = tree.n_nodes
    store = BoundsStore()
    store.ensure(n)
    if n == 0:
        return store.lo[:0], store.hi[:0]
    v = _node_values_f32(tree, task)
    for d in range(int(tree.depth.max(initial=0)) + 1):
        parents = np.flatnonzero((tree.depth == d) & (tree.left >= 0))
        if not len(parents):
            continue
        left = tree.left[parents]
        right = tree.right[parents]
        store.assign_children(
            parents, left, right, v[left], v[right],
            cst[tree.feature[parents]], n,
        )
    return store.lo[:n], store.hi[:n]


def clipped_class0(tree, cst: np.ndarray) -> np.ndarray:
    """Per-node bound-clipped class-0 fraction (binary classification).

    Forest ``predict_proba`` under constraints averages these: sklearn's
    forests average the clipped probabilities their trees store, and the
    averaged-raw-count alternative loses the monotone guarantee.
    """
    lo, hi = tree_bounds(tree, cst, "classification")
    return np.clip(_node_values_f32(tree, "classification"), lo, hi)


def clip_tree_values(tree, cst: np.ndarray, task: str) -> None:
    """sklearn's ``clip_node_value`` applied to the finished tree (in place).

    Classification: the clipped class-0 fraction decides the predicted
    label (label 0 iff clipped p0 >= 0.5: argmax of the clipped
    probability pair with sklearn's lowest-index tie). Raw ``count`` stays
    untouched: the tree's ``predict_proba`` returns raw counts by
    reference contract, so the monotonicity guarantee applies to
    ``predict`` (documented divergence from sklearn, whose stored
    probabilities are clipped). Regression clips ``value``/``count``.
    """
    lo, hi = tree_bounds(tree, cst, task)
    if task == "classification":
        p0 = np.clip(_node_values_f32(tree, task), lo, hi)
        tree.value = np.where(p0 >= 0.5, 0, 1).astype(np.int32)
    else:
        v = np.clip(tree.count[:, 0], lo.astype(np.float64),
                    hi.astype(np.float64))
        tree.count[:, 0] = v
        tree.value = v.astype(np.float32)
