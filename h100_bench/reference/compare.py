"""The walk that compares two fitted trees, and the judgement of a run's
compared numbers against their limits.

Two trees are walked together from their roots, whatever their node
numbering. A node pair matches when both are leaves, or both split on
the same feature at the same float32 threshold, and every compared field
(a check's ``FIELDS``: class counts; a boosted tree's row counts and leaf
values) is equal bit for bit. A pair that splits differently counts
every node below both as mismatched; a pair that splits alike but
differs in a field counts one and the walk goes on below it.

Which numbers a cell compares, and their limits, are its check's
(``checks/<check>.py``).
"""

from __future__ import annotations

import numpy as np


def _size(left, right, i) -> int:
    n, stack = 0, [i]
    while stack:
        k = stack.pop()
        n += 1
        if left[k] >= 0:
            stack += [left[k], right[k]]
    return n


def tree_mismatch(a: dict, b: dict, fields: tuple) -> int:
    """Mismatched nodes between trees ``a`` and ``b``: dicts of numpy
    arrays ``feature`` (-1 on leaves), ``threshold``, ``left``, ``right``
    and each of ``fields``."""
    bad, stack = 0, [(0, 0)]
    while stack:
        i, j = stack.pop()
        fa, fb = int(a["feature"][i]), int(b["feature"][j])
        same_split = fa == fb and (fa < 0 or np.float32(a["threshold"][i])
                                   .tobytes() == np.float32(
                                       b["threshold"][j]).tobytes())
        if not same_split:
            bad += _size(a["left"], a["right"], i) + _size(
                b["left"], b["right"], j)
            continue
        if any(not np.array_equal(np.asarray(a[f][i], np.float64),
                                  np.asarray(b[f][j], np.float64),
                                  equal_nan=True) for f in fields):
            bad += 1
        if fa >= 0:
            stack += [(a["left"][i], b["left"][j]),
                      (a["right"][i], b["right"][j])]
    return bad


def program_tree(t) -> dict:
    """A fitted ``TreeArrays`` of the program as the walk reads it."""
    return {"feature": np.asarray(t.feature), "threshold": np.asarray(
        t.threshold), "left": np.asarray(t.left), "right": np.asarray(
            t.right), "count": np.asarray(t.count, np.float64),
        "rows": np.asarray(t.n_node_samples, np.float64),
        "value": np.where(np.asarray(t.left) < 0, np.asarray(
            t.value, np.float32), np.nan)}


def reference_tree(r: dict, thresholds: np.ndarray) -> dict:
    """A reference tree (``tree.fit_tree``/``gbdt.fit_gbdt``) with its
    thresholds read from the reference's own bin table."""
    f = r["feature"]
    thr = np.full(len(f), np.nan, np.float32)
    inner = f >= 0
    thr[inner] = thresholds[f[inner], r["bin"][inner]]
    return dict(r, threshold=thr)


def judge(limits: dict, got: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every number of ``got``
    finite and at or below its limit in ``limits``."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in got.items())
    return ok, table
