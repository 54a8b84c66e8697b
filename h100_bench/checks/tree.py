"""The check of an entropy classification tree (``DecisionTreeClassifier``
with ``criterion="entropy"``), unit or per-class weights.

The plain reference bins the rows (``reference/binning.py``) and grows
the tree level by level in float64 (``reference/tree.py``); the control
runs the same split sweep in float32. One number is compared:

- ``tree_mismatch``: the nodes whose split (feature, float32 threshold)
  or class counts differ, walking both trees from the root
  (``reference/compare.py``); limit 0, the port's exact tree.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import yardstick
from h100_bench.reference import binning, compare
from h100_bench.reference.tree import fit_tree

LIMITS = {"tree_mismatch": 0}
FIELDS = ("count",)


def class_weights(params: dict, y: np.ndarray):
    """float64 copies of the float32 per-class weights that ``params``'
    ``class_weight`` asks for: None for unit weights, or sklearn's
    ``"balanced"`` (``n / (C * count_c)``). Other weightings are a check
    of their own."""
    cw = params.get("class_weight")
    if cw is None:
        return None
    if cw != "balanced":
        raise ValueError(f"the tree check weighs no class_weight={cw!r}")
    counts = np.bincount(y).astype(np.float64)
    return (counts.sum() / (len(counts) * counts)).astype(
        np.float32).astype(np.float64)


def outputs(est) -> dict:
    t = est.tree_
    return {"trees": [dict(compare.program_tree(t),
                           depth=np.asarray(t.depth))]}


def reference(params: dict, X, y, device, *, control: bool = False) -> dict:
    if params.get("criterion", "gini") != "entropy":
        raise ValueError("the tree check's reference grows entropy trees; "
                         "another criterion is a check of its own")
    bins = binning.bin_columns(X, int(params["max_bins"]), device)
    ref = fit_tree(bins["xb"], torch.from_numpy(y).to(device),
                   n_classes=int(y.max()) + 1, n_cand=bins["n_cand"],
                   max_depth=int(params["max_depth"]),
                   class_w=class_weights(params, y),
                   min_samples_split=float(params["min_samples_split"]),
                   dtype=torch.float32 if control else torch.float64)
    thr = bins["thresholds"].cpu().numpy()
    return {"trees": [compare.reference_tree(ref, thr)],
            "n_bins": int(bins["n_bins"])}


def numbers(got: dict, want: dict) -> dict:
    bad = sum(compare.tree_mismatch(a, b, FIELDS)
              for a, b in zip(got["trees"], want["trees"]))
    return {"tree_mismatch": float(bad)}


def work(out: dict, params: dict, X, y, want: dict) -> dict:
    """Each node's row count is its weighted class counts over the class
    weights (exact: every row of a class weighs the same); a weighted
    fit's histograms hold fixed-point cells of 8 bytes, an unweighted
    one's int32 counts."""
    class_w = class_weights(params, y)
    trees = []
    for t in out["trees"]:
        rows = (t["rows"] if class_w is None else
                np.rint(t["count"] / class_w).sum(axis=1))
        trees.append({"depth": t["depth"], "left": t["left"],
                      "right": t["right"], "rows": rows})
    return yardstick.fit_work(
        trees, max_depth=int(params["max_depth"]), n_features=X.shape[1],
        n_channels=int(y.max()) + 1, n_bins=want["n_bins"],
        cell=4 if class_w is None else 8)
