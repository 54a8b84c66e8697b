"""The check of a binary boosted classifier (``GradientBoostingClassifier``
on two classes, its fused leaf-wise rounds).

The plain reference bins the rows (``reference/binning.py``) and boosts
the rounds again under the fused rounds' semantics
(``reference/gbdt.py``); the control rounds each round's float32
``(g, h)`` to bfloat16. Two numbers are compared:

- ``tree_mismatch``: mismatched nodes over all rounds' trees (split, each
  node's row count, each leaf's float32 value), and 1,000 for each round
  one side lacks; limit 0;
- ``loss_gap``: the largest gap between the program's training loss after
  each round (``train_score_``, from the margins the rounds produced) and
  the reference's; limit 1e-6.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import yardstick
from h100_bench.reference import binning, compare
from h100_bench.reference.gbdt import fit_gbdt

LIMITS = {"tree_mismatch": 0, "loss_gap": 1e-6}
FIELDS = ("rows", "value")


def outputs(est) -> dict:
    return {"trees": [dict(compare.program_tree(t), depth=np.asarray(
        t.depth)) for t in est.trees_],
        "train_loss": -np.asarray(est.train_score_, np.float64)}


def reference(params: dict, X, y, device, *, control: bool = False) -> dict:
    if len(np.unique(y)) != 2:
        raise ValueError("the gbdt check's reference boosts two classes")
    bins = binning.bin_columns(X, int(params["max_bins"]), device)
    ref = fit_gbdt(bins["xb"], torch.from_numpy(y).to(device),
                   n_cand=bins["n_cand"], params=params,
                   stats_dtype=torch.bfloat16 if control else torch.float32)
    thr = bins["thresholds"].cpu().numpy()
    return {"trees": [compare.reference_tree(t, thr) for t in ref["trees"]],
            "train_loss": ref["train_loss"], "n_bins": int(bins["n_bins"])}


def numbers(got: dict, want: dict) -> dict:
    bad = sum(compare.tree_mismatch(a, b, FIELDS)
              for a, b in zip(got["trees"], want["trees"]))
    bad += 1000 * abs(len(got["trees"]) - len(want["trees"]))
    gl, wl = got["train_loss"], want["train_loss"]
    gap = float(np.max(np.abs(gl - wl))) if len(gl) == len(wl) else np.inf
    return {"tree_mismatch": float(bad), "loss_gap": gap}


def work(out: dict, params: dict, X, y, want: dict) -> dict:
    """Every round's tree, each node's row count its own; the (count, g,
    h) payload in 8-byte fixed-point cells."""
    trees = [{"depth": t["depth"], "left": t["left"], "right": t["right"],
              "rows": t["rows"]} for t in out["trees"]]
    return yardstick.fit_work(
        trees, max_depth=int(params["max_depth"]), n_features=X.shape[1],
        n_channels=3, n_bins=want["n_bins"], cell=8)
