"""Vectorized tree descent — every row walks the tree in lockstep.

Counterpart of ``descend`` (``mpitree_tpu/ops/predict.py:71``): a torch
loop of ``n_steps`` (the tree's depth) gathers over the struct-of-arrays
tree. Rows parked on a leaf keep their node id, so ``n_steps`` steps land
every row on its leaf. Comparisons stay in float32 (``x <= threshold``
with float32 raw values and float32 thresholds), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from mpitree_tpu_torch.core.tree_struct import TreeArrays


def descend(X: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
            left: torch.Tensor, right: torch.Tensor, *, n_steps: int
            ) -> torch.Tensor:
    """Route each row of ``X`` ((N, F) float32) to its leaf; returns (N,)
    int64 leaf node ids. ``feature`` (int64, ``< 0`` marks leaves),
    ``threshold`` (float32), ``left``/``right`` (int64) on X's device."""
    node = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    for _ in range(n_steps):
        f = feature[node]
        is_leaf = f < 0
        xf = torch.gather(X, 1, f.clamp(min=0)[:, None])[:, 0]
        go_left = xf <= threshold[node]
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(is_leaf, node, nxt)
    return node


def predict_leaf_ids(X: np.ndarray, tree: TreeArrays,
                     device: torch.device) -> np.ndarray:
    """(N, F) float32 host rows -> (N,) int64 leaf ids, descended on
    ``device``."""
    def put(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)

    ids = descend(
        put(np.ascontiguousarray(X, np.float32), torch.float32),
        put(tree.feature, torch.int64), put(tree.threshold, torch.float32),
        put(tree.left, torch.int64), put(tree.right, torch.int64),
        n_steps=max(tree.max_depth, 1),
    )
    return ids.cpu().numpy()
