"""Vectorized tree descent — every row walks the tree in lockstep.

Counterpart of ``descend`` (``mpitree_tpu/ops/predict.py:71``): a torch
loop of ``n_steps`` (the tree's depth) gathers over the struct-of-arrays
tree. Rows parked on a leaf keep their node id, so ``n_steps`` steps land
every row on its leaf. Comparisons stay in float32 (``x <= threshold``
with float32 raw values and float32 thresholds), as in the reference.
Ensembles descend all their trees at once over the flat serving table
(:func:`stacked_leaf_ids`). A tree fitted on a data mesh predicts with
its rows split over the mesh's local shards (:func:`predict_leaf_ids`
with ``mesh``), the counterpart of ``predict_mesh``'s sharded descent;
unlike it (``mpitree_tpu/ops/predict.py:109-118``) nothing here drops to
one device when the mesh cannot be had: the caller's mesh resolution
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from mpitree_tpu_torch.core.tree_struct import TreeArrays
from mpitree_tpu_torch.serving.tables import tables_for
from mpitree_tpu_torch.serving.traversal import flat_leaf_ids


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
                     device: torch.device, mesh=None) -> np.ndarray:
    """(N, F) float32 host rows -> (N,) int64 leaf ids, descended on
    ``device``; with a data ``mesh`` (``parallel/mesh.Mesh``) the rows
    split into one contiguous block per local shard, each descended on its
    shard's device, and the ids come back in row order. Across processes
    every process answers all of its caller's rows on its own shards, with
    no collective."""
    X = np.ascontiguousarray(X, np.float32)
    devices = [device] if mesh is None else list(mesh.devices)
    bounds = np.linspace(0, X.shape[0], len(devices) + 1).astype(np.int64)
    out = []
    for dev, a, b in zip(devices, bounds[:-1], bounds[1:]):
        def put(v, dtype, dev=dev):
            return torch.from_numpy(np.asarray(v)).to(device=dev,
                                                      dtype=dtype)

        out.append(descend(
            put(X[a:b], torch.float32),
            put(tree.feature, torch.int64), put(tree.threshold, torch.float32),
            put(tree.left, torch.int64), put(tree.right, torch.int64),
            n_steps=max(tree.max_depth, 1),
        ))
    return torch.cat([ids.cpu() for ids in out]).numpy()


def stacked_leaf_ids(trees, X: np.ndarray,
                     device: torch.device) -> np.ndarray:
    """(T, N) int32 per-tree leaf ids for an ensemble: one descent over the
    depth-packed flat table (``serving.traversal.flat_leaf_ids``) instead
    of a loop over trees. Counterpart of ``mpitree_tpu/ops/predict.py:169``.
    A single-table ensemble keeps its device copy on the table, so a warm
    predict uploads only ``X``; an ensemble past the tables' byte budget
    (``serving.tables.TABLE_GROUP_BYTES``) splits into several tables,
    uploaded one at a time."""
    tables = tables_for(trees)
    X_d = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(device)
    ids = np.empty((len(trees), X.shape[0]), np.int32)
    t0 = 0
    for tb in tables:
        rel = flat_leaf_ids(X_d, *tb.dev_arrays(device,
                                                 cache=len(tables) == 1),
                            n_steps=tb.n_steps)
        ids[t0:t0 + tb.n_trees] = rel.T.cpu().numpy()
        t0 += tb.n_trees
    return ids
