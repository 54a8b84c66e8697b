"""Struct-of-arrays decision tree (host numpy), as the JAX package stores it.

A copy of ``TreeArrays`` (``mpitree_tpu/core/tree_struct.py:23``): the tree
is flat numpy arrays indexed by node id, so a fitted tree from either
package carries across field for field (``utils/carry.py``). The build
keeps it on the host; predict uploads the four descent arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TreeArrays:
    """A fitted tree as parallel arrays indexed by node id (root = 0).

    Attributes
    ----------
    feature : (n_nodes,) int32
        Split feature per interior node; ``-1`` marks a leaf.
    threshold : (n_nodes,) float32
        Split value (``x <= threshold`` goes left); ``nan`` on leaves.
    left, right : (n_nodes,) int32
        Child ids; ``-1`` on leaves.
    parent : (n_nodes,) int32
        Parent id; ``-1`` on the root.
    depth : (n_nodes,) int32
        Edges from the root.
    value : (n_nodes,) int32
        Majority class index, defined for interior nodes too.
    count : (n_nodes, n_classes) int64
        Raw class counts (float64 under fractional sample weights).
    n_node_samples : (n_nodes,) int64
        Training rows (weighted) routed through each node.
    impurity : (n_nodes,) float64
        Per-node impurity under the training criterion.
    """

    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    parent: np.ndarray
    depth: np.ndarray
    value: np.ndarray
    count: np.ndarray
    n_node_samples: np.ndarray
    impurity: np.ndarray = None

    def __post_init__(self):
        if self.impurity is None:
            self.impurity = np.zeros(self.feature.shape[0], np.float64)

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def max_depth(self) -> int:
        return int(self.depth.max(initial=0))

    @property
    def n_leaves(self) -> int:
        return int((self.feature < 0).sum())

    def is_leaf(self, i: int) -> bool:
        return self.feature[i] < 0

    def save(self, path) -> None:
        np.savez(path, **dataclasses.asdict(self))

    @classmethod
    def load(cls, path) -> TreeArrays:
        with np.load(path) as z:
            return cls(**{k: z[k] for k in z.files})
