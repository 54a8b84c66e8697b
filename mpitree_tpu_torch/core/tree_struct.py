"""Struct-of-arrays decision tree (host numpy), as the JAX package stores it.

A copy of ``TreeArrays`` (``mpitree_tpu/core/tree_struct.py:23``): the tree
is flat numpy arrays indexed by node id, so a fitted tree from either
package carries across field for field (``utils/carry.py``,
``utils/serialize.py``). The build keeps it on the host; predict uploads
the four descent arrays.

``Node``/``BranchType`` and ``TreeArrays.to_nodes`` are the reference's
linked-node view (``mpitree/tree/_base.py:16-101``) for users who walked
``clf.tree_`` directly, copied from ``:92-176``: ``value`` is the feature
index on interior nodes and the class label (or mean) on leaves.
"""

from __future__ import annotations

import dataclasses
import enum

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

    def to_nodes(self) -> Node:
        """The reference-style linked-node view; returns the root."""
        feature = np.asarray(self.feature)
        threshold = np.asarray(self.threshold)
        depth = np.asarray(self.depth)
        count = np.asarray(self.count)
        left = np.asarray(self.left)
        right = np.asarray(self.right)
        value = np.asarray(self.value).tolist()
        nodes = [
            Node(
                value=(int(feature[i]) if feature[i] >= 0 else value[i]),
                threshold=(float(threshold[i]) if feature[i] >= 0 else None),
                depth=int(depth[i]),
                count=count[i],
            )
            for i in range(self.n_nodes)
        ]
        for i, node in enumerate(nodes):
            if feature[i] >= 0:
                node.left = nodes[left[i]]
                node.right = nodes[right[i]]
                node.left.parent = node
                node.right.parent = node
        return nodes[0] if nodes else Node(value=0)


class BranchType(enum.Enum):
    """Rendering glyph per node (reference ``mpitree/tree/_base.py:16-19``)."""

    ROOT = "┌──"
    INTERIOR_LIKE = "├──"
    LEAF_LIKE = "└──"


@dataclasses.dataclass
class Node:
    """Reference-compatible linked tree node (a view over
    :class:`TreeArrays`): overloaded ``value``, optional ``threshold``,
    ``depth``, the class-count vector ``count``, parent/left/right links,
    the ``_btype`` rendering state and the reference's side-effecting
    ``__lt__`` (``mpitree/tree/_base.py:50-75``), so ``sorted(
    node.children)`` behaves as on reference nodes."""

    value: object
    threshold: float | None = None
    depth: int = 0
    count: object = None
    parent: Node | None = dataclasses.field(default=None, repr=False)
    left: Node | None = dataclasses.field(default=None, repr=False)
    right: Node | None = dataclasses.field(default=None, repr=False)
    _btype: BranchType = dataclasses.field(
        default=BranchType.ROOT, repr=False
    )

    def __lt__(self, other: Node) -> bool:
        # The reference's semantics: comparing stamps both sides' branch
        # glyphs and returns whether self is interior, so interior nodes
        # sort first.
        if self.is_leaf:
            other._btype = BranchType.INTERIOR_LIKE
            self._btype = BranchType.LEAF_LIKE
        else:
            self._btype = BranchType.INTERIOR_LIKE
            other._btype = BranchType.LEAF_LIKE
        return not self.is_leaf

    @property
    def is_leaf(self) -> bool:
        return self.left is None and self.right is None

    @property
    def children(self) -> list:
        return [] if self.is_leaf else [self.left, self.right]
