"""Depth-packed structure-of-arrays node tables: the serving-side tree form.

Counterpart of ``mpitree_tpu/serving/tables.py``. A :class:`NodeTable`
flattens an ensemble into one id space: every node of every tree lives at
an absolute index into parallel arrays (feature, threshold, left, right,
orig), children addressed absolutely, nodes ordered by ``(depth, tree,
node)`` so each depth level is one contiguous slab (``level_off``).
``n_steps`` is the deepest member's depth, not the estimator's
``max_depth`` budget.

Host arrays are numpy and are built once per ensemble: a forest's
``trees_`` is a :class:`TreeList`, which carries its tables. Device
copies are torch tensors, made once per device and kept on the table
(:meth:`NodeTable.dev_arrays`, :meth:`NodeTable.dev_values`,
:meth:`NodeTable.dev_record`; the host value channels,
:meth:`NodeTable.values`, are kept too), so the request path uploads
nothing but the query batch. The kernels (``serving/serve_kernel.py``)
descend the packed node records (16 bytes a node), the plain versions
the columns; a published model holds one copy of each on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpitree_tpu_torch.serving.serve_kernel import pack_nodes

# Device-memory ceiling for one table's structural columns plus value
# headroom, as in the JAX package: ensembles past it split into several
# tables on the estimators' predict path.
TABLE_GROUP_BYTES = 256 << 20
_BYTES_PER_NODE = 24  # 5 x int32/f32 structural columns + value headroom


class TreeList(list):
    """A forest's list of trees, carrying the serving tables built from it
    (``tables``: cache key -> list of :class:`NodeTable`)."""

    __slots__ = ("tables",)

    def __init__(self, trees=()):
        super().__init__(trees)
        self.tables = {}


@dataclasses.dataclass
class NodeTable:
    """One depth-packed flat node table (a whole ensemble, or one group).

    Attributes
    ----------
    feature : (M,) int32 — split feature per node, ``-1`` marks leaves.
    threshold : (M,) float32 — split value; ``nan`` on leaves.
    left, right : (M,) int32 — absolute child ids into this table
        (``-1`` on leaves; never followed, the descent holds on leaves).
    orig : (M,) int32 — the node's id within its source tree.
    root : (T,) int32 — absolute root id per member tree.
    level_off : (D+2,) int64 — level ``d`` occupies
        ``[level_off[d], level_off[d+1])``.
    n_steps : int — true ensemble depth (deepest member; >= 1).
    """

    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    orig: np.ndarray
    root: np.ndarray
    level_off: np.ndarray
    n_steps: int
    order: np.ndarray = dataclasses.field(repr=False, default=None)

    def __post_init__(self):
        self._dev: dict = {}
        self._values: dict = {}
        self._dev_values: dict = {}
        self._dev_record: dict = {}

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_trees(self) -> int:
        return int(self.root.shape[0])

    def dev_arrays(self, device: torch.device, *, cache: bool = True) -> tuple:
        """``(feature, threshold, left, right, root, orig)`` on ``device``:
        int32 ids, float32 thresholds. ``cache=True`` keeps the copies on
        the table (first touch uploads, later calls reuse); ``cache=False``
        uploads transiently, so a multi-table ensemble's peak residency is
        one group."""
        key = str(device)
        dev = self._dev.get(key)
        if dev is None:
            dev = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.feature, self.threshold, self.left,
                          self.right, self.root, self.orig)
            )
            if cache:
                self._dev[key] = dev
        return dev

    def dev_record(self, device: torch.device) -> torch.Tensor:
        """The (M, 4) int32 node records the traversal kernels descend
        (``serve_kernel.pack_nodes`` of :meth:`dev_arrays`; 16 bytes a
        node), packed on ``device`` once and kept beside the columns."""
        key = str(device)
        rec = self._dev_record.get(key)
        if rec is None:
            rec = self._dev_record[key] = pack_nodes(
                *self.dev_arrays(device)[:4])
        return rec

    def values(self, channel: str, build) -> np.ndarray:
        """Host value channel ``channel``, built once as ``build(self)``."""
        v = self._values.get(channel)
        if v is None:
            v = self._values[channel] = build(self)
        return v

    def dev_values(self, channel: str, build, *, dtype: np.dtype,
                   device: torch.device, prepare=None) -> torch.Tensor:
        """Value channel ``channel`` (the host array :meth:`values`) on
        ``device`` at ``dtype``, uploaded once; ``prepare``, if given,
        maps the uploaded tensor on the device before it is kept."""
        key = (channel, np.dtype(dtype).str, str(device))
        d = self._dev_values.get(key)
        if d is None:
            host = np.ascontiguousarray(self.values(channel, build),
                                        dtype=dtype)
            d = torch.from_numpy(host).to(device)
            self._dev_values[key] = d = prepare(d) if prepare else d
        return d

    def scatter_order(self) -> np.ndarray:
        """(M,) permutation mapping absolute table position -> index into
        the per-tree concatenation (``concat(arrays)[scatter_order()]``
        depth-packs a per-node channel)."""
        return self.order


def _flatten(trees, lo: int, hi: int) -> NodeTable:
    """Depth-pack ``trees[lo:hi]`` into one :class:`NodeTable`."""
    group = trees[lo:hi]
    sizes = np.array([t.n_nodes for t in group], np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offs[-1])
    all_depth = np.concatenate(
        [np.asarray(t.depth, np.int64) for t in group]
    )
    all_tree = np.repeat(np.arange(len(group), dtype=np.int64), sizes)
    all_node = np.concatenate([np.arange(s, dtype=np.int64) for s in sizes])
    # (depth, tree, node) ascending: each depth level is one contiguous
    # slab, trees in member order inside it.
    order = np.lexsort((all_node, all_tree, all_depth))
    pos = np.empty(total, np.int64)
    pos[order] = np.arange(total)

    feat = np.concatenate([np.asarray(t.feature, np.int32) for t in group])
    thr = np.concatenate([np.asarray(t.threshold, np.float32) for t in group])
    left = np.concatenate([np.asarray(t.left, np.int64) for t in group])
    right = np.concatenate([np.asarray(t.right, np.int64) for t in group])
    # Within-tree child ids -> flat-concat ids -> absolute table ids; leaves
    # stay -1 (their pos[-1] read is masked out).
    tree_off = offs[all_tree]
    left_abs = np.where(left >= 0, pos[left + tree_off], -1)
    right_abs = np.where(right >= 0, pos[right + tree_off], -1)

    depth_sorted = all_depth[order]
    n_levels = int(depth_sorted[-1]) + 1 if total else 1
    level_off = np.searchsorted(
        depth_sorted, np.arange(n_levels + 1), side="left"
    )
    return NodeTable(
        feature=feat[order],
        threshold=thr[order],
        left=left_abs[order].astype(np.int32),
        right=right_abs[order].astype(np.int32),
        orig=all_node[order].astype(np.int32),
        root=pos[offs[:-1]].astype(np.int32),
        level_off=level_off.astype(np.int64),
        n_steps=max(n_levels - 1, 1),
        order=order,
    )


def tables_for(trees, *, group_bytes: int | None = TABLE_GROUP_BYTES) -> list:
    """Depth-packed tables for ``trees``.

    ``group_bytes`` caps one table's structural footprint; ``None`` means
    one table whatever its size (the serving path). A :class:`TreeList`
    keeps its tables, keyed so that a byte budget the whole ensemble fits
    inside shares the single table (and its device copy) with
    ``group_bytes=None``; any other list is flattened on every call.
    """
    n = len(trees)
    bounds = [0, n]
    if group_bytes is not None:
        cuts, cur, acc = [], 0, 0
        budget = max(int(group_bytes), 1)
        for i, t in enumerate(trees):
            b = t.n_nodes * _BYTES_PER_NODE
            if i > cur and acc + b > budget:
                cuts.append(i)
                cur, acc = i, 0
            acc += b
        bounds = [0, *cuts, n]
    cache = trees.tables if isinstance(trees, TreeList) else {}
    key = "one" if len(bounds) == 2 else int(group_bytes)
    tables = cache.get(key)
    if tables is None:
        tables = cache[key] = [
            _flatten(trees, bounds[i], bounds[i + 1])
            for i in range(len(bounds) - 1)
        ]
    return tables


def table_notes(trees) -> dict:
    """Host-only serving notes for a fitted ensemble: total nodes, true
    descent depth, and the flat table's fill against a padded
    ``(T, max_nodes)`` grid."""
    sizes = [int(t.n_nodes) for t in trees]
    n_steps = max(max((int(t.max_depth) for t in trees), default=0), 1)
    total = sum(sizes)
    stacked_cells = len(sizes) * max(sizes, default=0)
    return {
        "n_trees": len(sizes),
        "n_nodes": total,
        "n_steps": n_steps,
        "flat_fill": round(total / stacked_cells, 4) if stacked_cells else 1.0,
    }


def note_serving(obs, trees) -> None:
    """Record the serving-table plan on a fit's observer (the JAX
    package's ``note_serving``, ``mpitree_tpu/serving/tables.py:258``):
    what ``compile_model`` will flatten the fitted trees into."""
    notes = table_notes(trees)
    obs.decision(
        "serving", "flat-table",
        reason=(
            f"depth-packed node table: {notes['n_nodes']} nodes, "
            f"{notes['n_steps']} descent steps (true ensemble depth), "
            f"{notes['flat_fill']:.0%} of the padded stacked grid"
        ),
        **notes,
    )
