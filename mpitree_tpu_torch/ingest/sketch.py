"""Mergeable per-feature quantile sketches: the streaming binner's core.

Counterpart of ``mpitree_tpu/ingest/sketch.py``, bit for bit.
``ops.binning.bin_dataset`` selects edges as order statistics of the
whole column: exact mode keeps every unique value, quantile mode gathers
the sorted column at the host-float64 ``_quantile_indices``. A stream
cannot sort the whole column, but it can keep the column's exact
``(unique value, count)`` summary: unique sets merge associatively across
chunks and processes, and any order statistic reads off the merged
summary by cumulative count. While the summary is exact the streamed
edges are bit-identical to the in-memory ones:

- exact/auto edges: ``values[:-1]`` == ``np.unique(col)[:-1]``;
- quantile edges: ``sorted_col[i] == values[searchsorted(cumsum(counts),
  i, side="right")]`` for every gather index ``i``, deduplicated by the
  same ``np.unique``.

Past the capacity (``MPITREE_TPU_SKETCH_CAPACITY``, default 2**20 unique
values per feature) the summary compacts: adjacent pairs collapse, the
even-index value absorbing its right neighbour's count. That keeps the
total weight and every edge a real data value, at a rank error bounded by
the widest surviving gap; it is deterministic, so every chunking and
process split of a stream gives the same sketch. A compacted feature
forces ``quantized=True`` and refuses ``binning="exact"``.

Several processes merge through ``torch.distributed.all_gather_object``
in rank order (:meth:`SketchSet.merge_across_processes`). Host numpy
only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.ops.binning import _quantile_indices, pack_edges

# Per-feature unique-value cap before the sketch compacts (~12 MiB of
# (f32 value, i64 count) pairs per feature at the default). Overridable
# per call and via the env knob for constrained hosts.
SKETCH_CAPACITY = 1 << 20
SKETCH_CAPACITY_ENV = "MPITREE_TPU_SKETCH_CAPACITY"


def resolve_capacity(capacity: int | None = None) -> int:
    if capacity is not None:
        return max(int(capacity), 2)
    env = knobs.raw(SKETCH_CAPACITY_ENV)
    if env:
        try:
            return max(int(env), 2)
        except ValueError:
            pass
    return SKETCH_CAPACITY


def _merge_unique(v1, c1, v2, c2) -> tuple:
    """Merge two sorted-unique (values, counts) summaries exactly."""
    if not len(v1):
        return v2, c2
    if not len(v2):
        return v1, c1
    v = np.concatenate([v1, v2])
    c = np.concatenate([c1, c2])
    uv, inv = np.unique(v, return_inverse=True)
    uc = np.zeros(len(uv), np.int64)
    np.add.at(uc, inv, c)
    return uv, uc


@dataclasses.dataclass
class FeatureSketch:
    """One feature's mergeable ``(unique values, counts)`` summary."""

    values: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.float32)
    )
    counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64)
    )
    exact: bool = True
    capacity: int = SKETCH_CAPACITY

    @property
    def n(self) -> int:
        """Total weight (rows) the sketch has absorbed."""
        return int(self.counts.sum())

    @property
    def n_unique(self) -> int:
        return len(self.values)

    def update(self, col: np.ndarray) -> None:
        """Absorb one chunk's column (must already be finite f32)."""
        uv, uc = np.unique(
            np.ascontiguousarray(col, np.float32), return_counts=True
        )
        self.values, self.counts = _merge_unique(
            self.values, self.counts, uv, uc.astype(np.int64)
        )
        self._compact_if_needed()

    def merge(self, other: FeatureSketch) -> None:
        """Absorb another sketch (cross-chunk / cross-process merge)."""
        self.values, self.counts = _merge_unique(
            self.values, self.counts, other.values, other.counts
        )
        self.exact = self.exact and other.exact
        self._compact_if_needed()

    def _compact_if_needed(self) -> None:
        while len(self.values) > self.capacity:
            # Pair-collapse: even indices keep their value and absorb the
            # right neighbor's count. Values remain real data, total
            # weight is preserved, and the result is a valid summary for
            # the next merge — the deterministic sketch-mode fallback.
            c = self.counts
            if len(c) % 2:
                c = np.concatenate([c, np.zeros(1, np.int64)])
            self.counts = c[0::2] + c[1::2]
            self.values = self.values[0::2]
            self.exact = False

    def edges(self, *, max_bins: int, binning: str) -> tuple:
        """(edges f32, quantized) — the ``bin_dataset`` edge selection
        restated over the summary (bit-identical while ``exact``)."""
        if binning == "exact" or (
            binning == "auto" and self.exact and self.n_unique <= max_bins
        ):
            if not self.exact:
                raise ValueError(
                    "binning='exact' on a stream that exceeded the sketch "
                    f"capacity ({self.capacity} unique values): exact "
                    "candidates are no longer recoverable — use "
                    "binning='auto'/'quantile' or raise the capacity "
                    f"({SKETCH_CAPACITY_ENV})"
                )
            return self.values[:-1].astype(np.float32), False
        n = self.n
        if n < 1 or not self.n_unique:
            return np.empty(0, np.float32), binning == "quantile"
        # The same host-f64 gather indices as bin_dataset; the sorted
        # column's value at rank i is values[searchsorted(cum, i, "right")].
        idx = _quantile_indices(n, max_bins)
        pos = np.searchsorted(np.cumsum(self.counts), idx, side="right")
        edges = np.unique(self.values[pos].astype(np.float32))
        return edges, True


class SketchSet:
    """Per-feature sketch bank for one stream (plus the row total)."""

    def __init__(self, n_features: int, *, capacity: int | None = None):
        cap = resolve_capacity(capacity)
        self.sketches = [
            FeatureSketch(capacity=cap) for _ in range(int(n_features))
        ]
        self.n_rows = 0

    @property
    def n_features(self) -> int:
        return len(self.sketches)

    @property
    def exact(self) -> bool:
        return all(s.exact for s in self.sketches)

    def update(self, X_chunk: np.ndarray) -> None:
        X_chunk = np.ascontiguousarray(X_chunk, np.float32)
        if X_chunk.shape[1] != self.n_features:
            raise ValueError(
                f"chunk has {X_chunk.shape[1]} features, stream started "
                f"with {self.n_features}"
            )
        Xt = np.ascontiguousarray(X_chunk.T)
        for f, sk in enumerate(self.sketches):
            sk.update(Xt[f])
        self.n_rows += X_chunk.shape[0]

    def merge(self, other: SketchSet) -> None:
        if other.n_features != self.n_features:
            raise ValueError("cannot merge sketch sets of different width")
        for mine, theirs in zip(self.sketches, other.sketches):
            mine.merge(theirs)
        self.n_rows += other.n_rows

    def merge_across_processes(self) -> None:
        """Fold every process's sketches into the same global summary.

        Each process streams only its shard (``chunks.shard_for_process``)
        and then calls this once: the summaries are all-gathered over the
        ``torch.distributed`` world (``all_gather_object``) and merged in
        rank order, so every process derives the same edges and bins
        alike. A no-op in one process."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() <= 1:
            return
        mine = ([(s.values, s.counts) for s in self.sketches],
                self.exact, int(self.n_rows))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        exact = all(e for _, e, _ in every)
        cap = self.sketches[0].capacity if self.sketches else SKETCH_CAPACITY
        merged = [FeatureSketch(capacity=cap) for _ in range(self.n_features)]
        for summaries, _, _ in every:
            if len(summaries) != self.n_features:
                raise ValueError(
                    "cannot merge sketch sets of different width across "
                    f"processes ({len(summaries)} vs {self.n_features})")
            for sk, (v, c) in zip(merged, summaries):
                sk.merge(FeatureSketch(values=v, counts=c, capacity=cap))
                sk.exact = sk.exact and exact
        self.sketches = merged
        self.n_rows = sum(n for _, _, n in every)

    def to_thresholds(self, *, max_bins: int, binning: str) -> tuple:
        """(thresholds, n_cand, n_bins, quantized) via the shared
        ``ops.binning.pack_edges`` packaging."""
        per_feature = []
        quantized = False
        for sk in self.sketches:
            e, q = sk.edges(max_bins=max_bins, binning=binning)
            quantized = quantized or q or not sk.exact
            per_feature.append(e)
        return pack_edges(per_feature, quantized=quantized)

    def nbytes(self) -> int:
        """Host bytes the summaries currently hold (the planner's
        ``sketch`` row reads the a-priori bound, this the realized)."""
        return sum(s.values.nbytes + s.counts.nbytes for s in self.sketches)
