"""The ingest pipeline: sketch pass, packed edges, bin and place pass.

Counterpart of ``mpitree_tpu/ingest/stream.py``. Two passes over a
repeatable chunk source (``chunks.py``):

1. **sketch**: every chunk updates the mergeable per-feature sketches
   (``sketch.py``) and appends its targets and weights to the host's
   per-row state (the one O(N) host cost a stream keeps). Several
   processes then merge their sketches, so all derive the same edges.
2. **bin and place**: the merged sketches pack into the
   ``(thresholds, n_cand, n_bins)`` table ``bin_dataset`` builds
   (``ops.binning.pack_edges``); each chunk streams again, is binned
   against it (``bin_with_thresholds``, bit-identical ids) and lands in
   its shards on the fit's devices (``place.assemble_binned``).

The chunk size comes from the host budget (``obs/memory.ingest_chunk_rows``
under ``MPITREE_TPU_HOST_BYTES``) whenever the source lets the pipeline
choose. Across processes the row counts, then the targets and weights,
are all-gathered in rank order (``torch.distributed.all_gather``: NCCL on
the card, gloo on the CPU), so every process holds every row's targets,
as the mesh's builds expect.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mpitree_tpu_torch.ingest import chunks as chunks_mod
from mpitree_tpu_torch.ingest import place as place_mod
from mpitree_tpu_torch.ingest import spill as spill_mod
from mpitree_tpu_torch.ingest.sketch import SketchSet, resolve_capacity
from mpitree_tpu_torch.obs import memory as memory_lib
from mpitree_tpu_torch.ops.binning import (
    StreamedBinnedData,
    bin_with_thresholds,
)


class StreamedDataset:
    """A host-chunked training set — what ``fit(dataset=...)`` consumes.

    ``chunk_rows=None`` defers to the planner
    (:func:`obs.memory.ingest_chunk_rows` under the
    ``MPITREE_TPU_HOST_BYTES`` budget) for sources that support
    re-chunking; iterator sources own their chunk shapes.
    """

    def __init__(self, source, *, chunk_rows: int | None = None,
                 sketch_capacity: int | None = None):
        if not hasattr(source, "chunks"):
            raise TypeError(
                "source must implement .chunks() (see mpitree_tpu_torch."
                "ingest.chunks); use the from_* constructors for common "
                "layouts"
            )
        self.source = source
        self.chunk_rows = chunk_rows
        self.sketch_capacity = resolve_capacity(sketch_capacity)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_arrays(cls, X, y, sample_weight=None, *,
                    chunk_rows: int | None = None, **kw) -> StreamedDataset:
        """In-memory arrays streamed in ``chunk_rows`` slices (the
        identity-grid/testing form — real out-of-core inputs come from
        shards or iterators)."""
        return cls(
            chunks_mod.ArrayChunks(X, y, sample_weight),
            chunk_rows=chunk_rows, **kw,
        )

    @classmethod
    def from_npy(cls, x_paths, y_paths, weight_paths=None, *,
                 chunk_rows: int | None = None, **kw) -> StreamedDataset:
        """Memory-mapped ``.npy`` shard pairs (globs or path lists)."""
        return cls(
            chunks_mod.NpyShards(x_paths, y_paths, weight_paths),
            chunk_rows=chunk_rows, **kw,
        )

    @classmethod
    def from_npz(cls, paths, *, x_key="X", y_key="y", weight_key=None,
                 **kw) -> StreamedDataset:
        """``.npz`` shard files, one chunk per file."""
        return cls(
            chunks_mod.NpzShards(
                paths, x_key=x_key, y_key=y_key, weight_key=weight_key
            ), **kw,
        )

    @classmethod
    def from_chunks(cls, chunks_or_factory, **kw) -> StreamedDataset:
        """A list of ``(X, y[, w])`` tuples, or a zero-arg factory
        returning a fresh iterator of them per pass (the pipeline
        streams twice — a bare generator would arrive exhausted)."""
        return cls(chunks_mod.IterChunks(chunks_or_factory), **kw)

    # -- iteration ---------------------------------------------------------
    def resolve_chunk_rows(self) -> int | None:
        """The planner-derived chunk size (None for sources that own
        their chunking or whose width is unknown before the stream)."""
        if self.chunk_rows is not None:
            return int(self.chunk_rows)
        nf = getattr(self.source, "n_features", None)
        if nf is None:
            return None
        return memory_lib.ingest_chunk_rows(int(nf))

    def chunks(self, *, validate: bool = True):
        yield from self.source.chunks(
            self.resolve_chunk_rows(), validate=validate
        )


def sketch_dataset(ds: StreamedDataset) -> tuple:
    """Pass 1: (SketchSet, y, sample_weight|None) from one stream.

    ``y``/weights accumulate as chunk pieces and concatenate once at the
    end — per-row host state, not the matrix. Raises on an empty stream
    (nothing to fit) and on chunks that change width mid-stream.
    """
    sketches: SketchSet | None = None
    y_parts: list = []
    w_parts: list = []
    saw_w = None
    for X, y, w in ds.chunks():
        if sketches is None:
            sketches = SketchSet(
                X.shape[1], capacity=ds.sketch_capacity
            )
            saw_w = w is not None
        if (w is not None) != saw_w:
            raise ValueError(
                "chunk stream mixes weighted and unweighted chunks"
            )
        sketches.update(X)
        y_parts.append(np.asarray(y))
        if w is not None:
            w_parts.append(w)
    if sketches is None or sketches.n_rows == 0:
        raise ValueError("empty chunk stream: nothing to fit")
    sketches.merge_across_processes()
    y_all = np.concatenate(y_parts)
    w_all = np.concatenate(w_parts) if w_parts else None
    return sketches, y_all, w_all


def _world():
    """(rank, size) of the ``torch.distributed`` world, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _gather_device():
    """Where the cross-process gathers stage their buffers: the current
    card under NCCL, the host under gloo."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_counts(n_local: int) -> np.ndarray:
    """Every process's local row count, in rank order."""
    import torch.distributed as dist

    dev = _gather_device()
    mine = torch.tensor([int(n_local)], dtype=torch.int64, device=dev)
    every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return torch.cat(every).cpu().numpy()


def _allgather_rows(local: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate every process's per-row vector in rank order (the order
    the global row offsets assume). Uneven lengths gather through one
    padded buffer; non-numeric labels cannot ride the collective and are
    refused."""
    import torch.distributed as dist

    local = np.asarray(local)
    if not np.issubdtype(local.dtype, np.number):
        raise TypeError(
            "multi-host streamed fits need numeric targets/weights (the "
            f"cross-process gather cannot move dtype {local.dtype!r}); "
            "encode labels to integers before streaming"
        )
    # one dtype every process agrees on: int64 while every process holds
    # integers, else float64 (a float32 value widens exactly)
    kinds = _allgather_counts(1 if local.dtype.kind == "f" else 0)
    wide = np.float64 if kinds.any() else np.int64
    width = int(counts.max(initial=1))
    buf = np.zeros(width, wide)
    buf[: len(local)] = local
    dev = _gather_device()
    mine = torch.from_numpy(buf).to(dev)
    every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    out = np.concatenate([
        e.cpu().numpy()[: int(c)] for e, c in zip(every, counts)
    ])
    return out if kinds.any() else out.astype(local.dtype)


class StreamRowProvider:
    """Raw-row gather over the chunk stream: the refine tail's data
    source when no matrix exists (``core/hybrid_builder._GatheredRows``).

    ``gather(rows)`` makes ONE pass over the source and returns the
    requested global rows as a dense f32 block in ``rows`` order
    (``rows`` must be sorted ascending; refine candidates' row sets are
    disjoint, so their sorted union qualifies). Host residency is one
    chunk plus the gathered block — the refine tail's candidates are a
    small fraction of the training set by construction.
    """

    def __init__(self, ds: StreamedDataset, *, n_rows: int,
                 row_offset: int = 0):
        self._ds = ds
        self.n_rows = int(n_rows)
        self.row_offset = int(row_offset)

    def gather(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, np.int64)
        out = None
        pos = self.row_offset
        found = 0
        for X, _, _ in self._ds.chunks(validate=False):
            n = X.shape[0]
            lo, hi = np.searchsorted(rows, [pos, pos + n])
            if hi > lo:
                if out is None:
                    out = np.empty((len(rows), X.shape[1]), np.float32)
                out[lo:hi] = X[rows[lo:hi] - pos]
                found += hi - lo
            pos += n
        if found != len(rows):
            raise ValueError(
                f"streamed refine gather found {found}/{len(rows)} rows "
                "in the local chunk stream — multi-host streamed refine "
                "needs every process's rows and is not supported; set "
                "refine_depth=None for multi-host streamed fits"
            )
        return out


class IngestResult:
    """What one ingest produces: the placed ``StreamedBinnedData``, the
    host's per-row targets and weights, and ``stats`` (the estimators'
    ``ingest_stats_``). ``close()`` releases the spill store (a no-op for
    a repeatable source)."""

    def __init__(self, binned, y, sample_weight, stats, *, dataset=None,
                 spill=None, row_offset: int = 0):
        self.binned = binned
        self.y = y
        self.sample_weight = sample_weight
        self.stats = stats
        self.dataset = dataset
        self.spill = spill
        self.row_offset = int(row_offset)

    def row_provider(self) -> StreamRowProvider | None:
        """A raw-row gather handle for the refine tail (None when the
        source is unknown)."""
        if self.dataset is None:
            return None
        return StreamRowProvider(
            self.dataset, n_rows=int(self.binned.n_samples),
            row_offset=self.row_offset,
        )

    def close(self) -> None:
        if self.spill is not None:
            self.spill.close()
            self.spill = None


def ingest_dataset(ds: StreamedDataset, *, mesh, max_bins: int = 256,
                   binning: str = "auto", obs=None) -> IngestResult:
    """Run both passes and place the binned matrix in ``mesh``'s shards
    (``parallel/mesh.Mesh``: a one-shard mesh for one device). ``obs``
    (a fit's observer) gets the JAX package's ``ingest`` decision (and
    ``ingest_spill`` where a one-shot source spills).

    Across processes each streams its own shard (``ds`` built from
    ``shard_for_process``-dealt paths); its global row offset comes from
    the all-gathered row counts, and the targets and weights are gathered
    so that every process holds every row's."""
    if binning not in ("auto", "exact", "quantile"):
        raise ValueError(f"unknown binning mode: {binning!r}")
    # a one-shot source rides the spill rung (or is refused, the knob
    # named) before the first pass consumes it
    ds.source, spill_store = spill_mod.resolve_spill(ds.source, obs=obs)
    t0 = time.perf_counter()
    sketches, y_local, w_local = sketch_dataset(ds)
    sketch_s = time.perf_counter() - t0

    n_local = len(y_local)
    row_offset = 0
    n_rows = sketches.n_rows  # global after merge_across_processes
    rank, size = _world()
    if size > 1:
        counts = _allgather_counts(n_local)
        row_offset = int(counts[:rank].sum())
        # targets and weights are global like the matrix: the build's
        # per-row state and the classifier's label encoding span every
        # process's rows (a class absent from one shard must not change
        # that process's classes_)
        y_local = _allgather_rows(y_local, counts)
        if w_local is not None:
            w_local = _allgather_rows(w_local, counts)

    thresholds, n_cand, n_bins, quantized = sketches.to_thresholds(
        max_bins=max_bins, binning=binning
    )
    F = sketches.n_features
    chunk_rows = ds.resolve_chunk_rows() or memory_lib.ingest_chunk_rows(F)
    # the ingest's ledger (the JAX package's :287-300), on the fit's
    # observer; the build records its own plan after it
    from mpitree_tpu_torch.parallel.mesh import data_shards, feature_shards

    plan = memory_lib.plan_ingest(
        rows=n_rows, features=F, chunk_rows=chunk_rows,
        sketch_capacity=ds.sketch_capacity,
        mesh_axes={"data": data_shards(mesh),
                   "feature": feature_shards(mesh)},
        max_bins=max_bins,
        spill_bytes=None if spill_store is None else int(spill_store.bytes))
    if obs is not None:
        obs.memory_plan(plan)

    t1 = time.perf_counter()
    # validate=False: the sketch pass already proved every row finite
    shards, lay = place_mod.assemble_binned(
        mesh,
        (bin_with_thresholds(X, thresholds, n_cand)
         for X, _, _ in ds.chunks(validate=False)),
        n_rows=n_rows, n_features=F, row_offset=row_offset,
    )
    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    place_s = time.perf_counter() - t1

    binned = StreamedBinnedData(
        x_binned=shards, thresholds=thresholds, n_cand=n_cand,
        n_bins=n_bins, quantized=quantized, n_rows=n_rows,
        chunk_rows=int(chunk_rows), rows_pad=lay["rows_pad"],
        feat_pad=lay["feat_pad"],
    )
    stats = {
        "rows": int(n_rows),
        "rows_local": int(n_local),
        "features": int(F),
        "chunk_rows": int(chunk_rows),
        "n_bins": int(n_bins),
        "quantized": bool(quantized),
        "sketch_exact": bool(sketches.exact),
        "sketch_bytes": int(sketches.nbytes()),
        "sketch_s": round(sketch_s, 4),
        "bin_place_s": round(place_s, 4),
        "rows_per_s_host": (
            round(n_local / (sketch_s + place_s), 1)
            if sketch_s + place_s > 0 else None
        ),
    }
    if obs is not None:
        obs.decision(
            "ingest", "streamed",
            reason=(
                "fit(dataset=...): chunked sketch+bin ingest — the raw "
                "matrix never materializes on host; chunk size derived "
                f"from the {memory_lib.HOST_BUDGET_ENV} planner budget"
            ),
            **{k: stats[k] for k in (
                "rows", "features", "chunk_rows", "quantized",
                "sketch_exact",
            )},
        )
    host_rss = memory_lib.host_rss_bytes()
    if host_rss:
        stats["host_rss_bytes"] = int(host_rss)
    if spill_store is not None:
        stats["spill_bytes"] = int(spill_store.bytes)
        stats["spill_chunks"] = len(spill_store.names)
    return IngestResult(
        binned, y_local, w_local, stats,
        dataset=ds, spill=spill_store, row_offset=row_offset,
    )
