"""Chunk sources: how host-chunked input reaches the ingest.

Counterpart of ``mpitree_tpu/ingest/chunks.py``. A chunk source is
anything whose :meth:`chunks` yields ``(X, y)`` or ``(X, y, w)`` tuples of
aligned numpy arrays, repeatably: the pipeline streams the source twice
(the sketch pass, then the bin and place pass), so a one-shot generator
comes wrapped (:class:`IterChunks`) and spills (``ingest/spill.py``).
Sources that know their shape up front (:class:`ArrayChunks`,
:class:`NpyShards`) expose ``n_features``/``n_rows`` so the chunk size can
be derived before the first chunk is read.

``.npy`` shards open memory-mapped (``np.load(mmap_mode="r")``): slicing
``chunk_rows`` at a time faults in only those pages, so host residency
stays one chunk whatever the shard's size. ``.npz`` members cannot be
mapped: each shard is one chunk there.

Several processes: :func:`shard_for_process` deals a shard list
contiguously over the ``torch.distributed`` processes
(``parallel/distributed.initialize``), each of which streams only its
slice; the sketch and the placement merge them.
"""

from __future__ import annotations

import glob as glob_mod

import numpy as np


def _normalize(item, validate: bool = True) -> tuple:
    """One yielded item -> (X f32 (n, F), y (n,), w (n,)|None).

    ``validate=False`` skips the O(n*F) finiteness sweep — the pipeline
    streams every source twice, and the bin+place pass re-reads rows the
    sketch pass already proved finite (a second full scan of an
    out-of-core dataset would be pure overhead).
    """
    if not isinstance(item, (tuple, list)) or len(item) not in (2, 3):
        raise TypeError(
            "chunk sources must yield (X, y) or (X, y, sample_weight) "
            f"tuples, got {type(item).__name__}"
        )
    X = np.ascontiguousarray(item[0], dtype=np.float32)
    if X.ndim != 2:
        raise ValueError(f"chunk X must be 2-D, got shape {X.shape}")
    if validate and not np.isfinite(X).all():
        raise ValueError(
            "chunk X contains NaN/inf: streamed ingestion requires finite "
            "features (the sketch's sorted-unique merge has no NaN "
            "collapse; clean or impute before streaming)"
        )
    y = np.asarray(item[1])
    if y.shape != (X.shape[0],):
        raise ValueError(
            f"chunk y has shape {y.shape}, expected ({X.shape[0]},)"
        )
    w = None
    if len(item) == 3 and item[2] is not None:
        w = np.ascontiguousarray(item[2], dtype=np.float32)
        if w.shape != (X.shape[0],):
            raise ValueError(
                f"chunk sample_weight has shape {w.shape}, expected "
                f"({X.shape[0]},)"
            )
    return X, y, w


class ArrayChunks:
    """In-memory arrays re-chunked — the testing/identity-grid source."""

    def __init__(self, X, y, sample_weight=None, *, chunk_rows=None):
        self.X = np.asarray(X)
        self.y = np.asarray(y)
        self.w = None if sample_weight is None else np.asarray(sample_weight)
        self.chunk_rows = chunk_rows

    @property
    def n_rows(self) -> int:
        return self.X.shape[0]

    @property
    def n_features(self) -> int:
        return self.X.shape[1]

    def chunks(self, chunk_rows=None, *, validate=True):
        rows = int(chunk_rows or self.chunk_rows or max(self.n_rows, 1))
        for lo in range(0, self.n_rows, rows) or [0]:
            hi = min(lo + rows, self.n_rows)
            yield _normalize((
                self.X[lo:hi], self.y[lo:hi],
                None if self.w is None else self.w[lo:hi],
            ), validate)


class NpyShards:
    """Memory-mapped ``.npy`` shard pairs, sliced ``chunk_rows`` at a time."""

    def __init__(self, x_paths, y_paths, weight_paths=None, *,
                 chunk_rows=None):
        self.x_paths = _expand(x_paths)
        self.y_paths = _expand(y_paths)
        self.w_paths = None if weight_paths is None else _expand(weight_paths)
        if len(self.x_paths) != len(self.y_paths):
            raise ValueError(
                f"{len(self.x_paths)} X shards vs {len(self.y_paths)} "
                "y shards: shard lists must pair up"
            )
        if self.w_paths is not None and len(self.w_paths) != len(self.x_paths):
            raise ValueError("weight shard list must pair with X shards")
        if not self.x_paths:
            raise ValueError("no shards matched")
        self.chunk_rows = chunk_rows

    @property
    def n_features(self) -> int:
        return int(np.load(self.x_paths[0], mmap_mode="r").shape[1])

    @property
    def n_rows(self) -> int:
        return sum(
            int(np.load(p, mmap_mode="r").shape[0]) for p in self.x_paths
        )

    def chunks(self, chunk_rows=None, *, validate=True):
        rows = self.chunk_rows if chunk_rows is None else chunk_rows
        for i, xp in enumerate(self.x_paths):
            X = np.load(xp, mmap_mode="r")
            y = np.load(self.y_paths[i], mmap_mode="r")
            w = (None if self.w_paths is None
                 else np.load(self.w_paths[i], mmap_mode="r"))
            step = int(rows or len(X) or 1)
            for lo in range(0, len(X), step) or [0]:
                hi = min(lo + step, len(X))
                # np.array(...) faults in just this window's pages; the
                # mmap itself never materializes whole.
                yield _normalize((
                    np.array(X[lo:hi]), np.array(y[lo:hi]),
                    None if w is None else np.array(w[lo:hi]),
                ), validate)


class NpzShards:
    """``.npz`` shard files — one chunk per file (members cannot mmap)."""

    def __init__(self, paths, *, x_key="X", y_key="y", weight_key=None):
        self.paths = _expand(paths)
        if not self.paths:
            raise ValueError("no shards matched")
        self.x_key, self.y_key, self.w_key = x_key, y_key, weight_key

    @property
    def n_features(self) -> int:
        with np.load(self.paths[0]) as z:
            return int(z[self.x_key].shape[1])

    def chunks(self, chunk_rows=None, *, validate=True):
        for p in self.paths:
            with np.load(p) as z:
                yield _normalize((
                    z[self.x_key], z[self.y_key],
                    z[self.w_key] if self.w_key else None,
                ), validate)


class IterChunks:
    """A re-iterable wrapped as a source: a zero-arg FACTORY returning a
    fresh ``(X, y[, w])`` iterator per pass (the pipeline streams more
    than once), or a list/tuple of chunk tuples. A bare one-shot
    iterator (a generator, a cursor) is accepted too, flagged
    ``one_shot`` — the ingest pipeline then requires the spill rung
    (``MPITREE_TPU_SPILL_DIR``) so later passes replay from disk."""

    n_features = None  # discovered from the first chunk
    n_rows = None
    one_shot = False

    def __init__(self, chunks_or_factory):
        if callable(chunks_or_factory):
            self._factory = chunks_or_factory
        elif isinstance(chunks_or_factory, (list, tuple)):
            items = list(chunks_or_factory)
            self._factory = lambda: iter(items)
        elif hasattr(chunks_or_factory, "__next__"):
            self._iter = chunks_or_factory
            self.one_shot = True
            self._factory = self._drain_once
        else:
            raise TypeError(
                "from_chunks wants a zero-arg factory returning a fresh "
                "iterator, a list of (X, y[, w]) tuples, or a one-shot "
                "iterator (which needs MPITREE_TPU_SPILL_DIR set so the "
                "pipeline's later passes can replay it from disk)"
            )

    def _drain_once(self):
        it, self._iter = self._iter, None
        if it is None:
            raise RuntimeError(
                "one-shot chunk iterator already consumed — the ingest "
                "pipeline streams its source more than once; spill was "
                "expected to replay this pass (MPITREE_TPU_SPILL_DIR)"
            )
        return it

    def chunks(self, chunk_rows=None, *, validate=True):
        for item in self._factory():
            yield _normalize(item, validate)


def _expand(paths) -> list:
    """A glob string, one path, or a path list -> sorted path list."""
    if isinstance(paths, (str, bytes)):
        hits = sorted(glob_mod.glob(paths))
        return hits if hits else [paths]
    return [str(p) for p in paths]


def shard_for_process(items: list, process_index: int | None = None,
                      process_count: int | None = None) -> list:
    """This process's contiguous slice of a shard list: each process reads
    only its shards (``parallel.distributed.initialize`` first, then build
    the source from ``shard_for_process(all_paths)``). The rank and the
    count default to this process's in the ``torch.distributed`` group
    (0 of 1 when none was joined)."""
    if process_index is None or process_count is None:
        from mpitree_tpu_torch.parallel.distributed import process_info

        info = process_info("cpu")
        process_index = info["process_index"]
        process_count = info["process_count"]
    k, n = int(process_count), len(items)
    lo = (n * int(process_index)) // k
    hi = (n * (int(process_index) + 1)) // k
    return list(items[lo:hi])
