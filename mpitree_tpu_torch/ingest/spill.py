"""Spill-to-disk rung for one-shot chunk iterators.

Counterpart of ``mpitree_tpu/ingest/spill.py``. The ingest streams its
source at least twice (the sketch pass, then the bin and place pass; a
refine tail adds a raw-row pass), so a source must be repeatable. A
one-shot iterator (a socket reader, a database cursor, a generator the
caller cannot restart) can still stream when the first pass tees every
chunk to disk and later passes replay the spill.

Each chunk lands as ``chunk-NNNNNN.npz`` through write-then-
``os.replace``, and a JSON manifest is written last: a spill directory
without one is an aborted first pass, which replay refuses rather than
serve a partial stream. The store is capped (``MPITREE_TPU_SPILL_BYTES``):
crossing the cap raises before the chunk is kept.
"""

from __future__ import annotations

import io
import json
import os
import tempfile

import numpy as np

from mpitree_tpu_torch.config import knobs

MANIFEST = "manifest.json"
SPILL_VERSION = 1


def _atomic_bytes(path: str, payload: bytes) -> None:
    """Write-tmp-then-replace: readers never observe a partial file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class SpillStore:
    """One ingest run's on-disk chunk tail: append → commit → replay."""

    def __init__(self, directory: str, *, cap_bytes: int | None = None):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.cap_bytes = int(
            knobs.value("MPITREE_TPU_SPILL_BYTES")
            if cap_bytes is None else cap_bytes
        )
        self.bytes = 0
        self.names: list = []
        self.rows = 0
        self.weighted = False
        self.committed = False

    # -- first pass --------------------------------------------------------
    def append(self, X: np.ndarray, y: np.ndarray, w) -> None:
        """Spill one normalized chunk; refuses past the size cap."""
        buf = io.BytesIO()
        arrays = {"X": X, "y": y}
        if w is not None:
            arrays["w"] = w
            self.weighted = True
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        if self.bytes + len(payload) > self.cap_bytes:
            raise RuntimeError(
                f"spill store at {self.dir} would exceed its "
                f"MPITREE_TPU_SPILL_BYTES cap ({self.cap_bytes} bytes) at "
                f"chunk {len(self.names)} ({self.bytes + len(payload)} "
                "bytes total): raise the cap, shrink the stream, or hand "
                "the pipeline a re-iterable source"
            )
        name = f"chunk-{len(self.names):06d}.npz"
        _atomic_bytes(os.path.join(self.dir, name), payload)
        self.bytes += len(payload)
        self.rows += int(X.shape[0])
        self.names.append(name)

    def commit(self) -> None:
        """Manifest write = the commit point (checkpoint discipline)."""
        manifest = {
            "version": SPILL_VERSION,
            "chunks": self.names,
            "rows": int(self.rows),
            "bytes": int(self.bytes),
            "weighted": bool(self.weighted),
        }
        _atomic_bytes(
            os.path.join(self.dir, MANIFEST),
            json.dumps(manifest, indent=0).encode(),
        )
        self.committed = True

    # -- replay ------------------------------------------------------------
    def chunks(self, chunk_rows=None, *, validate: bool = True):
        """Replay the committed stream at its recorded chunk shapes
        (``chunk_rows`` is ignored, like ``NpzShards``)."""
        path = os.path.join(self.dir, MANIFEST)
        if not os.path.exists(path):
            raise RuntimeError(
                f"spill store at {self.dir} has no manifest: the first "
                "pass never committed (aborted stream?) — refusing to "
                "replay a partial spill"
            )
        with open(path) as f:
            manifest = json.load(f)
        for name in manifest["chunks"]:
            with np.load(os.path.join(self.dir, name)) as z:
                yield (
                    z["X"], z["y"],
                    z["w"] if manifest["weighted"] else None,
                )

    def close(self) -> None:
        """Best-effort cleanup of the spill files and directory."""
        try:
            for name in os.listdir(self.dir):
                if name == MANIFEST or name.startswith("chunk-"):
                    os.unlink(os.path.join(self.dir, name))
            os.rmdir(self.dir)
        except OSError:
            pass  # a stray file or a racing reader: leave the directory


class SpillTee:
    """A one-shot source made repeatable: the first ``.chunks()`` pass
    drains the underlying iterator while teeing every chunk into the
    store; every later pass replays from disk."""

    one_shot = False  # the whole point

    def __init__(self, source, store: SpillStore):
        self._source = source
        self.store = store
        self.n_features = getattr(source, "n_features", None)
        self.n_rows = getattr(source, "n_rows", None)

    def chunks(self, chunk_rows=None, *, validate: bool = True):
        if self.store.committed:
            yield from self.store.chunks(chunk_rows, validate=validate)
            return
        for X, y, w in self._source.chunks(chunk_rows, validate=validate):
            self.store.append(X, y, w)
            yield X, y, w
        self.store.commit()


def resolve_spill(source, *, obs=None):
    """Gate a one-shot source through the spill rung.

    Re-iterable sources pass through untouched. A one-shot source needs
    ``MPITREE_TPU_SPILL_DIR``; with it set, the source is wrapped in a
    :class:`SpillTee` over a fresh store directory under it, and ``obs``
    (a fit's observer) gets the typed ``ingest_spill`` decision. Returns
    ``(source, store or None)``."""
    if not getattr(source, "one_shot", False):
        return source, None
    spill_dir = knobs.value("MPITREE_TPU_SPILL_DIR")
    if not spill_dir:
        raise ValueError(
            "one-shot chunk iterator with no spill rung: the ingest "
            "pipeline streams its source more than once (sketch, then "
            "bin+place), so a bare iterator must spill — set "
            "MPITREE_TPU_SPILL_DIR to a scratch directory (size-capped "
            "by MPITREE_TPU_SPILL_BYTES) or pass a re-iterable source "
            "(a zero-arg factory, shard paths, or a chunk list)"
        )
    store = SpillStore(
        tempfile.mkdtemp(prefix="spill-", dir=str(spill_dir))
    )
    if obs is not None:
        obs.decision(
            "ingest_spill", "spill",
            reason=(
                "one-shot chunk iterator: first pass tees every chunk to "
                "disk (atomic chunk files, manifest-last commit) so the "
                "bin+place and refine passes replay from the spill"
            ),
            dir=store.dir, cap_bytes=int(store.cap_bytes),
        )
    return SpillTee(source, store), store
