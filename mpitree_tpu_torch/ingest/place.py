"""Chunk-at-a-time placement: binned chunks land straight in their shards
on the fit's devices, so no host ever holds the assembled matrix.

Counterpart of ``mpitree_tpu/ingest/place.py``. The JAX package scatters
each chunk into per-device buffers with a donated
``dynamic_update_slice`` and assembles one global array; the port has no
global array, so :func:`assemble_binned` returns this process's local
shards (``ops/binning.StreamedBinnedData``), laid out by
``parallel/partition.layout``:

- each local shard is allocated once, on its device
  (``torch.zeros(..., device=dev)``), never built on the host and copied;
- each binned chunk's row and column blocks are copied into their shards.
  On the card the chunk goes through one pinned staging buffer with
  ``non_blocking=True`` copies, and the next chunk waits on the copies'
  events before it reuses the buffer, so binning the next chunk overlaps
  the copy of this one and at most one chunk and one staging buffer live
  on the host;
- several processes: each fills only the row blocks its local shards
  own, starting at its global ``row_offset``; its rows must cover exactly
  those blocks, else the assembly raises (it never drops rows).

:func:`gather_matrix` is the forests' one move of the placed matrix: the
whole ``(N, F)`` matrix on the lead device, once per fit, which the
``(tree, data)`` mesh then re-slices per tree group as it slices an
in-memory matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from mpitree_tpu_torch.parallel import partition
from mpitree_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    data_shards,
    feature_shards,
)


def shard_blocks(mesh) -> list:
    """Every local shard's ``(row block, feature block)`` on ``mesh``."""
    names = mesh.axis_names
    out = []
    for i in range(mesh.n_local):
        c = mesh.coords(i)
        out.append((c[names.index(DATA_AXIS)] if DATA_AXIS in names else 0,
                    c[names.index(FEATURE_AXIS)] if FEATURE_AXIS in names
                    else 0))
    return out


def assemble_binned(mesh, binned_chunks, *, n_rows: int, n_features: int,
                    row_offset: int = 0) -> tuple:
    """Place int32 binned chunks into this process's shards of ``mesh``.

    ``binned_chunks`` yields ``(n_i, F)`` int32 numpy arrays in row order
    whose rows start at global row ``row_offset``; ``n_rows`` is the
    global row count. Returns ``(shards, layout)``: the local shards, in
    the mesh's local order, and ``partition.layout``'s dict."""
    lay = partition.layout(mesh, n_rows, n_features)
    sr, sc = lay["shard_rows"], lay["shard_cols"]
    dr = data_shards(mesh)
    blocks = shard_blocks(mesh)
    shards = [torch.zeros((sr, sc), dtype=torch.int32, device=dev)
              for dev in mesh.devices]
    by_row: dict = {}
    for i, (di, fi) in enumerate(blocks):
        by_row.setdefault(di, []).append((i, fi))
    cuda = [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]
    stage = None     # the pinned staging buffer (the card only)
    pending = []     # the events of the copies that read it
    covered = np.zeros(dr, np.int64)
    cursor = int(row_offset)
    for xb in binned_chunks:
        xb = np.ascontiguousarray(xb, np.int32)
        n = xb.shape[0]
        if xb.shape[1] != n_features:
            raise ValueError(
                f"binned chunk has {xb.shape[1]} features, expected "
                f"{n_features}"
            )
        if cuda:
            for ev in pending:
                ev.synchronize()
            pending = []
            if stage is None or stage.shape[0] < n:
                stage = torch.empty((n, n_features), dtype=torch.int32,
                                    pin_memory=True)
            src = stage[:n]
            src.copy_(torch.from_numpy(xb))
        else:
            src = torch.from_numpy(xb)
        lo = cursor
        while lo < cursor + n:
            di = lo // sr
            hi = min(cursor + n, (di + 1) * sr)
            if di in by_row:
                rows = src[lo - cursor:hi - cursor]
                for i, fi in by_row[di]:
                    c0 = fi * sc
                    w = min(sc, n_features - c0)
                    if w > 0:
                        shards[i][lo - di * sr:hi - di * sr, :w].copy_(
                            rows[:, c0:c0 + w], non_blocking=True)
                covered[di] += hi - lo
            lo = hi
        for d in cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            pending.append(ev)
        cursor += n
    for ev in pending:
        ev.synchronize()

    # every local row block must be exactly full (but the padding rows of
    # the last global block)
    for di in by_row:
        want = min(sr, max(n_rows - di * sr, 0))
        if int(covered[di]) != want:
            raise ValueError(
                f"ingest row block {di} got {int(covered[di])} rows, "
                f"expected {want}: each process's chunk stream must cover "
                "exactly its local devices' row blocks (align shard sizes "
                "or rebalance shard_for_process)"
            )
    return shards, lay


def gather_matrix(binned, mesh) -> torch.Tensor:
    """The whole ``(N, F)`` int32 matrix of a ``StreamedBinnedData``
    placed on ``mesh``, on ``mesh.lead``: the local shards copied into
    their blocks on the device and, across processes, one sum all-reduce
    over the mesh's process group (each block filled by one process;
    counted under ``exchange`` in ``mesh.stats``)."""
    from mpitree_tpu_torch.parallel import collective

    lead = mesh.lead
    sr = binned.rows_pad // data_shards(mesh)
    sc = binned.feat_pad // feature_shards(mesh)
    full = torch.zeros((binned.rows_pad, binned.feat_pad),
                       dtype=torch.int32, device=lead)
    for (di, fi), shard in zip(shard_blocks(mesh), binned.x_binned):
        full[di * sr:(di + 1) * sr, fi * sc:(fi + 1) * sc] = shard.to(lead)
    if mesh.group is not None:
        full = collective.psum([full], mesh, kind="exchange")
    return full[:binned.n_samples, :binned.n_features].contiguous()
