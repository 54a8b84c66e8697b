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

:func:`regroup_matrix` is the forests' one move of the placed matrix
(the JAX package pads the stream's global array for the forest mesh and
reshards it, ``mpitree_tpu/core/fused_builder.py:1276-1324``): each
shard of a ``(tree, data)`` mesh gets the row block its tree group's
data axis gives it, at the ingest's width (int32). Rows this process
placed are copied on the device; rows another process placed come from
that process, only those, each interval once, by a broadcast between
the two (counted under ``exchange`` in ``mesh.stats``). Where the
forest's data axis lines up with the ingest's, nothing crosses a
process.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mpitree_tpu_torch.parallel import collective, partition
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


def _overlap(a: int, b: int, c: int, d: int):
    lo, hi = max(a, c), min(b, d)
    return (lo, hi) if lo < hi else None


def _merged(spans: list) -> list:
    """Sorted disjoint ``(lo, hi)`` intervals covering ``spans``."""
    out: list = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def regroup_matrix(binned, src, dst) -> list:
    """The int32 row blocks of a ``StreamedBinnedData`` placed on the 1-D
    data mesh ``src`` that the local shards of ``dst`` (the same shards
    as a ``(tree, data)`` mesh, ``parallel/mesh.as_tree_data_mesh``)
    take, in ``dst``'s local order: shard ``g`` of tree group
    ``g // Dd`` holds rows ``[d * p, (d + 1) * p)``, ``d = g % Dd`` and
    ``p`` the rows padded to ``Dd`` over ``Dd``, zero past the real rows
    (padding rows, which the build keeps at ``node_id = -1``, weight 0).

    Every process computes the same plan: for each process, the rows its
    shards need that another process placed, as merged intervals per
    owner. Each interval is broadcast by its owner within the pair of
    processes (``mesh._subgroup``, made by every process in plan order),
    so a process receives exactly the rows it lacks, once; the received
    bytes and seconds count under ``exchange``. Nothing else crosses a
    process, and no device holds more than its shards' blocks and the
    received intervals."""
    import torch.distributed as dist

    from mpitree_tpu_torch.parallel.mesh import _subgroup, pad_rows

    if feature_shards(src) != 1 or src.n_local != dst.n_local:
        raise ValueError("a forest regroups a stream placed on a 1-D data "
                         "mesh of its own shards")
    N, F = binned.n_samples, binned.n_features
    n_local = src.n_local
    sr = binned.rows_pad // data_shards(src)     # an ingest block's rows
    Dd = data_shards(dst)
    per = (N + pad_rows(N, Dd)) // Dd           # a forest shard's rows
    P = src.n_procs

    def need(g):  # global forest shard g's real rows
        d = g % Dd
        return _overlap(d * per, (d + 1) * per, 0, N)

    def held(q):  # the real rows process q placed (contiguous blocks)
        return _overlap(q * n_local * sr, (q + 1) * n_local * sr, 0, N)

    plan = []  # (needer, owner, lo, hi), the same on every process
    for p in range(P):
        spans = [need(g) for g in range(p * n_local, (p + 1) * n_local)]
        for lo, hi in _merged([sp for sp in spans if sp is not None]):
            for q in range(P):
                part = None if q == p or held(q) is None else _overlap(
                    lo, hi, *held(q))
                if part is not None:
                    plan.append((p, q) + part)

    me, lead = src.rank, src.lead
    ranks = (list(range(P)) if src.group is None
             else dist.get_process_group_ranks(src.group))
    got = []  # (lo, hi, tensor) received by this process
    for d in dict.fromkeys(sh.device for sh in binned.x_binned):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    n_bytes = calls = 0
    for p, q, lo, hi in plan:
        group = _subgroup(tuple(sorted((ranks[p], ranks[q]))))
        if me == q:
            buf = _local_rows(binned, src, lo, hi, sr, lead)
        elif me == p:
            buf = torch.empty((hi - lo, F), dtype=torch.int32, device=lead)
        else:
            continue
        dist.broadcast(buf, src=ranks[q], group=group)
        if me == p:
            got.append((lo, hi, buf))
            n_bytes += buf.numel() * buf.element_size()
            calls += 1
    if calls:
        if lead.type == "cuda":
            torch.cuda.synchronize(lead)
        collective._count(src, "exchange", n_bytes,
                          time.perf_counter() - t0, site="row_exchange",
                          calls=calls)

    out = []
    for i, dev in enumerate(dst.devices):
        g = dst.shard_index(i)
        x = torch.zeros((per, F), dtype=torch.int32, device=dev)
        span = need(g)
        if span is not None:
            base = (g % Dd) * per
            for lo, hi, buf in got:
                part = _overlap(*span, lo, hi)
                if part is not None:
                    x[part[0] - base:part[1] - base] = buf[
                        part[0] - lo:part[1] - lo].to(dev)
            if held(me) is not None:
                part = _overlap(*span, *held(me))
                if part is not None:
                    x[part[0] - base:part[1] - base] = _local_rows(
                        binned, src, *part, sr, dev)
        out.append(x)
    return out


def _local_rows(binned, src, lo: int, hi: int, sr: int,
                dev) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the matrix from this process's own shards of
    the 1-D mesh ``src`` (its blocks of ``sr`` rows), on ``dev``."""
    parts = []
    for i, shard in enumerate(binned.x_binned):
        b = src.shard_index(i)
        part = _overlap(lo, hi, b * sr, (b + 1) * sr)
        if part is not None:
            parts.append(shard[part[0] - b * sr:part[1] - b * sr,
                               :binned.n_features].to(dev))
    return torch.cat(parts) if len(parts) > 1 else parts[0].contiguous()
