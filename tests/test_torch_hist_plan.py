"""The histogram kernels' host side on the CPU: row order, byte-wide bins,
planner and tiling.

The kernels themselves (``csrc/histogram.cu``) run only on the card
(``tests/test_torch_cuda.py``); what they are told to do is decided in
Python (``ops/hist_kernel.py``) and is tested here:

- :func:`hist_kernel.slot_segments` against numpy: every row of a slot in
  range appears once, in its slot's segment; rows out of range in none;
  empty slots have empty segments;
- :func:`hist_kernel.pack_bins` round trip and refusals;
- a plain-PyTorch replay of the planner's tiling — segments -> row pieces
  (:func:`hist_kernel.block_pieces`, the kernel's block decode) -> feature
  groups -> ragged shared-memory tile -> store-or-combine flush, in block
  order into an output that starts as NaN — equals
  :func:`hist_kernel.histogram_reference`. Tolerance: exact (integer
  payloads sum exactly in float32 in any order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpitree_tpu_torch.ops import hist_kernel

# (N, F, C, B, S), as in tests/test_torch_histogram.py
CASES = [
    (2000, 3, 2, 5, 1),
    (3000, 6, 7, 32, 8),
    (2500, 4, 3, 256, 8),
    (4000, 5, 7, 32, 64),
    (5000, 2, 3, 5, 256),
    (3000, 3, 7, 256, 256),
]


def _inputs(seed, N, F, C, B, S, *, skew=False):
    """Bins (the even features two-bin, like one-hot columns), an integer
    class payload with zero-weight rows, and slots from -2 to S + 1; with
    ``skew`` one slot holds 60% of the rows and every fourth slot is
    empty."""
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, B, size=(N, F)).astype(np.int32)
    xb[:, ::2] %= 2
    y = rng.integers(0, C, size=N)
    w = rng.integers(0, 4, size=N).astype(np.float32)
    payload = np.zeros((N, C), np.float32)
    payload[np.arange(N), y] = w
    slot = rng.integers(-2, S + 2, size=N).astype(np.int32)
    if skew:
        live = np.array([s for s in range(S) if s % 4 != 3])
        slot = live[rng.integers(0, len(live), N)].astype(np.int32)
        slot[rng.random(N) < 0.6] = live[len(live) // 2]
        slot[rng.random(N) < 0.05] = -1
    return (torch.from_numpy(xb), torch.from_numpy(payload),
            torch.from_numpy(slot))


@pytest.mark.parametrize("S", [1, 8, 300, 40_000])
def test_slot_segments_against_numpy(S):
    rng = np.random.default_rng(S)
    N = 5_000
    slot = rng.integers(-3, S + 3, size=N).astype(np.int32)
    slot[slot == min(2, S - 1)] = -1  # an empty slot
    order, seg = hist_kernel.slot_segments(torch.from_numpy(slot), S)
    assert order.dtype == torch.int32 and order.shape == (N,)
    assert seg.dtype == torch.int32 and seg.shape == (S + 1,)
    order, seg = order.numpy(), seg.numpy()
    assert seg[0] == (slot < 0).sum() and (np.diff(seg) >= 0).all()
    assert sorted(order.tolist()) == list(range(N))  # a permutation
    in_range = (slot >= 0) & (slot < S)
    assert seg[S] - seg[0] == in_range.sum()
    np.testing.assert_array_equal(np.diff(seg),
                                  np.bincount(slot[in_range], minlength=S))
    # every position of a segment holds a row of that slot
    np.testing.assert_array_equal(slot[order[seg[0]:seg[S]]],
                                  np.repeat(np.arange(S), np.diff(seg)))
    assert not in_range[order[seg[S]:]].any()
    assert not in_range[order[:seg[0]]].any()
    assert seg[min(2, S - 1) + 1] == seg[min(2, S - 1)]


def test_pack_bins_round_trip_and_refusals():
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.integers(0, 256, size=(100, 54)).astype(np.int32))
    packed = hist_kernel.pack_bins(xb, 256)
    assert packed.dtype == torch.uint8 and packed.shape == (100, 64)
    assert packed.is_contiguous()
    assert torch.equal(packed[:, :54].to(torch.int32), xb)
    assert not packed[:, 54:].any()
    assert hist_kernel.pack_bins(xb[:, :16], 256).shape == (100, 16)
    with pytest.raises(ValueError, match="n_bins <= 256"):
        hist_kernel.pack_bins(xb, 257)
    with pytest.raises(ValueError, match="outside"):
        hist_kernel.pack_bins(xb - 1, 256)
    with pytest.raises(ValueError, match="outside"):
        hist_kernel.pack_bins(xb, 200)


def _replay(xb, payload, order, seg, p, *, S, B, n_rows):
    """The sorted route as the kernel runs it, in plain PyTorch."""
    F, C = xb.shape[1], payload.shape[1]
    P = p["piece_rows"]
    out = torch.full((S, F, C, B), float("nan"))
    lens = (seg[1:] - seg[:-1]).tolist()
    for s in range(S):  # hist_zero_split_kernel
        if lens[s] > P:
            out[s] = 0.0
    stores = np.zeros((S, len(p["groups"])), int)
    pieces = hist_kernel.block_pieces(seg, S, P, n_rows)
    for g, (f0, f1) in enumerate(p["groups"]):
        nb = p["feat_bins"][f0:f1]
        off = p["feat_offset"][f0:f1]
        for s, a, b, owned in pieces:
            assert 0 <= b - a <= P
            tile = torch.zeros(p["group_cells"][g])
            row = p["group_cells"][g] // C  # cells of one channel's row
            rows = order[a:b].long()
            for r in rows.tolist():
                for c in torch.nonzero(payload[r]).flatten().tolist():
                    for j in range(f1 - f0):
                        bin_ = int(xb[r, f0 + j])
                        if 0 <= bin_ < nb[j]:
                            tile[c * row + off[j] + bin_] += payload[r, c]
            dense = torch.zeros((f1 - f0, C, B))
            for j in range(f1 - f0):
                for c in range(C):
                    lo = c * row + off[j]
                    dense[j, c, :nb[j]] = tile[lo:lo + nb[j]]
            if owned:
                out[s, f0:f1] = dense
                stores[s, g] += 1
            else:
                out[s, f0:f1] += dense
    # an owned slot is stored once per group, a split slot never
    want = np.array([[int(n <= P)] * len(p["groups"]) for n in lens])
    np.testing.assert_array_equal(stores, want)
    return out


def _check_replay(xb, payload, slot, *, S, B, piece_rows, feat_bins, cells):
    N, F = xb.shape
    C = payload.shape[1]
    # shared memory for ``cells`` tile cells and no more: several groups
    smem = 4 * cells + hist_kernel._feat_bytes(F) + 8 * piece_rows
    p = hist_kernel.plan(S, F, C, B, "sorted", feat_bins=feat_bins, n_rows=N,
                         smem_bytes=smem, piece_rows=piece_rows)
    assert p["smem"] <= smem and len(p["groups"]) >= 2
    assert p["piece_rows"] == piece_rows
    order, seg = hist_kernel.slot_segments(slot, S)
    got = _replay(xb, payload, order, seg, p, S=S, B=B, n_rows=N)
    want = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                           n_bins=B)
    assert torch.equal(got, want)  # no NaN left: every cell was written


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "N{}F{}C{}B{}S{}".format(*c))
def test_replay_of_the_tiling_equals_plain_version(case):
    N, F, C, B, S = case
    xb, payload, slot = _inputs(sum(case), *case)
    N = 600  # the replay is a Python loop over rows
    xb, payload, slot = xb[:N], payload[:N], slot[:N]
    feat_bins = (xb.max(dim=0).values + 1).tolist()
    _check_replay(xb, payload, slot, S=S, B=B, piece_rows=32,
                  feat_bins=feat_bins, cells=C * (max(feat_bins) | 1) + 3)


def test_replay_with_a_skewed_frontier():
    """One slot holds 60% of the rows (split into many pieces), several
    are empty (their zeros come from the block that owns them)."""
    N, F, C, B, S = 800, 4, 3, 16, 12
    xb, payload, slot = _inputs(5, N, F, C, B, S, skew=True)
    counts = np.bincount(slot.numpy()[slot.numpy() >= 0], minlength=S)
    assert counts.max() > 0.5 * N and (counts == 0).sum() >= 3
    _check_replay(xb, payload, slot, S=S, B=B, piece_rows=64,
                  feat_bins=None, cells=C * (B | 1) * 2 + 3)


@pytest.mark.parametrize("n_rows,piece_rows", [(1000, 32), (1000, 1000),
                                                (37, 64), (4096, 256)])
def test_block_pieces_cover_every_position_once(n_rows, piece_rows):
    """The kernel's block decode, over a chunk whose segments start at an
    offset into the level's order (``seg_start[0] > 0``)."""
    rng = np.random.default_rng(n_rows + piece_rows)
    S = 9
    lens = rng.multinomial(n_rows // 2, [.5, 0, .2, .1, 0, .1, .05, .05, 0])
    seg = np.concatenate([[n_rows // 4], n_rows // 4 + np.cumsum(lens)])
    pieces = hist_kernel.block_pieces(seg, S, piece_rows, n_rows)
    seen = np.zeros(n_rows, int)
    for s, a, b, owned in pieces:
        assert seg[s] <= a <= b <= seg[s + 1] and b - a <= piece_rows
        assert owned == (lens[s] <= piece_rows)
        seen[a:b] += 1
    assert (seen[seg[0]:seg[S]] == 1).all()
    assert not seen[:seg[0]].any() and not seen[seg[S]:].any()
    assert [p[0] for p in pieces[:S]] == list(range(S))


def test_reference_reads_the_prepared_arguments():
    """``packed``, ``order`` and ``seg_start`` are read, not ignored: the
    plain version takes a row's slot from its segment and its bins from
    the packed copy."""
    N, F, C, B, S = 500, 5, 3, 9, 6
    xb, payload, slot = _inputs(1, N, F, C, B, S)
    want = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                           n_bins=B)
    order, seg = hist_kernel.slot_segments(slot, S)
    packed = hist_kernel.pack_bins(xb, B)
    junk = torch.zeros_like(slot)
    got = hist_kernel.histogram(torch.zeros_like(xb), payload, junk,
                                n_slots=S, n_bins=B, packed=packed,
                                order=order, seg_start=seg)
    assert torch.equal(got, want)
    # a chunk of a wider level: offsets into the level's order
    order2, seg2 = hist_kernel.slot_segments(slot + 3, S + 6)
    got = hist_kernel.histogram(xb, payload, junk, n_slots=S, n_bins=B,
                                order=order2, seg_start=seg2[3:3 + S + 1])
    assert torch.equal(got, want)
