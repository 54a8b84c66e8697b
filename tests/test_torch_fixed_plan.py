"""The fixed-point histogram body's host side on the CPU: planner and a
replay of the kernel's arithmetic.

``csrc/fixed_hist.cu`` (routes ``stream_fixed`` and ``sorted_fixed``) runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase
12). What it is told to do is decided in ``ops/hist_kernel.py`` and is
held here:

- :func:`hist_kernel._fixed_plan` (through :func:`hist_kernel.plan` with
  ``fixed=True``): shared memory within a block's 227 KB and, at two
  blocks an SM, within half the SM; the block size each route takes; the
  stream route's one wave of blocks over every row;
- the exactness bound: the exponents of
  :func:`hist_kernel.fixed_point_exponents` keep ``|q| <=
  2**(FIXED_POINT_BITS - ceil(log2 N))``, so no partial sum of a tile or
  of the output reaches ``2**63``, and a cell's two 32-bit words with the
  low word's carry hold it exactly;
- a plain replay of the kernel, numpy on the words the kernel keeps:
  blocks (the stream grid or ``block_pieces``), feature groups, batches of
  one row a thread quantized once, the batch's rows added in a shuffled
  order (the warps' race), a cell as two uint32 words added with the
  carry, rows with several nonzero channels added whole by their scanning
  thread, and the store-or-add flush into an output that starts as
  garbage where the kernel does not zero it. It equals
  :func:`hist_kernel.histogram_reference` bit for bit (integer sums:
  exact in any order) on negative gradients, ``h == 0`` rows (R7: the
  row adds nothing), the largest ``|q|`` the exponents allow, every row
  in one bin, a skewed frontier and a last block and batch that are cut
  short.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from mpitree_tpu_torch.ops import hist_kernel
from mpitree_tpu_torch.ops import histogram as ph

M32 = 0xFFFFFFFF
# the bin counts chip_smoke.py phase 12 sees on covtype's 54 features
COVTYPE_BINS = ([256] * 6 + [242, 242, 256, 256] + [2, 1] + [2] * 19
                + [1] * 16 + [2] * 7)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: under pytest-xdist's parallel
    workers torch's intra-op threads oversubscribe the cores; nothing here
    depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (S, F, C, feat_bins, route, adds, blocks an SM, threads, groups) at
# covtype's rows: the shapes chip_smoke.py phase 12 times. Limbs where
# most features have few bins and the limb tile takes no more groups.
PLANS = [
    (1, 54, 7, COVTYPE_BINS, "stream", "limbs", 1, 512, 1),
    (2, 54, 7, COVTYPE_BINS, "stream", "carry", 1, 1024, 2),
    (1, 8, 3, None, "stream", "carry", 1, 1024, 1),
    (2, 8, 3, None, "stream", "carry", 1, 1024, 1),
    (2, 54, 3, COVTYPE_BINS, "stream", "limbs", 1, 1024, 1),
    (8, 54, 3, COVTYPE_BINS, "sorted", "limbs", 2, 512, 1),
    (32, 8, 3, None, "sorted", "carry", 2, 512, 1),
    (2048, 54, 7, COVTYPE_BINS, "sorted", "limbs", 1, 512, 1),
]


@pytest.mark.parametrize("case", PLANS, ids=lambda c: "S{}F{}C{}".format(
    *c[:3]))
def test_fixed_plan_fits_the_sm(case):
    S, F, C, fb, route, adds, bps, nt, n_groups = case
    N = 581_012
    p = hist_kernel.plan(S, F, C, 256, feat_bins=fb, n_rows=N, fixed=True)
    assert (p["route"], p["adds"], p["blocks_per_sm"], p["threads"]) == (
        route, adds, bps, nt)
    assert len(p["groups"]) == n_groups
    assert p["cell_bytes"] == hist_kernel.FIXED_ADDS[adds]
    assert p["chan"] == (3 if C == 3 else 1)
    assert p["smem"] <= hist_kernel.SMEM_BYTES and p["smem"] % 16 == 0
    assert bps * (p["smem"] + 1024) <= hist_kernel.SMEM_PER_SM
    assert bps * nt <= 2048  # threads an SM
    cells = [C * (v | 1) for v in (fb or [256] * F)]
    # the tile, the staging of one row a thread, the table, two counters
    assert p["smem"] == hist_kernel._fixed_smem(
        p["groups"], cells, p["tile_slots"], nt, p["chan"], adds)
    biggest = max(sum(cells[a:b]) for a, b in p["groups"])
    assert p["smem"] >= p["tile_slots"] * biggest * p["cell_bytes"] \
        + nt * 8 * (1 + p["chan"])
    if adds == "limbs":  # no more groups than the carry's tile
        carry = hist_kernel.plan(S, F, C, 256, feat_bins=fb, n_rows=N,
                                 fixed=True, adds="carry")
        assert len(carry["groups"]) >= n_groups
        assert p["piece_rows"] <= hist_kernel.LIMB_MAX_ROWS
    if route == "stream":  # one wave of blocks a group over every row
        assert p["n_blocks"] <= hist_kernel.N_SMS * bps
        assert p["n_blocks"] * p["piece_rows"] >= N
        assert (p["n_blocks"] - 1) * p["piece_rows"] < N
    else:
        assert p["n_blocks"] is None
        assert p["piece_rows"] <= hist_kernel.MAX_PIECE_ROWS


@pytest.mark.parametrize("threads", [512, 1024])
def test_fixed_plan_forced_block_size_and_refusal(threads):
    p = hist_kernel.plan(1, 54, 3, 256, feat_bins=COVTYPE_BINS,
                         n_rows=10_000, fixed=True, threads=threads)
    assert p["threads"] == threads
    with pytest.raises(ValueError, match="8-byte cells"):
        hist_kernel.plan(64, 54, 7, 256, "stream", feat_bins=COVTYPE_BINS,
                         fixed=True)


@pytest.mark.parametrize("n_rows", [581_012, 20_000_000])
def test_limb_plan_bounds_a_blocks_rows(n_rows):
    """A limb tile's two exact 16-bit limbs take at most LIMB_MAX_ROWS adds
    a cell: the stream grid cuts blocks to that many rows (more than one
    wave where it must), a longer forced piece is refused, and the
    default plan then keeps the carry."""
    cap = hist_kernel.LIMB_MAX_ROWS
    assert (cap + 1) * 0xFFFF < 2 ** 32  # 65,537 adds of a 16-bit limb
    p = hist_kernel.plan(1, 54, 3, 256, feat_bins=COVTYPE_BINS,
                         n_rows=n_rows, fixed=True, adds="limbs")
    assert p["piece_rows"] <= cap and p["cell_bytes"] == 12
    assert p["n_blocks"] * p["piece_rows"] >= n_rows
    assert (p["n_blocks"] - 1) * p["piece_rows"] < n_rows
    with pytest.raises(ValueError, match="limbs take at most"):
        hist_kernel.plan(1, 54, 3, 256, feat_bins=COVTYPE_BINS,
                         n_rows=n_rows, fixed=True, adds="limbs",
                         piece_rows=cap + 32)
    auto = hist_kernel.plan(1, 54, 3, 256, feat_bins=COVTYPE_BINS,
                            n_rows=n_rows, fixed=True, piece_rows=cap + 32)
    assert auto["adds"] == "carry"
    with pytest.raises(ValueError, match="unknown fixed-point adds"):
        hist_kernel.plan(1, 8, 3, 256, fixed=True, adds="cas")


@pytest.mark.parametrize("n_cells", [1, 3, 4, 1029])
def test_fixed_tile_bytes_match_the_body(n_cells):
    """csrc/fixed_hist.cu's layout: carry, 2 * n_cells words rounded to 4;
    limbs, three planes of n_cells words, each rounded to 4."""
    words = {"carry": (2 * n_cells + 3) & ~3,
             "limbs": 3 * ((n_cells + 3) & ~3)}
    for adds, w in words.items():
        assert hist_kernel._fixed_tile_bytes(n_cells, adds) == 4 * w


@pytest.mark.parametrize("n_rows,resident", [(581_012, 132), (1000, 132),
                                             (1, 132), (72_627, 66)])
def test_stream_grid_covers_every_row_once(n_rows, resident):
    blocks, rows = hist_kernel.stream_grid(n_rows, resident)
    assert rows % 32 == 0 and rows >= hist_kernel.MIN_PIECE_ROWS
    assert blocks <= resident and blocks * rows >= n_rows
    assert (blocks - 1) * rows < n_rows  # no block past the rows


@pytest.mark.parametrize("n", [2, 1000, 581_012, 1 << 24])
def test_exponents_bound_every_partial_sum(n):
    """``|q| <= 2**(62 - ceil(log2 n))``, so ``n`` of them stay below
    ``2**62 < 2**63``; a cell's carry words then hold any partial sum."""
    rng = np.random.default_rng(n)
    v = rng.standard_normal((64, 3)).astype(np.float32) * np.float32(
        [1.0, 1e-3, 3e4])
    p = torch.from_numpy(v)
    se = hist_kernel.fixed_point_exponents(p, n_rows=n)
    q = hist_kernel.quantize(p, se).abs().amax(dim=0)
    bound = 2 ** (hist_kernel.FIXED_POINT_BITS - math.ceil(math.log2(n)))
    assert all(int(x) <= bound for x in q)
    assert n * bound <= 2 ** 62


def _add_carry(lo, hi, c, q):
    """csrc/fixed_hist.cu add_carry on numpy uint32 words."""
    qlo, qhi = q & M32, (q >> 32) & M32
    if qlo:
        old = int(lo[c])
        lo[c] = (old + qlo) & M32
        qhi = (qhi + (1 if (old + qlo) & M32 < old else 0)) & M32
    if qhi:
        hi[c] = (int(hi[c]) + qhi) & M32


def _add_limbs(planes, c, q):
    """csrc/fixed_hist.cu add_q in limb mode on numpy uint32 planes: bits
    0-15 and 16-31 summed exactly (checked), bits 32-63 mod 2**32."""
    for k, limb in enumerate((q & 0xFFFF, (q >> 16) & 0xFFFF,
                              (q >> 32) & M32)):
        if limb:
            total = int(planes[k][c]) + limb
            assert k == 2 or total <= M32, "a 16-bit limb's sum wrapped"
            planes[k][c] = total & M32


def _replay(xb, payload, slot, p, se, *, S, B, order=None, seg=None,
            seed=0):
    """The fixed-point body as it runs, on numpy words (see the module
    docstring); returns the int64 output."""
    rng = np.random.default_rng(seed)
    xb, pay, slot = xb.numpy(), payload.numpy(), slot.numpy()
    N, F = xb.shape
    C = pay.shape[1]
    nt, chan, P = p["threads"], p["chan"], p["piece_rows"]
    limbs = p["adds"] == "limbs"
    scale = [2.0 ** k for k in se]
    sorted_ = p["route"] == "sorted"
    out = np.full((S, F, C, B), 0x5A5A5A5A5A5A5A5A, np.uint64)  # garbage
    if sorted_:
        order, seg_l = order.numpy(), seg.numpy()
        pieces = hist_kernel.block_pieces(seg_l, S, P, N)
        for s in range(S):  # hist_zero_split_kernel
            if seg_l[s + 1] - seg_l[s] > P:
                out[s] = 0
    else:
        out[:] = 0  # the wrapper's torch.zeros
        pieces = [(0, a, min(N, a + P), False)
                  for a in range(0, P * p["n_blocks"], P)]
        assert pieces[-1][1] < N
    tile_slots = p["tile_slots"]
    for g, (f0, f1) in enumerate(p["groups"]):
        gcells = p["group_cells"][g]
        rowcells = gcells // C
        nb, off = p["feat_bins"][f0:f1], p["feat_offset"][f0:f1]
        for own, a, b, owned in pieces:
            planes = [np.zeros(tile_slots * gcells, np.uint32)
                      for _ in range(3 if limbs else 2)]

            def add_row(r, base, qs):
                for j in range(f1 - f0):
                    bin_ = int(xb[r, f0 + j])
                    if 0 <= bin_ < nb[j]:
                        for c, q in enumerate(qs):
                            if not q:
                                continue
                            at = base + off[j] + bin_ + c * rowcells
                            if limbs:
                                _add_limbs(planes, at, q & (2**64 - 1))
                            else:
                                _add_carry(*planes, at, q & (2**64 - 1))

            for base in range(a, b, nt):  # one row a thread
                staged = []
                for i in range(base, min(b, base + nt)):
                    r = int(order[i]) if sorted_ else i
                    s = 0 if sorted_ else int(slot[r])
                    if not 0 <= s < S:
                        continue
                    qs = [int(np.rint(np.float64(pay[r, c]) * scale[c]))
                          for c in range(C)]
                    if chan == 3:
                        if any(qs):
                            staged.append((r, s * gcells, qs))
                        continue
                    nz = [c for c in range(C) if pay[r, c] != 0]
                    if len(nz) == 1 and qs[nz[0]]:
                        staged.append((r, s * gcells + nz[0] * rowcells,
                                       [qs[nz[0]]]))
                    elif len(nz) > 1:  # added whole by its scanning thread
                        add_row(r, s * gcells, qs)
                order_ = rng.permutation(len(staged))  # the warps' race
                for k in order_:
                    add_row(*staged[k])
            wide = [w.astype(np.uint64) for w in planes]
            if limbs:  # the flush's combine, mod 2**64
                words = (wide[0] + (wide[1] << np.uint64(16))
                         + (wide[2] << np.uint64(32)))
            else:
                words = wide[0] | (wide[1] << np.uint64(32))
            for sl in range(tile_slots):
                s = own if sorted_ else sl
                for j in range(f1 - f0):
                    for c in range(C):
                        lo_at = sl * gcells + c * rowcells + off[j]
                        row = words[lo_at:lo_at + nb[j]]
                        if owned:
                            out[s, f0 + j, c, :] = 0
                            out[s, f0 + j, c, :nb[j]] = row
                        else:
                            out[s, f0 + j, c, :nb[j]] += row  # wraps
    return torch.from_numpy(out.view(np.int64))


def _inputs(kind, N, F, B, S, seed, *, one_bin=False, skew=False,
            share=1, top=None):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, B, (N, F)).astype(np.int32)
    xb[:, 1::2] %= 2  # two-bin columns, as covtype's one-hot ones
    if one_bin:
        xb[:] = 1
    slot = rng.integers(-1, S + 1, N).astype(np.int32)
    if skew:
        slot = np.where(rng.random(N) < 0.7, S // 2,
                        rng.integers(0, S, N)).astype(np.int32)
        slot[(slot % 4 == 3) & (slot != S // 2)] = -1  # empty slots
    if share > 1:
        slot[rng.random(N) >= 1.0 / share] = -1
    if kind == "gbdt":
        g = rng.standard_normal(N).astype(np.float32) * 3  # negative g too
        h = np.where(rng.random(N) < 0.2, 0.0,
                     rng.uniform(0.05, 0.25, N)).astype(np.float32)
        if top is not None:  # the largest |q|: |g| = max|g| = 2**top
            g = np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(
                np.float32) * np.float32(2.0 ** top)
            h[h > 0] = np.float32(2.0 ** -3)
        payload = ph.gbdt_payload(torch.from_numpy(g), torch.from_numpy(h))
    elif kind == "moments":
        y = rng.normal(0, 2, N).astype(np.float32)
        w = rng.uniform(0.5, 2, N).astype(np.float32)
        payload = ph.moment_payload(torch.from_numpy(y), torch.from_numpy(w))
    else:  # class weights, C = 4, with a few rows of several channels
        y = rng.integers(0, 4, N)
        w = rng.uniform(0.5, 2, N).astype(np.float32)
        w[rng.random(N) < 0.05] = 0.0
        payload = ph.class_payload(torch.from_numpy(y), torch.from_numpy(w),
                                   4).clone()
        several = rng.random(N) < 0.03
        payload[torch.from_numpy(several), 3] += 0.75
    return (torch.from_numpy(xb), payload.contiguous(),
            torch.from_numpy(slot))


# (name, kind, N, F, B, S, route, threads, piece rows, input options,
# adds)
REPLAYS = [
    ("gbdt-stream", "gbdt", 1500, 5, 16, 1, "stream", 512, 1100, {},
     "carry"),
    ("gbdt-pair", "gbdt", 1200, 5, 16, 2, "stream", 1024, None,
     dict(share=8), "carry"),
    ("gbdt-largest-q", "gbdt", 900, 3, 8, 2, "stream", 512, 600,
     dict(top=5), "carry"),
    ("gbdt-one-bin", "gbdt", 800, 4, 8, 1, "stream", 512, None,
     dict(one_bin=True, top=0), "carry"),
    ("moments-sorted", "moments", 900, 4, 16, 6, "sorted", 512, 64, {},
     "carry"),
    ("moments-skewed", "moments", 1000, 3, 16, 12, "sorted", 512, 64,
     dict(skew=True), "carry"),
    ("class-stream", "class", 1300, 6, 16, 2, "stream", 1024, None, {},
     "carry"),
    ("class-skewed", "class", 900, 5, 8, 9, "sorted", 1024, 32,
     dict(skew=True), "carry"),
    ("class-one-bin", "class", 700, 3, 8, 5, "sorted", 512, 64,
     dict(one_bin=True), "carry"),
    ("gbdt-stream-limbs", "gbdt", 1500, 5, 16, 1, "stream", 512, 1100, {},
     "limbs"),
    ("gbdt-pair-limbs", "gbdt", 1200, 5, 16, 2, "stream", 1024, None,
     dict(share=8), "limbs"),
    ("gbdt-largest-q-limbs", "gbdt", 900, 3, 8, 2, "stream", 512, 600,
     dict(top=5), "limbs"),
    ("gbdt-one-bin-limbs", "gbdt", 800, 4, 8, 1, "stream", 512, None,
     dict(one_bin=True, top=0), "limbs"),
    ("moments-skewed-limbs", "moments", 1000, 3, 16, 12, "sorted", 512, 64,
     dict(skew=True), "limbs"),
    ("class-skewed-limbs", "class", 900, 5, 8, 9, "sorted", 1024, 32,
     dict(skew=True), "limbs"),
    ("class-one-bin-limbs", "class", 700, 3, 8, 5, "sorted", 512, 64,
     dict(one_bin=True), "limbs"),
]


@pytest.mark.parametrize("case", REPLAYS, ids=lambda c: c[0])
def test_replay_of_the_fixed_body_equals_plain_version(case):
    _, kind, N, F, B, S, route, nt, rows, opts, adds = case
    xb, payload, slot = _inputs(kind, N, F, B, S, N + S, **opts)
    se = hist_kernel.fixed_point_exponents(payload)
    C = payload.shape[1]
    cells = [C * (B | 1)] * F
    # room for two thirds of the features: several groups
    smem = (hist_kernel._feat_bytes(F) + nt * 8 * (1 + (3 if C == 3 else 1))
            + hist_kernel.FIXED_COUNTER_BYTES + 64
            + hist_kernel.FIXED_ADDS[adds] * (S if route == "stream" else 1)
            * sum(cells) * 2 // 3)
    p = hist_kernel.plan(S, F, C, B, route, n_rows=N, fixed=True,
                         threads=nt, piece_rows=rows, smem_bytes=smem,
                         adds=adds)
    assert len(p["groups"]) >= 2 and p["threads"] == nt
    assert p["adds"] == adds
    if rows:
        assert p["piece_rows"] == rows
    order = seg = None
    if route == "sorted":
        order, seg = hist_kernel.slot_segments(slot, S)
    want = hist_kernel.histogram_reference(xb, payload, slot, n_slots=S,
                                           n_bins=B, scale_exp=se)
    got = _replay(xb, payload, slot, p, se, S=S, B=B, order=order, seg=seg,
                  seed=N)
    assert torch.equal(got, want)
    if opts.get("top") is not None:  # the exponents' largest |q| was hit
        q = hist_kernel.quantize(payload, se)
        assert int(q[:, 1].abs().max()) == 2 ** (
            hist_kernel.FIXED_POINT_BITS - math.ceil(math.log2(N)))
    if kind == "gbdt":  # R7: an h == 0 row adds to no channel
        dead = (payload[:, 2] == 0) & (slot >= 0) & (slot < S)
        assert bool(dead.any()) and bool((payload[dead] == 0).all())


@pytest.mark.parametrize("adds", ["carry", "limbs"])
def test_replay_is_order_free(adds):
    """Two races (shuffles of every batch) give the same bits."""
    xb, payload, slot = _inputs("gbdt", 1000, 4, 16, 2, 3)
    se = hist_kernel.fixed_point_exponents(payload)
    p = hist_kernel.plan(2, 4, 3, 16, "stream", n_rows=1000, fixed=True,
                         threads=512, piece_rows=700, adds=adds)
    a = _replay(xb, payload, slot, p, se, S=2, B=16, seed=1)
    b = _replay(xb, payload, slot, p, se, S=2, B=16, seed=2)
    assert torch.equal(a, b)
