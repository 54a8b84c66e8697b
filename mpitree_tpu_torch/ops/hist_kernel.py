"""The payload histogram kernel family for Hopper, its wrapper and its plain version.

Replaces the three TPU kernels of the JAX package, which all compute one
function — ``hist[s, f, c, b] = sum_r payload[r, c] * [slot[r] == s] *
[xb[r, f] == b]``, rows with ``slot`` outside ``[0, S)`` adding nothing:

- K1 ``mpitree_tpu/ops/pallas_hist.py:77`` ``_hist_kernel`` (one block, tiny S)
  -> route ``"stream"``;
- K2 ``mpitree_tpu/ops/pallas_hist.py:103`` ``_hist_kernel_fgrid`` (S = 64..128)
  -> route ``"sorted"``;
- K3 ``mpitree_tpu/ops/wide_hist.py:252`` ``_wide_kernel`` (S >= 256)
  -> route ``"sorted"``.

The TPU kernels turn the scatter into one-hot matrix products because the
TPU has no fast scatter. Hopper has atomics in shared memory (native for
32-bit integers, which is what integer-valued payloads are added as), so
``csrc/histogram.cu`` scatters into a shared-memory tile that one block owns
and flushes once (the design and what bounds it are in that file's header):

- ``stream`` (S <= 2: the root, and a leaf-wise expansion's sibling
  pair): rows in storage order, cut into pieces; every piece adds its
  nonzero tile cells into the zeroed output with global atomics;
- ``sorted`` (S > 2): the rows are first ordered by slot
  (:func:`slot_segments`, plain PyTorch: the counterpart of K3's
  ``_sort_and_pack``, which the JAX package also runs outside its kernel), so
  a block reads one slot's rows only, and a slot that one block owns is
  written with plain stores into an output that is never zeroed. The level
  loop sorts once per level and hands ``order``/``seg_start`` to every chunk
  of that level; without them the wrapper sorts per call.

Byte-wide bins: with ``n_bins <= 256`` a fit keeps a ``uint8`` copy of the
binned matrix, rows padded to a multiple of 16 bytes (:func:`pack_bins`), and
passes it as ``packed=``; a thread's one 16-byte load then holds 16 features.
The tile is ragged: ``feat_bins[f]`` bins for feature ``f`` (the fit knows
them from the binning), so covtype's 54 columns fit one 74 KB tile.

Which route serves which width is measured, not reasoned: ``chip_smoke.py``
times every route that fits at each width on the card (``PERF.md``).

Exactness: integer-valued payloads with sums below 2**24 are exact in
float32 in any order, so the kernels are bit-identical (``torch.equal``) to
:func:`histogram_reference` despite the unordered atomics — the contract
``mpitree_tpu/ops/histogram.py`` states for the XLA scatter. The float32
route takes no other payload: :func:`histogram_cuda` refuses one that
:func:`float32_exact` rejects.

Non-integer payloads (fractional weights, the regression moments
``(w, w*y, w*y^2)``, GBDT's ``(count, g, h)``: the payloads
``mpitree_tpu/ops/pallas_hist.py:245-266`` hands the same TPU kernels, and
which the JAX package's XLA scatter serves at ``hist_kernel="auto"``) take
the **fixed-point** route: given ``scale_exp`` (one exponent ``k[c]`` per
channel, :func:`fixed_point_exponents`, fixed once per fit), every value
becomes the int64 ``round_half_even(v * 2**k[c])`` and the histogram is
their int64 sum. Integer addition does not depend on the order, so the
kernels (routes ``stream_fixed`` and ``sorted_fixed``: the fixed-point
body of ``csrc/fixed_hist.cu``, its own tile machinery with 8-byte carry
cells or 12-byte limb cells, rows quantized once and staged in batches;
planned by :func:`_fixed_plan`) equal the plain version bit for bit, and
a fit on the card equals the same fit on the CPU. The sums are exact
where every value is a multiple of ``2**-k[c]`` (csrc/fixed_hist.cu says
where they stop being).

On a data mesh every shard must add on one scale: the route and the
exponents come from every shard's :func:`payload_stats` reduced over the
mesh (``parallel/collective.payload_scale``) and the global row count,
never from one shard's rows, so the shards' int64 sums add and the tree
equals the one-shard tree.

On a CPU tensor :func:`histogram` uses :func:`histogram_reference`; on a
CUDA tensor it launches a kernel or raises. ``launches`` counts the kernel
launches per route (``stream``, ``sorted``, ``stream_fixed``,
``sorted_fixed``), and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref

import numpy as np
import torch

from mpitree_tpu_torch._device import sm_count

# Dynamic shared memory one block may use on Hopper (227 KB), and what one
# SM holds for all its resident blocks (228 KB, 1 KB of it reserved per block).
SMEM_BYTES = 232_448
SMEM_PER_SM = 233_472
N_SMS = 132  # an H100's; plan() takes the card's own count from the wrapper
# Widest frontier the stream route serves (measured: PERF.md, chip_smoke.py).
STREAM_MAX_SLOTS = 2  # the root, and the leaf-wise frontier's sibling pair
LANE_FEATURES = 16  # kLaneFeat in csrc/histogram.cu: features per thread
MAX_THREADS = 512  # kMaxThreads in csrc/histogram.cu
MIN_PIECE_ROWS = 256
MAX_PIECE_ROWS = 4096  # 8 bytes of shared memory a row; keeps int sums small
# 512 threads of 60 registers: the register file holds two blocks
MAX_BLOCKS_PER_SM = 2
MAX_GROUP_FEATURES = 256  # a row's lanes (16 features each) within a warp
# The fixed-point body (csrc/fixed_hist.cu): (blocks an SM, threads a
# block) per route in the planner's order of preference (measured: PERF.md),
# and its shared memory beside the tile and the staging (8 bytes of (row,
# tile base) and 8 a q value a thread): the feature table, two counters.
FIXED_SHAPES = {"stream": ((1, 1024), (2, 512), (1, 512)),
                "sorted": ((2, 512), (1, 1024), (1, 512))}
FIXED_COUNTER_BYTES = 16
# How the fixed-point body adds a q into a tile cell: "carry", two 32-bit
# words and the low word's carry (8 bytes a cell), or "limbs", three
# 32-bit planes of independent adds (12 bytes a cell; at most
# LIMB_MAX_ROWS rows a block, so the two 16-bit limbs' sums stay exact).
FIXED_ADDS = {"carry": 8, "limbs": 12}
LIMB_MAX_ROWS = 65_536
# The planner takes limbs when at least half the features have at most
# this many bins (many rows' adds meet in few cells, where the carry's
# dependent add waits longest) and the limb tile takes no more feature
# groups; carry otherwise (measured on an H100: PERF.md).
LIMBS_FEW_BINS = 16
ROUTES = ("stream", "sorted")
FIXED_ROUTES = tuple(f"{r}_fixed" for r in ROUTES)
# Bits a fixed-point histogram cell may use: no partial sum of N values,
# each below 2**(FIXED_POINT_BITS - ceil(log2 N)) in magnitude, reaches
# 2**63. The exponent is capped so that 2**-k stays a normal float32.
FIXED_POINT_BITS = 62
MAX_SCALE_EXP = 100

# Largest float32 sum the integer route keeps exact in any order.
FLOAT32_EXACT = 2.0 ** 24

launches = dict.fromkeys(ROUTES + FIXED_ROUTES, 0)
# id -> (weak reference, version) of the payloads float32_exact accepted
_exact_payloads: dict = {}


def float32_exact(payload: torch.Tensor) -> bool:
    """True when every value of the ``(N, C)`` payload is an integer and
    every channel's sum of ``|v|`` stays below 2**24: the float32 route
    then sums it exactly, in any order. One device-to-host copy, made once
    per payload tensor: an accepted tensor is remembered until it changes
    in place or is freed, so a fit's launches do not check it again."""
    seen = _exact_payloads.get(id(payload))
    if seen is not None and seen[0]() is payload \
            and seen[1] == payload._version:
        return True
    integral = bool(torch.equal(payload, torch.round(payload)))
    if not (integral and float(payload.abs().sum(dim=0).amax())
            < FLOAT32_EXACT):
        return False
    for key in [k for k, (ref, _) in _exact_payloads.items()
                if ref() is None]:
        del _exact_payloads[key]
    _exact_payloads[id(payload)] = (weakref.ref(payload), payload._version)
    return True


def fixed_point_exponents(payload: torch.Tensor, n_rows: int | None = None
                          ) -> tuple:
    """One exponent ``k[c]`` per channel of an ``(N, C)`` float32 payload:
    ``FIXED_POINT_BITS - ceil(log2 N) - ceil(log2 max|v_c|)``, capped at
    ``MAX_SCALE_EXP``, and 0 for a channel that is all zeros. ``n_rows``
    (default ``N``) is the most rows one sum can take. A fit computes it
    once (one device-to-host copy) and passes it to every histogram.
    Raises ``ValueError`` on a non-finite value, before any launch."""
    if payload.dim() != 2:
        raise ValueError("payload must be 2-D")
    top = payload.abs().amax(dim=0) if payload.shape[0] else \
        torch.zeros(payload.shape[1])
    return exponents_from_top(
        top.double().cpu().numpy()[None],
        payload.shape[0] if n_rows is None else n_rows)[0]


def payload_stats(payload: torch.Tensor) -> torch.Tensor:
    """(3, C) float64 per channel of an ``(n, C)`` payload: 1.0 where every
    value is an integer (else 0.0), the sum of ``|v|`` (exact for integer
    values) and ``max |v|``: what :func:`float32_exact` and
    :func:`fixed_point_exponents` read, in a form that reduces over the
    shards of a mesh (MIN, SUM, MAX; ``parallel/collective.payload_scale``)."""
    if payload.dim() != 2:
        raise ValueError("payload must be 2-D")
    p = payload.to(torch.float64)
    if payload.shape[0] == 0:
        return torch.stack([torch.ones(payload.shape[1], dtype=p.dtype,
                                       device=p.device),
                            p.sum(dim=0), p.sum(dim=0)])
    a = p.abs()
    return torch.stack([(p == torch.round(p)).all(dim=0).to(p.dtype),
                        a.sum(dim=0), a.amax(dim=0)])


def scale_from_stats(integral: bool, sums: np.ndarray, tops: np.ndarray, *,
                     n_rows: int, fixed: bool):
    """The route of reduced :func:`payload_stats`: None (the float32
    integer route) when ``integral`` and every channel's ``sums`` stays
    below 2**24 and the payload is not ``fixed`` (regression, boosting),
    else the exponents of :func:`exponents_from_top` for the channel
    maxima ``tops`` and ``n_rows``, the most rows one sum can take."""
    if not fixed and integral and float(np.max(sums, initial=0.0)) \
            < FLOAT32_EXACT:
        return None
    return exponents_from_top(np.asarray(tops, np.float64)[None],
                              n_rows)[0]


def exponents_from_top(top: np.ndarray, n_rows: int) -> list:
    """:func:`fixed_point_exponents` of payloads whose channel maxima
    ``max|v_c|`` are the rows of ``top`` (P, C): a forest decides every
    tree's exponents from one copy. Raises on a non-finite maximum."""
    if not np.isfinite(top).all():
        raise ValueError("payload holds NaN or infinity: the fixed-point "
                         "histogram takes finite values only")
    row_bits = math.ceil(math.log2(max(int(n_rows), 1)))
    return [
        tuple(
            0 if v == 0.0 else min(
                MAX_SCALE_EXP,
                FIXED_POINT_BITS - row_bits - math.ceil(math.log2(float(v))))
            for v in row)
        for row in np.asarray(top, np.float64)
    ]


_powers_cache: dict = {}


def _powers(exps, sign: int, dtype, dev: torch.device) -> torch.Tensor:
    """``2**(sign * k)`` for each exponent, on ``dev``, made once per
    distinct (exponents, sign, dtype, device): a fit's launches then copy
    nothing to the card (and a captured CUDA graph may reuse them)."""
    key = (dev, dtype, sign, tuple(int(k) for k in exps))
    if key not in _powers_cache:
        _powers_cache[key] = torch.tensor(
            [2.0 ** (sign * k) for k in key[3]], dtype=dtype, device=dev)
    return _powers_cache[key]


def quantize(payload: torch.Tensor, scale_exp) -> torch.Tensor:
    """``(N, C)`` float32 -> int64 ``round_half_even(v * 2**k[c])``, the
    values the fixed-point route adds (``torch.round`` rounds half to
    even, as the kernels' ``__double2ll_rn``)."""
    scale = _powers(scale_exp, 1, torch.float64, payload.device)
    return torch.round(payload.to(torch.float64) * scale).to(torch.int64)


def dequantize(q: torch.Tensor, scale_exp, dim: int,
               dtype=torch.float64) -> torch.Tensor:
    """int64 fixed-point sums -> ``dtype``, channel ``c`` (along ``dim``)
    times ``2**-k[c]``: one rounding of the int64 to ``dtype``, then an
    exact power-of-two scale."""
    shape = [1] * q.dim()
    shape[dim] = len(scale_exp)
    inv = _powers(scale_exp, -1, dtype, q.device).view(shape)
    return q.to(dtype) * inv


def pack_bins(x_binned: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``(N, F)`` integer bin ids -> ``(N, ceil(F / 16) * 16)`` uint8, the
    pad columns zero. Refuses ``n_bins > 256`` and ids outside
    ``[0, n_bins)``, which a byte could not tell from a real bin (one
    device-to-host check; a fit packs once)."""
    if n_bins > 256:
        raise ValueError(f"byte-wide bins need n_bins <= 256, got {n_bins}")
    if x_binned.dim() != 2:
        raise ValueError("x_binned must be 2-D")
    if bool(((x_binned < 0) | (x_binned >= n_bins)).any()):
        raise ValueError(f"bin ids outside [0, {n_bins}) cannot be packed")
    N, F = x_binned.shape
    width = -(-F // LANE_FEATURES) * LANE_FEATURES
    packed = torch.zeros((N, width), dtype=torch.uint8, device=x_binned.device)
    packed[:, :F] = x_binned.to(torch.uint8)
    return packed


def slot_segments(slot: torch.Tensor, n_slots: int) -> tuple:
    """Rows ordered by slot: ``(order, seg_start)``, both int32.

    ``order`` (N,) holds the row ids by ascending slot, the rows below the
    slot range first and those above it last; ``seg_start`` (n_slots + 1,)
    holds each slot's first position in ``order``, so slot ``s`` owns
    ``order[seg_start[s]:seg_start[s + 1]]`` and nothing before
    ``seg_start[0]`` or from ``seg_start[n_slots]`` on is ever read. Plain
    PyTorch on the tensor's device, no host synchronisation."""
    key = slot.clamp(-1, n_slots)
    if n_slots < 2**15:
        key = key.to(torch.int16)  # fewer radix passes on the card
    skey, order = torch.sort(key)
    bounds = torch.arange(n_slots + 1, device=slot.device, dtype=skey.dtype)
    seg_start = torch.searchsorted(skey, bounds)
    return order.to(torch.int32), seg_start.to(torch.int32)


def block_pieces(seg_start, n_slots: int, piece_rows: int,
                 n_rows: int) -> list:
    """The sorted route's grid as the kernel decodes it, on the host:
    ``[(slot, a, b, owned), ...]`` in block order, blocks that take nothing
    left out. Block ``v < S`` takes the first ``piece_rows`` rows of slot
    ``v`` and owns the slot (stores it whole) when it has no more; block
    ``S + e`` looks at position ``seg_start[0] + e * piece_rows`` and takes
    the further piece of the slot there that starts within ``piece_rows``
    after it, if there is one. Mirrors ``hist_tile_kernel``; the CPU tests
    replay it against the plain version."""
    seg = [int(v) for v in seg_start]
    P = piece_rows
    out = []
    for s in range(n_slots):
        owned = seg[s + 1] - seg[s] <= P
        out.append((s, seg[s], seg[s + 1] if owned else seg[s] + P, owned))
    for e in range(-(-n_rows // P)):
        pos = seg[0] + e * P
        if pos >= seg[n_slots]:
            break
        s = max(i for i in range(n_slots) if seg[i] <= pos)
        k = -(-(pos - seg[s]) // P)
        a = seg[s] + k * P
        if k == 0 or a >= seg[s + 1]:
            continue
        out.append((s, a, min(a + P, seg[s + 1]), False))
    return out


def _feature_groups(cells: list, budget: int) -> list:
    """Consecutive feature groups whose tile cells fit ``budget`` (and
    that hold at most ``MAX_GROUP_FEATURES`` features), as few as a greedy
    cut needs and then as even as that count allows."""
    def cut(cap):
        groups, f0, used = [], 0, 0
        for f, n in enumerate(cells):
            if n > cap:
                return None
            if used + n > cap or f - f0 >= MAX_GROUP_FEATURES:
                groups.append((f0, f))
                f0, used = f, 0
            used += n
        groups.append((f0, len(cells)))
        return groups

    groups = cut(budget)
    if groups is None:
        return None
    lo, hi = max(cells), budget  # smallest cap that keeps the group count
    while lo < hi:
        mid = (lo + hi) // 2
        got = cut(mid)
        if got is not None and len(got) <= len(groups):
            hi = mid
        else:
            lo = mid + 1
    return cut(lo)


def _feat_bytes(n: int) -> int:
    """feat_bytes() of csrc/histogram.cu: the (offset, bin count) table of
    ``n`` features, rounded to 16 bytes."""
    return (n * 8 + 15) & ~15


def _smem_bytes(groups, cells, tile_slots: int, piece_rows: int) -> int:
    """Largest group's dynamic shared memory in the integer body: the
    feature table, one 8-byte code per row of a piece, and the tile of
    4-byte cells rounded to 16 bytes."""
    return max(
        _feat_bytes(f1 - f0) + 8 * piece_rows
        + -(-tile_slots * sum(cells[f0:f1]) * 4 // 16) * 16
        for f0, f1 in groups
    )


def _piece_rows(n_rows: int, resident: int) -> int:
    """Rows per piece: the rows spread evenly over as few whole waves of
    ``resident`` blocks as keep a piece within ``MAX_PIECE_ROWS``."""
    waves = max(1, -(-n_rows // (resident * MAX_PIECE_ROWS)))
    rows = max(MIN_PIECE_ROWS, -(-n_rows // (resident * waves)))
    return min(-(-rows // 32) * 32, MAX_PIECE_ROWS)


def plan(n_slots: int, n_features: int, n_channels: int, n_bins: int,
         variant: str | None = None, *, feat_bins=None,
         n_rows: int = 1 << 20, n_sms: int = N_SMS,
         smem_bytes: int = SMEM_BYTES,
         piece_rows: int | None = None, fixed: bool = False,
         threads: int | None = None, adds: str | None = None) -> dict:
    """Route and tiling for one launch (host arithmetic, no device).

    ``feat_bins[f]`` is feature ``f``'s bin count (default ``n_bins``
    each); feature ``f`` takes ``feat_bins[f] | 1`` cells in each of the
    ``n_channels`` rows of a slot's tile, at ``feat_offset[f]``.
    ``stream`` keeps all ``n_slots`` slots of a feature group in one tile,
    ``sorted`` one slot. Two blocks share an SM when
    that adds no feature group; the rows are cut into pieces that fill
    whole waves of the resident blocks (:func:`_piece_rows`), unless
    ``piece_rows`` names the size. ``smem_bytes`` is the shared memory one
    block may use. ``variant=None`` picks ``stream`` up to
    ``STREAM_MAX_SLOTS`` slots and ``sorted`` beyond; a named route gets
    its tiling, or ``ValueError`` when its tile cannot fit. Plans are
    remembered: a fit asks for the same few on every level.

    ``fixed`` plans the fixed-point body (csrc/fixed_hist.cu,
    :func:`_fixed_plan`); ``threads`` forces its block size and ``adds``
    its cells (``FIXED_ADDS``; by default ``LIMBS_FEW_BINS`` decides)."""
    return _plan(n_slots, n_features, n_channels, n_bins, variant,
                 None if feat_bins is None else tuple(
                     int(v) for v in feat_bins),
                 n_rows, n_sms, smem_bytes, piece_rows, bool(fixed),
                 threads, adds)


def _fixed_smem(groups, cells, tile_slots: int, threads: int,
                chan: int, adds: str = "carry") -> int:
    """Largest group's dynamic shared memory in the fixed-point body: the
    feature table, the batch's staging (8 + 8 * chan bytes a thread), the
    tile (:func:`_fixed_tile_bytes`) and the two counters."""
    return max(
        _feat_bytes(f1 - f0) + threads * 8 * (1 + chan)
        + _fixed_tile_bytes(tile_slots * sum(cells[f0:f1]), adds)
        + FIXED_COUNTER_BYTES
        for f0, f1 in groups
    )


def _fixed_tile_bytes(n_cells: int, adds: str) -> int:
    """A fixed-point tile of ``n_cells`` cells as the body lays it out:
    "carry", two words a cell rounded to 16 bytes; "limbs", three planes
    of one word a cell, each rounded to 16 bytes."""
    if adds == "limbs":
        return 3 * -(-n_cells // 4) * 16
    return -(-2 * n_cells // 4) * 16


def stream_grid(n_rows: int, resident: int) -> tuple:
    """The fixed stream route's grid: ``(blocks, rows a block)`` for
    ``n_rows`` rows over one wave of ``resident`` blocks; a block takes at
    least ``MIN_PIECE_ROWS`` rows, a multiple of 32."""
    rows = max(MIN_PIECE_ROWS, -(-max(n_rows, 1) // max(resident, 1)))
    rows = -(-rows // 32) * 32
    return -(-max(n_rows, 1) // rows), rows


def _fixed_plan(variant, n_features, n_channels, cells, tile_slots, n_rows,
                n_sms, smem_bytes, piece_rows, threads, adds) -> dict:
    """The fixed-point body's tiling: for each (blocks an SM, threads) of
    ``FIXED_SHAPES[variant]`` (or the forced ``threads``) the fewest
    feature groups whose tiles fit beside the staging; the fewest groups
    win, then (sorted) the most resident threads, then the order of
    ``FIXED_SHAPES``. Stream: one wave of blocks over the rows for each
    feature group (:func:`stream_grid`); sorted: pieces of
    :func:`_piece_rows` and the integer body's decode (the wrapper adds
    the S owner blocks). ``adds`` (default "carry") sets the cells
    (``FIXED_ADDS``); "limbs" caps a block's rows at ``LIMB_MAX_ROWS``."""
    adds = adds or "carry"
    if adds not in FIXED_ADDS:
        raise ValueError(f"unknown fixed-point adds {adds!r}; expected one "
                         f"of {tuple(FIXED_ADDS)}")
    cb = FIXED_ADDS[adds]
    # the body's instance: three dense channels (moments, GBDT), or one
    # nonzero channel a row (class payloads of any C)
    chan = 3 if n_channels == 3 else 1
    best = None
    for rank, (bps, nt) in enumerate(FIXED_SHAPES[variant]):
        if threads is not None and nt != threads:
            continue
        room = min(smem_bytes, SMEM_PER_SM // bps - 1024)
        fixed_part = (_feat_bytes(n_features) + nt * 8 * (1 + chan)
                      + FIXED_COUNTER_BYTES)
        pad = 48 if adds == "limbs" else 0  # three planes' rounding
        groups = _feature_groups(cells, (room - fixed_part - pad)
                                 // (cb * tile_slots))
        if not groups or _fixed_smem(groups, cells, tile_slots, nt,
                                     chan, adds) > room:
            continue
        key = (len(groups), 0 if variant == "stream" else -bps * nt, rank)
        if best is None or key < best[0]:
            best = (key, groups, bps, nt)
    if best is None:
        raise ValueError(
            f"route {variant!r} does not fit S={tile_slots} C={n_channels} "
            f"({cb}-byte cells) in {smem_bytes} bytes of shared memory")
    _, groups, bps, nt = best
    blocks = None
    if variant == "stream":  # one wave of blocks a group (measured)
        blocks, rows = stream_grid(n_rows, n_sms * bps)
        if adds == "limbs":
            rows = min(rows, LIMB_MAX_ROWS)
        if piece_rows:
            rows = piece_rows
        blocks = -(-n_rows // rows)
    else:
        rows = piece_rows or _piece_rows(
            n_rows, max(1, n_sms * bps // len(groups)))
    if adds == "limbs" and rows > LIMB_MAX_ROWS:
        raise ValueError(f"limbs take at most {LIMB_MAX_ROWS} rows a block, "
                         f"got piece_rows={rows}")
    return dict(groups=groups, blocks_per_sm=bps, threads=nt, chan=chan,
                adds=adds, n_blocks=blocks, piece_rows=rows,
                smem=_fixed_smem(groups, cells, tile_slots, nt, chan, adds))


@functools.lru_cache(maxsize=256)
def _plan(n_slots, n_features, n_channels, n_bins, variant, feat_bins,
          n_rows, n_sms, smem_bytes, piece_rows, fixed, threads,
          adds) -> dict:
    if variant is None:
        variant = "stream" if n_slots <= STREAM_MAX_SLOTS else "sorted"
    if variant not in ROUTES:
        raise ValueError(f"unknown route {variant!r}; one of {ROUTES}")
    nb = [n_bins] * n_features if feat_bins is None else [
        max(1, min(int(v), n_bins)) for v in feat_bins]
    if len(nb) != n_features:
        raise ValueError(
            f"feat_bins has {len(nb)} entries for {n_features} features")
    cells = [n_channels * (v | 1) for v in nb]
    tile_slots = n_slots if variant == "stream" else 1
    if fixed:
        args = (variant, n_features, n_channels, cells, tile_slots, n_rows,
                n_sms, smem_bytes, piece_rows, threads)
        got = _fixed_plan(*args, adds or "carry")
        if adds is None and 2 * sum(v <= LIMBS_FEW_BINS for v in nb) \
                >= len(nb):
            # mostly few-bin features: limbs, where they take no more
            # feature groups (measured: PERF.md)
            try:
                limbs = _fixed_plan(*args, "limbs")
            except ValueError:  # no room, or a forced piece too long
                limbs = None
            if limbs is not None and len(limbs["groups"]) <= len(
                    got["groups"]):
                got = limbs
        return dict(got, **_layout_of(variant, got["groups"], nb,
                                      n_channels, tile_slots),
                    cell_bytes=FIXED_ADDS[got["adds"]])

    def tiling(blocks_per_sm):
        """(groups, piece rows) with as few groups as fit, or None."""
        room = min(smem_bytes, SMEM_PER_SM // blocks_per_sm - 1024)
        for n_groups in range(1, n_features + 1):
            rows = piece_rows or _piece_rows(
                n_rows, max(1, n_sms * blocks_per_sm // n_groups))
            budget = (room - _feat_bytes(n_features) - 8 * rows) \
                // (4 * tile_slots)
            groups = _feature_groups(cells, budget)
            if groups and len(groups) <= n_groups and _smem_bytes(
                    groups, cells, tile_slots, rows) <= room:
                return groups, rows
        return None

    best = tiling(1)
    if best is None:
        raise ValueError(
            f"route {variant!r} does not fit S={n_slots} C={n_channels} "
            f"B={n_bins} in {smem_bytes} bytes of shared memory"
        )
    blocks_per_sm = 1
    two = tiling(MAX_BLOCKS_PER_SM)
    if two is not None and len(two[0]) == len(best[0]):
        best, blocks_per_sm = two, MAX_BLOCKS_PER_SM
    groups, rows = best
    return dict(
        _layout_of(variant, groups, nb, n_channels, tile_slots),
        smem=_smem_bytes(groups, cells, tile_slots, rows),
        blocks_per_sm=blocks_per_sm, threads=MAX_THREADS, piece_rows=rows,
        cell_bytes=4,
    )


def _layout_of(variant, groups, nb, n_channels, tile_slots) -> dict:
    """The tile layout of ``groups``: each feature's offset in its
    group's channel row (``nb[f] | 1`` cells each), each group's cells,
    and the int32 ``layout`` the kernels read."""
    foff, group_cells = [], []  # channel-major: C rows of a group's bins
    for f0, f1 in groups:
        off = 0
        for f in range(f0, f1):
            foff.append(off)
            off += nb[f] | 1
        group_cells.append(n_channels * off)
    return dict(
        route=variant, groups=groups, group_cells=group_cells,
        feat_bins=nb, feat_offset=foff, tile_slots=tile_slots,
        # as the kernel reads it: group starts, cells per group, then
        # (offset in a channel row, bin count) per feature
        layout=tuple([g[0] for g in groups] + [len(nb)] + group_cells
                     + [v for pair in zip(foff, nb) for v in pair]),
    )


def histogram_reference(x_binned: torch.Tensor, payload: torch.Tensor,
                        slot: torch.Tensor, *, n_slots: int, n_bins: int,
                        packed: torch.Tensor | None = None,
                        order: torch.Tensor | None = None,
                        seg_start: torch.Tensor | None = None,
                        scale_exp=None) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` per channel over the
    flat ``((slot*F + f)*C + c)*B + bin`` cell ids of the rows that fall
    in ``[0, S)`` with a nonzero payload in that channel (bins outside
    ``[0, B)`` masked the same way as in the kernels), rows in storage
    order. Given ``packed`` it reads the bins from there, and given
    ``order``/``seg_start`` it takes each row's slot from its segment
    instead of from ``slot``, as the kernels do. Given ``scale_exp`` it is
    the fixed-point route: it adds :func:`quantize` of the payload into an
    int64 histogram (an exact sum, so its order does not matter)."""
    N, F = x_binned.shape
    C = payload.shape[1]
    dev = x_binned.device
    if packed is not None:
        x_binned = packed[:, :F]
    if order is not None:
        seg = seg_start.to(torch.int64)
        pos = torch.arange(N, device=dev)
        s_of_pos = torch.searchsorted(seg, pos, right=True) - 1
        live = (pos >= seg[0]) & (pos < seg[n_slots])
        slot = torch.full((N,), -1, dtype=torch.int64, device=dev)
        slot[order[live].to(torch.int64)] = s_of_pos[live]
    if scale_exp is not None:
        payload = quantize(payload, scale_exp)
    out = torch.zeros(n_slots * F * C * n_bins, device=dev,
                      dtype=torch.float32 if scale_exp is None
                      else torch.int64)
    in_range = (slot >= 0) & (slot < n_slots)
    feat = torch.arange(F, device=dev, dtype=torch.int64)
    for c in range(C):
        rows = torch.nonzero(in_range & (payload[:, c] != 0)).squeeze(1)
        xb = x_binned[rows].to(torch.int64)
        ids = ((slot[rows].to(torch.int64)[:, None] * F + feat) * C + c) \
            * n_bins + xb
        vals = payload[rows, c][:, None].expand(-1, F)
        ok = (xb >= 0) & (xb < n_bins)
        out.index_add_(0, ids[ok], vals[ok])
    return out.view(n_slots, F, C, n_bins)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "histogram": {"mpt_hist_tile": [_PTR] * 7 + [_INT] * 13 + [_PTR]},
    "fixed_hist": {"mpt_fixed_tile": [_PTR] * 8 + [_INT] * 15 + [_PTR]},
}
_libs: dict = {}
_layouts: dict = {}
_scales: dict = {}


def _library(name: str = "histogram"):
    """The built ``csrc/<name>.cu`` (``histogram``: the integer body;
    ``fixed_hist``: the fixed-point body), its functions typed."""
    if name not in _libs:
        from mpitree_tpu_torch import _build

        lib = _build.load(name)
        for fname, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mpt_error_string.argtypes = [ctypes.c_int]
        lib.mpt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _check(code: int, what: str, lib: str = "histogram") -> None:
    if code != 0:
        msg = _library(lib).mpt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _layout(p: dict, dev: torch.device) -> torch.Tensor:
    """The plan's tile layout on ``dev`` (int32), uploaded once per
    distinct layout and device."""
    key = (dev, p["layout"])
    if key not in _layouts:
        _layouts[key] = torch.tensor(p["layout"], dtype=torch.int32,
                                     device=dev)
    return _layouts[key]


def _scale(scale_exp, n_chan: int, dev: torch.device) -> torch.Tensor:
    """The fixed-point scales ``2**k[c]`` on ``dev`` (float64), uploaded
    once per distinct exponent tuple and device."""
    key = (dev, tuple(int(k) for k in scale_exp))
    if len(key[1]) != n_chan:
        raise ValueError(
            f"scale_exp must hold {n_chan} exponents "
            f"(fixed_point_exponents), got {scale_exp!r}")
    if key not in _scales:
        _scales[key] = torch.tensor([2.0 ** k for k in key[1]],
                                    dtype=torch.float64, device=dev)
    return _scales[key]


def histogram_cuda(x_binned: torch.Tensor, payload: torch.Tensor,
                   slot: torch.Tensor, *, n_slots: int, n_bins: int,
                   packed: torch.Tensor | None = None,
                   order: torch.Tensor | None = None,
                   seg_start: torch.Tensor | None = None,
                   feat_bins=None, scale_exp=None,
                   _variant: str | None = None,
                   _tune: dict | None = None) -> torch.Tensor:
    """Launch the route :func:`plan` picks; returns the ``(S, F, C, B)``
    float32 histogram, or with ``scale_exp`` the int64 fixed-point one
    (routes ``stream_fixed``/``sorted_fixed``; ``scale_exp`` must come from
    :func:`fixed_point_exponents` of this payload, which also refused
    non-finite values). Without ``scale_exp`` the payload must pass
    :func:`float32_exact`. Launches on the current stream without
    synchronising, apart from that check's first sight of a payload.
    Raises on anything the kernels do not take.

    ``packed`` is :func:`pack_bins` of ``x_binned`` (read instead of it),
    ``order``/``seg_start`` are :func:`slot_segments` of ``slot`` (made here
    when the sorted route runs without them), ``feat_bins`` the per-feature
    bin counts: a bin id at or above its feature's count adds nothing.
    ``_variant`` forces a route and ``_tune`` names :func:`plan`'s
    ``piece_rows`` (and, for the fixed-point body, ``threads`` and
    ``adds``); only
    ``chip_smoke.py``, the card tests and ``fixed_hist_ab.py`` pass them,
    to time the routes and candidates against each other at one width and
    to drive small pieces."""
    if not (x_binned.is_cuda and payload.is_cuda and slot.is_cuda):
        raise ValueError("histogram_cuda needs CUDA tensors")
    if not (x_binned.device == payload.device == slot.device):
        raise ValueError("x_binned, payload and slot must share a device")
    if x_binned.dtype != torch.int32 or x_binned.dim() != 2:
        raise ValueError("x_binned must be a 2-D int32 tensor")
    if payload.dtype != torch.float32 or payload.dim() != 2:
        raise ValueError("payload must be a 2-D float32 tensor")
    if slot.dtype != torch.int32 or slot.dim() != 1:
        raise ValueError("slot must be a 1-D int32 tensor")
    N, F = x_binned.shape
    C = payload.shape[1]
    if payload.shape[0] != N or slot.shape[0] != N:
        raise ValueError(
            f"row counts differ: x_binned {N}, payload {payload.shape[0]}, "
            f"slot {slot.shape[0]}"
        )
    if not (x_binned.is_contiguous() and payload.is_contiguous()
            and slot.is_contiguous()):
        raise ValueError("x_binned, payload and slot must be contiguous")
    if n_slots < 1 or n_bins < 1 or F < 1 or C < 1:
        raise ValueError(
            f"empty histogram shape S={n_slots} F={F} C={C} B={n_bins}"
        )
    if N * F >= 2**31:
        raise ValueError(f"N*F = {N * F} exceeds the kernels' 32-bit row ids")
    dev = x_binned.device
    if packed is not None:
        if n_bins > 256:
            raise ValueError(
                f"packed (byte-wide) bins need n_bins <= 256, got {n_bins}")
        if (packed.dtype != torch.uint8 or packed.dim() != 2
                or packed.shape[0] != N or packed.shape[1] < F
                or packed.shape[1] % LANE_FEATURES):
            raise ValueError(
                f"packed must be (N, width) uint8 with width >= F a "
                f"multiple of {LANE_FEATURES} (pack_bins), got "
                f"{tuple(packed.shape)} {packed.dtype}")
        if (packed.device != dev or not packed.is_contiguous()
                or packed.data_ptr() % 16):
            raise ValueError(
                "packed must be contiguous, 16-byte aligned and on the "
                "device of x_binned")
    if (order is None) != (seg_start is None):
        raise ValueError("order and seg_start come together")
    if order is not None:
        if (order.dtype != torch.int32 or order.shape != (N,)
                or seg_start.dtype != torch.int32
                or seg_start.shape != (n_slots + 1,)):
            raise ValueError(
                f"order must be ({N},) int32 and seg_start ({n_slots + 1},) "
                f"int32 (slot_segments), got {tuple(order.shape)} "
                f"{order.dtype} and {tuple(seg_start.shape)} "
                f"{seg_start.dtype}")
        if not (order.device == seg_start.device == dev
                and order.is_contiguous() and seg_start.is_contiguous()):
            raise ValueError(
                "order and seg_start must be contiguous and on the device "
                "of x_binned")
    fixed = scale_exp is not None
    if not fixed and not float32_exact(payload):
        raise ValueError(
            "the float32 route sums integer payloads below 2**24 only; pass "
            "scale_exp (fixed_point_exponents) for this payload")
    scale = _scale(scale_exp, C, dev) if fixed else None
    p = plan(n_slots, F, C, n_bins, _variant, feat_bins=feat_bins,
             n_rows=max(N, 1), n_sms=sm_count(dev), fixed=fixed,
             **(_tune or {}))
    route = p["route"]
    alloc = torch.empty if route == "sorted" and N else torch.zeros
    out = alloc((n_slots, F, C, n_bins), device=dev,
                dtype=torch.int64 if fixed else torch.float32)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_sorted = route == "sorted"
    if is_sorted and order is None:
        order, seg_start = slot_segments(slot, n_slots)
    bins = x_binned if packed is None else packed
    if fixed:
        n_blocks = p["n_blocks"] or math.ceil(N / p["piece_rows"]) + n_slots
        with torch.cuda.device(dev):
            _check(_library("fixed_hist").mpt_fixed_tile(
                bins.data_ptr(), payload.data_ptr(), slot.data_ptr(),
                order.data_ptr() if is_sorted else None,
                seg_start.data_ptr() if is_sorted else None,
                _layout(p, dev).data_ptr(), scale.data_ptr(),
                out.data_ptr(), N, bins.shape[1], F, C, n_bins, n_slots,
                len(p["groups"]), p["piece_rows"], n_blocks, p["threads"],
                p["smem"], bins.element_size(), p["chan"], int(is_sorted),
                int(p["adds"] == "limbs"), stream,
            ), f"fixed_tile[{route}_fixed]", "fixed_hist")
        launches[f"{route}_fixed"] += 1
        return out
    lib = _library()
    n_pieces = math.ceil(N / p["piece_rows"])
    with torch.cuda.device(dev):
        _check(lib.mpt_hist_tile(
            bins.data_ptr(), payload.data_ptr(), slot.data_ptr(),
            order.data_ptr() if is_sorted else None,
            seg_start.data_ptr() if is_sorted else None,
            _layout(p, dev).data_ptr(), out.data_ptr(), N,
            bins.shape[1], F, C, n_bins, n_slots, len(p["groups"]),
            p["piece_rows"], n_pieces + (n_slots if is_sorted else 0),
            p["threads"], p["smem"], bins.element_size(),
            int(is_sorted), stream,
        ), f"hist_tile[{route}]")
    launches[route] += 1
    return out


def histogram(x_binned: torch.Tensor, payload: torch.Tensor,
              slot: torch.Tensor, *, n_slots: int, n_bins: int,
              packed: torch.Tensor | None = None,
              order: torch.Tensor | None = None,
              seg_start: torch.Tensor | None = None,
              feat_bins=None, scale_exp=None) -> torch.Tensor:
    """``(S, F, C, B)`` payload histogram: the kernel on CUDA tensors,
    the plain version on CPU tensors; float32, or int64 fixed-point sums
    given ``scale_exp``. The optional arguments are those of
    :func:`histogram_cuda`."""
    if x_binned.is_cuda:
        return histogram_cuda(x_binned, payload, slot, n_slots=n_slots,
                              n_bins=n_bins, packed=packed, order=order,
                              seg_start=seg_start, feat_bins=feat_bins,
                              scale_exp=scale_exp)
    return histogram_reference(x_binned, payload, slot, n_slots=n_slots,
                               n_bins=n_bins, packed=packed, order=order,
                               seg_start=seg_start, scale_exp=scale_exp)
