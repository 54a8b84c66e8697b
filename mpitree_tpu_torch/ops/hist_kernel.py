"""The payload histogram kernel family for Hopper, its wrapper and its plain version.

Replaces the three TPU kernels of the JAX package, which all compute one
function — ``hist[s, f, c, b] = sum_r payload[r, c] * [slot[r] == s] *
[xb[r, f] == b]``, rows with ``slot`` outside ``[0, S)`` adding nothing:

- K1 ``mpitree_tpu/ops/pallas_hist.py:77`` ``_hist_kernel`` (one block, S <= ~8)
  -> variant ``"small"`` where it is faster, else ``"wide"``;
- K2 ``mpitree_tpu/ops/pallas_hist.py:103`` ``_hist_kernel_fgrid`` (S = 64..128)
  -> variant ``"wide"``;
- K3 ``mpitree_tpu/ops/wide_hist.py:252`` ``_wide_kernel`` (S >= 256)
  -> variant ``"wide"``.

The TPU kernels turn the scatter into one-hot matrix products because the
TPU has no fast scatter. Hopper has native float atomics in shared and
device memory, so the kernels here (``csrc/histogram.cu``) scatter: the
small variant privatizes a (slots x features x C x B) tile in shared
memory and flushes it with global atomics, the wide variant adds straight
into the output. One thread takes one (row, feature) element, so a warp
reads a row's bin ids coalesced and spreads its atomics over features.

Which variant serves which width is measured, not reasoned:
``chip_smoke.py`` times every variant whose tile fits at each width on
the card (``PERF.md``). The shared tile pays off only at S = 1, where
every row lands in one slot; from S = 8 up the global atomics of ``wide``
are faster. So ``small`` takes ``S <= SMALL_MAX_SLOTS`` and ``wide`` the
rest.

What bounds them on an H100: memory traffic. A pass must read the slot
vector (``N*4`` bytes), and for the rows inside the slot range their bins
and payload (``F*4 + C*4`` bytes each), and write the ``S*F*C*B*4``-byte
output once (the wrapper zeroes it first, which is part of the call),
against 3.35 TB/s; the adds (one per row and feature for a class payload)
are far below the card's atomic rate when they spread over many
addresses. What the design does about it: rows outside the slot range
read only their slot (deep levels walk many chunks, each a sparse pass),
zero payload channels issue no atomic, and the flush touches the output
only where a cell is nonzero. Contention is the known weakness: the 44
one-hot covtype columns have two bins, so at a narrow frontier many rows
add into one cell per (feature, class). Measured times beside the bound
are in ``PERF.md`` (``chip_smoke.py``).

Exactness: integer-valued payloads with sums below 2**24 are exact in
float32 in any order, so the kernels are bit-identical (``torch.equal``) to
:func:`histogram_reference` despite the unordered atomics — the contract
``mpitree_tpu/ops/histogram.py`` states for the XLA scatter. Fractional
weights are refused on CUDA (``core/builder.refuse_inexact_weights``).

On a CPU tensor :func:`histogram` uses :func:`histogram_reference`; on a
CUDA tensor it launches a kernel or raises. ``launches`` counts the kernel
launches per variant, and nothing else.
"""

from __future__ import annotations

import ctypes
import math

import torch

# Dynamic shared memory one block may use on Hopper (227 KB), and what one
# SM holds for all its resident blocks (228 KB, 1 KB of it reserved per block).
SMEM_BYTES = 232_448
SMEM_PER_SM = 233_472
# Widest frontier the small variant serves; measured faster than wide at
# S = 1 and slower at S = 8 (PERF.md, chip_smoke.py).
SMALL_MAX_SLOTS = 1
SMALL_THREADS = 1024  # kSmallThreads in csrc/histogram.cu
WIDE_THREADS = 256

launches = {"small": 0, "wide": 0}


def plan(n_slots: int, n_features: int, n_channels: int, n_bins: int,
         variant: str | None = None) -> dict:
    """Variant and tiling for one launch (host arithmetic, no device).

    ``small``: all slots in one shared-memory tile, as many features per
    block as fit (balanced over feature groups). ``wide``: global atomics,
    no tile. ``variant=None`` picks ``small`` up to ``SMALL_MAX_SLOTS``
    slots and ``wide`` beyond; a named variant gets its tiling, or
    ``ValueError`` when its tile cannot fit.
    """
    # one (slot, feature) tile in bytes, each channel's row padded by one
    # float against shared-memory bank conflicts (csrc/histogram.cu)
    per_cell = n_channels * (n_bins + 1) * 4
    fits = n_slots * per_cell <= SMEM_BYTES
    if variant is None:
        variant = "small" if n_slots <= SMALL_MAX_SLOTS and fits else "wide"
    if variant == "wide":
        return dict(variant="wide")
    if variant == "small" and fits:
        fc_max = min(n_features, SMEM_BYTES // (n_slots * per_cell))
        n_fgroups = math.ceil(n_features / fc_max)
        fc = math.ceil(n_features / n_fgroups)
        return dict(variant="small", feat_per_block=fc, n_fgroups=n_fgroups,
                    smem=n_slots * fc * per_cell)
    raise ValueError(
        f"variant {variant!r} does not fit S={n_slots} C={n_channels} "
        f"B={n_bins} in {SMEM_BYTES} bytes of shared memory"
    )


def histogram_reference(x_binned: torch.Tensor, payload: torch.Tensor,
                        slot: torch.Tensor, *, n_slots: int,
                        n_bins: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` per channel over the
    flat ``((slot*F + f)*C + c)*B + bin`` cell ids of the rows that fall
    in ``[0, S)`` with a nonzero payload in that channel (bins outside
    ``[0, B)`` masked the same way as in the kernels)."""
    N, F = x_binned.shape
    C = payload.shape[1]
    out = torch.zeros(n_slots * F * C * n_bins, dtype=torch.float32,
                      device=x_binned.device)
    in_range = (slot >= 0) & (slot < n_slots)
    feat = torch.arange(F, device=x_binned.device, dtype=torch.int64)
    for c in range(C):
        rows = torch.nonzero(in_range & (payload[:, c] != 0)).squeeze(1)
        xb = x_binned[rows].to(torch.int64)
        ids = ((slot[rows].to(torch.int64)[:, None] * F + feat) * C + c) \
            * n_bins + xb
        vals = payload[rows, c][:, None].expand(-1, F)
        ok = (xb >= 0) & (xb < n_bins)
        out.index_add_(0, ids[ok], vals[ok])
    return out.view(n_slots, F, C, n_bins)


_SIGNATURES = {
    "mpt_hist_small": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    "mpt_hist_wide": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
}
_lib = None
_sm_count: dict = {}


def _library():
    global _lib
    if _lib is None:
        from mpitree_tpu_torch import _build

        lib = _build.load("histogram")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mpt_error_string.argtypes = [ctypes.c_int]
        lib.mpt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(code: int, what: str) -> None:
    if code != 0:
        msg = _library().mpt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def histogram_cuda(x_binned: torch.Tensor, payload: torch.Tensor,
                   slot: torch.Tensor, *, n_slots: int, n_bins: int,
                   _variant: str | None = None) -> torch.Tensor:
    """Launch the kernel variant :func:`plan` picks; returns the
    ``(S, F, C, B)`` float32 histogram. Allocates the zeroed output with
    ``torch.zeros`` and launches on the current stream without
    synchronising. Raises on anything the kernels do not take.
    ``_variant`` forces a variant; only ``chip_smoke.py`` passes it, to
    time the variants against each other at one width."""
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
    out = torch.zeros((n_slots, F, C, n_bins), dtype=torch.float32,
                      device=dev)
    if N == 0:
        return out
    p = plan(n_slots, F, C, n_bins, _variant)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x_binned.data_ptr(), payload.data_ptr(), slot.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(dev):
        if p["variant"] == "wide":
            blocks = min(math.ceil(N * F / WIDE_THREADS), _sms(dev) * 32)
            _check(lib.mpt_hist_wide(
                *ptrs, N, F, C, n_bins, n_slots, blocks, WIDE_THREADS,
                stream,
            ), "hist_wide")
        else:
            resident = max(1, min(2048 // SMALL_THREADS,
                                  SMEM_PER_SM // (p["smem"] + 1024)))
            n_rblocks = max(1, min(
                math.ceil(resident * _sms(dev) / p["n_fgroups"]),
                math.ceil(N / SMALL_THREADS), 65535,
            ))
            _check(lib.mpt_hist_small(
                *ptrs, N, F, C, n_bins, n_slots, p["feat_per_block"],
                p["n_fgroups"], n_rblocks, math.ceil(N / n_rblocks),
                p["smem"], stream,
            ), "hist_small")
    launches[p["variant"]] += 1
    return out


def histogram(x_binned: torch.Tensor, payload: torch.Tensor,
              slot: torch.Tensor, *, n_slots: int,
              n_bins: int) -> torch.Tensor:
    """``(S, F, C, B)`` payload histogram: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if x_binned.is_cuda:
        return histogram_cuda(x_binned, payload, slot, n_slots=n_slots,
                              n_bins=n_bins)
    return histogram_reference(x_binned, payload, slot, n_slots=n_slots,
                               n_bins=n_bins)
