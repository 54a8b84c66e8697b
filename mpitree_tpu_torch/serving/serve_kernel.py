"""The serving traversal kernels for Hopper, their wrappers, planner and plain versions.

Replaces the Pallas kernel ``mpitree_tpu/serving/pallas_serve.py:49``
(``_traverse_kernel``, reached through ``traverse_batch_pallas`` at
``:150``) in both of its forms:

- K4, :func:`traverse` (``launches["traverse"]``): float32 thresholds,
  float64 leaf values, a float64 reduction in one of three modes —
  ``sum``, ``norm`` (per-tree row over ``max(rowsum, 1)``) and ``percls``
  (tree ``t`` into column ``t mod n_out``) — from zeros or, given
  ``baseline``, from a boosted model's baseline margins;
- K5, :func:`traverse_q` (``launches["traverse_q"]``): the quantized
  tables of ``serving/quantize.py`` — int16 feature ids, bfloat16
  thresholds, int8 leaf values summed as an exact int32 lattice sum in
  ``sum`` or ``percls`` mode; the caller applies the affine dequantization
  once afterwards (it is linear across the ensemble sum).

The TPU kernel descends by one-hot matmuls over a stacked per-tree table
(Mosaic has no vector gather) and accumulates in float32 (the TPU has no
float64). ``csrc/traverse.cu`` gathers directly from the flat
depth-packed :class:`~mpitree_tpu_torch.serving.tables.NodeTable`, read
as one 16-byte record per node (:func:`pack_nodes`), with one thread per
(row, tree) descent and one thread per (row, output column) reduction in
member order, all output columns in one launch; :func:`plan` tiles a call.
The reduction uses IEEE float64 operations nvcc cannot contract: K4 equals
its plain version, and so the estimator's host loop, bit for bit. What
bounds it on an H100 and the measured times: ``PERF.md``
(``chip_smoke.py``).

On a CPU tensor each wrapper uses its plain version (``traversal.descend``
+ ``traversal.accumulate``); on a CUDA tensor it launches the kernel or
raises. There is no fallback from a failed build or launch. ``launches``
counts kernel launches, and nothing else: one per call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mpitree_tpu_torch._device import sm_count
from mpitree_tpu_torch.obs.memory import serve_smem_bytes
from mpitree_tpu_torch.serving import traversal

THREADS = 256  # threads per block the planner fills with (row, tree) pairs
# Blocks per SM the planner keeps before it packs more rows into a block
# (measured on an H100: PERF.md, chip_smoke.py's tiling sweep).
FILL_BLOCKS_PER_SM = 4
SMEM_STATIC = 48 * 1024  # dynamic shared memory without the opt-in
SMEM_BYTES = 232_448  # the most one block may opt in to on Hopper
N_SMS = 132  # an H100 SXM's streaming multiprocessors (plan's default)
_AGG_CODE = {"sum": 0, "norm": 1, "percls": 2}
# (kernel, feature dtype, threshold dtype, value dtype, accumulator dtype)
_FORMS = {
    "traverse": ("mpt_traverse", torch.int32, torch.float32, torch.float64,
                 torch.float64),
    "traverse_q": ("mpt_traverse_q", torch.int16, torch.bfloat16, torch.int8,
                   torch.int32),
}

launches = {"traverse": 0, "traverse_q": 0}

_lib = None


def _library():
    global _lib
    if _lib is None:
        from mpitree_tpu_torch import _build

        lib = _build.load("traverse")
        for name in ("mpt_traverse", "mpt_traverse_q"):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.mpt_traverse_error_string.argtypes = [ctypes.c_int]
        lib.mpt_traverse_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# one block's dynamic shared memory: obs/memory.serve_smem_bytes, the
# formula the memory ledger prices the served model's tile with
_smem_bytes = serve_smem_bytes


def plan(form: str, n_rows: int, n_trees: int, n_out: int, *,
         n_features: int, agg: str = "sum", n_sms: int = N_SMS,
         rows_per_block: int | None = None) -> dict:
    """Tiling of one launch (host arithmetic, no device).

    A block takes ``rows_per_block`` rows (R) and walks the trees in
    chunks of ``trees_per_chunk`` (Tc = ``min(T, THREADS // R)``), one
    thread per (row, tree) pair of a chunk, then one thread per (row,
    output column) for the reduction. R grows with the batch, as far as
    ``FILL_BLOCKS_PER_SM`` blocks per SM remain, up to ``THREADS //
    n_out`` (the reduction then keeps most threads busy): small batches
    get one row per block and all their trees in one chunk, large ones
    many rows and short chunks. R is cut further while the block's shared
    memory is above 48 KB. The X rows are staged in shared memory unless
    one row alone would not fit.
    ``rows_per_block`` forces R (``chip_smoke.py`` times alternatives).
    Returns R, Tc, ``threads``, ``blocks``, ``smem`` (bytes), ``stage_x``
    and ``chunks``, the ``(t0, t1)`` tree ranges in the order the block
    reduces them; raises ``ValueError`` when one row's block cannot fit in
    ``SMEM_BYTES``.
    """
    acc_bytes = _FORMS[form][4].itemsize
    norm = agg == "norm"
    T = max(int(n_trees), 1)
    if rows_per_block is None:
        r = max(1, min(THREADS // n_out,
                       n_rows // (FILL_BLOCKS_PER_SM * n_sms)))
    else:
        r = int(rows_per_block)
        if not 1 <= r <= THREADS:
            raise ValueError(f"rows_per_block must be in [1, {THREADS}]")

    stage_x = _smem_bytes(1, min(T, THREADS), n_out, n_features, acc_bytes,
                          norm, True) <= SMEM_BYTES

    def tiling(r):
        tc = min(T, max(1, THREADS // r))
        return tc, _smem_bytes(r, tc, n_out, n_features, acc_bytes, norm,
                               stage_x)

    tc, smem = tiling(r)
    while rows_per_block is None and r > 1 and smem > SMEM_STATIC:
        r -= 1
        tc, smem = tiling(r)
    if smem > SMEM_BYTES:
        raise ValueError(
            f"{form}: a block of {r} rows x {tc} trees with n_out={n_out} "
            f"needs {smem} bytes of shared memory, over {SMEM_BYTES}"
        )
    return dict(
        rows_per_block=r, trees_per_chunk=tc,
        threads=-(-r * tc // 32) * 32, blocks=math.ceil(n_rows / r),
        smem=smem, stage_x=stage_x,
        chunks=tuple((t0, min(t0 + tc, n_trees))
                     for t0 in range(0, n_trees, tc)),
    )


def pack_nodes(feature, threshold, left, right) -> torch.Tensor:
    """(M, 4) int32 node records, one 16-byte load per descent step:
    (feature, threshold's float32 bits, left, right). int16 feature ids and
    bfloat16 thresholds widen exactly. Built on the columns' device; a
    model packs once when it is compiled (``NodeTable.dev_record``)."""
    return torch.stack([
        feature.to(torch.int32),
        threshold.to(torch.float32).view(torch.int32),
        left.to(torch.int32), right.to(torch.int32),
    ], dim=1).contiguous()


def _check_inputs(form: str, X, table, values, *, agg: str, n_out: int,
                  n_features: int, record=None, baseline=None) -> None:
    """Raise on anything the kernels do not take (both devices)."""
    _, feat_t, thr_t, val_t, acc_t = _FORMS[form]
    feature, threshold, left, right, root = table
    if agg not in _AGG_CODE or (form == "traverse_q" and agg == "norm"):
        raise ValueError(f"{form}: unknown or unsupported mode {agg!r}")
    tensors = (X, feature, threshold, left, right, root, values)
    if any(t.device != X.device for t in tensors):
        raise ValueError(f"{form}: X, table and values must share a device")
    want = ((X, torch.float32, 2, "X"), (feature, feat_t, 1, "feature"),
            (threshold, thr_t, 1, "threshold"),
            (left, torch.int32, 1, "left"), (right, torch.int32, 1, "right"),
            (root, torch.int32, 1, "root"), (values, val_t, 2, "values"))
    if record is not None:
        want += ((record, torch.int32, 2, "record"),)
    if baseline is not None:
        want += ((baseline, acc_t, 1, "baseline"),)
        if baseline.shape[0] != n_out or baseline.device != X.device:
            raise ValueError(
                f"{form}: baseline must hold n_out={n_out} values on X's "
                f"device, got {tuple(baseline.shape)} on {baseline.device}"
            )
    for t, dtype, dim, name in want:
        if t.dtype != dtype or t.dim() != dim:
            raise ValueError(
                f"{form}: {name} must be a {dim}-D {dtype} tensor, got "
                f"{t.dim()}-D {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{form}: {name} must be contiguous")
    if X.shape[1] != n_features:
        raise ValueError(
            f"{form}: X has {X.shape[1]} features, the table was built for "
            f"{n_features}"
        )
    M = feature.shape[0]
    if not (threshold.shape[0] == left.shape[0] == right.shape[0]
            == values.shape[0] == M):
        raise ValueError(f"{form}: table columns and values differ in length")
    if record is not None and (record.shape != (M, 4)
                               or record.device != X.device):
        raise ValueError(
            f"{form}: record must be the table's (M, 4) pack_nodes on X's "
            f"device, got {tuple(record.shape)} on {record.device}"
        )
    if n_out < 1 or values.shape[1] < 1 or (
            agg != "percls" and n_out != values.shape[1]):
        raise ValueError(
            f"{form}: n_out={n_out} does not fit {values.shape[1]} value "
            f"channels in mode {agg!r}"
        )


def _launch(form: str, X, table, values, record, *, n_steps: int, agg: str,
            n_out: int, baseline=None,
            _rows_per_block: int | None = None) -> torch.Tensor:
    """Allocate the (N, n_out) output and launch the kernel once on the
    current stream, without synchronising. ``_rows_per_block`` forces the
    tiling's R; only ``chip_smoke.py`` passes it, to time tilings against
    each other."""
    name, *_, acc_t = _FORMS[form]
    N, F = X.shape
    feature, threshold, left, right, root = table
    T = root.shape[0]
    if N == 0 or T == 0:
        out = torch.zeros((N, n_out), dtype=acc_t, device=X.device)
        return out if baseline is None else out + baseline
    if record is None:
        record = pack_nodes(feature, threshold, left, right)
    p = plan(form, N, T, n_out, n_features=F, agg=agg,
             n_sms=sm_count(X.device), rows_per_block=_rows_per_block)
    out = torch.empty((N, n_out), dtype=acc_t, device=X.device)
    lib = _library()
    with torch.cuda.device(X.device):
        code = getattr(lib, name)(
            X.data_ptr(), record.data_ptr(), root.data_ptr(),
            values.data_ptr(),
            None if baseline is None else baseline.data_ptr(),
            out.data_ptr(), N, F, T, n_steps,
            values.shape[1], n_out, _AGG_CODE[agg], p["rows_per_block"],
            p["trees_per_chunk"], int(p["stage_x"]), p["threads"],
            p["smem"], torch.cuda.current_stream(X.device).cuda_stream,
        )
    if code != 0:
        msg = lib.mpt_traverse_error_string(code).decode()
        raise RuntimeError(f"{form} launch failed: CUDA error {code} ({msg})")
    launches[form] += 1
    return out


def traverse_reference(X, feature, threshold, left, right, root, values, *,
                       n_steps: int, agg: str, n_out: int,
                       baseline=None) -> torch.Tensor:
    """K4's plain version: ``traversal.descend`` + ``traversal.accumulate``."""
    node = traversal.descend(X, feature, threshold, left, right, root,
                             n_steps)
    return traversal.accumulate(node, values, agg=agg, n_out=n_out,
                                baseline=baseline)


def traverse_q_reference(X, feature, threshold, left, right, root, qvals, *,
                         n_steps: int, agg: str, n_out: int) -> torch.Tensor:
    """K5's plain version: the descent over the int16/bfloat16 columns
    (both upcasts exact) and the int32 lattice sum."""
    node = traversal.descend(X, feature.to(torch.int32),
                             threshold.to(torch.float32), left, right, root,
                             n_steps)
    return traversal.accumulate(node, qvals.to(torch.int32), agg=agg,
                                n_out=n_out)


def traverse(X, feature, threshold, left, right, root, values, *,
             n_steps: int, agg: str, n_out: int, n_features: int,
             record: torch.Tensor | None = None,
             baseline: torch.Tensor | None = None) -> torch.Tensor:
    """K4: (N, n_out) float64 ensemble reduction (no division by the tree
    count: the caller owns the per-kind tail). The kernel on CUDA tensors,
    :func:`traverse_reference` on CPU tensors. ``record`` is the columns'
    :func:`pack_nodes`, kept by the caller; without it the kernel's call
    packs them first. ``baseline`` ((n_out,) float64 on X's device, a
    boosted model's baseline margins) is where every row's accumulator
    starts, so the trees add to it in the estimator's order."""
    table = (feature, threshold, left, right, root)
    _check_inputs("traverse", X, table, values, agg=agg, n_out=n_out,
                  n_features=n_features, record=record, baseline=baseline)
    if X.is_cuda:
        return _launch("traverse", X, table, values, record,
                       n_steps=n_steps, agg=agg, n_out=n_out,
                       baseline=baseline)
    return traverse_reference(X, *table, values, n_steps=n_steps, agg=agg,
                              n_out=n_out, baseline=baseline)


def traverse_q(X, feature, threshold, left, right, root, qvals, *,
               n_steps: int, agg: str, n_out: int, n_features: int,
               record: torch.Tensor | None = None) -> torch.Tensor:
    """K5: (N, n_out) int32 lattice sum over the quantized tables. The
    kernel on CUDA tensors, :func:`traverse_q_reference` on CPU tensors;
    ``record`` as for :func:`traverse`."""
    table = (feature, threshold, left, right, root)
    _check_inputs("traverse_q", X, table, qvals, agg=agg, n_out=n_out,
                  n_features=n_features, record=record)
    if X.is_cuda:
        return _launch("traverse_q", X, table, qvals, record,
                       n_steps=n_steps, agg=agg, n_out=n_out)
    return traverse_q_reference(X, *table, qvals, n_steps=n_steps, agg=agg,
                                n_out=n_out)
