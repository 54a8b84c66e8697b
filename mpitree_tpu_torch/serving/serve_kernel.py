"""The serving traversal kernels for Hopper, their wrappers and their plain versions.

Replaces the Pallas kernel ``mpitree_tpu/serving/pallas_serve.py:49``
(``_traverse_kernel``, reached through ``traverse_batch_pallas`` at
``:150``) in both of its forms:

- K4, :func:`traverse` (``launches["traverse"]``): float32 thresholds,
  float64 leaf values, a float64 reduction in one of three modes —
  ``sum``, ``norm`` (per-tree row over ``max(rowsum, 1)``, forest
  ``predict_proba``) and ``percls`` (tree ``t`` into column ``t mod
  n_out``);
- K5, :func:`traverse_q` (``launches["traverse_q"]``): the quantized
  tables of ``serving/quantize.py`` — int16 feature ids, bfloat16
  thresholds, int8 leaf values summed as an exact int32 lattice sum in
  ``sum`` or ``percls`` mode; the caller applies the affine dequantization
  once afterwards (it is linear across the ensemble sum).

The TPU kernel descends by one-hot matmuls over a stacked per-tree table
(Mosaic has no vector gather) and accumulates in float32 (the TPU has no
float64). ``csrc/traverse.cu`` descends by direct gathers over the flat
depth-packed :class:`~mpitree_tpu_torch.serving.tables.NodeTable` columns
that the plain version reads, one thread per row, and reduces in float64
with IEEE operations nvcc cannot contract: K4 equals its plain version,
and so the estimator's host loop, bit for bit. What bounds it on an H100
and the measured times: ``PERF.md`` (``chip_smoke.py``).

On a CPU tensor each wrapper uses its plain version (``traversal.descend``
+ ``traversal.accumulate``); on a CUDA tensor it launches the kernel or
raises. There is no fallback from a failed build or launch. ``launches``
counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from mpitree_tpu_torch.serving import traversal

BLOCK_OUT = 8  # kBlockOut in csrc/traverse.cu: output columns per launch
THREADS = 128
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
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.mpt_traverse_error_string.argtypes = [ctypes.c_int]
        lib.mpt_traverse_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(form: str, X, table, values, *, agg: str, n_out: int,
                  n_features: int) -> None:
    """Raise on anything the kernels do not take (both devices)."""
    _, feat_t, thr_t, val_t, _ = _FORMS[form]
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
    if n_out < 1 or values.shape[1] < 1 or (
            agg != "percls" and n_out != values.shape[1]):
        raise ValueError(
            f"{form}: n_out={n_out} does not fit {values.shape[1]} value "
            f"channels in mode {agg!r}"
        )


def _launch(form: str, X, table, values, *, n_steps: int, agg: str,
            n_out: int) -> torch.Tensor:
    """Allocate the (N, n_out) output and launch the kernel once per
    BLOCK_OUT output columns on the current stream, without
    synchronising."""
    name, *_, acc_t = _FORMS[form]
    N, F = X.shape
    feature, threshold, left, right, root = table
    if N == 0 or root.shape[0] == 0:
        return torch.zeros((N, n_out), dtype=acc_t, device=X.device)
    out = torch.empty((N, n_out), dtype=acc_t, device=X.device)
    lib = _library()
    fn = getattr(lib, name)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    ptrs = (X.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            left.data_ptr(), right.data_ptr(), root.data_ptr(),
            values.data_ptr(), out.data_ptr())
    with torch.cuda.device(X.device):
        for c0 in range(0, n_out, BLOCK_OUT):
            code = fn(*ptrs, N, F, root.shape[0], n_steps, values.shape[1],
                      n_out, c0, _AGG_CODE[agg], THREADS, stream)
            if code != 0:
                msg = lib.mpt_traverse_error_string(code).decode()
                raise RuntimeError(
                    f"{form} launch failed: CUDA error {code} ({msg})"
                )
            launches[form] += 1
    return out


def traverse_reference(X, feature, threshold, left, right, root, values, *,
                       n_steps: int, agg: str, n_out: int) -> torch.Tensor:
    """K4's plain version: ``traversal.descend`` + ``traversal.accumulate``."""
    node = traversal.descend(X, feature, threshold, left, right, root,
                             n_steps)
    return traversal.accumulate(node, values, agg=agg, n_out=n_out)


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
             n_steps: int, agg: str, n_out: int,
             n_features: int) -> torch.Tensor:
    """K4: (N, n_out) float64 ensemble reduction (no division by the tree
    count: the caller owns the per-kind tail). The kernel on CUDA tensors,
    :func:`traverse_reference` on CPU tensors."""
    table = (feature, threshold, left, right, root)
    _check_inputs("traverse", X, table, values, agg=agg, n_out=n_out,
                  n_features=n_features)
    if X.is_cuda:
        return _launch("traverse", X, table, values, n_steps=n_steps,
                       agg=agg, n_out=n_out)
    return traverse_reference(X, *table, values, n_steps=n_steps, agg=agg,
                              n_out=n_out)


def traverse_q(X, feature, threshold, left, right, root, qvals, *,
               n_steps: int, agg: str, n_out: int,
               n_features: int) -> torch.Tensor:
    """K5: (N, n_out) int32 lattice sum over the quantized tables. The
    kernel on CUDA tensors, :func:`traverse_q_reference` on CPU tensors."""
    table = (feature, threshold, left, right, root)
    _check_inputs("traverse_q", X, table, qvals, agg=agg, n_out=n_out,
                  n_features=n_features)
    if X.is_cuda:
        return _launch("traverse_q", X, table, qvals, n_steps=n_steps,
                       agg=agg, n_out=n_out)
    return traverse_q_reference(X, *table, qvals, n_steps=n_steps, agg=agg,
                                n_out=n_out)
