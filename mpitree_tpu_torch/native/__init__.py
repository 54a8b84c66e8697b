"""The native host split sweep: ``split_kernel.cpp`` built with ``g++`` at
first use and bound with ``ctypes``.

Counterpart of ``mpitree_tpu/native/__init__.py``; ``split_kernel.cpp`` is a
byte-identical copy of the JAX package's. It is the C++ sweep, for
classification and regression, of the host builder
(``core/host_builder.py``) and of the hybrid refine tail
(``core/hybrid_builder.py``), which runs on the host's cores after the
crown is grown on the card. Its threads split frontier slots
(``MPITREE_TPU_NATIVE_THREADS``) and never change a tree.

The library is compiled into ``build/native/`` at the root of the checkout;
its name carries a hash of the source, the flags and the host's CPU
(``-march=native``), so an edited source rebuilds and a library built for
another CPU is never loaded. Each process compiles to a file of its own
and moves it into place, so concurrent first uses never load a half-written
library.

``lib()`` is ``None`` when ``MPITREE_TPU_NO_NATIVE`` is set (to anything
but ``"0"``) or ``g++`` is not on ``PATH``: callers then take the numpy
sweep, as the JAX package does. A build that fails with ``g++`` present
raises with the compiler's output; it never falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from mpitree_tpu_torch.config import knobs
from mpitree_tpu_torch.obs.observer import cold_event

SRC = Path(__file__).resolve().parent / "split_kernel.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
             "-pthread")

_LOCK = threading.Lock()
_LIB: list = []  # [] = not loaded yet, [CDLL] = loaded

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def disabled() -> bool:
    """``MPITREE_TPU_NO_NATIVE`` set to anything but ``""`` or ``"0"``
    (the JAX package's boolean knob convention)."""
    return bool(knobs.value("MPITREE_TPU_NO_NATIVE"))


def _host_tag() -> str:
    """The machine and a hash of its CPU feature flags: a ``-march=native``
    library must not be loaded on a CPU that lacks its instructions."""
    tag = platform.machine() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    h = hashlib.sha256(line.encode()).hexdigest()[:8]
                    return f"{tag}-{h}"
    except OSError:
        pass
    return tag


def library_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
        + _host_tag().encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libsplit_kernel-{digest}.so"


def _build(gxx: str) -> Path:
    """Compile ``split_kernel.cpp`` unless its library exists; raises
    ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build {SRC.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def lib():
    """The loaded library, or ``None`` when the native sweep is disabled
    or there is no ``g++``."""
    if disabled():
        return None
    if _LIB:
        return _LIB[0]
    with _LOCK:
        if _LIB:
            return _LIB[0]
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        # its build (or a cached library's load): a cold event of the
        # fit it happens in (obs/observer.cold_event)
        with cold_event("native:split_kernel", "split_kernel"):
            cdll = ctypes.CDLL(str(_build(gxx)))
        cdll.best_splits_classification.argtypes = [
            _i32p, _i32p, _i32p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _i32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            _i32p, _i32p, _f64p, _f64p, _u8p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        cdll.best_splits_classification.restype = None
        cdll.best_splits_regression.argtypes = [
            _i32p, _f32p, _i32p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, _i32p, ctypes.c_int32, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            _i32p, _i32p, _f64p, _f64p, _u8p, _f64p, _f64p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        cdll.best_splits_regression.restype = None
        _LIB.append(cdll)
        return cdll


def _mono_args(mono_cst, mono_lo, mono_hi, n_slots):
    """(cst, lo, hi, out_vl, out_vr) pointers and arrays for the kernel's
    monotonic gate (``_mono_args``, ``mpitree_tpu/native/__init__.py:126``):
    all ``None`` when ``mono_cst`` is None (the unconstrained sweep),
    otherwise int8 signs, the (n_slots,) float32 bound windows and two
    (n_slots,) float32 outputs for the winners' child values."""
    if mono_cst is None:
        return None, None, None, None, None
    cst8 = np.ascontiguousarray(mono_cst, np.int8)
    lo32 = np.ascontiguousarray(mono_lo, np.float32)
    hi32 = np.ascontiguousarray(mono_hi, np.float32)
    if lo32.shape != (n_slots,) or hi32.shape != (n_slots,):
        raise ValueError(f"mono_lo {lo32.shape}, mono_hi {hi32.shape} "
                         f"(want ({n_slots},))")
    return (cst8, lo32, hi32, np.zeros(n_slots, np.float32),
            np.zeros(n_slots, np.float32))


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _with_values(out: dict, out_vl, out_vr) -> dict:
    if out_vl is not None:
        out["v_left"] = out_vl
        out["v_right"] = out_vr
    return out


def best_splits_classification(
    xb, y, node_id, w, *, n_bins, n_classes, frontier_lo, n_slots, n_cand,
    criterion, n_cand_per_slot=False, min_child_weight=0.0,
    mono_cst=None, mono_lo=None, mono_hi=None,
):
    """One level's best split per frontier slot (``None`` without the
    library): a dict of per-slot ``feature``, ``bin``, ``cost``,
    ``counts`` (float64 class counts) and ``constant``.

    ``xb`` (N, F) int32 bins, ``y`` (N,) int32 classes, ``node_id`` (N,)
    int32 (rows outside ``[frontier_lo, frontier_lo + n_slots)`` are
    ignored), ``w`` (N,) weights or None. ``n_cand_per_slot=True`` marks
    ``n_cand`` as (n_slots, F): one candidate count per frontier node, for
    the refine tail's multi-root frontiers where every root has its own
    exact local bins. ``mono_cst`` ((F,) internal signs) with the
    frontier's ``mono_lo``/``mono_hi`` ((n_slots,) float32 bounds)
    engages the kernel's monotonic gate, whose child values are exact for
    integer weights; the result then carries the winners' ``v_left`` and
    ``v_right`` (float32).
    """
    cdll = lib()
    if cdll is None:
        return None
    xb = np.ascontiguousarray(xb, np.int32)
    n_rows, n_feat = xb.shape
    y = np.ascontiguousarray(y, np.int32)
    node_id = np.ascontiguousarray(node_id, np.int32)
    n_cand = np.ascontiguousarray(n_cand, np.int32)
    want = (n_slots, n_feat) if n_cand_per_slot else (n_feat,)
    if y.shape != (n_rows,) or node_id.shape != (n_rows,) \
            or n_cand.shape != want:
        raise ValueError(
            f"best_splits_classification: xb {xb.shape}, y {y.shape}, "
            f"node_id {node_id.shape}, n_cand {n_cand.shape} (want {want})"
        )
    w64 = None if w is None else np.ascontiguousarray(w, np.float64)
    if w64 is not None and w64.shape != (n_rows,):
        raise ValueError(f"w has shape {w64.shape}, want ({n_rows},)")
    out_feat = np.empty(n_slots, np.int32)
    out_bin = np.empty(n_slots, np.int32)
    out_cost = np.empty(n_slots, np.float64)
    out_counts = np.zeros((n_slots, n_classes), np.float64)
    out_constant = np.empty(n_slots, np.uint8)
    cst, lo, hi, out_vl, out_vr = _mono_args(mono_cst, mono_lo, mono_hi,
                                             n_slots)
    cdll.best_splits_classification(
        xb, y, node_id, _ptr(w64),
        n_rows, n_feat, n_bins, n_classes, frontier_lo, n_slots, n_cand,
        1 if n_cand_per_slot else 0, 0 if criterion == "entropy" else 1,
        float(min_child_weight), _ptr(cst), _ptr(lo), _ptr(hi),
        out_feat, out_bin, out_cost, out_counts, out_constant,
        _ptr(out_vl), _ptr(out_vr),
    )
    return _with_values({
        "feature": out_feat, "bin": out_bin, "cost": out_cost,
        "counts": out_counts, "constant": out_constant.astype(bool),
    }, out_vl, out_vr)


def best_splits_regression(
    xb, yv, node_id, w, *, n_bins, frontier_lo, n_slots, n_cand,
    n_cand_per_slot=False, min_child_weight=0.0,
    mono_cst=None, mono_lo=None, mono_hi=None,
):
    """One level's best squared-error split per frontier slot (``None``
    without the library), ``best_splits_regression``
    (``mpitree_tpu/native/__init__.py:193``): a dict of per-slot
    ``feature``, ``bin``, ``cost``, ``counts`` (float64 moments ``(w,
    w*y, w*y^2)``), ``constant`` and ``ymin``/``ymax`` over rows of
    positive weight. ``yv`` (N,) float32 targets; the other arguments are
    :func:`best_splits_classification`'s. The kernel's regression gate
    reads child means cast from its float64 sums, which are not the
    device engine's values, so the host tier runs constrained regression
    on its numpy sweep and never passes ``mono_cst`` here, as the JAX
    package's host tier does."""
    cdll = lib()
    if cdll is None:
        return None
    xb = np.ascontiguousarray(xb, np.int32)
    n_rows, n_feat = xb.shape
    yv = np.ascontiguousarray(yv, np.float32)
    node_id = np.ascontiguousarray(node_id, np.int32)
    n_cand = np.ascontiguousarray(n_cand, np.int32)
    want = (n_slots, n_feat) if n_cand_per_slot else (n_feat,)
    if yv.shape != (n_rows,) or node_id.shape != (n_rows,) \
            or n_cand.shape != want:
        raise ValueError(
            f"best_splits_regression: xb {xb.shape}, y {yv.shape}, "
            f"node_id {node_id.shape}, n_cand {n_cand.shape} (want {want})"
        )
    w64 = None if w is None else np.ascontiguousarray(w, np.float64)
    if w64 is not None and w64.shape != (n_rows,):
        raise ValueError(f"w has shape {w64.shape}, want ({n_rows},)")
    out_feat = np.empty(n_slots, np.int32)
    out_bin = np.empty(n_slots, np.int32)
    out_cost = np.empty(n_slots, np.float64)
    out_counts = np.zeros((n_slots, 3), np.float64)
    out_constant = np.empty(n_slots, np.uint8)
    out_ymin = np.empty(n_slots, np.float64)
    out_ymax = np.empty(n_slots, np.float64)
    cst, lo, hi, out_vl, out_vr = _mono_args(mono_cst, mono_lo, mono_hi,
                                             n_slots)
    cdll.best_splits_regression(
        xb, yv, node_id, _ptr(w64),
        n_rows, n_feat, n_bins, frontier_lo, n_slots, n_cand,
        1 if n_cand_per_slot else 0, float(min_child_weight),
        _ptr(cst), _ptr(lo), _ptr(hi),
        out_feat, out_bin, out_cost, out_counts, out_constant,
        out_ymin, out_ymax, _ptr(out_vl), _ptr(out_vr),
    )
    return _with_values({
        "feature": out_feat, "bin": out_bin, "cost": out_cost,
        "counts": out_counts, "constant": out_constant.astype(bool),
        "ymin": out_ymin, "ymax": out_ymax,
    }, out_vl, out_vr)
