"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

Every ``csrc/*.cu`` file is a source with a plain C interface (no
PyTorch headers; it may include the package's ``csrc/*.cuh``), compiled for Hopper (``sm_90a``) into
``build/torch_kernels/`` at the root of the checkout on first use, and
loaded with ``ctypes``. The library name carries a hash of the source,
the headers and the flags, so an edited source rebuilds and a stale library is never
loaded. Nothing here runs at import time: the first launch on a CUDA
tensor triggers the build of its source, and :func:`build_all` builds
every source at once, one ``nvcc`` process each, in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin``, else the toolkit's
    default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        f"nvcc not found (PATH or {home}/bin): the CUDA kernels build "
        "from source on a machine with the CUDA toolkit"
    )


def _library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    the headers it may include (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library is built;
    returns ``(library path, process or None)``."""
    out = _library_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
         str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, proc


def _finish(name: str, out: Path, proc) -> Path:
    """Wait for a build :func:`_start` began and move its library into
    place; raises with nvcc's output when it failed."""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):"
                f"\n{log}"
            )
        os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)
    return out


def build_all() -> list:
    """Build every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together; returns the source names."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    errors = []
    with _lock:
        started = [(name, *_start(name)) for name in names]
        for name, out, proc in started:  # wait for every one
            try:
                _finish(name, out, proc)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            # the extension's first build or load in this process: a cold
            # event of the fit it happens in (obs/observer.cold_event)
            from mpitree_tpu_torch.obs.observer import cold_event

            with cold_event(f"ext:{name}", name):
                path = _finish(name, *_start(name))
                lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
