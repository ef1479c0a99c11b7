"""Build and load the hand-written CUDA kernels (nvcc -> plain-C shared library).

Each ``csrc/<name>.cu`` compiles on its own, with one ``nvcc`` process per
source started together, into ``build/kernels/<name>-<digest>.so`` at the
root of the checkout (git-ignored).  The digest covers the source and the
flags, so an edited source rebuilds and a stale library is never loaded.
Nothing is built at import time: the first launch of any kernel builds all
of them, and :func:`load_all` does the same on demand (the serving engine's
``warmup`` and ``chip_smoke.py`` call it so that no build lands inside a
timed region).

Every C entry point takes its pointers and the CUDA stream as ``void *``,
its sizes and flags as ``int``, then its real-valued arguments as ``float``,
and returns ``cudaGetLastError()`` after the launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["KERNELS", "NVCC_FLAGS", "build_all", "load_all", "entry", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("spike_matmul", "lif_scan", "sparse_accum", "quant_matmul", "flash_attention")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=KERNELS) -> float:
    """Compile every missing library in parallel; returns the wall seconds."""
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in todo:
        # write beside the target, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, tmp, proc))
    failed = []
    for name, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, _library_path(name))
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load_all() -> float:
    """Build (if needed) and load every kernel library; returns build seconds."""
    seconds = build_all()
    for name in KERNELS:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_library_path(name)))
    return seconds


def entry(name: str, symbol: str, n_pointers: int, n_ints: int, n_floats: int = 0):
    """The C entry point ``symbol`` of kernel library ``name``, typed as
    ``(void *) * n_pointers, int * n_ints, float * n_floats, void *stream -> int``."""
    fn = _ENTRIES.get(symbol)
    if fn is None:
        if name not in _LIBS:
            load_all()
        fn = getattr(_LIBS[name], symbol)
        fn.argtypes = (
            [ctypes.c_void_p] * n_pointers
            + [ctypes.c_int] * n_ints
            + [ctypes.c_float] * n_floats
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _ENTRIES[symbol] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")
