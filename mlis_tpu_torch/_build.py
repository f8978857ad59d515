"""Build the port's CUDA kernels into one shared library and load it.

All sources in ``mlis_tpu_torch/csrc/*.cu`` have a plain C interface. One
``nvcc`` call compiles them for Hopper (``sm_90a``) into
``build/mlis_tpu_torch/libmlis_kernels.so`` at the repository root, on
first use. The library is rebuilt when the hash of the sources changes and
is loaded with ``ctypes``; nothing here includes PyTorch's headers, so the
build takes seconds.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "mlis_tpu_torch"
LIB_NAME = "libmlis_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 600

_lib: Optional[ctypes.CDLL] = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels of mlis_tpu_torch cannot be built"
    )


def build(ptxas_verbose: bool = False) -> dict:
    """Compile the library if it is missing or stale.

    Returns ``{"path", "built", "seconds", "ptxas"}``; ``ptxas`` holds
    nvcc's ``-Xptxas -v`` report (registers, shared memory, spills per
    kernel) when ``ptxas_verbose`` is set and a build ran. Raises
    ``RuntimeError`` with nvcc's stderr when the build fails.
    """
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_digest()
    if lib_path.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return {"path": str(lib_path), "built": False, "seconds": 0.0, "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if ptxas_verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), *(str(s) for s in sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
            stdin=subprocess.DEVNULL,
        )
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s: {e}") from e
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    stamp.write_text(digest + "\n")
    return {
        "path": str(lib_path),
        "built": True,
        "seconds": seconds,
        "ptxas": proc.stderr + proc.stdout,
    }


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's ``argtypes`` and ``restype`` set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        p, i, d, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
        lib.mlis_tri_count.argtypes = [p, p, p, p, i, i, i, d, i, p, p]
        lib.mlis_tri_count.restype = ctypes.c_int
        strides = ctypes.POINTER(ll)  # 12 element strides: (b, l, h) of q, k, v, out
        lib.mlis_flash_attention.argtypes = [p, p, p, p, i, p, strides, i, i, i, i, i, i, p]
        lib.mlis_flash_attention.restype = ctypes.c_int
        lib.mlis_dense_attention.argtypes = [p, p, p, p, ll, ll, ll, p, strides, i, i, i, i, i, i,
                                             p]
        lib.mlis_dense_attention.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error after its launch, or
    (codes from 10000) a TMA tensor map that cuTensorMapEncodeTiled refused."""
    if status >= 10000:
        why = ("cuTensorMapEncodeTiled was not found" if status == 20000
               else f"cuTensorMapEncodeTiled returned CUresult {status - 10000}")
        raise RuntimeError(f"CUDA kernel {name}: no TMA tensor map ({why})")
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
