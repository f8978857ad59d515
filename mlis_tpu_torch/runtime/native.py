"""ctypes bindings for the port's libmlis_runtime.so, with numpy fallbacks.

Counterpart of ``mlis_tpu/runtime/native.py`` over the port's own copy of
the C++ source (``runtime/src/mlis_runtime.cc``): the strided PointCloud2
decode, the TUM parse and the batch parses of serialized Imu and Odometry
messages. The source is host code, built on first use with ``g++ -O3 -fPIC
-std=c++17 -shared`` into ``build/mlis_tpu_torch/libmlis_runtime.so`` at the
repository root, stamped with the hash of the source and the flags, and
written to a temporary file that ``os.replace`` moves into place (parallel
processes cannot race). It is a separate build from the CUDA kernels'.

Every entry point has the JAX package's numpy fallback for a host without
a C++ compiler; :func:`native_available` says which path runs. A compiler
that is present but fails raises: only a missing toolchain falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mlis_tpu_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "src" / "mlis_runtime.cc"
LIB_NAME = "libmlis_runtime.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
BUILD_TIMEOUT_S = 120

_lib: Optional[ctypes.CDLL] = None
_tried = False


def find_cxx() -> Optional[str]:
    """The C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on PATH."""
    for c in (os.environ.get("CXX"), "g++", "c++"):
        path = c and shutil.which(c)
        if path:
            return path
    return None


def build() -> Optional[Path]:
    """Compile the library if it is missing or stale; None without a
    compiler. Raises ``RuntimeError`` with the compiler's stderr when the
    build fails."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    digest = h.hexdigest()
    if lib_path.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return lib_path
    cxx = find_cxx()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
                          stdin=subprocess.DEVNULL)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    stamp_tmp = BUILD_DIR / f"{LIB_NAME}.sha256.{os.getpid()}.tmp"
    stamp_tmp.write_text(digest + "\n")
    os.replace(stamp_tmp, stamp)
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    path = build()
    _tried = True
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))

    lib.mlis_decode_pointcloud.restype = ctypes.c_long
    lib.mlis_decode_pointcloud.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mlis_parse_tum.restype = ctypes.c_long
    lib.mlis_parse_tum.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
    ]
    for fn in (lib.mlis_parse_imu_batch, lib.mlis_parse_odometry_batch):
        fn.restype = ctypes.c_long
    lib.mlis_parse_imu_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.mlis_parse_odometry_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _lptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def decode_pointcloud(
    data: bytes,
    point_step: int,
    x_off: int = 0,
    y_off: int = 4,
    z_off: int = 8,
    ring_off: int = -1,
    ring_size: int = 2,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """PointCloud2 blob -> ((N, 3) float32 xyz, (N,) int32 ring or None)."""
    n = len(data) // point_step
    lib = _load()
    if lib is not None:
        xyz = np.empty((n, 3), np.float32)
        ring = np.empty(n, np.int32)
        got = lib.mlis_decode_pointcloud(
            data, len(data), point_step, x_off, y_off, z_off,
            ring_off, ring_size,
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ring.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        xyz = xyz[:got]
        return xyz, (ring[:got] if ring_off >= 0 else None)

    # numpy fallback: strided views over the raw buffer
    buf = np.frombuffer(data, np.uint8)[: n * point_step].reshape(n, point_step)
    xyz = np.empty((n, 3), np.float32)
    for j, off in enumerate((x_off, y_off, z_off)):
        xyz[:, j] = buf[:, off : off + 4].copy().view(np.float32)[:, 0]
    ring = None
    if ring_off >= 0:
        if ring_size == 1:
            ring = buf[:, ring_off].astype(np.int32)
        else:
            ring = (buf[:, ring_off : ring_off + 2].copy().view(np.uint16)[:, 0]).astype(np.int32)
    return xyz, ring


def parse_tum_native(path: str, max_rows: int = 2_000_000) -> Optional[np.ndarray]:
    """Native TUM parse; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((max_rows, 8), np.float64)
    got = lib.mlis_parse_tum(str(path).encode(), _dptr(out), max_rows)
    if got < 0:
        raise FileNotFoundError(path)
    return out[:got].copy()


def parse_imu_batch(blob: bytes, offsets: np.ndarray, lengths: np.ndarray):
    """Serialized Imu messages -> (stamps, accel (N,3), gyro (N,3))."""
    n = len(offsets)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    lib = _load()
    if lib is not None:
        stamps = np.empty(n, np.float64)
        accel = np.empty((n, 3), np.float64)
        gyro = np.empty((n, 3), np.float64)
        got = lib.mlis_parse_imu_batch(
            blob, _lptr(offsets), _lptr(lengths), n,
            _dptr(stamps), _dptr(accel), _dptr(gyro),
        )
        return stamps[:got], accel[:got], gyro[:got]

    stamps, accel, gyro = [], [], []
    for off, ln in zip(offsets, lengths):
        p = blob[off : off + ln]
        if len(p) < 16:
            continue
        sec, nsec, fid = struct.unpack_from("<III", p, 4)
        base = 16 + fid
        if len(p) < base + 104 + 96 + 96:
            continue
        stamps.append(sec + 1e-9 * nsec)
        gyro.append(struct.unpack_from("<3d", p, base + 104))
        accel.append(struct.unpack_from("<3d", p, base + 104 + 96))
    return (
        np.asarray(stamps),
        np.asarray(accel).reshape(-1, 3),
        np.asarray(gyro).reshape(-1, 3),
    )


def parse_odometry_batch(blob: bytes, offsets: np.ndarray, lengths: np.ndarray):
    """Serialized Odometry messages -> (N, 8) TUM rows."""
    n = len(offsets)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    lib = _load()
    if lib is not None:
        out = np.empty((n, 8), np.float64)
        got = lib.mlis_parse_odometry_batch(blob, _lptr(offsets), _lptr(lengths), n, _dptr(out))
        return out[:got].copy()

    rows = []
    for off, ln in zip(offsets, lengths):
        p = blob[off : off + ln]
        if len(p) < 16:
            continue
        sec, nsec, fid = struct.unpack_from("<III", p, 4)
        cur = 16 + fid
        (cid,) = struct.unpack_from("<I", p, cur)
        cur += 4 + cid
        if len(p) < cur + 56:
            continue
        vals = struct.unpack_from("<7d", p, cur)
        rows.append((sec + 1e-9 * nsec, *vals))
    return np.asarray(rows).reshape(-1, 8)
