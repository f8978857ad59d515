"""LZ4 frame codec for ROS bag chunks (zero-dependency).

Counterpart of ``mlis_tpu/core/lz4f.py``, kept as the port's own copy.
Real-world NUFR bags are lz4-chunked: rosbag's roslz4 writes the standard
LZ4 Frame format (magic 0x184D2204). This module implements the frame
layer directly; block (de)compression binds the system ``liblz4.so.1``
through ctypes when present (native speed on the GB-scale bag hot path)
and falls back to a pure-Python block codec otherwise (``_LIB is None``
says which path runs; without liblz4, compression writes stored blocks).

Compression writes spec-compliant frames (version 01, independent blocks,
xxh32 header checksum) readable by any LZ4 frame decoder, including
python-lz4's ``lz4.frame`` and roslz4.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import Optional

_MAGIC = 0x184D2204
_BLOCK_MAX = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}


# -- system liblz4 binding (no headers needed) ---------------------------------
def _load_liblz4() -> Optional[ctypes.CDLL]:
    for name in ("liblz4.so.1", "liblz4.so", ctypes.util.find_library("lz4")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            lib.LZ4_decompress_safe.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.LZ4_decompress_safe.restype = ctypes.c_int
            lib.LZ4_compress_default.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.LZ4_compress_default.restype = ctypes.c_int
            return lib
        except OSError:
            continue
    return None


_LIB = _load_liblz4()


# -- xxHash32 (frame header checksum; ~30 lines, spec-exact) -------------------
_P1, _P2, _P3, _P4, _P5 = (
    2654435761,
    2246822519,
    3266489917,
    668265263,
    374761393,
)
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P1) & _M32
        while i <= n - 16:
            lanes = struct.unpack_from("<IIII", data, i)
            v1 = (_rotl((v1 + lanes[0] * _P2) & _M32, 13) * _P1) & _M32
            v2 = (_rotl((v2 + lanes[1] * _P2) & _M32, 13) * _P1) & _M32
            v3 = (_rotl((v3 + lanes[2] * _P2) & _M32, 13) * _P1) & _M32
            v4 = (_rotl((v4 + lanes[3] * _P2) & _M32, 13) * _P1) & _M32
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i <= n - 4:
        (k,) = struct.unpack_from("<I", data, i)
        h = (_rotl((h + k * _P3) & _M32, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M32, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


# -- LZ4 block codec ------------------------------------------------------------
def block_decompress(src: bytes, max_size: int) -> bytes:
    if _LIB is not None:
        dst = ctypes.create_string_buffer(max_size)
        n = _LIB.LZ4_decompress_safe(src, dst, len(src), max_size)
        if n < 0:
            raise ValueError(f"corrupt LZ4 block (code {n})")
        return dst.raw[:n]
    return _py_block_decompress(src, max_size)


def block_compress(src: bytes) -> Optional[bytes]:
    """Compressed block, or None when liblz4 is unavailable (caller should
    emit a stored block — still a valid frame)."""
    if _LIB is None or len(src) == 0:
        return None
    bound = len(src) + len(src) // 255 + 16
    dst = ctypes.create_string_buffer(bound)
    n = _LIB.LZ4_compress_default(src, dst, len(src), bound)
    if n <= 0:
        return None
    return dst.raw[:n]


def _py_block_decompress(src: bytes, max_size: int) -> bytes:
    """Pure-Python LZ4 block decoder (spec: token | literals | offset+match)."""
    dst = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            # a token declaring more literals than remain is corruption —
            # match liblz4's error behavior, never silently truncate
            raise ValueError("corrupt LZ4 block: literal run past input end")
        dst += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence carries literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero offset")
        mlen = token & 15
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(dst) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: offset before start")
        for j in range(mlen):  # byte-wise: matches may overlap the output
            dst.append(dst[start + j])
        if len(dst) > max_size:
            raise ValueError("LZ4 block exceeds declared size")
    return bytes(dst)


# -- LZ4 frame codec --------------------------------------------------------------
def decompress(buf: bytes, verify_checksums: bool = False) -> bytes:
    """Decode one LZ4 frame (optionally followed by trailing garbage)."""
    if len(buf) < 7:
        raise ValueError("LZ4 frame too short")
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"bad LZ4 frame magic 0x{magic:08x}")
    i = 4
    flg, bd = buf[i], buf[i + 1]
    if (flg >> 6) & 3 != 1:
        raise ValueError("unsupported LZ4 frame version")
    b_checksum = bool(flg & 0x10)
    c_size = bool(flg & 0x08)
    c_checksum = bool(flg & 0x04)
    dict_id = bool(flg & 0x01)
    bmax_id = (bd >> 4) & 7
    if bmax_id not in _BLOCK_MAX:
        raise ValueError(f"bad LZ4 block max size id {bmax_id}")
    bmax = _BLOCK_MAX[bmax_id]
    desc_start = i
    i += 2
    if c_size:
        i += 8
    if dict_id:
        i += 4
    hc = buf[i]
    if verify_checksums:
        want = (xxh32(buf[desc_start:i]) >> 8) & 0xFF
        if hc != want:
            raise ValueError("LZ4 frame header checksum mismatch")
    i += 1

    out = bytearray()
    while True:
        (bsize,) = struct.unpack_from("<I", buf, i)
        i += 4
        if bsize == 0:  # EndMark
            break
        stored = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        block = buf[i : i + bsize]
        i += bsize
        if b_checksum:
            if verify_checksums:
                (want,) = struct.unpack_from("<I", buf, i)
                if xxh32(block) != want:
                    raise ValueError("LZ4 block checksum mismatch")
            i += 4
        out += block if stored else block_decompress(block, bmax)
    if c_checksum and verify_checksums:
        (want,) = struct.unpack_from("<I", buf, i)
        if xxh32(bytes(out)) != want:
            raise ValueError("LZ4 content checksum mismatch")
    return bytes(out)


def compress(data: bytes, block_size_id: int = 7) -> bytes:
    """Encode one LZ4 frame (independent blocks, header checksum, no
    content/block checksums — matching roslz4's defaults)."""
    if block_size_id not in _BLOCK_MAX:
        raise ValueError(f"bad block size id {block_size_id}")
    bmax = _BLOCK_MAX[block_size_id]
    flg = 0x60  # version 01 | block independence
    bd = block_size_id << 4
    desc = bytes([flg, bd])
    hc = (xxh32(desc) >> 8) & 0xFF
    parts = [struct.pack("<I", _MAGIC), desc, bytes([hc])]
    for s in range(0, len(data), bmax):
        raw = data[s : s + bmax]
        comp = block_compress(raw)
        if comp is not None and len(comp) < len(raw):
            parts.append(struct.pack("<I", len(comp)))
            parts.append(comp)
        else:  # stored block (high bit set)
            parts.append(struct.pack("<I", len(raw) | 0x80000000))
            parts.append(raw)
    parts.append(struct.pack("<I", 0))  # EndMark
    return b"".join(parts)
