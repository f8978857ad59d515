"""Exact all-pairs proximity sweep for loop-closure candidate generation.

Counterpart of ``mlis_tpu/ops/pairwise.py``. A pair (i, j) is a
loop-closure candidate iff

    j - i >= min_gap   and   ||p_i - p_j||_2 <= radius

and it is cross-floor iff floor[i] != floor[j]. The counts must equal the
reference's float64 sweep exactly.

The pair space is cut into 512x512 (ti, tj) tiles; only tiles whose largest
column index reaches ``min_gap`` past their smallest row index are listed
(:func:`tile_list`, built exactly as the JAX ``candidate_counts`` builds
it). :func:`tri_count` counts the listed tiles: on a CUDA tensor it launches
the hand-written kernel ``csrc/pairwise.cu`` (which replaces the TPU kernels
``_tri_count_kernel`` and ``_count_kernel``), on a CPU tensor it runs
:func:`tri_count_plain`, the same float64 arithmetic as tiled torch code.
The kernel cuts each listed tile into ``2**log_split`` blocks
(:func:`sweep_split` picks the cut from the tile count and the card's SM
count; :func:`split_blocks` spells the cut out).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

TILE = 512
_COL_CHUNK = 8 * TILE  # columns per step of the plain version
MAX_LOG_SPLIT = 8  # the kernel cuts a tile into at most 256 blocks of 32 x 32
# the automatic cut: blocks of at most 256 x 128 (8 a tile), then enough
# blocks for every SM to get 8, in at most 64 blocks of 64 x 64 a tile
MIN_AUTO_LOG_SPLIT = 3
BLOCKS_PER_SM = 8
MAX_AUTO_LOG_SPLIT = 6


def tile_list(n: int, min_gap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-triangle (ti, tj) tile list, int32, in the JAX package's order:
    a tile is kept iff its largest column index reaches ``min_gap`` past
    its smallest row index."""
    n_t = -(-n // TILE)
    ti, tj = np.meshgrid(np.arange(n_t), np.arange(n_t), indexing="ij")
    keep = (tj + 1) * TILE - 1 >= ti * TILE + min_gap
    return (
        np.ascontiguousarray(ti[keep], np.int32),
        np.ascontiguousarray(tj[keep], np.int32),
    )


def all_tiles(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every (ti, tj) tile of the full grid: the launch of the JAX package's
    full-grid kernel ``_count_kernel``, which the same CUDA kernel covers."""
    n_t = -(-n // TILE)
    ti, tj = np.meshgrid(np.arange(n_t), np.arange(n_t), indexing="ij")
    return (
        np.ascontiguousarray(ti.ravel(), np.int32),
        np.ascontiguousarray(tj.ravel(), np.int32),
    )


def sweep_split(n_tiles: int, sms: int) -> int:
    """log2 of the blocks the kernel cuts each listed tile into: the least
    power of two from ``2**MIN_AUTO_LOG_SPLIT`` that gives the grid
    ``BLOCKS_PER_SM`` blocks for every SM, at most ``2**MAX_AUTO_LOG_SPLIT``.
    Small blocks keep the last wave short at large n; many keep every SM
    busy at small n (timed on an H100 by tools/sweep_ab.py)."""
    want = BLOCKS_PER_SM * int(sms)
    log_split = MIN_AUTO_LOG_SPLIT
    while log_split < MAX_AUTO_LOG_SPLIT and (int(n_tiles) << log_split) < want:
        log_split += 1
    return log_split


def split_blocks(tile_i, tile_j, n: int, min_gap: int, log_split: int) -> np.ndarray:
    """The kernel's cut, block by block in launch order: (B, 4) int64 rows
    ``(i_lo, i_hi, j_lo, j_hi)`` of the half-open pose ranges each block
    pairs, cut at n, without the blocks that leave at once (no pair with
    j - i >= min_gap). Tile t's block p is row strip p >> log_cs of
    ``2**log_rs`` and column strip p & (2**log_cs - 1), with
    log_rs = log_split // 2 and log_cs = log_split - log_rs."""
    parts = 1 << log_split
    ti = np.repeat(np.asarray(tile_i, np.int64), parts)
    tj = np.repeat(np.asarray(tile_j, np.int64), parts)
    part = np.tile(np.arange(parts, dtype=np.int64), len(np.asarray(tile_i)))
    log_rs = log_split >> 1
    log_cs = log_split - log_rs
    rows, cols = TILE >> log_rs, TILE >> log_cs
    i0 = ti * TILE + (part >> log_cs) * rows
    j0 = tj * TILE + (part & ((1 << log_cs) - 1)) * cols
    n_cols = np.minimum(cols, n - j0)
    keep = (i0 < n) & (n_cols > 0) & (j0 + n_cols - 1 - i0 >= min_gap)
    return np.stack([i0, np.minimum(i0 + rows, n), j0, j0 + n_cols], axis=1)[keep]


def index_valid_pairs(n: int, min_gap: int) -> int:
    """Number of pairs with j - i >= min_gap and i, j < n: the pairs whose
    distance the sweep must compute."""
    d = np.arange(max(min_gap, 1 - n), n, dtype=np.int64)  # d = j - i
    return int((n - np.abs(d)).sum())


def tri_count_plain(
    pos: torch.Tensor,  # (n, 3) float64
    floors: torch.Tensor,  # (n,) int32
    tile_i: torch.Tensor,  # (T,) int32
    tile_j: torch.Tensor,  # (T,) int32
    min_gap: int,
    r2: float,
) -> Tuple[int, int]:
    """Plain torch version of the kernel on any device: (total, same_floor)
    over the listed tiles, d2 = dx*dx + dy*dy + dz*dz in float64."""
    n = pos.shape[0]
    dev = pos.device
    total = torch.zeros((), dtype=torch.int64, device=dev)
    same = torch.zeros((), dtype=torch.int64, device=dev)
    ti_np = tile_i.cpu().numpy()
    tj_np = tile_j.cpu().numpy()
    for ti in np.unique(ti_np):
        i0, i1 = int(ti) * TILE, min((int(ti) + 1) * TILE, n)
        if i0 >= n:
            continue
        cols = [
            torch.arange(int(t) * TILE, min((int(t) + 1) * TILE, n), device=dev)
            for t in np.sort(tj_np[ti_np == ti])
            if int(t) * TILE < n
        ]
        if not cols:
            continue
        js = torch.cat(cols)
        ii = torch.arange(i0, i1, device=dev)
        pi, fi = pos[i0:i1], floors[i0:i1]
        for c0 in range(0, js.numel(), _COL_CHUNK):
            jj = js[c0 : c0 + _COL_CHUNK]
            pj = pos[jj]
            dx = pi[:, None, 0] - pj[None, :, 0]
            dy = pi[:, None, 1] - pj[None, :, 1]
            dz = pi[:, None, 2] - pj[None, :, 2]
            d2 = dx * dx + dy * dy + dz * dz
            ok = (jj[None, :] - ii[:, None] >= min_gap) & (d2 <= r2)
            total += ok.sum()
            same += (ok & (fi[:, None] == floors[jj][None, :])).sum()
    return int(total), int(same)


def _check_inputs(pos, floors, tile_i, tile_j) -> None:
    if pos.dtype != torch.float64 or pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions must be (n, 3) float64, got {tuple(pos.shape)} {pos.dtype}")
    if floors.dtype != torch.int32 or floors.shape != (pos.shape[0],):
        raise ValueError(f"floors must be (n,) int32, got {tuple(floors.shape)} {floors.dtype}")
    for t in (tile_i, tile_j):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != tile_i.shape:
            raise ValueError("tile lists must be equal-length 1-D int32 tensors")
    for name, t in (("positions", pos), ("floors", floors), ("tile_i", tile_i), ("tile_j", tile_j)):
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, positions on {pos.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pos.shape[0] >= 2**31 - 2 * TILE:
        raise ValueError("the kernel indexes poses with int32")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_tri_count(pos, floors, tile_i, tile_j, min_gap: int, r2: float,
                      log_split=None) -> Tuple[int, int]:
    """One launch with ``2**log_split`` blocks a tile (default
    :func:`sweep_split`; the kernel takes 0 to ``MAX_LOG_SPLIT``)."""
    from mlis_tpu_torch import _build

    lib = _build.library()
    if log_split is None:
        log_split = sweep_split(tile_i.numel(), sm_count(pos.device))
    out = torch.zeros(2, dtype=torch.int64, device=pos.device)
    status = lib.mlis_tri_count(
        ctypes.c_void_p(pos.data_ptr()),
        ctypes.c_void_p(floors.data_ptr()),
        ctypes.c_void_p(tile_i.data_ptr()),
        ctypes.c_void_p(tile_j.data_ptr()),
        ctypes.c_int(int(tile_i.numel())),
        ctypes.c_int(int(pos.shape[0])),
        ctypes.c_int(int(min_gap)),
        ctypes.c_double(float(r2)),
        ctypes.c_int(int(log_split)),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(pos.device).cuda_stream),
    )
    _build.check(status, "tri_count")
    tri_count.launches += 1
    total, same = out.tolist()
    return int(total), int(same)


def tri_count(
    pos: torch.Tensor,
    floors: torch.Tensor,
    tile_i: torch.Tensor,
    tile_j: torch.Tensor,
    min_gap: int,
    r2: float,
) -> Tuple[int, int]:
    """(total, same_floor) over the listed tiles. CUDA tensors launch the
    kernel, each tile cut into ``2**sweep_split(...)`` blocks
    (``tri_count.launches`` counts the launches); CPU tensors run
    :func:`tri_count_plain`."""
    _check_inputs(pos, floors, tile_i, tile_j)
    if pos.device.type == "cuda":
        return _launch_tri_count(pos, floors, tile_i, tile_j, min_gap, r2)
    if pos.device.type == "cpu":
        return tri_count_plain(pos, floors, tile_i, tile_j, min_gap, r2)
    raise ValueError(f"tri_count has no path for device {pos.device}")


tri_count.launches = 0


def pack_sweep_inputs(positions, floors, min_gap: int, device) -> tuple:
    """(pos f64 (n,3), floors int32 (n,), tile_i, tile_j) on ``device``."""
    device = torch.device(device)
    pos = torch.as_tensor(np.asarray(positions, dtype=np.float64), device=device)
    fl = torch.as_tensor(np.asarray(floors).astype(np.int32), device=device)
    ti, tj = tile_list(pos.shape[0], min_gap)
    return (
        pos.contiguous(),
        fl.contiguous(),
        torch.as_tensor(ti, device=device),
        torch.as_tensor(tj, device=device),
    )


def candidate_counts(
    positions,
    floors,
    radius: float = 2.0,
    min_gap: int = 100,
    device="cuda",
) -> Tuple[int, int, int]:
    """Count loop-closure candidates and their floor split:
    (total, same_floor, cross_floor), equal to the float64 sweep."""
    n = len(positions)
    if n == 0:
        return 0, 0, 0
    pos, fl, ti, tj = pack_sweep_inputs(positions, floors, min_gap, device)
    r2 = float(radius) * float(radius)
    total, same = tri_count(pos, fl, ti, tj, min_gap, r2)
    return total, same, total - same


def candidate_counts_host(
    positions: np.ndarray,
    floors: np.ndarray,
    radius: float = 2.0,
    min_gap: int = 100,
    tile: int = 2048,
) -> Tuple[int, int, int]:
    """Host float64 sweep over row/column blocks (numpy): ground truth."""
    positions = np.asarray(positions, dtype=np.float64)
    floors = np.asarray(floors)
    n = positions.shape[0]
    total = same = 0
    r2 = radius * radius
    for i0 in range(0, n, tile):
        i1 = min(i0 + tile, n)
        for j0 in range(max(i0 + min_gap, 0), n, tile):
            j1 = min(j0 + tile, n)
            d2 = ((positions[i0:i1, None, :] - positions[None, j0:j1, :]) ** 2).sum(-1)
            ii = np.arange(i0, i1)[:, None]
            jj = np.arange(j0, j1)[None, :]
            ok = (jj - ii >= min_gap) & (d2 <= r2)
            total += int(ok.sum())
            same += int((ok & (floors[i0:i1, None] == floors[None, j0:j1])).sum())
    return total, same, total - same


def candidate_pairs_host(
    positions: np.ndarray,
    floors: np.ndarray,
    radius: float = 2.0,
    min_gap: int = 100,
    tile: int = 2048,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Materialise the candidate pairs (i, j, dist) on the host, float64."""
    positions = np.asarray(positions, dtype=np.float64)
    n = positions.shape[0]
    r2 = radius * radius
    out_i, out_j, out_d = [], [], []
    for i0 in range(0, n, tile):
        i1 = min(i0 + tile, n)
        for j0 in range(i0 + min_gap, n, tile):
            j1 = min(j0 + tile, n)
            d2 = ((positions[i0:i1, None, :] - positions[None, j0:j1, :]) ** 2).sum(-1)
            ii = np.arange(i0, i1)[:, None]
            jj = np.arange(j0, j1)[None, :]
            w = np.nonzero((jj - ii >= min_gap) & (d2 <= r2))
            out_i.append(w[0] + i0)
            out_j.append(w[1] + j0)
            out_d.append(np.sqrt(d2[w]))
    if not out_i:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z
    return np.concatenate(out_i), np.concatenate(out_j), np.concatenate(out_d)
