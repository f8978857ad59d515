"""LiDAR ground-plane floor tracking: batched RANSAC over scans on tensors.

Counterpart of ``mlis_tpu/gating/lidar_floor_tracker.py``:
  * ground candidates: Ouster ring < 30, else z below the 5th percentile
    + 0.5 m;
  * RANSAC: 3-point plane hypotheses by cross product, inlier threshold
    0.1 m, the plane with the most inliers wins (ties to the lower
    hypothesis, as ``jnp.argmax``);
  * robot height = the plane's d once its normal points up;
  * the mean of the last ``smoothing_window`` valid heights; floor =
    round((smoothed_z - reference_z) / floor_height), half to even;
  * confidence = inlier_ratio / (1 + 10 * var(window));
  * transitions = floor changes spaced >= min_duration;
  * per-pose labels by the nearest scan time.

All hypotheses of all scans are drawn up front, from an explicit
``torch.Generator`` on the scans' device or from the caller's
``uniforms``. Inliers are counted in blocks of scans, so that no
(scans, hypotheses, points) tensor of more than ``RANSAC_BLOCK_ELEMENTS``
values exists; each scan's draws are its own, so the blocks change no
result. The point-to-plane distance is elementwise float32 arithmetic,
never a matmul, so TF32 settings cannot change an inlier count. The
sequential smoothing of the JAX package (a ``lax.scan`` over scans) is
one vectorised pass: the valid heights compacted, a trailing window over
them, and invalid scans forward-filled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from mlis_tpu_torch.eval.association import nearest_indices

RANSAC_BLOCK_ELEMENTS = 1 << 27  # scans x hypotheses x points per inlier-count block


@dataclass
class FloorEstimate:
    """Per-scan floor estimate."""

    timestamp: float
    z_height: float
    floor_number: int
    confidence: float
    num_ground_points: int


def extract_ground_mask(
    points: torch.Tensor,  # (..., P, 3)
    rings: Optional[torch.Tensor],  # (..., P) or None
    valid: Optional[torch.Tensor] = None,  # (..., P) bool; masks padding
    ground_ring_threshold: int = 30,
) -> torch.Tensor:
    """Ground-candidate mask over the last axis (one scan, or a batch)."""
    if rings is not None:
        mask = rings < ground_ring_threshold
    else:
        z = points[..., 2]
        if valid is not None:
            # the 5th-percentile sample of the valid points, by rank
            n_valid = valid.sum(-1, keepdim=True).clamp(min=1)
            z_sorted = torch.sort(torch.where(valid, z, float("inf")), dim=-1).values
            k = (0.05 * (n_valid - 1)).to(torch.int64).clamp(0, z.shape[-1] - 1)
            z_min = torch.gather(z_sorted, -1, k)
        else:
            z_min = torch.quantile(z, 0.05, dim=-1, keepdim=True)
        mask = z < z_min + 0.5
    if valid is not None:
        mask = mask & valid
    return mask


def _row_counts(mask: torch.Tensor) -> torch.Tensor:
    """True values per row of a (S, P) bool tensor, in blocks of rows: a
    bool sum first copies its input to int64 (3.1 GB for a 3,000-scan bag)."""
    step = max(1, RANSAC_BLOCK_ELEMENTS // (8 * max(mask.shape[1], 1)))
    return torch.cat([m.sum(1) for m in mask.split(step)])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, one rounded product per term on every
    device (no fused multiply-add)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _fit_block(points, ground_mask, u, threshold: float):
    """RANSAC over one block of scans: (planes (B, 4), ratio (B,))."""
    B, P, _ = points.shape
    H = u.shape[1]
    n_valid = ground_mask.sum(1)  # (B,)
    # 3 draws per hypothesis, uniform over the scan's ground points: the
    # draw-th ground point in index order (JAX: argsort(~mask, stable))
    draw = (u * n_valid.clamp(min=1)[:, None, None].to(torch.float32)).to(torch.int32)
    draw = torch.minimum(draw, (n_valid - 1).clamp(min=0)[:, None, None].to(torch.int32))
    running = ground_mask.cumsum(1, dtype=torch.int32)
    idx = torch.searchsorted(running, (draw + 1).reshape(B, H * 3))
    idx = torch.where(n_valid[:, None] > 0, idx, 0)  # no ground point: index 0

    tri = torch.gather(points, 1, idx[..., None].expand(B, H * 3, 3)).reshape(B, H, 3, 3)
    p0 = tri[:, :, 0]
    normal = _cross(tri[:, :, 1] - p0, tri[:, :, 2] - p0)  # (B, H, 3)
    nx, ny, nz = normal.unbind(-1)
    norm_len = (nx * nx + ny * ny + nz * nz).sqrt()
    degenerate = norm_len < 1e-6
    normal = normal / norm_len.clamp(min=1e-12)[..., None]
    nx, ny, nz = normal.unbind(-1)
    d = -(nx * p0[..., 0] + ny * p0[..., 1] + nz * p0[..., 2])  # (B, H)

    # inliers: |n . p + d| < threshold over ground points, elementwise and
    # in place: the indicator is left in the float32 distances and summed
    # there (exact below 2**24), where a bool sum would first copy to int64
    x, y, z = (c[:, None, :] for c in points.permute(2, 0, 1).contiguous())  # (B, 1, P)
    dist = nx[..., None] * x
    dist.addcmul_(ny[..., None], y).addcmul_(nz[..., None], z).add_(d[..., None]).abs_()
    dist.lt_(threshold).mul_(ground_mask[:, None, :])
    counts = dist.sum(-1).to(torch.int64)  # (B, H)
    counts = torch.where(degenerate, -1, counts)

    best = torch.argmax(counts, dim=1)  # first maximum
    pick = best[:, None]
    best_counts = torch.gather(counts, 1, pick)[:, 0]
    best_normal = torch.gather(normal, 1, pick[..., None].expand(B, 1, 3))[:, 0]
    best_d = torch.gather(d, 1, pick)[:, 0]
    planes = torch.cat([best_normal, best_d[:, None]], 1)
    ratio = best_counts / n_valid.clamp(min=1)
    ratio = torch.where(n_valid > 0, ratio, 0.0)
    return planes, ratio


def fit_plane_ransac_batch(
    points: torch.Tensor,  # (S, P, 3) float32 padded scans
    ground_mask: torch.Tensor,  # (S, P) bool
    generator: Optional[torch.Generator] = None,
    iterations: int = 128,
    threshold: float = 0.1,
    uniforms: Optional[torch.Tensor] = None,  # (S, iterations, 3) in [0, 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched RANSAC ground-plane fit over S scans.

    Returns (planes (S, 4) [nx, ny, nz, d] with a unit normal, inlier_ratio
    (S,)). The draws are ``uniforms`` when given (e.g. the JAX package's
    ``jax.random.uniform(key, (S, H, 3))``), else drawn from ``generator``
    on the points' device."""
    S, P, _ = points.shape
    dev = points.device
    if uniforms is None:
        uniforms = torch.rand((S, iterations, 3), generator=generator, device=dev)
    else:
        uniforms = torch.as_tensor(uniforms, device=dev).to(torch.float32)
    block = max(1, RANSAC_BLOCK_ELEMENTS // (uniforms.shape[1] * max(P, 1)))
    out = [
        _fit_block(points[s : s + block], ground_mask[s : s + block],
                   uniforms[s : s + block], threshold)
        for s in range(0, S, block)
    ]
    return torch.cat([p for p, _ in out]), torch.cat([r for _, r in out])


def robot_height_from_plane(planes: torch.Tensor) -> torch.Tensor:
    """Signed robot height above the fitted plane: the plane turned so its
    normal points up (n_z >= 0), then its d. A 3-point hypothesis has a
    random normal orientation, so this is canonicalised as in the JAX
    package."""
    flip = planes[:, 2] < 0
    return torch.where(flip, -planes[:, 3], planes[:, 3])


def smooth_and_label(
    z: torch.Tensor,  # (S,) float32 raw heights
    valid: torch.Tensor,  # (S,) bool: scans with enough ground points
    floor_height: float,
    window: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal trailing-window mean / variance over valid scans + floor index.

    The JAX package's sequential scan in one pass: valid scan k (in order)
    averages the valid heights k-window+1 .. k; invalid scans carry the
    last valid scan's values (zero height, floor 0 and stability 1 before
    the first). The reference height is the first valid one. Returns
    (smoothed_z, floor_number int32, stability) per scan."""
    S = z.shape[0]
    dev = z.device
    order = torch.argsort((~valid).to(torch.uint8), stable=True)  # valid scans first
    zc = z[order]
    k = torch.arange(S, device=dev)
    count = (k + 1).clamp(max=window)
    buf = torch.cat([zc.new_zeros(window - 1), zc]).unfold(0, window, 1)  # (S, window)
    slots = torch.arange(window, device=dev)[None, :] >= (window - count)[:, None]
    mean = torch.where(slots, buf, 0.0).sum(1) / count
    var = torch.where(slots, (buf - mean[:, None]) ** 2, 0.0).sum(1) / count
    floor_c = torch.round((mean - zc[0]) / floor_height).to(torch.int32)
    stab_c = 1.0 / (1.0 + var * 10.0)

    j = valid.cumsum(0) - 1  # the last valid scan at or before each scan
    seen = j >= 0
    jc = j.clamp(min=0)
    smoothed = torch.where(seen, mean[jc], 0.0)
    floors = torch.where(seen, floor_c[jc], 0)
    stability = torch.where(seen, stab_c[jc], 1.0)
    return smoothed, floors, stability


class LiDARFloorTracker:
    """Stateful per-scan API and the batched path over whole bags."""

    def __init__(
        self,
        floor_height: float = 3.5,
        ground_ring_threshold: int = 30,
        ransac_iterations: int = 128,
        ransac_threshold: float = 0.1,
        min_ground_points: int = 100,
        smoothing_window: int = 10,
        seed: int = 0,
        device="cuda",
    ):
        self.floor_height = floor_height
        self.ground_ring_threshold = ground_ring_threshold
        self.ransac_iterations = ransac_iterations
        self.ransac_threshold = ransac_threshold
        self.min_ground_points = min_ground_points
        self.smoothing_window = smoothing_window
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.z_history: List[float] = []
        self.floor_history: List[FloorEstimate] = []
        self.current_floor: int = 0
        self.reference_z: Optional[float] = None

    def _ground_mask(self, points, rings, valid) -> torch.Tensor:
        if rings is not None:
            mask = torch.as_tensor(rings, device=self.device) < self.ground_ring_threshold
            return mask & valid
        # the percentile by sort, in blocks of scans: a sort holds values
        # and int64 indices, so a block stays near 100 MB
        S, P = valid.shape
        block = max(1, RANSAC_BLOCK_ELEMENTS // (16 * max(P, 1)))
        return torch.cat([
            extract_ground_mask(points[s : s + block], None, valid[s : s + block],
                                self.ground_ring_threshold)
            for s in range(0, S, block)
        ])

    # -- batched path --------------------------------------------------------
    def process_scans(
        self,
        scans,  # (S, P, 3) padded point clouds (array or tensor)
        timestamps,  # (S,)
        rings=None,  # (S, P) or None
        point_valid=None,  # (S, P) padding mask
        uniforms=None,  # (S, ransac_iterations, 3) draws, else the tracker's generator
    ) -> List[FloorEstimate]:
        """Process a whole bag of scans on the tracker's device."""
        pts = torch.as_tensor(scans, device=self.device).to(torch.float32)
        S, P, _ = pts.shape
        valid = (torch.as_tensor(point_valid, device=self.device).to(torch.bool)
                 if point_valid is not None
                 else torch.ones((S, P), dtype=torch.bool, device=self.device))
        gmask = self._ground_mask(pts, rings, valid)
        planes, ratios = fit_plane_ransac_batch(
            pts, gmask, self.generator, self.ransac_iterations, self.ransac_threshold,
            uniforms=uniforms,
        )
        heights = robot_height_from_plane(planes)
        n_ground = _row_counts(gmask)
        scan_ok = n_ground >= self.min_ground_points
        smoothed, floors, stability = smooth_and_label(
            heights, scan_ok, self.floor_height, self.smoothing_window)
        conf = torch.where(scan_ok, ratios * stability, 0.0)

        # one device-to-host copy
        table = torch.stack([smoothed.to(torch.float64), floors.to(torch.float64),
                             conf.to(torch.float64), n_ground.to(torch.float64),
                             scan_ok.to(torch.float64)]).cpu().numpy()
        estimates = []
        for i in range(S):
            est = FloorEstimate(
                timestamp=float(timestamps[i]),
                z_height=float(table[0, i]),
                floor_number=int(table[1, i]),
                confidence=float(table[2, i]),
                num_ground_points=int(table[3, i]),
            )
            estimates.append(est)
            # low-confidence scans are returned but not recorded, as in the
            # per-scan API: labels and transitions see plane-backed scans only
            if table[4, i]:
                self.floor_history.append(est)
        if estimates:
            self.current_floor = estimates[-1].floor_number
        return estimates

    # -- per-scan API ---------------------------------------------------------
    def process_scan(self, points, timestamp: float, rings=None) -> FloorEstimate:
        pts = torch.as_tensor(points, device=self.device).to(torch.float32)[None]
        valid = torch.ones((1, pts.shape[1]), dtype=torch.bool, device=self.device)
        if rings is not None:
            gmask = (torch.as_tensor(rings, device=self.device)[None]
                     < self.ground_ring_threshold) & valid
        else:
            gmask = extract_ground_mask(pts, None, valid)

        n_ground = int(gmask.sum())
        if n_ground < self.min_ground_points:
            return FloorEstimate(
                timestamp=timestamp,
                z_height=self.z_history[-1] if self.z_history else 0.0,
                floor_number=self.current_floor,
                confidence=0.0,
                num_ground_points=n_ground,
            )

        planes, ratios = fit_plane_ransac_batch(
            pts, gmask, self.generator, self.ransac_iterations, self.ransac_threshold)
        z_height = float(robot_height_from_plane(planes)[0])
        self.z_history.append(z_height)
        self.z_history = self.z_history[-self.smoothing_window :]
        if self.reference_z is None:
            self.reference_z = z_height

        smoothed_z = float(np.mean(self.z_history))
        floor_number = int(round((smoothed_z - self.reference_z) / self.floor_height))
        z_var = float(np.var(self.z_history)) if len(self.z_history) > 1 else 1.0
        confidence = float(ratios[0]) * (1.0 / (1.0 + z_var * 10.0))
        self.current_floor = floor_number

        est = FloorEstimate(
            timestamp=timestamp,
            z_height=smoothed_z,
            floor_number=floor_number,
            confidence=confidence,
            num_ground_points=n_ground,
        )
        self.floor_history.append(est)
        return est

    def detect_floor_transitions(self, min_duration: float = 2.0) -> List[Tuple[float, int, int]]:
        """Floor changes spaced >= min_duration."""
        if len(self.floor_history) < 2:
            return []
        transitions = []
        last_floor = self.floor_history[0].floor_number
        last_t = self.floor_history[0].timestamp
        for est in self.floor_history[1:]:
            if est.floor_number != last_floor:
                if est.timestamp - last_t >= min_duration:
                    transitions.append((est.timestamp, last_floor, est.floor_number))
                    last_t = est.timestamp
                last_floor = est.floor_number
        return transitions

    def get_floor_labels(self, timestamps) -> np.ndarray:
        """Nearest-scan floor label per pose."""
        if not self.floor_history:
            return np.zeros(len(timestamps), dtype=int)
        scan_t = np.asarray([e.timestamp for e in self.floor_history])
        scan_f = np.asarray([e.floor_number for e in self.floor_history])
        order = np.argsort(scan_t, kind="stable")
        j = nearest_indices(np.asarray(timestamps, np.float64), scan_t[order])
        return scan_f[order][j]

    def reset(self) -> None:
        self.z_history.clear()
        self.floor_history.clear()
        self.current_floor = 0
        self.reference_z = None
