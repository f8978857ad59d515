"""Trajectory error metrics: ATE, RPE, rotation error, segment analysis,
problem regions, tracking quality, smoothness and the validity gate.

Counterpart of ``mlis_tpu/eval/metrics.py``, kept as the port's own host
copy (numpy float64): the vectorised form of the reference evaluation's
per-pose loops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mlis_tpu_torch.eval.association import normalize_timestamps

# Annotated problem regions (fractions of the trajectory).
PROBLEM_REGIONS: Dict[str, Dict[str, Dict]] = {
    "5th_floor": {
        "A": {"start_pct": 0.25, "end_pct": 0.40, "type": "dynamic",
              "description": "Dynamic content (people)"},
        "B": {"start_pct": 0.55, "end_pct": 0.70, "type": "featureless",
              "description": "Featureless corridor + tight turn"},
    },
    "1st_floor": {
        "C": {"start_pct": 0.10, "end_pct": 0.30, "type": "glass",
              "description": "Glass walls, reflections"},
        "D": {"start_pct": 0.60, "end_pct": 0.80, "type": "open",
              "description": "Open atrium"},
    },
}


def cumulative_distance(positions) -> np.ndarray:
    d = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    return np.concatenate([np.zeros(1, dtype=d.dtype), np.cumsum(d)])


def _stats(errors, with_min=False) -> Dict[str, float]:
    out = {
        "rmse": float(np.sqrt(np.mean(errors**2))),
        "mean": float(np.mean(errors)),
        "median": float(np.median(errors)),
        "std": float(np.std(errors)),
        "max": float(np.max(errors)),
    }
    if with_min:
        out["min"] = float(np.min(errors))
    return out


def compute_ate(est_positions, ref_positions) -> Dict:
    """Absolute trajectory error between associated, aligned positions."""
    errors = np.linalg.norm(est_positions - ref_positions, axis=1)
    out = _stats(errors, with_min=True)
    out["errors"] = errors
    return out


def compute_rpe(positions, delta: float = 1.0) -> Optional[Dict]:
    """Relative pose error over ``delta``-meter segments.

    For each pose i, j = searchsorted(cumdist, cumdist[i] + delta); the
    error is the relative deviation of chord length from path length, in
    percent. Masking replaces the reference's early break, since cumdist
    is non-decreasing.
    """
    positions = np.asarray(positions)
    n = positions.shape[0]
    if n < 2:
        return None
    cum = cumulative_distance(positions)
    total = cum[-1]

    i_idx = np.arange(n - 1)
    target = cum[:-1] + delta
    j_idx = np.searchsorted(cum, target)
    valid = (target <= total) & (j_idx < n)

    j_safe = np.clip(j_idx, 0, n - 1)
    actual = np.linalg.norm(positions[j_safe] - positions[i_idx], axis=1)
    expected = cum[j_safe] - cum[:-1]
    valid = valid & (expected > 0)

    if not bool(np.any(valid)):
        return None
    vals = np.abs(actual - expected) / np.where(expected > 0, expected, 1.0) * 100.0
    vals = vals[valid]
    out = _stats(vals)
    out["values"] = vals
    out["indices"] = i_idx[valid]
    return out


def compute_rotation_error(est_quats, ref_quats) -> Optional[Dict]:
    """Relative rotation angle per pose pair, degrees: for unit quaternions
    the geodesic angle of R_ref^-1 R_est is 2*arccos(|<q_est, q_ref>|)."""
    est = np.asarray(est_quats, dtype=np.float64)
    ref = np.asarray(ref_quats, dtype=np.float64)
    if est.shape[0] == 0:
        return None
    est = est / np.linalg.norm(est, axis=1, keepdims=True)
    ref = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    dots = np.clip(np.abs(np.sum(est * ref, axis=1)), 0.0, 1.0)
    angles = np.degrees(2.0 * np.arccos(dots))
    out = _stats(angles)
    out["errors"] = angles
    return out


def compute_segment_metrics(est_positions, ref_positions, num_segments: int = 10) -> List[Dict]:
    """Per-segment ATE over equal index ranges."""
    n = len(est_positions)
    seg = n // num_segments
    if seg == 0:
        return []
    out = []
    for i in range(num_segments):
        start = i * seg
        end = (i + 1) * seg if i < num_segments - 1 else n
        errors = np.linalg.norm(est_positions[start:end] - ref_positions[start:end], axis=1)
        if errors.shape[0] == 0:
            continue
        out.append(
            {
                "segment": i + 1,
                "start_idx": start,
                "end_idx": end,
                "start_pct": start / n * 100,
                "end_pct": end / n * 100,
                "rmse": float(np.sqrt(np.mean(errors**2))),
                "max": float(np.max(errors)),
                "num_poses": int(end - start),
            }
        )
    return out


def compute_error_at_distances(
    est_positions,
    ref_positions,
    distances: Sequence[float] = (10, 25, 50, 100, 150),
) -> Dict[float, Optional[float]]:
    """Positional error sampled at fixed path distances."""
    cum = cumulative_distance(ref_positions)
    total = cum[-1]
    out: Dict[float, Optional[float]] = {}
    for d in distances:
        if d > total:
            out[d] = None
            continue
        idx = int(np.searchsorted(cum, d))
        if idx < len(est_positions):
            out[d] = float(np.linalg.norm(est_positions[idx] - ref_positions[idx]))
        else:
            out[d] = None
    return out


def analyze_problem_regions(
    est_positions, ref_positions, floor: str, regions=PROBLEM_REGIONS
) -> Dict[str, Dict]:
    """RMSE inside annotated problem regions against the rest."""
    if floor not in regions:
        return {}
    n = len(est_positions)
    results = {}
    for name, info in regions[floor].items():
        s = int(info["start_pct"] * n)
        e = int(info["end_pct"] * n)
        if e <= s:
            continue
        errors = np.linalg.norm(est_positions[s:e] - ref_positions[s:e], axis=1)
        other_est = np.concatenate([est_positions[:s], est_positions[e:]])
        other_ref = np.concatenate([ref_positions[:s], ref_positions[e:]])
        other = np.linalg.norm(other_est - other_ref, axis=1)
        region_rmse = float(np.sqrt(np.mean(errors**2)))
        other_rmse = float(np.sqrt(np.mean(other**2))) if other.shape[0] > 0 else 0.0
        results[name] = {
            "type": info["type"],
            "description": info["description"],
            "start_pct": info["start_pct"] * 100,
            "end_pct": info["end_pct"] * 100,
            "region_rmse": region_rmse,
            "region_max": float(np.max(errors)),
            "other_rmse": other_rmse,
            "degradation_factor": region_rmse / other_rmse if other_rmse > 0 else 0.0,
            "num_poses": int(e - s),
        }
    return results


def analyze_tracking_quality(timestamps: np.ndarray, expected_rate: float = 20.0) -> Dict:
    """Tracking continuity: gaps, pose rate, completeness."""
    t = normalize_timestamps(timestamps)
    dt = np.diff(t)
    expected_dt = 1.0 / expected_rate
    gaps = dt > 2 * expected_dt
    total_time = float(t[-1] - t[0]) if len(t) else 0.0
    return {
        "total_poses": int(len(t)),
        "total_time": total_time,
        "expected_poses": int(total_time * expected_rate),
        "pose_rate": float(len(t) / total_time) if total_time > 0 else 0.0,
        "completeness": float(len(t) / (total_time * expected_rate) * 100)
        if total_time > 0
        else 0.0,
        "num_gaps": int(gaps.sum()),
        "gap_indices": np.nonzero(gaps)[0].tolist(),
        "max_gap": float(dt.max()) if len(dt) else 0.0,
        "mean_dt": float(dt.mean()) if len(dt) else 0.0,
    }


def compute_trajectory_smoothness(positions) -> Optional[Dict]:
    """Second-difference (jerkiness) statistics."""
    if len(positions) < 3:
        return None
    acc = np.diff(positions, n=2, axis=0)
    mag = np.linalg.norm(acc, axis=1)
    mean = float(np.mean(mag))
    return {
        "mean_acceleration": mean,
        "max_acceleration": float(np.max(mag)),
        "std_acceleration": float(np.std(mag)),
        "smoothness_score": 1.0 / (1.0 + mean),
    }


def is_valid_trajectory(positions, expected_len: float, max_ratio: float = 10.0) -> Tuple[bool, str]:
    """Divergence gate: trajectories longer than max_ratio x expected or
    shorter than 0.1 x expected fail."""
    d = np.linalg.norm(np.diff(positions, axis=0), axis=1)
    length = float(np.sum(d))
    if length > expected_len * max_ratio:
        return False, f"diverged ({length:.0f}m vs {expected_len}m expected)"
    if length < expected_len * 0.1:
        return False, f"too short ({length:.1f}m vs {expected_len}m expected)"
    return True, "ok"
