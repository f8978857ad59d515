"""TUM-format trajectory IO and multi-sequence combination.

Counterpart of ``mlis_tpu/core/trajectory.py``, kept as the port's own
copy. Host-side numpy float64 end to end: timestamps at nanosecond scale
do not survive float32. Device code downstream converts positions as it
needs them.

  - TUM line format: ``timestamp tx ty tz qx qy qz qw``.
  - Multi-floor combination: a plain vstack of the per-sequence files in
    dataset order, each floor sequence with its constant floor label;
    transit sequences get ``linspace(start, end, n).round()`` labels.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Trajectory:
    """A TUM trajectory: N poses of (t, position, quaternion xyzw)."""

    timestamps: np.ndarray  # (N,) float64 seconds
    positions: np.ndarray  # (N, 3) float64
    quaternions: np.ndarray  # (N, 4) float64, xyzw

    def __len__(self) -> int:
        return int(self.timestamps.shape[0])

    @property
    def duration(self) -> float:
        return float(self.timestamps[-1] - self.timestamps[0]) if len(self) else 0.0

    def as_matrix(self) -> np.ndarray:
        """(N, 8) TUM matrix [t, tx, ty, tz, qx, qy, qz, qw]."""
        return np.hstack([self.timestamps[:, None], self.positions, self.quaternions])

    @classmethod
    def from_matrix(cls, m: np.ndarray) -> "Trajectory":
        m = np.atleast_2d(np.asarray(m, dtype=np.float64))
        if m.shape[1] < 8:
            raise ValueError(f"TUM matrix needs 8 columns, got {m.shape[1]}")
        return cls(m[:, 0], m[:, 1:4], m[:, 4:8])


def load_tum(path: str | Path) -> Trajectory:
    """Load a TUM trajectory file. Skips '#' comments and blank lines."""
    rows: List[List[float]] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            rows.append([float(x) for x in parts[:8]])
    if not rows:
        raise ValueError(f"No poses parsed from {path}")
    return Trajectory.from_matrix(np.asarray(rows, dtype=np.float64))


def save_tum(traj: Trajectory, path: str | Path) -> None:
    m = traj.as_matrix()
    with open(path, "w") as f:
        for row in m:
            f.write(f"{row[0]:.6f} " + " ".join(f"{v:.9f}" for v in row[1:]) + "\n")


def trajectory_length(positions: np.ndarray) -> float:
    """Cumulative path length: sum of consecutive-pose distances."""
    if len(positions) < 2:
        return 0.0
    return float(np.linalg.norm(np.diff(positions, axis=0), axis=1).sum())


def endpoint_drift(positions: np.ndarray) -> float:
    """Start-to-end closure error (loop-closure-free drift)."""
    if len(positions) < 2:
        return 0.0
    return float(np.linalg.norm(positions[-1] - positions[0]))


def combine_sequences(
    sequences: Sequence[Tuple[str, Optional[int], Trajectory]],
    transit_floors: Optional[Dict[str, Tuple[int, int]]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate per-sequence trajectories into one multi-floor trajectory.

    Args:
        sequences: ordered (name, floor_or_None, Trajectory). floor=None marks
            a transit sequence, whose floors are looked up in transit_floors.
        transit_floors: name -> (start_floor, end_floor) for transit sequences.

    Returns:
        (tum_matrix (N,8) float64, floor_labels (N,) int32)
    """
    transit_floors = transit_floors or {}
    mats: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    for name, floor, traj in sequences:
        n = len(traj)
        if n == 0:
            continue
        mats.append(traj.as_matrix())
        if floor is None:
            if name not in transit_floors:
                raise KeyError(f"transit sequence {name!r} missing floor mapping")
            a, b = transit_floors[name]
            labels.append(np.linspace(a, b, n).round().astype(np.int32))
        else:
            labels.append(np.full(n, floor, dtype=np.int32))
    if not mats:
        raise ValueError("no sequences to combine")
    return np.vstack(mats), np.concatenate(labels)
