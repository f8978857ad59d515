"""Timestamp association between trajectories.

Counterpart of ``mlis_tpu/eval/association.py``, kept as the port's own
copy: a vectorised nearest neighbour in time. Host float64, because
absolute ROS timestamps (~1.7e9 s) do not survive float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def normalize_timestamps(t: np.ndarray) -> np.ndarray:
    """Nanosecond stamps to seconds (a first stamp > 1e15 means nanoseconds)."""
    t = np.asarray(t, dtype=np.float64)
    if t.size and t[0] > 1e15:
        return t / 1e9
    return t


def nearest_indices(query_t: np.ndarray, ref_t: np.ndarray) -> np.ndarray:
    """Index of the nearest ref_t for each query_t. ref_t must be sorted."""
    pos = np.searchsorted(ref_t, query_t)
    left = np.clip(pos - 1, 0, len(ref_t) - 1)
    right = np.clip(pos, 0, len(ref_t) - 1)
    choose_right = np.abs(ref_t[right] - query_t) < np.abs(ref_t[left] - query_t)
    return np.where(choose_right, right, left)


def associate_by_time(
    est_times: np.ndarray,
    ref_times: np.ndarray,
    max_diff: float = 0.5,
    min_matches: int = 10,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Match each est pose to its nearest-in-time ref pose.

    Returns (est_idx, ref_idx) arrays, or (None, None) when fewer than
    min_matches survive. An unsorted ref falls back to the O(N*M) argmin.
    """
    est_t = normalize_timestamps(est_times)
    ref_t = normalize_timestamps(ref_times)
    if len(ref_t) == 0 or len(est_t) == 0:
        return None, None

    if np.all(np.diff(ref_t) >= 0):
        j = nearest_indices(est_t, ref_t)
    else:
        j = np.abs(ref_t[None, :] - est_t[:, None]).argmin(axis=1)

    keep = np.abs(ref_t[j] - est_t) < max_diff
    est_idx = np.nonzero(keep)[0]
    ref_idx = j[keep]
    if len(est_idx) < min_matches:
        return None, None
    return est_idx, ref_idx
