"""SE(3)/SO(3) primitives on the host: quaternions, rotations, transform
chaining and the IMU frame conventions.

Counterpart of ``mlis_tpu/ops/geometry.py``, kept as the port's own numpy
copy (float64). Quaternions are xyzw (TUM / scipy order) throughout.
"""

from __future__ import annotations

import numpy as np


def quat_to_matrix(q) -> np.ndarray:
    """(..., 4) xyzw quaternion -> (..., 3, 3) rotation matrix."""
    q = np.asarray(q)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1)
    row1 = np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1)
    row2 = np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return np.stack([row0, row1, row2], -2)


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> (4,) xyzw quaternion (Shepperd's method)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def se3_inverse(T: np.ndarray) -> np.ndarray:
    """(4, 4) rigid transform inverse."""
    R = T[:3, :3]
    t = T[:3, 3]
    out = np.eye(4, dtype=T.dtype)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def se3_from_rt(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t).ravel()
    return T


def chain(*transforms: np.ndarray) -> np.ndarray:
    """Compose transforms left-to-right: chain(A, B) = A @ B."""
    out = np.eye(4)
    for T in transforms:
        out = out @ np.asarray(T)
    return out


# Frame conventions -----------------------------------------------------------

# The VectorNav IMU on NUFR-M3F reports in NED (z-down); SLAM stacks expect
# FLU (z-up). The correction is a 180-degree roll: x forward, y and z negated.
R_NED_TO_FLU = np.diag([1.0, -1.0, -1.0])


def ned_to_flu(vectors: np.ndarray) -> np.ndarray:
    """(..., 3) NED vectors -> FLU: (x, -y, -z)."""
    v = np.asarray(vectors)
    return v * np.asarray([1.0, -1.0, -1.0])


def detect_imu_convention(accel_z_mean: float) -> str:
    """Gravity sign heuristic: a stationary z-up (FLU) IMU measures +9.81 on
    z; NED measures -9.81."""
    if accel_z_mean < -5.0:
        return "NED"
    if accel_z_mean > 5.0:
        return "FLU"
    return "unknown"
