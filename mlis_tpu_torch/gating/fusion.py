"""Multi-modal floor detection: IMU elevator events + LiDAR absolute height.

Counterpart of ``mlis_tpu/gating/fusion.py``. The IMU labels are
authoritative (elevator signatures beat RANSAC planes); the LiDAR labels,
offset-aligned to the IMU start floor, give the agreement score. The
declared IMU/LiDAR weights are kept for API parity.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from mlis_tpu_torch.gating.floor_detector import IMUFloorDetector
from mlis_tpu_torch.gating.lidar_floor_tracker import LiDARFloorTracker


class MultiModalFloorDetector:
    def __init__(
        self,
        floor_height: float = 3.5,
        imu_weight: float = 0.7,
        lidar_weight: float = 0.3,
        device="cuda",
    ):
        self.floor_height = floor_height
        self.imu_weight = imu_weight
        self.lidar_weight = lidar_weight
        self.imu_detector = IMUFloorDetector(device=device)
        self.lidar_tracker = LiDARFloorTracker(floor_height=floor_height, device=device)
        self.fused_floor_labels: Optional[np.ndarray] = None

    def process_imu(self, timestamps, accel_x, accel_y, accel_z) -> None:
        self.imu_detector.detect_elevator_events(timestamps, accel_x, accel_y, accel_z)

    def process_lidar_scan(self, points, timestamp, rings=None) -> None:
        self.lidar_tracker.process_scan(points, timestamp, rings)

    def process_lidar_scans(self, scans, timestamps, rings=None, point_valid=None):
        self.lidar_tracker.process_scans(scans, timestamps, rings, point_valid)

    def fuse_estimates(self, trajectory_times: np.ndarray, start_floor: int = 0) -> np.ndarray:
        """The IMU labels: they win; the LiDAR's only verify (see agreement)."""
        imu_labels = self.imu_detector.assign_floor_labels(trajectory_times, start_floor)
        self.fused_floor_labels = imu_labels.copy()
        return self.fused_floor_labels

    def agreement(self, trajectory_times: np.ndarray, start_floor: int = 0) -> Dict:
        """Fraction of poses where the two modalities agree after offset
        alignment."""
        imu_labels = self.imu_detector.assign_floor_labels(trajectory_times, start_floor)
        if not self.lidar_tracker.floor_history:
            return {"agreement": 1.0, "n": len(imu_labels), "lidar_available": False}
        lidar = self.lidar_tracker.get_floor_labels(trajectory_times)
        lidar = lidar + (start_floor - lidar[0])
        agree = float(np.mean(imu_labels == lidar))
        return {"agreement": agree, "n": len(imu_labels), "lidar_available": True}
