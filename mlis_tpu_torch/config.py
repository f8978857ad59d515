"""Pipeline configuration: the fields ``FullGatePipeline.from_config`` reads,
and the floor detector's, LiDAR tracker's and gate's settings.

The fields, with the names and defaults of ``mlis_tpu/config.py``,
so that one configuration dict means the same thing to both packages;
``from_dict`` ignores the fields this package does not read.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class FloorDetectorConfig:
    """IMU elevator detection thresholds (gating/floor_detector.py)."""

    z_accel_threshold: float = 0.5  # m/s^2 deviation from gravity
    min_duration: float = 2.0  # seconds
    window_size: int = 50  # smoothing window, samples
    horizontal_var_threshold: float = 1.0
    max_events: int = 32  # padded length of the event table


@dataclass
class LidarTrackerConfig:
    """LiDAR ground-plane floor tracking (gating/lidar_floor_tracker.py)."""

    ransac_iterations: int = 128
    inlier_threshold: float = 0.1  # meters
    ground_ring_max: int = 30  # Ouster OS-128 lower rings
    floor_height: float = 3.5  # meters per floor (ISEC)
    smoothing_window: int = 10
    max_points: int = 8192  # in mlis_tpu's config; neither package reads it


@dataclass
class GateConfig:
    strict_mode: bool = True  # strict: reject any floor diff; loose: diff > 1
    floor_height: float = 3.0  # for contextual z-priors
    sigma_z: float = 0.5
    sigma_dz: float = 0.3


@dataclass
class GatingConfig:
    floor: FloorDetectorConfig = field(default_factory=FloorDetectorConfig)
    lidar: LidarTrackerConfig = field(default_factory=LidarTrackerConfig)
    gate: GateConfig = field(default_factory=GateConfig)


@dataclass
class VPRConfig:
    method: str = "cricavpr"  # cricavpr | mixvpr are ported
    top_k: int = 10
    similarity_threshold: float = 0.5
    min_time_gap_s: float = 10.0


@dataclass
class VerificationConfig:
    matcher: str = "lightglue"
    max_keypoints: int = 2048
    ransac_threshold_px: float = 3.0
    min_inliers: int = 20
    min_inlier_ratio: float = 0.25


@dataclass
class PipelineConfig:
    gating: GatingConfig = field(default_factory=GatingConfig)
    vpr: VPRConfig = field(default_factory=VPRConfig)
    verification: VerificationConfig = field(default_factory=VerificationConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        """Build from a (possibly larger) ``mlis_tpu`` config dict."""

        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                hints = typing.get_type_hints(tp)
                return tp(**{
                    f.name: build(hints[f.name], val[f.name])
                    for f in dataclasses.fields(tp)
                    if f.name in val
                })
            return val

        return build(cls, d)
