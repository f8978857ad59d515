"""Single dataclass-based config tree, serializable to and from JSON.

Counterpart of ``mlis_tpu/config.py``, with its field names and defaults,
so one configuration file means the same thing to both packages: a config
that either package saves, the other loads equal field by field. One
default is the port's own: ``DataConfig.trajectory_root`` is
``reference/results/trajectories`` under the working directory, as the
CLI's ``--trajectory-root``. ``from_dict`` ignores fields it does not know.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict

from mlis_tpu_torch.core.dataset import REFERENCE_TRAJECTORY_ROOT


def _env_path(var: str, default: str) -> str:
    return os.environ.get(var, default)


@dataclass
class DataConfig:
    """Dataset locations; each has an environment override."""

    trajectory_root: str = field(
        default_factory=lambda: _env_path("MLIS_TRAJECTORY_ROOT", REFERENCE_TRAJECTORY_ROOT)
    )
    dataset_root: str = field(
        default_factory=lambda: _env_path("MLIS_DATASET_ROOT", "/data/ISEC")
    )
    results_root: str = field(
        default_factory=lambda: _env_path("MLIS_RESULTS_ROOT", "./results")
    )


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
class CandidateConfig:
    """Proximity candidate generation (the exact sweep, ops/pairwise.py)."""

    distance_threshold: float = 2.0  # meters
    min_time_gap: int = 100  # frames
    tile: int = 2048  # tile edge of mlis_tpu's all-pairs sweep; the port's kernel tiles itself


@dataclass
class VPRConfig:
    method: str = "cricavpr"  # mixvpr | salad | anyloc | cricavpr
    descriptor_dim: int = 4096
    top_k: int = 10
    similarity_threshold: float = 0.5
    min_time_gap_s: float = 10.0
    batch_size: int = 32
    dtype: str = "bfloat16"


@dataclass
class VerificationConfig:
    matcher: str = "lightglue"  # lightglue | superglue | loftr | orb (weight-free)
    max_keypoints: int = 2048
    ransac_threshold_px: float = 3.0
    ransac_prob: float = 0.999
    ransac_hypotheses: int = 512
    min_inliers: int = 20
    min_inlier_ratio: float = 0.25


@dataclass
class MeshConfig:
    """Device-mesh layout for the sharded gate (parallel/mesh.py)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: every rank on the data axis
    model_parallel: int = 1


@dataclass
class GatingConfig:
    floor: FloorDetectorConfig = field(default_factory=FloorDetectorConfig)
    lidar: LidarTrackerConfig = field(default_factory=LidarTrackerConfig)
    gate: GateConfig = field(default_factory=GateConfig)
    candidates: CandidateConfig = field(default_factory=CandidateConfig)


@dataclass
class PipelineConfig:
    data: DataConfig = field(default_factory=DataConfig)
    gating: GatingConfig = field(default_factory=GatingConfig)
    vpr: VPRConfig = field(default_factory=VPRConfig)
    verification: VerificationConfig = field(default_factory=VerificationConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
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

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "PipelineConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))
