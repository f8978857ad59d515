"""NUFR-M3F (ISEC building) dataset manifest.

Counterpart of ``mlis_tpu/core/dataset.py``, kept as the port's own copy:
sequence order, expected path lengths, sensor topics and rates, the stereo
pair, the floor height, per-algorithm trajectory filename patterns and the
paper's Table IV endpoint drifts.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from mlis_tpu_torch.core.trajectory import Trajectory, load_tum


@dataclass(frozen=True)
class SequenceSpec:
    name: str
    floor: Optional[int]  # None for transit sequences
    expected_length_m: Optional[float] = None


# Benchmark floor sequences in traversal order (5 -> 1 -> 4 -> 2), with the
# elevator transits between them.
FLOOR_SEQUENCES: List[SequenceSpec] = [
    SequenceSpec("5th_floor", 5, 187.0),
    SequenceSpec("1st_floor", 1, 65.0),
    SequenceSpec("4th_floor", 4, 66.0),
    SequenceSpec("2nd_floor", 2, 128.0),
]

TRANSIT_SEQUENCES: List[SequenceSpec] = [
    SequenceSpec("transit_5_to_1", None),
    SequenceSpec("transit_1_to_4", None),
    SequenceSpec("transit_4_to_2", None),
    SequenceSpec("transit_2_to_5", None),
]

TRANSIT_FLOORS: Dict[str, Tuple[int, int]] = {
    "transit_5_to_1": (5, 1),
    "transit_1_to_4": (1, 4),
    "transit_4_to_2": (4, 2),
    "transit_2_to_5": (2, 5),
}

# Full traversal order including transits.
FULL_SEQUENCE_ORDER: List[SequenceSpec] = [
    FLOOR_SEQUENCES[0], TRANSIT_SEQUENCES[0],
    FLOOR_SEQUENCES[1], TRANSIT_SEQUENCES[1],
    FLOOR_SEQUENCES[2], TRANSIT_SEQUENCES[2],
    FLOOR_SEQUENCES[3], TRANSIT_SEQUENCES[3],
]

# Sensor facts.
CAMERA_TOPICS = [f"/camera_array/cam{i}/image_raw" for i in range(7)]
IMU_TOPIC = "/vectornav/imu"  # 200 Hz, NED / Z-down convention
LIDAR_TOPIC = "/ouster/points"  # 10 Hz, Ouster OS-128
STEREO_PAIR = ("cam1", "cam3")
STEREO_BASELINE_M = 0.328
CAMERA_RATE_HZ = 20.0
IMU_RATE_HZ = 200.0
LIDAR_RATE_HZ = 10.0
IMAGE_SIZE = (540, 720)  # (H, W)
FLOOR_HEIGHT_M = 3.5  # ISEC inter-floor height used by the LiDAR tracker

# Paper (Kaveti et al., IEEE CASE 2023) Table IV endpoint-drift values.
PAPER_TABLE_IV: Dict[str, Dict[str, float]] = {
    "lego_loam": {"5th_floor": 0.395, "1st_floor": 0.256, "4th_floor": 0.789, "2nd_floor": 0.286},
    "orb_slam3": {"5th_floor": 0.516, "1st_floor": 0.949, "4th_floor": 0.483, "2nd_floor": 0.310},
    "droid_slam": {"5th_floor": 0.441, "1st_floor": 0.666, "4th_floor": 0.112, "2nd_floor": 0.214},
    "basalt": {"5th_floor": 1.214, "1st_floor": 4.043, "4th_floor": 1.809, "2nd_floor": 3.054},
}

# Per-algorithm trajectory filename patterns under <trajectory_root>/<algo>/.
TRAJECTORY_FILE_PATTERNS: Dict[str, List[str]] = {
    "orb_slam3": ["{seq}.txt"],
    "lego_loam": ["{seq}.txt"],
    "droid_slam": ["{seq}_stereo.txt", "{seq}.txt"],
    "basalt": ["{seq}.txt"],
}

# Start floor of every algorithm integration (all runs start on the 5th floor).
START_FLOOR = 5

# Where the reference repository keeps its published trajectories, relative
# to a working directory with the reference checked out beside it: the
# default root of the gate / evaluate CLI and of opt.scale.
REFERENCE_TRAJECTORY_ROOT = "reference/results/trajectories"


@dataclass
class NUFRM3F:
    """Manifest + loader for benchmark trajectories of one algorithm."""

    trajectory_root: str
    algorithm: str
    include_transits: bool = False

    def sequence_order(self) -> List[SequenceSpec]:
        return list(FULL_SEQUENCE_ORDER) if self.include_transits else list(FLOOR_SEQUENCES)

    def trajectory_path(self, seq: str) -> Optional[Path]:
        root = Path(self.trajectory_root) / self.algorithm
        for pat in TRAJECTORY_FILE_PATTERNS.get(self.algorithm, ["{seq}.txt"]):
            p = root / pat.format(seq=seq)
            if p.exists():
                return p
        return None

    def load(self) -> List[Tuple[str, Optional[int], Trajectory]]:
        """Load the available sequences in order; missing files are skipped."""
        out = []
        for spec in self.sequence_order():
            p = self.trajectory_path(spec.name)
            if p is None:
                continue
            out.append((spec.name, spec.floor, load_tum(p)))
        return out
