"""SemanticGatingPipeline: load a trajectory and an IMU table, detect
floors, gate candidates, report.

Counterpart of ``mlis_tpu/gating/pipeline.py``: a TUM trajectory and an
IMU table in, elevator events and per-pose floor labels out, the
floor-consistency gate over candidate lists, a text report, the 2D and
3D figures, and a ``--demo`` mode that synthesises a trajectory and an IMU
stream with two elevator rides:

    python -m mlis_tpu_torch.gating.pipeline --demo [--device cpu]

``load_imu_data`` reads a CSV (``.csv``) or whitespace table without a
header row, as the JAX package's does; a CSV written by ``bag imu-csv``
(which carries a header) is refused by both.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mlis_tpu_torch.core.trajectory import load_tum
from mlis_tpu_torch.gating.floor_detector import ElevatorEvent, IMUFloorDetector
from mlis_tpu_torch.gating.gate import SemanticLoopClosureGate


class SemanticGatingPipeline:
    def __init__(self, output_dir: str = "./results/semantic_gating", device="cuda"):
        self.output_dir = Path(output_dir)
        self.device = device
        self.trajectory: Optional[np.ndarray] = None  # (N, 8) TUM matrix
        self.imu_data: Optional[np.ndarray] = None  # (M, 7) t ax ay az gx gy gz
        self.floor_detector: Optional[IMUFloorDetector] = None
        self.floor_labels: Optional[np.ndarray] = None
        self.loop_gate: Optional[SemanticLoopClosureGate] = None

    # -- IO ----------------------------------------------------------------
    def load_trajectory(self, path: str) -> np.ndarray:
        self.trajectory = load_tum(path).as_matrix()
        return self.trajectory

    def load_imu_data(self, path: str) -> np.ndarray:
        """Whitespace/CSV table: t ax ay az [gx gy gz]."""
        data = np.loadtxt(path, delimiter="," if str(path).endswith(".csv") else None)
        if data.shape[1] < 4:
            raise ValueError("IMU file needs at least t, ax, ay, az columns")
        self.imu_data = data
        return data

    # -- stages --------------------------------------------------------------
    def detect_floors(
        self, start_floor: int = 5, detector: Optional[IMUFloorDetector] = None
    ) -> Tuple[List[ElevatorEvent], np.ndarray]:
        if self.trajectory is None or self.imu_data is None:
            raise ValueError("load trajectory and IMU data first")
        self.floor_detector = detector or IMUFloorDetector(device=self.device)
        t, ax, ay, az = (self.imu_data[:, i] for i in range(4))
        events = self.floor_detector.detect_elevator_events(t, ax, ay, az)
        self.floor_labels = self.floor_detector.assign_floor_labels(
            self.trajectory[:, 0], start_floor=start_floor
        )
        return events, self.floor_labels

    def create_loop_closure_gate(self, strict_mode: bool = True) -> SemanticLoopClosureGate:
        if self.floor_labels is None:
            raise ValueError("detect floors first")
        self.loop_gate = SemanticLoopClosureGate(self.floor_labels, strict_mode, device=self.device)
        return self.loop_gate

    def gate_candidates(self, candidates: Sequence[Tuple[int, int, float]]):
        if self.loop_gate is None:
            self.create_loop_closure_gate()
        return self.loop_gate.gate_candidates(candidates)

    # -- outputs ----------------------------------------------------------------
    def generate_report(self) -> str:
        lines = ["=" * 60, "SEMANTIC GATING PIPELINE REPORT", "=" * 60, ""]
        if self.trajectory is not None:
            dur = self.trajectory[-1, 0] - self.trajectory[0, 0]
            lines += [f"Trajectory poses: {len(self.trajectory)}", f"Duration: {dur:.1f} s"]
        if self.floor_detector is not None:
            lines.append(f"Elevator events: {len(self.floor_detector.events)}")
            for i, ev in enumerate(self.floor_detector.events):
                lines.append(
                    f"  {i + 1}. t=[{ev.start_time:.1f}, {ev.end_time:.1f}] "
                    f"{ev.direction} ({ev.duration:.1f}s)"
                )
        if self.floor_labels is not None:
            floors, counts = np.unique(self.floor_labels, return_counts=True)
            lines.append("Floor distribution:")
            for f, c in zip(floors, counts):
                lines.append(f"  Floor {f}: {c} poses ({100 * c / len(self.floor_labels):.1f}%)")
        if self.loop_gate is not None:
            s = self.loop_gate.get_stats()
            lines += [
                "Gating:",
                f"  total: {s['total_candidates']}",
                f"  accepted: {s['accepted']}",
                f"  rejected (cross-floor): {s['rejected_cross_floor']}",
            ]
        lines.append("=" * 60)
        report = "\n".join(lines)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        (self.output_dir / "semantic_gating_report.txt").write_text(report)
        return report

    def visualize_results(self) -> Optional[Path]:
        if self.trajectory is None or self.floor_labels is None:
            raise ValueError("run the pipeline first")
        from mlis_tpu_torch.viz.figures import plot_floor_segmentation

        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / "pipeline_floor_segmentation.png"
        plot_floor_segmentation(self.trajectory, self.floor_labels, path)
        return path

    def visualize_3d(self) -> Optional[Path]:
        if self.trajectory is None or self.floor_labels is None:
            raise ValueError("run the pipeline first")
        from mlis_tpu_torch.viz.figures import plot_multifloor_3d

        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / "pipeline_3d_multifloor.png"
        plot_multifloor_3d(self.trajectory, self.floor_labels, path)
        return path


def make_demo_data(seed: int = 0):
    """Synthetic single-run scenario: a loop trajectory + a 200 Hz IMU
    stream with a down ride at t=[100,105] and an up ride at t=[200,204].
    The same numpy draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    n_poses = 5000
    t = np.linspace(0, 300, n_poses)
    theta = np.linspace(0, 2 * np.pi, n_poses)
    x = 20 * np.cos(theta) + rng.normal(0, 0.1, n_poses)
    y = np.zeros(n_poses)
    z = 30 * np.sin(theta) + rng.normal(0, 0.1, n_poses)
    quat = np.tile([0.0, 0.0, 0.0, 1.0], (n_poses, 1))
    trajectory = np.column_stack([t, x, y, z, quat])

    n_imu = 300 * 200
    t_imu = np.linspace(0, 300, n_imu)
    ax = rng.normal(0, 0.1, n_imu)
    ay = rng.normal(0, 0.1, n_imu)
    az = rng.normal(9.81, 0.1, n_imu)
    az[(t_imu >= 100) & (t_imu <= 105)] -= 0.8  # down
    az[(t_imu >= 200) & (t_imu <= 204)] += 0.7  # up
    gyro = rng.normal(0, 0.01, (n_imu, 3))
    imu = np.column_stack([t_imu, ax, ay, az, gyro])
    return trajectory, imu


def run_demo(output_dir: Optional[str] = None, device="cuda") -> SemanticGatingPipeline:
    """The demo scenario end to end; the report goes to ``output_dir``
    (default: semantic_gating_demo under the temporary directory)."""
    if output_dir is None:
        output_dir = str(Path(tempfile.gettempdir()) / "semantic_gating_demo")
    pipeline = SemanticGatingPipeline(output_dir=output_dir, device=device)
    pipeline.trajectory, pipeline.imu_data = make_demo_data()
    events, labels = pipeline.detect_floors(start_floor=5)
    print(f"Detected {len(events)} elevator events")
    print(f"Floor labels: {np.unique(labels)}")

    pipeline.create_loop_closure_gate(strict_mode=True)
    candidates = [
        (100, 4500, 0.85),
        (500, 2500, 0.92),
        (1000, 1500, 0.88),
        (200, 3000, 0.91),
    ]
    valid, rejected = pipeline.gate_candidates(candidates)
    print(f"Gating: valid={len(valid)} rejected={len(rejected)}")
    print(pipeline.generate_report())
    return pipeline


def main(argv=None):
    parser = argparse.ArgumentParser(description="Semantic gating pipeline for multi-floor SLAM")
    parser.add_argument("--trajectory", type=str, help="TUM trajectory path")
    parser.add_argument("--imu", type=str, help="IMU table path (t ax ay az ...)")
    parser.add_argument("--output", type=str, default="./results/semantic_gating")
    parser.add_argument("--start-floor", type=int, default=5)
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    if args.demo:
        run_demo(args.output, device=args.device)
        return 0
    if args.trajectory and args.imu:
        p = SemanticGatingPipeline(output_dir=args.output, device=args.device)
        p.load_trajectory(args.trajectory)
        p.load_imu_data(args.imu)
        p.detect_floors(start_floor=args.start_floor)
        p.visualize_results()
        p.visualize_3d()
        print(p.generate_report())
        return 0
    parser.print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
