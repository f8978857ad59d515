"""Semantic evaluation, host only: loop-closure, floor-detection and
dynamic-filtering metrics, the gating report parser, trajectory velocity
metrics, and the JSON + markdown comparison of ``SemanticEvaluator``.

Counterpart of ``mlis_tpu/eval/semantic_eval.py``, kept as the port's own
copy. Every ratio returns 0 on an empty denominator, except gating
effectiveness, which is 1 when there were no cross-floor candidates to
reject. ``parse_gating_report`` reads the analysis reports that either
package's ``SemanticIntegration.run_full_analysis`` writes (their field
labels are the same).
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, Optional

import numpy as np


@dataclass
class LoopClosureMetrics:
    total_candidates: int = 0
    true_positives: int = 0
    false_positives: int = 0
    false_negatives: int = 0
    same_floor_candidates: int = 0
    cross_floor_candidates: int = 0
    cross_floor_rejected: int = 0

    @property
    def precision(self) -> float:
        d = self.true_positives + self.false_positives
        return self.true_positives / d if d else 0.0

    @property
    def recall(self) -> float:
        d = self.true_positives + self.false_negatives
        return self.true_positives / d if d else 0.0

    @property
    def f1_score(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def cross_floor_rate(self) -> float:
        return self.cross_floor_candidates / self.total_candidates if self.total_candidates else 0.0

    @property
    def gating_effectiveness(self) -> float:
        if self.cross_floor_candidates == 0:
            return 1.0
        return self.cross_floor_rejected / self.cross_floor_candidates


@dataclass
class FloorDetectionMetrics:
    total_poses: int = 0
    correct_floor_labels: int = 0
    elevator_events_detected: int = 0
    elevator_events_ground_truth: int = 0

    @property
    def floor_accuracy(self) -> float:
        return self.correct_floor_labels / self.total_poses if self.total_poses else 0.0

    @property
    def elevator_precision(self) -> float:
        if self.elevator_events_ground_truth == 0:
            return 1.0 if self.elevator_events_detected == 0 else 0.0
        return min(
            1.0, self.elevator_events_detected / self.elevator_events_ground_truth
        )


@dataclass
class DynamicFilteringMetrics:
    total_frames: int = 0
    frames_with_dynamic_objects: int = 0
    total_features_extracted: int = 0
    features_filtered: int = 0
    mean_tracking_velocity: float = 0.0
    velocity_std: float = 0.0
    tracking_failures: int = 0

    @property
    def dynamic_object_rate(self) -> float:
        return (
            self.frames_with_dynamic_objects / self.total_frames
            if self.total_frames
            else 0.0
        )

    @property
    def feature_filter_rate(self) -> float:
        return (
            self.features_filtered / self.total_features_extracted
            if self.total_features_extracted
            else 0.0
        )


@dataclass
class SemanticEvaluationResult:
    algorithm: str
    sequence: str = "all"
    # None = not evaluated; 0.0 is a legitimate measured value (e.g. the
    # pseudo-ground-truth trajectory scored against itself)
    ate_rmse: Optional[float] = None
    ate_mean: Optional[float] = None
    ate_max: Optional[float] = None
    loop_closure: LoopClosureMetrics = field(default_factory=LoopClosureMetrics)
    floor_detection: FloorDetectionMetrics = field(
        default_factory=FloorDetectionMetrics
    )
    dynamic_filtering: Optional[DynamicFilteringMetrics] = None
    mean_velocity: Optional[float] = None
    velocity_std: Optional[float] = None
    endpoint_drift: Optional[float] = None


# -- report parsing -------------------------------------------------------------

_REPORT_PATTERNS = {
    "total_candidates": r"Total candidates detected:\s*([\d,]+)",
    "same_floor": r"Same-floor \(valid\):\s*([\d,]+)",
    "cross_floor": r"Cross-floor \(perceptual aliasing\):\s*([\d,]+)",
    "total_poses": r"Total poses:\s*([\d,]+)",
}


def parse_gating_report(path_or_text) -> LoopClosureMetrics:
    """Parse a semantic-analysis text report (either package's, or the
    reference's: the field labels are the same) into LoopClosureMetrics."""
    text = (
        Path(path_or_text).read_text()
        if isinstance(path_or_text, (str, Path)) and len(str(path_or_text)) < 512
        and Path(str(path_or_text)).exists()
        else str(path_or_text)
    )
    vals = {}
    for key, pat in _REPORT_PATTERNS.items():
        m = re.search(pat, text)
        vals[key] = int(m.group(1).replace(",", "")) if m else 0
    return LoopClosureMetrics(
        total_candidates=vals["total_candidates"],
        same_floor_candidates=vals["same_floor"],
        cross_floor_candidates=vals["cross_floor"],
        cross_floor_rejected=vals["cross_floor"],  # strict gate rejects all
        true_positives=vals["same_floor"],
        false_positives=0,
    )


# -- trajectory quality ----------------------------------------------------------


def trajectory_velocity_metrics(tum_matrix: np.ndarray) -> Dict[str, float]:
    """Velocity statistics and endpoint drift."""
    t = tum_matrix[:, 0]
    pos = tum_matrix[:, 1:4]
    dt = np.diff(t)
    ok = dt > 1e-6
    v = np.linalg.norm(np.diff(pos, axis=0), axis=1)[ok] / dt[ok]
    return {
        "mean_velocity": float(v.mean()) if v.size else 0.0,
        "velocity_std": float(v.std()) if v.size else 0.0,
        "max_velocity": float(v.max()) if v.size else 0.0,
        "endpoint_drift": float(np.linalg.norm(pos[-1] - pos[0])),
        "duration": float(t[-1] - t[0]),
    }


def floor_detection_metrics(
    predicted: np.ndarray,
    ground_truth: np.ndarray,
    events_detected: int = 0,
    events_ground_truth: int = 0,
) -> FloorDetectionMetrics:
    predicted = np.asarray(predicted)
    ground_truth = np.asarray(ground_truth)
    return FloorDetectionMetrics(
        total_poses=len(predicted),
        correct_floor_labels=int((predicted == ground_truth).sum()),
        elevator_events_detected=events_detected,
        elevator_events_ground_truth=events_ground_truth,
    )


# -- evaluator ---------------------------------------------------------------------


class SemanticEvaluator:
    """Aggregates semantic-gating results across algorithms and renders
    JSON + markdown comparison tables."""

    def __init__(self, results_dir: str = "./results/semantic_gating"):
        self.results_dir = Path(results_dir)
        self.results: Dict[str, SemanticEvaluationResult] = {}

    def evaluate_algorithm(
        self,
        algorithm: str,
        report_path: Optional[str] = None,
        tum_matrix: Optional[np.ndarray] = None,
        reference_tum: Optional[np.ndarray] = None,
        comprehensive_results: Optional[Dict] = None,
    ) -> SemanticEvaluationResult:
        """Aggregate one algorithm's gating report + trajectory metrics.

        The ATE fields come from either:
          * ``comprehensive_results``, the per-floor dict of
            ``eval.comprehensive.run_full_evaluation`` (the ate_vs_lego
            blocks averaged across valid floors), or
          * ``reference_tum``, a reference TUM matrix to associate, align
            and score ``tum_matrix`` against directly.
        """
        res = SemanticEvaluationResult(algorithm=algorithm)
        report = (
            Path(report_path)
            if report_path
            else self.results_dir / f"{algorithm}_semantic_analysis.txt"
        )
        if report.exists():
            res.loop_closure = parse_gating_report(report)
        if tum_matrix is not None:
            vm = trajectory_velocity_metrics(tum_matrix)
            res.mean_velocity = vm["mean_velocity"]
            res.velocity_std = vm["velocity_std"]
            res.endpoint_drift = vm["endpoint_drift"]

        if comprehensive_results is not None:
            ates = [
                fr["ate_vs_lego"]
                for fr in comprehensive_results.get(algorithm, {}).values()
                if isinstance(fr, dict) and "ate_vs_lego" in fr
            ]
            if ates:
                res.ate_rmse = float(np.mean([a["rmse"] for a in ates]))
                res.ate_mean = float(np.mean([a["mean"] for a in ates]))
                res.ate_max = float(np.max([a["max"] for a in ates]))
        elif tum_matrix is not None and reference_tum is not None:
            ate = self._ate_vs_reference(tum_matrix, reference_tum)
            if ate is not None:
                res.ate_rmse = ate["rmse"]
                res.ate_mean = ate["mean"]
                res.ate_max = ate["max"]

        self.results[algorithm] = res
        return res

    @staticmethod
    def _ate_vs_reference(
        tum_matrix: np.ndarray,
        reference_tum: np.ndarray,
        max_time_diff: float = 0.5,
    ) -> Optional[Dict[str, float]]:
        from mlis_tpu_torch.eval.alignment import align_se3
        from mlis_tpu_torch.eval.association import associate_by_time
        from mlis_tpu_torch.eval.metrics import compute_ate

        est_idx, ref_idx = associate_by_time(
            tum_matrix[:, 0], reference_tum[:, 0], max_diff=max_time_diff
        )
        if est_idx is None or len(est_idx) < 3:
            return None
        aligned, _, _ = align_se3(
            tum_matrix[est_idx, 1:4], reference_tum[ref_idx, 1:4]
        )
        ate = compute_ate(aligned, reference_tum[ref_idx, 1:4])
        return {k: float(v) for k, v in ate.items() if k != "errors"}

    def evaluate_all(self, algorithms=("orb_slam3", "droid_slam", "lego_loam")):
        for algo in algorithms:
            self.evaluate_algorithm(algo)
        return self.results

    # -- output -----------------------------------------------------------------
    def to_json(self, path: Optional[str] = None) -> str:
        def enc(r: SemanticEvaluationResult):
            d = asdict(r)
            d["loop_closure"].update(
                cross_floor_rate=r.loop_closure.cross_floor_rate,
                gating_effectiveness=r.loop_closure.gating_effectiveness,
                precision=r.loop_closure.precision,
                recall=r.loop_closure.recall,
                f1_score=r.loop_closure.f1_score,
            )
            return d

        out = json.dumps({k: enc(v) for k, v in self.results.items()}, indent=2)
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            Path(path).write_text(out)
        return out

    def comparison_markdown(self, path: Optional[str] = None) -> str:
        """Multi-section comparison: trajectory accuracy (ATE + drift),
        loop-closure metrics, smoothness."""
        lines = [
            "# Semantic Gating Comparison",
            "",
            "## Trajectory Accuracy",
            "",
            "| Algorithm | ATE RMSE | ATE mean | ATE max | Endpoint drift |",
            "|---|---|---|---|---|",
        ]

        def _m(v: Optional[float]) -> str:
            return f"{v:.3f}m" if v is not None else "N/A"

        for algo, r in self.results.items():
            lines.append(
                f"| {algo} | {_m(r.ate_rmse)} | {_m(r.ate_mean)} "
                f"| {_m(r.ate_max)} | {_m(r.endpoint_drift)} |"
            )

        lines += [
            "",
            "## Loop Closure Metrics",
            "",
            "| Algorithm | Candidates | Same-floor | Cross-floor | Cross-floor rate | Gating effectiveness |",
            "|---|---|---|---|---|---|",
        ]
        for algo, r in self.results.items():
            lc = r.loop_closure
            lines.append(
                f"| {algo} | {lc.total_candidates:,} | {lc.same_floor_candidates:,} "
                f"| {lc.cross_floor_candidates:,} | {lc.cross_floor_rate:.1%} "
                f"| {lc.gating_effectiveness:.1%} |"
            )

        lines += [
            "",
            "## Trajectory Smoothness",
            "",
            "| Algorithm | Mean velocity (m/s) | Velocity std (m/s) |",
            "|---|---|---|",
        ]
        for algo, r in self.results.items():
            mv = f"{r.mean_velocity:.3f}" if r.mean_velocity is not None else "N/A"
            vs = f"{r.velocity_std:.3f}" if r.velocity_std is not None else "N/A"
            lines.append(f"| {algo} | {mv} | {vs} |")

        out = "\n".join(lines) + "\n"
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            Path(path).write_text(out)
        return out
