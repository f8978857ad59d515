"""Per-algorithm semantic-gating integration drivers, as the ``gate`` CLI
drives them.

Counterpart of ``mlis_tpu/gating/integration.py``: load the per-floor TUM
trajectories of one algorithm, concatenate them with floor labels
(transits interpolated), run the exact all-pairs candidate sweep with its
floor split (kernel K1 on the card), load the counts into a strict gate,
and write the analysis report with integer-exact counts. The module-level
:func:`analyze` is the one sweep path; ``SemanticIntegration.analyze``
calls it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from mlis_tpu_torch.core.dataset import NUFRM3F, TRANSIT_FLOORS
from mlis_tpu_torch.core.trajectory import Trajectory, combine_sequences
from mlis_tpu_torch.gating.gate import SemanticLoopClosureGate
from mlis_tpu_torch.ops.pairwise import candidate_counts, candidate_pairs_host

@dataclass
class LoopClosureAnalysis:
    """Candidate statistics after floor gating."""

    total_candidates: int = 0
    same_floor_candidates: int = 0
    cross_floor_candidates: int = 0
    elapsed_s: float = 0.0
    example_cross_floor_pairs: List[Tuple[int, int, int, int]] = field(default_factory=list)

    @property
    def cross_floor_rate(self) -> float:
        return (
            self.cross_floor_candidates / self.total_candidates
            if self.total_candidates
            else 0.0
        )


def analyze(
    positions: np.ndarray,  # (N, 3) float64
    floor_labels: np.ndarray,  # (N,)
    distance_threshold: float = 2.0,
    min_time_gap: int = 100,
    with_examples: bool = False,
    device="cuda",
) -> Tuple[LoopClosureAnalysis, SemanticLoopClosureGate]:
    """Run the candidate sweep and the floor gate; counts are float64-exact."""
    t0 = time.perf_counter()
    total, same, cross = candidate_counts(
        positions, floor_labels, radius=distance_threshold, min_gap=min_time_gap,
        device=device,
    )
    analysis = LoopClosureAnalysis(total, same, cross, time.perf_counter() - t0)

    gate = SemanticLoopClosureGate(floor_labels, strict_mode=True, device=device)
    gate.stats["total_candidates"] = total
    gate.stats["accepted"] = same
    gate.stats["rejected_cross_floor"] = cross

    if with_examples:
        fl = np.asarray(floor_labels)
        qi, mi, _ = candidate_pairs_host(
            positions[:4096], fl[:4096], radius=distance_threshold, min_gap=min_time_gap
        )
        for q, m in zip(qi, mi):
            if fl[q] != fl[m]:
                analysis.example_cross_floor_pairs.append(
                    (int(q), int(m), int(fl[q]), int(fl[m]))
                )
            if len(analysis.example_cross_floor_pairs) >= 5:
                break
    return analysis, gate


class SemanticIntegration:
    """Shared integration driver; subclasses pin the algorithm name."""

    algorithm: str = ""
    display_name: str = ""
    include_transits: bool = False

    def __init__(
        self,
        trajectory_dir: str,
        output_dir: str = "./results/semantic_gating",
        dataset_dir: Optional[str] = None,
        device="cuda",
    ):
        # trajectory_dir may point at the per-algorithm directory
        # (.../trajectories/orb_slam3) or at the shared root (.../trajectories)
        p = Path(trajectory_dir)
        root = p.parent if p.name == self.algorithm else p
        self.manifest = NUFRM3F(
            trajectory_root=str(root),
            algorithm=self.algorithm,
            include_transits=self.include_transits,
        )
        self.output_dir = Path(output_dir)
        self.dataset_dir = dataset_dir
        self.device = device
        self.combined: Optional[np.ndarray] = None  # (N, 8) TUM matrix
        self.floor_labels: Optional[np.ndarray] = None
        self.sequences: List[Tuple[str, Optional[int], Trajectory]] = []
        self.loop_gate: Optional[SemanticLoopClosureGate] = None
        self.last_analysis: Optional[LoopClosureAnalysis] = None

    # -- pipeline stages ----------------------------------------------------
    def load_and_combine(self) -> Tuple[np.ndarray, np.ndarray]:
        self.sequences = self.manifest.load()
        if not self.sequences:
            raise FileNotFoundError(
                f"no {self.algorithm} trajectories under {self.manifest.trajectory_root}"
            )
        self.combined, self.floor_labels = combine_sequences(self.sequences, TRANSIT_FLOORS)
        return self.combined, self.floor_labels

    def analyze(
        self,
        distance_threshold: float = 2.0,
        min_time_gap: int = 100,
        with_examples: bool = False,
    ) -> LoopClosureAnalysis:
        """Run the candidate sweep + floor gate; counts are float64-exact."""
        if self.combined is None:
            self.load_and_combine()
        analysis, self.loop_gate = analyze(
            self.combined[:, 1:4], self.floor_labels, distance_threshold, min_time_gap,
            with_examples, device=self.device,
        )
        return analysis

    # -- reporting ----------------------------------------------------------
    def generate_report(self, analysis: LoopClosureAnalysis) -> str:
        if self.combined is None or self.floor_labels is None:
            raise ValueError("load the trajectories first")
        lines: List[str] = []
        bar = "=" * 70
        sub = "-" * 50
        lines += [bar, f"{self.display_name} SEMANTIC GATING ANALYSIS", bar, ""]

        lines += ["TRAJECTORY SUMMARY", sub]
        lines.append(f"  Total poses: {len(self.combined)}")
        lines.append(f"  Sequences loaded: {len(self.sequences)}")
        duration = self.combined[-1, 0] - self.combined[0, 0]
        lines.append(f"  Total duration: {duration:.1f} seconds")
        lines.append("")

        lines += ["FLOOR DISTRIBUTION", sub]
        floors, counts = np.unique(self.floor_labels, return_counts=True)
        for floor, count in zip(floors, counts):
            pct = 100 * count / len(self.floor_labels)
            lines.append(f"  Floor {floor}: {count} poses ({pct:.1f}%)")
        lines.append("")

        lines += ["LOOP CLOSURE ANALYSIS", sub]
        lines.append(f"  Total candidates detected: {analysis.total_candidates}")
        lines.append(f"  Same-floor (valid): {analysis.same_floor_candidates}")
        lines.append(f"  Cross-floor (perceptual aliasing): {analysis.cross_floor_candidates}")
        if analysis.total_candidates:
            lines.append(f"  Cross-floor rate: {analysis.cross_floor_rate:.1%}")
        lines.append(f"  Sweep time: {analysis.elapsed_s*1e3:.1f} ms")
        lines.append("")

        lines += ["IMPACT ASSESSMENT", sub]
        lines.append("  Without semantic gating:")
        lines.append(f"    - {analysis.cross_floor_candidates} false loop closures would occur")
        lines.append("  With floor-based semantic gating:")
        lines.append(f"    - {analysis.cross_floor_candidates} false positives rejected")
        lines.append(f"    - {analysis.same_floor_candidates} true loop closures preserved")
        lines.append("")
        lines.append(bar)
        return "\n".join(lines)

    def run_full_analysis(
        self,
        distance_threshold: float = 2.0,
        min_time_gap: int = 100,
        save_report: bool = True,
        make_figures: bool = False,
    ) -> str:
        self.load_and_combine()
        analysis = self.last_analysis = self.analyze(distance_threshold, min_time_gap)
        report = self.generate_report(analysis)
        if save_report:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            (self.output_dir / f"{self.algorithm}_semantic_analysis.txt").write_text(report)
        if make_figures:
            from mlis_tpu_torch.viz.figures import (
                plot_floor_segmentation,
                plot_loop_closure_gating,
                plot_multifloor_3d,
            )

            self.output_dir.mkdir(parents=True, exist_ok=True)
            plot_floor_segmentation(
                self.combined, self.floor_labels,
                self.output_dir / f"{self.algorithm}_floor_segmentation.png",
                title=self.display_name,
            )
            plot_multifloor_3d(
                self.combined, self.floor_labels,
                self.output_dir / f"{self.algorithm}_3d_multifloor.png",
                title=self.display_name,
            )
            # before/after gating links on a pose subsample
            step = max(len(self.combined) // 4000, 1)
            sub = self.combined[::step]
            sub_floors = self.floor_labels[::step]
            qi, mi, _ = candidate_pairs_host(
                sub[:, 1:4], sub_floors,
                radius=distance_threshold, min_gap=max(min_time_gap // step, 2),
            )
            plot_loop_closure_gating(
                sub, sub_floors, list(zip(qi, mi)),
                self.output_dir / f"{self.algorithm}_loop_closure_gating.png",
                title=self.display_name,
            )
        return report


class ORBSlam3SemanticIntegration(SemanticIntegration):
    algorithm = "orb_slam3"
    display_name = "ORB-SLAM3"


class DroidSlamSemanticIntegration(SemanticIntegration):
    algorithm = "droid_slam"
    display_name = "DROID-SLAM"


class LegoLoamSemanticIntegration(SemanticIntegration):
    algorithm = "lego_loam"
    display_name = "LeGO-LOAM"


INTEGRATIONS = {
    cls.algorithm: cls
    for cls in (
        ORBSlam3SemanticIntegration,
        DroidSlamSemanticIntegration,
        LegoLoamSemanticIntegration,
    )
}


def run_comparison(
    trajectory_root: str,
    output_dir: str = "./results/semantic_gating",
    algorithms: Optional[List[str]] = None,
    save_report: bool = True,
    per_algo_reports: bool = False,
    make_figures: bool = False,
    device="cuda",
) -> Dict[str, LoopClosureAnalysis]:
    """Run every integration and write the cross-algorithm comparison.

    per_algo_reports / make_figures also write each algorithm's
    ``<algo>_semantic_analysis.txt`` and its three figures (floor
    segmentation, 3D multi-floor, gating links)."""
    algorithms = algorithms or list(INTEGRATIONS)
    results: Dict[str, LoopClosureAnalysis] = {}
    meta: Dict[str, Dict] = {}
    for algo in algorithms:
        integ = INTEGRATIONS[algo](trajectory_root, output_dir, device=device)
        if per_algo_reports or make_figures:
            integ.run_full_analysis(save_report=per_algo_reports, make_figures=make_figures)
            results[algo] = integ.last_analysis
            combined, floors = integ.combined, integ.floor_labels
        else:
            combined, floors = integ.load_and_combine()
            results[algo] = integ.analyze()
        fl, counts = np.unique(floors, return_counts=True)
        meta[algo] = {
            "poses": len(combined),
            "sequences": len(integ.sequences),
            "duration": float(combined[-1, 0] - combined[0, 0]),
            "floor_dist": {int(f): float(c / len(floors)) for f, c in zip(fl, counts)},
        }
    if save_report:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        (Path(output_dir) / "semantic_gating_comparison.txt").write_text(
            comparison_text(results, meta)
        )
    return results


def comparison_text(results: Dict[str, LoopClosureAnalysis], meta: Dict[str, Dict]) -> str:
    """Cross-algorithm comparison table."""
    algos = list(results)
    bar = "=" * 70
    lines = [bar, "SEMANTIC GATING COMPARISON", bar, ""]
    header = f"{'Metric':<28}" + "".join(f"{a:<16}" for a in algos)
    lines += [header, "-" * len(header)]

    def row(label, fn):
        lines.append(f"{label:<28}" + "".join(f"{fn(a):<16}" for a in algos))

    row("Total poses", lambda a: f"{meta[a]['poses']:,}")
    row("Sequences loaded", lambda a: str(meta[a]["sequences"]))
    row("Total duration (s)", lambda a: f"{meta[a]['duration']:.1f}")
    lines.append("")
    all_floors = sorted({f for a in algos for f in meta[a]["floor_dist"]})
    for f in all_floors:
        row(f"  Floor {f}", lambda a, f=f: f"{100 * meta[a]['floor_dist'].get(f, 0):.1f}%")
    lines.append("")
    row("Loop closure candidates", lambda a: f"{results[a].total_candidates:,}")
    row("Same-floor (valid)", lambda a: f"{results[a].same_floor_candidates:,}")
    row("Cross-floor (rejected)", lambda a: f"{results[a].cross_floor_candidates:,}")
    row("CROSS-FLOOR RATE", lambda a: f"{results[a].cross_floor_rate:.1%}")
    lines += ["", bar]
    return "\n".join(lines)
