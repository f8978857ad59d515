"""Full benchmark evaluation pipeline, host only.

Counterpart of ``mlis_tpu/eval/comprehensive.py``, kept as the port's own
copy over the port's ``core/dataset.py`` and ``core/trajectory.py``: the
reference's two evaluation scripts as one pipeline with explicit modes.
LeGO-LOAM is the pseudo-ground-truth; DROID aligns with Sim(3) (no metric
scale), the others with SE(3).

``legacy_alignment=True`` reproduces the reference's published
results/metrics/final_evaluation.json numbers (its "SE(3)" applies the
similarity scale; see ``eval/alignment.kabsch_sim3_legacy``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mlis_tpu_torch.core.dataset import PAPER_TABLE_IV, NUFRM3F
from mlis_tpu_torch.core.trajectory import (
    Trajectory,
    endpoint_drift,
    trajectory_length,
)
from mlis_tpu_torch.eval.alignment import align_se3, align_sim3, kabsch_sim3_legacy
from mlis_tpu_torch.eval.association import associate_by_time
from mlis_tpu_torch.eval.metrics import (
    analyze_problem_regions,
    analyze_tracking_quality,
    compute_ate,
    compute_error_at_distances,
    compute_rpe,
    compute_segment_metrics,
    compute_trajectory_smoothness,
    is_valid_trajectory,
)

ALGORITHMS: Dict[str, Dict] = {
    "lego_loam": {"type": "LiDAR", "has_scale": True},
    "orb_slam3": {"type": "Visual", "has_scale": True},
    "basalt": {"type": "VIO", "has_scale": True},
    "droid_slam": {"type": "Deep Learning", "has_scale": False},
}

FLOORS = ["5th_floor", "1st_floor", "4th_floor", "2nd_floor"]
EXPECTED_LENGTHS = {"5th_floor": 187, "1st_floor": 65, "4th_floor": 66, "2nd_floor": 128}


def evaluate_algorithm_floor(
    algo: str,
    floor: str,
    traj: Trajectory,
    ref_traj: Optional[Trajectory] = None,
    legacy_alignment: bool = True,
    max_time_diff: float = 0.5,
    full_diagnostics: bool = True,
) -> Dict:
    """Evaluate one (algorithm, floor) trajectory against the reference."""
    positions = traj.positions
    result: Dict = {
        "algorithm": algo,
        "floor": floor,
        "num_poses": len(traj),
    }

    length = trajectory_length(positions)
    drift = endpoint_drift(positions)
    expected = EXPECTED_LENGTHS.get(floor, 0)
    result.update(
        trajectory_length=length,
        endpoint_drift=drift,
        drift_percent=drift / length * 100 if length > 0 else 0.0,
        expected_length=expected,
        length_ratio=length / expected if expected > 0 else 0.0,
    )

    valid, reason = is_valid_trajectory(positions, expected) if expected else (True, "ok")
    result["valid"] = valid
    result["status"] = reason
    if not valid:
        return result

    if full_diagnostics:
        result["tracking"] = analyze_tracking_quality(traj.timestamps)
        sm = compute_trajectory_smoothness(positions)
        if sm:
            result["smoothness"] = sm
        for delta in (1.0, 5.0, 10.0):
            rpe = compute_rpe(positions, delta=delta)
            if rpe:
                result[f"rpe_{int(delta)}m"] = {
                    k: v for k, v in rpe.items() if k not in ("values", "indices")
                }

    if ref_traj is not None and algo != "lego_loam":
        est_idx, ref_idx = associate_by_time(
            traj.timestamps, ref_traj.timestamps, max_diff=max_time_diff
        )
        if est_idx is not None:
            est_assoc = positions[est_idx]
            ref_assoc = ref_traj.positions[ref_idx]
            use_scale = not ALGORITHMS.get(algo, {}).get("has_scale", True)

            if legacy_alignment:
                aligned, scale = kabsch_sim3_legacy(
                    est_assoc, ref_assoc, use_scale=use_scale
                )
            elif use_scale:
                aligned, scale, _, _ = align_sim3(est_assoc, ref_assoc)
            else:
                aligned, _, _ = align_se3(est_assoc, ref_assoc)
                scale = 1.0

            result["num_matched"] = int(len(est_idx))
            if use_scale:
                result["scale"] = float(scale)
            ate = compute_ate(aligned, ref_assoc)
            result["ate_vs_lego"] = {
                k: v for k, v in ate.items() if k != "errors"
            }
            if full_diagnostics:
                result["segments"] = compute_segment_metrics(aligned, ref_assoc)
                result["error_at_distance"] = compute_error_at_distances(
                    aligned, ref_assoc
                )
                pr = analyze_problem_regions(aligned, ref_assoc, floor)
                if pr:
                    result["problem_regions"] = pr

    paper = PAPER_TABLE_IV.get(algo, {}).get(floor)
    if paper is not None:
        result["paper_ate"] = paper
        if "ate_vs_lego" in result:
            result["vs_paper_ratio"] = (
                result["ate_vs_lego"]["rmse"] / paper if paper > 0 else 0.0
            )
    return result


def run_full_evaluation(
    trajectory_root: str,
    output_path: Optional[str] = None,
    algorithms: Optional[List[str]] = None,
    legacy_alignment: bool = True,
    full_diagnostics: bool = True,
    verbose: bool = True,
) -> Dict:
    """Evaluate every algorithm on every floor against LeGO-LOAM pseudo-GT."""
    algorithms = algorithms or list(ALGORITHMS)

    ref: Dict[str, Trajectory] = {}
    lego = NUFRM3F(trajectory_root, "lego_loam")
    for name, _, t in lego.load():
        ref[name] = t

    results: Dict[str, Dict] = {}
    for algo in algorithms:
        manifest = NUFRM3F(trajectory_root, algo)
        results[algo] = {}
        for name, _, traj in manifest.load():
            r = evaluate_algorithm_floor(
                algo,
                name,
                traj,
                ref.get(name),
                legacy_alignment=legacy_alignment,
                full_diagnostics=full_diagnostics,
            )
            results[algo][name] = r
            if verbose:
                ate = r.get("ate_vs_lego", {}).get("rmse")
                ate_s = f", ATE={ate:.3f}m" if ate is not None else ""
                status = "" if r["valid"] else f"  INVALID: {r['status']}"
                print(
                    f"  {algo}/{name}: {r['num_poses']} poses, "
                    f"{r['trajectory_length']:.1f}m, drift={r['endpoint_drift']:.3f}m"
                    f"{ate_s}{status}"
                )

    if output_path:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        Path(output_path).write_text(json.dumps(_jsonify(results), indent=2))
    if verbose:
        print(summary_tables(results))
    return results


def _jsonify(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    return obj


def summary_tables(results: Dict) -> str:
    """Four summary tables (reference final_eval.py:221-293)."""
    lines: List[str] = []
    bar = "=" * 80

    lines += [bar, "TABLE 1: ENDPOINT DRIFT (meters) - Ours vs Paper", bar]
    for algo in results:
        row = f"{algo:<12} |"
        for floor in FLOORS:
            r = results[algo].get(floor, {})
            if r.get("valid"):
                paper = r.get("paper_ate")
                p = f"{paper:.3f}" if paper else "-"
                row += f" {r['endpoint_drift']:6.3f} / {p:<7} |"
            else:
                row += f" {'FAIL':^16} |"
        lines.append(row)

    lines += ["", bar, "TABLE 2: TRAJECTORY LENGTHS (meters)", bar]
    for algo in results:
        row = f"{algo:<12} |"
        for floor in FLOORS:
            r = results[algo].get(floor, {})
            row += (
                f" {r['trajectory_length']:10.1f}m |"
                if r.get("valid")
                else f" {'FAIL':^12} |"
            )
        lines.append(row)

    lines += ["", bar, "TABLE 3: ATE vs LeGO-LOAM (RMSE in meters)", bar]
    for algo in results:
        if algo == "lego_loam":
            continue
        row = f"{algo:<12} |"
        for floor in FLOORS:
            ate = results[algo].get(floor, {}).get("ate_vs_lego")
            row += f" {ate['rmse']:10.3f}m |" if ate else f" {'-':^12} |"
        lines.append(row)

    lines += ["", bar, "TABLE 4: SCALE FACTORS (Sim3 alignment)", bar]
    for algo in results:
        for floor in FLOORS:
            r = results[algo].get(floor, {})
            if r.get("scale"):
                lines.append(
                    f"  {algo}/{floor}: scale={r['scale']:.4f}, "
                    f"raw_length={r['trajectory_length']:.1f}m"
                )
    return "\n".join(lines)
