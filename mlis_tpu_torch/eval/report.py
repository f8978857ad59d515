"""Published-artifact writers: the Table IV CSV and the benchmark summary
markdown, generated from the evaluation results dict
(``eval/comprehensive.run_full_evaluation``) and the gating comparison
(``gating/integration.run_comparison``).

Counterpart of ``mlis_tpu/eval/report.py``, kept as the port's own copy.
The layouts mirror the reference's results/metrics/table_iv.csv column
schema and the sections of its BENCHMARK_RESULTS_SUMMARY.md.
"""

from __future__ import annotations

import datetime
from pathlib import Path
from typing import Dict, Optional

from mlis_tpu_torch.eval.comprehensive import EXPECTED_LENGTHS, FLOORS


def write_table_iv_csv(eval_results: Dict, path) -> str:
    """Per-(algorithm, floor) drift/length/pose CSV with the paper's
    Table IV ATE column (reference results/metrics/table_iv.csv schema)."""
    lines = ["Algorithm,Floor,Drift_m,Drift_pct,Length_m,Poses,Paper_ATE_m"]
    for algo, floors in eval_results.items():
        for floor in FLOORS:
            r = floors.get(floor)
            if not r:
                continue
            paper = r.get("paper_ate")
            lines.append(
                f"{algo},{floor},{r['endpoint_drift']:.4f},"
                f"{r['drift_percent']:.4f},{r['trajectory_length']:.2f},"
                f"{r['num_poses']},"
                + (f"{paper}" if paper is not None else "")
            )
    text = "\n".join(lines) + "\n"
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(text)
    return text


def _algo_status(floors: Dict) -> str:
    valid = [r.get("valid", False) for r in floors.values()]
    if not valid:
        return "no data"
    if all(valid):
        return "complete"
    if any(valid):
        return "partial"
    return "failed"


def _key_stat(algo: str, floors: Dict) -> str:
    """One data-driven headline per algorithm."""
    import numpy as np

    ates = [
        r["ate_vs_lego"]["rmse"]
        for r in floors.values()
        if r.get("valid") and "ate_vs_lego" in r
    ]
    scales = [r["scale"] for r in floors.values() if r.get("scale")]
    if scales:
        s = float(np.mean(scales))
        extra = f", consistent {s:.2f}x Sim(3) scale" if np.std(scales) < 0.1 else ""
        if ates:
            return f"mean ATE {float(np.mean(ates)):.2f} m{extra}"
        return f"scale {s:.2f}x"
    if algo == "lego_loam":
        r5 = floors.get("5th_floor", {})
        if r5.get("valid"):
            return (
                f"5th-floor length {r5['trajectory_length']:.1f} m vs "
                f"{EXPECTED_LENGTHS['5th_floor']} m expected (pseudo-GT)"
            )
    if ates:
        return f"mean ATE {float(np.mean(ates)):.2f} m"
    failed = [f for f, r in floors.items() if not r.get("valid")]
    if failed:
        return "diverged on " + ", ".join(sorted(failed))
    return "-"


def benchmark_summary_md(
    eval_results: Dict,
    gating_results: Optional[Dict] = None,
    date: Optional[str] = None,
) -> str:
    """Generate the BENCHMARK_RESULTS_SUMMARY.md content from evaluation +
    gating outputs (the reference's hand-written summary, reproduced as a
    generated artifact)."""
    from mlis_tpu_torch.eval.comprehensive import ALGORITHMS

    date = date or datetime.date.today().isoformat()
    L = []
    L += [
        "# SLAM Benchmarking Results Summary (mlis_tpu_torch)",
        "",
        f"**Date:** {date}",
        "**Dataset:** NUFR-M3F (Kaveti et al., IEEE CASE 2023), ISEC building",
        "**Generated by:** `mlis_tpu_torch.eval.report.write_benchmark_summary` "
        "— gating analysis and trajectory evaluation from the published "
        "reference trajectories.",
        "",
        "## Executive summary",
        "",
        "| Algorithm | Type | Status | Headline |",
        "|---|---|---|---|",
    ]
    for algo, floors in eval_results.items():
        typ = ALGORITHMS.get(algo, {}).get("type", "?")
        L.append(
            f"| {algo} | {typ} | {_algo_status(floors)} | "
            f"{_key_stat(algo, floors)} |"
        )
    L += ["", "## Table 1 — Endpoint drift (m), ours / paper Table IV", ""]
    L.append("| Algorithm | " + " | ".join(FLOORS) + " |")
    L.append("|---|" + "---|" * len(FLOORS))
    for algo, floors in eval_results.items():
        cells = []
        for floor in FLOORS:
            r = floors.get(floor, {})
            if r.get("valid"):
                p = r.get("paper_ate")
                cells.append(
                    f"{r['endpoint_drift']:.3f} / "
                    + (f"{p:.3f}" if p else "-")
                )
            else:
                cells.append("FAIL" if r else "-")
        L.append(f"| {algo} | " + " | ".join(cells) + " |")

    L += ["", "## Table 2 — Trajectory lengths (m)", ""]
    L.append(
        "| Algorithm | "
        + " | ".join(f"{f} (exp {EXPECTED_LENGTHS[f]} m)" for f in FLOORS)
        + " |"
    )
    L.append("|---|" + "---|" * len(FLOORS))
    for algo, floors in eval_results.items():
        cells = []
        for floor in FLOORS:
            r = floors.get(floor, {})
            cells.append(
                f"{r['trajectory_length']:.1f}" if r.get("valid")
                else ("FAIL" if r else "-")
            )
        L.append(f"| {algo} | " + " | ".join(cells) + " |")

    L += ["", "## Table 3 — ATE RMSE vs LeGO-LOAM pseudo-GT (m)", ""]
    L.append("| Algorithm | " + " | ".join(FLOORS) + " | mean |")
    L.append("|---|" + "---|" * (len(FLOORS) + 1))
    for algo, floors in eval_results.items():
        if algo == "lego_loam":
            continue
        vals = []
        cells = []
        for floor in FLOORS:
            ate = floors.get(floor, {}).get("ate_vs_lego")
            if ate:
                vals.append(ate["rmse"])
                cells.append(f"{ate['rmse']:.3f}")
            else:
                cells.append("-")
        mean = f"{sum(vals)/len(vals):.2f}" if vals else "-"
        L.append(f"| {algo} | " + " | ".join(cells) + f" | {mean} |")

    scale_rows = [
        (algo, floor, r["scale"], r["trajectory_length"])
        for algo, floors in eval_results.items()
        for floor, r in floors.items()
        if r.get("scale")
    ]
    if scale_rows:
        L += ["", "## Table 4 — Sim(3) scale factors", ""]
        L.append("| Algorithm | Floor | Scale | Raw length (m) | Scaled (m) |")
        L.append("|---|---|---|---|---|")
        for algo, floor, s, ln in scale_rows:
            L.append(
                f"| {algo} | {floor} | {s:.4f} | {ln:.1f} | {s * ln:.1f} |"
            )

    if gating_results:
        L += [
            "",
            "## Semantic gating — cross-floor loop-closure rejection",
            "",
            "Exact float64 candidate sweep (2 m radius, 100-index gap) + "
            "strict floor gate over the combined multi-floor trajectories "
            "(per-algorithm analyses under `semantic_gating/`):",
            "",
            "| Algorithm | Candidates | Same-floor (kept) | Cross-floor "
            "(rejected) | Rejection rate |",
            "|---|---|---|---|---|",
        ]
        for algo, a in gating_results.items():
            L.append(
                f"| {algo} | {a.total_candidates:,} | "
                f"{a.same_floor_candidates:,} | {a.cross_floor_candidates:,} | "
                f"{a.cross_floor_rate:.1%} |"
            )
        L += [
            "",
            "Without the gate every cross-floor candidate is a perceptual-"
            "aliasing false loop closure fed to the pose graph; the gate "
            "removes them at floor-label-compare cost before any matcher "
            "work (reference claim reproduced with integer-exact counts "
            "where its shipped data is self-consistent).",
        ]
    L += [""]
    return "\n".join(L)


def write_benchmark_summary(
    eval_results: Dict,
    gating_results: Optional[Dict],
    path,
    date: Optional[str] = None,
) -> str:
    text = benchmark_summary_md(eval_results, gating_results, date=date)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(text)
    return text
