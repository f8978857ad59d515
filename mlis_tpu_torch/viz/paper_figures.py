"""Paper figure reproductions (Kaveti et al. CASE 2023 Figures 6 & 7).

Counterpart of ``mlis_tpu/viz/paper_figures.py`` over the port's
``core``, ``eval.alignment``, ``eval.association`` and
``ops.pairwise.candidate_pairs_host``.

Figure 6: perceptual-aliasing view, the multi-floor trajectory in 3D with
loop-closure candidate edges, green same-floor vs red cross-floor.

Figure 7: timestamp-associated, Umeyama-aligned 5th-floor trajectory
comparison against the LeGO-LOAM pseudo-ground-truth.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from mlis_tpu_torch.core.dataset import NUFRM3F, TRANSIT_FLOORS
from mlis_tpu_torch.core.trajectory import combine_sequences
from mlis_tpu_torch.eval.alignment import align_se3, align_sim3
from mlis_tpu_torch.eval.association import associate_by_time
from mlis_tpu_torch.ops.pairwise import candidate_pairs_host
from mlis_tpu_torch.viz.figures import plot_multifloor_3d, plot_trajectory_comparison


def generate_figure6(
    trajectory_root: str,
    output_path: str,
    algorithm: str = "orb_slam3",
    max_edges: int = 100,
    sample_poses: int = 4000,
) -> Path:
    """3D multi-floor trajectory with gated loop-closure edges."""
    manifest = NUFRM3F(trajectory_root, algorithm)
    combined, floors = combine_sequences(manifest.load(), TRANSIT_FLOORS)

    # subsample for edge search (figure needs examples, not the full set)
    step = max(len(combined) // sample_poses, 1)
    sub = combined[::step]
    sub_floors = floors[::step]
    qi, mi, _ = candidate_pairs_host(
        sub[:, 1:4], sub_floors, radius=2.0, min_gap=max(100 // step, 2)
    )
    if len(qi) > max_edges:
        sel = np.linspace(0, len(qi) - 1, max_edges).astype(int)
        qi, mi = qi[sel], mi[sel]

    return plot_multifloor_3d(
        sub,
        sub_floors,
        output_path,
        title=f"Figure 6 — {algorithm}",
        link_pairs=list(zip(qi, mi)),
    )


DEFAULT_FLOOR_HEIGHTS = {
    "1st_floor": 0.0,
    "2nd_floor": 4.5,
    "3rd_floor": 9.0,
    "4th_floor": 13.5,
    "5th_floor": 18.0,
}


def generate_figure6_lc_pair(
    positions_no_lc: np.ndarray,  # (N, 3)
    positions_with_lc: Optional[np.ndarray],  # (N, 3) or None
    output_path: str,
    floor_heights: Optional[Dict[str, float]] = None,
    jump_threshold: float = 5.0,
) -> Path:
    """Figure 6 as the LC/no-LC trajectory PAIR (reference
    generate_paper_figures.py:125-232): panel (a) the loop-closure-free
    trajectory with floors correctly stacked, panel (b) the with-LC
    trajectory where perceptual aliasing merged floors, with the inferred
    incorrect loop-closure constraints drawn in green.

    Floor segmentation is height-threshold based and the constraints come
    from the LC/no-LC divergence detector (viz/figures.py)."""
    import matplotlib.pyplot as plt

    from mlis_tpu_torch.viz.figures import (
        detect_loop_closure_events,
        segment_by_floor_height,
    )

    heights = floor_heights or DEFAULT_FLOOR_HEIGHTS
    has_pair = positions_with_lc is not None
    ncols = 2 if has_pair else 1
    fig, axes = plt.subplots(
        1, ncols, figsize=(8 * ncols, 8), subplot_kw={"projection": "3d"}
    )
    axes = np.atleast_1d(axes)
    cmap = plt.cm.tab10(np.linspace(0, 1, max(len(heights), 2)))
    colors = dict(zip(sorted(heights), cmap))

    span = np.ptp(positions_no_lc, axis=0).max() / 2.0
    mid = (positions_no_lc.max(axis=0) + positions_no_lc.min(axis=0)) / 2.0

    def draw(ax, positions, title):
        for name, mask in segment_by_floor_height(positions, heights).items():
            p = positions[mask]
            ax.plot(
                p[:, 0], p[:, 1], p[:, 2],
                color=colors.get(name, "#333333"),
                label=name.replace("_", " "), linewidth=1.5, alpha=0.8,
            )
        ax.set_xlabel("X (m)")
        ax.set_ylabel("Y (m)")
        ax.set_zlabel("Z (m)")
        ax.set_title(title, fontweight="bold")
        ax.set_xlim(mid[0] - span, mid[0] + span)
        ax.set_ylim(mid[1] - span, mid[1] + span)
        ax.set_zlim(mid[2] - span, mid[2] + span)
        ax.view_init(elev=25, azim=-60)
        ax.legend(loc="upper left", fontsize=9)

    draw(axes[0], positions_no_lc, "(a) Without Loop Closure")
    if has_pair:
        ax = axes[1]
        draw(ax, positions_with_lc, "(b) With Loop Closure (Perceptual Aliasing)")
        events = detect_loop_closure_events(
            positions_with_lc, positions_no_lc, jump_threshold=jump_threshold
        )
        for i, j in events[:200]:
            ax.plot(
                [positions_with_lc[i, 0], positions_with_lc[j, 0]],
                [positions_with_lc[i, 1], positions_with_lc[j, 1]],
                [positions_with_lc[i, 2], positions_with_lc[j, 2]],
                "g-", linewidth=2, alpha=0.7,
            )
        if events:
            ax.plot([], [], "g-", linewidth=2, label="Incorrect Loop Closures")
            ax.legend(loc="upper left", fontsize=9)

    fig.tight_layout()
    out = Path(output_path)
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out


def generate_figure7(
    trajectory_root: str,
    output_path: str,
    floor: str = "5th_floor",
) -> Optional[Path]:
    """Aligned trajectory comparison on one floor vs LeGO-LOAM."""
    lego = NUFRM3F(trajectory_root, "lego_loam")
    ref = {name: t for name, _, t in lego.load()}
    if floor not in ref:
        return None
    ref_traj = ref[floor]

    curves: Dict[str, np.ndarray] = {"LeGO-LOAM": ref_traj.positions[:, :2]}
    for algo, use_scale in (("orb_slam3", False), ("droid_slam", True)):
        manifest = NUFRM3F(trajectory_root, algo)
        found = {name: t for name, _, t in manifest.load()}
        if floor not in found:
            continue
        est = found[floor]
        ei, ri = associate_by_time(est.timestamps, ref_traj.timestamps, max_diff=0.1)
        if ei is None:
            continue
        src = est.positions[ei]
        tgt = ref_traj.positions[ri]
        if use_scale:
            _, s, R, t = align_sim3(src, tgt)
            aligned = s * est.positions @ R.T + t
        else:
            _, R, t = align_se3(src, tgt)
            aligned = est.positions @ R.T + t
        curves[algo] = aligned[:, :2]

    return plot_trajectory_comparison(
        curves, output_path, title=f"Figure 7 — {floor} comparison"
    )
