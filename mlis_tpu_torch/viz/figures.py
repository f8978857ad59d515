"""Figure generators (host-side matplotlib; Agg backend).

Counterpart of ``mlis_tpu/viz/figures.py``, kept as the port's own copy:
floor-colored top-down views + floor-over-time (floor segmentation),
before/after gating link diagrams, stacked-3D multi-floor views, trajectory
comparison / error figures, the evaluation figures, the self-contained
interactive 3D HTML export, and the helpers of the paper Figure 6
reproduction. Inputs are numpy arrays on the host.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import colors as mcolors  # noqa: E402
from matplotlib.patches import Patch  # noqa: E402


def _floor_colors(floors: np.ndarray) -> Dict[int, tuple]:
    uniq = np.unique(floors)
    cmap = plt.cm.Set1(np.linspace(0, 1, max(len(uniq), 2)))
    return dict(zip(uniq.tolist(), cmap))


def plot_floor_segmentation(
    tum_matrix: np.ndarray,
    floor_labels: np.ndarray,
    path: str | Path,
    title: str = "",
) -> Path:
    """Top-down trajectory colored by floor + floor-over-time step plot."""
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 6))
    colors = _floor_colors(floor_labels)

    for f, c in colors.items():
        m = floor_labels == f
        ax1.scatter(
            tum_matrix[m, 1], tum_matrix[m, 3], s=2, alpha=0.6,
            color=c, label=f"Floor {f}",
        )
    ax1.set_xlabel("X (m)")
    ax1.set_ylabel("Z (m)")
    ax1.set_title(f"{title} trajectory (top-down)".strip())
    ax1.legend(loc="best", markerscale=4)
    ax1.set_aspect("equal")
    ax1.grid(alpha=0.3)

    t = tum_matrix[:, 0] - tum_matrix[0, 0]
    ax2.step(t, floor_labels, where="post", linewidth=1.5)
    ax2.set_xlabel("Time (s)")
    ax2.set_ylabel("Floor")
    ax2.set_yticks(sorted(colors))
    ax2.set_title("Floor label over time")
    ax2.grid(alpha=0.3)

    fig.tight_layout()
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_loop_closure_gating(
    tum_matrix: np.ndarray,
    floor_labels: np.ndarray,
    candidate_pairs: Sequence[Tuple[int, int]],
    path: str | Path,
    title: str = "",
    max_links: int = 200,
) -> Path:
    """Before/after gating link diagram: green same-floor, red cross-floor."""
    pos = tum_matrix[:, 1:4]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 6))
    for ax in (ax1, ax2):
        ax.scatter(pos[:, 0], pos[:, 2], c="lightgray", s=1, alpha=0.5)
        ax.set_xlabel("X (m)")
        ax.set_ylabel("Z (m)")
        ax.set_aspect("equal")
        ax.grid(alpha=0.3)

    shown = list(candidate_pairs)[:max_links]
    n_valid = 0
    for q, m in shown:
        same = floor_labels[q] == floor_labels[m]
        xs = [pos[q, 0], pos[m, 0]]
        zs = [pos[q, 2], pos[m, 2]]
        if same:
            ax1.plot(xs, zs, "g-", alpha=0.3, linewidth=0.5)
            ax2.plot(xs, zs, "g-", alpha=0.4, linewidth=0.5)
            n_valid += 1
        else:
            ax1.plot(xs, zs, "r-", alpha=0.5, linewidth=1.0)

    ax1.legend(
        handles=[
            Patch(facecolor="green", alpha=0.5, label="Same-floor (valid)"),
            Patch(facecolor="red", alpha=0.5, label="Cross-floor (rejected)"),
        ],
        loc="best",
    )
    ax1.set_title(f"{title} before gating ({len(shown)} shown)".strip())
    ax2.set_title(f"After floor gating ({n_valid} valid shown)")
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_multifloor_3d(
    tum_matrix: np.ndarray,
    floor_labels: np.ndarray,
    path: str | Path,
    title: str = "",
    floor_height: float = 5.0,
    link_pairs: Optional[Sequence[Tuple[int, int]]] = None,
) -> Path:
    """3D view with floors separated by height; optional loop-closure edges
    (the paper Figure-6 style perceptual-aliasing view)."""
    fig = plt.figure(figsize=(12, 10))
    ax = fig.add_subplot(111, projection="3d")
    colors = _floor_colors(floor_labels)
    min_floor = min(colors)

    z_of = (floor_labels - min_floor) * floor_height
    for f, c in colors.items():
        m = floor_labels == f
        ax.plot(
            tum_matrix[m, 1], tum_matrix[m, 3], z_of[m],
            color=c, linewidth=1.2, label=f"Floor {f}",
        )
    if link_pairs is not None:
        for q, mI in list(link_pairs)[:100]:
            same = floor_labels[q] == floor_labels[mI]
            ax.plot(
                [tum_matrix[q, 1], tum_matrix[mI, 1]],
                [tum_matrix[q, 3], tum_matrix[mI, 3]],
                [z_of[q], z_of[mI]],
                color="green" if same else "red",
                alpha=0.4,
                linewidth=0.8,
            )
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.set_zlabel("Height (m)")
    ax.set_title(f"{title} multi-floor trajectory".strip())
    ax.legend(loc="upper left")
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_trajectory_comparison(
    trajectories: Dict[str, np.ndarray],  # name -> (N, 3) aligned positions
    path: str | Path,
    title: str = "Trajectory comparison",
) -> Path:
    """Figure-7 style overlaid top-down comparison of aligned trajectories."""
    fig, ax = plt.subplots(figsize=(10, 8))
    for name, pos in trajectories.items():
        ax.plot(pos[:, 0], pos[:, 1], linewidth=1.2, label=name, alpha=0.8)
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.set_title(title)
    ax.legend()
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_error_accumulation(
    errors_by_algo: Dict[str, np.ndarray],  # name -> per-pose ATE errors
    path: str | Path,
) -> Path:
    fig, ax = plt.subplots(figsize=(10, 6))
    for name, errors in errors_by_algo.items():
        ax.plot(np.asarray(errors), linewidth=1.0, label=name, alpha=0.8)
    ax.set_xlabel("Pose index")
    ax.set_ylabel("ATE (m)")
    ax.set_title("Error accumulation along trajectory")
    ax.legend()
    ax.grid(alpha=0.3)
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_segment_heatmap(
    segment_rmse: Dict[str, List[float]],  # algo -> per-segment RMSE
    path: str | Path,
) -> Path:
    algos = list(segment_rmse)
    data = np.asarray([segment_rmse[a] for a in algos])
    fig, ax = plt.subplots(figsize=(10, 0.6 * len(algos) + 2))
    im = ax.imshow(data, aspect="auto", cmap="viridis")
    ax.set_yticks(range(len(algos)), algos)
    ax.set_xlabel("Trajectory segment")
    ax.set_title("Segment-wise ATE RMSE (m)")
    fig.colorbar(im, ax=ax)
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_rpe_boxplot(
    results: Dict[str, Dict],  # comprehensive-eval results[algo][floor]
    path: str | Path,
    rpe_key: str = "rpe_1m",
) -> Path:
    """RPE distribution box plot across floors per algorithm (reference
    evaluation/generate_figures.py:323-361)."""
    data, labels = [], []
    for algo, floors in results.items():
        vals = [
            r[rpe_key]["rmse"]
            for r in floors.values()
            if isinstance(r, dict) and rpe_key in r
        ]
        if vals:
            data.append(vals)
            labels.append(algo)
    fig, ax = plt.subplots(figsize=(10, 6))
    if data:
        bp = ax.boxplot(data, tick_labels=labels, patch_artist=True)
        cmap = plt.cm.Set2(np.linspace(0, 1, max(len(data), 2)))
        for patch, c in zip(bp["boxes"], cmap):
            patch.set_facecolor(c)
            patch.set_alpha(0.7)
    ax.set_ylabel(f"RPE RMSE ({rpe_key.split('_')[1]} segments)")
    ax.set_title("Relative pose error distribution across all floors")
    ax.grid(True, alpha=0.3, axis="y")
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_paper_comparison(
    results: Dict[str, Dict],  # comprehensive-eval results[algo][floor]
    path: str | Path,
) -> Path:
    """Ours-vs-paper endpoint-drift bars, one panel per floor (reference
    evaluation/generate_figures.py:265-317; paper values ride in each
    result's `paper_ate` field from Table IV)."""
    floors: List[str] = []
    for fl_map in results.values():
        for fl in fl_map:
            if fl not in floors:
                floors.append(fl)
    ncols = 2
    nrows = max((len(floors) + 1) // 2, 1)
    fig, axes = plt.subplots(nrows, ncols, figsize=(7 * ncols, 5 * nrows))
    axes = np.atleast_1d(axes).flatten()
    algos = list(results)
    x = np.arange(len(algos))
    width = 0.35
    for idx, floor in enumerate(floors):
        ax = axes[idx]
        ours = [
            results[a].get(floor, {}).get("endpoint_drift", 0.0) for a in algos
        ]
        paper = [
            results[a].get(floor, {}).get("paper_ate") or 0.0 for a in algos
        ]
        ax.bar(x - width / 2, ours, width, label="Ours", color="steelblue")
        ax.bar(x + width / 2, paper, width, label="Paper", color="coral")
        ax.set_ylabel("Endpoint drift (m)")
        ax.set_title(floor.replace("_", " ").title())
        ax.set_xticks(x)
        ax.set_xticklabels(algos, rotation=45, ha="right")
        ax.legend()
        ax.grid(True, alpha=0.3, axis="y")
    for ax in axes[len(floors):]:
        ax.axis("off")
    fig.suptitle("Endpoint drift: our results vs paper", fontweight="bold")
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_all_floors_overview(
    trajectories: Dict[str, np.ndarray],  # floor name -> TUM matrix (N, >=4)
    path: str | Path,
    algo_label: str = "LeGO-LOAM",
    paper_values: Optional[Dict[str, Dict[str, float]]] = None,
) -> Path:
    """Per-floor top-down grid in the paper Figure-7 orientation (x -> -x,
    z forward), with start/end markers and length/drift vs paper stats in
    the titles (reference visualization/plot_all_floors.py)."""
    floors = list(trajectories)
    ncols = 2
    nrows = max((len(floors) + 1) // 2, 1)
    fig, axes = plt.subplots(nrows, ncols, figsize=(7 * ncols, 7 * nrows))
    axes = np.atleast_1d(axes).flatten()
    cmap = plt.cm.tab10(np.linspace(0, 1, max(len(floors), 2)))
    for idx, floor in enumerate(floors):
        ax = axes[idx]
        tum = trajectories[floor]
        if tum is None or len(tum) < 2:
            ax.text(0.5, 0.5, f"{floor}\n(no data)", ha="center", va="center",
                    transform=ax.transAxes)
            continue
        x = -tum[:, 1]  # paper orientation
        z = tum[:, 3]
        ax.plot(x, z, color=cmap[idx], linewidth=1.5, label=algo_label)
        ax.plot(x[0], z[0], "go", markersize=8, label="Start")
        ax.plot(x[-1], z[-1], "ro", markersize=8, label="End")
        length = float(np.linalg.norm(np.diff(tum[:, 1:4], axis=0), axis=1).sum())
        drift = float(np.linalg.norm(tum[-1, 1:4] - tum[0, 1:4]))
        title = f"{floor.replace('_', ' ').title()}\nL={length:.0f}m"
        pv = (paper_values or {}).get(floor)
        if pv:
            title += f" (paper: {pv.get('length_m', '?')}m)"
        title += f", drift={drift:.2f}m"
        if pv and "ate_m" in pv:
            title += f" (paper: {pv['ate_m']}m)"
        ax.set_title(title, fontsize=10)
        ax.set_xlabel("x (m)")
        ax.set_ylabel("z (m)")
        ax.axis("equal")
        ax.grid(True, alpha=0.3)
        if idx == 0:
            ax.legend(loc="best", fontsize=8)
    for ax in axes[len(floors):]:
        ax.axis("off")
    fig.suptitle(f"{algo_label} trajectories — all floors", fontweight="bold")
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def segment_by_floor_height(
    positions: np.ndarray,  # (N, 3)
    floor_heights: Dict[str, float],
    tolerance: float = 2.0,
) -> Dict[str, np.ndarray]:
    """Height-threshold floor segmentation: index masks per named floor
    (reference visualization/generate_paper_figures.py:56-82)."""
    z = positions[:, 2]
    return {
        name: np.abs(z - h) < tolerance
        for name, h in floor_heights.items()
        if bool(np.any(np.abs(z - h) < tolerance))
    }


def detect_loop_closure_events(
    positions_with_lc: np.ndarray,
    positions_no_lc: np.ndarray,
    jump_threshold: float = 5.0,
    proximity: float = 3.0,
    min_index_gap: int = 100,
) -> List[Tuple[int, int]]:
    """Infer loop-closure constraints from an LC/no-LC trajectory pair:
    discontinuities in the with-vs-without difference mark correction
    events; temporally distant poses pulled within `proximity` of the jump
    are the (mis)matched pairs (reference generate_paper_figures.py:85-122,
    vectorized)."""
    if len(positions_with_lc) != len(positions_no_lc):
        return []
    diff = np.linalg.norm(positions_with_lc - positions_no_lc, axis=1)
    jumps = np.where(np.abs(np.gradient(diff)) > jump_threshold)[0]
    events: List[Tuple[int, int]] = []
    n = len(positions_with_lc)
    for j in jumps:
        d = np.linalg.norm(positions_with_lc - positions_with_lc[j], axis=1)
        close_but_far = np.where(
            (d < proximity) & (np.abs(np.arange(n) - j) > min_index_gap)
        )[0]
        events.extend((int(j), int(m)) for m in close_but_far)
    return events


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>body{margin:0;background:#111;color:#ddd;font-family:sans-serif}
#c{display:block;cursor:grab}#hud{position:fixed;top:8px;left:10px;font-size:13px}
.sw{display:inline-block;width:10px;height:10px;margin-right:4px;border-radius:2px}
</style></head><body>
<canvas id="c"></canvas><div id="hud"><b>__TITLE__</b> — drag to rotate,
wheel to zoom<div id="legend"></div></div>
<script>
const DATA=__DATA__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let rx=-1.0,rz=0.6,zoom=1,cx=0,cy=0;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw()}
addEventListener('resize',resize);
let drag=null;
cv.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 rz+=(e.clientX-drag[0])*0.01;rx+=(e.clientY-drag[1])*0.01;
 drag=[e.clientX,e.clientY];draw()});
cv.addEventListener('wheel',e=>{e.preventDefault();
 zoom*=Math.exp(-e.deltaY*0.001);draw()});
function proj(p){
 const cz=Math.cos(rz),sz=Math.sin(rz),cxr=Math.cos(rx),sxr=Math.sin(rx);
 const x=p[0]*cz-p[1]*sz,y=p[0]*sz+p[1]*cz;
 const y2=y*cxr-p[2]*sxr,z2=y*sxr+p[2]*cxr;
 return[cv.width/2+ (x-cx)*zoom*DATA.scale, cv.height/2+ (y2-cy)*zoom*DATA.scale, z2];}
function draw(){
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 for(const seg of DATA.segments){
  ctx.strokeStyle=seg.color;ctx.lineWidth=1.4;ctx.beginPath();
  let first=true;
  for(const p of seg.points){const q=proj(p);
   if(first){ctx.moveTo(q[0],q[1]);first=false}else ctx.lineTo(q[0],q[1]);}
  ctx.stroke();}
 for(const l of DATA.links){
  ctx.strokeStyle=l.valid?'rgba(60,220,60,0.5)':'rgba(240,60,60,0.6)';
  ctx.lineWidth=1;ctx.beginPath();
  const a=proj(l.a),b=proj(l.b);ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);
  ctx.stroke();}}
const lg=document.getElementById('legend');
lg.innerHTML=DATA.segments.map(s=>'<div><span class="sw" style="background:'+
 s.color+'"></span>'+s.name+'</div>').join('');
resize();
</script></body></html>
"""


def export_interactive_3d_html(
    tum_matrix: np.ndarray,
    floor_labels: np.ndarray,
    path: str | Path,
    title: str = "Multi-floor trajectory",
    floor_height: float = 5.0,
    link_pairs: Optional[Sequence[Tuple[int, int]]] = None,
    max_points_per_floor: int = 4000,
) -> Path:
    """Self-contained interactive 3D HTML (drag-rotate / wheel-zoom canvas
    renderer, trajectory data embedded as JSON). Replaces the reference's
    plotly-gated interactive export (visualization/generate_figures.py:27-32
    skips silently without plotly; this needs no dependencies at all)."""
    import json as _json

    colors = _floor_colors(floor_labels)
    min_floor = min(colors)
    hexes = {f: mcolors.to_hex(c) for f, c in colors.items()}
    z_of = (np.asarray(floor_labels) - min_floor) * floor_height
    segments = []
    for f in sorted(colors):
        m = np.asarray(floor_labels) == f
        pts = np.column_stack(
            [tum_matrix[m, 1], tum_matrix[m, 3], z_of[m]]
        )
        if len(pts) > max_points_per_floor:
            pts = pts[:: int(np.ceil(len(pts) / max_points_per_floor))]
        segments.append(
            {
                "name": f"Floor {f}",
                "color": hexes[f],
                "points": np.round(pts, 3).tolist(),
            }
        )
    links = []
    if link_pairs is not None:
        fl = np.asarray(floor_labels)
        for q, mI in list(link_pairs)[:500]:
            links.append(
                {
                    "a": [
                        float(tum_matrix[q, 1]),
                        float(tum_matrix[q, 3]),
                        float(z_of[q]),
                    ],
                    "b": [
                        float(tum_matrix[mI, 1]),
                        float(tum_matrix[mI, 3]),
                        float(z_of[mI]),
                    ],
                    "valid": bool(fl[q] == fl[mI]),
                }
            )
    span = float(
        np.max(np.ptp(tum_matrix[:, 1:4], axis=0)) or 1.0
    )
    data = {"segments": segments, "links": links, "scale": 500.0 / span}
    html = _HTML_TEMPLATE.replace("__TITLE__", title).replace(
        "__DATA__", _json.dumps(data)
    )
    path = Path(path)
    path.write_text(html)
    return path


def plot_elevator_detection(
    timestamps: np.ndarray,
    accel_z: np.ndarray,
    events,  # sequence of ElevatorEvent (gating/floor_detector.py)
    path: str | Path,
    title: str = "IMU elevator detection",
) -> Path:
    """Z-acceleration trace with detected elevator rides shaded and
    direction-annotated (the reference's transit diagnostic figure,
    semantic/extract_imu_transit.py plot_elevator_detection)."""
    t = np.asarray(timestamps, dtype=np.float64)
    t_rel = t - t[0]
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.plot(t_rel, np.asarray(accel_z), linewidth=0.6, color="tab:blue",
            label="accel z")
    for ev in events:
        a, b = ev.start_time - t[0], ev.end_time - t[0]
        up = ev.direction == "up"
        ax.axvspan(a, b, alpha=0.25, color="tab:green" if up else "tab:red")
        ax.annotate(
            ("↑" if up else "↓") + f" {ev.duration:.1f}s",
            xy=((a + b) / 2, ax.get_ylim()[1]),
            ha="center", va="top", fontsize=10,
        )
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Linear acceleration z (m/s²)")
    ax.set_title(f"{title} — {len(events)} event(s)")
    ax.legend(
        handles=[
            Patch(facecolor="tab:green", alpha=0.4, label="Elevator up"),
            Patch(facecolor="tab:red", alpha=0.4, label="Elevator down"),
        ]
        + ax.get_legend_handles_labels()[0],
        loc="lower right",
    )
    ax.grid(alpha=0.3)
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_rejection_rates(
    rates: Dict[str, float],  # algo -> cross-floor rejection rate
    path: str | Path,
) -> Path:
    fig, ax = plt.subplots(figsize=(8, 5))
    names = list(rates)
    vals = [100 * rates[n] for n in names]
    ax.bar(names, vals, color="tab:red", alpha=0.8)
    for i, v in enumerate(vals):
        ax.text(i, v + 1, f"{v:.1f}%", ha="center")
    ax.set_ylabel("Cross-floor candidates rejected (%)")
    ax.set_title("Semantic gating rejection rates")
    ax.set_ylim(0, 100)
    ax.grid(axis="y", alpha=0.3)
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_pgo_comparison(
    gt_t: np.ndarray,  # (N, 3) ground-truth positions
    variants: Dict[str, np.ndarray],  # name -> (N, 3) optimized positions
    floor_labels: np.ndarray,
    path: str | Path,
) -> Path:
    """Side-by-side 3D views of pose-graph results (opt/demo.py): ground
    truth vs each optimization variant (odometry-only / gated / ungated),
    colored by floor. The visual counterpart of the gate's trajectory-
    level ATE claim."""
    n = len(variants)
    fig = plt.figure(figsize=(5 * (n + 1), 5))
    colors = _floor_colors(floor_labels)

    def draw(ax, pts, title):
        for f, c in colors.items():
            m = floor_labels == f
            ax.plot(pts[m, 0], pts[m, 1], pts[m, 2], ".", ms=2, color=c,
                    label=f"floor {f}")
        ax.set_title(title)
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_zlabel("z [m]")

    ax = fig.add_subplot(1, n + 1, 1, projection="3d")
    draw(ax, np.asarray(gt_t), "ground truth")
    ax.legend(loc="upper left", fontsize=8)
    for k, (name, pts) in enumerate(variants.items()):
        ax = fig.add_subplot(1, n + 1, k + 2, projection="3d")
        err = np.linalg.norm(np.asarray(pts) - np.asarray(gt_t), axis=1)
        rmse = float(np.sqrt((err**2).mean()))
        draw(ax, np.asarray(pts), f"{name} (ATE {rmse:.2f} m)")
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_training_curves(
    log_path: str | Path,
    path: str | Path,
    title: Optional[str] = None,
) -> Path:
    """Loss + held-out recall/precision curves from a pretraining log
    JSON (the `<checkpoint>_log.json` files train/driver.py writes next
    to every shipped checkpoint) — the observability artifact for the
    in-env-trained weights."""
    import json

    log_path = Path(log_path)
    hist = json.loads(log_path.read_text())
    loss = np.asarray(hist.get("loss", []), np.float64)
    evals = np.asarray(hist.get("eval", []), np.float64)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    if len(loss):
        ax1.plot(loss[:, 0], loss[:, 1], lw=1.2)
        ax1.set_yscale("log")
    ax1.set_xlabel("step")
    ax1.set_ylabel("mean chunk loss")
    ax1.set_title("training loss")
    ax1.grid(alpha=0.3)
    if len(evals):
        ax2.plot(evals[:, 0], evals[:, 1], "-o", ms=3, label="recall")
        if evals.shape[1] > 2:
            ax2.plot(evals[:, 0], evals[:, 2], "-s", ms=3, label="precision")
        ax2.set_ylim(0, 1.02)
        ax2.legend()
    ax2.set_xlabel("step")
    ax2.set_ylabel("held-out metric")
    ax2.set_title("held-out homography matching")
    ax2.grid(alpha=0.3)
    fig.suptitle(title or log_path.stem.replace("_log", ""))
    fig.tight_layout()
    path = Path(path)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path
