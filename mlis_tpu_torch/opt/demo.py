"""Trajectory-level demonstration of the semantic gate's value.

Counterpart of ``mlis_tpu/opt/demo.py``. Cross-floor loop closures corrupt
the pose graph of a multi-level building, and semantic gating prevents
it:

  multi-floor GT trajectory with drift
    -> loop-closure candidates (true revisits + cross-floor aliases)
    -> SemanticLoopClosureGate.gate_batch
    -> ContextualPriorFactor.floor_priors + elevator dz factors
    -> opt/pose_graph.optimize_pose_graph (Gauss-Newton on the device)
    -> ATE against ground truth (eval/metrics.compute_ate)

Six solves on the same odometry: odometry only, gated closures, ungated
closures (the aliased cross-floor pairs included, as a gate-less system
would), Switchable Constraints and GNC on every candidate, and a plain
solve on the PCM-filtered set. The contract: ate(gated) <
ate(odometry-only) << ate(ungated).

The draws come from ``np.random.default_rng``, as in the JAX package, so
both packages see the same scene, noise and candidates.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from mlis_tpu_torch.eval.metrics import compute_ate
from mlis_tpu_torch.gating.gate import ContextualPriorFactor, SemanticLoopClosureGate
from mlis_tpu_torch.opt.lie import se3_compose, se3_exp, se3_inv, so3_exp
from mlis_tpu_torch.opt.pcm import pcm_filter
from mlis_tpu_torch.opt.pose_graph import (
    build_factors,
    optimize_pose_graph,
    optimize_pose_graph_gnc,
)


def _rect_path(cx: float, cy: float, w: float, h: float, step: float):
    """Rectangle perimeter waypoints (x, y, yaw), counter-clockwise."""
    pts = []
    corners = [
        (cx - w / 2, cy - h / 2),
        (cx + w / 2, cy - h / 2),
        (cx + w / 2, cy + h / 2),
        (cx - w / 2, cy + h / 2),
    ]
    for s in range(4):
        x0, y0 = corners[s]
        x1, y1 = corners[(s + 1) % 4]
        seg = np.hypot(x1 - x0, y1 - y0)
        n = max(int(seg / step), 1)
        yaw = np.arctan2(y1 - y0, x1 - x0)
        for k in range(n):
            a = k / n
            pts.append((x0 + a * (x1 - x0), y0 + a * (y1 - y0), yaw))
    return pts


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def build_multifloor_scene(
    floors: Tuple[int, int] = (2, 5),
    laps: int = 2,
    floor_height: float = 3.0,
    step: float = 0.6,
    seed: int = 0,
):
    """GT trajectory: ``laps`` rectangle laps on the lower floor, an elevator
    ascent, ``laps`` laps of the same footprint on the upper floor (the
    aliasing geometry: identical (x, y) paths stacked vertically).

    Returns a dict with gt_R (N,3,3), gt_t (N,3), floor_labels (N,),
    lap_starts (per floor, the pose index where each lap begins), lap_len,
    floors, floor_height and elevator (pose_before, pose_after).
    """
    lo, hi = floors
    path = _rect_path(0.0, 0.0, 10.0, 6.0, step)
    L = len(path)
    ts, yaws, labels = [], [], []
    lap_starts: Dict[int, List[int]] = {lo: [], hi: []}

    def add_floor(floor: int):
        z = floor * floor_height
        for _ in range(laps):
            lap_starts[floor].append(len(ts))
            for x, y, yaw in path:
                ts.append((x, y, z))
                yaws.append(yaw)
                labels.append(floor)

    add_floor(lo)
    # elevator: vertical ascent at the rectangle's first corner
    pose_before = len(ts) - 1
    x0, y0, yaw0 = path[0]
    n_elev = 10
    for k in range(1, n_elev + 1):
        z = lo * floor_height + (hi - lo) * floor_height * k / n_elev
        ts.append((x0, y0, z))
        yaws.append(yaw0)
        labels.append(lo if k <= n_elev // 2 else hi)
    pose_after = len(ts) - 1
    add_floor(hi)

    w = np.zeros((len(yaws), 3), np.float32)
    w[:, 2] = yaws
    return {
        "gt_R": so3_exp(torch.as_tensor(w)).numpy(),
        "gt_t": np.asarray(ts, np.float32),
        "floor_labels": np.asarray(labels, np.int32),
        "lap_starts": lap_starts,
        "lap_len": L,
        "floors": floors,
        "floor_height": floor_height,
        "elevator": (pose_before, pose_after),
    }


def simulate_odometry(
    gt_R: np.ndarray,
    gt_t: np.ndarray,
    seed: int = 0,
    sigma_rho: float = 0.02,
    sigma_omega: float = 0.003,
    yaw_bias: float = 0.0015,
    device="cuda",
):
    """Relative GT poses corrupted by white noise and a constant yaw-rate
    bias (the drift source); returns (edges, edge_R, edge_t, init_R,
    init_t), the init integrated from the noisy odometry one float32
    compose per step on ``device``."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    N = gt_t.shape[0]
    Rj, tj = _f32(gt_R, dev), _f32(gt_t, dev)
    Ri_inv, ti_inv = se3_inv(Rj[:-1], tj[:-1])
    Rrel, trel = se3_compose(Ri_inv, ti_inv, Rj[1:], tj[1:])
    noise = rng.normal(size=(N - 1, 6)).astype(np.float32) * np.asarray(
        [sigma_rho, sigma_rho, sigma_rho * 0.25,
         sigma_omega * 0.3, sigma_omega * 0.3, sigma_omega],
        np.float32,
    )
    noise[:, 5] += yaw_bias
    dR, dt = se3_exp(_f32(noise, dev))
    eR, et = se3_compose(Rrel, trel, dR, dt)

    init_R, init_t = [Rj[0]], [tj[0]]
    for k in range(N - 1):
        Rn, tn = se3_compose(init_R[-1], init_t[-1], eR[k], et[k])
        init_R.append(Rn)
        init_t.append(tn)
    edges = [(i, i + 1) for i in range(N - 1)]
    return (edges, eR.cpu().numpy(), et.cpu().numpy(), torch.stack(init_R).cpu().numpy(),
            torch.stack(init_t).cpu().numpy())


def make_loop_candidates(scene: dict, every: int = 6, seed: int = 0, device="cuda"):
    """Loop-closure candidates with measured relative poses.

    True candidates: lap-2 pose <-> the same lap-1 pose on the same floor
    (measurement = GT relative pose + small noise: what a correct match and
    RANSAC pose would estimate). False candidates: upper-floor pose <->
    the vertically aligned lower-floor pose (the measurement claims the
    identity relative pose: aliased features match as if the places were
    the same).

    Returns (pairs (M,2), meas_R, meas_t, is_true (M,)).
    """
    rng = np.random.default_rng(seed + 1)
    dev = torch.device(device)
    L = scene["lap_len"]
    lo, hi = scene["floors"]
    pairs, noise, is_true = [], [], []

    def add(i, j, true_pair):
        scale = [0.03, 0.03, 0.03, 0.005, 0.005, 0.005] if true_pair else \
            [0.05, 0.05, 0.05, 0.01, 0.01, 0.01]
        noise.append(rng.normal(size=6).astype(np.float32) * np.asarray(scale, np.float32))
        pairs.append((i, j))
        is_true.append(true_pair)

    for floor in (lo, hi):
        lap1, lap2 = scene["lap_starts"][floor][0], scene["lap_starts"][floor][1]
        for k in range(0, L, every):
            add(lap1 + k, lap2 + k, True)
    # cross-floor aliases: same in-lap offset, different floor
    lo1, hi1 = scene["lap_starts"][lo][0], scene["lap_starts"][hi][0]
    for k in range(0, L, every * 2):
        add(lo1 + k, hi1 + k, False)

    pairs = np.asarray(pairs, np.int64)
    is_true = np.asarray(is_true, bool)
    Rj, tj = _f32(scene["gt_R"], dev), _f32(scene["gt_t"], dev)
    dR, dt = se3_exp(_f32(np.stack(noise), dev))
    ii = torch.as_tensor(pairs[:, 0], device=dev)
    jj = torch.as_tensor(pairs[:, 1], device=dev)
    Ri_inv, ti_inv = se3_inv(Rj[ii], tj[ii])
    Rr, tr = se3_compose(*se3_compose(Ri_inv, ti_inv, Rj[jj], tj[jj]), dR, dt)
    # aliased match: claims j sits where i is (identity + jitter)
    keep = torch.as_tensor(is_true, device=dev)
    meas_R = torch.where(keep[:, None, None], Rr, dR)
    meas_t = torch.where(keep[:, None], tr, dt)
    return pairs, meas_R.cpu().numpy(), meas_t.cpu().numpy(), is_true


def demo_problem(seed: int = 0, laps: int = 2, device="cuda") -> Dict:
    """The demo's inputs on the host: the scene, the drifted odometry and
    its integrated init, the loop candidates with their truth and the
    gate's decisions, the floor z priors and the elevator dz factor."""
    dev = torch.device(device)
    scene = build_multifloor_scene(laps=laps, seed=seed)
    labels = scene["floor_labels"]
    odo_edges, odo_R, odo_t, init_R, init_t = simulate_odometry(
        scene["gt_R"], scene["gt_t"], seed=seed, device=dev)
    pairs, mR, mt, is_true = make_loop_candidates(scene, seed=seed, device=dev)
    gate = SemanticLoopClosureGate(labels, strict_mode=True, device=dev)
    expected_z, _ = ContextualPriorFactor(labels).floor_priors(scene["floor_height"], sigma_z=0.5)
    pb, pa = scene["elevator"]
    return {
        "scene": scene, "odo_edges": odo_edges, "odo_R": odo_R, "odo_t": odo_t,
        "init_R": init_R, "init_t": init_t, "pairs": pairs, "meas_R": mR, "meas_t": mt,
        "is_true": is_true, "accept": gate.gate_batch(pairs[:, 0], pairs[:, 1]),
        "expected_z": expected_z,
        "dz_edges": [(pb, pa, float((labels[pa] - labels[pb]) * scene["floor_height"]))],
    }


def demo_factors(problem: Dict, closure_mask: np.ndarray, switchable: bool = False,
                 use_priors: bool = True, device="cuda"):
    """(factors, kept closure indices): the odometry edges and the closures
    in ``closure_mask``; with ``switchable`` the closures are flagged for
    Switchable Constraints or GNC."""
    n_odo, keep = len(problem["odo_edges"]), np.nonzero(closure_mask)[0]
    pairs = problem["pairs"]
    edges = problem["odo_edges"] + [tuple(pairs[i]) for i in keep]
    sig = np.concatenate([np.tile(np.asarray([[0.03, 0.004]], np.float32), (n_odo, 1)),
                          np.tile(np.asarray([[0.05, 0.01]], np.float32), (len(keep), 1))])
    factors = build_factors(
        len(problem["scene"]["gt_t"]), edges,
        np.concatenate([problem["odo_R"], problem["meas_R"][keep]]),
        np.concatenate([problem["odo_t"], problem["meas_t"][keep]]),
        edge_sigmas=sig,
        prior_z=problem["expected_z"] if use_priors else None,
        sigma_z=0.5,
        dz_edges=problem["dz_edges"] if use_priors else (),
        switchable=np.concatenate([np.zeros(n_odo, bool), np.ones(len(keep), bool)])
        if switchable else None,
        device=device,
    )
    return factors, keep


def demo_pcm_keep(problem: Dict, device="cuda") -> np.ndarray:
    """PCM's keep mask over the demo's candidates, on the odometry-integrated
    poses; the cycle covariance is the odometry drift accumulated over the
    loop, much looser than a single edge's sigma."""
    keep, _ = pcm_filter(problem["init_R"], problem["init_t"], problem["pairs"],
                         problem["meas_R"], problem["meas_t"], sigma_rho=0.5,
                         sigma_omega=0.05, device=device)
    return keep


def run_pgo_demo(
    seed: int = 0,
    laps: int = 2,
    num_iters: int = 20,
    cg_iters: int = 256,
    huber_delta: float = None,
    use_priors: bool = True,
    return_trajectories: bool = False,
    device="cuda",
) -> Dict:
    """Scene -> candidates -> gate -> factors -> Gauss-Newton on ``device``
    -> ATE. Returns a flat JSON-ready dict (plus the non-JSON
    "trajectories", "gt_t" and "floor_labels" entries when requested)."""
    dev = torch.device(device)
    problem = demo_problem(seed, laps, dev)
    gt_t, labels = problem["scene"]["gt_t"], problem["scene"]["floor_labels"]
    pairs, is_true, accept = problem["pairs"], problem["is_true"], problem["accept"]
    n_odo = len(problem["odo_edges"])
    R0, t0 = _f32(problem["init_R"], dev), _f32(problem["init_t"], dev)

    def solve(closure_mask: np.ndarray, sc: bool = False, gnc: bool = False) -> Dict:
        factors, keep = demo_factors(problem, closure_mask, sc or gnc, use_priors, dev)
        if gnc:
            R, t, costs, switches = optimize_pose_graph_gnc(
                R0, t0, factors, inner_iters=2, cg_iters=cg_iters,
            )
        else:
            R, t, costs, switches = optimize_pose_graph(
                R0, t0, factors, num_iters=num_iters, cg_iters=cg_iters,
                huber_delta=huber_delta,
            )
        t = t.cpu().numpy()
        ate = compute_ate(t, gt_t)
        out = {
            "ate_rmse": float(ate["rmse"]),
            "ate_max": float(ate["max"]),
            "cost_final": float(costs[-1]),
            "_t": t,
        }
        if sc or gnc:
            # per-closure switch / GNC-weight values, aligned with `keep`
            sw = switches.cpu().numpy()[n_odo : n_odo + len(keep)]
            truth = is_true[keep]
            out["false_disabled"] = float((sw[~truth] < 0.5).mean()) if (~truth).any() else 1.0
            out["true_kept"] = float((sw[truth] >= 0.5).mean()) if truth.any() else 1.0
        return out

    out = {
        "n_poses": int(len(gt_t)),
        "n_candidates": int(len(pairs)),
        "n_true": int(is_true.sum()),
        "n_false": int((~is_true).sum()),
        "gate_accepted": int(accept.sum()),
        "gate_rejected": int((~accept).sum()),
        # the gate must keep exactly the true pairs on this scene
        "gate_correct": bool((accept == is_true).all()),
        "ate_init": float(compute_ate(problem["init_t"], gt_t)["rmse"]),
    }
    res_odo = solve(np.zeros(len(pairs), bool))
    res_gated = solve(accept)
    res_ungated = solve(np.ones(len(pairs), bool))
    # Switchable Constraints on every candidate: the robust-back-end
    # alternative to gating (per-closure switches the optimiser can turn off)
    res_sc = solve(np.ones(len(pairs), bool), sc=True)
    # GNC on every candidate: the reference's own robust back end
    # (Kimera-RPGO, outlier_method 2)
    res_gnc = solve(np.ones(len(pairs), bool), gnc=True)
    # PCM (outlier_method 1): pairwise-consistency filter, then a plain
    # solve on the surviving clique
    pcm_keep = demo_pcm_keep(problem, dev)
    res_pcm = solve(pcm_keep)
    res_pcm["false_removed"] = float((~pcm_keep[~is_true]).mean()) if (~is_true).any() else 1.0
    res_pcm["true_kept"] = float(pcm_keep[is_true].mean()) if is_true.any() else 1.0
    trajs = {
        "odometry": res_odo.pop("_t"),
        "gated": res_gated.pop("_t"),
        "ungated": res_ungated.pop("_t"),
        "ungated_sc": res_sc.pop("_t"),
        "ungated_gnc": res_gnc.pop("_t"),
        "ungated_pcm": res_pcm.pop("_t"),
    }
    out.update({f"odometry_{k}": v for k, v in res_odo.items()})
    out.update({f"gated_{k}": v for k, v in res_gated.items()})
    out.update({f"ungated_{k}": v for k, v in res_ungated.items()})
    out.update({f"sc_{k}": v for k, v in res_sc.items()})
    out.update({f"gnc_{k}": v for k, v in res_gnc.items()})
    out.update({f"pcm_{k}": v for k, v in res_pcm.items()})
    if return_trajectories:
        out["trajectories"] = trajs
        out["gt_t"] = gt_t
        out["floor_labels"] = labels
    return out
