"""Pose-graph optimisation at dataset scale (LeGO-LOAM / NUFR-M3F).

Counterpart of ``mlis_tpu/opt/scale.py``: ``opt/demo.py`` at the size of a
published trajectory and its whole candidate set (on the published
LeGO-LOAM run: 2,406 poses, 87,044 proximity candidates, 21,477
same-floor and 65,567 cross-floor).

The reference generates candidates in the SLAM-estimated space, where z
drift collapses the floors onto each other; that is why 75.3% of LeGO's
proximity candidates are cross-floor. This experiment therefore
  1. keeps the published xy geometry and re-anchors z to the floor labels
     (z = floor * floor_height) as the multi-level ground truth;
  2. generates candidates from the published (z-collapsed) geometry,
     reproducing the reference's candidate pipeline and counts;
  3. treats same-floor candidates as true closures (measured relative pose
     = GT + noise) and cross-floor ones as the aliased failure mode (the
     measurement claims the published near-zero dz, "same place");
  4. solves the graph on the device three ways: odometry only, gated,
     ungated (and, on request, Switchable Constraints and GNC-GM on the
     ungated graph).

The noise comes from ``np.random.default_rng(seed)`` in the JAX package's
order; the odometry integration is host float64.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from mlis_tpu_torch.core.dataset import NUFRM3F, REFERENCE_TRAJECTORY_ROOT
from mlis_tpu_torch.core.trajectory import combine_sequences
from mlis_tpu_torch.eval.metrics import compute_ate
from mlis_tpu_torch.gating.gate import ContextualPriorFactor
from mlis_tpu_torch.ops.geometry import quat_to_matrix
from mlis_tpu_torch.ops.pairwise import candidate_pairs_host
from mlis_tpu_torch.opt.lie import se3_exp
from mlis_tpu_torch.opt.pose_graph import (
    build_factors,
    optimize_pose_graph,
    optimize_pose_graph_gnc,
)


def _compose_np(Ra, ta, Rb, tb):
    return Ra @ Rb, Ra @ tb + ta


def _rel_np(Ra, ta, Rb, tb):
    """inv(Ta) @ Tb for single poses (numpy, float64)."""
    RaT = Ra.T
    return RaT @ Rb, RaT @ (tb - ta)


def _integrate(R0, t0, eR, et):
    """Chain relative poses on the host (float64: no float32 drift over
    thousands of steps)."""
    N = len(eR) + 1
    R = np.empty((N, 3, 3))
    t = np.empty((N, 3))
    R[0], t[0] = R0, t0
    for k in range(len(eR)):
        R[k + 1], t[k + 1] = _compose_np(R[k], t[k], eR[k], et[k])
    return R, t


def _exp_f64(xi: np.ndarray, device) -> tuple:
    """se3_exp in float32 on ``device`` (the JAX package's precision), as
    float64 host arrays."""
    dR, dt = se3_exp(torch.as_tensor(xi.astype(np.float32), device=device))
    return dR.cpu().double().numpy(), dt.cpu().double().numpy()


def load_real_scene(
    trajectory_root: str = REFERENCE_TRAJECTORY_ROOT,
    algorithm: str = "lego_loam",
    floor_height: float = 3.0,
):
    """Published trajectory -> (gt_R, gt_t, floors, published_positions).

    gt z is re-anchored to the floor labels (see the module docstring); xy
    and orientations are the published values.
    """
    m = NUFRM3F(trajectory_root, algorithm)
    mat, floors = combine_sequences(m.load(), {})
    pub_pos = mat[:, 1:4].copy()
    gt_R = quat_to_matrix(mat[:, 4:8])
    gt_t = pub_pos.copy()
    gt_t[:, 2] = floors.astype(np.float64) * floor_height
    return gt_R, gt_t, floors.astype(np.int32), pub_pos


def real_problem(
    trajectory_root: str = REFERENCE_TRAJECTORY_ROOT,
    algorithm: str = "lego_loam",
    floor_height: float = 3.0,
    radius: float = 2.0,
    min_gap: int = 100,
    closure_stride: int = 1,
    seed: int = 0,
    sigma_rho: float = 0.01,
    sigma_omega: float = 0.002,
    yaw_bias: float = 0.0004,
    device="cuda",
) -> Dict:
    """The experiment's inputs on the host: the re-anchored ground truth,
    the drifted odometry and its float64 integration, the candidates from
    the published geometry with their measurements (true block, false
    block), their counts and the floor z priors."""
    dev = torch.device(device)
    gt_R, gt_t, floors, pub_pos = load_real_scene(trajectory_root, algorithm, floor_height)
    N = len(gt_t)
    rng = np.random.default_rng(seed)

    # --- odometry (GT relative + noise + yaw-rate bias) -> drifted init
    eR = np.empty((N - 1, 3, 3))
    et = np.empty((N - 1, 3))
    for k in range(N - 1):
        eR[k], et[k] = _rel_np(gt_R[k], gt_t[k], gt_R[k + 1], gt_t[k + 1])
    noise = rng.normal(size=(N - 1, 6)) * np.asarray(
        [sigma_rho, sigma_rho, sigma_rho * 0.25,
         sigma_omega * 0.3, sigma_omega * 0.3, sigma_omega]
    )
    noise[:, 5] += yaw_bias
    ndR, ndt = _exp_f64(noise, dev)
    for k in range(N - 1):
        eR[k], et[k] = _compose_np(eR[k], et[k], ndR[k], ndt[k])
    init_R, init_t = _integrate(gt_R[0], gt_t[0], eR, et)

    # --- candidates from the published geometry (the reference pipeline)
    ci, cj, _ = candidate_pairs_host(pub_pos, floors, radius, min_gap)
    same = floors[ci] == floors[cj]
    sel = slice(None, None, closure_stride)
    ti_, tj_ = ci[same][sel], cj[same][sel]
    fi_, fj_ = ci[~same][sel], cj[~same][sel]

    # true closures: GT relative pose + noise
    tR = np.empty((len(ti_), 3, 3))
    tt = np.empty((len(ti_), 3))
    for k in range(len(ti_)):
        tR[k], tt[k] = _rel_np(gt_R[ti_[k]], gt_t[ti_[k]], gt_R[tj_[k]], gt_t[tj_[k]])
    n = rng.normal(size=(len(ti_), 6)) * np.asarray([0.03, 0.03, 0.03, 0.005, 0.005, 0.005])
    dR, dt = _exp_f64(n, dev)
    for k in range(len(ti_)):
        tR[k], tt[k] = _compose_np(tR[k], tt[k], dR[k], dt[k])
    # aliased closures: the measurement is the published relative pose
    # (z-collapsed: it claims the floors coincide)
    fR = np.einsum("eji,ejk->eik", gt_R[fi_], gt_R[fj_])
    ft = np.einsum("eji,ej->ei", gt_R[fi_], pub_pos[fj_] - pub_pos[fi_])

    expected_z, _ = ContextualPriorFactor(floors).floor_priors(floor_height, sigma_z=0.5)
    return {
        "algorithm": algorithm, "gt_R": gt_R, "gt_t": gt_t, "floors": floors,
        "pub_pos": pub_pos, "odo_R": eR, "odo_t": et, "init_R": init_R, "init_t": init_t,
        "counts": (len(ci), int(same.sum()), int((~same).sum())),
        "true": (ti_, tj_, tR, tt), "false": (fi_, fj_, fR, ft), "expected_z": expected_z,
        "closure_stride": closure_stride,
    }


def real_factors(problem: Dict, with_true: bool, with_false: bool, switchable: bool = False,
                 shared_pad: bool = True, device="cuda"):
    """The factors of one variant: odometry, then the true closures, then
    the false ones; ``shared_pad`` pads every variant to the ungated edge
    count, as the JAX package does (one compiled program there, one shape
    here)."""
    N = len(problem["gt_t"])
    blocks = [(np.arange(N - 1), np.arange(1, N), problem["odo_R"], problem["odo_t"],
               [0.02, 0.003], False)]
    if with_true:
        blocks.append((*problem["true"], [0.05, 0.01], True))
    if with_false:
        blocks.append((*problem["false"], [0.05, 0.01], True))
    edges = [e for ii, jj, *_ in blocks for e in zip(ii.tolist(), jj.tolist())]
    max_edges = N - 1 + len(problem["true"][0]) + len(problem["false"][0])
    return build_factors(
        N, edges,
        np.concatenate([b[2] for b in blocks]).astype(np.float32),
        np.concatenate([b[3] for b in blocks]).astype(np.float32),
        edge_sigmas=np.concatenate([np.tile([b[4]], (len(b[0]), 1)) for b in blocks]
                                   ).astype(np.float32),
        prior_z=problem["expected_z"].astype(np.float32),
        sigma_z=0.5,
        switchable=np.concatenate([np.full(len(b[0]), b[5]) for b in blocks])
        if switchable else None,
        pad_edges=(1 << (max_edges - 1).bit_length()) if shared_pad else None,
        device=device,
    )


def run_pgo_real(
    trajectory_root: str = REFERENCE_TRAJECTORY_ROOT,
    algorithm: str = "lego_loam",
    floor_height: float = 3.0,
    radius: float = 2.0,
    min_gap: int = 100,
    closure_stride: int = 1,
    seed: int = 0,
    sigma_rho: float = 0.01,
    sigma_omega: float = 0.002,
    yaw_bias: float = 0.0004,
    num_iters: int = 12,
    cg_iters: int = 1024,
    include_sc: bool = False,
    include_gnc: bool = False,  # GNC-GM on the ungated graph: about 5x one
    # plain solve's work (outer anneal x inner GN), so opt-in
    shared_pad: bool = True,
    device="cuda",
) -> Dict:
    """Full-scale gate-vs-ungated pose-graph experiment on a published
    trajectory. ``closure_stride`` subsamples the candidate closures
    (1 = every one). Each solve's ``solve_s`` ends when its poses reach the
    host."""
    dev = torch.device(device)
    problem = real_problem(trajectory_root, algorithm, floor_height, radius, min_gap,
                           closure_stride, seed, sigma_rho, sigma_omega, yaw_bias, dev)
    gt_t, n_true, n_false = problem["gt_t"], len(problem["true"][0]), len(problem["false"][0])
    R0 = torch.as_tensor(problem["init_R"].astype(np.float32), device=dev)
    t0 = torch.as_tensor(problem["init_t"].astype(np.float32), device=dev)

    def solve(with_true: bool, with_false: bool, sc: bool = False, gnc: bool = False) -> Dict:
        factors = real_factors(problem, with_true, with_false, sc or gnc, shared_pad, dev)
        n_edges = len(gt_t) - 1 + n_true * with_true + n_false * with_false
        t_start = time.perf_counter()
        if gnc:
            R, t, costs, w = optimize_pose_graph_gnc(
                R0, t0, factors, inner_iters=2, cg_iters=cg_iters)
        else:
            R, t, costs, w = optimize_pose_graph(
                R0, t0, factors, num_iters=num_iters, cg_iters=cg_iters)
        t = t.cpu().numpy()  # the fetch ends the timing
        elapsed = time.perf_counter() - t_start
        ate = compute_ate(t, gt_t)
        out = {
            "ate_rmse": float(ate["rmse"]),
            "ate_max": float(ate["max"]),
            "n_edges": n_edges,
            "solve_s": round(elapsed, 2),
        }
        if (sc or gnc) and with_true and with_false:
            # closure-edge weights: the true block, then the false block
            N = len(gt_t)
            ww = w.cpu().numpy()[N - 1 : n_edges]
            out["false_disabled"] = float((ww[n_true:] < 0.5).mean())
            out["true_kept"] = float((ww[:n_true] >= 0.5).mean())
        return out

    counts = problem["counts"]
    out = {
        "algorithm": algorithm,
        "n_poses": int(len(gt_t)),
        "candidates": counts[0],
        "same_floor": counts[1],
        "cross_floor": counts[2],
        "closure_stride": closure_stride,
        "ate_init": float(compute_ate(problem["init_t"], gt_t)["rmse"]),
    }
    res = {"odometry": solve(False, False), "gated": solve(True, False),
           "ungated": solve(True, True)}
    if include_sc:
        res["ungated_sc"] = solve(True, True, sc=True)
    if include_gnc:
        res["ungated_gnc"] = solve(True, True, gnc=True)
    for name, r in res.items():
        out.update({f"{name}_{k}": v for k, v in r.items()})
    return out
