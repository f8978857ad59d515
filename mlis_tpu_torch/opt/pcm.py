"""Pairwise Consistency Maximization (PCM) loop-closure filtering.

Counterpart of ``mlis_tpu/opt/pcm.py``: Kimera-RPGO's outlier method 1
(Mangelson et al., ICRA 2018). Two loop closures a = (i_a, j_a, Z_a) and
b = (i_b, j_b, Z_b) are pairwise consistent when the cycle

    C_ab = Z_a^-1 * odom(i_a -> i_b) * Z_b * odom(j_b -> j_a)

is close to identity under the measurement covariance; the accepted set
is (approximately) the maximum clique of the consistency graph. It is a
front-end filter like the semantic gate, but needs O(A^2) SE(3) cycle
checks where the gate needs one floor-label lookup per candidate.

The (A, A) cycle-residual matrix is one batched Lie-group sweep on the
device, broadcast over blocks of rows so that the (rows, A, 3, 3)
temporaries stay within a few hundred MB; the greedy max-clique search
runs on the host over the small boolean matrix.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mlis_tpu_torch.opt.lie import se3_compose, se3_inv, se3_log

_BLOCK_PAIRS = 1 << 20  # closure pairs per block of rows


def pairwise_cycle_r2(
    pose_R: torch.Tensor,  # (N, 3, 3) odometry-integrated rotations
    pose_t: torch.Tensor,  # (N, 3)
    ci: torch.Tensor,  # (A,) int64 closure endpoint i
    cj: torch.Tensor,  # (A,) int64 closure endpoint j
    cR: torch.Tensor,  # (A, 3, 3) measured Z = T_i^-1 T_j
    ct: torch.Tensor,  # (A, 3)
    w: torch.Tensor,  # (6,) sqrt-information of the cycle residual
) -> torch.Tensor:
    """(A, A) whitened squared cycle residuals; the diagonal is 0."""
    A = ci.shape[0]
    Ri_inv, ti_inv = se3_inv(pose_R[ci], pose_t[ci])  # T_{i_a}^-1
    Rj_inv, tj_inv = se3_inv(pose_R[cj], pose_t[cj])  # T_{j_b}^-1
    Za_inv_R, Za_inv_t = se3_inv(cR, ct)
    out = torch.empty((A, A), dtype=pose_R.dtype, device=pose_R.device)
    rows = max(1, _BLOCK_PAIRS // max(A, 1))
    for a0 in range(0, A, rows):
        a = slice(a0, min(a0 + rows, A))
        # odom(i_a -> i_b) = T_{i_a}^-1 T_{i_b}: rows a, columns b
        O1 = se3_compose(Ri_inv[a, None], ti_inv[a, None], pose_R[ci][None], pose_t[ci][None])
        # odom(j_b -> j_a) = T_{j_b}^-1 T_{j_a}
        O2 = se3_compose(Rj_inv[None], tj_inv[None], pose_R[cj][a, None], pose_t[cj][a, None])
        R1, t1 = se3_compose(Za_inv_R[a, None], Za_inv_t[a, None], *O1)
        R2, t2 = se3_compose(R1, t1, cR[None], ct[None])
        R3, t3 = se3_compose(R2, t2, *O2)
        r = se3_log(R3, t3) * w
        out[a] = (r * r).sum(-1)
    return out


def greedy_max_clique(adj: np.ndarray) -> np.ndarray:
    """Greedy max-clique heuristic on a boolean adjacency matrix: repeatedly
    add the candidate with the most remaining-candidate neighbours, seeded
    from each of the top-degree vertices. Returns a boolean membership mask."""
    A = adj.shape[0]
    adj = np.asarray(adj, bool).copy()
    np.fill_diagonal(adj, False)
    best = np.zeros(A, bool)
    order = np.argsort(-adj.sum(1))
    for seed in order[: min(8, A)]:
        clique = [seed]
        cand = np.where(adj[seed])[0]
        while len(cand):
            sub = adj[np.ix_(cand, cand)]
            pick = cand[np.argmax(sub.sum(1))]
            clique.append(pick)
            cand = cand[adj[pick, cand]]
        if len(clique) > best.sum():
            best = np.zeros(A, bool)
            best[clique] = True
    return best


def pcm_filter(
    pose_R: np.ndarray,  # (N, 3, 3) odometry-integrated poses
    pose_t: np.ndarray,
    closures: np.ndarray,  # (A, 2) int endpoints
    closure_R: np.ndarray,  # (A, 3, 3)
    closure_t: np.ndarray,  # (A, 3)
    sigma_rho: float = 0.2,  # cycle translation sigma (odometry drift
    # accumulates over the cycle, so this is looser than a single edge's)
    sigma_omega: float = 0.05,
    threshold: float = 16.81,  # chi2(0.99, 6) on the whitened cycle
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """PCM: keep the (approximately) largest mutually consistent closure
    set. Returns (keep_mask (A,) bool, r2 (A, A) float32 cycle residuals)."""
    A = len(closures)
    if A == 0:
        return np.zeros(0, bool), np.zeros((0, 0), np.float32)
    dev = torch.device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    closures = np.asarray(closures)
    w = f32([1.0 / sigma_rho] * 3 + [1.0 / sigma_omega] * 3)
    r2 = pairwise_cycle_r2(
        f32(pose_R), f32(pose_t),
        torch.as_tensor(closures[:, 0].astype(np.int64), device=dev),
        torch.as_tensor(closures[:, 1].astype(np.int64), device=dev),
        f32(closure_R), f32(closure_t), w,
    ).cpu().numpy()
    adj = (r2 < threshold) & (r2.T < threshold)
    return greedy_max_clique(adj), r2
