"""Batched epipolar geometry: essential-matrix RANSAC + pose recovery.

Counterpart of ``mlis_tpu/ops/epipolar.py``, written over a leading pair
dimension P instead of ``vmap``:

* hypotheses (:func:`sample_hypotheses`): the gauge-fixed (E_33 = 1)
  8-point solve on random minimal samples, by Gauss-Jordan on the 8x8
  normal equations;
* scoring (:func:`score_hypotheses`): Sampson distance in normalised coordinates against
  (threshold_px / mean focal)^2; the top 8 hypotheses by count (ties to
  the lower index) are projected onto the essential manifold by SVD and
  rescored, and the first best one wins;
* pose: the four (R, t) decompositions of E, voted by two-view
  cheirality.

The JAX version draws its samples with ``jax.random.uniform(key, (H, 8))``
per pair, which torch cannot reproduce; here the (P, H, 8) uniforms are an
optional argument (tests feed the reference's draws) and otherwise come
from a ``torch.Generator`` on the device. SVD signs differ between
libraries, so E is defined up to sign; the projected E and the pose do not
depend on them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mlis_tpu_torch.utils.profiling import sync_point


class EssentialResult(NamedTuple):
    E: torch.Tensor  # (P, 3, 3)
    inlier_mask: torch.Tensor  # (P, N) bool
    num_inliers: torch.Tensor  # (P,) int32
    inlier_ratio: torch.Tensor  # (P,) float32


TOP_K = 8  # hypotheses projected and rescored


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_points(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalised camera coordinates: (x - c) / f."""
    return torch.stack(
        [(pts[..., 0] - K[0, 2]) / K[0, 0], (pts[..., 1] - K[1, 2]) / K[1, 1]], dim=-1
    )


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto the essential manifold (singular values 1, 1, 0)."""
    with sync_point("svd"):
        u, _, vt = torch.linalg.svd(E)
    with sync_point("upload_const"):
        d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (u * d) @ vt


def _gauss_jordan_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b for a batch of SPD (..., n, n) systems by Gauss-Jordan
    elimination without pivoting (tiny pivots clamped to 1e-12)."""
    M, b = M.clone(), b.clone()
    n = M.shape[-1]
    for k in range(n):
        piv = M[..., k, k]
        piv = torch.where(piv.abs() < 1e-12, torch.full_like(piv, 1e-12), piv)
        rowk = M[..., k, :] / piv[..., None]
        bk = b[..., k] / piv
        M[..., k, :] = rowk
        b[..., k] = bk
        col = M[..., :, k].clone()
        col[..., k] = 0.0
        M = M - col[..., :, None] * rowk[..., None, :]
        b = b - col * bk[..., None]
    return b


def _eight_point(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Gauge-fixed (E_33 = 1) essential matrices from (..., M, 2)
    normalised correspondences, unprojected."""
    h1, h2 = to_homogeneous(x1), to_homogeneous(x2)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*x1.shape[:-1], 9)
    A8, a9 = A[..., :8], A[..., 8]
    eye = torch.eye(8, dtype=A.dtype, device=A.device)
    M = A8.transpose(-1, -2) @ A8 + 1e-10 * eye
    rhs = -(A8.transpose(-1, -2) @ a9[..., None])[..., 0]
    e8 = _gauss_jordan_solve(M, rhs)
    e = torch.cat([e8, torch.ones_like(e8[..., :1])], dim=-1)
    return e.reshape(*e.shape[:-1], 3, 3)


def sampson_error(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric error in normalised coordinates.

    E (P, G, 3, 3) hypotheses, x1/x2 (P, N, 2) -> (P, G, N)."""
    e = E[..., None, :, :]  # (P, G, 1, 3, 3)
    u1, v1 = x1[:, None, :, 0], x1[:, None, :, 1]  # (P, 1, N)
    u2, v2 = x2[:, None, :, 0], x2[:, None, :, 1]
    # E h1 and E^T h2 for h = (u, v, 1)
    ex = [e[..., i, 0] * u1 + e[..., i, 1] * v1 + e[..., i, 2] for i in range(3)]
    etx = [e[..., 0, j] * u2 + e[..., 1, j] * v2 + e[..., 2, j] for j in range(2)]
    err = u2 * ex[0] + v2 * ex[1] + ex[2]
    denom = ex[0] ** 2 + ex[1] ** 2 + etx[0] ** 2 + etx[1] ** 2
    return err**2 / denom.clamp_min(1e-12)


def _topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def sample_hypotheses(
    x1: torch.Tensor,  # (P, N, 2) normalised coordinates
    x2: torch.Tensor,
    valid: torch.Tensor,  # (P, N) bool
    uniforms: torch.Tensor,  # (P, H, 8) in [0, 1)
) -> torch.Tensor:
    """The (P, H, 3, 3) unprojected 8-point hypotheses: each row of
    ``uniforms`` picks 8 of the valid correspondences (valid ones first,
    in index order) for one gauge-fixed solve."""
    P = valid.shape[0]
    n_valid = valid.sum(1)  # (P,)
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True)[1]  # valid first
    draw = (uniforms.to(torch.float32)
            * n_valid.clamp_min(1)[:, None, None].to(torch.float32)).to(torch.int64)
    draw = torch.minimum(draw, (n_valid - 1).clamp_min(0)[:, None, None])
    idx = order.gather(1, draw.reshape(P, -1)).reshape(draw.shape)  # (P, H, 8)

    def pick(x):
        return x.gather(1, idx.reshape(P, -1, 1).expand(-1, -1, 2)).reshape(*idx.shape, 2)

    return _eight_point(pick(x1), pick(x2))


def score_hypotheses(
    Es: torch.Tensor,  # (P, H, 3, 3) unprojected hypotheses
    x1: torch.Tensor,  # (P, N, 2) normalised coordinates
    x2: torch.Tensor,
    valid: torch.Tensor,  # (P, N) bool
    thr: float,  # squared Sampson threshold in normalised units
    score_subset: int = 0,
) -> EssentialResult:
    """RANSAC's scoring and selection: inlier counts of every hypothesis
    (on a stratified subset of ``score_subset`` valid points when 0 <
    score_subset < N), the top 8 projected onto the essential manifold and
    rescored on every point, the first best one kept."""
    P, N = valid.shape
    nv1 = valid.sum(1).clamp_min(1)
    if 0 < score_subset < N:
        S = int(score_subset)
        order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True)[1]
        pos = (torch.arange(S, device=valid.device)[None, :] * nv1[:, None]) // S
        sub = order.gather(1, pos.clamp(max=N - 1))  # (P, S)
        x1s = x1.gather(1, sub[..., None].expand(-1, -1, 2))
        x2s = x2.gather(1, sub[..., None].expand(-1, -1, 2))
        vs = valid.gather(1, sub)
        counts = ((sampson_error(Es, x1s, x2s) < thr) & vs[:, None, :]).sum(-1)
    else:
        counts = ((sampson_error(Es, x1, x2) < thr) & valid[:, None, :]).sum(-1)

    cand = _topk_stable(counts, TOP_K)  # (P, TOP_K)
    E_cand = _project_essential(Es.gather(1, cand[..., None, None].expand(-1, -1, 3, 3)))
    inl_c = (sampson_error(E_cand, x1, x2) < thr) & valid[:, None, :]  # (P, TOP_K, N)
    counts_c = inl_c.sum(-1)
    best = counts_c.argmax(dim=1)  # first max
    ar = torch.arange(P, device=valid.device)
    num = counts_c[ar, best]
    ratio = num.to(torch.float32) / nv1.to(torch.float32)
    return EssentialResult(E_cand[ar, best], inl_c[ar, best], num.to(torch.int32), ratio)


def sampson_threshold(K: torch.Tensor, threshold_px: float) -> torch.Tensor:
    """(threshold_px / mean focal)^2, the squared Sampson cut."""
    return (threshold_px / (0.5 * (K[0, 0] + K[1, 1]))) ** 2


def essential_ransac_batch_core(
    kpts1: torch.Tensor,  # (P, N, 2) pixels
    kpts2: torch.Tensor,
    valid: torch.Tensor,  # (P, N) bool
    K: torch.Tensor,  # (3, 3)
    uniforms: torch.Tensor,  # (P, H, 8) in [0, 1)
    threshold_px: float = 3.0,
    score_subset: int = 0,
) -> EssentialResult:
    """:func:`sample_hypotheses`, then :func:`score_hypotheses`."""
    x1 = normalize_points(kpts1.to(torch.float32), K)
    x2 = normalize_points(kpts2.to(torch.float32), K)
    Es = sample_hypotheses(x1, x2, valid, uniforms)
    return score_hypotheses(Es, x1, x2, valid, sampson_threshold(K, threshold_px), score_subset)


def _triangulate_depths(R, t, x1, x2):
    """Closed-form two-view depths for x2 ~ R x1 + t, batched over the
    leading dims: R (..., 3, 3), t (..., 3), x (..., N, 2) -> (z1, z2)."""
    h1, h2 = to_homogeneous(x1), to_homogeneous(x2)
    Rx1 = h1 @ R.transpose(-1, -2)  # (..., N, 3)
    h2 = h2.expand_as(Rx1)
    c = torch.linalg.cross(h2, Rx1, dim=-1)
    ct = torch.linalg.cross(h2, t[..., None, :].expand_as(Rx1), dim=-1)
    z1 = -(ct * c).sum(-1) / (c * c).sum(-1).clamp_min(1e-12)
    z2 = Rx1[..., 2] * z1 + t[..., None, 2]
    return z1, z2


def recover_pose_batch(
    E: torch.Tensor,  # (P, 3, 3)
    kpts1: torch.Tensor,  # (P, N, 2) pixels
    kpts2: torch.Tensor,
    inlier_mask: torch.Tensor,  # (P, N) bool
    K: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cheirality-voted (R, t) from E (x2 = R x1 + t, |t| = 1).
    Returns (T (P, 4, 4), num_good (P,) int32, det R (P,))."""
    x1 = normalize_points(kpts1.to(torch.float32), K)
    x2 = normalize_points(kpts2.to(torch.float32), K)
    with sync_point("svd"):
        u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))[:, None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[:, None, None]
    with sync_point("upload_const"):
        W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                         dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    tvec = u[:, :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=1)  # (P, 4, 3, 3)
    ts = torch.stack([tvec, -tvec, tvec, -tvec], dim=1)  # (P, 4, 3)
    z1, z2 = _triangulate_depths(Rs, ts, x1[:, None], x2[:, None])  # (P, 4, N)
    scores = ((z1 > 0) & (z2 > 0) & inlier_mask[:, None, :]).sum(-1)
    best = scores.argmax(dim=1)
    ar = torch.arange(E.shape[0], device=E.device)
    R, t = Rs[ar, best], ts[ar, best]
    T = torch.eye(4, dtype=torch.float32, device=E.device).repeat(E.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return T, scores[ar, best].to(torch.int32), torch.linalg.det(R)


def essential_ransac_batch(
    kpts1: torch.Tensor,  # (P, N, 2)
    kpts2: torch.Tensor,
    valid: torch.Tensor,  # (P, N)
    K: torch.Tensor,  # (3, 3) shared intrinsics
    num_hypotheses: int = 512,
    threshold_px: float = 3.0,
    score_subset: int = 0,
    uniforms: Optional[torch.Tensor] = None,  # (P, H, 8)
    generator: Optional[torch.Generator] = None,
):
    """RANSAC + pose recovery for a batch of candidate pairs.
    Returns (EssentialResult, T (P, 4, 4), num_good (P,))."""
    P = kpts1.shape[0]
    K = torch.as_tensor(K, dtype=torch.float32, device=kpts1.device)
    if uniforms is None:
        uniforms = torch.rand((P, num_hypotheses, 8), generator=generator,
                              device=kpts1.device, dtype=torch.float32)
    elif uniforms.shape != (P, num_hypotheses, 8):
        raise ValueError(f"uniforms must be {(P, num_hypotheses, 8)}, got {tuple(uniforms.shape)}")
    res = essential_ransac_batch_core(
        kpts1, kpts2, valid, K, uniforms.to(kpts1.device), threshold_px, score_subset
    )
    T, good, _ = recover_pose_batch(res.E, kpts1, kpts2, res.inlier_mask, K)
    return res, T, good


def essential_ransac(kpts1, kpts2, valid, K, num_hypotheses: int = 512,
                     threshold_px: float = 3.0, score_subset: int = 0,
                     uniforms: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> EssentialResult:
    """Single-pair RANSAC: (N, 2) inputs, ``uniforms`` (H, 8)."""
    K = torch.as_tensor(K, dtype=torch.float32, device=kpts1.device)
    if uniforms is None:
        uniforms = torch.rand((num_hypotheses, 8), generator=generator,
                              device=kpts1.device, dtype=torch.float32)
    res = essential_ransac_batch_core(
        kpts1[None], kpts2[None], valid[None], K, uniforms[None], threshold_px, score_subset
    )
    return EssentialResult(*(x[0] for x in res))


def recover_pose(E, kpts1, kpts2, inlier_mask, K):
    """Single-pair :func:`recover_pose_batch`: (T (4, 4), num_good, det R)."""
    K = torch.as_tensor(K, dtype=torch.float32, device=kpts1.device)
    T, good, det = recover_pose_batch(E[None], kpts1[None], kpts2[None], inlier_mask[None], K)
    return T[0], good[0], det[0]
