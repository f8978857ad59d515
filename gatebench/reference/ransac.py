"""Essential-matrix RANSAC as the gate specifies it, in plain PyTorch float32.

Each hypothesis draws 8 of a pair's valid correspondences (valid ones
first, in index order; draw = floor(u * n_valid), at most n_valid - 1)
and solves the gauge-fixed (E_33 = 1) 8-point normal equations by
Gauss-Jordan elimination without pivoting. Every hypothesis is scored by
its Sampson inliers in normalised coordinates under (threshold_px / mean
focal)^2; the 8 best by count (ties to the lower index) are projected
onto the essential manifold by SVD and rescored; the first best wins.
"""

from __future__ import annotations

import torch

TOP_K = 8


def _normalise(pts, K):
    return torch.stack([(pts[..., 0] - K[0, 2]) / K[0, 0], (pts[..., 1] - K[1, 2]) / K[1, 1]], -1)


def _hom(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _solve(M, b):
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


def _eight_point(x1, x2):
    A = (_hom(x2)[..., :, None] * _hom(x1)[..., None, :]).reshape(*x1.shape[:-1], 9)
    A8, a9 = A[..., :8], A[..., 8]
    M = A8.transpose(-1, -2) @ A8 + 1e-10 * torch.eye(8, dtype=A.dtype, device=A.device)
    e8 = _solve(M, -(A8.transpose(-1, -2) @ a9[..., None])[..., 0])
    return torch.cat([e8, torch.ones_like(e8[..., :1])], -1).reshape(*e8.shape[:-1], 3, 3)


def _sampson(E, x1, x2):
    e = E[..., None, :, :]
    u1, v1 = x1[:, None, :, 0], x1[:, None, :, 1]
    u2, v2 = x2[:, None, :, 0], x2[:, None, :, 1]
    ex = [e[..., i, 0] * u1 + e[..., i, 1] * v1 + e[..., i, 2] for i in range(3)]
    etx = [e[..., 0, j] * u2 + e[..., 1, j] * v2 + e[..., 2, j] for j in range(2)]
    err = u2 * ex[0] + v2 * ex[1] + ex[2]
    denom = ex[0] ** 2 + ex[1] ** 2 + etx[0] ** 2 + etx[1] ** 2
    return err**2 / denom.clamp_min(1e-12)


def inliers(k1, k2, valid, K, uniforms, threshold_px: float):
    """(P, N, 2) pixel correspondences, (P, N) validity, (P, H, 8) draws ->
    (num_inliers (P,) int64, inlier_ratio (P,) float32)."""
    P = valid.shape[0]
    x1, x2 = _normalise(k1.to(torch.float32), K), _normalise(k2.to(torch.float32), K)
    n_valid = valid.sum(1)
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True)[1]
    draw = (uniforms * n_valid.clamp_min(1)[:, None, None].to(torch.float32)).to(torch.int64)
    draw = torch.minimum(draw, (n_valid - 1).clamp_min(0)[:, None, None])
    idx = order.gather(1, draw.reshape(P, -1)).reshape(draw.shape)

    def pick(x):
        return x.gather(1, idx.reshape(P, -1, 1).expand(-1, -1, 2)).reshape(*idx.shape, 2)

    Es = _eight_point(pick(x1), pick(x2))
    thr = (threshold_px / (0.5 * (K[0, 0] + K[1, 1]))) ** 2
    counts = ((_sampson(Es, x1, x2) < thr) & valid[:, None, :]).sum(-1)
    cand = torch.sort(counts, dim=-1, descending=True, stable=True)[1][..., :TOP_K]
    E = Es.gather(1, cand[..., None, None].expand(-1, -1, 3, 3))
    u, _, vt = torch.linalg.svd(E)
    E = (u * torch.tensor([1.0, 1.0, 0.0], device=E.device)) @ vt
    counts_c = ((_sampson(E, x1, x2) < thr) & valid[:, None, :]).sum(-1)
    num = counts_c.gather(1, counts_c.argmax(1, keepdim=True))[:, 0]
    return num, num.to(torch.float32) / n_valid.clamp_min(1).to(torch.float32)
