"""Batched SO(3)/SE(3) Lie-group maps on torch tensors.

Counterpart of ``mlis_tpu/opt/lie.py``: the tangent-space parameterisation
of the pose-graph solver (``opt/pose_graph.py``). Everything is batched
over leading axes, differentiable under ``torch.func`` (forward and
reverse mode), and safe at theta -> 0 through Taylor branches chosen with
``torch.where`` on masked-safe operands. Both branches of a ``where`` are
computed and both reach the derivative, so the unselected branch must be
finite and have a finite derivative too (the "double where"): its
cotangent is multiplied by zero, and 0 * inf is NaN.

Tangent convention: xi = [rho (3), omega (3)], translation first; the
retraction is the right perturbation T <- T @ Exp(xi).

The 3 x 3 products and matrix-vector products are elementwise multiplies
and sums, not matmuls: a float32 matmul may run on TF32 tensor cores on
the card, which would move a solve hundreds of CG steps deep on the card
only.
"""

from __future__ import annotations

import torch

# Taylor-branch cutoff on theta^2 (theta < 0.01 rad). It must be large for
# float32: (1 - cos(theta)) rounds to exactly 0.0f for theta^2 up to about
# 1.2e-7 (B = (1 - cos) / t^2 would be zero and V^-1 divide by it), while
# the series' error at theta = 0.01 is about theta^4 / 120 ~ 1e-10, far
# below float32's epsilon. Under the cutoff the series is the more
# accurate branch.
_SMALL = 1e-4


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as a multiply and a sum over k."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def matvec3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as a multiply and a sum over j."""
    return (a * v[..., None, :]).sum(-1)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi) with the JAX package's derivative: at a bound the
    two sides of ``maximum`` / ``minimum`` share it, 0.5 each (``torch.clamp``
    gives 1 there, and a pose graph's switches start exactly at 1)."""
    full = lambda v: torch.full((), v, dtype=x.dtype, device=x.device)  # noqa: E731
    return torch.minimum(torch.maximum(x, full(lo)), full(hi))


_CONSTANTS = {}  # (name, device, dtype) -> the (3, 3, 3) eps_ijk or the (3, 3) identity


def _constant(name: str, like: torch.Tensor) -> torch.Tensor:
    """A small constant on ``like``'s device, made there once (not inside a
    CUDA graph capture: the solvers run every map eagerly first)."""
    key = (name, like.device, like.dtype)
    if key not in _CONSTANTS:
        if name == "eye":
            c = torch.eye(3, dtype=like.dtype)
        else:
            c = torch.zeros(3, 3, 3, dtype=like.dtype)
            for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
                c[i, j, k], c[j, i, k] = -1.0, 1.0
        _CONSTANTS[key] = c.to(like.device)
    return _CONSTANTS[key]


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix [w]x, as a sum over k
    of -eps_ijk w_k: each entry is one signed w_k plus two zeros, so it is
    exact, in two kernels."""
    return (_constant("levi", w) * w[..., None, None, :]).sum(-1)


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew-symmetric -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return _constant("eye", W).expand(W.shape)


def _sin_coeffs(theta_sq: torch.Tensor):
    """Rodrigues coefficients A = sin(t)/t, B = (1-cos(t))/t^2 and
    C = (1-A)/t^2, with Taylor branches at t -> 0 (double where: the
    analytic branch divides by a safe theta_sq)."""
    small = theta_sq < _SMALL
    ts_safe = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(ts_safe)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / ts_safe)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - a) / ts_safe)
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues)."""
    theta_sq = (w * w).sum(-1)
    a, b, _ = _sin_coeffs(theta_sq)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * matmul3(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle.

    Accurate away from theta = pi (pose-graph residuals live near 0).
    Differentiable at theta -> 0: theta comes from atan2(sin, cos), smooth
    at (0, 1) where acos's derivative is infinite, and the small-angle
    branch is chosen with the double where.
    """
    # vee(R - R^T) = 2 sin(theta) * axis, as the contraction over i, j of
    # -eps_ijk R_ij: two nonzero terms, R_ji - R_ij, so it is exact
    w_vee = (_constant("levi", R) * R[..., :, :, None]).sum((-3, -2))
    sin_sq = (w_vee * w_vee).sum(-1) * 0.25  # sin^2(theta)
    cos_t = clip((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    small = sin_sq < _SMALL
    sin_safe = torch.sqrt(torch.where(small, 1.0, sin_sq))
    theta = torch.atan2(sin_safe, cos_t)
    # w = theta / (2 sin) * vee; Taylor (theta^2 ~ 2 (1 - cos)):
    # 1/2 + theta^2/12 ~ 1/2 + (1 - cos)/6
    scale = torch.where(small, 0.5 + (1.0 - cos_t) / 6.0, theta / (2.0 * sin_safe))
    return scale[..., None] * w_vee


def se3_exp(xi: torch.Tensor):
    """(..., 6) [rho, omega] -> ((..., 3, 3) R, (..., 3) t) with t = V rho."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta_sq = (w * w).sum(-1)
    a, b, c = _sin_coeffs(theta_sq)
    W = hat(w)
    WW = matmul3(W, W)
    eye = _eye_like(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    return R, matvec3(V, rho)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """((..., 3, 3), (..., 3)) -> (..., 6) [rho, omega] with rho = V^-1 t."""
    w = so3_log(R)
    theta_sq = (w * w).sum(-1)
    a, b, _ = _sin_coeffs(theta_sq)
    W = hat(w)
    WW = matmul3(W, W)
    # V^-1 = I - W/2 + k WW, k = (1 - A/(2B)) / t^2; Taylor k -> 1/12, with
    # the double where of _sin_coeffs
    small = theta_sq < _SMALL
    ts_safe = torch.where(small, 1.0, theta_sq)
    b_safe = torch.where(small, 0.5, b)
    k = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0, (1.0 - a / (2.0 * b_safe)) / ts_safe)
    V_inv = _eye_like(W) - 0.5 * W + k[..., None, None] * WW
    return torch.cat([matvec3(V_inv, t), w], -1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) @ (Rb, tb): batched rigid-transform composition."""
    return matmul3(Ra, Rb), matvec3(Ra, tb) + ta


def se3_inv(R, t):
    """Batched rigid-transform inverse."""
    Rt = R.transpose(-1, -2)
    return Rt, -matvec3(Rt, t)


def se3_retract(R, t, xi):
    """Right-perturbation retraction: T <- T @ Exp(xi), batched."""
    dR, dt = se3_exp(xi)
    return se3_compose(R, t, dR, dt)
