"""Trajectory alignment: Umeyama SE(3)/Sim(3) and the reference's legacy
Kabsch variant.

Counterpart of ``mlis_tpu/eval/alignment.py``. Each function takes numpy
arrays (the host float64 path of the evaluation) or torch tensors, which
it aligns with torch operations on their own device; the JAX package's
``xp=`` argument is that choice, made here from the input's type.

  * ``umeyama`` is the canonical algorithm: SVD of the target/source
    covariance, det-sign correction S, scale = tr(diag(D) S) / var_src.
  * ``kabsch_sim3_legacy`` reproduces the reference evaluation's variant
    with its quirks: the scale's denominator carries +1e-10, and its
    "SE(3)" path still applies the Sim(3) scale (the published
    final_evaluation.json ATE numbers depend on it).
"""

from __future__ import annotations

import numpy as np
import torch


def _xp(a):
    return torch if isinstance(a, torch.Tensor) else np


def umeyama(source, target, with_scale: bool = True):
    """Umeyama alignment of source onto target.

    Returns (scale, R, t) with target ~= scale * R @ source + t.
    """
    xp = _xp(source)
    n = source.shape[0]
    mu_src = xp.mean(source, axis=0)
    mu_tgt = xp.mean(target, axis=0)
    src_c = source - mu_src
    tgt_c = target - mu_tgt

    var_src = xp.sum(src_c**2) / n
    cov = (tgt_c.T @ src_c) / n
    U, D, Vt = xp.linalg.svd(cov)

    d = xp.sign(xp.linalg.det(U) * xp.linalg.det(Vt))
    # S = diag(1, 1, d): flip the smallest singular direction on reflection
    s_diag = xp.stack([xp.ones_like(d), xp.ones_like(d), d])
    R = (U * s_diag[None, :]) @ Vt

    if with_scale:
        scale = xp.sum(D * s_diag) / var_src
    else:
        scale = xp.ones_like(var_src)
    t = mu_tgt - scale * (R @ mu_src)
    return scale, R, t


def apply_sim3(points, scale, R, t):
    """target-frame points = scale * R @ p + t, for (N, 3) arrays."""
    return scale * (points @ R.T) + t


def align_se3(source, target):
    """SE(3) (rigid) alignment; returns (aligned_source, R, t)."""
    scale, R, t = umeyama(source, target, with_scale=False)
    return apply_sim3(source, scale, R, t), R, t


def align_sim3(source, target):
    """Sim(3) (similarity) alignment; returns (aligned_source, scale, R, t)."""
    scale, R, t = umeyama(source, target, with_scale=True)
    return apply_sim3(source, scale, R, t), scale, R, t


def kabsch_sim3_legacy(est, ref, use_scale: bool = True):
    """The reference evaluation's alignment, quirks preserved.

    Returns (aligned_est, scale). With use_scale=False this still APPLIES
    the scale (the reference's align_se3 only *reports* 1.0), as the
    published final_evaluation.json ATE values require.
    """
    xp = _xp(est)
    est_c = xp.mean(est, axis=0)
    ref_c = xp.mean(ref, axis=0)
    est_centered = est - est_c
    ref_centered = ref - ref_c

    H = est_centered.T @ ref_centered
    U, _, Vt = xp.linalg.svd(H)
    d = xp.sign(xp.linalg.det(Vt.T @ U.T))
    s_diag = xp.stack([xp.ones_like(d), xp.ones_like(d), d])
    R = (Vt.T * s_diag[None, :]) @ U.T

    est_rot = (R @ est_centered.T).T
    scale = xp.sum(ref_centered * est_rot) / (xp.sum(est_rot * est_rot) + 1e-10)
    t = ref_c - scale * R @ est_c
    aligned = scale * (R @ est.T).T + t
    reported_scale = scale if use_scale else xp.ones_like(scale)
    return aligned, reported_scale
