"""Descriptor aggregation: GeM pooling, VLAD and the cross-image patch
correlation.

Counterpart of ``mlis_tpu/ops/pooling.py``, float32 throughout:

* GeM p = 3, CricaVPR's descriptor pooling;
* hard-assignment VLAD, AnyLoc's aggregation: each token goes to the first
  nearest centre, residuals are summed per centre, intra-normalised, then
  the flattened vector is L2-normalised;
* the CricaVPR rerank score: L2-normalise both images' patch features,
  correlate, take the mean best match in each direction, clip at 0, and
  return the geometric mean of the two.
"""

from __future__ import annotations

import torch


def gem_pool(tokens: torch.Tensor, p: float = 3.0, eps: float = 1e-6) -> torch.Tensor:
    """Generalised-mean pooling over the token axis: (B, N, D) -> (B, D)."""
    x = tokens.to(torch.float32).clamp_min(eps)
    return (x**p).mean(1) ** (1.0 / p)


def nearest_center(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(..., D) points, (K, D) centres -> (...) index of the first nearest
    centre, the squared distances expanded as x^2 - 2 x.c + c^2 (in that
    order, as the reference computes them)."""
    d2 = (x * x).sum(-1, keepdim=True) - 2 * (x @ centers.T) + (centers * centers).sum(-1)
    return d2.argmin(-1)


def vlad_aggregate(tokens: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, N, D) local descriptors, (K, D) vocabulary -> (B, K * D): hard
    assignment by :func:`nearest_center`, residual sums through the one-hot
    product, intra-normalisation (eps 1e-12), then global L2."""
    x = tokens.to(torch.float32)
    c = centers.to(torch.float32)
    assign = torch.nn.functional.one_hot(nearest_center(x, c), c.shape[0]).to(torch.float32)
    sums = torch.einsum("bnk,bnd->bkd", assign, x)
    vlad = sums - assign.sum(1)[..., None] * c
    vlad = vlad / (torch.linalg.vector_norm(vlad, dim=-1, keepdim=True) + 1e-12)
    flat = vlad.reshape(vlad.shape[0], -1)
    return flat / (torch.linalg.vector_norm(flat, dim=-1, keepdim=True) + 1e-12)


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def _score_from_corr(corr: torch.Tensor) -> torch.Tensor:
    """(..., P, M) correlations -> (...) bidirectional best-match score."""
    ab = corr.amax(-1).mean(-1).clamp_min(0.0)
    ba = corr.amax(-2).mean(-1).clamp_min(0.0)
    return torch.sqrt(ab * ba)


def cross_correlation_score(patches_a: torch.Tensor, patches_b: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) patch features -> scalar correlation score."""
    a = _l2n(patches_a.to(torch.float32))
    b = _l2n(patches_b.to(torch.float32))
    return _score_from_corr(a @ b.T)


def cross_correlation_scores_batch(
    query_patches: torch.Tensor,  # (N, D)
    candidate_patches: torch.Tensor,  # (C, M, D)
) -> torch.Tensor:
    """One query against C candidates: (C,) scores."""
    a = _l2n(query_patches.to(torch.float32))
    b = _l2n(candidate_patches.to(torch.float32))
    return _score_from_corr(torch.einsum("pd,cmd->cpm", a, b))


def cross_correlation_scores_pairs(
    patch_stack: torch.Tensor,  # (N, P, D) patch features of all images
    query_idx: torch.Tensor,  # (Q,) query image indices
    cand_idx: torch.Tensor,  # (Q, K) candidate image indices per query
    batch_size: int = 32,
) -> torch.Tensor:
    """Every query's rerank scores, (Q, K), in batches of ``batch_size``
    query rows (the JAX package's ``lax.map``); each batch gathers its
    (b, K, P, D) candidate block and correlates it, so memory stays
    O(batch_size * K * P * P)."""
    ps = _l2n(patch_stack.to(torch.float32))
    query_idx = torch.as_tensor(query_idx, device=ps.device).long()
    cand_idx = torch.as_tensor(cand_idx, device=ps.device).long()
    out = []
    for s in range(0, query_idx.shape[0], batch_size):
        q = ps[query_idx[s : s + batch_size]]  # (b, P, D)
        c = ps[cand_idx[s : s + batch_size]]  # (b, K, P, D)
        out.append(_score_from_corr(torch.einsum("bpd,bkqd->bkpq", q, c)))
    if not out:
        return torch.zeros(tuple(cand_idx.shape), dtype=torch.float32, device=ps.device)
    return torch.cat(out)
