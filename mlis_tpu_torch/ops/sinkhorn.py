"""Log-space Sinkhorn optimal transport with a fixed iteration count.

Counterpart of ``mlis_tpu/ops/sinkhorn.py``: SALAD's descriptor
aggregation (3 iterations) and SuperGlue-style matchers (20, with a
dustbin row and column). All arithmetic is float32 in log space; the
marginals default to uniform.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def sinkhorn_log(
    scores: torch.Tensor,  # (..., M, N) affinity logits
    num_iters: int = 20,
    log_mu: Optional[torch.Tensor] = None,  # (..., M) log row marginals
    log_nu: Optional[torch.Tensor] = None,  # (..., N) log column marginals
) -> torch.Tensor:
    """The log transport plan log P whose rows and columns match the
    marginals after ``num_iters`` alternating updates."""
    s = scores.to(torch.float32)
    M, N = s.shape[-2], s.shape[-1]
    if log_mu is None:
        log_mu = torch.full(s.shape[:-1], -math.log(M), dtype=torch.float32, device=s.device)
    if log_nu is None:
        log_nu = torch.full((*s.shape[:-2], N), -math.log(N), dtype=torch.float32,
                            device=s.device)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iters):
        u = log_mu - torch.logsumexp(s + v[..., None, :], dim=-1)
        v = log_nu - torch.logsumexp(s + u[..., None], dim=-2)
    return s + u[..., None] + v[..., None, :]


def sinkhorn_with_dustbin(
    scores: torch.Tensor,  # (B, M, N)
    alpha: torch.Tensor,  # scalar dustbin logit
    num_iters: int = 20,
) -> torch.Tensor:
    """SuperGlue's partial assignment: a dustbin row and column with logit
    ``alpha`` take the unmatched points. Returns the (B, M+1, N+1) log
    assignment, rescaled so that each point's row sums to about 1."""
    B, M, N = scores.shape
    s = scores.to(torch.float32)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=s.device).reshape(1, 1, 1)
    aug = torch.cat([torch.cat([s, a.expand(B, M, 1)], dim=2),
                     torch.cat([a.expand(B, 1, N), a.expand(B, 1, 1)], dim=2)], dim=1)
    norm = -math.log(float(M + N))

    def marginal(n_points: int, n_other: int) -> torch.Tensor:
        m = torch.full((B, n_points + 1), norm, dtype=torch.float32, device=s.device)
        m[:, -1] = math.log(float(n_other)) + norm
        return m

    out = sinkhorn_log(aug, num_iters, marginal(M, N), marginal(N, M))
    return out - norm
