"""Batched cosine-similarity retrieval (kNN) for place recognition.

Counterpart of ``mlis_tpu/ops/knn.py``. Descriptors are L2-normalised in
float32 and rounded to the compute dtype (bfloat16 by default); the
similarity GEMM then accumulates the exact products in float32, as the
JAX version's ``preferred_element_type=float32`` does. (On CUDA this needs
TF32 matmuls off, PyTorch's default.)

Ties go to the LOWER index, as with ``lax.top_k``: the top-k comes from a
stable descending sort. Exact ties are the normal case when keyframes
repeat, and ``torch.topk`` promises no order among them on CUDA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-8, dim: int = -1) -> torch.Tensor:
    """Row normalisation with the +eps convention."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def _normalized(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Normalise in float32, round to ``compute_dtype``, return float32."""
    return l2_normalize(x.to(torch.float32)).to(compute_dtype).to(torch.float32)


def topk_lower_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cosine_topk(
    queries: torch.Tensor,  # (Q, D)
    database: torch.Tensor,  # (N, D)
    query_times: Optional[torch.Tensor] = None,  # (Q,)
    db_times: Optional[torch.Tensor] = None,  # (N,)
    k: int = 10,
    min_time_gap: float = 10.0,
    chunk: int = 1024,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine matches per query with temporal-neighbour masking.

    Returns (scores (Q, k) float32, indices (Q, k) int32); masked entries
    come back as -inf scores."""
    qn = _normalized(queries, compute_dtype)
    dbn_t = _normalized(database, compute_dtype).T
    masked = query_times is not None and db_times is not None
    scores, idx = [], []
    for s in range(0, qn.shape[0], chunk):
        sims = qn[s : s + chunk] @ dbn_t
        if masked:
            gap = (db_times.to(torch.float32)[None, :]
                   - query_times[s : s + chunk].to(torch.float32)[:, None]).abs()
            sims = sims.masked_fill(gap < min_time_gap, float("-inf"))
        v, i = topk_lower_index(sims, k)
        scores.append(v)
        idx.append(i.to(torch.int32))
    return torch.cat(scores), torch.cat(idx)


def pairwise_similarity(
    descriptors: torch.Tensor,
    chunk: int = 2048,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Full N x N cosine similarity matrix, in query chunks."""
    dn = _normalized(descriptors, compute_dtype)
    return torch.cat([dn[s : s + chunk] @ dn.T for s in range(0, dn.shape[0], chunk)])


def loop_closure_topk(
    descriptors: torch.Tensor,  # (N, D)
    timestamps: torch.Tensor,  # (N,)
    k: int = 10,
    min_time_gap: float = 10.0,
    chunk: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """Every frame against the whole database, itself and its temporal
    neighbours masked: host (scores (N, k), indices (N, k))."""
    scores, idx = cosine_topk(descriptors, descriptors, timestamps, timestamps, k=k,
                              min_time_gap=min_time_gap, chunk=chunk)
    return scores.cpu().numpy(), idx.cpu().numpy()
