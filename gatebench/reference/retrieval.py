"""Retrieval, pair dedup and the strict floor gate as the gate specifies them.

Descriptors are L2-normalised in float32 (+1e-8), rounded to bfloat16 and
multiplied in float32 (the gate's stated retrieval precision); temporal
neighbours closer than ``min_time_gap`` are masked; each frame keeps its
``k`` best (a stable descending sort: ties to the lower index); a
candidate is an unordered pair above ``threshold``; the strict floor
gate keeps the pairs of equal floor labels. Survivors are returned in
ascending (lo, hi) order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def gate(db: torch.Tensor, times: np.ndarray, floors: np.ndarray, k: int, threshold: float,
         min_time_gap: float, strict: bool = True) -> Tuple[int, int, List[Tuple[int, int]]]:
    """-> (candidate pairs, floor-rejected pairs, survivors)."""
    n = db.shape[0]
    k = min(k, n)
    x = db.to(torch.float32)
    dn = (x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)).to(torch.bfloat16)
    dn = dn.to(torch.float32)
    sims = dn @ dn.T
    t = torch.as_tensor(np.asarray(times, np.float32), device=db.device)
    sims = sims.masked_fill((t[None, :] - t[:, None]).abs() < min_time_gap, float("-inf"))
    vals, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()
    pairs = set()
    for i in range(n):
        for s, j in zip(vals[i], idx[i]):
            if np.isfinite(s) and s >= threshold:
                pairs.add((min(i, int(j)), max(i, int(j))))
    fl = np.asarray(floors)
    keep = [(a, b) for a, b in sorted(pairs)
            if (fl[a] == fl[b] if strict else abs(int(fl[a]) - int(fl[b])) <= 1)]
    return len(pairs), len(pairs) - len(keep), keep
