"""Sharded cosine top-k retrieval over a device mesh.

Counterpart of ``mlis_tpu/parallel/distributed_knn.py``, SPMD: every rank
calls with the full host arrays and takes its slab. The QUERY axis shards
over ``data`` (each rank owns a query slab and scans the full database),
or, for databases too large to replicate, the DATABASE axis shards and the
per-shard top-k merge after one all-gather (k << N, so the collective moves
k results per rank, not the similarity matrix).

Each rank runs :func:`mlis_tpu_torch.ops.knn.cosine_topk` on its slab. The
merge keeps the lower position first among equal scores, as ``lax.top_k``
does (``torch.topk`` promises no order among ties): duplicated descriptors
and the ``-inf`` of masked entries tie exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mlis_tpu_torch.ops.knn import cosine_topk, topk_lower_index
from mlis_tpu_torch.parallel.mesh import DATA_AXIS, axis_slice


def _no_times(Q: int, N: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros(Q, dtype=torch.float32, device=device),
            torch.full((N,), 1e18, dtype=torch.float32, device=device))


def query_sharded_topk(
    mesh: DeviceMesh,
    queries: torch.Tensor,  # (Q, D) — Q divisible by the mesh's data size
    database: torch.Tensor,  # (N, D) replicated
    query_times: Optional[torch.Tensor] = None,
    db_times: Optional[torch.Tensor] = None,
    k: int = 10,
    min_time_gap: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each rank retrieves for its slab of queries against the full
    database; the (Q, k) results are gathered so every rank returns them
    whole."""
    if query_times is None:
        query_times, db_times = _no_times(queries.shape[0], database.shape[0], queries.device)
    sl = axis_slice(mesh, queries.shape[0])
    scores, idx = cosine_topk(queries[sl], database, query_times[sl], db_times, k=k,
                              min_time_gap=min_time_gap)
    group = mesh.get_group(DATA_AXIS)
    n = dist.get_world_size(group)
    all_s = scores.new_empty((n * scores.shape[0], scores.shape[1]))
    all_i = idx.new_empty((n * idx.shape[0], idx.shape[1]))
    dist.all_gather_into_tensor(all_s, scores.contiguous(), group=group)
    dist.all_gather_into_tensor(all_i, idx.contiguous(), group=group)
    return all_s, all_i


def db_sharded_topk(
    mesh: DeviceMesh,
    queries: torch.Tensor,  # (Q, D) replicated
    database: torch.Tensor,  # (N, D) — N divisible by the mesh's data size
    query_times: Optional[torch.Tensor] = None,
    db_times: Optional[torch.Tensor] = None,
    k: int = 10,
    min_time_gap: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Database sharded over ``data``; per-shard top-k merged via one
    all-gather. Returns (scores (Q, k), GLOBAL database indices (Q, k))."""
    group = mesh.get_group(DATA_AXIS)
    n_dev = dist.get_world_size(group)
    N, Q = database.shape[0], queries.shape[0]
    if query_times is None:
        query_times, db_times = _no_times(Q, N, queries.device)
    sl = axis_slice(mesh, N)
    scores, idx = cosine_topk(queries, database[sl], query_times, db_times[sl], k=k,
                              min_time_gap=min_time_gap)
    # globalize indices by this shard's offset, then gather every shard's
    # candidates: (n_dev, Q, k)
    idx = idx + sl.start
    all_s = scores.new_empty((n_dev * Q, scores.shape[1]))
    all_i = idx.new_empty((n_dev * Q, idx.shape[1]))
    dist.all_gather_into_tensor(all_s, scores.contiguous(), group=group)
    dist.all_gather_into_tensor(all_i, idx.contiguous(), group=group)
    merged_s = all_s.view(n_dev, Q, -1).permute(1, 0, 2).reshape(Q, -1)
    merged_i = all_i.view(n_dev, Q, -1).permute(1, 0, 2).reshape(Q, -1)
    top_s, pos = topk_lower_index(merged_s, k)
    return top_s, merged_i.gather(1, pos)
