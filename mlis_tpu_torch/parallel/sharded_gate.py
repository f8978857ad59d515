"""Multi-card full-gate inference step over a device mesh.

Counterpart of ``mlis_tpu/parallel/sharded_gate.py``, run SPMD on
torch.distributed: every rank calls the step with the full host arrays and
takes its slab of the keyframe axis. Decomposition:

  * ENCODE + DETECT on the rank's keyframe slab — no communication.
  * RETRIEVAL all-gathers the (N, D) descriptor matrix so each rank
    retrieves for its own query slab against the full database (the
    query-sharded layout of parallel/distributed_knn.py).
  * GATE + BUDGETED SELECTION stay local per query slab with DIRECTED match
    semantics; the global statistics come from one int64 all_reduce.
  * VERIFY runs the fused match+RANSAC program on each rank's top-B accepted
    pairs. Keypoints are all-gathered once (pairs may span shards, so every
    rank holds the full keypoint table); the verdicts are gathered so every
    rank returns all ``n_dev * B`` slots, like the reference's out_specs.

RANSAC draws come from a generator seeded with the rank (the reference
folds the device index into ``PRNGKey(0)``), or from ``uniforms=``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mlis_tpu_torch.models.superpoint import Keypoints
from mlis_tpu_torch.ops.image import to_grayscale
from mlis_tpu_torch.ops.knn import cosine_topk, topk_lower_index
from mlis_tpu_torch.parallel.mesh import DATA_AXIS

def _gather0(x: torch.Tensor, group, n: int) -> torch.Tensor:
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def make_sharded_gate_program(
    mesh: DeviceMesh,
    matcher,
    encode_fn: Callable,
    n_frames: int,
    hw: Tuple[int, int],
    K: np.ndarray,
    *,
    top_k: int,
    threshold: float,
    min_time_gap: float,
    budget: int,
    ransac_threshold: float = 3.0,
    match_top_k: int = 0,
) -> Callable:
    """Build the sharded gate program:
    (images, t_loc, fl_loc, t_all, fl_all, uniforms=None) ->
    (qi, mi, slot_ok, n_match, n_inliers, ratio, n_confident, stats,
    per_device_accepted, max_accepted).

    Inputs are the full arrays on the matcher's device; the first three are
    split over ``data`` (each rank takes its slab). Outputs are whole on
    every rank: the ``(n_dev * budget,)`` slots, the three directed counts,
    the ``(n_dev,)`` accepted counts, and their maximum from an
    all_reduce(MAX). ``uniforms`` (n_dev * budget, H, 8) feeds RANSAC, each
    rank its slab; without it the draws come from a generator seeded with
    the rank. The program closes over the matcher's K on the card; the
    reference caches its programs to save their compiles, and this one has
    none to save."""
    H, W = hw
    h8, w8 = (H // 8) * 8, (W // 8) * 8
    group = mesh.get_group(DATA_AXIS)
    n_dev, rank = dist.get_world_size(group), mesh.get_local_rank(DATA_AXIS)
    shard = n_frames // n_dev
    kk = min(top_k, n_frames)
    B = int(budget)
    fused = matcher.make_fused_match_verify(hw, K, ransac_threshold)
    dev = matcher.device
    sl = slice(rank * shard, (rank + 1) * shard)
    sxy = torch.tensor([W / w8, H / h8], dtype=torch.float32, device=dev)

    @torch.no_grad()
    def program(images, t_loc, fl_loc, t_all, fl_all, uniforms=None):
        # encode + detect: the rank's keyframe slab
        imgs = images[sl]
        desc_loc = encode_fn(imgs)  # (shard, D)
        kp_loc = matcher.sp.detect(to_grayscale(imgs, size=(h8, w8)))
        if (h8, w8) != (H, W):
            kp_loc = kp_loc._replace(coords=kp_loc.coords * sxy)
        if match_top_k and match_top_k < kp_loc.coords.shape[1]:
            # keypoints are detector-score-sorted, so the pruned set is a
            # prefix slice (prefix-valid mask preserved)
            kp_loc = kp_loc.map(lambda x: x[:, :match_top_k])

        # replicate descriptors + keypoints
        desc_all = _gather0(desc_loc, group, n_dev)
        kp_all = Keypoints(*(_gather0(x, group, n_dev) for x in kp_loc))

        # retrieval: local query slab vs the full database
        scores, idx = cosine_topk(desc_loc, desc_all, t_loc[sl], t_all, k=kk,
                                  min_time_gap=min_time_gap)
        valid = torch.isfinite(scores) & (scores >= threshold)
        accept = valid & (fl_loc[sl][:, None] == fl_all[idx.long()])

        # global directed statistics: one all_reduce
        stats = torch.stack([valid.sum(), (valid & ~accept).sum(), accept.sum()]).to(torch.int64)
        dist.all_reduce(stats, group=group)
        acc_cnt = accept.sum().to(torch.int64).reshape(1)
        max_acc = acc_cnt.clone()
        dist.all_reduce(max_acc, op=dist.ReduceOp.MAX, group=group)

        # budgeted selection: this rank's top-B accepted pairs by score,
        # ties to the lower position as with lax.top_k
        flat = torch.where(accept, scores, torch.full_like(scores, float("-inf"))).reshape(-1)
        top_s, pos = topk_lower_index(flat, B)
        slot_ok = torch.isfinite(top_s)
        zero = torch.zeros_like(pos)
        qi = torch.where(slot_ok, rank * shard + torch.div(pos, kk, rounding_mode="floor"), zero)
        mi = torch.where(slot_ok, idx.reshape(-1)[pos].long(), zero)

        generator = None
        if uniforms is not None:
            uniforms = uniforms[rank * B:(rank + 1) * B].to(dev)
        else:
            generator = torch.Generator(device=dev).manual_seed(rank)
        _, _, n_match, n_inl, ratio, _, _, n_conf = fused(kp_all, qi, mi, uniforms=uniforms,
                                                          generator=generator)
        ints = torch.cat([torch.stack([qi, mi, slot_ok.long(), n_match.long(), n_inl.long(),
                                       n_conf.long()]).reshape(-1), acc_cnt])
        ints = _gather0(ints[None], group, n_dev)  # (n_dev, 6 B + 1)
        ratios = _gather0(ratio.to(torch.float32), group, n_dev)
        cols = ints[:, :-1].reshape(n_dev, 6, B).permute(1, 0, 2).reshape(6, n_dev * B)
        qi_a, mi_a, ok_a, nm_a, ni_a, nc_a = cols
        return (qi_a, mi_a, ok_a.bool(), nm_a, ni_a, ratios, nc_a, stats, ints[:, -1], max_acc[0])

    return program


def sharded_full_gate_step(
    mesh: DeviceMesh,
    matcher,  # LightGlue-style: .sp.detect, .make_fused_match_verify, .device
    encode_fn: Callable,  # (B, H, W, C) uint8/float tensor -> (B, D) descriptors
    images: np.ndarray,  # (N, H, W, C); N divisible by the mesh's data size
    timestamps: np.ndarray,
    floor_labels: np.ndarray,
    K: np.ndarray,
    top_k: int = 10,
    threshold: float = 0.5,
    min_time_gap: float = 10.0,
    per_device_budget: int = 16,
    ransac_threshold: float = 3.0,
    exact: bool = True,
    match_top_k: int = 0,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """One multi-card gate step; every rank of the mesh calls it with the
    same arguments and gets the same result.

    Returns (verdicts, stats):
      verdicts: dict of (n_dev * budget,) arrays — qi, mi, slot_valid,
        n_matches, n_inliers, inlier_ratio, n_confident — for each rank's
        budgeted accepted pairs (slot_valid False marks unused slots).
      stats: global DIRECTED counts {total, rejected, accepted}, plus
        {verified, dropped, budget_used}.

    Exactness contract (the single-card fused path's overflow fallback):
    when ``exact`` (default) and any rank's accepted count overflows
    per_device_budget, the step reruns with the budget raised to the next
    power of two >= the largest per-rank accepted count, so accepted pairs
    are NEVER silently dropped. That count comes from an all_reduce(MAX),
    so every rank takes the same decision (a rank rerunning alone would
    deadlock its peers at their next collective). With exact=False,
    overflow keeps each rank's top-budget pairs by score and reports the
    drop in stats['dropped'].

    match_top_k > 0 prunes each keyframe's keypoints to the top-K by
    detector score BEFORE the all-gather. ``uniforms`` must then hold
    (n_dev * budget_used, 512, 8) draws."""
    group = mesh.get_group(DATA_AXIS)
    n_dev = dist.get_world_size(group)
    N = int(images.shape[0])
    if N % n_dev:
        raise ValueError(f"{N} keyframes do not shard over {n_dev} devices")
    shard = N // n_dev
    H, W = int(images.shape[1]), int(images.shape[2])
    kk = min(top_k, N)
    # clamp: each rank's candidate pool is shard * kk entries
    B = min(int(per_device_budget), shard * kk)
    dev = matcher.device
    t = torch.as_tensor(np.asarray(timestamps, np.float32), device=dev)
    fl = torch.as_tensor(np.asarray(floor_labels, np.int32), device=dev)
    imgs_dev = torch.as_tensor(np.ascontiguousarray(images), device=dev)

    def run(B: int):
        if uniforms is not None and uniforms.shape[0] != n_dev * B:
            raise ValueError(f"uniforms hold {uniforms.shape[0]} draws, the step runs "
                             f"{n_dev} x {B} slots")
        prog = make_sharded_gate_program(
            mesh, matcher, encode_fn, N, (H, W), K,
            top_k=top_k, threshold=threshold, min_time_gap=min_time_gap,
            budget=B, ransac_threshold=ransac_threshold, match_top_k=match_top_k,
        )
        out = prog(imgs_dev, t, fl, t, fl, uniforms=uniforms)
        return [x.cpu().numpy() for x in out]

    qi, mi, ok, n_match, n_inl, ratio, n_conf, stats, dev_acc, max_acc = run(B)
    if exact and int(max_acc) > B:
        # overflow: raise the budget to the next power of two covering the
        # worst rank and rerun — the accepted sets don't depend on B, so
        # one rerun restores exactness
        B = min(1 << (int(max_acc) - 1).bit_length(), shard * kk)
        qi, mi, ok, n_match, n_inl, ratio, n_conf, stats, dev_acc, max_acc = run(B)
    verdicts = {
        "qi": qi.astype(np.int32),
        "mi": mi.astype(np.int32),
        "slot_valid": ok,
        "n_matches": n_match.astype(np.int32),
        "n_inliers": n_inl.astype(np.int32),
        "inlier_ratio": ratio,
        "n_confident": n_conf.astype(np.int32),
    }
    return verdicts, {
        "total": int(stats[0]),
        "rejected": int(stats[1]),
        "accepted": int(stats[2]),
        "verified": int(ok.sum()),
        "dropped": int(np.maximum(dev_acc - B, 0).sum()),
        "budget_used": B,
    }
