"""Online (streaming) semantic loop-closure gate.

Counterpart of ``mlis_tpu/gating/streaming.py``: a front end that sees
one keyframe at a time gets gated loop-closure candidates with bounded
latency.

  * A fixed-capacity ring buffer of descriptors, floor labels, timestamps
    and global frame ids lives on the gate's device and is updated in
    place.
  * Each keyframe of a micro-batch retrieves against every frame inserted
    before it, earlier frames of the same micro-batch included, then is
    inserted; eviction is oldest-first (ring overwrite), counted in
    ``stats["evicted"]``.
  * The decision order is the offline gate's: top-k over the time-gap-
    masked cosine similarities first (ties to the lower ring slot), then
    the similarity threshold, then the floor gate on the surviving top-k.
    A cross-floor candidate inside the top-k consumes its slot.
  * Similarities are those of ``ops/knn``: unit descriptors rounded to
    bfloat16, products summed in float32. The ring holds the rounded
    descriptors in float32, so each step is one float32 GEMV, exact in
    its products whatever the TF32 setting (bfloat16 values are exact in
    TF32).

The JAX package runs a micro-batch as one ``lax.scan``; the port runs the
same step per keyframe, and brings a micro-batch's results to the host in
one copy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mlis_tpu_torch.ops.knn import l2_normalize, topk_lower_index


@dataclass
class StreamingState:
    """Device-resident ring buffer."""

    desc: torch.Tensor  # (C, D) unit descriptors rounded to bfloat16, in float32
    times: torch.Tensor  # (C,) float32
    floors: torch.Tensor  # (C,) int32
    ids: torch.Tensor  # (C,) int32 global frame id, -1 = empty
    count: torch.Tensor  # () int32 total frames ever inserted


@dataclass
class StreamingMatches:
    """Gated top-k candidates for one micro-batch (host-side view)."""

    query_ids: np.ndarray  # (M,)
    match_ids: np.ndarray  # (M, k) global frame ids, -1 where no match
    scores: np.ndarray  # (M, k) cosine similarity, -inf where no match
    cross_floor_rejected: int  # above-threshold candidates the gate removed

    def pairs(self) -> List[Tuple[int, int, float]]:
        out = []
        for qi, q in enumerate(self.query_ids):
            for j in range(self.match_ids.shape[1]):
                m = int(self.match_ids[qi, j])
                if m >= 0:
                    out.append((int(q), m, float(self.scores[qi, j])))
        return out


def _init_state(capacity: int, dim: int, device) -> StreamingState:
    return StreamingState(
        desc=torch.zeros((capacity, dim), dtype=torch.float32, device=device),
        times=torch.full((capacity,), float("-inf"), dtype=torch.float32, device=device),
        floors=torch.zeros((capacity,), dtype=torch.int32, device=device),
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _stream_step(
    state: StreamingState,
    new_desc: torch.Tensor,  # (M, D) unit descriptors
    new_times: torch.Tensor,  # (M,) float32
    new_floors: torch.Tensor,  # (M,) int32
    start: int,  # global id of the first frame (= frames inserted before)
    k: int,
    strict_floor: bool,
    min_time_gap: float,
    threshold: float,
) -> torch.Tensor:
    """One micro-batch, retrieve-then-insert per keyframe; updates
    ``state`` in place. Returns (M, 2k + 1) float64: the scores, the match
    ids and each frame's cross-floor rejections."""
    C = state.desc.shape[0]
    M = new_desc.shape[0]
    q = new_desc.to(torch.bfloat16).to(torch.float32)
    out = torch.empty((M, 2 * k + 1), dtype=torch.float64, device=q.device)
    for i in range(M):
        sims = state.desc @ q[i]  # (C,)
        eligible = (state.ids >= 0) & ((state.times - new_times[i]).abs() >= min_time_gap)
        scores, slot = topk_lower_index(torch.where(eligible, sims, float("-inf")), k)
        above = torch.isfinite(scores) & (scores >= threshold)
        diff = (state.floors[slot] - new_floors[i]).abs()
        floor_ok = diff == 0 if strict_floor else diff <= 1
        accept = above & floor_ok
        out[i, :k] = torch.where(accept, scores, float("-inf"))
        out[i, k : 2 * k] = torch.where(accept, state.ids[slot], -1)
        out[i, 2 * k] = (above & ~floor_ok).sum()
        pos = (start + i) % C  # oldest-first overwrite once full
        state.desc[pos] = q[i]
        state.times[pos] = new_times[i]
        state.floors[pos] = new_floors[i]
        state.ids[pos] = start + i
    state.count += M
    return out


def measure_compute_rate(
    capacity: int = 4096,
    dim: int = 4096,
    n_frames: int = 4096,
    top_k: int = 10,
    similarity_threshold: float = 0.5,
    min_time_gap: float = 10.0,
    strict_floor: bool = True,
    reps: int = 3,
    seed: int = 0,
    device="cuda",
) -> Dict[str, float]:
    """Compute-only StreamingGate rate in keyframes/s: one step over all
    ``n_frames`` keyframes with the inputs already on the device, timed to
    a ``synchronize`` (the micro-batches' host copies are left out).

    Returns {"keyframes_per_s", "ms_per_keyframe", "elapsed_s"} for the
    best of ``reps`` timed runs after a warm-up, each on a fresh ring."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    desc = l2_normalize(torch.as_tensor(
        rng.normal(size=(n_frames, dim)).astype(np.float32), device=device))
    times = torch.as_tensor(np.arange(n_frames, dtype=np.float32) * (2.0 * min_time_gap),
                            device=device)
    floors = torch.as_tensor(rng.integers(1, 6, size=n_frames).astype(np.int32), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run() -> None:
        s = _init_state(capacity, dim, device)
        _stream_step(s, desc, times, floors, 0, top_k, strict_floor, min_time_gap,
                     similarity_threshold)
        sync()

    run()  # warm-up
    best = float("inf")
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return {
        "keyframes_per_s": n_frames / best,
        "ms_per_keyframe": 1e3 * best / n_frames,
        "elapsed_s": best,
    }


class StreamingGate:
    """Bounded-latency online gate: call ``add_keyframes`` per micro-batch.

    Args:
        capacity: ring-buffer size.
        descriptor_dim: optional D; inferred from the first batch when
            None, enforced (ValueError on mismatch) when given.
        encoder: optional batched image encoder ``(B, H, W[, C]) -> (B, D)``
            on the gate's device (e.g. ``train/pretrain_vpr.load_encoder()``
            or a VPR encoder's ``encode_batch_device``); when set,
            ``add_keyframes`` accepts images.
        top_k / similarity_threshold / min_time_gap / strict_floor: the
            offline gate's retrieval + gate semantics.
        device: where the ring buffer lives and the steps run.
    """

    def __init__(
        self,
        capacity: int = 4096,
        descriptor_dim: Optional[int] = None,
        encoder: Optional[Callable] = None,
        top_k: int = 10,
        similarity_threshold: float = 0.5,
        min_time_gap: float = 10.0,
        strict_floor: bool = True,
        device="cuda",
    ):
        self.capacity = int(capacity)
        self.dim = None if descriptor_dim is None else int(descriptor_dim)
        self.encoder = encoder
        self.top_k = int(top_k)
        self.threshold = float(similarity_threshold)
        self.min_time_gap = float(min_time_gap)
        self.strict_floor = bool(strict_floor)
        self.device = torch.device(device)
        self.state: Optional[StreamingState] = None
        self.stats: Dict[str, int] = {
            "keyframes": 0,
            "accepted_candidates": 0,
            "rejected_cross_floor": 0,
            "evicted": 0,
        }

    def _ensure_state(self, dim: int) -> None:
        if self.dim is not None and int(dim) != self.dim:
            raise ValueError(f"descriptor dim mismatch: got {int(dim)}, expected {self.dim}")
        if self.state is None:
            self.dim = int(dim)
            self.state = _init_state(self.capacity, self.dim, self.device)

    def add_keyframes(
        self,
        images_or_desc,  # (M, H, W[, C]) images or (M, D) descriptors
        timestamps,  # (M,)
        floor_labels,  # (M,)
    ) -> StreamingMatches:
        """Process one micro-batch; returns this batch's gated candidates.
        Frame i retrieves against everything inserted before it, earlier
        frames of the same call included."""
        x = torch.as_tensor(images_or_desc, device=self.device)
        if x.ndim >= 3:
            if self.encoder is None:
                raise ValueError("images given but no encoder attached")
            x = self.encoder(x)
        desc = l2_normalize(x.to(torch.float32))
        M = int(desc.shape[0])
        self._ensure_state(desc.shape[1])
        start = self.stats["keyframes"]
        k = self.top_k
        out = _stream_step(
            self.state, desc,
            torch.as_tensor(np.asarray(timestamps, np.float32), device=self.device),
            torch.as_tensor(np.asarray(floor_labels).astype(np.int32), device=self.device),
            start, k, self.strict_floor, self.min_time_gap, self.threshold,
        ).cpu().numpy()
        scores = out[:, :k].astype(np.float32)
        match_ids = out[:, k : 2 * k].astype(np.int32)
        rejected = int(out[:, 2 * k].sum())
        self.stats["keyframes"] += M
        self.stats["rejected_cross_floor"] += rejected
        self.stats["accepted_candidates"] += int((match_ids >= 0).sum())
        self.stats["evicted"] = max(0, self.stats["keyframes"] - self.capacity)
        return StreamingMatches(
            query_ids=np.arange(start, start + M),
            match_ids=match_ids,
            scores=scores,
            cross_floor_rejected=rejected,
        )
