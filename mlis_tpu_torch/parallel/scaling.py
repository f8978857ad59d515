"""Analytic interconnect comm-volume / scaling model for the sharded gate step.

Counterpart of ``mlis_tpu/parallel/scaling.py``, with the same formulas;
the defaults are an H100's. The multi-card design is checked three ways:

  1. correctness in a 4-rank gloo world on the CPU against the JAX
     package's 4-device mesh (tests/test_torch_sharded_gate.py);
  2. a measured one-rank overhead on one card against the single-card
     ``FullGatePipeline`` (chip_smoke.py phase 13);
  3. THIS model: per-device interconnect bytes vs per-device compute for
     the collectives ``sharded_full_gate_step`` issues, so the expected
     scaling efficiency at 4/8 cards is a computed number, not a hope.

Communication structure (parallel/sharded_gate.py): per step each rank
all-gathers (a) the (N, D) float32 VPR descriptor matrix and (b) the
pruned keypoint table as the port holds it — coords (N, K, 2) float32,
scores (N, K) float32, descriptors (N, K, 256) float32 (SuperPoint's
sampled descriptors are float32 even with bf16 convolutions), mask
(N, K) bool, one byte each — receiving the (n_dev-1)/n_dev fraction it
does not already hold. The int64 all_reduce of three counts, the int64
all_reduce(MAX) of the rerun decision and the gather of the (B,) verdicts
are negligible. Compute per device: encode + detect over N/n_dev frames,
retrieval (N/n_dev, N, D) GEMM, and the fused match+RANSAC over its
budget slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from mlis_tpu_torch.utils.flops import (
    H100_PEAK_BF16,
    matcher_flops,
    resnet50_encoder_flops,
    superpoint_flops,
)

# H100 SXM5 NVLink 4: 900 GB/s per card in both directions together
# (NVIDIA H100 data sheet), so 450 GB/s received: a ring all-gather moves
# each other shard into a card once at that rate at best. Not measured
# here: one card has no peer.
NVLINK_BYTES_PER_S = 450e9
KP_DESC_DIM = 256


@dataclass
class GateScalingEstimate:
    n_dev: int
    comm_bytes_per_dev: float
    comm_s: float
    compute_flops_per_dev: float
    compute_s: float
    step_s: float
    efficiency: float  # vs perfect linear scaling of the 1-dev compute
    comm_fraction: float

    def as_dict(self) -> Dict[str, float]:
        return {
            "n_dev": self.n_dev,
            "comm_MB_per_dev": round(self.comm_bytes_per_dev / 1e6, 2),
            "comm_ms": round(self.comm_s * 1e3, 3),
            "compute_ms": round(self.compute_s * 1e3, 1),
            "step_ms": round(self.step_s * 1e3, 1),
            "efficiency": round(self.efficiency, 4),
            "comm_fraction": round(self.comm_fraction, 4),
        }


def gate_comm_bytes_per_device(
    n_frames: int,
    n_dev: int,
    desc_dim: int = 4096,
    match_kpts: int = 512,
    kp_desc_dim: int = KP_DESC_DIM,
) -> float:
    """Per-device RX bytes of the two all-gathers (tiled ring all-gather:
    each device receives every other shard once)."""
    frac = (n_dev - 1) / n_dev if n_dev > 1 else 0.0
    desc_bytes = n_frames * desc_dim * 4
    kp_bytes = n_frames * match_kpts * (2 * 4 + 4 + kp_desc_dim * 4 + 1)
    return frac * (desc_bytes + kp_bytes)


def gate_compute_flops_per_device(
    n_frames: int,
    n_dev: int,
    image_hw=(270, 360),
    desc_dim: int = 4096,
    match_kpts: int = 512,
    pairs_verified: int = 896,
    matcher_dim: int = 256,
    matcher_depth: int = 9,
) -> float:
    """Per-device modeled FLOPs: encode+detect its frame shard, retrieval
    of its query slab vs the full DB, fused verify of its budget slots
    (the pair budget splits across devices)."""
    H, W = image_hw
    h8, w8 = (H // 8) * 8, (W // 8) * 8
    per_frame = superpoint_flops(h8, w8) + resnet50_encoder_flops(H, W)
    shard = n_frames / n_dev
    retrieval = 2.0 * shard * n_frames * desc_dim
    verify = (pairs_verified / n_dev) * matcher_flops(
        match_kpts, matcher_dim, matcher_depth
    )
    return shard * per_frame + retrieval + verify


def estimate_gate_scaling(
    n_frames: int = 128,
    n_dev: int = 8,
    image_hw=(270, 360),
    desc_dim: int = 4096,
    match_kpts: int = 512,
    pairs_verified: int = 896,
    achieved_flops_per_s: float = 0.15 * H100_PEAK_BF16,
    ici_bytes_per_s: float = NVLINK_BYTES_PER_S,
) -> GateScalingEstimate:
    """Scaling estimate for one gate step at bench-protocol shapes.

    achieved_flops_per_s calibrates the compute term to a MEASURED
    single-card rate (default: 0.15 of the bf16 peak, the reference's
    ~0.1-0.2 MFU regime — using peak would understate compute time and
    overstate the comm fraction's importance). ``ici_bytes_per_s`` keeps
    the reference's keyword; its default is the card's NVLink rate.
    Comm and compute are modeled as non-overlapped (worst case: the
    step's all-gathers wait for the local encode and detect).
    """
    comm = gate_comm_bytes_per_device(
        n_frames, n_dev, desc_dim, match_kpts
    )
    flops = gate_compute_flops_per_device(
        n_frames, n_dev, image_hw, desc_dim, match_kpts, pairs_verified
    )
    comm_s = comm / ici_bytes_per_s
    compute_s = flops / achieved_flops_per_s
    step_s = comm_s + compute_s
    flops_1dev = gate_compute_flops_per_device(
        n_frames, 1, image_hw, desc_dim, match_kpts, pairs_verified
    )
    t_1dev = flops_1dev / achieved_flops_per_s
    efficiency = t_1dev / (n_dev * step_s) if step_s > 0 else 0.0
    return GateScalingEstimate(
        n_dev=n_dev,
        comm_bytes_per_dev=comm,
        comm_s=comm_s,
        compute_flops_per_dev=flops,
        compute_s=compute_s,
        step_s=step_s,
        efficiency=efficiency,
        comm_fraction=comm_s / step_s if step_s > 0 else 0.0,
    )
