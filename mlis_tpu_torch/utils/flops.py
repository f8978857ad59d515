"""Analytic FLOP counts for the gate's compute path -> MFU reporting.

Counterpart of ``mlis_tpu/utils/flops.py``: the same counting functions,
returning the same floats. Counts the dominant dense/conv/attention FLOPs
of each pipeline stage so a benchmark can report achieved TFLOP/s and MFU
against the H100's dense bf16 peak. Counts are 2*MACs; minor terms
(layernorms, softmax exps, top-k, RANSAC's 8-point solves, the N^2*D
retrieval GEMM) are excluded — they are <2% of the matcher+detector total
at bench shapes, so the reported MFU is slightly conservative.
"""

from __future__ import annotations

# H100 SXM5, dense bf16 tensor-core peak (NVIDIA H100 data sheet: 1,979
# TFLOP/s with sparsity, half of it dense), FLOP/s per card
H100_PEAK_BF16 = 989e12


def dense_flops(tokens: int, din: int, dout: int) -> float:
    return 2.0 * tokens * din * dout


def matcher_flops(
    K: int, dim: int = 256, depth: int = 9, descriptor_dim: int = 256
) -> float:
    """One LightGlue pair forward (models/lightglue.py MatcherNet):
    both K-token streams through `depth` blocks of self+cross attention
    with LightGlue's concat-ffn, plus projections and the KxK similarity
    and assignment heads."""
    D = dim
    # one AttnLayer for ONE stream: q,k,v,proj + attention + ffn
    attn_layer = (
        4 * dense_flops(K, D, D)  # q, k, v, proj
        + 2 * (2.0 * K * K * D)  # scores QK^T + weighted values
        + dense_flops(K, 2 * D, 2 * D)  # ffn1 (concat input)
        + dense_flops(K, 2 * D, D)  # ffn2
    )
    blocks = depth * 2 * 2 * attn_layer  # self+cross, two streams
    io = (
        2 * dense_flops(K, descriptor_dim, D)  # in_proj, both streams
        + 2 * dense_flops(K, D, D)  # final_proj
        + 2.0 * K * K * D  # similarity GEMM
        + 2 * dense_flops(K, D, 1)  # matchability heads
    )
    return blocks + io


def superpoint_flops(
    H: int,
    W: int,
    channels=(64, 64, 128, 128),
    descriptor_dim: int = 256,
) -> float:
    """One frame through the SuperPoint VGG encoder + heads
    (models/superpoint.py): 2 stride-1 3x3 convs per block at full, 1/2,
    1/4, 1/8 resolution, then detector (3x3 -> 256, 1x1 -> 65) and
    descriptor (3x3 -> 256, 1x1 -> D) heads at 1/8."""
    f = 0.0
    cin = 1
    h, w = H, W
    for i, c in enumerate(channels):
        f += 2.0 * h * w * 9 * (cin * c + c * c)
        cin = c
        if i < 3:
            h, w = h // 2, w // 2
    h8, w8 = H // 8, W // 8
    f += 2.0 * h8 * w8 * (
        cin * 256 * 9 + 256 * 65 + cin * 256 * 9 + 256 * descriptor_dim
    )
    return f


def resnet50_encoder_flops(H: int, W: int) -> float:
    """MixVPR's ResNet-50 backbone, scaled from the canonical 4.1 GFLOPs
    at 224x224 (the mixer head adds <3%)."""
    return 4.1e9 * (H * W) / (224.0 * 224.0)


def full_gate_flops(
    n_frames: int,
    n_pairs_verified: int,
    image_hw,
    max_keypoints: int,
    matcher_dim: int = 256,
    matcher_depth: int = 9,
) -> float:
    """Total modeled FLOPs of one full-gate pass (encode + detect once
    per frame, match per verified pair)."""
    H, W = image_hw
    h8, w8 = (H // 8) * 8, (W // 8) * 8
    per_frame = superpoint_flops(h8, w8) + resnet50_encoder_flops(H, W)
    per_pair = matcher_flops(max_keypoints, matcher_dim, matcher_depth)
    return n_frames * per_frame + n_pairs_verified * per_pair
