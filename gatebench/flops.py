"""Work of the gate's models, counted from shapes and from the run's own counts.

A multiply-add is two operations. Counted: SuperPoint per frame at the
detect resolution; the encoder per frame (the ViT-B/14 of CricaVPR, or
MixVPR's ResNet-50 through stage 3 and its mixer); LightGlue per
verified pair at each frame's valid (matched) keypoint count and the
checkpoint's depth. Not counted: biases, norms, activations, softmax,
padding to verify batches or to the static keypoint count, and anything
an implementation recomputes. The attention kernels' bounds count each of
q, k and v read once and the output written once, in bfloat16, and each
row's valid keys only. Peaks: one NVIDIA H100 SXM (dense, 700 W).
"""

from __future__ import annotations

from typing import Iterable, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2


def conv(cin: int, cout: int, k: int, h: int, w: int) -> float:
    """A k x k convolution producing an h x w map."""
    return 2.0 * k * k * cin * cout * h * w


def superpoint(h: int, w: int, channels=(64, 64, 128, 128), descriptor_dim: int = 256) -> float:
    """One frame at the detect resolution h x w (multiples of 8)."""
    total, cin = 0.0, 1
    for stage, c in enumerate(channels):
        hs, ws = h >> stage, w >> stage
        total += conv(cin, c, 3, hs, ws) + conv(c, c, 3, hs, ws)
        cin = c
    h8, w8 = h // 8, w // 8
    total += conv(cin, 256, 3, h8, w8) + conv(256, 65, 1, h8, w8)
    total += conv(cin, 256, 3, h8, w8) + conv(256, descriptor_dim, 1, h8, w8)
    return total


def vit(h: int, w: int, dim: int = 768, depth: int = 12, mlp_ratio: float = 4.0,
        patch: int = 14) -> float:
    """One frame through a ViT: patch embedding, depth blocks (qkv, the two
    attention products, projection, MLP)."""
    gh, gw = h // patch, w // patch
    S = gh * gw + 1
    hidden = int(dim * mlp_ratio)
    per_block = (2.0 * S * dim * 3 * dim + 4.0 * S * S * dim + 2.0 * S * dim * dim
                 + 4.0 * S * dim * hidden)
    return conv(3, dim, patch, gh, gw) + depth * per_block


def resnet50_stage3(h: int, w: int, width: int = 64, blocks=(3, 4, 6)) -> float:
    """ResNet-50's stem and first three stages on an h x w input."""
    hs, ws = -(-h // 2), -(-w // 2)
    total = conv(3, width, 7, hs, ws)
    hs, ws = -(-hs // 2), -(-ws // 2)  # max-pool
    cin = width
    for stage, n in enumerate(blocks):
        f = width * 2**stage
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            ho, wo = -(-hs // stride), -(-ws // stride)
            total += conv(cin, f, 1, hs, ws) + conv(f, f, 3, ho, wo) + conv(f, 4 * f, 1, ho, wo)
            if b == 0:
                total += conv(cin, 4 * f, 1, ho, wo)
            cin, hs, ws = 4 * f, ho, wo
    return total


def mixvpr(h: int, w: int, descriptor_dim: int = 4096, mix_depth: int = 4, rows: int = 4) -> float:
    """One frame through MixVPR: the backbone, then the mixer and projections."""
    hw = -(-h // 16) * -(-w // 16)
    C, out_c = 1024, descriptor_dim // rows
    head = mix_depth * 4.0 * C * hw * hw + 2.0 * hw * C * out_c + 2.0 * out_c * hw * rows
    return resnet50_stage3(h, w) + head


def lightglue(n0: int, n1: int, dim: int = 256, depth: int = 9, descriptor_dim: int = 256) -> float:
    """One pair with n0 and n1 valid keypoints."""
    N = n0 + n1
    per_layer = 2 * (20.0 * N * dim * dim) + 4.0 * dim * (n0 * n0 + n1 * n1) + 8.0 * dim * n0 * n1
    return (2.0 * N * descriptor_dim * dim + depth * per_layer + 2.0 * N * dim * dim
            + 2.0 * n0 * n1 * dim + 2.0 * N * dim)


def vit_attention(tokens: int, dim: int = 768) -> Tuple[float, float]:
    """(operations, bytes) of one frame's attention in one ViT block."""
    return 4.0 * tokens * tokens * dim, 4.0 * tokens * dim * BF16_BYTES


def lightglue_attention(n0: int, n1: int, dim: int = 256) -> Tuple[float, float]:
    """(operations, bytes) of one pair's self- and cross-attention in one
    LightGlue layer (two launches, both images each)."""
    N = n0 + n1
    ops = 4.0 * dim * (n0 * n0 + n1 * n1) + 8.0 * dim * n0 * n1
    return ops, 2 * 4.0 * N * dim * BF16_BYTES


def bound_s(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time at the peaks, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def frame_flops(cfg: dict) -> float:
    """Detector and encoder operations of one frame."""
    H, W = cfg["keyframe_hw"]
    total = superpoint((H // 8) * 8, (W // 8) * 8)
    v = cfg["vpr"]
    h, w = v["input_size"]
    if v["method"] == "cricavpr":
        total += vit(h, w)
    elif v["method"] == "mixvpr":
        total += mixvpr(h, w, int(v["descriptor_dim"]))
    else:
        raise ValueError(f"no operation count for encoder {v['method']}")
    return total


def pairs_flops(pairs: Iterable[Tuple[int, int]], cfg: dict) -> float:
    m = cfg["matcher"]
    return sum(lightglue(a, b, depth=int(m["depth"])) for a, b in pairs)

