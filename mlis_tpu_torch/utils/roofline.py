"""Per-stage roofline models for the full-gate compute path on an H100.

Counterpart of ``mlis_tpu/utils/roofline.py``, over the port's
``utils/flops.py``: the same analytic HBM byte counts and FLOP counts per
pipeline stage, returning the same floats, placed against the H100's
rooflines instead of the TPU's: achieved TFLOP/s against the 989 TFLOP/s
dense bf16 tensor-core peak, achieved GB/s against the 3.35 TB/s of HBM3
(NVIDIA H100 SXM5 80GB data sheet, 700 W), and each stage's binding
resource named.

Byte-count model (stated assumptions, deliberately conservative):
  * every conv / dense layer reads its input activation once and writes
    its output once (elementwise epilogues fused into the producer);
  * attention materializes its (B, h, K, K) score tensor to HBM in f32,
    ``ATTN_SCORE_PASSES`` times (2 = write + read back, the upper bound);
  * parameters are read once per dispatch (batch >> 1 makes them minor
    everywhere except tiny heads);
  * intermediates that fuse (bias adds, activations, layernorm
    statistics) are free.

The models are for roofline *placement* (which resource binds a stage),
not exact bandwidth accounting: a stage at >50% of one roofline and <10%
of the other is unambiguous under any reasonable variant of these
assumptions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from mlis_tpu_torch.utils.flops import (  # noqa: F401
    H100_PEAK_BF16,
    dense_flops,
    matcher_flops,
    superpoint_flops,
)

H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 80GB, HBM3 bandwidth per card

# f32 score-tensor HBM passes charged per attention op (see module
# docstring: 2 = write + read back, the conservative upper bound).
ATTN_SCORE_PASSES = 2


def grayscale_bytes(n: int, H: int, W: int, h8: int, w8: int) -> float:
    """mono8 (N, H, W) -> resized f32 (N, h8, w8, 1) grayscale."""
    return float(n) * (H * W * 1 + h8 * w8 * 4)


def superpoint_bytes(
    n: int, h8: int, w8: int, channels=(64, 64, 128, 128),
    descriptor_dim: int = 256, max_keypoints: int = 1024,
) -> float:
    """SuperPoint VGG encoder + heads + NMS/top-k/descriptor-sample
    activation traffic for n frames (models/superpoint.py)."""
    b = h8 * w8 * 4.0  # input activation, f32
    cin = 1
    h, w = h8, w8
    for i, c in enumerate(channels):
        # two stride-1 3x3 convs per block: each reads in + writes out
        b += (h * w * cin + h * w * c) * 4.0
        b += (h * w * c + h * w * c) * 4.0
        cin = c
        if i < 3:
            h, w = h // 2, w // 2
            b += h * w * c * 4.0 * 2  # pool read+write
    hc, wc = h8 // 8, w8 // 8
    # detector head (3x3 -> 256, 1x1 -> 65) + softmax/depth-to-space back
    # to full res, then NMS (a few max-pool passes over the full-res heat)
    b += (hc * wc * (cin + 256) + hc * wc * (256 + 65)) * 4.0
    b += h8 * w8 * 4.0 * 2  # heatmap write + NMS read
    b += h8 * w8 * 4.0 * 2  # NMS output + top-k scan read
    # descriptor head + bilinear sample of K descriptors
    b += (hc * wc * (cin + 256) + hc * wc * (256 + descriptor_dim)) * 4.0
    b += max_keypoints * descriptor_dim * 4.0 * 2
    return float(n) * b


def resnet50_stage3_bytes(n: int, H: int, W: int) -> float:
    """MixVPR's ResNet-50-to-layer3 backbone + mixer head activation
    traffic (models/mixvpr.py: crop_stage=3, 1024-ch 1/16-res feature).
    Counts each conv's input read + output write at f32."""
    s = H // 2, W // 2  # stem out
    b = H * W * 3 * 4.0 + s[0] * s[1] * 64 * 4.0  # 7x7/2 stem
    p = s[0] // 2, s[1] // 2  # maxpool out (1/4)
    b += (s[0] * s[1] * 64 + p[0] * p[1] * 64) * 4.0
    # bottleneck traffic per block at (h, w): read in, write c1, read c1,
    # write c1, read c1, write 4c out (+ residual read/write)
    def _layer(h, w, cmid, cout, blocks, cin):
        t = 0.0
        for i in range(blocks):
            ci = cin if i == 0 else cout
            t += (h * w * ci + h * w * cmid) * 4.0
            t += (h * w * cmid * 2) * 4.0
            t += (h * w * cmid + h * w * cout) * 4.0
            t += h * w * cout * 4.0  # residual add read
        t += (h * w * cin + h * w * cout) * 4.0  # downsample proj
        return t

    h, w = p
    b += _layer(h, w, 64, 256, 3, 64)
    h, w = h // 2, w // 2
    b += _layer(h, w, 128, 512, 4, 256)
    h, w = h // 2, w // 2
    b += _layer(h, w, 256, 1024, 6, 512)
    # mixer head: 4 mixer layers on (C=1024, HW=h*w) + two projections
    hw = h * w
    b += 4 * (1024 * hw * 4.0 * 2)
    b += (1024 * hw + 4 * hw) * 4.0 + (1024 * 4 + 4 * 1024) * 4.0
    return float(n) * b


def retrieval_bytes(n: int, D: int, k: int) -> float:
    """_gate_compact: N x N cosine GEMM + top-k + packed-key sort +
    compaction (gating/full_gate.py). The sort is O(N k log) passes over
    N*k int32 keys; charge 4 passes."""
    return (
        2 * n * D * 4.0          # descriptor reads (both operands)
        + n * n * 4.0 * 2        # score matrix write + top-k read
        + 4 * n * k * 4.0 * 4    # sort/compaction passes over keys
    )


def matcher_stage_bytes(
    B: int, K: int, dim: int = 256, depth: int = 9, num_heads: int = 4,
    descriptor_dim: int = 256, dtype_bytes: int = 2,
) -> float:
    """LightGlue matcher forward on a B-pair batch (models/lightglue.py
    MatcherNet: both streams ride one (2B, K, D) batch; depth blocks of
    self+cross attention). bf16 activations (dtype_bytes=2), f32 score
    tensors."""
    rows = 2 * B * K  # concatenated token count
    act = rows * dim * dtype_bytes

    # one AttnLayer: q/k/v/proj denses (read in + write out each), the
    # score tensor (f32, ATTN_SCORE_PASSES), attention output, ffn1
    # (concat 2D -> 2D) + ffn2 (2D -> D)
    attn = (
        4 * (act * 2)
        + ATTN_SCORE_PASSES * (2 * B) * num_heads * K * K * 4.0
        + act
        + (rows * 2 * dim * dtype_bytes) * 2 * 2
        + (rows * 2 * dim + rows * dim) * dtype_bytes
    )
    blocks = depth * 2 * attn  # self + cross per block
    io = (
        rows * descriptor_dim * 4.0 + act      # in_proj
        + act * 2                               # final_proj
        + ATTN_SCORE_PASSES * B * K * K * 4.0   # similarity + dual softmax
        + act                                   # matchability heads read
    )
    return blocks + io


def ransac_bytes(
    B: int, K: int, num_hypotheses: int = 512, passes: int = 3
) -> float:
    """essential_ransac_batch (ops/epipolar.py): per hypothesis batch the
    (B, hyp, K) residual tensor dominates; `passes` covers residual
    write + argmax read + inlier re-score."""
    return (
        B * K * 2 * 4.0 * 2                      # both coordinate sets
        + passes * B * num_hypotheses * K * 4.0  # residual traffic
        + B * num_hypotheses * 9 * 4.0 * 2       # hypothesis E matrices
    )


def ransac_flops(B: int, K: int, num_hypotheses: int = 512) -> float:
    """Dominant term: residual evaluation x1' E x0 (~30 flops/point) per
    hypothesis, plus the 8-point SVD solves (~2k flops each)."""
    return B * num_hypotheses * (K * 30.0 + 2000.0)


def retrieval_flops(n: int, D: int) -> float:
    return 2.0 * n * n * D


def resnet50_stage3_flops(H: int, W: int) -> float:
    """ResNet-50 cropped after layer3 ~= 75% of the full 4.1 GFLOP
    (layer4 is ~25%), scaled by input area."""
    return 0.75 * 4.1e9 * (H * W) / (224.0 * 224.0)


@dataclass
class StageRoofline:
    name: str
    seconds: float
    flops: float
    bytes: float

    @property
    def tflops(self) -> float:
        return self.flops / self.seconds / 1e12 if self.seconds else 0.0

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9 if self.seconds else 0.0

    @property
    def frac_tensor(self) -> float:
        """Share of the H100's dense bf16 tensor-core peak (989 TFLOP/s,
        H100 SXM5 80GB HBM3 at 700 W, NVIDIA data sheet) that the stage's
        modelled FLOPs reach in its measured time."""
        return self.flops / self.seconds / H100_PEAK_BF16 if self.seconds else 0.0

    @property
    def frac_hbm(self) -> float:
        return (
            self.bytes / self.seconds / H100_HBM_BYTES_PER_S
            if self.seconds
            else 0.0
        )

    @property
    def bound(self) -> str:
        f_c, f_m = self.frac_tensor, self.frac_hbm
        if max(f_c, f_m) < 0.15:
            return "overhead"  # neither roofline explains the time
        return "tensor" if f_c >= f_m else "HBM"

    def row(self) -> Dict:
        return {
            "seconds": round(self.seconds, 4),
            "tflops": round(self.tflops, 1),
            "gbps": round(self.gbps, 1),
            "frac_tensor": round(self.frac_tensor, 3),
            "frac_hbm": round(self.frac_hbm, 3),
            "bound": self.bound,
        }


def format_table(stages) -> str:
    hdr = (
        f"{'stage':<12} {'ms':>8} {'TFLOP/s':>8} {'GB/s':>7} "
        f"{'%TC':>6} {'%HBM':>6}  bound"
    )
    lines = [hdr, "-" * len(hdr)]
    for s in stages:
        lines.append(
            f"{s.name:<12} {s.seconds * 1e3:>8.1f} {s.tflops:>8.1f} "
            f"{s.gbps:>7.0f} {s.frac_tensor * 100:>5.1f}% "
            f"{s.frac_hbm * 100:>5.1f}%  {s.bound}"
        )
    return "\n".join(lines)
