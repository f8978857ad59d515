"""LoFTR: detector-free coarse-to-fine dense matching, batched over pairs.

Counterpart of the in-env LoFTR of ``mlis_tpu/models/loftr.py`` (the
architecture the shipped ``checkpoints/loftr_*.npz`` hold):

* a conv backbone (flax ``SAME`` padding, which pads a stride-2 layer on
  the bottom and right only) gives a coarse 1/8 and a fine 1/2 map;
* the coarse transformer is linear attention, phi(q) (phi(k)^T v) with
  phi = elu + 1, all in float32; each depth step runs self-attention on
  both images, then cross-attention: image 0 reads image 1's tokens from
  before the step's cross-attention, image 1 reads image 0's after it;
* coarse matching is dual softmax with mutual maxima (first index on
  ties), a confidence threshold and a static top-M (ties to the lower
  index, as ``lax.top_k``);
* fine refinement correlates image 0's centre feature with a 5x5 window of
  image 1's fine map and takes the soft-argmax.

``LoFTRConfig(official=True)`` (``official_full``, ``official_tiny``) builds
the official zju3dv / kornia architecture instead, the reference's own
pretrained matcher, weight-compatible with its checkpoints through
:meth:`LoFTR.load_torch_state_dict`:

* ResNetFPN_8_2 with torch's symmetric padding, frozen batch norm and a
  bilinear ``align_corners=True`` upsample computed in float32;
* the sine position encoding with the released checkpoints' div-term
  precedence bug (``temp_bug_fix=False``);
* encoder layers with bias-free projections, a float32 LayerNorm after the
  message and a ReLU MLP; each depth step runs the self layer once on both
  images (shared weights), then the cross layer on image 0 and on image 1,
  which reads image 0 after its own cross update;
* coarse matching on features / sqrt(d) with ``border_rm`` cells masked,
  zero-padded 5x5 fine windows (``F.unfold`` at stride 4), the fine
  preprocess and transformer, and the spatial expectation on the [-1, 1]
  window grid; keypoints are ``8 * cell`` (no centre offset) in image 0
  and that plus expectation x (W // 2) x 2 in image 1.

Module names follow the JAX package's flax tree (``coarse.backbone.
layer1_0.conv1``, ``coarse.coarse_self0.q_proj``, ``fine.down_proj``...), so
``save_weights`` and ``load_weights`` carry the ``loftr:`` tree across with
no renaming table.

Inputs whose sides are not multiples of 8 are resized down to the nearest
multiple (bilinear with antialiasing, as ``jax.image.resize(method=
"linear")``) and the keypoints scaled back. The linear attention, like the
rest, is plain PyTorch: the JAX package computes it with XLA einsums, no
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from mlis_tpu_torch.gating.verification import BaseFeatureMatcher
from mlis_tpu_torch.models.layers import Conv, Dense, FrozenBatchNorm, LayerNorm
from mlis_tpu_torch.ops.image import resize_nhwc, to_grayscale
from mlis_tpu_torch.ops.knn import topk_lower_index


@dataclasses.dataclass(frozen=True)
class LoFTRConfig:
    coarse_dim: int = 128
    fine_dim: int = 64
    depth: int = 4
    num_heads: int = 4
    temperature: float = 0.1
    match_threshold: float = 0.2
    max_matches: int = 1024
    fine_window: int = 5
    dtype: torch.dtype = torch.bfloat16
    # --- the official architecture (kornia / zju3dv LoFTR) ---
    official: bool = False
    initial_dim: int = 128
    block_dims: Tuple[int, ...] = (128, 196, 256)
    # the released indoor/outdoor weights were trained with the position
    # encoding's div-term precedence bug (upstream keeps it under False)
    temp_bug_fix: bool = False
    border_rm: int = 2

    @staticmethod
    def tiny_test(**kw) -> "LoFTRConfig":
        kw.setdefault("coarse_dim", 32)
        kw.setdefault("fine_dim", 16)
        kw.setdefault("depth", 1)
        kw.setdefault("num_heads", 2)
        kw.setdefault("max_matches", 64)
        return LoFTRConfig(**kw)

    @staticmethod
    def official_full(**kw) -> "LoFTRConfig":
        """The released indoor/outdoor-ds configuration (d_model 256)."""
        kw.setdefault("coarse_dim", 256)
        kw.setdefault("fine_dim", 128)
        kw.setdefault("depth", 4)
        kw.setdefault("num_heads", 8)
        return LoFTRConfig(official=True, **kw)

    @staticmethod
    def official_tiny(**kw) -> "LoFTRConfig":
        """The official structure at test-size widths."""
        kw.setdefault("coarse_dim", 32)
        kw.setdefault("fine_dim", 16)
        kw.setdefault("depth", 1)
        kw.setdefault("num_heads", 2)
        kw.setdefault("max_matches", 64)
        kw.setdefault("initial_dim", 16)
        kw.setdefault("block_dims", (16, 24, 32))
        return LoFTRConfig(official=True, **kw)


class DenseMatches(NamedTuple):
    kpts0: torch.Tensor  # (B, M, 2) xy pixels in image 0
    kpts1: torch.Tensor  # (B, M, 2) refined xy pixels in image 1
    scores: torch.Tensor  # (B, M)
    valid: torch.Tensor  # (B, M)


class SameConv(Conv):
    """3x3 ``flax.linen.Conv(padding="SAME")``: out = ceil(in / stride), the
    padding split with the smaller half first."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, dtype=torch.float32):
        super().__init__(in_ch, out_ch, 3, stride=stride, padding=0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        pads = []
        for n in (x.shape[3], x.shape[2]):  # F.pad order: last dim first
            total = max((-(-n // s) - 1) * s + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class LoFTRBackbone(nn.Module):
    def __init__(self, cfg: LoFTRConfig):
        super().__init__()
        dt = cfg.dtype
        self.c1a = SameConv(1, 32, dtype=dt)
        self.c1b = SameConv(32, 32, stride=2, dtype=dt)  # /2
        self.fine_out = SameConv(32, cfg.fine_dim, dtype=dt)
        self.c2 = SameConv(32, 64, stride=2, dtype=dt)  # /4
        self.c3 = SameConv(64, 128, stride=2, dtype=dt)  # /8
        self.coarse_out = SameConv(128, cfg.coarse_dim, dtype=dt)
        self.dtype = dt

    def forward(self, images: torch.Tensor):
        """(B, H, W, 1) -> (coarse (B, H/8, W/8, Dc), fine (B, H/2, W/2, Df))."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x1 = F.relu(self.c1b(F.relu(self.c1a(x))))
        fine = self.fine_out(x1)
        x3 = F.relu(self.c3(F.relu(self.c2(x1))))
        coarse = self.coarse_out(x3)
        return coarse.permute(0, 2, 3, 1), fine.permute(0, 2, 3, 1)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """phi(q) (phi(k)^T v) / (phi(q) . sum phi(k)), phi = elu + 1, float32.
    q (B, S, H, Dh), k/v (B, T, H, Dh) -> (B, S, H, Dh)."""
    qf = F.elu(q.to(torch.float32)) + 1.0
    kf = F.elu(k.to(torch.float32)) + 1.0
    kv = torch.einsum("bthd,bthe->bhde", kf, v.to(torch.float32))
    z = 1.0 / (torch.einsum("bshd,bhd->bsh", qf, kf.sum(dim=1)) + 1e-6)
    return torch.einsum("bshd,bhde->bshe", qf, kv) * z[..., None]


class LinearAttnLayer(nn.Module):
    """x + MLP(concat(x, proj(linear_attention(x <- source))))."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = Dense(dim, dim, dtype=dtype)
        self.k = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.ffn1 = Dense(2 * dim, 2 * dim, dtype=dtype)
        self.ffn2 = Dense(2 * dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        T, H = source.shape[1], self.num_heads
        q = self.q(x).reshape(B, S, H, D // H)
        k = self.k(source).reshape(B, T, H, D // H)
        v = self.v(source).reshape(B, T, H, D // H)
        msg = self.proj(linear_attention(q, k, v).reshape(B, S, D).to(self.dtype))
        h = self.ffn1(torch.cat([x, msg], dim=-1))
        return x + self.ffn2(F.gelu(h, approximate="tanh"))


class LoFTRNet(nn.Module):
    """Backbone on both images, then ``depth`` rounds of self and cross
    linear attention over the coarse tokens."""

    def __init__(self, cfg: LoFTRConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = LoFTRBackbone(cfg)
        for i in range(cfg.depth):
            for name in ("self", "cross"):
                for j in (0, 1):
                    self.add_module(f"{name}{i}_{j}",
                                    LinearAttnLayer(cfg.coarse_dim, cfg.num_heads, cfg.dtype))

    def forward(self, images0: torch.Tensor, images1: torch.Tensor):
        c0, f0 = self.backbone(images0)
        c1, f1 = self.backbone(images1)
        B, hc, wc, D = c0.shape
        t0, t1 = c0.reshape(B, hc * wc, D), c1.reshape(B, hc * wc, D)
        for i in range(self.cfg.depth):
            t0 = getattr(self, f"self{i}_0")(t0, t0)
            t1 = getattr(self, f"self{i}_1")(t1, t1)
            t0n = getattr(self, f"cross{i}_0")(t0, t1)
            t1 = getattr(self, f"cross{i}_1")(t1, t0)
            t0 = t0n
        return t0, t1, f0, f1, (hc, wc)


def coarse_match(t0, t1, temperature: float, threshold: float, max_matches: int,
                 normalize: str = "l2", grid_hw=None, border_rm: int = 0):
    """Dual-softmax mutual matching over the coarse grids -> static top-M.

    normalize "l2" (unit features) or "sqrt_dim" (features / sqrt(d));
    ``border_rm`` zeroes confidences within that many cells of the grid edge
    in either image. Returns (sel0, sel1, scores, valid), each (B, M)."""
    if normalize == "sqrt_dim":
        d = t0.shape[-1]
        n0, n1 = t0.to(torch.float32) / d**0.5, t1.to(torch.float32) / d**0.5
    else:
        n0 = t0.to(torch.float32) / (torch.linalg.vector_norm(
            t0.to(torch.float32), dim=-1, keepdim=True) + 1e-8)
        n1 = t1.to(torch.float32) / (torch.linalg.vector_norm(
            t1.to(torch.float32), dim=-1, keepdim=True) + 1e-8)
    sim = torch.einsum("bnd,bmd->bnm", n0, n1) / temperature
    p = torch.softmax(sim, dim=2) * torch.softmax(sim, dim=1)
    if border_rm > 0 and grid_hw is not None:
        hc, wc = grid_hw
        cells = torch.arange(hc * wc, device=p.device)
        xs, ys = cells % wc, torch.div(cells, wc, rounding_mode="floor")
        interior = ((xs >= border_rm) & (xs < wc - border_rm)
                    & (ys >= border_rm) & (ys < hc - border_rm)).to(p.dtype)
        p = p * interior[None, :, None] * interior[None, None, :]
    best1 = p.argmax(dim=2)  # (B, N), first index on ties
    best0 = p.argmax(dim=1)  # (B, M)
    n_idx = torch.arange(p.shape[1], device=p.device)
    mutual = best0.gather(1, best1) == n_idx[None]
    conf = p.gather(2, best1[..., None])[..., 0]
    conf = torch.where(mutual & (conf > threshold), conf, torch.zeros_like(conf))
    scores, sel = topk_lower_index(conf, min(max_matches, conf.shape[1]))
    return sel, best1.gather(1, sel), scores, scores > 0


def fine_refine(f1: torch.Tensor, coarse_xy1: torch.Tensor, center_feat0: torch.Tensor,
                window: int, scale: int = 2) -> torch.Tensor:
    """Refine image-1 positions: correlate image 0's centre feature with a
    window x window patch of image 1's fine map around each coarse
    location, soft-argmax. f1 (B, hf, wf, D), coarse_xy1 (B, M, 2) and the
    result in fine-grid coordinates, center_feat0 (B, M, D)."""
    B, hf, wf, D = f1.shape
    r = window // 2
    offs = torch.arange(-r, r + 1, device=f1.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)  # (W2,)
    gx = (coarse_xy1[..., 0, None] + ox).clamp(0, wf - 1).long()  # (B, M, W2)
    gy = (coarse_xy1[..., 1, None] + oy).clamp(0, hf - 1).long()
    b = torch.arange(B, device=f1.device)[:, None, None]
    patches = f1.to(torch.float32)[b, gy, gx]  # (B, M, W2, D)
    corr = torch.einsum("bmwd,bmd->bmw", patches, center_feat0.to(torch.float32))
    w = torch.softmax(corr / D**0.5, dim=-1)
    dx = (w * ox.to(torch.float32)).sum(-1)
    dy = (w * oy.to(torch.float32)).sum(-1)
    return coarse_xy1 + torch.stack([dx, dy], dim=-1)


# ---------------------------------------------------------------------------
# The official architecture (kornia / zju3dv LoFTR)
# ---------------------------------------------------------------------------


def _pconv(in_ch: int, out_ch: int, k: int, stride: int, dtype) -> Conv:
    """Bias-free conv with torch's padding, (k - 1) // 2 on both sides (flax
    ``SAME`` pads a stride-2 layer asymmetrically, which differs)."""
    return Conv(in_ch, out_ch, k, stride=stride, padding=(k - 1) // 2, bias=False, dtype=dtype)


class _FPNBasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int, dtype):
        super().__init__()
        self.stride = stride
        self.conv1 = _pconv(in_planes, planes, 3, stride, dtype)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _pconv(planes, planes, 3, 1, dtype)
        self.bn2 = FrozenBatchNorm(planes)
        if stride != 1:
            self.downsample_conv = _pconv(in_planes, planes, 1, stride, dtype)
            self.downsample_bn = FrozenBatchNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.stride != 1:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + y)


def _upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of NCHW ``x`` with torch's align_corners=True
    sampling, in float32 (the JAX package's lerp of rows, then columns)."""
    x = x.to(torch.float32)

    def plan(n):
        out = 2 * n
        src = np.arange(out) * ((n - 1) / (out - 1)) if out > 1 else np.zeros(1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n - 1)
        t = torch.as_tensor((src - lo).astype(np.float32), device=x.device)
        return torch.as_tensor(lo, device=x.device), torch.as_tensor(hi, device=x.device), t

    ly, hy, ty = plan(x.shape[2])
    rows = x[:, :, ly] * (1.0 - ty)[:, None] + x[:, :, hy] * ty[:, None]
    lx, hx, tx = plan(x.shape[3])
    return rows[..., lx] * (1.0 - tx) + rows[..., hx] * tx


class ResNetFPN82(nn.Module):
    """The official ResNetFPN_8_2 backbone: (B, H, W, 1) in [0, 1] ->
    coarse (B, block_dims[2], H/8, W/8) and fine (B, block_dims[0], H/2,
    W/2), NCHW in ``cfg.dtype``."""

    def __init__(self, cfg: LoFTRConfig):
        super().__init__()
        dt = cfg.dtype
        self.dtype = dt
        d0, d1, d2 = cfg.block_dims
        self.conv1 = Conv(1, cfg.initial_dim, 7, stride=2, padding=3, bias=False, dtype=dt)
        self.bn1 = FrozenBatchNorm(cfg.initial_dim)
        self.layer1_0 = _FPNBasicBlock(cfg.initial_dim, d0, 1, dt)
        self.layer1_1 = _FPNBasicBlock(d0, d0, 1, dt)  # 1/2
        self.layer2_0 = _FPNBasicBlock(d0, d1, 2, dt)
        self.layer2_1 = _FPNBasicBlock(d1, d1, 1, dt)  # 1/4
        self.layer3_0 = _FPNBasicBlock(d1, d2, 2, dt)
        self.layer3_1 = _FPNBasicBlock(d2, d2, 1, dt)  # 1/8
        self.layer3_outconv = _pconv(d2, d2, 1, 1, dt)
        self.layer2_outconv = _pconv(d1, d2, 1, 1, dt)
        self.layer2_outconv2_0 = _pconv(d2, d2, 3, 1, dt)
        self.layer2_outconv2_bn = FrozenBatchNorm(d2)
        self.layer2_outconv2_1 = _pconv(d2, d1, 3, 1, dt)
        self.layer1_outconv = _pconv(d0, d1, 1, 1, dt)
        self.layer1_outconv2_0 = _pconv(d1, d1, 3, 1, dt)
        self.layer1_outconv2_bn = FrozenBatchNorm(d1)
        self.layer1_outconv2_1 = _pconv(d1, d0, 3, 1, dt)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x0 = F.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1_1(self.layer1_0(x0))
        x2 = self.layer2_1(self.layer2_0(x1))
        x3 = self.layer3_1(self.layer3_0(x2))
        x3_out = self.layer3_outconv(x3)
        h = self.layer2_outconv(x2)
        h = h + _upsample2x_align_corners(x3_out).to(h.dtype)
        h = F.leaky_relu(self.layer2_outconv2_bn(self.layer2_outconv2_0(h)), 0.01)
        x2_out = self.layer2_outconv2_1(h)
        h = self.layer1_outconv(x1)
        h = h + _upsample2x_align_corners(x2_out).to(h.dtype)
        h = F.leaky_relu(self.layer1_outconv2_bn(self.layer1_outconv2_0(h)), 0.01)
        return x3_out, self.layer1_outconv2_1(h)


def sine_pos_encoding(d_model: int, h: int, w: int, temp_bug_fix: bool) -> np.ndarray:
    """The official PositionEncodingSine, channel-last (h, w, d_model), on
    the host in numpy. The released checkpoints were trained with the
    div-term precedence bug: ``-log(1e4) / d_model // 2`` floor-divides
    after the division, so the div term is exp(-arange) for d_model >= 10."""
    pe = np.zeros((d_model, h, w), np.float32)
    y_pos = np.cumsum(np.ones((h, w), np.float32), axis=0)
    x_pos = np.cumsum(np.ones((h, w), np.float32), axis=1)
    ar = np.arange(0, d_model // 2, 2, dtype=np.float32)
    if temp_bug_fix:
        div = np.exp(ar * (-math.log(10000.0) / (d_model // 2)))
    else:
        div = np.exp(ar * (-math.log(10000.0) / d_model // 2))
    div = div[:, None, None]
    pe[0::4] = np.sin(x_pos[None] * div)
    pe[1::4] = np.cos(x_pos[None] * div)
    pe[2::4] = np.sin(y_pos[None] * div)
    pe[3::4] = np.cos(y_pos[None] * div)
    return pe.transpose(1, 2, 0)


class OfficialEncoderLayer(nn.Module):
    """The official LoFTREncoderLayer: bias-free projections, linear
    attention, a float32 LayerNorm after the merge, a ReLU MLP over
    [x || message] and a float32 LayerNorm after it."""

    def __init__(self, dim: int, num_heads: int, dtype):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.q_proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.k_proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.v_proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.merge = Dense(dim, dim, bias=False, dtype=dtype)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.mlp0 = Dense(2 * dim, 2 * dim, bias=False, dtype=dtype)
        self.mlp2 = Dense(2 * dim, dim, bias=False, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        T, H = source.shape[1], self.num_heads
        q = self.q_proj(x).reshape(B, S, H, D // H)
        k = self.k_proj(source).reshape(B, T, H, D // H)
        v = self.v_proj(source).reshape(B, T, H, D // H)
        msg = self.merge(linear_attention(q, k, v).reshape(B, S, D).to(self.dtype))
        msg = self.norm1(msg).to(self.dtype)
        h = self.mlp2(F.relu(self.mlp0(torch.cat([x, msg], dim=-1))))
        return x + self.norm2(h).to(self.dtype)


class OfficialLoFTRNet(nn.Module):
    """Backbone, position encoding and the coarse transformer in the
    official order: per depth step the self layer once over both streams
    (shared weights, one batch), then the cross layer for stream 0 and for
    stream 1, which reads stream 0 after its update."""

    def __init__(self, cfg: LoFTRConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetFPN82(cfg)
        for i in range(cfg.depth):
            for name in ("self", "cross"):
                self.add_module(f"coarse_{name}{i}",
                                OfficialEncoderLayer(cfg.coarse_dim, cfg.num_heads, cfg.dtype))

    def forward(self, images0: torch.Tensor, images1: torch.Tensor):
        """(B, H, W, 1) pairs -> coarse tokens t0, t1 (B, hc * wc, Dc), fine
        maps f0, f1 (B, hf, wf, Df) and the coarse grid (hc, wc)."""
        c = self.cfg
        B = images0.shape[0]
        coarse, fine = self.backbone(torch.cat([images0, images1]))
        hc, wc = coarse.shape[2], coarse.shape[3]
        with record_function("loftr.coarse"):
            pe = torch.as_tensor(sine_pos_encoding(c.coarse_dim, hc, wc, c.temp_bug_fix),
                                 device=coarse.device)
            coarse = (coarse.permute(0, 2, 3, 1).to(torch.float32) + pe).to(c.dtype)
            t = coarse.reshape(2 * B, hc * wc, c.coarse_dim)
            for i in range(c.depth):
                t = getattr(self, f"coarse_self{i}")(t, t)
                cross = getattr(self, f"coarse_cross{i}")
                t0 = cross(t[:B], t[B:])
                t = torch.cat([t0, cross(t[B:], t0)])
        fine = fine.permute(0, 2, 3, 1)
        return t[:B], t[B:], fine[:B], fine[B:], (hc, wc)


class OfficialFineModule(nn.Module):
    """The official FinePreprocess (coarse features down-projected and
    merged into every window position) and fine transformer (one self and
    one cross layer over each window). windows0/1 (B, M, W*W, Df), cfeat0/1
    (B, M, Dc) -> the transformed windows, (B, M, W*W, Df) each."""

    def __init__(self, cfg: LoFTRConfig):
        super().__init__()
        dt, Df = cfg.dtype, cfg.fine_dim
        self.dtype = dt
        self.down_proj = Dense(cfg.coarse_dim, Df, dtype=dt)
        self.merge_feat = Dense(2 * Df, Df, dtype=dt)
        self.fine_self0 = OfficialEncoderLayer(Df, cfg.num_heads, dt)
        self.fine_cross0 = OfficialEncoderLayer(Df, cfg.num_heads, dt)

    def forward(self, windows0, windows1, cfeat0, cfeat1):
        B, M, WW, Df = windows0.shape
        w = torch.cat([windows0, windows1]).to(self.dtype)
        cf = self.down_proj(torch.cat([cfeat0, cfeat1]).to(self.dtype))
        w = self.merge_feat(torch.cat([w, cf[:, :, None, :].expand(2 * B, M, WW, Df)], dim=-1))
        w = w.reshape(2 * B * M, WW, Df)
        w = self.fine_self0(w, w)
        f0 = self.fine_cross0(w[: B * M], w[B * M :])
        f1 = self.fine_cross0(w[B * M :], f0)
        return f0.reshape(B, M, WW, Df), f1.reshape(B, M, WW, Df)


def gather_fine_windows(f: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, window: int,
                        stride: int = 4) -> torch.Tensor:
    """Zero-padded window x window patches of the fine map centred at
    (stride * cx, stride * cy), as ``F.unfold(kernel=window, stride=4,
    padding=window // 2)`` gives them at the coarse cells.
    f (B, hf, wf, D), cx/cy (B, M) integer -> (B, M, window^2, D)."""
    B, hf, wf, D = f.shape
    r = window // 2
    offs = torch.arange(-r, r + 1, device=f.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    gx = cx[..., None].long() * stride + ox.reshape(-1)
    gy = cy[..., None].long() * stride + oy.reshape(-1)
    inb = (gx >= 0) & (gx < wf) & (gy >= 0) & (gy < hf)
    b = torch.arange(B, device=f.device)[:, None, None]
    pat = f[b, gy.clamp(0, hf - 1), gx.clamp(0, wf - 1)]
    return pat * inb[..., None].to(pat.dtype)


def fine_spatial_expectation(f0_win: torch.Tensor, f1_win: torch.Tensor,
                             window: int) -> torch.Tensor:
    """The official FineMatching: the centre feature of window 0 against
    every position of window 1, softmax at 1 / sqrt(C), the expectation on
    the [-1, 1] window grid. -> (B, M, 2) offsets in [-1, 1]."""
    WW, C = f0_win.shape[2], f0_win.shape[3]
    center = f0_win[:, :, WW // 2, :].to(torch.float32)
    sim = torch.einsum("bmc,bmrc->bmr", center, f1_win.to(torch.float32))
    heat = torch.softmax(sim / C**0.5, dim=-1)
    lin = torch.as_tensor(np.linspace(-1.0, 1.0, window, dtype=np.float32), device=heat.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([(heat * gx.reshape(-1)).sum(-1), (heat * gy.reshape(-1)).sum(-1)], -1)


class OfficialLoFTRMatcher(nn.Module):
    """The official forward: coarse transformer, dual-softmax matching,
    fine preprocess and transformer, spatial-expectation refinement.
    (B, H, W, 1) pairs with H, W multiples of 8 -> :class:`DenseMatches`."""

    def __init__(self, cfg: LoFTRConfig):
        super().__init__()
        self.cfg = cfg
        self.coarse = OfficialLoFTRNet(cfg)
        self.fine = OfficialFineModule(cfg)

    def forward(self, images0: torch.Tensor, images1: torch.Tensor) -> DenseMatches:
        """Profiler ranges: ``loftr.coarse`` over the coarse transformer and
        the matching, ``loftr.fine`` over the fine stage; the backbone and
        the keypoints' assembly run in the caller's range (``loftr.match``),
        so that a profile of it spans the whole forward."""
        c = self.cfg
        t0, t1, f0, f1, (hc, wc) = self.coarse(images0, images1)
        with record_function("loftr.coarse"):
            sel0, sel1, scores, valid = coarse_match(
                t0, t1, c.temperature, c.match_threshold, c.max_matches,
                normalize="sqrt_dim", grid_hw=(hc, wc), border_rm=c.border_rm)
        with record_function("loftr.fine"):
            x0, y0 = sel0 % wc, torch.div(sel0, wc, rounding_mode="floor")
            x1, y1 = sel1 % wc, torch.div(sel1, wc, rounding_mode="floor")
            w0 = gather_fine_windows(f0, x0, y0, c.fine_window)
            w1 = gather_fine_windows(f1, x1, y1, c.fine_window)
            D = t0.shape[-1]
            cf0 = t0.gather(1, sel0[..., None].expand(-1, -1, D))
            cf1 = t1.gather(1, sel1[..., None].expand(-1, -1, D))
            off = fine_spatial_expectation(*self.fine(w0, w1, cf0, cf1), c.fine_window)
        # coarse cells -> input pixels at scale 8 with no centre offset; the
        # offset is [-1, 1] x (W // 2) fine pixels x the fine stride 2
        kpts0 = torch.stack([x0 * 8.0, y0 * 8.0], dim=-1)
        kpts1 = torch.stack([x1 * 8.0, y1 * 8.0], dim=-1) + off * (float(c.fine_window // 2) * 2.0)
        return DenseMatches(kpts0, kpts1, scores, valid)


class LoFTR(BaseFeatureMatcher):
    """Batched dense matcher with the reference's resize and rescale
    contract; ``match_batch`` returns :class:`DenseMatches`."""

    # match_batch returns already-paired points: GeometricVerifier.
    # verify_pairs_batch dispatches on this
    dense_matcher = True

    def __init__(self, cfg: Optional[LoFTRConfig] = None, device="cuda"):
        self.cfg = cfg or LoFTRConfig()
        self.device = torch.device(device)
        net = OfficialLoFTRMatcher if self.cfg.official else LoFTRNet
        self.net = net(self.cfg).to(self.device).eval()

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "LoFTR":
        """Every Dense and Conv drawn with flax's initialisers (lecun-normal
        kernels, zero biases, LayerNorm ones and zeros) from
        ``torch.Generator().manual_seed(seed)``; the global RNG is left alone."""
        from mlis_tpu_torch.models.layers import flax_init_

        self.net.cpu()
        flax_init_(self.net, torch.Generator().manual_seed(int(seed)))
        self.net.to(self.device)
        return self

    def load_torch_state_dict(self, state_dict, shape=(64, 64)) -> None:
        """Load an official LoFTR checkpoint (kornia / zju3dv indoor or
        outdoor ds): a flat module state dict or the lightning layout
        (``state_dict`` with a ``matcher.`` prefix), torch tensors or numpy
        arrays. Needs ``cfg.official``. ``shape`` is the JAX package's init
        shape, which torch modules do not need."""
        from mlis_tpu_torch.models.convert import convert_loftr_torch
        from mlis_tpu_torch.weights import from_jax_params, to_jax_params

        if not self.cfg.official:
            raise ValueError("official checkpoints need LoFTRConfig(official=True)")
        tree = convert_loftr_torch(state_dict, to_jax_params(self.net.state_dict()))
        self.net.load_state_dict(from_jax_params(tree, scan_prefixes=()), strict=True)
        self.net.to(self.device)

    def load_weights(self, path: str, image_hw=None) -> None:
        """Load a ``save_weights`` npz (the ``loftr:`` tree). ``image_hw`` is
        the JAX package's init shape, which torch modules do not need."""
        from mlis_tpu_torch.weights import load_npz

        self.net.load_state_dict(load_npz(path, scan_prefixes=())["loftr"], strict=True)
        self.net.to(self.device)

    def save_weights(self, path: str) -> None:
        """Write the weights as the JAX package's ``save_weights`` does: one
        npz, the ``loftr:`` tree in flax layout, float16."""
        from mlis_tpu_torch.weights import save_params_npz, to_jax_params

        save_params_npz(path, loftr=to_jax_params(self.net.state_dict()))

    @torch.no_grad()
    def match_batch(self, images0: torch.Tensor, images1: torch.Tensor) -> DenseMatches:
        """(B, H, W, 1) grayscale pairs in [0, 1]. Sides that are not
        multiples of 8 are resized down to the nearest multiple and the
        keypoints scaled back to input pixels by (W / w8, H / h8)."""
        images0 = torch.as_tensor(images0, device=self.device).to(torch.float32)
        images1 = torch.as_tensor(images1, device=self.device).to(torch.float32)
        H, W = int(images0.shape[1]), int(images0.shape[2])
        h8, w8 = (H // 8) * 8, (W // 8) * 8
        if (h8, w8) != (H, W):
            m = self.match_batch(resize_nhwc(images0, (h8, w8)), resize_nhwc(images1, (h8, w8)))
            s = torch.tensor([W / w8, H / h8], dtype=torch.float32, device=self.device)
            return DenseMatches(m.kpts0 * s, m.kpts1 * s, m.scores, m.valid)
        cfg = self.cfg
        if cfg.official:
            with record_function("loftr.match"):
                return self.net(images0, images1)
        with record_function("loftr.match"):
            t0, t1, f0, f1, (hc, wc) = self.net(images0, images1)
            sel0, sel1, scores, valid = coarse_match(
                t0, t1, cfg.temperature, cfg.match_threshold, cfg.max_matches)
            x0, y0 = (sel0 % wc).float(), torch.div(sel0, wc, rounding_mode="floor").float()
            x1, y1 = (sel1 % wc).float(), torch.div(sel1, wc, rounding_mode="floor").float()
            # the fine grid is 1/2 resolution, the coarse 1/8: a factor of 4
            fine_xy1 = torch.stack([x1 * 4 + 1.5, y1 * 4 + 1.5], dim=-1)
            fine_xy0 = torch.stack([x0 * 4 + 1.5, y0 * 4 + 1.5], dim=-1)
            b = torch.arange(f0.shape[0], device=f0.device)[:, None]
            feat0 = f0.to(torch.float32)[b, fine_xy0[..., 1].long(), fine_xy0[..., 0].long()]
            refined1 = fine_refine(f1, fine_xy1, feat0, cfg.fine_window, 2)
            # to full-resolution pixels: coarse cell centres; the fine grid
            # has stride 2, plus half a cell
            kpts0 = torch.stack([x0 * 8 + 3.5, y0 * 8 + 3.5], dim=-1)
            return DenseMatches(kpts0, refined1 * 2.0 + 0.5, scores, valid)

    @torch.no_grad()
    def detect_and_match(self, image1, image2):
        """One pair of uint8 images -> (kpts1 (M, 2), kpts2 (M, 2), scores
        (M,)), tensors on the device: grayscale resized down to multiples of
        8, keypoints scaled back."""
        h, w = int(image1.shape[0]), int(image1.shape[1])
        h8, w8 = (h // 8) * 8, (w // 8) * 8
        g1 = to_grayscale(torch.as_tensor(image1, device=self.device)[None], size=(h8, w8))
        g2 = to_grayscale(torch.as_tensor(image2, device=self.device)[None], size=(h8, w8))
        m = self.match_batch(g1, g2)
        valid = m.valid[0]
        s = torch.tensor([w / w8, h / h8], dtype=torch.float32, device=self.device)
        k0, k1 = m.kpts0[0][valid] * s, m.kpts1[0][valid] * s
        # detector-free: the "detected" keypoints are the matched points
        self.last_detector_counts = (int(k0.shape[0]), int(k1.shape[0]))
        return k0, k1, m.scores[0][valid]
