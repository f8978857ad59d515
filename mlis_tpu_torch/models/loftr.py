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

Inputs whose sides are not multiples of 8 are resized down to the nearest
multiple (bilinear with antialiasing, as ``jax.image.resize(method=
"linear")``) and the keypoints scaled back. The linear attention, like the
rest, is plain PyTorch: the JAX package computes it with XLA einsums, no
Pallas kernel. The official kornia architecture of the JAX module (its
``official=True`` path and ``load_torch_state_dict``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from mlis_tpu_torch.gating.verification import BaseFeatureMatcher
from mlis_tpu_torch.models.layers import Conv, Dense
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
    # the JAX package's official-architecture fields (kornia LoFTR); the
    # port keeps them for configuration parity and refuses official=True
    official: bool = False
    initial_dim: int = 128
    block_dims: Tuple[int, ...] = (128, 196, 256)
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


class LoFTR(BaseFeatureMatcher):
    """Batched dense matcher with the reference's resize and rescale
    contract; ``match_batch`` returns :class:`DenseMatches`."""

    # match_batch returns already-paired points: GeometricVerifier.
    # verify_pairs_batch dispatches on this
    dense_matcher = True

    def __init__(self, cfg: Optional[LoFTRConfig] = None, device="cuda"):
        self.cfg = cfg or LoFTRConfig()
        if self.cfg.official:
            raise NotImplementedError(
                "the official kornia LoFTR architecture is not ported (ROADMAP Queue 1 item 6, "
                "with models/convert.convert_loftr_torch)")
        self.device = torch.device(device)
        self.net = LoFTRNet(self.cfg).to(self.device).eval()

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
