"""SuperPoint keypoint detector + descriptor, batched with static shapes.

Counterpart of ``mlis_tpu/models/superpoint.py``: a VGG trunk, a 65-way
detector head turned into a full-resolution heatmap, max-pool NMS
(radius 4), one global top-K over the heatmap (score-sorted, so the
validity mask is a prefix; ties go to the lower flat index, as with
``lax.top_k``), and descriptors sampled bilinearly from the 1/8-resolution
map and L2-normalised. Public functions keep the JAX package's
channels-last layout.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mlis_tpu_torch.models.layers import Conv
from mlis_tpu_torch.ops.knn import topk_lower_index
from mlis_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    channels: Tuple[int, ...] = (64, 64, 128, 128)
    descriptor_dim: int = 256
    max_keypoints: int = 2048
    detection_threshold: float = 0.001
    nms_radius: int = 4
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test(**kw) -> "SuperPointConfig":
        kw.setdefault("channels", (8, 8, 16, 16))
        kw.setdefault("descriptor_dim", 32)
        kw.setdefault("max_keypoints", 128)
        return SuperPointConfig(**kw)


class Keypoints(NamedTuple):
    coords: torch.Tensor  # (B, K, 2) xy pixel coords
    scores: torch.Tensor  # (B, K)
    descriptors: torch.Tensor  # (B, K, D) L2-normalised
    mask: torch.Tensor  # (B, K) bool, above-threshold keypoints

    def map(self, fn) -> "Keypoints":
        return Keypoints(*(fn(x) for x in self))


class SuperPointNet(nn.Module):
    def __init__(self, cfg: SuperPointConfig):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.channels, cfg.dtype
        in_ch = 1
        for stage in range(4):
            for i in range(2):
                self.add_module(f"conv{stage + 1}_{i}", Conv(in_ch, c[stage], 3, padding=1, dtype=dt))
                in_ch = c[stage]
        self.det_conv = Conv(in_ch, 256, 3, padding=1, dtype=dt)
        self.det_out = Conv(256, 65, 1, dtype=dt)
        self.desc_conv = Conv(in_ch, 256, 3, padding=1, dtype=dt)
        self.desc_out = Conv(256, cfg.descriptor_dim, 1, dtype=dt)

    def _heads(self, images: torch.Tensor):
        """The VGG trunk and both heads: (detector logits (B, 65, hc, wc) in
        the compute dtype, desc_map (B, hc, wc, D) float32, L2-normalised)."""
        x = images.permute(0, 3, 1, 2)
        for stage in range(4):
            for i in range(2):
                x = F.relu(getattr(self, f"conv{stage + 1}_{i}")(x))
            if stage < 3:
                x = F.max_pool2d(x, 2, stride=2)
        det = self.det_out(F.relu(self.det_conv(x)))
        desc = self.desc_out(F.relu(self.desc_conv(x))).to(torch.float32)
        desc = desc.permute(0, 2, 3, 1)
        desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
        return det, desc

    def forward(self, images: torch.Tensor):
        """images: (B, H, W, 1) grayscale in [0, 1], H and W divisible by 8.

        Returns (heatmap (B, H, W) float32, desc_map (B, H/8, W/8, D) float32)."""
        det, desc = self._heads(images)
        prob = torch.softmax(det.to(torch.float32), dim=1)[:, :64]  # (B, 64, hc, wc)
        B, _, hc, wc = prob.shape
        heat = prob.permute(0, 2, 3, 1).reshape(B, hc, wc, 8, 8)
        heat = heat.permute(0, 1, 3, 2, 4).reshape(B, hc * 8, wc * 8)
        return heat, desc

    def raw_head(self, images: torch.Tensor):
        """The heads before the detector softmax, for training: (logits (B,
        hc, wc, 65) in the compute dtype, desc_map (B, hc, wc, D) float32,
        L2-normalised), what the JAX package's SuperPointTrainer captures
        from ``det_out`` and ``desc_out``."""
        det, desc = self._heads(images)
        return det.permute(0, 2, 3, 1), desc


def nms_heatmap(heat: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Zero the scores that are not the max of their (2r+1)^2 window."""
    w = 2 * radius + 1
    pooled = F.max_pool2d(heat[:, None], w, stride=1, padding=radius)[:, 0]
    return torch.where(heat >= pooled, heat, torch.zeros_like(heat))


def topk_keypoints(heat: torch.Tensor, k: int, threshold: float):
    """(B, H, W) -> coords (B, K, 2) xy, scores (B, K), mask (B, K)."""
    B, H, W = heat.shape
    scores, idx = topk_lower_index(heat.reshape(B, H * W), k)
    ys = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    xs = (idx % W).to(torch.float32)
    return torch.stack([xs, ys], dim=-1), scores, scores > threshold


def sample_descriptors(desc_map: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of (B, hc, wc, D) descriptors at full-res (B, K, 2)
    xy coordinates (cell centres at 8i + 3.5), L2-normalised."""
    B, hc, wc, D = desc_map.shape
    gx = ((coords[..., 0] - 3.5) / 8.0).clamp(0, wc - 1)
    gy = ((coords[..., 1] - 3.5) / 8.0).clamp(0, hc - 1)
    x0, y0 = gx.floor(), gy.floor()
    x1 = (x0 + 1).clamp(max=wc - 1)
    y1 = (y0 + 1).clamp(max=hc - 1)
    wx, wy = gx - x0, gy - y0
    b = torch.arange(B, device=desc_map.device)[:, None]

    def gather(yy, xx):
        return desc_map[b, yy.long(), xx.long()]

    out = (
        gather(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
        + gather(y0, x1) * (wx * (1 - wy))[..., None]
        + gather(y1, x0) * ((1 - wx) * wy)[..., None]
        + gather(y1, x1) * (wx * wy)[..., None]
    )
    return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-8)


class SuperPoint:
    """Batched detector: grayscale images -> fixed-K keypoints."""

    def __init__(self, cfg: SuperPointConfig | None = None, device="cuda"):
        self.cfg = cfg or SuperPointConfig()
        self.device = torch.device(device)
        self.net = SuperPointNet(self.cfg).to(self.device).eval()

    def load_state(self, state_dict) -> None:
        self.net.load_state_dict(state_dict, strict=True)
        self.net.to(self.device)

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "SuperPoint":
        """The filters drawn with flax's initialisers (lecun-normal kernels,
        zero biases) from ``torch.Generator().manual_seed(seed)``; the
        global RNG is left alone."""
        from mlis_tpu_torch.models.layers import flax_init_

        self.net.cpu()
        flax_init_(self.net, torch.Generator().manual_seed(int(seed)))
        self.net.to(self.device)
        return self

    @torch.no_grad()
    def detect(self, images: torch.Tensor) -> Keypoints:
        """(B, H, W, 1) float grayscale in [0, 1] -> Keypoints (static K)."""
        cfg = self.cfg
        heat, desc_map = self.net(images.to(self.device))
        with span("superpoint.nms_topk"):
            heat = nms_heatmap(heat, cfg.nms_radius)
            coords, scores, mask = topk_keypoints(heat, cfg.max_keypoints,
                                                  cfg.detection_threshold)
        return Keypoints(coords, scores, sample_descriptors(desc_map, coords), mask)
