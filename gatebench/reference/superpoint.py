"""SuperPoint (DeTone et al., 2018) as the gate runs it, in plain PyTorch.

A VGG trunk (two 3x3 convolutions a stage, 2x2 max-pooling between the
four stages), a 65-way detector head turned into a full-resolution
heatmap, max-pool NMS, one global score-sorted top-K (ties to the lower
flat index), descriptors sampled bilinearly from the 1/8-resolution map
at (x - 3.5) / 8 and L2-normalised. Frames are converted to grey in
[0, 1] and resized to the largest multiple of 8 that fits, and the
keypoints are scaled back to input pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gatebench.reference.nets import conv, resize_bilinear


class Keypoints(NamedTuple):
    coords: torch.Tensor  # (B, K, 2) xy in input pixels
    scores: torch.Tensor  # (B, K)
    descriptors: torch.Tensor  # (B, K, D)
    mask: torch.Tensor  # (B, K) bool
    grid: torch.Tensor  # (B, K) int64 flat index y * w8 + x at the detect resolution


def detect_size(H: int, W: int):
    return (H // 8) * 8, (W // 8) * 8


def heads(p: dict, x: torch.Tensor, prec: str):
    for stage in range(4):
        for i in range(2):
            x = F.relu(conv(x, p[f"conv{stage + 1}_{i}"], prec, padding=1))
        if stage < 3:
            x = F.max_pool2d(x, 2, stride=2)
    det = conv(F.relu(conv(x, p["det_conv"], prec, padding=1)), p["det_out"], prec)
    desc = conv(F.relu(conv(x, p["desc_conv"], prec, padding=1)), p["desc_out"], prec)
    desc = desc / (torch.linalg.vector_norm(desc, dim=1, keepdim=True) + 1e-8)
    return det, desc.permute(0, 2, 3, 1)  # (B, 65, hc, wc), (B, hc, wc, D)


def sample_descriptors(desc_map: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    B, hc, wc, D = desc_map.shape
    gx = ((xy[..., 0] - 3.5) / 8.0).clamp(0, wc - 1)
    gy = ((xy[..., 1] - 3.5) / 8.0).clamp(0, hc - 1)
    x0, y0 = gx.floor(), gy.floor()
    x1 = (x0 + 1).clamp(max=wc - 1)
    y1 = (y0 + 1).clamp(max=hc - 1)
    wx, wy = gx - x0, gy - y0
    b = torch.arange(B, device=desc_map.device)[:, None]

    def at(yy, xx):
        return desc_map[b, yy.long(), xx.long()]

    out = (at(y0, x0) * ((1 - wx) * (1 - wy))[..., None] + at(y0, x1) * (wx * (1 - wy))[..., None]
           + at(y1, x0) * ((1 - wx) * wy)[..., None] + at(y1, x1) * (wx * wy)[..., None])
    return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-8)


def detect(p: dict, images_u8: torch.Tensor, max_keypoints: int, keep: int, prec: str,
           threshold: float = 0.001, nms_radius: int = 4) -> Keypoints:
    """(B, H, W) mono8 frames -> the ``keep`` best of ``max_keypoints``
    keypoints a frame (``keep`` <= max_keypoints: the matched prefix)."""
    B, H, W = images_u8.shape
    h8, w8 = detect_size(H, W)
    gray = resize_bilinear(images_u8.to(torch.float32)[:, None] / 255.0, (h8, w8))
    det, desc_map = heads(p, gray, prec)
    prob = torch.softmax(det, dim=1)[:, :64]
    hc, wc = prob.shape[-2:]
    heat = prob.reshape(B, 8, 8, hc, wc).permute(0, 3, 1, 4, 2).reshape(B, hc * 8, wc * 8)
    pooled = F.max_pool2d(heat[:, None], 2 * nms_radius + 1, stride=1, padding=nms_radius)[:, 0]
    heat = torch.where(heat >= pooled, heat, torch.zeros_like(heat))
    scores, idx = torch.sort(heat.reshape(B, -1), dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :max_keypoints][:, :keep], idx[:, :max_keypoints][:, :keep]
    xy = torch.stack([(idx % w8).to(torch.float32),
                      torch.div(idx, w8, rounding_mode="floor").to(torch.float32)], -1)
    descriptors = sample_descriptors(desc_map, xy)
    sxy = torch.tensor([W / w8, H / h8], dtype=torch.float32, device=xy.device)
    return Keypoints(xy * sxy, scores, descriptors, scores > threshold, idx)
