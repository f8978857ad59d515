"""ORB: batched FAST-9 corners, steered BRIEF-256 and Hamming cross-check
matching, all on tensors on the caller's device.

Counterpart of ``mlis_tpu/models/orb.py``, the weight-free classical
matcher:

* FAST-9: the 16-pixel Bresenham ring is 16 rolled copies of the image
  (wrap-around, as ``jnp.roll``); a corner has 9 contiguous ring pixels all
  brighter or all darker than the centre by ``threshold``; its score is the
  summed margin; 3x3 non-max suppression by rolled maxima, then the border
  margin (the BRIEF patch radius + 3) is cleared and the top K kept, ties
  to the lower flat index as with ``lax.top_k``;
* orientation: the intensity centroid over a radius-15 disc, ``atan2``;
* steered BRIEF: a fixed pattern of 256 point pairs drawn with numpy's
  ``default_rng(7)`` and rotated by the orientation, sampled nearest
  (round half to even) from a 5x5 box-blurred image; bit i of word w is
  test 32 w + i. ``torch.uint32`` has few operators, so the eight 32-bit
  words are held in ``int64`` with the same bit pattern;
* matching: Hamming distance by a byte popcount table over the XORed
  words, mutual nearest neighbours (first index on ties), matches sorted by
  distance with confidence 1 - d / max d.

Matching is one pair at a time, as in the JAX package: ``GeometricVerifier``
verifies ORB pairs one by one through ``verify``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mlis_tpu_torch.gating.verification import BaseFeatureMatcher
from mlis_tpu_torch.ops.image import BT601_BGR
from mlis_tpu_torch.ops.knn import topk_lower_index

# 16-point Bresenham circle of radius 3 (dy, dx), clockwise from 12 o'clock
FAST_RING = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_PATCH_R = 15  # orientation / BRIEF sampling radius
_MARGIN = _PATCH_R + 3
_BIG = 1 << 24  # distance of a pair with an invalid keypoint


def _brief_pattern(seed: int = 7, n: int = 256) -> np.ndarray:
    """(n, 2, 2) test-point pairs (dy, dx) ~ N(0, (R/5)^2), rounded and
    clipped to the patch; the same numpy draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    pts = np.clip(
        np.round(rng.normal(scale=_PATCH_R / 5.0, size=(n, 2, 2))),
        -(_PATCH_R - 2),
        _PATCH_R - 2,
    )
    return pts.astype(np.float32)


def _sum_first_axis(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in index order (a fixed float32 summation order)."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


@torch.no_grad()
def fast_detect(
    images: torch.Tensor,  # (B, H, W) float32 grayscale in [0, 1]
    max_keypoints: int = 512,
    threshold: float = 0.08,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FAST-9 corners with 3x3 non-max suppression.

    Returns (coords (B, K, 2) float32 xy, scores (B, K), valid (B, K))."""
    B, H, W = images.shape
    c = images.to(torch.float32)
    ring = torch.stack([torch.roll(c, (-dy, -dx), dims=(1, 2)) for dy, dx in FAST_RING])
    bright = ring > c + threshold
    dark = ring < c - threshold

    def arc9(flags):
        ext = torch.cat([flags, flags[:8]], dim=0)  # wrap the ring
        return torch.stack([ext[i : i + 9].all(dim=0) for i in range(16)]).any(dim=0)

    corner = arc9(bright) | arc9(dark)
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    margin = (torch.where(bright, ring - c - threshold, zero)
              + torch.where(dark, c - threshold - ring, zero))
    score = torch.where(corner, _sum_first_axis(margin), zero)

    neigh = torch.stack([
        torch.roll(score, (dy, dx), dims=(1, 2))
        for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)
    ]).amax(dim=0)
    score = torch.where(score >= neigh, score, zero)

    ys = torch.arange(H, device=c.device)[:, None]
    xs = torch.arange(W, device=c.device)[None, :]
    interior = (ys >= _MARGIN) & (ys < H - _MARGIN) & (xs >= _MARGIN) & (xs < W - _MARGIN)
    score = torch.where(interior, score, zero)

    top, idx = topk_lower_index(score.reshape(B, H * W), max_keypoints)
    coords = torch.stack([(idx % W).to(torch.float32),
                          torch.div(idx, W, rounding_mode="floor").to(torch.float32)], dim=-1)
    return coords, top, top > 0.0


def _box_blur(images: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(2r+1)^2 separable box blur with wrap-around borders."""
    out = images
    for axis in (1, 2):
        acc = out
        for d in range(1, r + 1):
            acc = acc + torch.roll(out, d, dims=axis) + torch.roll(out, -d, dims=axis)
        out = acc / (2 * r + 1)
    return out


@torch.no_grad()
def orb_detect_describe(
    images: torch.Tensor,  # (B, H, W) float32 in [0, 1]
    max_keypoints: int = 512,
    threshold: float = 0.08,
):
    """FAST-9 -> intensity-centroid orientation -> steered BRIEF-256.

    Returns (coords (B, K, 2) xy, desc (B, K, 8) int64 words holding 32
    bits each, valid (B, K))."""
    B, H, W = images.shape
    dev = images.device
    coords, _, valid = fast_detect(images, max_keypoints, threshold)
    flat = _box_blur(images.to(torch.float32)).reshape(B, H * W)

    def gather(yy, xx):  # yy, xx (B, ...) int64
        yy = yy.clamp(0, H - 1)
        xx = xx.clamp(0, W - 1)
        lin = (yy * W + xx).reshape(B, -1)
        return flat.gather(1, lin).reshape(yy.shape)

    kx = coords[..., 0].to(torch.int64)  # (B, K)
    ky = coords[..., 1].to(torch.int64)

    # orientation: intensity centroid over a radius-15 disc
    dd = torch.arange(-_PATCH_R, _PATCH_R + 1, device=dev)
    dy, dx = torch.meshgrid(dd, dd, indexing="ij")
    disc = ((dy**2 + dx**2) <= _PATCH_R**2).reshape(-1).to(torch.float32)
    dyf, dxf = dy.reshape(-1), dx.reshape(-1)
    patch = gather(ky[..., None] + dyf, kx[..., None] + dxf) * disc  # (B, K, P)
    m01 = (patch * dyf.to(torch.float32)).sum(-1)
    m10 = (patch * dxf.to(torch.float32)).sum(-1)
    theta = torch.atan2(m01, m10)  # (B, K)

    # steered BRIEF: rotate the pattern by theta, sample the nearest pixel
    pat = torch.as_tensor(_brief_pattern(), device=dev)  # (256, 2, 2) (dy, dx)
    py, px = pat[:, :, 0], pat[:, :, 1]
    cos_t = torch.cos(theta)[..., None, None]  # (B, K, 1, 1)
    sin_t = torch.sin(theta)[..., None, None]
    ry = cos_t * py + sin_t * px  # (B, K, 256, 2)
    rx = -sin_t * py + cos_t * px
    yy = ky[..., None, None] + torch.round(ry).to(torch.int64)
    xx = kx[..., None, None] + torch.round(rx).to(torch.int64)
    vals = gather(yy, xx)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int64)  # (B, K, 256)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    desc = (bits.reshape(B, -1, 8, 32) << shifts).sum(-1)  # (B, K, 8)
    return coords, desc, valid


_POPCOUNT8 = [bin(i).count("1") for i in range(256)]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each int64, by a byte table."""
    table = torch.tensor(_POPCOUNT8, dtype=torch.int64, device=x.device)
    return sum(table[(x >> (8 * j)) & 255] for j in range(4))


@torch.no_grad()
def hamming_mutual_match(
    d0: torch.Tensor,  # (K0, 8) words
    v0: torch.Tensor,  # (K0,) bool
    d1: torch.Tensor,  # (K1, 8)
    v1: torch.Tensor,
):
    """Brute-force Hamming + cross-check (BFMatcher crossCheck=True).
    Returns (match_idx (K0,) int64, -1 where unmatched; distance (K0,))."""
    dist = popcount32(d0[:, None, :] ^ d1[None, :, :]).sum(-1)
    big = torch.full_like(dist, _BIG)
    dist = torch.where(v0[:, None] & v1[None, :], dist, big)
    nn0 = dist.argmin(dim=1)  # first index on ties
    nn1 = dist.argmin(dim=0)
    d_best = dist.gather(1, nn0[:, None])[:, 0]
    mutual = (nn1[nn0] == torch.arange(d0.shape[0], device=d0.device)) & (d_best < _BIG)
    return torch.where(mutual, nn0, torch.full_like(nn0, -1)), d_best



class ORBMatcher(BaseFeatureMatcher):
    """Weight-free matcher: ``detect_and_match(img0, img1) -> (mkpts0,
    mkpts1, confidences)``, matches sorted by ascending Hamming distance,
    confidence 1 - d / max d. Tensors live on ``device``."""

    def __init__(self, max_keypoints: int = 512, fast_threshold: float = 0.08, device="cuda"):
        self.max_keypoints = max_keypoints
        self.fast_threshold = fast_threshold
        self.device = torch.device(device)

    def _gray_batch(self, images) -> torch.Tensor:
        """uint8 or float, colour or mono -> (B, H, W) float32 in [0, 1]:
        BT.601 luma in BGR order for colour, divided by 255 when the values
        reach past 1.5."""
        x = torch.as_tensor(images, device=self.device)
        if x.dim() >= 3 and x.shape[-1] == 3:
            x = x.to(torch.float32)
            x = x[..., 0] * BT601_BGR[0] + x[..., 1] * BT601_BGR[1] + x[..., 2] * BT601_BGR[2]
        elif x.dim() >= 3 and x.shape[-1] == 1:
            x = x[..., 0]
        x = x.to(torch.float32)
        if x.numel() and float(x.max()) > 1.5:  # integer-range input
            x = x / 255.0
        return x

    def _to_gray(self, image) -> torch.Tensor:
        g = self._gray_batch(image)
        return g[None] if g.dim() == 2 else g

    def detect_and_describe(self, images):
        """Batched front end on (B, H, W[, C]) images."""
        return orb_detect_describe(self._gray_batch(images), self.max_keypoints,
                                   self.fast_threshold)

    @torch.no_grad()
    def detect_and_match(self, image1, image2):
        """One pair -> (matched kpts1 (M, 2), kpts2 (M, 2), confidences (M,)
        float64), tensors on the matcher's device."""
        with record_function("orb.match"):
            g1, g2 = self._to_gray(image1), self._to_gray(image2)
            if g1.shape == g2.shape:
                coords, desc, valid = orb_detect_describe(
                    torch.cat([g1, g2]), self.max_keypoints, self.fast_threshold)
                c1, c2, d1, d2, v1, v2 = (coords[0], coords[1], desc[0], desc[1],
                                          valid[0], valid[1])
            else:
                c1, d1, v1 = (a[0] for a in orb_detect_describe(
                    g1, self.max_keypoints, self.fast_threshold))
                c2, d2, v2 = (a[0] for a in orb_detect_describe(
                    g2, self.max_keypoints, self.fast_threshold))
            n1, n2 = (int(n) for n in torch.stack([v1.sum(), v2.sum()]).tolist())
            self.last_detector_counts = (n1, n2)
            empty = (c1.new_zeros((0, 2)), c1.new_zeros((0, 2)),
                     torch.zeros(0, dtype=torch.float64, device=c1.device))
            if n1 < 5 or n2 < 5:
                return empty
            midx, mdist = hamming_mutual_match(d1, v1, d2, v2)
            keep = torch.nonzero(midx >= 0)[:, 0]
            if keep.numel() == 0:
                return empty
            order = keep[torch.sort(mdist[keep], stable=True)[1]]
            dists = mdist[order].to(torch.float64)
            max_d = dists.max()
            conf = 1.0 - dists / torch.where(max_d > 0, max_d, torch.ones_like(max_d))
            return c1[order], c2[midx[order]], conf
