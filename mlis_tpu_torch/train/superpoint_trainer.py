"""Self-supervised SuperPoint training: synthetic corners and homography
descriptors, on the device.

Counterpart of ``mlis_tpu/train/superpoint_trainer.py``, the official
recipe's two ingredients:

1. detector: images of random convex quads over a low-frequency background
   with exact corner ground truth (half-plane tests); the detector head
   minimises the 65-way cell softmax cross-entropy against the corner
   cells (SuperPoint paper eq. 1-2);
2. descriptor: each scene (half texture, half shapes) warped by a random
   homography, and the dense hinge loss over all cell pairs (eq. 4):
   positive margin for cells that correspond under H, negative otherwise.

Both losses train jointly. The JAX functions draw from keys; here they
take their raw U[0, 1) draws as tensors (:class:`ShapeDraws`,
:class:`SuperPointDraws`), made by ``draw_*`` helpers from a
``torch.Generator``. :func:`corner_cell_labels` resolves several corners in
one cell as the reference's scatter does, the last one winning, but
deterministically on any device: the largest corner index per cell is
found with ``scatter_reduce(amax)`` and its label gathered.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mlis_tpu_torch.ops.image import resize_nhwc
from mlis_tpu_torch.train.matcher_trainer import (
    Draws,
    apply_homography,
    draw_homography_jitter,
    draw_texture_noise,
    random_homography,
    synthetic_textures,
    uniform_range,
    warp_image,
)
from mlis_tpu_torch.train.optim import ClippedAdam

SHAPES_PER_IMAGE = 6
_BASE_ANGLES = (0.25, 1.8, 3.4, 5.0)


# -- synthetic shapes with exact corners ---------------------------------------------

@dataclasses.dataclass
class ShapeDraws(Draws):
    """U[0, 1) draws of :func:`render_shapes` for n images of S quads."""

    bg: torch.Tensor  # (n, H // 32 + 1, W // 32 + 1) background noise
    shades: torch.Tensor  # (n, S)
    centers: torch.Tensor  # (n, S, 2)
    radii: torch.Tensor  # (n, S, 4, 2)
    angles: torch.Tensor  # (n, S, 4)


def draw_shapes(n: int, H: int, W: int, shapes_per_image: int = SHAPES_PER_IMAGE,
                generator: Optional[torch.Generator] = None, device="cuda") -> ShapeDraws:
    S = shapes_per_image

    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return ShapeDraws(u(n, H // 32 + 1, W // 32 + 1), u(n, S), u(n, S, 2), u(n, S, 4, 2),
                      u(n, S, 4))


def _render_polygon(yy: torch.Tensor, xx: torch.Tensor, verts: torch.Tensor,
                    shade: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill convex polygons of CCW-ordered (..., V, 2) xy vertices by
    half-plane tests: (mask (..., H, W) x shade, the vertices)."""
    nxt = torch.roll(verts, -1, dims=-2)
    ex = (nxt[..., 0] - verts[..., 0])[..., None, None]
    ey = (nxt[..., 1] - verts[..., 1])[..., None, None]
    px = xx - verts[..., 0, None, None]
    py = yy - verts[..., 1, None, None]
    inside = (ex * py - ey * px >= 0.0).all(-3)
    return inside.to(torch.float32) * shade[..., None, None], verts


def _ccw_sort(verts: torch.Tensor) -> torch.Tensor:
    """(..., V, 2) vertices ordered by angle about their mean."""
    c = verts.mean(-2, keepdim=True)
    ang = torch.atan2(verts[..., 1] - c[..., 1], verts[..., 0] - c[..., 0])
    order = torch.argsort(ang, dim=-1, stable=True)
    return verts.gather(-2, order[..., None].expand_as(verts))


def render_shapes(draws: ShapeDraws, H: int, W: int):
    """(n, H, W) images of random convex quads over a noise background with
    exact corner ground truth: (images, corners (n, S * 4, 2) xy,
    corner_valid (n, S * 4)), every corner valid (a degenerate sliver still
    has its corners)."""
    dev = draws.bg.device
    n, S = draws.shades.shape
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    # low-frequency background, upsampled linearly as jax.image.resize
    img = resize_nhwc((draws.bg * 0.3)[..., None], (H, W), antialias=True)[..., 0]
    shades = uniform_range(draws.shades, 0.35, 1.0)
    wh = torch.tensor([W, H], dtype=torch.float32, device=dev)
    center = uniform_range(draws.centers, 0.12, 0.88) * wh
    radii = uniform_range(draws.radii, 6.0, 0.18 * W)
    angles = torch.tensor(_BASE_ANGLES, dtype=torch.float32, device=dev) + uniform_range(
        draws.angles, 0.0, 1.2)
    pts = center[..., None, :] + radii * torch.stack([torch.cos(angles), torch.sin(angles)], -1)
    lo = torch.ones(2, dtype=torch.float32, device=dev)
    hi = torch.tensor([W - 2.0, H - 2.0], dtype=torch.float32, device=dev)
    pts = _ccw_sort(torch.maximum(torch.minimum(pts, hi), lo))  # (n, S, 4, 2)
    for i in range(S):
        m, _ = _render_polygon(yy, xx, pts[:, i], shades[:, i])
        img = torch.where(m > 0, m, img)
    corners = pts.reshape(n, S * 4, 2)
    return img, corners, torch.ones(corners.shape[:2], dtype=torch.bool, device=dev)


def corner_cell_labels(corners: torch.Tensor, valid: torch.Tensor, H: int,
                       W: int) -> torch.Tensor:
    """(B, H/8, W/8) int32 labels in [0, 64]: the in-cell position of a
    corner in each 8x8 cell, 64 (the dustbin) where there is none. Several
    corners in one cell: the last one wins. As in the reference, an invalid
    corner writes the dustbin to cell 0, and a flat cell index past the
    grid (a bottom row cut by H % 8) is dropped."""
    B, C, _ = corners.shape
    hc, wc = H // 8, W // 8
    ix = corners[..., 0].clamp(0, W - 1).to(torch.int64)
    iy = corners[..., 1].clamp(0, H - 1).to(torch.int64)
    cell = torch.where(valid, (iy // 8) * wc + ix // 8, torch.zeros_like(ix))
    label = torch.where(valid, (iy % 8) * 8 + ix % 8, torch.full_like(ix, 64))
    n_cells = hc * wc
    target = torch.where((cell >= 0) & (cell < n_cells), cell, torch.full_like(cell, n_cells))
    order = torch.arange(C, device=corners.device).expand(B, C)
    last = torch.full((B, n_cells + 1), -1, dtype=torch.int64, device=corners.device)
    last = last.scatter_reduce(1, target, order, reduce="amax")[:, :n_cells]
    labels = torch.where(last >= 0, label.gather(1, last.clamp_min(0)), torch.full_like(last, 64))
    return labels.to(torch.int32).reshape(B, hc, wc)


def detector_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """65-way cell softmax cross-entropy, corner and dustbin cells each
    averaged on their own (balancing the dustbin majority)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    is_corner = labels < 64
    zero = torch.zeros_like(nll)
    return (torch.where(is_corner, nll, zero).sum() / is_corner.sum().clamp_min(1)
            + torch.where(~is_corner, nll, zero).sum() / (~is_corner).sum().clamp_min(1))


def descriptor_loss(desc0: torch.Tensor, desc1: torch.Tensor, Hms: torch.Tensor, H: int, W: int,
                    pos_margin: float = 1.0, neg_margin: float = 0.2,
                    neg_weight: float = 0.25) -> torch.Tensor:
    """Dense hinge loss over all cell pairs (eq. 4): cells whose centres
    correspond under H within 8 px are positives. desc (B, hc, wc, D)."""
    B, hc, wc, D = desc0.shape
    cy, cx = torch.meshgrid(torch.arange(hc, device=desc0.device) * 8.0 + 3.5,
                            torch.arange(wc, device=desc0.device) * 8.0 + 3.5, indexing="ij")
    centers = torch.stack([cx.reshape(-1), cy.reshape(-1)], -1)  # (N, 2)
    warped = apply_homography(Hms, centers)  # (B, N, 2): image 0's centres in image 1
    dist = torch.linalg.vector_norm(warped[:, :, None, :] - centers[None, None], dim=-1)
    in_view = ((warped[..., 0] >= 0) & (warped[..., 0] <= W - 1)
               & (warped[..., 1] >= 0) & (warped[..., 1] <= H - 1)).to(torch.float32)
    s = (dist <= 8.0).to(torch.float32) * in_view[..., None]
    dot = desc0.reshape(B, -1, D) @ desc1.reshape(B, -1, D).transpose(1, 2)
    pos = s * torch.clamp_min(pos_margin - dot, 0.0)
    neg = (1.0 - s) * torch.clamp_min(dot - neg_margin, 0.0)
    n_pos = s.sum((1, 2)).clamp_min(1.0)
    n_neg = (1.0 - s).sum((1, 2)).clamp_min(1.0)
    return (pos.sum((1, 2)) / n_pos + neg_weight * neg.sum((1, 2)) / n_neg).mean()


# -- trainer ----------------------------------------------------------------------------

@dataclasses.dataclass
class SuperPointDraws(Draws):
    """One joint step's draws: the shapes, the textures' noise and gains,
    and the homographies' corner draws."""

    shapes: ShapeDraws
    tex_grids: List[torch.Tensor]
    tex_gains: torch.Tensor
    corners: torch.Tensor  # (B, 4, 2)


def draw_superpoint_step(n: int, H: int, W: int, generator: Optional[torch.Generator] = None,
                         device="cuda") -> SuperPointDraws:
    shapes = draw_shapes(n, H, W, generator=generator, device=device)
    grids, gains = draw_texture_noise(n, H, W, generator, device)
    return SuperPointDraws(shapes, grids, gains, draw_homography_jitter(n, generator, device))


class SuperPointTrainer:
    """Joint detector (synthetic corners) and descriptor (homography pairs)
    training of ``sp.net`` (``optimizer``: a :class:`ClippedAdam` over it;
    by default clip 1.0 and Adam at ``learning_rate``). Draws come from
    ``torch.Generator(device).manual_seed(seed)``."""

    def __init__(self, sp, image_hw: Tuple[int, int], learning_rate=1e-3,
                 desc_weight: float = 1.0, max_corner_jitter: float = 0.15, seed: int = 0,
                 optimizer: Optional[ClippedAdam] = None):
        self.sp = sp
        self.device = sp.device
        self.image_hw = (int(image_hw[0]), int(image_hw[1]))
        self.desc_weight = float(desc_weight)
        self.max_corner_jitter = float(max_corner_jitter)
        self.optimizer = optimizer or ClippedAdam(sp.net.parameters(), learning_rate)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def draw_step(self, batch_size: int) -> SuperPointDraws:
        H, W = self.image_hw
        return draw_superpoint_step(batch_size, H, W, self.generator, self.device)

    def step(self, draws: SuperPointDraws) -> torch.Tensor:
        """One joint update; returns the device vector [total, detector,
        descriptor] of the losses."""
        H, W = self.image_hw
        with torch.no_grad():
            shape_imgs, corners, cvalid = render_shapes(draws.shapes, H, W)
            labels = corner_cell_labels(corners, cvalid, H, W)
            tex = synthetic_textures(draws.tex_grids, draws.tex_gains, H, W)
            mix = 0.5 * tex + 0.5 * shape_imgs
            Hms = random_homography(draws.corners, H, W, self.max_corner_jitter)
            warped = warp_image(mix, Hms)
        self.optimizer.zero_grad()
        net = self.sp.net
        logits, _ = net.raw_head(shape_imgs[..., None])
        det = detector_loss(logits, labels)
        _, d0 = net.raw_head(mix[..., None])
        _, d1 = net.raw_head(warped[..., None])
        desc = descriptor_loss(d0, d1, Hms, H, W)
        loss = det + self.desc_weight * desc
        loss.backward()
        self.optimizer.step()
        return torch.stack([loss, det, desc]).detach()

    def train_chunk(self, steps: int, batch_size: int = 8) -> np.ndarray:
        """``steps`` joint steps; returns the (steps, 3) [total, detector,
        descriptor] loss trace."""
        return torch.stack([self.step(self.draw_step(batch_size))
                            for _ in range(steps)]).cpu().numpy()

    # -- evaluation -------------------------------------------------------------
    def corner_metrics(self, draws: Optional[ShapeDraws] = None, n: int = 8,
                       dist_px: float = 4.0) -> dict:
        """Detector precision and recall on fresh shapes (seed 4242 unless
        ``draws`` are given) against the exact corners."""
        H, W = self.image_hw
        if draws is None:
            draws = draw_shapes(n, H, W, generator=torch.Generator(self.device).manual_seed(4242),
                                device=self.device)
        with torch.no_grad():
            imgs, corners, _ = render_shapes(draws.to(self.device), H, W)
            kp = self.sp.detect(imgs[..., None])
        coords, mask = kp.coords.cpu().numpy(), kp.mask.cpu().numpy()
        corners = corners.cpu().numpy()
        hits = n_gt = matched_det = 0
        n_det = int(mask.sum())
        for b in range(len(corners)):
            det = coords[b][mask[b]]
            gt = corners[b]
            n_gt += len(gt)
            if len(det) == 0:
                continue
            d = np.linalg.norm(gt[:, None, :] - det[None, :, :], axis=-1)
            hits += int((d.min(axis=1) <= dist_px).sum())
            matched_det += int((d.min(axis=0) <= dist_px).sum())
        return {"corner_recall": hits / max(n_gt, 1),
                "detector_precision": matched_det / max(n_det, 1),
                "n_detections": n_det, "n_gt": n_gt}

    def repeatability(self, draws=None, n: int = 8, dist_px: float = 3.0) -> float:
        """Share of keypoints of a homography-warped texture that land within
        dist_px of a projected keypoint of the original (seed 777 unless
        ``draws``, ((grids, gains), corners), are given)."""
        H, W = self.image_hw
        if draws is None:
            g = torch.Generator(self.device).manual_seed(777)
            draws = (draw_texture_noise(n, H, W, g, self.device),
                     draw_homography_jitter(n, g, self.device))
        (grids, gains), corners = draws
        with torch.no_grad():
            imgs = synthetic_textures([x.to(self.device) for x in grids], gains.to(self.device),
                                      H, W)
            Hms = random_homography(corners.to(self.device), H, W, self.max_corner_jitter)
            warped = warp_image(imgs, Hms)
            kp0 = self.sp.detect(imgs[..., None])
            kp1 = self.sp.detect(warped[..., None])
            proj = apply_homography(Hms, kp0.coords).cpu().numpy()
        c1 = kp1.coords.cpu().numpy()
        m0, m1 = kp0.mask.cpu().numpy(), kp1.mask.cpu().numpy()
        hits = total = 0
        for b in range(len(proj)):
            p = proj[b][m0[b]]
            p = p[(p[:, 0] >= 0) & (p[:, 0] <= W - 1) & (p[:, 1] >= 0) & (p[:, 1] <= H - 1)]
            q = c1[b][m1[b]]
            if len(p) == 0 or len(q) == 0:
                continue
            d = np.linalg.norm(p[:, None] - q[None, :], axis=-1)
            hits += int((d.min(axis=1) <= dist_px).sum())
            total += len(p)
        return hits / max(total, 1)

    def save_checkpoint(self, path: str) -> None:
        from mlis_tpu_torch.weights import save_params_npz, to_jax_params

        save_params_npz(path, superpoint=to_jax_params(self.sp.net.state_dict()))
