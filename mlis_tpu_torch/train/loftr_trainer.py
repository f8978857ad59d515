"""Homography and layered-scene self-supervision of the in-env LoFTR.

Counterpart of ``mlis_tpu/train/loftr_trainer.py``: the lite LoFTR
(``models/loftr.LoFTRNet``) trained end to end on procedural pairs drawn
on the device, as the shipped ``loftr_*.npz`` were:

* a random homography warps a texture (or a layered SE(3) pair is
  rendered), which gives an exact dense ground truth;
* coarse supervision: every 1/8-grid cell of image 0 whose centre projects
  into image 1 (through its own layer's homography, where that layer is on
  top, in parallax mode) has a target cell, and the loss is that target's
  NLL under the dual-softmax distribution of ``coarse_match``;
* fine supervision: where the true point lies within the fine window's
  reach of the target cell's centre, ``fine_refine`` started from the
  target cell must land on it (L2 in pixels), the only gradient path into
  the backbone's 1/2-resolution features.

Draws come from a ``torch.Generator`` (or are passed in as tensors, see
``train/matcher_trainer.py``). The official architecture is inference-only
and is refused, as the JAX package refuses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from mlis_tpu_torch.models.loftr import LoFTR, fine_refine
from mlis_tpu_torch.train.matcher_trainer import (
    LayeredPairDraws,
    _in_image,
    _layer_at,
    apply_homography,
    draw_homography_jitter,
    draw_layered_pair,
    draw_textures,
    project_by_layer,
    random_homography,
    render_layered_pair,
    warp_image,
)
from mlis_tpu_torch.train.optim import ClippedAdam


def _cell_centers(hc: int, wc: int, device, step: float = 8.0, offset: float = 3.5):
    """(hc * wc, 2) xy centres of the grid's cells, row-major."""
    cy, cx = torch.meshgrid(torch.arange(hc, device=device), torch.arange(wc, device=device),
                            indexing="ij")
    return torch.stack([cx.reshape(-1) * step + offset, cy.reshape(-1) * step + offset], -1)


def _target_cells(proj: torch.Tensor, hc: int, wc: int, image_hw):
    """(flat target cell, in-bounds) of projected cell centres."""
    H, W = image_hw
    tx = torch.round((proj[..., 0] - 3.5) / 8.0).to(torch.int64)
    ty = torch.round((proj[..., 1] - 3.5) / 8.0).to(torch.int64)
    inb = (_in_image(proj, H, W) & (tx >= 0) & (tx < wc) & (ty >= 0) & (ty < hc))
    return ty.clamp(0, hc - 1) * wc + tx.clamp(0, wc - 1), inb


def coarse_gt_cells(Hm: torch.Tensor, hc: int, wc: int, image_hw: Tuple[int, int]):
    """Ground-truth coarse assignment of (..., 3, 3) homographies: image 0's
    cell centres (8 cx + 3.5) projected into image 1. Returns idx1 (..., N)
    the target flat cell, valid (..., N) the centre lands inside image 1,
    target (..., N, 2) the projected pixel (the fine supervision)."""
    centers = _cell_centers(hc, wc, Hm.device)
    proj = apply_homography(Hm, centers)
    idx1, inb = _target_cells(proj, hc, wc, image_hw)
    return idx1, inb, proj


def coarse_gt_cells_parallax(lid0: torch.Tensor, lid1: torch.Tensor, Hs: torch.Tensor, hc: int,
                             wc: int, image_hw: Tuple[int, int]):
    """Dense coarse GT of layered pairs (B, H, W), (B, L, 3, 3): each cell
    centre projects through its own layer's homography and is supervisable
    only where that layer is on top at the projection. Returns as
    :func:`coarse_gt_cells`."""
    B = lid0.shape[0]
    centers = _cell_centers(hc, wc, lid0.device).expand(B, -1, -1)
    layer = _layer_at(lid0, centers)
    proj = project_by_layer(Hs, layer, centers)
    idx1, inb = _target_cells(proj, hc, wc, image_hw)
    visible = _layer_at(lid1, proj) == layer
    return idx1, inb & visible, proj


def loftr_loss(t0, t1, f0, f1, idx1, valid, target_px, grid_hw: Tuple[int, int],
               temperature: float, fine_window: int, fine_weight: float = 0.25):
    """(loss, n_gt): the coarse dual-softmax NLL of the GT cells plus
    fine_weight x the fine L2 (pixels) where the GT point is reachable."""
    hc, wc = grid_hw
    n0 = t0 / (torch.linalg.vector_norm(t0.to(torch.float32), dim=-1, keepdim=True) + 1e-8)
    n1 = t1 / (torch.linalg.vector_norm(t1.to(torch.float32), dim=-1, keepdim=True) + 1e-8)
    sim = torch.einsum("bnd,bmd->bnm", n0.to(torch.float32), n1.to(torch.float32)) / temperature
    logp = F.log_softmax(sim, dim=2) + F.log_softmax(sim, dim=1)
    gt_logp = logp.gather(2, idx1[..., None])[..., 0]
    n_gt = valid.sum().clamp_min(1)
    coarse = -(gt_logp * valid).sum() / n_gt

    # fine refinement from the TARGET cell's centre (teacher forcing): the
    # soft-argmax must recover the projected point
    tx = (idx1 % wc).to(torch.float32)
    ty = torch.div(idx1, wc, rounding_mode="floor").to(torch.float32)
    fine_xy1 = torch.stack([tx * 4 + 1.5, ty * 4 + 1.5], -1)
    fine_xy0 = _cell_centers(hc, wc, f0.device, 4.0, 1.5).expand_as(fine_xy1)
    b = torch.arange(f0.shape[0], device=f0.device)[:, None]
    feat0 = f0.to(torch.float32)[b, fine_xy0[..., 1].long(), fine_xy0[..., 0].long()]
    pred_px = fine_refine(f1, fine_xy1, feat0, fine_window, 2) * 2.0 + 0.5
    reach = 2.0 * (fine_window // 2)
    cell_center = torch.stack([tx * 8 + 3.5, ty * 8 + 3.5], -1)
    reachable = valid & ((target_px - cell_center).abs() <= reach).all(-1)
    err2 = ((pred_px - target_px) ** 2).sum(-1)
    fine = (err2 * reachable).sum() / reachable.sum().clamp_min(1)
    return coarse + fine_weight * fine, n_gt


class LoFTRTrainer:
    """End-to-end self-supervision of a lite LoFTR (``optimizer``: a
    :class:`ClippedAdam` over ``matcher.net``; by default clip 1.0 and Adam
    at ``learning_rate``). Draws come from
    ``torch.Generator(device).manual_seed(seed)``."""

    def __init__(self, matcher: LoFTR, image_hw: Tuple[int, int], learning_rate=1e-4,
                 max_corner_jitter: float = 0.15, fine_weight: float = 0.25, seed: int = 0,
                 optimizer: Optional[ClippedAdam] = None, pair_mode: str = "homography"):
        H, W = int(image_hw[0]), int(image_hw[1])
        if H % 8 or W % 8:
            raise ValueError("LoFTR training size must be a multiple of 8")
        if matcher.cfg.official:
            raise ValueError(
                "official-architecture LoFTR is inference-only (its net returns "
                "DenseMatches, not feature maps); train the lite LoFTRNet "
                "(LoFTRConfig(official=False)) instead")
        if pair_mode not in ("homography", "parallax"):
            raise ValueError(f"pair_mode must be 'homography' or 'parallax', got {pair_mode!r}")
        self.matcher = matcher
        self.device = matcher.device
        self.image_hw = (H, W)
        self.pair_mode = pair_mode
        self.max_corner_jitter = float(max_corner_jitter)
        self.fine_weight = float(fine_weight)
        self.optimizer = optimizer or ClippedAdam(matcher.net.parameters(), learning_rate)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def draw_step(self, batch_size: int):
        """One step's draws: corner draws (B, 4, 2), or LayeredPairDraws."""
        H, W = self.image_hw
        if self.pair_mode == "parallax":
            return draw_layered_pair(batch_size, H, W, generator=self.generator,
                                     device=self.device)
        return draw_homography_jitter(batch_size, self.generator, self.device)

    def step(self, images: Optional[torch.Tensor], draws) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on (B, H, W) images (unused in parallax mode) and the
        step's draws; returns (loss, n_gt) as device scalars."""
        H, W = self.image_hw
        cfg = self.matcher.cfg
        with torch.no_grad(), record_function("train.pairs"):
            if self.pair_mode == "parallax":
                img0, warped, lid0, lid1, Hs = render_layered_pair(draws, H, W)
            else:
                Hms = random_homography(draws, H, W, self.max_corner_jitter)
                img0, warped = images, warp_image(images, Hms)
        self.optimizer.zero_grad()
        with record_function("train.forward"):
            t0, t1, f0, f1, (hc, wc) = self.matcher.net(img0[..., None], warped[..., None])
            with torch.no_grad():
                if self.pair_mode == "parallax":
                    idx1, valid, target = coarse_gt_cells_parallax(lid0, lid1, Hs, hc, wc,
                                                                   (H, W))
                else:
                    idx1, valid, target = coarse_gt_cells(Hms, hc, wc, (H, W))
            loss, n_gt = loftr_loss(t0, t1, f0, f1, idx1, valid, target, (hc, wc),
                                    cfg.temperature, cfg.fine_window, self.fine_weight)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.update"):
            self.optimizer.step()
        return loss.detach(), n_gt

    def train_batch(self, images, draws=None) -> Tuple[float, int]:
        images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        if draws is None:
            draws = self.draw_step(images.shape[0])
        loss, n_gt = self.step(images, draws)
        return float(loss), int(n_gt)

    def train_chunk(self, steps: int, batch_size: int = 4) -> np.ndarray:
        """``steps`` updates on textures drawn on the device; returns the
        (steps,) loss trace."""
        H, W = self.image_hw
        losses = []
        for _ in range(steps):
            images = (None if self.pair_mode == "parallax"
                      else draw_textures(batch_size, H, W, self.generator, self.device))
            losses.append(self.step(images, self.draw_step(batch_size))[0])
        return torch.stack(losses).cpu().numpy()

    def save_checkpoint(self, path: str) -> None:
        self.matcher.save_weights(path)

    @staticmethod
    def _summary(correct, predicted, n_vis) -> dict:
        c, p, v = (int(x) for x in torch.stack([correct.sum(), predicted.sum(), n_vis]).tolist())
        return {"precision": c / max(p, 1), "recall": c / max(v, 1), "n_pred": p, "n_gt": v}

    def parallax_match_metrics(self, n_pairs: int = 8, draws: Optional[LayeredPairDraws] = None,
                               threshold_px: float = 4.0) -> dict:
        """Held-out metrics through the full inference path on layered SE(3)
        pairs (seed 991 unless ``draws`` are given): a prediction is
        correct within threshold_px of the point projected through its own
        layer's homography, where that layer is on top."""
        H, W = self.image_hw
        if draws is None:
            draws = draw_layered_pair(n_pairs, H, W, device=self.device,
                                      generator=torch.Generator(self.device).manual_seed(991))
        with torch.no_grad():
            img0, img1, lid0, lid1, Hs = render_layered_pair(draws.to(self.device), H, W)
            m = self.matcher.match_batch(img0[..., None], img1[..., None])
            layer = _layer_at(lid0, m.kpts0)
            proj = project_by_layer(Hs, layer, m.kpts0)
            vis = _in_image(proj, H, W) & (_layer_at(lid1, proj) == layer)
            err = torch.linalg.vector_norm(m.kpts1 - proj, dim=-1)
            correct = m.valid & vis & (err <= threshold_px)
            _, gt_vis, _ = coarse_gt_cells_parallax(lid0, lid1, Hs, H // 8, W // 8, (H, W))
            return self._summary(correct, m.valid & vis, gt_vis.sum())

    def match_metrics(self, images, draws=None, threshold_px: float = 4.0) -> dict:
        """Held-out metrics through the full inference path (coarse dual
        softmax, mutual top-M, fine refinement): precision = predictions
        within threshold_px of the GT projection, recall = correct
        predictions / visible coarse cells; homographies of ``images``
        (corner draws from seed 999 unless given), or in parallax mode
        len(images) layered pairs."""
        if self.pair_mode == "parallax":
            return self.parallax_match_metrics(int(len(images)), draws, threshold_px)
        H, W = self.image_hw
        imgs = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        if draws is None:
            draws = draw_homography_jitter(imgs.shape[0], device=self.device,
                                           generator=torch.Generator(self.device).manual_seed(999))
        with torch.no_grad():
            Hms = random_homography(draws.to(self.device), H, W, self.max_corner_jitter)
            m = self.matcher.match_batch(imgs[..., None], warp_image(imgs, Hms)[..., None])
            proj = apply_homography(Hms, m.kpts0)
            inb = _in_image(proj, H, W)
            err = torch.linalg.vector_norm(m.kpts1 - proj, dim=-1)
            correct = m.valid & inb & (err <= threshold_px)
            _, vis, _ = coarse_gt_cells(Hms, H // 8, W // 8, (H, W))
            return self._summary(correct, m.valid & inb, vis.sum())
