"""VPR fine-tuning demonstration: contrastive training reduces cross-floor
perceptual aliasing.

Counterpart of ``mlis_tpu/train/vpr_finetune_demo.py``. An image-level
analogue of the planar-aliasing testbed:

  * two floors share the same set of plan-position textures (a repeated
    floor layout) — a random-init encoder retrieves cross-floor aliases
    because appearance is dominated by the shared texture;
  * each floor carries a SUBTLE floor-specific appearance cue (amplitude
    ``floor_cue`` — think signage, lighting, carpet color) that an
    untrained encoder under-weights;
  * supervised NT-Xent over (floor, place) labels makes cross-floor
    same-plan views NEGATIVES, so training teaches the encoder to amplify
    the floor cue: cross-floor false-retrieval falls and same-floor recall
    rises.

The images are drawn with the render functions of
:mod:`mlis_tpu_torch.train.matcher_trainer` from a ``torch.Generator``
seeded with ``seed`` (other draws than ``jax.random``'s for the same seed),
or from raw draws passed in (:func:`aliasing_draws` says which).

Run: python -m mlis_tpu_torch.train.vpr_finetune_demo
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mlis_tpu_torch.models.vit import resample_weights
from mlis_tpu_torch.train.matcher_trainer import (
    draw_texture_noise,
    random_homography,
    synthetic_textures,
    uniform_range,
    warp_image,
)


def aliasing_draws(n_places: int, n_views: int, hw: Tuple[int, int],
                   generator: Optional[torch.Generator] = None, device="cuda") -> Dict:
    """The raw draws of :func:`make_aliasing_images`, all U[0, 1) but the
    gains: texture grids and N(0, 1) gains (:func:`draw_texture_noise`),
    the (2, 4, 6) floor-cue grid, (N, 4, 2) homography corners and (N,)
    brightness offsets, N = 2 * n_places * n_views."""
    H, W = hw
    N = 2 * n_places * n_views
    grids, gains = draw_texture_noise(n_places, H, W, generator, device)
    return {
        "grids": grids,
        "gains": gains,
        "cue": torch.rand((2, 4, 6), generator=generator, device=device),
        "corners": torch.rand((N, 4, 2), generator=generator, device=device),
        "bright": torch.rand((N,), generator=generator, device=device),
    }


def make_aliasing_images(
    n_places: int = 8,
    n_views: int = 4,
    hw: Tuple[int, int] = (64, 96),
    floor_cue: float = 0.12,
    corner_jitter: float = 0.06,
    seed: int = 0,
    draws: Optional[Dict] = None,
    device="cuda",
):
    """(N, H, W, 3) float images, place_ids (floor-specific), floors, as
    numpy arrays.

    N = 2 floors * n_places * n_views. Cross-floor pairs at the same plan
    position share their base texture; each floor adds a low-frequency cue
    pattern at small amplitude."""
    H, W = hw
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        draws = aliasing_draws(n_places, n_views, hw, gen, device)
    dev = draws["gains"].device
    textures = synthetic_textures(draws["grids"], draws["gains"], H, W)
    # per-floor cue: smooth random pattern (4x6 noise upsampled linearly)
    cue = uniform_range(draws["cue"], -1.0, 1.0)
    wh = torch.as_tensor(resample_weights(4, H, "linear"), dtype=torch.float32, device=dev)
    ww = torch.as_tensor(resample_weights(6, W, "linear"), dtype=torch.float32, device=dev)
    cues = torch.einsum("hi,fij,wj->fhw", wh, cue, ww)
    bright = uniform_range(draws["bright"], -0.05, 0.05)
    Hm = random_homography(draws["corners"], H, W, corner_jitter)

    fi = torch.arange(2, device=dev).repeat_interleave(n_places * n_views)
    p = torch.arange(n_places, device=dev).repeat_interleave(n_views).repeat(2)
    base = textures[p] + floor_cue * cues[fi]
    obs = (warp_image(base, Hm) + bright[:, None, None]).clamp(0.0, 1.0)
    images = obs[..., None].expand(-1, -1, -1, 3)  # mono -> rgb
    place_ids = (fi * n_places + p).cpu().numpy().astype(np.int32)
    floors = np.where(fi.cpu().numpy() == 0, 5, 2).astype(np.int32)
    return images.cpu().numpy().astype(np.float32), place_ids, floors


def retrieval_metrics(
    desc: np.ndarray, place_ids: np.ndarray, floors: np.ndarray, k: int = 5
) -> Dict[str, float]:
    """cross_floor_false_rate: fraction of top-k hits from the other
    floor; same_floor_recall: queries with >= 1 same-place same-floor
    co-view in top-k."""
    d = desc / (np.linalg.norm(desc, axis=1, keepdims=True) + 1e-8)
    sims = d @ d.T
    np.fill_diagonal(sims, -np.inf)
    topk = np.argsort(-sims, axis=1)[:, :k]
    cross = floors[topk] != floors[:, None]
    same_place = place_ids[topk] == place_ids[:, None]
    return {
        "cross_floor_false_rate": float(cross.mean()),
        "same_floor_recall": float(same_place.any(axis=1).mean()),
    }


def run_demo(
    steps: int = 150,
    n_places: int = 8,
    n_views: int = 4,
    hw: Tuple[int, int] = (64, 96),
    floor_cue: float = 0.12,
    learning_rate: float = 3e-4,
    seed: int = 0,
    n_data: int = -1,
    device="cuda",
) -> Dict:
    """Train a tiny ViT encoder with supervised NT-Xent on the aliasing
    set; return before/after retrieval metrics. The ViT runs the plain
    attention (the kernels are forward-only) and starts from flax's
    initialisers drawn from ``torch.Generator().manual_seed(seed)``."""
    from mlis_tpu_torch.models.vit import ViT, ViTConfig
    from mlis_tpu_torch.train.trainer import GeMEncoder, VPRTrainer

    images, place_ids, floors = make_aliasing_images(
        n_places=n_places, n_views=n_views, hw=hw, floor_cue=floor_cue, seed=seed,
        device=device,
    )
    cfg = ViTConfig(dim=64, depth=2, num_heads=2, pos_grid=8, patch_size=8)
    vit = ViT(cfg, use_kernel=False).init_random_(torch.Generator().manual_seed(int(seed)))
    encoder = GeMEncoder(vit).to(device)
    x = torch.as_tensor(images, device=device)

    def encode(module) -> np.ndarray:
        with torch.no_grad():
            return module(x).cpu().numpy()

    before = retrieval_metrics(encode(encoder), place_ids, floors)
    trainer = VPRTrainer(encoder, learning_rate=learning_rate, n_data=n_data, device=device)
    losses = [trainer.train_batch(images, place_ids) for _ in range(steps)]
    after = retrieval_metrics(encode(trainer.encoder), place_ids, floors)
    return {
        "steps": steps,
        "n_images": int(len(images)),
        "floor_cue": floor_cue,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "before": before,
        "after": after,
    }


if __name__ == "__main__":
    print(json.dumps(run_demo(), indent=2))
