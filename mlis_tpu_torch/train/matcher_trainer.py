"""Procedural images and homography warps, on the device.

Counterpart of the rendering functions of ``mlis_tpu/train/matcher_trainer.py``
(``random_homography``, ``apply_homography``, ``warp_image``,
``synthetic_textures``); the trainer itself is not ported yet. The JAX
functions draw from a key; here each function takes its raw draws as
tensors, so the same draws give the same images on any device, and a
``draw_*`` helper makes them from a ``torch.Generator``:

* ``synthetic_textures``: one U[0, 1) block-noise grid per scale (8, 16,
  32, 64 pixels) and N(0, 1) gains of the illumination ramp;
* ``random_homography``: U[0, 1) corner draws, scaled to the jitter range
  as ``jax.random.uniform(minval, maxval)`` scales its own.

Everything computes in float32. Functions accept one image or a batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

TEXTURE_SCALES = (8, 16, 32, 64)


def uniform_range(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """U[0, 1) draws -> U[minval, maxval), as jax.random.uniform maps them:
    max(minval, u * (maxval - minval) + minval) in float32."""
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def draw_homography_jitter(n: int, generator: Optional[torch.Generator] = None,
                           device="cuda") -> torch.Tensor:
    """(n, 4, 2) U[0, 1) corner draws for :func:`random_homography`."""
    return torch.rand((n, 4, 2), generator=generator, device=device)


def random_homography(u: torch.Tensor, H: int, W: int,
                      max_corner_jitter: float = 0.15) -> torch.Tensor:
    """(..., 4, 2) U[0, 1) corner draws -> (..., 3, 3) perspective warps: the
    four corners jitter by up to max_corner_jitter x the image size and
    the 8-DoF DLT is solved exactly."""
    dev = u.device
    src = torch.tensor([[0.0, 0.0], [W - 1, 0.0], [W - 1, H - 1], [0.0, H - 1]],
                       dtype=torch.float32, device=dev)
    jit = uniform_range(u, -max_corner_jitter, max_corner_jitter) * torch.tensor(
        [W, H], dtype=torch.float32, device=dev)
    dst = src + jit
    x, y = src[:, 0].expand_as(dst[..., 0]), src[:, 1].expand_as(dst[..., 0])
    uu, vv = dst[..., 0], dst[..., 1]
    one, zero = torch.ones_like(uu), torch.zeros_like(uu)
    r0 = torch.stack([x, y, one, zero, zero, zero, -uu * x, -uu * y], -1)
    r1 = torch.stack([zero, zero, zero, x, y, one, -vv * x, -vv * y], -1)
    A = torch.stack([r0, r1], -2).reshape(*u.shape[:-2], 8, 8)
    b = torch.stack([uu, vv], -1).reshape(*u.shape[:-2], 8)
    h = torch.linalg.solve(A, b)
    return torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(*u.shape[:-2], 3, 3)


def apply_homography(Hm: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., K, 2) xy points through (..., 3, 3) homographies."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    q = p @ Hm.transpose(-1, -2)
    return q[..., :2] / (q[..., 2:3] + 1e-9)


def warp_image(img: torch.Tensor, Hm: torch.Tensor) -> torch.Tensor:
    """(..., H, W) images warped by (..., 3, 3) homographies: output pixel p
    samples the source bilinearly at H^-1 p. Pixels whose source falls
    outside the image are zero (no border replication, which would paint
    streaked texture there)."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    flat = img.reshape(-1, H * W)
    Hinv = torch.linalg.inv(Hm).reshape(-1, 3, 3)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device),
                            indexing="ij")
    grid = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)  # (HW, 2) xy
    src = apply_homography(Hinv[:, None], grid[None, :, None, :])[:, :, 0]  # (B, HW, 2)
    sx_raw, sy_raw = src[..., 0], src[..., 1]
    in_view = (sx_raw >= 0.0) & (sx_raw <= W - 1) & (sy_raw >= 0.0) & (sy_raw <= H - 1)
    sx = sx_raw.clamp(0.0, W - 1.001)
    sy = sy_raw.clamp(0.0, H - 1.001)
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    fx = sx - x0
    fy = sy - y0

    def at(yi, xi):
        return flat.gather(1, yi * W + xi)

    out = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
           + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)
    return torch.where(in_view, out, torch.zeros_like(out)).reshape(*lead, H, W)


def draw_texture_noise(n: int, H: int, W: int, generator: Optional[torch.Generator] = None,
                       device="cuda") -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Raw draws of :func:`synthetic_textures`: the U[0, 1) grids
    (n, H // s + 1, W // s + 1) per scale s, then the (n, 2) N(0, 1) gains."""
    grids = [torch.rand((n, H // s + 1, W // s + 1), generator=generator, device=device)
             for s in TEXTURE_SCALES]
    gains = torch.randn((n, 2), generator=generator, device=device)
    return grids, gains


def synthetic_textures(grids: Sequence[torch.Tensor], gains: torch.Tensor,
                       H: int, W: int) -> torch.Tensor:
    """(n, H, W) float [0, 1] procedural images: multi-scale block noise
    (hard edges and corners at several frequencies, what SuperPoint
    responds to) plus a low-frequency illumination ramp of gains x 0.15."""
    img = torch.zeros((gains.shape[0], H, W), dtype=torch.float32, device=gains.device)
    total = 0.0
    for i, (s, g) in enumerate(zip(TEXTURE_SCALES, grids)):
        up = g.repeat_interleave(s, 1).repeat_interleave(s, 2)[:, :H, :W]
        w = 0.55**i
        img = img + w * up
        total += w
    img = img / total
    gk = gains * 0.15
    yy = torch.linspace(-1, 1, H, device=gains.device)[None, :, None]
    xx = torch.linspace(-1, 1, W, device=gains.device)[None, None, :]
    ramp = gk[:, 0, None, None] * yy + gk[:, 1, None, None] * xx
    return (img + ramp).clamp(0.0, 1.0)
