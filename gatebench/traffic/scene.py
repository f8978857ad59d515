"""The benchmark's frozen copy of the v2 ground-truth scene generator.

Copied from ``mlis_tpu_torch/eval/quality.py`` (``draw_quality_scene_v2``,
``render_quality_scene_v2``) and the helpers it takes from
``mlis_tpu_torch/train/matcher_trainer.py``, changed only so that it
stands alone: it imports nothing of the program, so a later change of the
port's generator does not move this yardstick.

Each place is ``len(depths)`` fronto-parallel textured layers (the near
ones behind blob masks, the farthest a full wall). The first pass sees
them from the canonical pose, the second from a random pose: real
parallax, occlusion edges and scale change, every layer warped by its own
plane-induced homography. A near occluder hides part of some revisits.
Floor 0 sees each place's texture family; floor k > 0 blends the family
with its own texture at the place's alias strength (1.0, 0.85, 0.7 in
turn), so cross-floor look-alikes come at three similarities.

A scene holds ``floors x places x 2`` mono8 keyframes, each floor's as
[pass 1 places 0..P-1, pass 2 places 0..P-1], ``frame_dt`` seconds apart.
Every random number is drawn from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

TEXTURE_SCALES = (8, 16, 32, 64)
QUANTILE_CHUNK = 64  # masks thresholded at once (torch.quantile caps its input at 2^24)
RENDER_CHUNK = 32  # frames warped at once
FLOOR_LABELS = (5, 2, 4, 1, 6, 7, 8, 9)
DEPTHS = (4.0, 7.0, 12.0)
LAYER_COVERAGE = (0.22, 0.40, 1.0)
ALIAS_STRENGTHS = (1.0, 0.85, 0.7)
MAX_ROT_DEG = 5.0
MAX_TRANS = 0.45
MAX_TRANS_Z = 1.2
OCCLUDER_FRAC = 0.20
OCCLUDER_PROB = 0.6
BRIGHTNESS_JITTER = 0.10


@dataclass
class Scene:
    images: np.ndarray  # (N, H, W) uint8
    timestamps: np.ndarray  # (N,) float64 seconds
    floors: np.ndarray  # (N,) int64 floor labels
    K: np.ndarray  # (3, 3) float32 intrinsics


def intrinsics(H: int, W: int) -> np.ndarray:
    f = 200.0 * (W / 360.0)
    return np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)


def uniform_range(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def apply_homography(Hm: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    q = p @ Hm.transpose(-1, -2)
    return q[..., :2] / (q[..., 2:3] + 1e-9)


def warp_image(img: torch.Tensor, Hm: torch.Tensor) -> torch.Tensor:
    """(..., H, W) images warped by (..., 3, 3) homographies, bilinear, zero
    outside the source."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    flat = img.reshape(-1, H * W)
    Hinv = torch.linalg.inv(Hm).reshape(-1, 3, 3)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device),
                            indexing="ij")
    grid = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
    src = apply_homography(Hinv[:, None], grid[None, :, None, :])[:, :, 0]
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


def draw_texture_noise(n: int, H: int, W: int, g: torch.Generator, device):
    grids = [torch.rand((n, H // s + 1, W // s + 1), generator=g, device=device)
             for s in TEXTURE_SCALES]
    gains = torch.randn((n, 2), generator=g, device=device)
    return grids, gains


def synthetic_textures(grids: Sequence[torch.Tensor], gains: torch.Tensor,
                       H: int, W: int) -> torch.Tensor:
    """(n, H, W) multi-scale block noise plus an illumination ramp, in [0, 1]."""
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


def rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Rz(yaw) @ Ry(pitch) @ Rx(roll) from (..., 3) radians."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat((one, zero, zero), (zero, c[..., 0], -s[..., 0]), (zero, s[..., 0], c[..., 0]))
    Ry = mat((c[..., 1], zero, s[..., 1]), (zero, one, zero), (-s[..., 1], zero, c[..., 1]))
    Rz = mat((c[..., 2], -s[..., 2], zero), (s[..., 2], c[..., 2], zero), (zero, zero, one))
    return Rz @ Ry @ Rx


def plane_homography(K, Kinv, R, t, depth: float) -> torch.Tensor:
    n = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=R.device)
    return K @ (R + t[..., :, None] * n / depth) @ Kinv


def blob_mask(u: torch.Tensor, H: int, W: int, coverage: float, block: int = 40) -> torch.Tensor:
    """Block noise thresholded at its 1 - coverage quantile -> (..., H, W) masks."""
    lead = u.shape[:-2]
    g = u.reshape(-1, *u.shape[-2:])
    up = g.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :H, :W].reshape(g.shape[0], -1)
    thr = torch.cat([torch.quantile(up[s : s + QUANTILE_CHUNK], 1.0 - coverage, dim=1,
                                    interpolation="linear")
                     for s in range(0, up.shape[0], QUANTILE_CHUNK)])
    return (up >= thr[:, None]).to(torch.float32).reshape(*lead, H, W)


def render_scene(n_floors: int, n_places: int, hw: Tuple[int, int], g: torch.Generator,
                 device, frame_dt: float) -> Scene:
    """Draw one scene's random numbers from ``g`` and render it on ``device``."""
    H, W = hw
    P, F, L = n_places, n_floors, len(DEPTHS)
    N = F * 2 * P
    # the draws, in the port's order
    fam_grids, fam_gains = draw_texture_noise(P * L, H, W, g, device)
    uni_grids, uni_gains = draw_texture_noise(F * P * L, H, W, g, device)
    mask_noise = torch.rand((P, L - 1, H // 40 + 2, W // 40 + 2), generator=g, device=device)
    u_angles = torch.rand((N, 3), generator=g, device=device)
    u_trans = torch.rand((N, 3), generator=g, device=device)
    u_occ = torch.rand((N,), generator=g, device=device)
    occ_noise = torch.rand((N, H // 64 + 2, W // 64 + 2), generator=g, device=device)
    u_bright = torch.rand((N,), generator=g, device=device)
    occ_grids, occ_gains = draw_texture_noise(8, H, W, g, device)

    fam = synthetic_textures(fam_grids, fam_gains, H, W).reshape(P, L, H, W)
    uni = synthetic_textures(uni_grids, uni_gains, H, W).reshape(F, P, L, H, W)
    alpha = torch.tensor([ALIAS_STRENGTHS[p % len(ALIAS_STRENGTHS)] for p in range(P)],
                         dtype=torch.float32, device=device)
    masks = torch.ones((P, L, H, W), dtype=torch.float32, device=device)
    for layer in range(L - 1):
        masks[:, layer] = blob_mask(mask_noise[:, layer], H, W, LAYER_COVERAGE[layer])
    K = torch.tensor(intrinsics(H, W), dtype=torch.float32, device=device)
    Kinv = torch.linalg.inv(K)

    frame = np.arange(N)
    fi_arr, pass_arr, p_arr = frame // (2 * P), (frame // P) % 2, frame % P
    p2 = torch.as_tensor((pass_arr == 1).astype(np.float32), device=device)
    rot = float(np.deg2rad(np.float32(MAX_ROT_DEG)))
    angles = uniform_range(u_angles, -rot, rot) * p2[:, None]
    ts = (uniform_range(u_trans, -1.0, 1.0)
          * torch.tensor([MAX_TRANS, MAX_TRANS, MAX_TRANS_Z], dtype=torch.float32, device=device)
          * p2[:, None])
    Rs = rotation_matrix(angles)
    occ_apply = ((u_occ < OCCLUDER_PROB) & (p2 > 0)).to(torch.float32)
    occ_masks = blob_mask(occ_noise, H, W, OCCLUDER_FRAC, block=64) * occ_apply[:, None, None]
    occ_tex = synthetic_textures(occ_grids, occ_gains, H, W)
    bright = uniform_range(u_bright, -BRIGHTNESS_JITTER, BRIGHTNESS_JITTER)

    frames: List[torch.Tensor] = []
    for s in range(0, N, RENDER_CHUNK):
        sl = slice(s, min(s + RENDER_CHUNK, N))
        fi = torch.as_tensor(fi_arr[sl], device=device)
        pi = torch.as_tensor(p_arr[sl], device=device)
        a = alpha[pi][:, None, None, None]
        tex = torch.where((fi == 0)[:, None, None, None], fam[pi], a * fam[pi] + (1 - a) * uni[fi, pi])
        out = torch.zeros((len(fi), H, W), dtype=torch.float32, device=device)
        for layer in range(L - 1, -1, -1):
            Hm = plane_homography(K, Kinv, Rs[sl], ts[sl], DEPTHS[layer])
            img_l = warp_image(tex[:, layer], Hm)
            m_l = warp_image(masks[pi, layer], Hm)
            out = torch.where(m_l > 0.5, img_l, out)
        occ_t = occ_tex[torch.as_tensor(frame[sl] % occ_tex.shape[0], device=device)]
        out = torch.where(occ_masks[sl] > 0.5, occ_t, out)
        out = (out + bright[sl, None, None]).clamp(0.0, 1.0)
        frames.append((out * 255.0).to(torch.uint8))
    images = torch.cat(frames).cpu().numpy()
    return Scene(images=images, timestamps=np.arange(N) * float(frame_dt),
                 floors=np.asarray([FLOOR_LABELS[f] for f in fi_arr], np.int64),
                 K=intrinsics(H, W))


def scene_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one draw, from the run's seed and the draw's path."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_pool(mix: dict, hw: Tuple[int, int], device) -> List[Scene]:
    """The mix's ``pool`` scenes, drawn from its ``scenes_seed`` (scene j from
    its own generator, so a scene does not depend on the pool's size). The
    set is fixed for a mix: a run's seed orders it and draws RANSAC, so
    every seed does the same work."""
    if int(mix["floors"]) > len(FLOOR_LABELS):
        raise ValueError(f"at most {len(FLOOR_LABELS)} floors, got {mix['floors']}")
    if int(mix["passes"]) != 2:
        raise ValueError("the v2 scene has two passes")
    pool = []
    for j in range(int(mix["pool"])):
        g = torch.Generator(device=device).manual_seed(scene_seed(int(mix["scenes_seed"]), 0, j))
        pool.append(render_scene(int(mix["floors"]), int(mix["places"]), hw, g, device,
                                 float(mix["frame_dt"])))
    return pool


def pool_order(n: int, seed: int) -> List[int]:
    """The order in which a run of ``seed`` cycles through a pool of ``n``."""
    return [int(i) for i in np.random.default_rng(scene_seed(seed, 4)).permutation(n)]
