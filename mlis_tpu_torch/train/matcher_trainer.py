"""Homography and layered-scene self-supervision for the matchers.

Counterpart of ``mlis_tpu/train/matcher_trainer.py``: the procedural
images and warps (``random_homography``, ``apply_homography``,
``warp_image``, ``synthetic_textures``), the layered two-view pairs
(``render_layered_pair``), the ground-truth assignments (``gt_assignment``,
``gt_assignment_parallax``), LightGlue's training loss (``matcher_loss``)
and :class:`MatcherTrainer`. The JAX functions draw from a key; here each
function takes its raw draws as tensors, so the same draws give the same
images on any device, and a ``draw_*`` helper makes them from a
``torch.Generator``:

* ``synthetic_textures``: one U[0, 1) block-noise grid per scale (8, 16,
  32, 64 pixels) and N(0, 1) gains of the illumination ramp;
* ``random_homography``: U[0, 1) corner draws, scaled to the jitter range
  as ``jax.random.uniform(minval, maxval)`` scales its own;
* ``render_layered_pair``: :class:`LayeredPairDraws`.

Everything computes in float32. Functions accept one image or a batch.
The trainer's steps are a Python loop on the device (the JAX package scans
them in one dispatch); the SuperPoint front end is frozen and detects
under ``torch.no_grad()``, the reference's ``stop_gradient``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mlis_tpu_torch.train.optim import ClippedAdam

TEXTURE_SCALES = (8, 16, 32, 64)
QUANTILE_CHUNK = 64  # masks thresholded at once (torch.quantile caps its input at 2^24)


class Draws:
    """Base of the dataclasses that hold a function's raw draws."""

    def to(self, device) -> "Draws":
        """The same draws on ``device`` (so one draw renders anywhere): every
        field a tensor, a list of tensors or nested draws."""
        def move(v):
            return [x.to(device) for x in v] if isinstance(v, list) else v.to(device)

        return type(self)(**{f.name: move(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


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


# -- layered scenes ----------------------------------------------------------------

def _rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Rz(yaw) @ Ry(pitch) @ Rx(roll) from (..., 3) (roll, pitch, yaw) radians."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])

    def mat(*rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rx = mat((one, zero, zero), (zero, c[..., 0], -s[..., 0]), (zero, s[..., 0], c[..., 0]))
    Ry = mat((c[..., 1], zero, s[..., 1]), (zero, one, zero), (-s[..., 1], zero, c[..., 1]))
    Rz = mat((c[..., 2], -s[..., 2], zero), (s[..., 2], c[..., 2], zero), (zero, zero, one))
    return Rz @ Ry @ Rx


def _plane_homography(K, Kinv, R, t, depth: float) -> torch.Tensor:
    """View-0 -> view-1 homography of the fronto-parallel plane z = depth
    under X1 = R X0 + t: H = K (R + t n^T / d) K^-1, batched over R, t."""
    n = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=R.device)
    return K @ (R + t[..., :, None] * n / depth) @ Kinv


def _blob_mask(u: torch.Tensor, H: int, W: int, coverage: float, block: int = 40) -> torch.Tensor:
    """(..., H // block + 2, W // block + 2) U[0, 1) block noise -> (..., H, W)
    binary support masks covering ~coverage of the frame: the noise is
    upsampled to blocks and thresholded at its 1 - coverage quantile
    (linear, as jnp.quantile)."""
    lead = u.shape[:-2]
    g = u.reshape(-1, *u.shape[-2:])
    up = g.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :H, :W].reshape(g.shape[0], -1)
    thr = torch.cat([torch.quantile(up[s : s + QUANTILE_CHUNK], 1.0 - coverage, dim=1,
                                    interpolation="linear")
                     for s in range(0, up.shape[0], QUANTILE_CHUNK)])
    return (up >= thr[:, None]).to(torch.float32).reshape(*lead, H, W)


def layered_homographies(angles: torch.Tensor, trans: torch.Tensor, H: int, W: int,
                         depths: Sequence[float], max_rot_deg: float = 5.0,
                         max_trans: float = 0.45, max_trans_z: float = 1.2) -> torch.Tensor:
    """(B, 3) U[0, 1) rotation and translation draws -> (B, L, 3, 3) view-0 ->
    view-1 homographies of the fronto-parallel layers at ``depths``, under
    a pose with rotation up to max_rot_deg and translation up to max_trans
    / max_trans_z metres, and the layered renderers' camera (f = 200 W / 360,
    the principal point at the centre)."""
    dev = angles.device
    f = 200.0 * (W / 360.0)
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], dtype=torch.float32, device=dev)
    Kinv = torch.linalg.inv(K)
    rot = float(torch.deg2rad(torch.tensor(max_rot_deg, dtype=torch.float32)))
    R = _rotation_matrix(uniform_range(angles, -rot, rot))
    t3 = uniform_range(trans, -1.0, 1.0) * torch.tensor(
        [max_trans, max_trans, max_trans_z], dtype=torch.float32, device=dev)
    return torch.stack([_plane_homography(K, Kinv, R, t3, d) for d in depths], 1)


# -- layered two-view pairs ---------------------------------------------------------

@dataclasses.dataclass
class LayeredPairDraws(Draws):
    """The raw draws of :func:`render_layered_pair` for B pairs of L layers."""

    tex_grids: List[torch.Tensor]  # per scale, (B, L, H // s + 1, W // s + 1) U[0, 1)
    tex_gains: torch.Tensor  # (B, L, 2) N(0, 1)
    mask_noise: torch.Tensor  # (B, L - 1, H // 40 + 2, W // 40 + 2) U[0, 1)
    angles: torch.Tensor  # (B, 3) U[0, 1) rotation draws
    trans: torch.Tensor  # (B, 3) U[0, 1) translation draws
    bright: torch.Tensor  # (B, 2) U[0, 1) brightness draws of the two views


def draw_layered_pair(n: int, H: int, W: int, n_layers: int = 3,
                      generator: Optional[torch.Generator] = None,
                      device="cuda") -> LayeredPairDraws:
    """Draws of ``n`` layered pairs from ``generator``."""
    L = n_layers
    grids, gains = draw_texture_noise(n * L, H, W, generator, device)
    grids = [g.reshape(n, L, *g.shape[1:]) for g in grids]
    mask_noise = torch.rand((n, L - 1, H // 40 + 2, W // 40 + 2), generator=generator,
                            device=device)
    angles = torch.rand((n, 3), generator=generator, device=device)
    trans = torch.rand((n, 3), generator=generator, device=device)
    bright = torch.rand((n, 2), generator=generator, device=device)
    return LayeredPairDraws(grids, gains.reshape(n, L, 2), mask_noise, angles, trans, bright)


def render_layered_pair(
    draws: LayeredPairDraws,
    H: int,
    W: int,
    depths=(4.0, 7.0, 12.0),
    layer_coverage=(0.22, 0.40),
    max_rot_deg: float = 5.0,
    max_trans: float = 0.45,
    max_trans_z: float = 1.2,
    brightness: float = 0.08,
):
    """B layered piecewise-planar places (the v2 GT scene's render model)
    seen canonically (view 0) and from a random SE(3) pose (view 1): true
    two-view geometry with parallax, occlusion and scale change, and exact
    per-pixel ground truth (each pixel's layer is known, so its
    correspondence is its layer's plane-induced homography, and it is
    visible in view 1 where the same layer is on top there).

    Returns (img0, img1 (B, H, W), layer_id0, layer_id1 (B, H, W) int32,
    Hs (B, L, 3, 3)); layer_id1 is -1 where view 1 sees no layer."""
    L = len(depths)
    B = draws.angles.shape[0]
    dev = draws.angles.device
    tex = synthetic_textures([g.reshape(B * L, *g.shape[2:]) for g in draws.tex_grids],
                             draws.tex_gains.reshape(B * L, 2), H, W).reshape(B, L, H, W)
    ones = torch.ones((B, H, W), dtype=torch.float32, device=dev)
    masks = [_blob_mask(draws.mask_noise[:, l], H, W, layer_coverage[l]) for l in range(L - 1)]
    masks.append(ones)

    Hs = layered_homographies(draws.angles, draws.trans, H, W, depths, max_rot_deg, max_trans,
                              max_trans_z)  # (B, L, 3, 3)

    img0 = torch.zeros((B, H, W), dtype=torch.float32, device=dev)
    lid0 = torch.full((B, H, W), L - 1, dtype=torch.int32, device=dev)
    img1 = torch.zeros_like(img0)
    lid1 = torch.full((B, H, W), -1, dtype=torch.int32, device=dev)
    for l in range(L - 1, -1, -1):
        on0 = masks[l] > 0.5
        img0 = torch.where(on0, tex[:, l], img0)
        lid0 = torch.where(on0, torch.full_like(lid0, l), lid0)
        on1 = warp_image(masks[l], Hs[:, l]) > 0.5
        img1 = torch.where(on1, warp_image(tex[:, l], Hs[:, l]), img1)
        lid1 = torch.where(on1, torch.full_like(lid1, l), lid1)
    b = uniform_range(draws.bright, -brightness, brightness)
    img0 = (img0 + b[:, 0, None, None]).clamp(0.0, 1.0)
    img1 = (img1 + b[:, 1, None, None]).clamp(0.0, 1.0)
    return img0, img1, lid0, lid1, Hs


# -- ground-truth assignments and the loss ------------------------------------------

def _in_image(p: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return (p[..., 0] >= 0.0) & (p[..., 0] <= W - 1) & (p[..., 1] >= 0.0) & (p[..., 1] <= H - 1)


def _mutual_nearest(proj, v0, kp1, m1, threshold_px: float) -> torch.Tensor:
    """(..., K, K) bool: row i holds True at its nearest valid kp1 when that
    one is mutual and closer than threshold_px (first index on ties)."""
    d = torch.linalg.vector_norm(proj[..., :, None, :] - kp1[..., None, :, :], dim=-1)
    d = torch.where(v0[..., :, None] & m1[..., None, :], d, torch.full_like(d, float("inf")))
    nn0 = d.argmin(-1)
    nn1 = d.argmin(-2)
    K = proj.shape[-2]
    mutual = nn1.gather(-1, nn0) == torch.arange(K, device=d.device)
    close = d.gather(-1, nn0[..., None])[..., 0] < threshold_px
    gt = torch.zeros(d.shape, dtype=torch.bool, device=d.device)
    return gt.scatter_(-1, nn0[..., None], (mutual & close)[..., None])


def gt_assignment(kp0: torch.Tensor, m0: torch.Tensor, kp1: torch.Tensor, m1: torch.Tensor,
                  Hm: torch.Tensor, threshold_px: float = 3.0,
                  image_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(..., K, K) bool ground-truth matches: kp0 (..., K, 2) projected by
    Hm (..., 3, 3) within threshold_px of kp1, mutual nearest, both valid.
    With image_hw, kp0 whose projection leaves the image are excluded."""
    proj = apply_homography(Hm, kp0)
    v0 = m0
    if image_hw is not None:
        v0 = v0 & _in_image(proj, *image_hw)
    return _mutual_nearest(proj, v0, kp1, m1, threshold_px)


def _layer_at(lid: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, H, W) per-pixel layers read at the rounded (B, K, 2) xy points."""
    H, W = lid.shape[-2:]
    xi = torch.round(pts[..., 0]).to(torch.int64).clamp(0, W - 1)
    yi = torch.round(pts[..., 1]).to(torch.int64).clamp(0, H - 1)
    return lid.reshape(lid.shape[0], -1).gather(1, yi * W + xi)


def project_by_layer(Hs: torch.Tensor, layer: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, K, 2) points each through its own layer's homography of (B, L, 3, 3)."""
    Hsel = Hs[torch.arange(Hs.shape[0], device=Hs.device)[:, None], layer.long()]
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    q = torch.einsum("bkij,bkj->bki", Hsel, p)
    return q[..., :2] / (q[..., 2:3] + 1e-9)


def gt_assignment_parallax(kp0: torch.Tensor, m0: torch.Tensor, kp1: torch.Tensor,
                           m1: torch.Tensor, lid0: torch.Tensor, lid1: torch.Tensor,
                           Hs: torch.Tensor, threshold_px: float = 3.0,
                           image_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(B, K, K) bool GT matches of layered pairs: each keypoint projects
    through its own layer's homography and counts only where that layer is
    on top (unoccluded, in view) at the projection. ``image_hw`` is
    accepted for the reference's signature; the bounds are lid0's."""
    H, W = lid0.shape[-2:]
    l0 = _layer_at(lid0, kp0)
    proj = project_by_layer(Hs, l0, kp0)
    visible = _layer_at(lid1, proj) == l0
    v0 = m0 & _in_image(proj, H, W) & visible
    return _mutual_nearest(proj, v0, kp1, m1, threshold_px)


def matcher_loss(scores: torch.Tensor, gt: torch.Tensor, m0: Optional[torch.Tensor] = None,
                 m1: Optional[torch.Tensor] = None, mp0: Optional[torch.Tensor] = None,
                 mp1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LightGlue's training loss: the NLL of the ground-truth assignment
    under the scores, plus (with matchable probabilities) a BCE pushing
    matchability down for valid keypoints with no ground-truth match."""
    eps = 1e-6
    pos = -torch.log(scores + eps) * gt
    loss = pos.sum() / gt.sum().clamp_min(1)
    if mp0 is not None:
        un0 = m0 & ~gt.any(2)
        un1 = m1 & ~gt.any(1)
        neg0 = -torch.log1p(-mp0.clamp(0.0, 1.0 - eps)) * un0
        neg1 = -torch.log1p(-mp1.clamp(0.0, 1.0 - eps)) * un1
        loss = loss + 0.5 * (neg0.sum() / un0.sum().clamp_min(1)
                             + neg1.sum() / un1.sum().clamp_min(1))
    return loss


def predicted_assignment(matches, K: int) -> torch.Tensor:
    """(B, K, K) bool: row i True at its predicted match."""
    idx = matches.idx0.clamp(0, K - 1).long()
    pred = torch.zeros((idx.shape[0], K, K), dtype=torch.bool, device=idx.device)
    return pred.scatter_(2, idx[..., None], matches.valid[..., None])


def draw_textures(n: int, H: int, W: int, generator: Optional[torch.Generator] = None,
                  device="cuda") -> torch.Tensor:
    """(n, H, W) synthetic textures drawn from ``generator``."""
    grids, gains = draw_texture_noise(n, H, W, generator, device)
    return synthetic_textures(grids, gains, H, W)


# -- the trainer ----------------------------------------------------------------------

class MatcherTrainer:
    """Homography (or layered-scene) self-supervision of a LightGlue or
    SuperGlue instance. The SuperPoint front end stays frozen; only the
    matcher trains, with ``optimizer`` (a :class:`ClippedAdam` over
    ``matcher.net``; by default clip 1.0 and Adam at ``learning_rate``).
    Draws come from ``torch.Generator(device).manual_seed(seed)``."""

    def __init__(self, matcher, image_hw: Tuple[int, int], learning_rate=1e-4,
                 threshold_px: float = 3.0, max_corner_jitter: float = 0.15, seed: int = 0,
                 optimizer: Optional[ClippedAdam] = None, pair_mode: str = "homography"):
        if pair_mode not in ("homography", "parallax"):
            raise ValueError(f"pair_mode must be 'homography' or 'parallax', got {pair_mode!r}")
        self.matcher = matcher
        self.device = matcher.device
        self.image_hw = (int(image_hw[0]), int(image_hw[1]))
        self.threshold_px = float(threshold_px)
        self.max_corner_jitter = float(max_corner_jitter)
        self.pair_mode = pair_mode
        self.optimizer = optimizer or ClippedAdam(matcher.net.parameters(), learning_rate)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    # -- one step ------------------------------------------------------------------
    def draw_step(self, batch_size: int):
        """One step's draws: corner draws (B, 4, 2), or LayeredPairDraws."""
        H, W = self.image_hw
        if self.pair_mode == "parallax":
            return draw_layered_pair(batch_size, H, W, generator=self.generator,
                                     device=self.device)
        return draw_homography_jitter(batch_size, self.generator, self.device)

    def _pairs(self, images: Optional[torch.Tensor], draws, mode: str):
        """(img0, img1, gt function of the two keypoint sets) of ``mode``'s
        pairs ("homography" or "parallax")."""
        H, W = self.image_hw
        hw, thr = self.image_hw, self.threshold_px
        if mode == "parallax":
            img0, img1, lid0, lid1, Hs = render_layered_pair(draws, H, W)
            return img0, img1, lambda k0, k1: gt_assignment_parallax(
                k0.coords, k0.mask, k1.coords, k1.mask, lid0, lid1, Hs, thr, image_hw=hw)
        Hms = random_homography(draws, H, W, self.max_corner_jitter)
        return images, warp_image(images, Hms), lambda k0, k1: gt_assignment(
            k0.coords, k0.mask, k1.coords, k1.mask, Hms, thr, image_hw=hw)

    def step(self, images: Optional[torch.Tensor], draws) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pair synthesis, frozen detection, the matcher's forward and
        backward pass and one update. ``images`` (B, H, W) are view 0 in
        homography mode (unused in parallax mode). Returns (loss, n_gt) as
        device scalars."""
        with torch.no_grad(), record_function("train.pairs"):
            img0, img1, gt_fn = self._pairs(images, draws, self.pair_mode)
            kp0 = self.matcher.sp.detect(img0[..., None])
            kp1 = self.matcher.sp.detect(img1[..., None])
            gt = gt_fn(kp0, kp1)
        self.optimizer.zero_grad()
        with record_function("train.forward"):
            scores, mp0, mp1 = self.matcher.net(
                kp0.descriptors, kp0.coords, kp0.mask, kp1.descriptors, kp1.coords, kp1.mask,
                self.image_hw, return_matchability=True)
            loss = matcher_loss(scores, gt, kp0.mask, kp1.mask, mp0, mp1)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.update"):
            self.optimizer.step()
        return loss.detach(), gt.sum()

    def train_batch(self, images, draws=None) -> Tuple[float, int]:
        """One step on a (B, H, W) float [0, 1] batch; returns (loss, number
        of GT correspondences in the batch)."""
        images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        if draws is None:
            draws = self.draw_step(images.shape[0])
        loss, n_gt = self.step(images, draws)
        return float(loss), int(n_gt)

    def train_chunk(self, steps: int, batch_size: int = 8) -> np.ndarray:
        """``steps`` steps with images drawn on the device; returns the
        (steps,) loss trace (one host synchronisation, at the end)."""
        H, W = self.image_hw
        losses = []
        for _ in range(steps):
            images = (None if self.pair_mode == "parallax"
                      else draw_textures(batch_size, H, W, self.generator, self.device))
            losses.append(self.step(images, self.draw_step(batch_size))[0])
        return torch.stack(losses).cpu().numpy()

    def save_checkpoint(self, path: str) -> None:
        """The matcher and its frozen SuperPoint as one npz."""
        self.matcher.save_weights(path)

    # -- held-out metrics -----------------------------------------------------------
    def _metrics(self, img0, img1, gt_fn) -> dict:
        with torch.no_grad():
            kp0 = self.matcher.sp.detect(img0[..., None])
            kp1 = self.matcher.sp.detect(img1[..., None])
            gt = gt_fn(kp0, kp1)
            matches = self.matcher.match_keypoints(kp0, kp1, self.image_hw)
            pred = predicted_assignment(matches, kp0.coords.shape[1])
            hits, n_gt, n_pred = (int(x) for x in torch.stack(
                [(pred & gt).sum(), gt.sum(), pred.sum()]).tolist())
        return {"recall": hits / max(n_gt, 1), "precision": hits / max(n_pred, 1),
                "n_gt": n_gt, "n_pred": n_pred}

    def match_recall(self, images, draws=None) -> float:
        return self.match_metrics(images, draws)["recall"]

    def parallax_match_metrics(self, n_pairs: int = 16,
                               draws: Optional[LayeredPairDraws] = None) -> dict:
        """Recall and precision on fresh layered SE(3) pairs (drawn from
        seed 991 unless ``draws`` are given)."""
        H, W = self.image_hw
        if draws is None:
            draws = draw_layered_pair(n_pairs, H, W, device=self.device,
                                      generator=torch.Generator(self.device).manual_seed(991))
        img0, img1, gt_fn = self._pairs(None, draws.to(self.device), "parallax")
        return self._metrics(img0, img1, gt_fn)

    def match_metrics(self, images, draws=None) -> dict:
        """Held-out recall (share of GT correspondences recovered) and
        precision (share of predicted matches that are GT) on fresh pairs
        of the training distribution: homographies of ``images`` (corner
        draws from seed 999 unless given), or in parallax mode
        len(images) layered pairs."""
        if self.pair_mode == "parallax":
            return self.parallax_match_metrics(n_pairs=int(len(images)), draws=draws)
        H, W = self.image_hw
        imgs = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        if draws is None:
            draws = draw_homography_jitter(imgs.shape[0], device=self.device,
                                           generator=torch.Generator(self.device).manual_seed(999))
        img0, img1, gt_fn = self._pairs(imgs, draws.to(self.device), "homography")
        return self._metrics(img0, img1, gt_fn)
