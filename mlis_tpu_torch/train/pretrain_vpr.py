"""The trained VPR encoders of the decision-quality harness.

Counterpart of the loaders in ``mlis_tpu/train/pretrain_vpr.py``:

* ``load_encoder(path, seed, arch)``: a function (B, H, W[, C]) uint8 or
  float -> (B, D) float32 on ``device`` for each arch the reference trains,
  or None when its checkpoint is not there:
  - "tiny" (``vpr_tiny.npz``, or ``vpr_tiny_v2.npz`` by path): a ViT
    (``ViTConfig.tiny_test(patch_size=8)``: 64 wide, 2 blocks, bf16) at
    64x96, GeM (p = 3) over the patch tokens, L2-normalised;
  - "salad" (``vpr_salad.npz``): the SALAD head (16 clusters x 32 + 64) on
    a small ViT (128 wide, 4 blocks, 4 heads, patch 8) at 64x96;
  - "anyloc" (``vpr_anyloc.npz``): the tiny ViT's patch tokens at 64x96,
    VLAD over the checkpoint's ``vlad/centers`` vocabulary;
  - "mixvpr" (``vpr_mixvpr.npz``): ResNet-50 + mixer at 320x320, ImageNet
    preprocessing;
  - "cricavpr" (``vpr_crica.npz``): the ViT-B/14 at 322x322, ImageNet
    preprocessing, GeM.
  Without ImageNet preprocessing frames are averaged to grey, resized
  bilinearly with antialiasing (as ``jax.image.resize(method="linear")``)
  and replicated to three channels. Like the reference, which builds these
  encoders with ``use_pallas=False``, every attention runs the plain
  version (``use_kernel=False``) on any device;
* ``load_mixvpr_vpr``, ``load_crica_vpr`` and ``load_crica_tiny_vpr``:
  the encoder classes with the shipped weights (CricaVPR's ViTs run the
  attention kernels, as the reference's ``use_pallas=None`` does).

The training stream, as in the reference: ``_sample_batch`` (homography
views of fresh textures) and ``_sample_batch_parallax`` (layered SE(3)
views with occluders) take their raw draws as tensors
(:class:`BatchDraws`, :class:`ParallaxBatchDraws`, made by ``draw_*``
helpers from a ``torch.Generator``); ``make_train_chunk`` runs NT-Xent
steps with gradients clipped at a global norm of 1 and AdamW
(``train/optim.py``); ``heldout_recall`` scores recall@1 on sibling views;
``fit_anyloc`` fits AnyLoc's VLAD vocabulary by k-means on the trained
tiny encoder's patch features; ``main`` drives every arch.

Run: python -m mlis_tpu_torch.train.pretrain_vpr --parallax
     python -m mlis_tpu_torch.train.pretrain_vpr --tiny --device cpu --out /tmp/vpr.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mlis_tpu_torch.models.mixvpr import MixVPRModule
from mlis_tpu_torch.models.vit import ViT, ViTConfig
from mlis_tpu_torch.ops.image import preprocess_imagenet, resize_nhwc
from mlis_tpu_torch.ops.pooling import gem_pool, vlad_aggregate
from mlis_tpu_torch.train.matcher_trainer import (
    Draws,
    _blob_mask,
    draw_homography_jitter,
    draw_texture_noise,
    layered_homographies,
    random_homography,
    synthetic_textures,
    uniform_range,
    warp_image,
)
from mlis_tpu_torch.weights import REPO_ROOT, load_npz

# encoder input resolution: keyframes are resized to it inside the apply fn
ENC_HW = (64, 96)
DEFAULT_CKPT = "checkpoints/vpr_tiny.npz"
CRICA_CKPT = "checkpoints/vpr_crica.npz"
MIXVPR_CKPT = "checkpoints/vpr_mixvpr.npz"
SALAD_CKPT = "checkpoints/vpr_salad.npz"
ANYLOC_CKPT = "checkpoints/vpr_anyloc.npz"
TINY_V2_CKPT = "checkpoints/vpr_tiny_v2.npz"
MIXVPR_HW = (320, 320)  # MixVPR's input
CRICA_HW = (322, 322)  # CricaVPR's input: a 23x23 patch grid
ARCHS = ("tiny", "salad", "anyloc", "mixvpr", "cricavpr")
ARCH_HW = {"cricavpr": CRICA_HW, "mixvpr": MIXVPR_HW}


def small_salad_vit() -> ViTConfig:
    """The trained SALAD's backbone: 128 wide, 4 blocks, 4 heads, patch 8."""
    return ViTConfig(dim=128, depth=4, num_heads=4, patch_size=8, pos_grid=12)


def _build_model(seed: int = 0, arch: str = "tiny", device="cuda") -> torch.nn.Module:
    """The arch's module, drawn from ``torch.Generator().manual_seed(seed)``
    with flax's default distributions; the global RNG is left as it was."""
    if arch not in ARCHS:
        raise ValueError(f"unknown encoder arch {arch!r}; available: {', '.join(ARCHS)}")
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        if arch == "mixvpr":
            from mlis_tpu_torch.models.layers import flax_init_
            from mlis_tpu_torch.models.resnet import ResNetConfig

            cfg = ResNetConfig(crop_stage=3)
            stride = 4 * 2 ** (cfg.crop_stage - 1)
            hw = (MIXVPR_HW[0] // stride) * (MIXVPR_HW[1] // stride)
            model = flax_init_(MixVPRModule(cfg, hw), gen)
        elif arch == "salad":
            from mlis_tpu_torch.models.salad import SALADModule

            model = SALADModule(small_salad_vit(), num_clusters=16, cluster_dim=32, token_dim=64,
                                use_kernel=False).init_random_(gen)
        else:  # tiny, anyloc's backbone, cricavpr
            cfg = ViTConfig.dinov2_vitb14() if arch == "cricavpr" else ViTConfig.tiny_test(
                patch_size=8)
            model = ViT(cfg, use_kernel=False).init_random_(gen)
    return model.to(device).eval()


def _make_apply(model: torch.nn.Module, enc_hw=ENC_HW, imagenet: bool = False,
                pooling: str = "gem") -> Callable[[torch.Tensor], torch.Tensor]:
    """x: (B, H, W) float in [0, 1], mono -> (B, D), L2-normalised.
    ``pooling="module"``: the module returns the descriptor itself
    (MixVPR, SALAD); "gem": GeM over the ViT's patch tokens."""

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        if imagenet:
            rgb = preprocess_imagenet(x * 255.0, tuple(enc_hw))
        else:
            xr = resize_nhwc(x[..., None], tuple(enc_hw), antialias=True)
            rgb = xr.expand(*xr.shape[:-1], 3)
        if pooling == "module":
            # MixVPR's ResNet takes NCHW images, SALAD's ViT NHWC
            return model(rgb.permute(0, 3, 1, 2) if isinstance(model, MixVPRModule) else rgb)
        d = gem_pool(model(rgb)["patches"], p=3.0)
        return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)

    return apply_fn


def _anyloc_apply(model: ViT, centers: torch.Tensor,
                  enc_hw=ENC_HW) -> Callable[[torch.Tensor], torch.Tensor]:
    """AnyLoc's descriptor: the trained backbone's patch tokens, VLAD over
    the fitted vocabulary."""

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        xr = resize_nhwc(x[..., None], tuple(enc_hw), antialias=True)
        out = model(xr.expand(*xr.shape[:-1], 3))
        return vlad_aggregate(out["patches"].to(torch.float32), centers)

    return apply_fn


def _resolve(path: Optional[str], default: str) -> Optional[Path]:
    """The checkpoint's path, or None when it is not there; a relative path
    that does not exist resolves against the repository root."""
    root = Path(REPO_ROOT)
    p = Path(path) if path else root / default
    if not p.exists() and path and not Path(path).is_absolute():
        p = root / path
    return p if p.exists() else None


def load_encoder(path: Optional[str] = None, seed: int = 0, arch: str = "tiny",
                 device="cuda") -> Optional[Callable]:
    """The trained encoder of ``arch`` as a function (B, H, W) | (B, H, W,
    C) uint8 or float -> (B, D) float32 on ``device``, or None when the
    checkpoint is not there. ``path`` defaults to the arch's checkpoint
    (``checkpoints/vpr_tiny.npz`` for "tiny")."""
    if arch not in ARCHS:
        raise ValueError(f"unknown encoder arch {arch!r}; available: {', '.join(ARCHS)}")
    default = {"cricavpr": CRICA_CKPT, "salad": SALAD_CKPT, "anyloc": ANYLOC_CKPT,
               "mixvpr": MIXVPR_CKPT}.get(arch, DEFAULT_CKPT)
    p = _resolve(path, default)
    if p is None:
        return None
    groups = load_npz(str(p))
    # AnyLoc's backbone is the parallax-trained tiny ViT
    model = _build_model(seed, arch="tiny" if arch == "anyloc" else arch, device=device)
    model.load_state_dict(groups["vpr"], strict=True)
    if arch == "anyloc":
        apply_fn = _anyloc_apply(model, groups["vlad"]["centers"].to(device))
    else:
        apply_fn = _make_apply(model, ARCH_HW.get(arch, ENC_HW),
                               imagenet=arch in ("cricavpr", "mixvpr"),
                               pooling="module" if arch in ("mixvpr", "salad") else "gem")

    @torch.no_grad()
    def encode(imgs) -> torch.Tensor:
        x = torch.as_tensor(imgs, device=device).to(torch.float32)
        if x.dim() == 4:
            x = x.mean(-1)
        return apply_fn(x / 255.0)

    return encode


def load_mixvpr_vpr(path: Optional[str] = None, seed: int = 0, device="cuda", **kw):
    """``models/mixvpr.MixVPR`` with the trained ``vpr_mixvpr.npz``, or None
    when it is not there."""
    from mlis_tpu_torch.models.mixvpr import MixVPR

    p = _resolve(path, MIXVPR_CKPT)
    return None if p is None else MixVPR(checkpoint=str(p), device=device, **kw)


def load_crica_vpr(path: Optional[str] = None, seed: int = 0, device="cuda", **crica_kw):
    """``models/cricavpr.CricaVPR`` whose ViT-B/14 carries ``vpr_crica.npz``
    (descriptors and the patch-correlation rerank both on trained
    features), or None when it is not there."""
    from mlis_tpu_torch.models.cricavpr import CricaVPR

    p = _resolve(path, CRICA_CKPT)
    return None if p is None else CricaVPR(checkpoint=str(p), device=device, **crica_kw)


def load_crica_tiny_vpr(path: Optional[str] = None, seed: int = 0, device="cuda",
                        **crica_kw):
    """The CricaVPR rerank over the parallax-trained tiny encoder
    (``vpr_tiny_v2.npz``): 64x96 grey input, GeM + L2 as the trainer's
    descriptor, plus the patch cache and correlation rerank. None when the
    checkpoint is not there."""
    from mlis_tpu_torch.models.cricavpr import CricaVPR

    p = _resolve(path, TINY_V2_CKPT)
    if p is None:
        return None
    return CricaVPR(descriptor_dim=64, vit_cfg=ViTConfig.tiny_test(patch_size=8),
                    input_size=ENC_HW, imagenet_preproc=False, checkpoint=str(p), device=device,
                    **crica_kw)



# -- the training stream -------------------------------------------------------------

def _train_bn_statistics(model: torch.nn.Module) -> torch.nn.Module:
    """Make every frozen batch norm's four tensors parameters. The JAX
    ResNet keeps scale, bias, mean and var in its ``params`` tree, so the
    reference's optimiser trains all four; the port's FrozenBatchNorm
    holds them as buffers, which an optimiser would skip."""
    from mlis_tpu_torch.models.layers import FrozenBatchNorm

    for m in model.modules():
        if isinstance(m, FrozenBatchNorm):
            for name in ("weight", "bias", "running_mean", "running_var"):
                m.register_parameter(name, torch.nn.Parameter(m._buffers.pop(name)))
    return model


@dataclasses.dataclass
class BatchDraws(Draws):
    """Raw draws of :func:`_sample_batch`: P textures, B = P x V views."""

    tex_grids: List[torch.Tensor]  # per scale (P, H // s + 1, W // s + 1) U[0, 1)
    tex_gains: torch.Tensor  # (P, 2) N(0, 1)
    corners: torch.Tensor  # (B, 4, 2) U[0, 1)
    bright: torch.Tensor  # (B,) U[0, 1)


def draw_batch(n_places: int, views: int, hw: Tuple[int, int],
               generator: Optional[torch.Generator] = None, device="cuda") -> BatchDraws:
    B = n_places * views
    grids, gains = draw_texture_noise(n_places, hw[0], hw[1], generator, device)
    return BatchDraws(grids, gains, draw_homography_jitter(B, generator, device),
                      torch.rand((B,), generator=generator, device=device))


def _sample_batch(draws: BatchDraws, n_places: int, views: int, hw: Tuple[int, int],
                  corner_jitter: float, brightness: float):
    """(P x V, H, W) warped, brightness-jittered views of P fresh textures
    and their place ids."""
    H, W = hw
    tex = synthetic_textures(draws.tex_grids, draws.tex_gains, H, W)
    place = torch.arange(n_places, device=tex.device).repeat_interleave(views)
    Hms = random_homography(draws.corners, H, W, corner_jitter)
    bright = uniform_range(draws.bright, -brightness, brightness)
    imgs = warp_image(tex[place], Hms)
    return (imgs + bright[:, None, None]).clamp(0.0, 1.0), place


@dataclasses.dataclass
class ParallaxBatchDraws(Draws):
    """Raw draws of :func:`_sample_batch_parallax` (P places of L layers,
    B = P x V views), all U[0, 1) but the texture gains, N(0, 1)."""

    tex_grids: List[torch.Tensor]  # per scale (P * L, ...)
    tex_gains: torch.Tensor  # (P * L, 2)
    mask_noise: torch.Tensor  # (P, L - 1, H // 40 + 2, W // 40 + 2)
    angles: torch.Tensor  # (B, 3)
    trans: torch.Tensor  # (B, 3)
    bright: torch.Tensor  # (B,)
    occ_apply: torch.Tensor  # (B,): an occluder where < occluder_prob
    occ_noise: torch.Tensor  # (B, H // 64 + 2, W // 64 + 2)
    occ_grids: List[torch.Tensor]  # the 4 occluder textures
    occ_gains: torch.Tensor


def draw_batch_parallax(n_places: int, views: int, hw: Tuple[int, int], n_layers: int = 3,
                        generator: Optional[torch.Generator] = None,
                        device="cuda") -> ParallaxBatchDraws:
    H, W = hw
    P, L, B = n_places, n_layers, n_places * views

    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    grids, gains = draw_texture_noise(P * L, H, W, generator, device)
    mask_noise = u(P, L - 1, H // 40 + 2, W // 40 + 2)
    angles, trans, bright, occ_apply = u(B, 3), u(B, 3), u(B), u(B)
    occ_noise = u(B, H // 64 + 2, W // 64 + 2)
    occ_grids, occ_gains = draw_texture_noise(4, H, W, generator, device)
    return ParallaxBatchDraws(grids, gains, mask_noise, angles, trans, bright, occ_apply,
                              occ_noise, occ_grids, occ_gains)


def _sample_batch_parallax(draws: ParallaxBatchDraws, n_places: int, views: int,
                           hw: Tuple[int, int], brightness: float,
                           depths: Sequence[float] = (4.0, 7.0, 12.0),
                           layer_coverage: Sequence[float] = (0.22, 0.40),
                           max_rot_deg: float = 5.0, max_trans: float = 0.45,
                           max_trans_z: float = 1.2, occluder_frac: float = 0.20,
                           occluder_prob: float = 0.4):
    """(P x V, H, W) views of P layered piecewise-planar places, each view
    from a random SE(3) pose (parallax, occlusion edges, scale change) with
    an occluder on a share of them, and their place ids: the v2 GT scene's
    corruption family."""
    H, W = hw
    P, V, L = n_places, views, len(depths)
    B = P * V
    dev = draws.angles.device
    tex = synthetic_textures(draws.tex_grids, draws.tex_gains, H, W).reshape(P, L, H, W)
    masks = torch.ones((P, L, H, W), dtype=torch.float32, device=dev)
    for l in range(L - 1):
        masks[:, l] = _blob_mask(draws.mask_noise[:, l], H, W, layer_coverage[l])
    place = torch.arange(P, device=dev).repeat_interleave(V)
    Hs = layered_homographies(draws.angles, draws.trans, H, W, depths, max_rot_deg, max_trans,
                              max_trans_z)
    out = torch.zeros((B, H, W), dtype=torch.float32, device=dev)
    for l in range(L - 1, -1, -1):
        img_l = warp_image(tex[place, l], Hs[:, l])
        m_l = warp_image(masks[place, l], Hs[:, l])
        out = torch.where(m_l > 0.5, img_l, out)
    occ_tex = synthetic_textures(draws.occ_grids, draws.occ_gains, H, W)
    om = _blob_mask(draws.occ_noise, H, W, occluder_frac, block=64)
    occluded = (draws.occ_apply < occluder_prob)[:, None, None] & (om > 0.5)
    out = torch.where(occluded, occ_tex[torch.arange(B, device=dev) % 4], out)
    bright = uniform_range(draws.bright, -brightness, brightness)
    return (out + bright[:, None, None]).clamp(0.0, 1.0), place


def sample_training_batch(n_places: int, views: int, hw: Tuple[int, int], corner_jitter: float,
                          brightness: float, parallax: bool, generator: torch.Generator,
                          device="cuda", draws=None):
    """One batch of the training stream, drawn from ``generator`` unless
    ``draws`` are given."""
    if parallax:
        draws = draws if draws is not None else draw_batch_parallax(
            n_places, views, hw, generator=generator, device=device)
        return _sample_batch_parallax(draws, n_places, views, hw, brightness)
    draws = draws if draws is not None else draw_batch(n_places, views, hw, generator, device)
    return _sample_batch(draws, n_places, views, hw, corner_jitter, brightness)


def make_train_chunk(apply_fn: Callable, optimizer, n_places: int, views: int,
                     hw: Tuple[int, int], corner_jitter: float, brightness: float,
                     parallax: bool = False, device="cuda") -> Callable:
    """chunk(n, generator, draws=None) -> (n,) losses: n NT-Xent steps of
    ``optimizer`` (a :class:`~mlis_tpu_torch.train.optim.ClippedAdam` over
    the module behind ``apply_fn``) on fresh batches; ``draws``, a list of
    n batches' draws, replaces the generator's."""
    from mlis_tpu_torch.train.trainer import nt_xent_loss

    def step(generator, draws=None) -> torch.Tensor:
        with torch.no_grad():
            imgs, place = sample_training_batch(n_places, views, hw, corner_jitter, brightness,
                                                parallax, generator, device, draws)
        optimizer.zero_grad()
        loss = nt_xent_loss(apply_fn(imgs), place)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def chunk(n: int, generator: torch.Generator, draws=None) -> np.ndarray:
        losses = [step(generator, None if draws is None else draws[i]) for i in range(n)]
        return torch.stack(losses).cpu().numpy()

    return chunk


@torch.no_grad()
def heldout_recall(apply_fn: Callable, n_places: int = 32, hw: Tuple[int, int] = (270, 360),
                   corner_jitter: float = 0.08, seed: int = 0, parallax: bool = False,
                   device="cuda", draws=None) -> float:
    """recall@1 over two views of each of n_places unseen places: a query
    scores when its nearest neighbour is its sibling view. Drawn from seed
    77,000 + seed, disjoint from the training stream, unless ``draws`` are
    given. ``apply_fn`` closes over its module (no parameter argument)."""
    g = torch.Generator(device).manual_seed(77_000 + seed)
    imgs, place = sample_training_batch(n_places, 2, hw, corner_jitter, 0.08, parallax, g,
                                        device, draws)
    d = apply_fn(imgs).to(torch.float32).cpu().numpy()
    sims = d @ d.T
    np.fill_diagonal(sims, -np.inf)
    nn1 = np.argmax(sims, axis=1)
    place = place.cpu().numpy()
    return float((place[nn1] == place).mean())


def _vpr_tree(model: torch.nn.Module) -> dict:
    """The module's parameters as the JAX package's ``vpr`` tree (flax
    layout under ``params``)."""
    from mlis_tpu_torch.weights import to_jax_params

    return {"params": to_jax_params(model.state_dict())}


def kmeans_step(centers: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """One Lloyd step: each feature to its nearest centre (first index on
    ties); an empty cluster keeps its centre."""
    d2 = (f ** 2).sum(1, keepdim=True) - 2 * f @ centers.T + (centers ** 2).sum(1)
    a = torch.nn.functional.one_hot(d2.argmin(1), centers.shape[0]).to(f.dtype)
    sums = a.T @ f
    counts = a.sum(0)[:, None]
    return torch.where(counts > 0, sums / counts.clamp_min(1), centers)


def fit_anyloc(args, sample_draws=None, init_indices=None, heldout_draws=None) -> dict:
    """AnyLoc's vocabulary: no gradient stage, a VLAD vocabulary fitted by
    k-means on the patch features of the parallax-trained tiny encoder
    (``--init-from``, default vpr_tiny_v2.npz) over fresh parallax views,
    scored with the held-out recall@1 of the gradient archs. The feature
    batches are drawn from seed 2,000,000 + seed and the initial centres
    chosen without replacement from seed (``torch.randperm``) unless
    ``sample_draws`` (a list of ParallaxBatchDraws) and ``init_indices``
    are given."""
    from mlis_tpu_torch.weights import save_params_npz

    dev = torch.device(args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    log_path = out.with_name(out.stem + "_log.json")
    init = args.init_from or TINY_V2_CKPT
    model = _build_model(args.seed, arch="tiny", device=dev)
    model.load_state_dict(load_npz(str(_resolve(init, TINY_V2_CKPT) or init))["vpr"],
                          strict=True)
    hw = (args.height, args.width)

    @torch.no_grad()
    def patch_feats(x):  # (B, h, w) [0, 1] -> (B * N, D)
        xr = resize_nhwc(x[..., None], ENC_HW, antialias=True)
        p = model(xr.expand(*xr.shape[:-1], 3))["patches"].to(torch.float32)
        return p.reshape(-1, p.shape[-1])

    t0 = time.time()
    g = torch.Generator(dev).manual_seed(2_000_000 + args.seed)
    n_batches = max(args.steps // 4, 2)
    feats = []
    for i in range(n_batches):
        with torch.no_grad():
            imgs, _ = sample_training_batch(args.places, args.views, hw, args.corner_jitter,
                                            args.brightness, True, g, dev,
                                            None if sample_draws is None else sample_draws[i])
        feats.append(patch_feats(imgs))
    feats = torch.cat(feats)
    print(f"vocabulary sample: {feats.shape[0]} patch features", flush=True)

    K = args.clusters
    if init_indices is None:
        init_indices = torch.randperm(feats.shape[0], generator=torch.Generator().manual_seed(
            args.seed))[:K]
    centers = feats[torch.as_tensor(np.array(init_indices), device=dev).long()]
    for _ in range(25):
        centers = kmeans_step(centers, feats)

    r = heldout_recall(_anyloc_apply(model, centers), hw=hw, seed=args.seed, parallax=True,
                       device=dev, draws=heldout_draws)
    wall = time.time() - t0
    print(f"anyloc VLAD (K={K}) heldout parallax recall@1: {r:.4f} in {wall:.0f}s", flush=True)
    save_params_npz(str(out), vpr=_vpr_tree(model), vlad={"centers": centers.cpu().numpy()})
    config = {k: v for k, v in vars(args).items()}
    history = {"config": config, "backbone": init, "best_recall_at_1": r, "wall_s": wall}
    log_path.write_text(json.dumps(history))
    return history


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--places", type=int, default=16)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--width", type=int, default=360)
    ap.add_argument("--corner-jitter", type=float, default=0.08)
    ap.add_argument("--brightness", type=float, default=0.08)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--arch", choices=ARCHS, default="tiny",
                    help="'cricavpr' = ViT-B/14 at 322x322 + GeM; 'mixvpr' = ResNet-50 + "
                    "feature mixer at 320x320; 'salad' = the Sinkhorn-OT head on a small "
                    "ViT; 'anyloc' = no gradient stage, the VLAD vocabulary fitted on the "
                    "trained tiny encoder's parallax patch features (--init-from)")
    ap.add_argument("--clusters", type=int, default=32, help="anyloc VLAD vocabulary size")
    ap.add_argument("--parallax", action="store_true",
                    help="train on layered-scene SE(3) parallax views instead of single "
                    "homographies")
    ap.add_argument("--init-from", help="warm-start the encoder from an npz of the same arch")
    ap.add_argument("--tiny", action="store_true",
                    help="few steps and small textures (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.steps, args.chunk = 30, 10
        args.height, args.width = 96, 128
        args.places, args.views = 6, 3
    if args.arch in ("cricavpr", "mixvpr") and args.places == 16 and not args.tiny:
        args.places = 8  # batch 32: full-size backbones at 320^2
    if args.out is None:
        args.out = {"cricavpr": CRICA_CKPT, "mixvpr": MIXVPR_CKPT, "salad": SALAD_CKPT,
                    "anyloc": ANYLOC_CKPT}.get(args.arch, DEFAULT_CKPT)
    if args.arch == "anyloc":
        return fit_anyloc(args)

    from mlis_tpu_torch.train.optim import ClippedAdam, warmup_cosine_decay_schedule
    from mlis_tpu_torch.weights import save_params_npz

    dev = torch.device(args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    log_path = out.with_name(out.stem + "_log.json")

    model = _train_bn_statistics(_build_model(args.seed, arch=args.arch, device=dev))
    if args.init_from:
        model.load_state_dict(load_npz(args.init_from)["vpr"], strict=True)
        model.to(dev)
        print(f"warm-started from {args.init_from}", flush=True)
    apply_fn = _make_apply(model, ARCH_HW.get(args.arch, ENC_HW),
                           imagenet=args.arch in ("cricavpr", "mixvpr"),
                           pooling="module" if args.arch in ("mixvpr", "salad") else "gem")
    hw = (args.height, args.width)
    schedule = warmup_cosine_decay_schedule(0.0, args.peak_lr, max(args.steps // 10, 1),
                                            args.steps, end_value=1e-6)
    optimizer = ClippedAdam(model.parameters(), schedule, weight_decay=1e-4)  # optax.adamw's
    chunk_fn = make_train_chunk(apply_fn, optimizer, args.places, args.views, hw,
                                args.corner_jitter, args.brightness, parallax=args.parallax,
                                device=dev)

    def recall() -> float:
        return heldout_recall(apply_fn, hw=hw, corner_jitter=args.corner_jitter, seed=args.seed,
                              parallax=args.parallax, device=dev)

    history = {"config": dict(vars(args)), "loss": [], "eval": []}
    r0 = recall()
    history["eval"].append((0, r0))
    print(f"step 0: heldout recall@1={r0:.4f}", flush=True)
    best, saved = r0, False

    g = torch.Generator(dev).manual_seed(1_000_000 + args.seed)
    done = 0
    t0 = time.time()
    next_eval = args.eval_every
    while done < args.steps:
        n = min(args.chunk, args.steps - done)
        losses = chunk_fn(n, g)
        done += n
        history["loss"].append((done, float(losses.mean())))
        rate = done / (time.time() - t0)
        print(f"step {done}/{args.steps}: loss={losses.mean():.4f} {rate:.2f} steps/s",
              flush=True)
        if done >= next_eval or done >= args.steps:
            next_eval += args.eval_every
            r = recall()
            history["eval"].append((done, r))
            print(f"  eval@{done}: heldout recall@1={r:.4f}", flush=True)
            if r > best or not saved:
                best = max(best, r)
                save_params_npz(str(out), vpr=_vpr_tree(model))
                saved = True
                print(f"  saved best checkpoint (recall@1 {best:.4f})", flush=True)
        log_path.write_text(json.dumps(history))

    history["best_recall_at_1"] = best
    history["wall_s"] = time.time() - t0
    log_path.write_text(json.dumps(history))
    print(f"done: best heldout recall@1 {best:.4f} in {history['wall_s']:.0f}s", flush=True)
    return history


if __name__ == "__main__":
    main()
