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

The trainers are not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import torch

from mlis_tpu_torch.models.mixvpr import MixVPRModule
from mlis_tpu_torch.models.vit import ViT, ViTConfig
from mlis_tpu_torch.ops.image import preprocess_imagenet, resize_nhwc
from mlis_tpu_torch.ops.pooling import gem_pool, vlad_aggregate
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

