"""The trained tiny VPR encoder of the decision-quality harness.

Counterpart of ``load_encoder`` in ``mlis_tpu/train/pretrain_vpr.py`` for
``arch="tiny"``: a ViT (``ViTConfig.tiny_test(patch_size=8)``: 64 wide, 2
blocks, bf16) whose flax weights ship as ``checkpoints/vpr_tiny_v2.npz``
(trained on parallax views) or ``vpr_tiny.npz`` (homography views). Frames
are averaged to grey, resized to 64x96 (bilinear with antialiasing, as
``jax.image.resize(method="linear")``), replicated to three channels; the
descriptor is GeM (p = 3) over the patch tokens, L2-normalised.

Like the reference, which builds this ViT with ``use_pallas=False``, every
block runs the plain attention (``use_kernel=False``) on any device. The
trainers and the other architectures (SALAD, AnyLoc, MixVPR,
CricaVPR) are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import torch

from mlis_tpu_torch.models.vit import ViT, ViTConfig
from mlis_tpu_torch.ops.image import resize_nhwc
from mlis_tpu_torch.ops.pooling import gem_pool
from mlis_tpu_torch.weights import REPO_ROOT, load_npz

# encoder input resolution: keyframes are resized to it inside the apply fn
ENC_HW = (64, 96)
DEFAULT_CKPT = "checkpoints/vpr_tiny.npz"


def _build_model(seed: int = 0, arch: str = "tiny", device="cuda") -> ViT:
    """The tiny ViT with plain attention, initialised from ``seed`` without
    touching the global RNG's state."""
    if arch != "tiny":
        raise ValueError(
            f"encoder arch {arch!r} is not ported to mlis_tpu_torch yet "
            "(ROADMAP Queue 1, the other VPR encoders); available: tiny")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ViT(ViTConfig.tiny_test(patch_size=8), use_kernel=False)
    return model.to(device).eval()


def _make_apply(model: ViT, enc_hw=ENC_HW) -> Callable[[torch.Tensor], torch.Tensor]:
    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W) float [0, 1] mono -> (B, D) L2-normalised."""
        xr = resize_nhwc(x[..., None], tuple(enc_hw), antialias=True)
        rgb = xr.expand(*xr.shape[:-1], 3)
        d = gem_pool(model(rgb)["patches"], p=3.0)
        return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)

    return apply_fn


def load_encoder(path: Optional[str] = None, seed: int = 0, arch: str = "tiny",
                 device="cuda") -> Optional[Callable]:
    """The trained encoder as a function (B, H, W) | (B, H, W, C) uint8 or
    float -> (B, D) float32 on ``device``, or None when the checkpoint is
    not there. ``path`` defaults to ``checkpoints/vpr_tiny.npz``; a relative
    path that does not exist resolves against the repository root."""
    root = Path(REPO_ROOT)
    p = Path(path) if path else root / DEFAULT_CKPT
    if not p.exists() and path and not Path(path).is_absolute():
        p = root / path
    if not p.exists():
        return None
    model = _build_model(seed, arch=arch, device=device)
    model.load_state_dict(load_npz(str(p))["vpr"], strict=True)
    model.to(device)
    apply_fn = _make_apply(model)

    @torch.no_grad()
    def encode(imgs) -> torch.Tensor:
        x = torch.as_tensor(imgs, device=device).to(torch.float32)
        if x.dim() == 4:
            x = x.mean(-1)
        return apply_fn(x / 255.0)

    return encode
