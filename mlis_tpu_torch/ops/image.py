"""Image preprocessing on the device.

Counterpart of ``mlis_tpu/ops/image.py``. Public functions keep the JAX
package's channels-last layout. Resizing is bilinear with antialiasing,
which matches ``jax.image.resize(..., method="bilinear", antialias=True)``
to float32 rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mlis_tpu_torch.utils.profiling import sync_point

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# ITU-R BT.601 luma weights in BGR channel order (cv2.cvtColor convention)
BT601_BGR = (0.114, 0.587, 0.299)


def resize_nhwc(x: torch.Tensor, size: Tuple[int, int], antialias: bool = True) -> torch.Tensor:
    """(B, H, W, C) float -> (B, h, w, C), bilinear, half-pixel centres."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
        align_corners=False, antialias=antialias,
    )
    return y.permute(0, 2, 3, 1)


def preprocess_imagenet(
    images: torch.Tensor,  # (B, H, W, 3) / (B, H, W, 1) / (B, H, W) uint8 or float
    size: Tuple[int, int],
    bgr: bool = True,
    antialias: bool = True,
) -> torch.Tensor:
    """uint8 (BGR/RGB/mono) -> resized, ImageNet-normalised float32 (B, h, w, 3).

    Mono input is replicated to 3 channels on the device (GRAY2RGB)."""
    x = images.to(torch.float32) / 255.0
    if x.dim() == 3:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], 3)
    elif bgr:
        x = x.flip(-1)
    x = resize_nhwc(x, size, antialias)
    with sync_point("upload_norm"):
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    with sync_point("upload_norm"):
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def to_grayscale(
    images: torch.Tensor, size: Optional[Tuple[int, int]] = None, bgr: bool = True
) -> torch.Tensor:
    """uint8 colour or mono -> float32 grayscale in [0, 1], (B, H, W, 1),
    optionally resized (BT.601 weights)."""
    x = images.to(torch.float32) / 255.0
    if x.dim() == 3:
        x = x[..., None] if x.shape[-1] not in (1, 3) else x[None]
    if x.shape[-1] == 3:
        with sync_point("upload_luma"):
            w = torch.tensor(BT601_BGR, dtype=torch.float32, device=x.device)
        if not bgr:
            w = w.flip(0)
        x = (x * w).sum(-1, keepdim=True)
    if size is not None:
        x = resize_nhwc(x, size)
    return x
