"""Shared scaffolding for the VPR encoders.

Counterpart of ``mlis_tpu/models/base.py``: an encoder is an ``nn.Module``
with an ``input_size``; ``encode_batch_device`` preprocesses uint8 images on
the device and returns device-resident descriptors, and the encoder plugs
into the :class:`BasePlaceRecognition` database API.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mlis_tpu_torch.gating.place_recognition import BasePlaceRecognition
from mlis_tpu_torch.ops.image import preprocess_imagenet


class TorchEncoderVPR(BasePlaceRecognition):
    """VPR database whose encoder is ``self.module`` (an ``nn.Module`` taking
    (B, 3, H, W) ImageNet-normalised float32 and returning (B, D))."""

    input_size: Tuple[int, int] = (224, 224)

    def __init__(self, descriptor_dim: int, device="cuda"):
        super().__init__(descriptor_dim=descriptor_dim, encoder=self, device=device)
        self.module: torch.nn.Module = None  # set by the subclass

    def load_state(self, state_dict) -> None:
        """Load ``self.module``'s weights (strict) onto the encoder's device."""
        self.module.load_state_dict(state_dict, strict=True)
        self.module.to(self.device)

    def load_torch_state_dict(self, state_dict) -> None:
        """Replace the backbone's weights with a converted official torch
        checkpoint (the encoders with a converter override this)."""
        raise NotImplementedError(f"{type(self).__name__} has no converter")

    def _load_converted(self, module: torch.nn.Module, convert, state_dict) -> None:
        """``module``'s weights from an official state dict through one of
        ``models/convert.py``'s converters, the template taken from
        ``module`` itself."""
        from mlis_tpu_torch.weights import from_jax_params, to_jax_params

        tree = convert(state_dict, to_jax_params(module.state_dict()))
        module.load_state_dict(from_jax_params(tree, scan_prefixes=()), strict=True)
        module.to(self.device)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return fit_descriptor_dim(self.module(x), self.descriptor_dim)

    @torch.no_grad()
    def encode_batch_device(self, images) -> torch.Tensor:
        """uint8 (B, H, W[, C]) -> device-resident float32 (B, D)."""
        imgs = torch.as_tensor(images, device=self.device)
        x = preprocess_imagenet(imgs, self.input_size)
        return self._forward(x.permute(0, 3, 1, 2).contiguous())

    def encode_batch(self, images) -> np.ndarray:
        return self.encode_batch_device(images).cpu().numpy().astype(np.float32)


def fit_descriptor_dim(desc: torch.Tensor, dim: int) -> torch.Tensor:
    """Truncate or zero-pad (B, D') to (B, dim)."""
    d = desc.shape[-1]
    if d == dim:
        return desc
    if d > dim:
        return desc[..., :dim]
    return F.pad(desc, (0, dim - d))
