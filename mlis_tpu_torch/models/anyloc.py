"""AnyLoc: DINOv2 patch features + hard-assignment VLAD.

Counterpart of ``mlis_tpu/models/anyloc.py``: a ViT at 518x518 (a 37x37
patch grid, 1370 tokens, so every block's attention runs the flash kernel
on the card), VLAD over a (K, D) vocabulary (``ops/pooling.vlad_aggregate``)
or, with ``aggregation="gap"``, the L2-normalised patch mean. Like the JAX
class it starts from a random initialisation: the ViT is drawn from
``torch.Generator().manual_seed(seed)`` with flax's default distributions
and the vocabulary, a standard normal, from the generator at ``seed + 1``
(the reference draws it from ``PRNGKey(seed + 1)``).
``fit_vocabulary`` runs k-means steps over a sample's patch features.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mlis_tpu_torch.models.base import TorchEncoderVPR, fit_descriptor_dim
from mlis_tpu_torch.models.vit import ViT, ViTConfig
from mlis_tpu_torch.ops.image import preprocess_imagenet
from mlis_tpu_torch.ops.pooling import nearest_center, vlad_aggregate


def kmeans_step(centers: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """One Lloyd step: (K, D) centres, (M, D) features -> new centres; an
    empty cluster keeps its centre."""
    a = torch.nn.functional.one_hot(nearest_center(feats, centers),
                                    centers.shape[0]).to(feats.dtype)
    sums = a.T @ feats
    counts = a.sum(0)[:, None]
    return torch.where(counts > 0, sums / counts.clamp_min(1), centers)


class AnyLoc(TorchEncoderVPR):
    input_size = (518, 518)  # 37x37 patch grid (DINOv2's native)

    def __init__(
        self,
        descriptor_dim: Optional[int] = None,
        seed: int = 0,
        num_clusters: int = 64,
        vit_cfg: Optional[ViTConfig] = None,
        aggregation: str = "vlad",  # "vlad" | "gap"
        input_size=None,
        device="cuda",
        **_ignored,
    ):
        cfg = vit_cfg or ViTConfig.dinov2_vitb14()
        if aggregation not in ("vlad", "gap"):
            raise ValueError(f"aggregation must be 'vlad' or 'gap', got {aggregation!r}")
        dim = descriptor_dim or (num_clusters * cfg.dim if aggregation == "vlad" else cfg.dim)
        super().__init__(descriptor_dim=dim, device=device)
        if input_size is not None:
            self.input_size = tuple(input_size)
        self.aggregation = aggregation
        self.num_clusters = num_clusters
        with torch.random.fork_rng(devices=[]):  # module construction leaves the global RNG be
            self.module = ViT(cfg)
        self.module.init_random_(torch.Generator().manual_seed(seed))
        self.module.to(self.device).eval()
        vocab = torch.Generator().manual_seed(seed + 1)
        self.centers = torch.randn((num_clusters, cfg.dim), generator=vocab).to(self.device)

    def load_state(self, state_dict, centers=None) -> None:
        """The ViT's state dict and, optionally, a (K, D) vocabulary."""
        super().load_state(state_dict)
        if centers is not None:
            self.centers = torch.tensor(np.asarray(centers), dtype=torch.float32,
                                        device=self.device)

    def _patch_features(self, images) -> torch.Tensor:
        x = preprocess_imagenet(torch.as_tensor(images, device=self.device), self.input_size)
        return self.module(x)["patches"].to(torch.float32)

    @torch.no_grad()
    def encode_batch_device(self, images) -> torch.Tensor:
        """uint8 (B, H, W[, C]) -> device-resident float32 (B, D)."""
        patches = self._patch_features(images)
        if self.aggregation == "gap":
            desc = patches.mean(1)
            desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
        else:
            desc = vlad_aggregate(patches, self.centers)
        return fit_descriptor_dim(desc, self.descriptor_dim)

    @torch.no_grad()
    def fit_vocabulary(self, images, iters: int = 10) -> None:
        """k-means the vocabulary on the patch features of a sample batch."""
        feats = self._patch_features(images).reshape(-1, self.centers.shape[1])
        c = self.centers
        for _ in range(iters):
            c = kmeans_step(c, feats)
        self.centers = c

    def load_torch_state_dict(self, state_dict) -> None:
        """The ViT from a facebookresearch DINOv2 state dict
        (``models/convert.convert_dinov2_torch``)."""
        from mlis_tpu_torch.models.convert import convert_dinov2_torch

        self._load_converted(self.module, convert_dinov2_torch, state_dict)
