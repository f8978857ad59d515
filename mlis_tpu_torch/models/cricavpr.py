"""CricaVPR: DINOv2 ViT-B/14 + GeM pooling + cross-image correlation rerank.

Counterpart of ``mlis_tpu/models/cricavpr.py``: 322x322 input (a 23x23
patch grid), the descriptor is GeM (p = 3) over the patch tokens,
L2-normalised and fitted to the 10752-d descriptor slot; every encoded
image's patch tokens stay on the device for the rerank, which mixes the
global cosine score with the bidirectional patch-correlation score
(0.5 / 0.5).

``checkpoint="auto"`` loads ``checkpoints/vpr_crica.npz`` (the ``vpr``
group: the 12 x 768 ViT-B/14, as ``mlis_tpu.train.pretrain_vpr.load_crica_vpr``
loads it); the JAX class itself starts from a random initialisation.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mlis_tpu_torch.models.base import TorchEncoderVPR, fit_descriptor_dim
from mlis_tpu_torch.models.vit import ViT, ViTConfig
from mlis_tpu_torch.ops.image import preprocess_imagenet
from mlis_tpu_torch.ops.pooling import (
    cross_correlation_scores_batch,
    cross_correlation_scores_pairs,
    gem_pool,
)
from mlis_tpu_torch.weights import default_crica_checkpoint, load_npz


class CricaVPR(TorchEncoderVPR):
    input_size = (322, 322)  # 23x23 patch grid

    def __init__(
        self,
        descriptor_dim: int = 10752,
        use_reranking: bool = True,
        vit_cfg: Optional[ViTConfig] = None,
        rerank_weight: float = 0.5,
        input_size=None,
        imagenet_preproc: bool = True,
        checkpoint: Optional[str] = "auto",
        device="cuda",
        **_ignored,
    ):
        """checkpoint: "auto" loads the shipped ``vpr_crica.npz`` (and raises
        if it is missing), a path loads that file, None keeps the module's
        own initialisation (tests load weights themselves).
        imagenet_preproc=False is the plain path of encoders trained
        without ImageNet normalisation: grey mean, bilinear resize, /255,
        replicated to 3 channels."""
        super().__init__(descriptor_dim=descriptor_dim, device=device)
        if input_size is not None:
            self.input_size = tuple(input_size)
        self.use_reranking = use_reranking
        self.rerank_weight = rerank_weight
        self.imagenet_preproc = imagenet_preproc
        self.module = ViT(vit_cfg or ViTConfig.dinov2_vitb14())
        if checkpoint == "auto":
            checkpoint = default_crica_checkpoint()
            if checkpoint is None:
                raise FileNotFoundError("checkpoints/vpr_crica.npz is not in the repository")
        if checkpoint is not None:
            self.load_state(load_npz(checkpoint)["vpr"])
        self.module.to(self.device).eval()
        self.patch_cache: List[torch.Tensor] = []  # (P, D) float32 per image, on the device
        self._patch_matrix: Optional[torch.Tensor] = None

    def _forward_full(self, x: torch.Tensor):
        patches = self.module(x)["patches"].to(torch.float32)
        desc = gem_pool(patches, p=3.0)
        desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
        return fit_descriptor_dim(desc, self.descriptor_dim), patches

    def _preprocess_plain(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.float32)
        if x.dim() == 4:
            x = x.mean(-1)
        x = F.interpolate((x / 255.0)[:, None], size=tuple(self.input_size), mode="bilinear",
                          align_corners=False, antialias=True)[:, 0]
        return x[..., None].expand(*x.shape, 3)

    @torch.no_grad()
    def encode_batch_device(self, images) -> torch.Tensor:
        """uint8 (B, H, W[, C]) -> device-resident float32 (B, D); the patch
        tokens join the device-resident cache."""
        imgs = torch.as_tensor(images, device=self.device)
        x = (preprocess_imagenet(imgs, self.input_size) if self.imagenet_preproc
             else self._preprocess_plain(imgs))
        desc, patches = self._forward_full(x)
        self.patch_cache.extend(patches.unbind(0))
        self._patch_matrix = None
        return desc

    def patch_matrix(self) -> torch.Tensor:
        """Device-resident (N, P, D) stack of all cached patch features."""
        if self._patch_matrix is None or self._patch_matrix.shape[0] != len(self.patch_cache):
            self._patch_matrix = torch.stack(self.patch_cache)
        return self._patch_matrix

    # -- reranking (the reference's :714-757) ------------------------------------
    @torch.no_grad()
    def rerank_scores_all(self, query_idx, cand_idx, batch_size: int = 32) -> np.ndarray:
        """Cross-correlation scores of every (query, candidate) cell:
        (Q,), (Q, K) -> (Q, K)."""
        scores = cross_correlation_scores_pairs(
            self.patch_matrix(), torch.as_tensor(np.asarray(query_idx)),
            torch.as_tensor(np.asarray(cand_idx)), batch_size=batch_size)
        return scores.cpu().numpy()

    @torch.no_grad()
    def rerank_candidates(self, query_idx: int, matches: list, top_k: Optional[int] = None) -> list:
        """Re-score matches (objects with ``match_idx`` and ``similarity``)
        as (1 - w) * global + w * patch correlation, best first."""
        if not self.use_reranking or not matches or query_idx >= len(self.patch_cache):
            return matches
        cand = torch.stack([self.patch_cache[m.match_idx] for m in matches])
        cc = cross_correlation_scores_batch(self.patch_cache[query_idx], cand).cpu().numpy()
        w = self.rerank_weight
        rescored = [
            type(m)(**{**vars(m), "similarity": float((1 - w) * m.similarity + w * float(c))})
            for m, c in zip(matches, cc)
        ]
        rescored.sort(key=lambda m: -m.similarity)
        return rescored[: top_k or len(rescored)]

    def load_torch_state_dict(self, state_dict) -> None:
        """The ViT from a facebookresearch DINOv2 state dict
        (``models/convert.convert_dinov2_torch``)."""
        from mlis_tpu_torch.models.convert import convert_dinov2_torch

        self._load_converted(self.module, convert_dinov2_torch, state_dict)
