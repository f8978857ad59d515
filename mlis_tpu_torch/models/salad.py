"""SALAD: DINOv2 patch tokens + Sinkhorn optimal-transport aggregation.

Counterpart of ``mlis_tpu/models/salad.py``. Patch tokens are softly
assigned to m = 64 clusters by a score map regularised by optimal
transport (3 log-space Sinkhorn iterations over the clusters plus a
dustbin column, which is dropped afterwards), reduced to l = 128 features,
aggregated per cluster in float32 and concatenated with a 256-d projection
of the cls token: 64 x 128 + 256 = 8448, L2-normalised.

Each Dense computes in the head's dtype (bf16 by default), as flax's do.
The backbone is the port's ViT, so at the default 476x644 input (34x46
patches + cls = 1565 tokens) every block's attention goes to the flash
kernel on the card. Like the JAX class, ``SALAD`` starts from a random
initialisation, drawn here from ``torch.Generator().manual_seed(seed)``
with flax's default distributions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mlis_tpu_torch.models.base import TorchEncoderVPR, fit_descriptor_dim
from mlis_tpu_torch.models.layers import Dense, flax_init_
from mlis_tpu_torch.models.vit import ViT, ViTConfig
from mlis_tpu_torch.ops.image import preprocess_imagenet
from mlis_tpu_torch.ops.sinkhorn import sinkhorn_log

HIDDEN = 512  # width of the head's three MLPs


class SALADHead(nn.Module):
    def __init__(self, dim: int, num_clusters: int = 64, cluster_dim: int = 128,
                 token_dim: int = 256, sinkhorn_iters: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_clusters, self.sinkhorn_iters, self.dtype = num_clusters, sinkhorn_iters, dtype
        self.feat_hidden = Dense(dim, HIDDEN, dtype=dtype)
        self.feat_proj = Dense(HIDDEN, cluster_dim, dtype=dtype)
        self.score_hidden = Dense(dim, HIDDEN, dtype=dtype)
        self.score_proj = Dense(HIDDEN, num_clusters, dtype=dtype)
        self.dustbin = nn.Parameter(torch.ones(()))
        self.token_hidden = Dense(dim, HIDDEN, dtype=dtype)
        self.token_proj = Dense(HIDDEN, token_dim, dtype=dtype)

    def forward(self, patches: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        B, N, _ = patches.shape
        x = patches.to(self.dtype)
        feats = self.feat_proj(F.relu(self.feat_hidden(x)))  # (B, N, l)
        scores = self.score_proj(F.relu(self.score_hidden(x))).to(torch.float32)  # (B, N, m)
        aug = torch.cat([scores, self.dustbin.to(torch.float32).expand(B, N, 1)], dim=-1)
        p = sinkhorn_log(aug, self.sinkhorn_iters).exp()[..., : self.num_clusters]
        agg = torch.einsum("bnm,bnl->bml", p, feats.to(torch.float32)).reshape(B, -1)
        g = self.token_proj(F.relu(self.token_hidden(cls.to(self.dtype))))
        out = torch.cat([g.to(torch.float32), agg], dim=-1)
        return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-8)


class SALADModule(nn.Module):
    """The ViT backbone and the SALAD head: (B, H, W, 3) -> (B, m l + g).

    ``use_kernel`` is the reference's ``use_pallas`` (False for the small
    trained SALAD, which the reference builds with plain attention)."""

    def __init__(self, vit_cfg: ViTConfig, num_clusters: int = 64, cluster_dim: int = 128,
                 token_dim: int = 256, use_kernel: Optional[bool] = None):
        super().__init__()
        self.backbone = ViT(vit_cfg, use_kernel=use_kernel)
        self.head = SALADHead(vit_cfg.dim, num_clusters, cluster_dim, token_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        out = self.backbone(images)
        return self.head(out["patches"], out["cls"])

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "SALADModule":
        """flax's initialisation from ``generator``: the ViT's own, the
        head's Dense layers lecun-normal with zero biases, the dustbin 1."""
        self.backbone.init_random_(generator)
        flax_init_(self.head, generator)
        self.head.dustbin.fill_(1.0)
        return self


class SALAD(TorchEncoderVPR):
    input_size = (476, 644)  # 14-divisible stand-in for the reference's 480x640

    def __init__(
        self,
        descriptor_dim: Optional[int] = None,
        seed: int = 0,
        vit_cfg: Optional[ViTConfig] = None,
        input_size=None,
        num_clusters: int = 64,
        cluster_dim: int = 128,
        token_dim: int = 256,
        device="cuda",
        **_ignored,
    ):
        native = num_clusters * cluster_dim + token_dim  # 8448 at the defaults
        super().__init__(descriptor_dim=descriptor_dim or native, device=device)
        if input_size is not None:
            self.input_size = tuple(input_size)
        cfg = vit_cfg or ViTConfig.dinov2_vitb14()
        with torch.random.fork_rng(devices=[]):  # module construction leaves the global RNG be
            self.module = SALADModule(cfg, num_clusters, cluster_dim, token_dim)
        self.module.init_random_(torch.Generator().manual_seed(seed))
        self.module.to(self.device).eval()

    @torch.no_grad()
    def encode_batch_device(self, images) -> torch.Tensor:
        """uint8 (B, H, W[, C]) -> device-resident float32 (B, D)."""
        x = preprocess_imagenet(torch.as_tensor(images, device=self.device), self.input_size)
        return fit_descriptor_dim(self.module(x), self.descriptor_dim)

    def load_torch_state_dict(self, state_dict) -> None:
        """The ViT backbone from a facebookresearch DINOv2 state dict
        (``models/convert.convert_dinov2_torch``)."""
        from mlis_tpu_torch.models.convert import convert_dinov2_torch

        self._load_converted(self.module.backbone, convert_dinov2_torch, state_dict)
