"""MixVPR: ResNet-50 features + MLP-Mixer aggregation -> 4096-d descriptor.

Counterpart of ``mlis_tpu/models/mixvpr.py``: ResNet-50 cropped after
layer 3 (1024 channels, stride 16), 320x320 input -> 20x20 map, four
feature-mixer blocks over the flattened spatial axis, a channel projection
to 1024 and a row projection to 4, flattened and L2-normalised.

Weights come from ``checkpoints/vpr_mixvpr.npz`` (the ``vpr`` group, as
``mlis_tpu.train.pretrain_vpr.load_mixvpr_vpr`` loads it). The mixer
width is the backbone's output size at ``input_size``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mlis_tpu_torch.models.base import TorchEncoderVPR
from mlis_tpu_torch.models.layers import Dense, LayerNorm
from mlis_tpu_torch.models.resnet import ResNet, ResNetConfig
from mlis_tpu_torch.weights import default_mixvpr_checkpoint, load_npz


class FeatureMixerLayer(nn.Module):
    def __init__(self, hw: int, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(hw)
        self.fc1 = Dense(hw, hw, dtype=dtype)
        self.fc2 = Dense(hw, hw, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, HW)
        h = self.norm(x).to(x.dtype)
        return x + self.fc2(F.relu(self.fc1(h)))


class MixVPRHead(nn.Module):
    def __init__(self, in_channels: int, hw: int, mix_depth: int = 4,
                 out_channels: int = 1024, out_rows: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.mix_depth = mix_depth
        for i in range(mix_depth):
            self.add_module(f"mix{i}", FeatureMixerLayer(hw, dtype))
        self.channel_proj = Dense(in_channels, out_channels, dtype=dtype)
        self.row_proj = Dense(hw, out_rows, dtype=dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:  # (B, C, h, w)
        B, C = feat.shape[:2]
        x = feat.reshape(B, C, -1)  # (B, C, HW), spatial index h * w_dim + w
        for i in range(self.mix_depth):
            x = getattr(self, f"mix{i}")(x)
        x = self.channel_proj(x.transpose(1, 2))  # (B, HW, out_channels)
        x = self.row_proj(x.transpose(1, 2))  # (B, out_channels, out_rows)
        x = x.reshape(B, -1).to(torch.float32)
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class MixVPRModule(nn.Module):
    def __init__(self, backbone_cfg: ResNetConfig, hw: int, mix_depth: int = 4,
                 out_channels: int = 1024, out_rows: int = 4):
        super().__init__()
        self.backbone = ResNet(backbone_cfg)
        self.aggregator = MixVPRHead(
            self.backbone.out_channels, hw, mix_depth, out_channels, out_rows,
            backbone_cfg.dtype,
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.aggregator(self.backbone(images))


class MixVPR(TorchEncoderVPR):
    """4096-d MixVPR encoder (320x320 input)."""

    input_size = (320, 320)

    def __init__(
        self,
        descriptor_dim: int = 4096,
        backbone_cfg: Optional[ResNetConfig] = None,
        input_size=None,
        checkpoint: Optional[str] = "auto",
        device="cuda",
        **_ignored,
    ):
        """checkpoint: "auto" loads the shipped ``vpr_mixvpr.npz`` (and
        raises if it is missing), a path loads that file, None keeps the
        module's own initialisation (tests load weights themselves)."""
        super().__init__(descriptor_dim=descriptor_dim, device=device)
        if input_size is not None:
            self.input_size = tuple(input_size)
        cfg = backbone_cfg or ResNetConfig(crop_stage=3)
        stride = 4 * 2 ** (min(cfg.crop_stage, len(cfg.stage_sizes)) - 1)
        hw = -(-self.input_size[0] // stride) * -(-self.input_size[1] // stride)
        out_rows = 4
        self.module = MixVPRModule(cfg, hw, out_channels=descriptor_dim // out_rows,
                                   out_rows=out_rows)
        if checkpoint == "auto":
            checkpoint = default_mixvpr_checkpoint()
            if checkpoint is None:
                raise FileNotFoundError("checkpoints/vpr_mixvpr.npz is not in the repository")
        if checkpoint is not None:
            self.load_state(load_npz(checkpoint)["vpr"])
        self.module.to(self.device).eval()

    def load_torch_state_dict(self, state_dict) -> None:
        """The ResNet backbone from a torchvision ResNet-50 state dict
        (``models/convert.convert_resnet_torch``)."""
        from mlis_tpu_torch.models.convert import convert_resnet_torch

        self._load_converted(self.module.backbone, convert_resnet_torch, state_dict)
