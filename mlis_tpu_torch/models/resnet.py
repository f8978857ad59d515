"""ResNet-50 backbone on NCHW tensors (MixVPR's feature extractor).

Counterpart of ``mlis_tpu/models/resnet.py``: inference-mode (frozen) batch
norm, stride on the 3x3 convolution, and ``crop_stage`` to stop after
layer 3 as MixVPR does (1024 channels at stride 16).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mlis_tpu_torch.models.layers import Conv, FrozenBatchNorm


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    crop_stage: int = 4  # 4 = full network; 3 = stop after layer3 (MixVPR)
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny_test(**kw) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(1, 1), width=8, crop_stage=2, **kw)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(in_ch, features, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = Conv(features, features, 3, stride=strides, padding=1, bias=False, dtype=dtype)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = Conv(features, features * 4, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(features * 4)
        self.needs_proj = in_ch != features * 4 or strides != 1
        if self.needs_proj:
            self.downsample_conv = Conv(in_ch, features * 4, 1, stride=strides, bias=False, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.needs_proj else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        self.stem_conv = Conv(3, cfg.width, 7, stride=2, padding=3, bias=False, dtype=cfg.dtype)
        self.stem_bn = FrozenBatchNorm(cfg.width)
        in_ch = cfg.width
        self.block_names = []
        for stage, n_blocks in enumerate(cfg.stage_sizes[: cfg.crop_stage]):
            feats = cfg.width * (2**stage)
            for b in range(n_blocks):
                strides = 2 if (b == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck(in_ch, feats, strides, cfg.dtype))
                self.block_names.append(name)
                in_ch = feats * 4
        self.out_channels = in_ch

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) preprocessed float -> (B, C, h, w) feature map."""
        x = F.relu(self.stem_bn(self.stem_conv(images)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x
