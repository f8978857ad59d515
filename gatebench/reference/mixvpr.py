"""MixVPR (Ali-bey et al., 2023) on a ResNet-50 cut after stage 3, in plain PyTorch.

ResNet-50 (He et al., 2016) with inference batch norm, the stride on the
3x3 convolution, stopped after layer 3 (1024 channels at stride 16); four
feature-mixer blocks x + W2 relu(W1 LN(x)) over the flattened spatial
axis; a channel projection to descriptor_dim / 4 and a row projection to
4; flattened channel-major and L2-normalised. The input is the mono8
frame replicated to three channels, resized bilinearly with antialiasing
and ImageNet-normalised.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gatebench.reference.nets import conv, dense, frozen_bn, imagenet_input, l2n, layer_norm

STAGES = (3, 4, 6)  # ResNet-50's first three stages


def bottleneck(b: dict, x: torch.Tensor, stride: int, prec: str) -> torch.Tensor:
    y = F.relu(frozen_bn(conv(x, b["conv1"], prec), b["bn1"]))
    y = F.relu(frozen_bn(conv(y, b["conv2"], prec, stride=stride, padding=1), b["bn2"]))
    y = frozen_bn(conv(y, b["conv3"], prec), b["bn3"])
    if "downsample_conv" in b:
        x = frozen_bn(conv(x, b["downsample_conv"], prec, stride=stride), b["downsample_bn"])
    return F.relu(y + x)


def encode(p: dict, images_u8: torch.Tensor, cfg: dict, prec: str) -> torch.Tensor:
    """(B, H, W) mono8 -> (B, descriptor_dim) unit descriptors."""
    bb, agg = p["backbone"], p["aggregator"]
    x = imagenet_input(images_u8, cfg["input_size"])
    x = F.relu(frozen_bn(conv(x, bb["stem_conv"], prec, stride=2, padding=3), bb["stem_bn"]))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage, n in enumerate(STAGES):
        for i in range(n):
            x = bottleneck(bb[f"layer{stage + 1}_{i}"], x, 2 if (i == 0 and stage > 0) else 1, prec)
    B, C = x.shape[:2]
    x = x.reshape(B, C, -1)
    for i in range(sum(1 for k in agg if k.startswith("mix"))):
        m = agg[f"mix{i}"]
        x = x + dense(F.relu(dense(layer_norm(x, m["norm"]), m["fc1"], prec)), m["fc2"], prec)
    x = dense(x.transpose(1, 2), agg["channel_proj"], prec)  # (B, HW, C')
    x = dense(x.transpose(1, 2), agg["row_proj"], prec)  # (B, C', rows)
    return l2n(x.reshape(B, -1))
