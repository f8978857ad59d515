"""Plain PyTorch building blocks of the reference networks.

Every function computes in float32 (the caller turns TF32 off). The
``prec`` argument exists for the control alone: ``"fp8"`` rounds both
operands of every matrix product and convolution to float8 e4m3 with one
scale per tensor (its largest magnitude to 448), as an fp8 inference path
would feed its tensor cores, and accumulates in float32. Weights are in
the checkpoints' flax layout: a dense kernel is (in, out), a convolution
kernel HWIO.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

F32 = "f32"
FP8 = "fp8"
_E4M3_MAX = 448.0


def q8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under a per-tensor scale, back to float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = _E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    x = x.to(torch.float32)
    return q8(x) if prec == FP8 else x


def dense(x: torch.Tensor, p: dict, prec: str) -> torch.Tensor:
    """x @ kernel + bias, kernel (in, out)."""
    y = operand(x, prec) @ operand(p["kernel"], prec)
    return y + p["bias"] if "bias" in p else y


def conv(x: torch.Tensor, p: dict, prec: str, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NCHW convolution with an HWIO kernel."""
    w = p["kernel"].permute(3, 2, 0, 1)
    return F.conv2d(operand(x, prec), operand(w, prec), p.get("bias"), stride, padding)


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    """Flax's LayerNorm over the last axis: Var = E[x^2] - E[x]^2 clipped at 0."""
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def frozen_bn(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm on NCHW."""
    s = p["scale"] * torch.rsqrt(p["var"] + eps)
    return x * s[:, None, None] + (p["bias"] - p["mean"] * s)[:, None, None]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prec: str,
              kv_len: Optional[torch.Tensor] = None, empty_rows_zero: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v over (B, L, H, Dh) tensors; keys at
    positions >= kv_len[b] are masked. A row with no valid key is zero
    when ``empty_rows_zero``, else the mean of v (what a finite mask gives)."""
    Dh = q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", operand(q, prec), operand(k, prec)) / math.sqrt(Dh)
    if kv_len is not None:
        keep = torch.arange(k.shape[1], device=k.device)[None, :] < kv_len[:, None]
        s = s.masked_fill(~keep[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", operand(p, prec), operand(v, prec))
    if kv_len is not None and empty_rows_zero:
        out = torch.where((kv_len > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW bilinear resize with antialiasing, half-pixel centres."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)


def imagenet_input(images_u8: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W) mono8 -> (B, 3, h, w) ImageNet-normalised float32."""
    x = images_u8.to(torch.float32)[:, None] / 255.0
    x = resize_bilinear(x, size).expand(-1, 3, -1, -1)
    mean = torch.tensor([0.485, 0.456, 0.406], device=x.device)[None, :, None, None]
    std = torch.tensor([0.229, 0.224, 0.225], device=x.device)[None, :, None, None]
    return (x - mean) / std


def l2n(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)
