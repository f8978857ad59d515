"""Layers with the numerics of their flax counterparts.

Parameters are stored in float32. ``Dense`` and ``Conv`` compute in their
``dtype`` (inputs, weights and bias cast to it, as flax does with
``dtype=``); normalisation runs in float32 and casts back.
:func:`flax_init_` draws a random initialisation with flax's default
distributions from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """``flax.linen.Dense``: y = x @ W.T + b in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Conv2d):
    """``flax.linen.Conv`` on NCHW tensors, computed in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride, self.padding)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last dim: float32 statistics with
    Var = E[x^2] - E[x]^2 clipped at 0, epsilon 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class FrozenBatchNorm(nn.Module):
    """Inference batch norm on NCHW: y = x * s + (b - mean * s) with
    s = weight / sqrt(var + eps), both factors cast to the input dtype."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.rsqrt(self.running_var + self.eps)
        s = self.weight * r
        shift = self.bias - self.running_mean * self.weight * r
        return x * s.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


# flax's lecun_normal: a normal truncated at two standard deviations, its
# scale corrected so that the truncated variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """flax's ``truncated_normal(std)``: N(0, std^2) cut at +-2 std."""
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every Dense and Conv of ``module`` as flax initialises them
    (lecun-normal kernels over the fan-in, zero biases) and reset each
    LayerNorm to ones and zeros. Draws come from ``generator`` alone."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            fan_in = m.weight[0].numel()
            trunc_normal_(m.weight, (1.0 / fan_in) ** 0.5 / _TRUNC_STD, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
