"""Vision Transformer backbone (DINOv2-style), forward only.

Counterpart of ``mlis_tpu/models/vit.py``: patch-14 embedding, a cls token
and optional register tokens, pre-norm blocks with LayerScale, learned
position embeddings resampled bicubically to the input's patch grid.
Every block's attention goes through
:func:`mlis_tpu_torch.ops.attention.multi_head_attention`, so on the card
it runs the dense attention kernel (the flash kernel for sequences whose
score tile exceeds 4 MiB).

Numerics follow flax: Dense and Conv compute in ``cfg.dtype`` (bf16 by
default), LayerNorm in float32 (epsilon 1e-6), GELU is the tanh
approximation (flax's ``nn.gelu`` default), and the final norm's float32
output is returned. Module names equal the flax ones
(``block{i}.attn.qkv`` ...), so :func:`mlis_tpu_torch.weights.from_jax_params`
carries a flax tree across. Images come in the JAX layout, (B, H, W, 3).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mlis_tpu_torch.models.layers import Conv, Dense, LayerNorm, flax_init_, trunc_normal_
from mlis_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 14
    pos_grid: int = 37  # pretrain grid (518 / 14 for DINOv2)
    num_register_tokens: int = 0
    layerscale_init: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def dinov2_vitb14(**kw) -> "ViTConfig":
        return ViTConfig(dim=768, depth=12, num_heads=12, **kw)

    @staticmethod
    def dinov2_vits14(**kw) -> "ViTConfig":
        return ViTConfig(dim=384, depth=12, num_heads=6, **kw)

    @staticmethod
    def tiny_test(**kw) -> "ViTConfig":
        return ViTConfig(dim=64, depth=2, num_heads=2, pos_grid=8, **kw)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 use_kernel: Optional[bool] = None):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.use_kernel = use_kernel
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        qkv = self.qkv(x).reshape(B, S, 3, self.num_heads, self.dim // self.num_heads)
        # q, k and v are strided slices of the packed qkv: the kernels read
        # them in place
        out = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                   use_kernel=self.use_kernel)
        return self.proj(out.reshape(B, S, self.dim).to(self.dtype))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, use_kernel: Optional[bool] = None):
        super().__init__()
        self.dtype = cfg.dtype
        self.norm1 = LayerNorm(cfg.dim)
        self.attn = Attention(cfg.dim, cfg.num_heads, cfg.dtype, use_kernel)
        self.ls1 = LayerScale(cfg.dim, cfg.layerscale_init)
        self.norm2 = LayerNorm(cfg.dim)
        self.mlp = Mlp(cfg.dim, int(cfg.dim * cfg.mlp_ratio), cfg.dtype)
        self.ls2 = LayerScale(cfg.dim, cfg.layerscale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x).to(self.dtype)))
        return x + self.ls2(self.mlp(self.norm2(x).to(self.dtype)))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel with a = -0.5 (jax.image's "bicubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@lru_cache(maxsize=None)
def resample_weights(n_in: int, n_out: int, method: str = "bicubic") -> np.ndarray:
    """(n_out, n_in) weights of jax.image.resize(method="bicubic" or
    "linear") along one axis: half-pixel centres, the kernel widened by
    n_in / n_out when downsampling (antialiasing), rows normalised;
    computed in float64 once per grid."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = _keys_cubic(x) if method == "bicubic" else np.maximum(0.0, 1.0 - x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def _interpolate_pos_embed(pos: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """Resize the (1, G*G, D) patch position table to an (h, w) grid."""
    G2, D = pos.shape[1], pos.shape[2]
    G = int(round(G2**0.5))
    if (G, G) == tuple(grid):
        return pos
    wh = torch.as_tensor(resample_weights(G, grid[0]), dtype=torch.float32, device=pos.device)
    ww = torch.as_tensor(resample_weights(G, grid[1]), dtype=torch.float32, device=pos.device)
    p = pos.reshape(G, G, D).to(torch.float32)
    p = torch.einsum("hi,ijd->hjd", wh, p)
    p = torch.einsum("wj,hjd->hwd", ww, p)
    return p.reshape(1, grid[0] * grid[1], D)


class ViT(nn.Module):
    """DINOv2-style ViT. Input (B, H, W, 3) float (preprocessed); H and W
    must be multiples of ``patch_size``. Returns a dict with the cls,
    register and patch tokens (float32) and the patch grid.

    ``use_kernel`` is the reference's ``use_pallas``: None runs the
    attention kernels on CUDA tensors, False the plain attention on any
    device."""

    def __init__(self, cfg: ViTConfig, use_kernel: Optional[bool] = None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.patch_embed = Conv(3, c.dim, c.patch_size, stride=c.patch_size, dtype=c.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.pos_grid * c.pos_grid + 1, c.dim))
        if c.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, c.num_register_tokens, c.dim))
        for i in range(c.depth):
            self.add_module(f"block{i}", Block(c, use_kernel))
        self.norm = LayerNorm(c.dim)
        for p in (self.cls_token, self.pos_embed):
            nn.init.trunc_normal_(p, std=0.02)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "ViT":
        """A random initialisation with the reference's distributions, drawn
        from ``generator`` alone: flax's defaults for every Dense, Conv and
        LayerNorm, truncated N(0, 0.02^2) tokens and position table, and
        LayerScale at ``layerscale_init``."""
        flax_init_(self, generator)
        for name in ("cls_token", "pos_embed", "register_tokens"):
            if hasattr(self, name):
                trunc_normal_(getattr(self, name), 0.02, generator)
        for m in self.modules():
            if isinstance(m, LayerScale):
                m.gamma.fill_(self.cfg.layerscale_init)
        return self

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        c = self.cfg
        B, H, W, _ = images.shape
        gh, gw = H // c.patch_size, W // c.patch_size
        x = self.patch_embed(images.to(c.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, gh * gw, dim), row-major over the grid
        pos = self.pos_embed
        x = x + _interpolate_pos_embed(pos[:, 1:], (gh, gw)).to(c.dtype)
        cls_tok = (self.cls_token.to(c.dtype) + pos[:, :1].to(c.dtype)).expand(B, 1, c.dim)
        toks = [cls_tok]
        n_reg = c.num_register_tokens
        if n_reg:
            toks.append(self.register_tokens.to(c.dtype).expand(B, n_reg, c.dim))
        x = torch.cat(toks + [x], dim=1)
        for i in range(c.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.norm(x)
        return {
            "cls": x[:, 0],
            "registers": x[:, 1 : 1 + n_reg],
            "patches": x[:, 1 + n_reg :],
            "grid": (gh, gw),
        }
