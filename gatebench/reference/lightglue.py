"""LightGlue (Lindenberger et al., 2023) at fixed depth, in plain PyTorch.

Both images run on one (2B, K, D) batch. Keypoints are normalised by half
the larger image side; a learnable Fourier projection gives the angles
of a rotary encoding of interleaved feature pairs, applied to q and k in
self-attention only. Each of ``depth`` layers is self-attention then
cross-attention (the source is the batch rolled by B), each a residual
MHA + MLP on [x, message] with LayerNorm inside. Padded keypoints are a
suffix and masked as keys. The head is the dual softmax times the
sigmoid matchabilities; matches are mutual argmax above the threshold.

Rows with no valid key: at K * K above 1024^2 the gate's attention
returns zero for them, at or below it the mean of v; the reference does
the same, so a frame without keypoints reads alike on both sides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gatebench.reference.nets import attention, dense, layer_norm, operand
from gatebench.reference.weights import layer

ZERO_ROW_PRODUCT = 1024 * 1024


class Matches(NamedTuple):
    idx0: torch.Tensor  # (B, K0) int64, -1 where unmatched
    scores: torch.Tensor  # (B, K0)
    valid: torch.Tensor  # (B, K0) bool


def rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    B, K, H, Dh = x.shape
    x2 = x.reshape(B, K, H, Dh // 2, 2)
    a, b = x2[..., 0], x2[..., 1]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.stack([a * c - b * s, a * s + b * c], -1).reshape(B, K, H, Dh)


def attn_layer(p: dict, x, src, kv_len, heads: int, prec: str, rot=None, zero_rows=False):
    B, Kx, D = x.shape
    q = dense(x, p["q"], prec).reshape(B, Kx, heads, D // heads)
    k = dense(src, p["k"], prec).reshape(B, src.shape[1], heads, D // heads)
    v = dense(src, p["v"], prec).reshape(B, src.shape[1], heads, D // heads)
    if rot is not None:
        q, k = rotary(q, *rot), rotary(k, *rot)
    msg = attention(q, k, v, prec, kv_len=kv_len, empty_rows_zero=zero_rows).reshape(B, Kx, D)
    msg = dense(msg, p["proj"], prec)
    h = dense(torch.cat([x, msg], -1), p["ffn1"], prec)
    h = F.gelu(layer_norm(h, p["ffn_norm"]), approximate="tanh")
    return x + dense(h, p["ffn2"], prec)


def scores(p: dict, d0, c0, m0, d1, c1, m1, image_hw, heads: int, prec: str) -> torch.Tensor:
    """Dual-softmax x matchability scores (B, K, K) of equal-K keypoint sets."""
    B, K = d0.shape[:2]
    H, W = image_hw
    size = torch.tensor([W, H], dtype=torch.float32, device=d0.device)
    cn = (torch.cat([c0, c1]) - size / 2.0) / (size.max() / 2.0)
    ang = cn @ p["posenc"]["Wr"]
    rot = (torch.cos(ang), torch.sin(ang))
    x = dense(torch.cat([d0, d1]), p["in_proj"], prec)
    mc = torch.cat([m0, m1])
    kv_self = mc.sum(-1)
    kv_cross = torch.roll(mc, B, dims=0).sum(-1)
    zero_rows = K * K > ZERO_ROW_PRODUCT
    depth = p["blocks"]["self"]["q"]["kernel"].shape[0]
    for i in range(depth):
        blk = layer(p["blocks"], i)
        x = attn_layer(blk["self"], x, x, kv_self, heads, prec, rot=rot, zero_rows=zero_rows)
        x = attn_layer(blk["cross"], x, torch.roll(x, B, dims=0), kv_cross, heads, prec,
                       zero_rows=zero_rows)
    f = dense(x, p["final_proj"], prec)
    f0, f1 = f[:B], f[B:]
    D = f.shape[-1]
    sim = torch.einsum("bkd,bld->bkl", operand(f0, prec), operand(f1, prec)) / D**0.5
    mask2d = m0[:, :, None] & m1[:, None, :]
    z0 = dense(f0, p["matchability"], prec)[..., 0]
    z1 = dense(f1, p["matchability"], prec)[..., 0]
    sim = torch.where(mask2d, sim, torch.full_like(sim, -1e30))
    prob = torch.softmax(sim, 2) * torch.softmax(sim, 1)
    return prob * torch.sigmoid(z0)[:, :, None] * torch.sigmoid(z1)[:, None, :]


def match(p: dict, kp0, kp1, image_hw, heads: int, threshold: float, prec: str) -> Matches:
    """Mutual-argmax matches of (coords, descriptors, mask) keypoint sets."""
    (c0, d0, m0), (c1, d1, m1) = kp0, kp1
    s = scores(p, d0, c0, m0, d1, c1, m1, image_hw, heads, prec)
    mask2d = m0[:, :, None] & m1[:, None, :]
    s = torch.where(mask2d, s, torch.full_like(s, -1.0))
    best1 = s.argmax(2)
    best0 = s.argmax(1)
    mutual = best0.gather(1, best1) == torch.arange(s.shape[1], device=s.device)[None, :]
    sc = s.gather(2, best1[..., None])[..., 0]
    valid = mutual & (sc > threshold) & m0
    return Matches(torch.where(valid, best1, torch.full_like(best1, -1)),
                   torch.where(valid, sc, torch.zeros_like(sc)), valid)
