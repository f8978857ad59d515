"""CricaVPR's global descriptor on a DINOv2 ViT-B/14, in plain PyTorch.

DINOv2 (Oquab et al., 2023): patch-14 embedding, a cls token, learned
position embeddings resampled bicubically (Keys a = -0.5, antialiased,
as ``jax.image.resize``) from the 37 x 37 pretraining grid to the
input's, pre-norm blocks with LayerScale, tanh-GELU MLPs, a final norm.
CricaVPR (Lu et al., 2024): GeM (p = 3) over the patch tokens,
L2-normalised and zero-padded to the descriptor slot. The input is the
mono8 frame replicated to three channels, resized bilinearly with
antialiasing and ImageNet-normalised.

Seeded weights (``seeded_params``), in the shipped ``vpr_crica.npz``
layout: every dense and convolution kernel N(0, 1 / fan_in) (fan_in the
product of all but its output axis), every bias N(0, 0.02^2), every
LayerNorm scale N(1, 0.02^2), the cls token and the position table
N(0, 0.02^2), every LayerScale gamma N(0.1, 0.02^2).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gatebench import flops
from gatebench.reference.nets import attention, conv, dense, imagenet_input, l2n, layer_norm
from gatebench.reference.weights import draw_normal

PATCH = 14
POS_GRID = 37  # DINOv2's pretraining grid, 518 / 14
SEEDED_STD = 0.02  # biases, LayerNorm scales, tokens, position table, LayerScale
SEEDED_GAMMA = 0.1  # LayerScale's mean


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bicubic resampling weights along one axis."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kscale
    w = _keys_cubic(x)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def position_table(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    G = int(round((pos.shape[1] - 1) ** 0.5))
    grid = pos[0, 1:].reshape(G, G, -1)
    if (G, G) != (gh, gw):
        wh = torch.as_tensor(resample_matrix(G, gh), dtype=torch.float32, device=pos.device)
        ww = torch.as_tensor(resample_matrix(G, gw), dtype=torch.float32, device=pos.device)
        grid = torch.einsum("wj,hjd->hwd", ww, torch.einsum("hi,ijd->hjd", wh, grid))
    return grid.reshape(gh * gw, -1)


def vit_patches(p: dict, x: torch.Tensor, heads: int, prec: str) -> torch.Tensor:
    """(B, 3, H, W) normalised images -> (B, gh * gw, D) final-norm patch tokens."""
    tok = conv(x, p["patch_embed"], prec, stride=PATCH)
    B, D, gh, gw = tok.shape
    tok = tok.flatten(2).transpose(1, 2) + position_table(p["pos_embed"], gh, gw)
    cls = (p["cls_token"][0] + p["pos_embed"][0, :1]).expand(B, 1, D)
    h = torch.cat([cls, tok], 1)
    depth = sum(1 for k in p if k.startswith("block"))
    for i in range(depth):
        b = p[f"block{i}"]
        y = layer_norm(h, b["norm1"])
        S = y.shape[1]
        qkv = dense(y, b["attn"]["qkv"], prec).reshape(B, S, 3, heads, D // heads)
        a = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], prec).reshape(B, S, D)
        h = h + b["ls1"]["gamma"] * dense(a, b["attn"]["proj"], prec)
        y = layer_norm(h, b["norm2"])
        y = dense(F.gelu(dense(y, b["mlp"]["fc1"], prec), approximate="tanh"), b["mlp"]["fc2"], prec)
        h = h + b["ls2"]["gamma"] * y
    return layer_norm(h, p["norm"])[:, 1:]


def encode(p: dict, images_u8: torch.Tensor, cfg: dict, prec: str) -> torch.Tensor:
    """(B, H, W) mono8 -> (B, descriptor_dim) unit descriptors."""
    x = imagenet_input(images_u8, cfg["input_size"])
    patches = vit_patches(p, x, int(cfg["heads"]), prec)
    desc = l2n(patches.clamp_min(1e-6).pow(3.0).mean(1).pow(1.0 / 3.0))
    return F.pad(desc, (0, int(cfg["descriptor_dim"]) - desc.shape[-1]))


def frame_flops(cfg: dict) -> float:
    """Operations of one frame at ``input_size`` (``gatebench.flops.vit``)."""
    h, w = cfg["input_size"]
    return flops.vit(h, w, dim=int(cfg["dim"]), depth=int(cfg["depth"]))


def attention_shape(cfg: dict):
    """(tokens, width, blocks) of one frame's attention on the dense kernel:
    the patches of ``input_size`` and the cls token, in every block."""
    h, w = cfg["input_size"]
    return (h // PATCH) * (w // PATCH) + 1, int(cfg["dim"]), int(cfg["depth"])


def seeded_params(cfg: dict, generator) -> dict:
    """The ViT's weights drawn from ``generator`` (the module docstring's
    distributions), keyed as ``vpr_crica.npz``: ``{flat key: float16 array}``."""
    D, hidden = int(cfg["dim"]), 4 * int(cfg["dim"])
    spec = {}

    def dense_(name, n_in, n_out):
        spec[f"{name}/kernel"] = ((n_in, n_out), 0.0, n_in ** -0.5)
        spec[f"{name}/bias"] = ((n_out,), 0.0, SEEDED_STD)

    def norm_(name):
        spec[f"{name}/scale"] = ((D,), 1.0, SEEDED_STD)
        spec[f"{name}/bias"] = ((D,), 0.0, SEEDED_STD)

    spec["cls_token"] = ((1, 1, D), 0.0, SEEDED_STD)
    spec["pos_embed"] = ((1, POS_GRID * POS_GRID + 1, D), 0.0, SEEDED_STD)
    spec["patch_embed/kernel"] = ((PATCH, PATCH, 3, D), 0.0, (PATCH * PATCH * 3) ** -0.5)
    spec["patch_embed/bias"] = ((D,), 0.0, SEEDED_STD)
    norm_("norm")
    for i in range(int(cfg["depth"])):
        b = f"block{i}"
        norm_(f"{b}/norm1")
        norm_(f"{b}/norm2")
        dense_(f"{b}/attn/qkv", D, 3 * D)
        dense_(f"{b}/attn/proj", D, D)
        dense_(f"{b}/mlp/fc1", D, hidden)
        dense_(f"{b}/mlp/fc2", hidden, D)
        for g in ("ls1", "ls2"):
            spec[f"{b}/{g}/gamma"] = ((D,), SEEDED_GAMMA, SEEDED_STD)
    return draw_normal({f"vpr:params/{k}": v for k, v in spec.items()}, generator)
