"""Fused multi-head attention: softmax(q k^T / sqrt(Dh) + bias) v.

Counterpart of ``mlis_tpu/ops/attention.py``. Its two Pallas kernels
(``_attention_kernel`` and ``_attention_bias_kernel``) read q, k and v as
float32, keep scores, softmax and p v in float32 and cast the output to
the input dtype; here one hand-written CUDA kernel (the dense kernel of
``csrc/attention.cu``) covers both, the bias pointer being optional.
:func:`fused_attention` on a CUDA tensor launches it
(``fused_attention.launches`` counts the launches); on a CPU tensor it runs
:func:`_reference_attention`, the plain version.

:func:`multi_head_attention` keeps the JAX dispatch: a bias-free problem
whose (S, T) float32 score tile exceeds 4 MiB goes to the flash kernel
(:func:`mlis_tpu_torch.ops.flash_attention.flash_mha`). That limit was the
TPU's VMEM budget. A biased problem above it, which the JAX package hands
to XLA's unfused attention, runs the same dense kernel here on CUDA: the
function is the same, and the kernel streams keys, so the score tile never
has to fit anywhere. A (B, 1|H, S, T) bias is read in place by the
kernel, never broadcast to (B, H, S, T).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mlis_tpu_torch.ops.flash_attention import DTYPE_CODES, bh_slices, check_qkv, flash_mha

VMEM_SCORE_BUDGET = 4 * 1024 * 1024  # bytes of the (S, T) float32 score tile


def _reference_attention(q, k, v, bias=None):
    """Plain version: (BH, S, Dh) attention in float32 with an optional
    (BH, S, T) additive bias, output in q's dtype; computed in slices of
    ``bh`` that keep the scores under 256 MiB."""
    BH, S, Dh = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    out = torch.empty_like(q)
    for sl in bh_slices(BH, S, T):
        scores = torch.matmul(q[sl].float(), k[sl].float().transpose(1, 2)) * scale
        if bias is not None:
            scores = scores + bias[sl].float()
        p = torch.softmax(scores, dim=-1)
        out[sl] = torch.matmul(p, v[sl].float()).to(q.dtype)
    return out


def _bias_strides(bias: torch.Tensor, BH: int, S: int, T: int, heads: int):
    """(heads, sb, sh, ss) element strides of a (BH, S, T) bias (heads = 1)
    or a (B, 1|H, S, T) bias, for the kernel's index
    (bh / heads) * sb + (bh % heads) * sh + s * ss + t."""
    if bias.dim() == 3:
        if tuple(bias.shape) != (BH, S, T):
            raise ValueError(f"bias must be ({BH}, {S}, {T}), got {tuple(bias.shape)}")
        return 1, bias.stride(0), 0, bias.stride(1)
    if bias.dim() == 4:
        B = BH // heads
        if bias.shape[0] != B or bias.shape[1] not in (1, heads) or tuple(bias.shape[2:]) != (S, T):
            raise ValueError(f"bias must be ({B}, 1|{heads}, {S}, {T}), got {tuple(bias.shape)}")
        sh = bias.stride(1) if bias.shape[1] == heads else 0
        return heads, bias.stride(0), sh, bias.stride(2)
    raise ValueError(f"bias must be 3-D or 4-D, got {bias.dim()}-D")


def _launch_dense(q, k, v, bias, heads: int) -> torch.Tensor:
    from mlis_tpu_torch import _build

    check_qkv(q, k, v, "fused_attention")
    BH, S, Dh = q.shape
    T = k.shape[1]
    bias_ptr, strides = None, (1, 0, 0, 0)
    if bias is not None:
        if bias.device != q.device:
            raise ValueError(f"fused_attention: bias is on {bias.device}, q on {q.device}")
        bias = bias.to(torch.float32)  # the TPU kernels add the bias in float32
        if bias.stride(-1) != 1:
            raise ValueError("fused_attention: the bias's key axis must be contiguous")
        strides = _bias_strides(bias, BH, S, T, heads)
        bias_ptr = bias.data_ptr()
    out = torch.empty_like(q)
    if BH == 0 or S == 0:
        return out
    status = _build.library().mlis_dense_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(bias_ptr), *strides,
        ctypes.c_void_p(out.data_ptr()), DTYPE_CODES[q.dtype], BH, S, T, Dh,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(status, "dense_attention")
    fused_attention.launches += 1
    return out


def fused_attention(
    q: torch.Tensor,  # (BH, S, Dh)
    k: torch.Tensor,  # (BH, T, Dh)
    v: torch.Tensor,  # (BH, T, Dh)
    bias: Optional[torch.Tensor] = None,  # (BH, S, T) additive, e.g. a -inf mask
) -> torch.Tensor:
    """Scaled dot-product attention: the dense kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cuda":
        return _launch_dense(q, k, v, bias, heads=1)
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, bias)
    raise ValueError(f"fused_attention has no path for device {q.device}")


fused_attention.launches = 0


def multi_head_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, T, H, Dh)
    v: torch.Tensor,  # (B, T, H, Dh)
    bias: Optional[torch.Tensor] = None,  # (B, 1|H, S, T)
) -> torch.Tensor:
    """(B, S, H, Dh) attention over the flattened (B * H) problems."""
    B, S, H, Dh = q.shape
    T = k.shape[1]
    if bias is None and S * T * 4 > VMEM_SCORE_BUDGET:
        return flash_mha(q, k, v)

    def flat(x, L):
        return x.permute(0, 2, 1, 3).reshape(B * H, L, Dh).contiguous()

    if q.device.type == "cuda":
        out = _launch_dense(flat(q, S), flat(k, T), flat(v, T), bias, heads=H)
    elif q.device.type == "cpu":
        bias_f = None
        if bias is not None:
            bias_f = bias.expand(B, H, S, T).reshape(B * H, S, T)
        out = _reference_attention(flat(q, S), flat(k, T), flat(v, T), bias_f)
    else:
        raise ValueError(f"multi_head_attention has no path for device {q.device}")
    return out.reshape(B, H, S, Dh).permute(0, 2, 1, 3)
