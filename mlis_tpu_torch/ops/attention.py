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
kernel, never broadcast to (B, H, S, T). On CUDA the kernel reads q, k
and v as (B, L, H, Dh) views in place and writes the (B, S, H, Dh)
output: no layout copy on either side.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from mlis_tpu_torch.ops.flash_attention import (
    DTYPE_CODES,
    bh_slices,
    flash_mha,
    prepare_launch,
    refuse_autograd,
)

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


def _bias_strides(bias: torch.Tensor, B: int, H: int, S: int, T: int):
    """(sb, sh, ss) element strides of a (B, 1|H, S, T) bias, or of a
    (B, S, T) one when H = 1, for the kernel's index
    b * sb + h * sh + s * ss + t."""
    if bias.dim() == 3 and H == 1:
        if tuple(bias.shape) != (B, S, T):
            raise ValueError(f"bias must be ({B}, {S}, {T}), got {tuple(bias.shape)}")
        return bias.stride(0), 0, bias.stride(1)
    if bias.dim() == 4:
        if bias.shape[0] != B or bias.shape[1] not in (1, H) or tuple(bias.shape[2:]) != (S, T):
            raise ValueError(f"bias must be ({B}, 1|{H}, {S}, {T}), got {tuple(bias.shape)}")
        sh = bias.stride(1) if bias.shape[1] == H and H > 1 else 0
        return bias.stride(0), sh, bias.stride(2)
    raise ValueError(f"bias must be 4-D (B, 1|H, S, T), got {bias.dim()}-D")


def _launch_dense(q, k, v, bias) -> torch.Tensor:
    """The dense kernel on (B, S, H, Dh) and (B, T, H, Dh) views with an
    optional bias read in place; returns a contiguous (B, S, H, Dh) output."""
    from mlis_tpu_torch import _build

    refuse_autograd("dense_attention", q, k, v, bias)
    out, strides = prepare_launch(q, k, v, "fused_attention")
    B, S, H, Dh = q.shape
    T = k.shape[1]
    bias_ptr, bias_strides = None, (0, 0, 0)
    if bias is not None:
        if bias.device != q.device:
            raise ValueError(f"fused_attention: bias is on {bias.device}, q on {q.device}")
        bias = bias.to(torch.float32)  # the TPU kernels add the bias in float32
        if bias.stride(-1) != 1:
            raise ValueError("fused_attention: the bias's key axis must be contiguous")
        bias_strides = _bias_strides(bias, B, H, S, T)
        bias_ptr = bias.data_ptr()
    if B * H == 0 or S == 0:
        return out
    status = _build.library().mlis_dense_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(bias_ptr), *bias_strides,
        ctypes.c_void_p(out.data_ptr()), strides, DTYPE_CODES[q.dtype], B, H, S, T, Dh,
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
    """Scaled dot-product attention: the dense kernel on CUDA tensors (the
    (B, S, H, Dh) case H = 1), the plain version on CPU tensors."""
    if q.device.type == "cuda":
        return _launch_dense(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), bias).squeeze(2)
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, bias)
    raise ValueError(f"fused_attention has no path for device {q.device}")


fused_attention.launches = 0


def _plain_multi_head(q, k, v, bias):
    """The plain version over (B * H, L, Dh) copies, output (B, S, H, Dh)."""
    B, S, H, Dh = q.shape
    T = k.shape[1]

    def flat(x, L):
        return x.permute(0, 2, 1, 3).reshape(B * H, L, Dh).contiguous()

    bias_f = None
    if bias is not None:
        bias_f = bias.expand(B, H, S, T).reshape(B * H, S, T)
    out = _reference_attention(flat(q, S), flat(k, T), flat(v, T), bias_f)
    return out.reshape(B, H, S, Dh).permute(0, 2, 1, 3)


def multi_head_attention(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, T, H, Dh)
    v: torch.Tensor,  # (B, T, H, Dh)
    bias: Optional[torch.Tensor] = None,  # (B, 1|H, S, T)
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """(B, S, H, Dh) attention over the (B * H) problems.

    ``use_kernel=False`` runs the plain version on any device, as the
    reference's ``use_pallas=False`` does. Otherwise CUDA tensors go to the
    kernels, which read the views in place (the ViT's slices of its packed
    qkv included) and return a contiguous (B, S, H, Dh) output, and CPU
    tensors to the plain versions."""
    if use_kernel is False:
        return _plain_multi_head(q, k, v, bias)
    S, T = q.shape[1], k.shape[1]
    if bias is None and S * T * 4 > VMEM_SCORE_BUDGET:
        return flash_mha(q, k, v)
    if q.device.type == "cuda":
        return _launch_dense(q, k, v, bias)
    if q.device.type == "cpu":
        return _plain_multi_head(q, k, v, bias)
    raise ValueError(f"multi_head_attention has no path for device {q.device}")
