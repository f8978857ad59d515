"""KV-tiled flash attention with per-row key counts (online softmax).

Counterpart of ``mlis_tpu/ops/flash_attention.py``, for the attentions
the matchers need (LightGlue's on the card at every keypoint count, through
``models/lightglue.masked_attention``; ViT sequences too long for the dense
kernel): softmax(q k^T / sqrt(Dh)) v where the keys of row ``bh`` at
positions >= ``kv_len[bh]`` are masked, so a prefix-valid keypoint mask is
a length, not an (S, T) bias.

Semantics, as in the JAX package's two Pallas kernels (``_flash_kernel``
and ``_single_block_kernel``, which compute the same function):

* q k^T and p v take their operands in the input dtype and accumulate in
  float32; the softmax state is float32;
* p is cast to v's dtype before the p v product, and the output is
  acc / max(l, 1e-20), so a row with ``kv_len = 0`` is zeros, not NaN.
  ``_launch_flash(..., mean_empty=True)`` gives such a row V's mean over
  all T keys instead, the answer of a dense softmax over a fully masked
  row, which LightGlue keeps up to Kx * Ks = 1024^2 as the JAX package's
  dense attention does.

:func:`flash_attention` on a CUDA tensor launches the hand-written kernel
of ``csrc/attention.cu`` (one kernel serves both Pallas kernels); on a CPU
tensor it runs :func:`flash_attention_plain`, which repeats the arithmetic
with a one-shot softmax, in slices of ``bh`` that keep the (S, T) float32
scores under 256 MiB. Layouts are the JAX package's: (BH, S, Dh) here,
(B, S, H, Dh) at :func:`flash_mha`. The kernel itself takes (B, L, H, Dh)
views with any strides that its TMA loads accept (:func:`check_views`), so
neither wrapper copies q, k, v or the output on CUDA. The kernels are
forward-only: on tensors that require grad, with autograd on, the launch
raises (:func:`refuse_autograd`) instead of cutting the gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

PLAIN_SCORE_BYTES = 256 * 1024 * 1024  # float32 scores per slice of the plain version
HEAD_DIMS = (16, 32, 64)  # head widths the CUDA kernels are built for
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_BH = 65535  # grid y of the CUDA kernels


def bh_slices(BH: int, S: int, T: int):
    """Slices of the bh axis whose (S, T) float32 scores fit PLAIN_SCORE_BYTES."""
    step = max(1, PLAIN_SCORE_BYTES // max(1, S * T * 4))
    return [slice(b, min(b + step, BH)) for b in range(0, BH, step)]


def flash_attention_plain(
    q: torch.Tensor,  # (BH, S, Dh)
    k: torch.Tensor,  # (BH, T, Dh)
    v: torch.Tensor,  # (BH, T, Dh)
    kv_len: Optional[torch.Tensor] = None,  # (BH,) valid key count
) -> torch.Tensor:
    """Plain torch version of the flash kernel on any device."""
    BH, S, Dh = q.shape
    T = k.shape[1]
    if kv_len is None:
        kv_len = torch.full((BH,), T, dtype=torch.int32, device=q.device)
    scale = 1.0 / math.sqrt(Dh)
    col = torch.arange(T, device=q.device)
    out = torch.empty_like(q)
    for sl in bh_slices(BH, S, T):
        s = torch.matmul(q[sl].float(), k[sl].float().transpose(1, 2)) * scale
        s = s.masked_fill(col[None, None, :] >= kv_len[sl, None, None], float("-inf"))
        m = s.amax(-1, keepdim=True)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m_safe)
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        l = p.sum(-1, keepdim=True)
        acc = torch.matmul(p.to(v.dtype).float(), v[sl].float())
        out[sl] = (acc / l.clamp_min(1e-20)).to(q.dtype)
    return out


def refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd is on and any of ``tensors`` requires grad. The
    CUDA kernels are forward-only (no backward is written, as the Pallas
    kernels have no VJP): their output would carry no ``grad_fn``, and the
    gradient to q, k, v (or the bias) would be cut without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward-only and has no backward; "
                           f"call it under torch.no_grad() or run the plain version "
                           f"(use_kernel=False) to differentiate")


def check_views(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str) -> None:
    """Raise unless q (B, S, H, Dh), k and v (B, T, H, Dh) are views the
    CUDA kernels take: one CUDA device, one dtype of DTYPE_CODES, Dh in
    HEAD_DIMS, B * H <= MAX_BH, the head axis contiguous, and every base
    address and stride a multiple of 16 bytes (the TMA's rules). Nothing is
    copied to make a view fit."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (B, S, H, Dh) and (B, T, H, Dh) views")
    B, S, H, Dh = q.shape
    if k.shape[0] != B or tuple(k.shape[2:]) != (H, Dh) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)} disagree")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtype must be one of float32, bfloat16, float16 for all "
                         f"three, got {q.dtype}, {k.dtype}, {v.dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head width {Dh} is not one of {HEAD_DIMS}")
    if B * H > MAX_BH:
        raise ValueError(f"{name}: B * H = {B * H} exceeds {MAX_BH}")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {label} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {label}'s head axis must be contiguous, strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
        for d in range(3):
            if t.shape[d] > 1 and (t.stride(d) <= 0 or t.stride(d) * t.element_size() % 16):
                raise ValueError(f"{name}: {label}'s strides {t.stride()} must be positive "
                                 f"multiples of 16 bytes")


def _view_strides(t: torch.Tensor) -> list:
    """(b, l, h) element strides of a (B, L, H, Dh) view; an axis of size 1
    gets Dh, which every map of the kernels accepts."""
    return [t.stride(d) if t.shape[d] > 1 else t.shape[-1] for d in range(3)]


def prepare_launch(q, k, v, name):
    """Check the views and allocate the (B, S, H, Dh) output; returns it and
    the 12 strides of q, k, v and out as a ctypes array."""
    check_views(q, k, v, name)
    if k.shape[1] == 0:
        raise ValueError(f"{name}: there are no keys (T = 0)")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    vals = [s for t in (q, k, v, out) for s in _view_strides(t)]
    return out, (ctypes.c_longlong * 12)(*vals)


def _launch_flash(q, k, v, kv_len, mean_empty: bool = False) -> torch.Tensor:
    """The flash kernel on (B, S, H, Dh) and (B, T, H, Dh) views; kv_len
    (B * H,) int32 or None; returns a contiguous (B, S, H, Dh) output. A
    row with kv_len = 0 gives zeros, or with ``mean_empty`` V's mean over
    all T keys (a softmax of equal logits, as a dense masked softmax gives)."""
    from mlis_tpu_torch import _build

    refuse_autograd("flash_attention", q, k, v)
    out, strides = prepare_launch(q, k, v, "flash_attention")
    B, S, H, Dh = q.shape
    T = k.shape[1]
    if kv_len is None:
        kv_len = torch.full((B * H,), T, dtype=torch.int32, device=q.device)
    if kv_len.shape != (B * H,) or kv_len.dtype != torch.int32 or kv_len.device != q.device \
            or not kv_len.is_contiguous():
        raise ValueError(f"flash_attention: kv_len must be a contiguous ({B * H},) int32 tensor "
                         f"on {q.device}")
    if B * H == 0 or S == 0:
        return out
    status = _build.library().mlis_flash_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(kv_len.data_ptr()), int(mean_empty),
        ctypes.c_void_p(out.data_ptr()), strides, DTYPE_CODES[q.dtype], B, H, S, T, Dh,
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,  # (BH, S, Dh)
    k: torch.Tensor,  # (BH, T, Dh)
    v: torch.Tensor,  # (BH, T, Dh)
    kv_len: Optional[torch.Tensor] = None,  # (BH,) valid key count
) -> torch.Tensor:
    """Attention with per-row key counts. CUDA tensors launch the flash
    kernel (``flash_attention.launches`` counts the launches); CPU tensors
    run :func:`flash_attention_plain`."""
    if kv_len is not None:
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    if q.device.type == "cuda":  # (BH, S, Dh) is the (B, S, H, Dh) case H = 1
        return _launch_flash(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), kv_len).squeeze(2)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len)
    raise ValueError(f"flash_attention has no path for device {q.device}")


flash_attention.launches = 0


def flash_mha(
    q: torch.Tensor,  # (B, S, H, Dh)
    k: torch.Tensor,  # (B, T, H, Dh)
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,  # (B, T) prefix-valid mask
) -> torch.Tensor:
    """Multi-head wrapper over :func:`flash_attention`: each batch row's key
    count, the length of its valid prefix, is repeated over the heads. On
    CUDA the kernel reads the (B, L, H, Dh) views in place and returns its
    (B, S, H, Dh) output; the plain version works on (B * H, L, Dh) copies."""
    B, S, H, Dh = q.shape
    T = k.shape[1]
    lens = None
    if kv_valid is not None:
        lens = kv_valid.sum(1, dtype=torch.int32).repeat_interleave(H)
    if q.device.type == "cuda":
        return _launch_flash(q, k, v, None if lens is None else lens.to(q.device).contiguous())

    def flat(x, L):
        return x.permute(0, 2, 1, 3).reshape(B * H, L, Dh).contiguous()

    out = flash_attention(flat(q, S), flat(k, T), flat(v, T), lens)
    return out.reshape(B, H, S, Dh).permute(0, 2, 1, 3)
