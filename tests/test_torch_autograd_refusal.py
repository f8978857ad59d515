"""The attention kernels are forward-only, and their wrappers say so: with
autograd on, ``_launch_flash`` and ``_launch_dense`` raise a RuntimeError
that names the kernel on inputs that require grad, before anything is
built or launched (the shared helper ``refuse_autograd``), as the JAX
package's ``pallas_call`` has no VJP. The CPU branches run the plain
versions, which differentiate: their gradients equal those of plain
autograd attention. The card's half (raise with grad, launch under
``torch.no_grad()``) is the gpu-marked test at the end and chip_smoke.py's
phase 14f. This file imports neither JAX nor mlis_tpu."""

import math

import pytest
import torch

from mlis_tpu_torch.ops import attention as att
from mlis_tpu_torch.ops import flash_attention as fa


def _qkv(requires_grad, B=2, S=5, T=7, H=2, Dh=16, device="cpu"):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, n, H, Dh, generator=g).to(device) for n in (S, T, T))
    return [x.requires_grad_(requires_grad) for x in (q, k, v)]


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_helper_refuses_any_input_that_requires_grad(which):
    tensors = [torch.zeros(2, 3) for _ in range(4)]
    tensors[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="dense_attention: the CUDA kernel is forward-only"):
        fa.refuse_autograd("dense_attention", *tensors)
    with torch.no_grad():
        fa.refuse_autograd("dense_attention", *tensors)
    with torch.inference_mode():
        fa.refuse_autograd("dense_attention", *tensors)
    fa.refuse_autograd("flash_attention", *(t.detach() for t in tensors), None)


def test_launchers_refuse_before_building_anything():
    q, k, v = _qkv(True)
    counts = (fa.flash_attention.launches, att.fused_attention.launches)
    with pytest.raises(RuntimeError, match="flash_attention: the CUDA kernel is forward-only"):
        fa._launch_flash(q, k, v, None)
    with pytest.raises(RuntimeError, match="dense_attention: the CUDA kernel is forward-only"):
        att._launch_dense(q, k, v, None)
    bias = torch.zeros(2, 1, 5, 7, requires_grad=True)
    with pytest.raises(RuntimeError, match="dense_attention"):
        att._launch_dense(*(x.detach() for x in (q, k, v)), bias)
    assert (fa.flash_attention.launches, att.fused_attention.launches) == counts


def _autograd_attention(q, k, v):
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("path", ["flash_mha", "multi_head_attention", "plain"])
def test_cpu_paths_still_differentiate(path):
    q, k, v = _qkv(True)
    if path == "flash_mha":
        out = fa.flash_mha(q, k, v)
    elif path == "plain":
        out = att.multi_head_attention(q, k, v, use_kernel=False)
    else:
        out = att.multi_head_attention(q, k, v)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    ref_in = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad((_autograd_attention(*ref_in) * w).sum(), ref_in)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_card_wrappers_refuse_grad_and_launch_without():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (x.to(torch.bfloat16) for x in _qkv(False, S=64, T=64, device="cuda"))
    for x in (q, k, v):
        x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_mha(q, k, v)
    with pytest.raises(RuntimeError, match="forward-only"):
        att.multi_head_attention(q, k, v)
    before = (fa.flash_attention.launches, att.fused_attention.launches)
    with torch.no_grad():
        fa.flash_mha(q, k, v)
        att.multi_head_attention(q, k, v)
    assert (fa.flash_attention.launches, att.fused_attention.launches) == (before[0] + 1,
                                                                         before[1] + 1)
