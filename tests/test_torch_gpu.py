"""Card-only tests of the port: the CUDA kernels (the candidate sweep,
flash and dense attention) against their plain versions, their launch
counters and input checks, and the gate on the card against the CPU.
They need an NVIDIA card and ``nvcc``; without a card they skip. Run them
on the card with

    MLIS_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_torch_gpu.py

(the variable keeps tests/conftest.py from importing JAX, which the card's
machine does not have). This file imports neither JAX nor mlis_tpu."""

import numpy as np
import pytest
import torch

from mlis_tpu_torch.ops import pairwise as pw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, 3)) * 30
    return centers[rng.integers(0, 8, n)] + rng.normal(size=(n, 3)), rng.integers(1, 6, n)


@pytest.mark.parametrize("n,min_gap", [(50, 30), (700, 25), (1500, 100), (5000, 100), (2100, 0),
                                       (1926, 100), (2406, 100), (513, 513), (513, 520)])
def test_kernel_equals_plain_version(cuda, n, min_gap):
    pos, floors = _cloud(n, n)
    p, f, ti, tj = pw.pack_sweep_inputs(pos, floors, min_gap, cuda)
    before = pw.tri_count.launches
    got = pw.tri_count(p, f, ti, tj, min_gap, 4.0)
    assert pw.tri_count.launches == before + 1
    assert got == pw.tri_count_plain(p, f, ti, tj, min_gap, 4.0)
    assert got == pw.candidate_counts_host(pos, floors, 2.0, min_gap)[:2]
    ai, aj = (torch.as_tensor(t, device=cuda) for t in pw.all_tiles(n))
    assert pw.tri_count(p, f, ai, aj, min_gap, 4.0) == got


@pytest.mark.parametrize("log_split", range(pw.MAX_LOG_SPLIT + 1))
@pytest.mark.parametrize("n,min_gap", [(500, 0), (1300, 100), (1100, -1100)])
def test_kernel_at_every_cut(cuda, n, min_gap, log_split):
    """Every cut of a tile into 2**log_split blocks (row and column strips)
    gives the plain version's and the float64 sweep's counts, on the
    upper-triangle list and on the full grid."""
    pos, floors = _cloud(n, log_split)
    p, f, ti, tj = pw.pack_sweep_inputs(pos, floors, min_gap, cuda)
    got = pw._launch_tri_count(p, f, ti, tj, min_gap, 4.0, log_split)
    assert got == pw.tri_count_plain(p, f, ti, tj, min_gap, 4.0)
    assert got == pw.candidate_counts_host(pos, floors, 2.0, min_gap)[:2]
    ai, aj = (torch.as_tensor(t, device=cuda) for t in pw.all_tiles(n))
    assert pw._launch_tri_count(p, f, ai, aj, min_gap, 4.0, log_split) == got


def test_kernel_refuses_a_cut_past_its_range(cuda):
    p, f, ti, tj = pw.pack_sweep_inputs(*_cloud(100, 1), 10, cuda)
    for log_split in (-1, pw.MAX_LOG_SPLIT + 1):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            pw._launch_tri_count(p, f, ti, tj, 10, 4.0, log_split)


def test_sm_count_splits_one_tile(cuda, monkeypatch):
    """A card with many SMs makes the wrapper cut the one tile of a 500-pose
    sweep into 2**MAX_AUTO_LOG_SPLIT blocks; a card with one SM into the
    least power of two at or above BLOCKS_PER_SM and 2**MIN_AUTO_LOG_SPLIT.
    Both count as the plain version does, one launch each."""
    pos, floors = _cloud(500, 3)
    p, f, ti, tj = pw.pack_sweep_inputs(pos, floors, 20, cuda)
    want = pw.tri_count_plain(p, f, ti, tj, 20, 4.0)
    one_sm = max(pw.MIN_AUTO_LOG_SPLIT, (pw.BLOCKS_PER_SM - 1).bit_length())
    for sms, log_split in ((1000, pw.MAX_AUTO_LOG_SPLIT), (1, one_sm)):
        monkeypatch.setattr(pw, "sm_count", lambda device, sms=sms: sms)
        assert pw.sweep_split(len(ti), pw.sm_count(cuda)) == log_split
        before = pw.tri_count.launches
        assert pw.tri_count(p, f, ti, tj, 20, 4.0) == want
        assert pw.tri_count.launches == before + 1
    assert want == pw.candidate_counts_host(pos, floors, 2.0, 20)[:2]


def test_kernel_boundary_pairs(cuda):
    pos = np.zeros((300, 3))
    pos[:, 0] = np.arange(300) * 10.0
    pos[250] = pos[0] + [2.0, 0, 0]
    pos[251] = pos[1] + [2.0 - 1e-9, 0, 0]
    pos[252] = pos[2] + [2.0 + 1e-9, 0, 0]
    got = pw.candidate_counts(pos, np.ones(300, int), 2.0, 100, device=cuda)
    assert got == pw.candidate_counts_host(pos, np.ones(300, int), 2.0, 100) and got[0] == 2


def test_kernel_wrapper_rejects_mixed_devices(cuda):
    p, f, ti, tj = pw.pack_sweep_inputs(*_cloud(100, 1), 10, cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        pw.tri_count(p, f.cpu(), ti, tj, 10, 4.0)


def test_long_attention_runs_the_flash_kernel(cuda):
    """LightGlue attention above Kx*Ks = 1024^2 launches the flash kernel."""
    from mlis_tpu_torch.models.lightglue import masked_attention
    from mlis_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 1025, 2, 16, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([1025, 0], device=cuda)
    before = flash_attention.launches
    out = masked_attention(q, k, v, lens)
    assert flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all() and not out[1].float().any()


# bf16 keeps 8 significant bits: two roundings of nearly equal float32
# values may land one bf16 ulp apart, up to 2^-7 of the value
BF16_RTOL = 2.0**-7


def test_matcher_size_attention_runs_the_flash_kernel(cuda):
    """bf16 LightGlue attention at 512 x 512 keypoints (Kx*Ks <= 1024^2, 2B
    = 8, 4 heads of 64) launches the flash kernel once and agrees with the
    plain float32-logit route on the same inputs; the row with no valid key
    is V's mean over all 512 positions, as the plain route's softmax of
    equal logits gives. With q requiring grad under autograd the call stays
    on the plain route: nothing launches and the output has a grad_fn."""
    from mlis_tpu_torch.models.lightglue import masked_attention
    from mlis_tpu_torch.ops.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attn_inputs(cuda, [(8, 512, 4, 64)] * 3, torch.bfloat16, 22)
    lens = torch.tensor([512, 300, 1, 0] * 2, device=cuda)
    before = flash_attention.launches
    with torch.no_grad():
        got = masked_attention(q, k, v, lens)
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    qg = q.detach().clone().requires_grad_(True)
    want = masked_attention(qg, k, v, lens)
    assert flash_attention.launches == before + 1 and want.grad_fn is not None
    torch.cuda.synchronize()
    _assert_attention_close(got, want.detach(), v, torch.bfloat16, flash=True)
    mean = v.float().mean(1, keepdim=True).expand(-1, 512, -1, -1)
    for row in (3, 7):
        torch.testing.assert_close(got[row].float(), mean[row], rtol=BF16_RTOL, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("S,T,Dh", [(512, 512, 64), (130, 70, 16), (200, 333, 32)])
def test_flash_kernel_averages_empty_rows_when_asked(cuda, dtype, S, T, Dh):
    """``mean_empty``: a row with kv_len = 0 gives V's mean over all T keys
    (T not a multiple of the 64-key tile in two cases); the other rows are
    the same launch's without it, bit for bit."""
    from mlis_tpu_torch.ops.flash_attention import _launch_flash, flash_attention

    B, H = 2, 2
    q, k, v = _attn_inputs(cuda, [(B, S, H, Dh), (B, T, H, Dh), (B, T, H, Dh)], dtype, S + T)
    lens = torch.tensor([T, 0, 1, 0], dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    got = _launch_flash(q, k, v, lens, mean_empty=True)
    zeros = _launch_flash(q, k, v, lens)
    assert flash_attention.launches == before + 2
    torch.cuda.synchronize()
    assert not zeros[0, :, 1].float().any() and not zeros[1, :, 1].float().any()
    torch.testing.assert_close(got[:, :, 0], zeros[:, :, 0], rtol=0, atol=0)
    mean = v.float().mean(1)  # (B, H, Dh)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=BF16_RTOL, atol=1e-5)
    for b in range(B):
        torch.testing.assert_close(got[b, :, 1].float(), mean[b, 1].expand(S, Dh), **tol)


def _attn_inputs(cuda, shapes, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(*s, generator=g, device=cuda).to(dtype) for s in shapes]


def _assert_attention_close(got, want, v, dtype, flash):
    if dtype == torch.float32:
        # an online softmax against a one-shot one: float32 rounding
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    atol = 1e-5
    if flash:
        # p is rounded to bf16/f16 before p v at the scale of the running
        # max in the kernel, of the row max in the plain version: each p
        # may differ by 2^-9 of itself, the output by 2^-9 max|v|
        atol = 2.0**-8 * float(v.abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=atol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("S,T,Dh,lens", [
    (300, 600, 32, None),
    (130, 70, 16, [70, 0, 1, 33]),
    (256, 2048, 64, [2048, 1500, 1, 0]),
    (100, 200, 16, [200, 7]),
])
def test_flash_kernel_equals_plain_version(cuda, dtype, S, T, Dh, lens):
    from mlis_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    BH = 2 if lens is None else len(lens)
    q, k, v = _attn_inputs(cuda, [(BH, S, Dh), (BH, T, Dh), (BH, T, Dh)], dtype, S + T)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, kv)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, kv)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attention_close(got, want, v, dtype, flash=True)
    if lens is not None:
        for i, n in enumerate(lens):
            if n == 0:
                assert not got[i].float().any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("bias", [None, "per_batch", "per_head"])
def test_dense_kernel_equals_plain_version(cuda, dtype, bias):
    from mlis_tpu_torch.ops.attention import _reference_attention, fused_attention, multi_head_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, T, H, Dh = 3, 530, 530, 4, 64
    q, k, v = _attn_inputs(cuda, [(B, S, H, Dh), (B, T, H, Dh), (B, T, H, Dh)], dtype, 7)
    b = None
    if bias is not None:
        (b,) = _attn_inputs(cuda, [(B, 1 if bias == "per_batch" else H, S, T)], torch.float32, 8)
    before = fused_attention.launches
    got = multi_head_attention(q, k, v, bias=b)
    assert fused_attention.launches == before + 1
    torch.cuda.synchronize()

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, -1, Dh)

    bf = None if b is None else b.expand(B, H, S, T).reshape(B * H, S, T)
    want = _reference_attention(flat(q), flat(k), flat(v), bf).reshape(B, H, S, Dh).permute(0, 2, 1, 3)
    _assert_attention_close(got, want, v, dtype, flash=False)
    if bf is not None:  # the (BH, S, T) bias of fused_attention
        out = fused_attention(flat(q).contiguous(), flat(k).contiguous(), flat(v).contiguous(), bf)
        _assert_attention_close(out, flat(want), v, dtype, flash=False)


def test_dense_kernel_masked_rows(cuda):
    """A -inf mask: masked keys get no weight, a fully masked row is NaN
    (as the TPU kernel's softmax gives)."""
    from mlis_tpu_torch.ops.attention import _reference_attention, fused_attention

    q, k, v = _attn_inputs(cuda, [(2, 70, 32), (2, 90, 32), (2, 90, 32)], torch.bfloat16, 9)
    mask = torch.zeros(2, 70, 90, device=cuda)
    mask[:, :, 60:] = float("-inf")
    mask[1, 5] = float("-inf")
    got = fused_attention(q, k, v, mask)
    want = _reference_attention(q, k, v, mask)
    assert torch.isnan(got[1, 5].float()).all() and not torch.isnan(got[0].float()).any()
    ok = ~torch.isnan(want.float())
    torch.testing.assert_close(got.float()[ok], want.float()[ok], rtol=BF16_RTOL, atol=1e-5)


def test_attention_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from mlis_tpu_torch.ops.attention import fused_attention
    from mlis_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(2, 64, 64, device=cuda, dtype=torch.bfloat16)
    for fn in (flash_attention, fused_attention):
        with pytest.raises(ValueError, match="dtype"):
            fn(q.double(), q.double(), q.double())
        with pytest.raises(ValueError, match="dtype"):
            fn(q, q.float(), q)
        with pytest.raises(ValueError, match="contiguous"):
            fn(q.transpose(1, 2), q, q)
        with pytest.raises(ValueError, match="head width"):
            fn(q[..., :24].contiguous(), q[..., :24].contiguous(), q[..., :24].contiguous())
        with pytest.raises(ValueError, match="is on cpu"):
            fn(q, q.cpu(), q)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, q, q, torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="bias is on cpu"):
        fused_attention(q, q, q, torch.zeros(2, 64, 64))
    with pytest.raises(ValueError, match="bias must be"):
        fused_attention(q, q, q, torch.zeros(2, 64, 63, device=cuda))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Dh", [16, 32, 64])
@pytest.mark.parametrize("S,T", [(1, 1), (17, 17), (530, 530), (1000, 2047), (2047, 1000),
                                 (1, 2047)])
def test_wgmma_kernels_across_shapes(cuda, dtype, Dh, S, T):
    """Both tensor-core kernels at every head width, single rows, ragged
    tiles on both axes, and kv_len 0, 1, T and a draw among the rows."""
    from mlis_tpu_torch.ops.attention import _reference_attention, fused_attention
    from mlis_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    BH = 4
    q, k, v = _attn_inputs(cuda, [(BH, S, Dh), (BH, T, Dh), (BH, T, Dh)], dtype, S + T + Dh)
    lens = [0, 1, T, max(1, (T * 2) // 3)]
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = (flash_attention.launches, fused_attention.launches)
    got_f = flash_attention(q, k, v, kv)
    got_d = fused_attention(q, k, v)
    assert (flash_attention.launches, fused_attention.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    _assert_attention_close(got_f, flash_attention_plain(q, k, v, kv), v, dtype, flash=True)
    _assert_attention_close(got_d, _reference_attention(q, k, v), v, dtype, flash=False)
    assert not got_f[0].float().any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("S", [530, 1370, 1565])
def test_packed_qkv_views_are_read_in_place(cuda, dtype, S):
    """The ViT's q, k, v: slices of one packed (B, S, 3, H, Dh) tensor,
    row stride 3 H Dh. 530 tokens (CricaVPR) go to the dense kernel, 1370
    (AnyLoc) and 1565 (SALAD) to the flash kernel; the output is the
    kernel's contiguous (B, S, H, Dh)."""
    from mlis_tpu_torch.ops.attention import _plain_multi_head, fused_attention, multi_head_attention
    from mlis_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Dh = 2, 3, 64
    (qkv,) = _attn_inputs(cuda, [(B, S, 3, H, Dh)], dtype, S)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert q.stride(1) == 3 * H * Dh and not q.is_contiguous()
    before = (flash_attention.launches, fused_attention.launches)
    got = multi_head_attention(q, k, v)
    flash = S > 1024
    assert (flash_attention.launches, fused_attention.launches) == (
        before[0] + flash, before[1] + (not flash))
    assert got.shape == (B, S, H, Dh) and got.is_contiguous()
    torch.cuda.synchronize()
    if flash:
        flat = [x.permute(0, 2, 1, 3).reshape(B * H, S, Dh).contiguous() for x in (q, k, v)]
        want = flash_attention_plain(*flat).reshape(B, H, S, Dh).permute(0, 2, 1, 3)
    else:
        want = _plain_multi_head(q, k, v, None)
    _assert_attention_close(got, want, v, dtype, flash=flash)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_mha_views_with_a_prefix_mask(cuda, dtype):
    """flash_mha on strided views with a prefix-valid key mask per batch row
    (L = 1100, not a multiple of the 64-key tile or the 128-row block)."""
    from mlis_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain, flash_mha

    B, L, H, Dh = 3, 1100, 2, 64
    (qkv,) = _attn_inputs(cuda, [(B, L, 3, H, Dh)], dtype, 11)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    valid = torch.arange(L, device=cuda)[None, :] < torch.tensor([[L], [700], [0]], device=cuda)
    before = flash_attention.launches
    got = flash_mha(q, k, v, kv_valid=valid)
    assert flash_attention.launches == before + 1 and got.shape == (B, L, H, Dh)
    torch.cuda.synchronize()
    flat = [x.permute(0, 2, 1, 3).reshape(B * H, L, Dh).contiguous() for x in (q, k, v)]
    lens = valid.sum(1, dtype=torch.int32).repeat_interleave(H)
    want = flash_attention_plain(*flat, lens).reshape(B, H, L, Dh).permute(0, 2, 1, 3)
    _assert_attention_close(got, want, v, dtype, flash=True)
    assert not got[2].float().any()


def test_wrappers_raise_on_misaligned_views(cuda):
    """TMA takes 16-byte aligned bases and strides only; the wrappers raise
    instead of copying."""
    from mlis_tpu_torch.ops.attention import multi_head_attention
    from mlis_tpu_torch.ops.flash_attention import flash_mha

    wide = torch.zeros(2, 64, 1, 20, device=cuda, dtype=torch.bfloat16)
    q = wide[..., :16]  # row stride 40 bytes
    ok = torch.zeros(2, 64, 1, 16, device=cuda, dtype=torch.bfloat16)
    shifted = torch.zeros(1 + ok.numel(), device=cuda, dtype=torch.bfloat16)[1:].view(ok.shape)
    for fn in (multi_head_attention, flash_mha):
        with pytest.raises(ValueError, match="multiples of 16 bytes"):
            fn(q, ok, ok)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(ok, shifted, ok)


@pytest.mark.parametrize("method", ["salad", "anyloc"])
def test_full_width_salad_and_anyloc_on_the_flash_kernel(cuda, method):
    """The gate's SALAD (476x644, 1565 tokens) and AnyLoc (518x518, 1370
    tokens) at ViT-B/14 width: one flash launch per block and none of the
    dense kernel, unit descriptors of 8448 / 49152, within a cosine of
    0.999 of the same weights on the CPU (bf16)."""
    from mlis_tpu_torch.gating.place_recognition import _build_vpr
    from mlis_tpu_torch.ops.attention import fused_attention
    from mlis_tpu_torch.ops.flash_attention import flash_attention

    vpr = _build_vpr(method, device="cpu")
    rng = np.random.default_rng(0)
    images = np.kron(rng.integers(0, 255, (2, 34, 45), dtype=np.uint8),
                     np.ones((8, 8), np.uint8))[:, :270, :360]
    want = vpr.encode_batch_device(images)
    vpr.module.to(cuda)
    vpr.device = cuda
    if method == "anyloc":
        vpr.centers = vpr.centers.to(cuda)
    before = (flash_attention.launches, fused_attention.launches)
    got = vpr.encode_batch_device(images)
    assert (flash_attention.launches, fused_attention.launches) == (before[0] + 12, before[1])
    assert got.shape == want.shape == (2, 8448 if method == "salad" else 49152)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(torch.linalg.vector_norm(got, dim=1).cpu(), torch.ones(2))
    assert bool(((got.cpu() * want).sum(1) >= 0.999).all())


def test_vit_plain_attention_switch(cuda):
    """use_kernel=False keeps every block's attention off both kernels;
    the default runs the dense kernel once per block."""
    from mlis_tpu_torch.models.vit import ViT, ViTConfig
    from mlis_tpu_torch.ops.attention import fused_attention
    from mlis_tpu_torch.ops.flash_attention import flash_attention

    cfg = ViTConfig.tiny_test()
    torch.manual_seed(0)
    plain = ViT(cfg, use_kernel=False).to(cuda)
    kernel = ViT(cfg).to(cuda)
    kernel.load_state_dict(plain.state_dict())
    x = torch.rand(2, 112, 112, 3, device=cuda)
    before = (flash_attention.launches, fused_attention.launches)
    with torch.no_grad():
        want = plain(x)
        assert (flash_attention.launches, fused_attention.launches) == before
        got = kernel(x)
    assert (flash_attention.launches, fused_attention.launches) == (before[0],
                                                                    before[1] + cfg.depth)
    # bf16 activations through two blocks: the kernel's and the plain
    # attention round differently, within a few bf16 ulps of the tokens
    torch.testing.assert_close(got["patches"], want["patches"], rtol=2.0**-5, atol=2.0**-5)


def test_tiny_gate_card_matches_cpu(cuda):
    """A tiny random-weight gate, float32 with TF32 off, on both devices."""
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig
    from mlis_tpu_torch.models.resnet import ResNetConfig
    from mlis_tpu_torch.models.superpoint import SuperPointConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    bases = [np.kron(rng.integers(0, 255, (15, 20), dtype=np.uint8), np.ones((8, 8), np.uint8))
             for _ in range(4)]
    images = np.stack([bases[i % 4] for i in range(16)])
    times, floors = np.arange(16) * 30.0, np.asarray([5] * 8 + [2] * 8)
    K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]])
    torch.manual_seed(0)
    lg = LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=64, dtype=torch.float32),
                   matcher_cfg=MatcherConfig.tiny_test(dtype=torch.float32), device="cpu")
    spr = SemanticPlaceRecognition("mixvpr", similarity_threshold=0.5, device="cpu",
                                   backbone_cfg=ResNetConfig.tiny_test(dtype=torch.float32),
                                   input_size=(64, 64), checkpoint=None)
    sp_state, net_state = lg.sp.net.state_dict(), lg.net.state_dict()
    vpr_state = spr.vpr.module.state_dict()
    results = {}
    for dev in ("cpu", cuda):
        m = LightGlue(sp_cfg=lg.sp.cfg, matcher_cfg=lg.cfg, device=dev)
        m.sp.load_state(sp_state)
        m.net.load_state_dict(net_state)
        s = SemanticPlaceRecognition("mixvpr", similarity_threshold=0.5, device=dev,
                                     backbone_cfg=ResNetConfig.tiny_test(dtype=torch.float32),
                                     input_size=(64, 64), checkpoint=None)
        s.vpr.load_state(vpr_state)
        pipe = FullGatePipeline(vpr=s, verifier=GeometricVerifier(matcher=m),
                                similarity_threshold=0.5, verify_batch=8,
                                matcher_weights=None, device=dev)
        probe = pipe.process(images, times, floors, K, verify=False)
        u = torch.rand((probe.total_pairs - probe.cross_floor_rejected, 512, 8),
                       generator=torch.Generator().manual_seed(1))
        results[str(dev)] = pipe.process(images, times, floors, K, ransac_uniforms=u)
    a, b = results["cuda"], results["cpu"]
    assert (a.total_pairs, a.cross_floor_rejected) == (b.total_pairs, b.cross_floor_rejected)
    assert [(r.query_idx, r.match_idx) for r in a.results] == [
        (r.query_idx, r.match_idx) for r in b.results]
    for ra, rb in zip(a.results, b.results):
        assert ra.num_matches == rb.num_matches
        # float32 on two devices: an inlier at the Sampson threshold may flip
        assert abs(ra.num_inliers - rb.num_inliers) <= 3


# the two benchmarked gates: (keyframe size, VPR method, its checkpoint and
# settings, detected / matched keypoints, the matcher's checkpoint)
NAMED_WAIT_GATES = {
    "crica_lg512": ((270, 360), "cricavpr", "vpr_crica.npz",
                    dict(input_size=(322, 322), descriptor_dim=10752),
                    1024, 512, "lightglue_homog_sp.npz"),
    "fullres_mixvpr_lg2048": ((540, 720), "mixvpr", "vpr_mixvpr.npz",
                              dict(input_size=(320, 320), descriptor_dim=4096),
                              2048, None, "lightglue_homog_sp_fullres.npz"),
}


def _named_wait_gate(config, device):
    from mlis_tpu_torch.gating.full_gate import FullGatePipeline
    from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
    from mlis_tpu_torch.gating.verification import GeometricVerifier
    from mlis_tpu_torch.models.lightglue import LightGlue
    from mlis_tpu_torch.models.resnet import ResNetConfig
    from mlis_tpu_torch.models.superpoint import SuperPointConfig
    from mlis_tpu_torch.models.vit import ViTConfig
    from mlis_tpu_torch.weights import shipped_checkpoint

    hw, method, vpr_ckpt, vpr_kw, max_kp, match_top_k, matcher_ckpt = NAMED_WAIT_GATES[config]
    ckpts = [shipped_checkpoint(matcher_ckpt), shipped_checkpoint(vpr_ckpt)]
    if None in ckpts:
        pytest.skip(f"needs checkpoints/{matcher_ckpt} and checkpoints/{vpr_ckpt}")
    bf16 = torch.bfloat16
    matcher = LightGlue.from_checkpoint(
        ckpts[0], sp_cfg=SuperPointConfig(max_keypoints=max_kp, dtype=bf16), dtype=bf16,
        device=device)
    if method == "mixvpr":
        vpr_kw = dict(vpr_kw, backbone_cfg=ResNetConfig(crop_stage=3, dtype=bf16))
    else:
        vpr_kw = dict(vpr_kw, vit_cfg=ViTConfig.dinov2_vitb14(dtype=bf16))
    spr = SemanticPlaceRecognition(method, similarity_threshold=0.3, min_time_gap=10.0,
                                   device=device, checkpoint=ckpts[1], **vpr_kw)
    verifier = GeometricVerifier(matcher=matcher, min_inliers=20, min_inlier_ratio=0.25,
                                 ransac_threshold=3.0)
    pipe = FullGatePipeline(vpr=spr, verifier=verifier, top_k=10, similarity_threshold=0.3,
                            min_time_gap=10.0, verify_batch=256, strict_floor=True,
                            match_top_k=match_top_k, matcher_weights=None,
                            num_hypotheses=512, device=device)
    return pipe, hw


@pytest.mark.parametrize("config", sorted(NAMED_WAIT_GATES))
def test_every_host_wait_of_the_gate_is_named(cuda, config, monkeypatch):
    """One exact-path call of each benchmarked gate (CricaVPR + LightGlue at
    512 keypoints, 270x360; MixVPR + LightGlue at 2,048, 540x720) on a
    two-floor v2 quality scene of 128 host keyframes, under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronisation the
    card reports happens inside a ``sync.*`` range, and every ``sync.*``
    range holds one, but the explicit synchronize after encoding where the
    mode does not report it. Prints the count by site."""
    import json
    import os
    import traceback
    import warnings
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from mlis_tpu_torch.eval.quality import make_quality_scene_v2
    from mlis_tpu_torch.utils import profiling

    pipe, hw = _named_wait_gate(config, cuda)
    scene = make_quality_scene_v2(n_floors=2, n_places=32, hw=hw, seed=3, device=cuda)

    def call():
        return pipe.process(scene.images, scene.timestamps, scene.floors, scene.K,
                            encode_batch_size=64,
                            generator=torch.Generator(device=cuda).manual_seed(1))

    stack, closed, syncs, unnamed = [], [], [], []
    real = profiling.record_function

    class Recorded:
        """The profiler's range, with the syncs reported while it is innermost."""

        def __init__(self, name):
            self.name, self.inner, self.held = name, real(name), 0

        def __enter__(self):
            stack.append(self)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            stack.pop()
            closed.append((self.name, self.held))
            return self.inner.__exit__(*exc)

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            inner = stack[-1] if stack else None
            syncs.append((f"{os.path.relpath(filename)}:{lineno}", inner and inner.name))
            if inner is not None:
                inner.held += 1
            if not (inner and inner.name.startswith("sync.")):
                unnamed.append("".join(traceback.format_stack(limit=8)[:-1]))

    with torch.inference_mode():
        call()  # the fused matcher, the kernel library and the library plans
        torch.cuda.synchronize()
        monkeypatch.setattr(profiling, "record_function", Recorded)
        with profile(activities=[ProfilerActivity.CPU]), warnings.catch_warnings():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")  # may warn itself, before the call
            warnings.showwarning = seen
            try:
                res = call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    spans = [(name, held) for name, held in closed if name.startswith("sync.")]
    report = {"config": config, "verified": res.verified, "syncs": len(syncs),
              "sync_spans": len(spans),
              "by_span": dict(Counter(name for name, _ in spans).most_common()),
              "held_by_span": dict(Counter(name for _, name in syncs).most_common()),
              "by_line": dict(Counter(site for site, _ in syncs).most_common())}
    print(json.dumps(report))
    assert res.verified > 0
    assert not unnamed, "\n".join(unnamed)
    empty = [name for name, held in spans if held == 0 and name != "sync.detect_encode"]
    assert not empty, report
