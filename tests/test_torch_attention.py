"""The port's attention layer (ops/attention.py, ops/flash_attention.py)
against mlis_tpu's on the CPU. The JAX side runs its Pallas kernels in
interpret mode (K4/K5 through ``fused_attention(use_pallas=True)``, K2
through ``flash_attention``); the port runs its plain versions, which are
what its CUDA kernels are held against on the card."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.ops import attention as jatt  # noqa: E402
from mlis_tpu.ops import flash_attention as jflash  # noqa: E402

from mlis_tpu_torch.ops import attention as tatt  # noqa: E402
from mlis_tpu_torch.ops import flash_attention as tflash  # noqa: E402

# float32 on both sides; the sums run in another order (and the JAX flash
# kernel rescales an online softmax), so agreement is to float32 rounding
F32_ATOL = 3e-5
# bf16 outputs of float32 arithmetic: a sum that differs in its last float32
# bits may round to the neighbouring bf16 value, one bf16 ulp (2^-8 relative)
BF16_RTOL = 2.0**-8


def _np(rng, shape, dtype=np.float32):
    return rng.normal(size=shape).astype(dtype)


def _to_jax(a, bf16):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if bf16 else x


def _to_torch(a, bf16):
    x = torch.from_numpy(a)
    return x.to(torch.bfloat16) if bf16 else x


def _close(got: torch.Tensor, want, bf16: bool):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if bf16:
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(g, w, atol=F32_ATOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("bias", [None, "per_batch", "per_head"])
def test_dense_matches_pallas_kernels(bias, bf16):
    """K4 (no bias) and K5 (bias broadcast from (B, 1, S, T) or given per
    head) through multi_head_attention and fused_attention."""
    rng = np.random.default_rng(0)
    B, S, T, H, Dh = 2, 37, 45, 3, 16
    q, k, v = _np(rng, (B, S, H, Dh)), _np(rng, (B, T, H, Dh)), _np(rng, (B, T, H, Dh))
    b = None
    if bias is not None:
        b = _np(rng, (B, 1 if bias == "per_batch" else H, S, T))
    jb = None if b is None else jnp.asarray(b)
    want = jatt.multi_head_attention(*(_to_jax(a, bf16) for a in (q, k, v)), bias=jb,
                                     use_pallas=True)
    tb = None if b is None else torch.from_numpy(b)
    got = tatt.multi_head_attention(*(_to_torch(a, bf16) for a in (q, k, v)), bias=tb)
    assert got.shape == (B, S, H, Dh) and got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _close(got, want, bf16)

    # the (BH, S, Dh) entry point with a (BH, S, T) bias
    flat = [a.transpose(0, 2, 1, 3).reshape(B * H, -1, Dh) for a in (q, k, v)]
    bf = None if b is None else np.broadcast_to(b, (B, H, S, T)).reshape(B * H, S, T).copy()
    want = jatt.fused_attention(*(_to_jax(a, bf16) for a in flat),
                                None if bf is None else jnp.asarray(bf), use_pallas=True)
    got = tatt.fused_attention(*(_to_torch(a, bf16) for a in flat),
                               None if bf is None else torch.from_numpy(bf))
    _close(got, want, bf16)


def test_dense_masking_bias_and_long_biased_problem():
    """A -inf mask bias (fully masked rows give NaN in both), and a biased
    problem above the 4 MiB score budget, which both packages run densely."""
    rng = np.random.default_rng(1)
    q, k, v = _np(rng, (1, 6, 2, 8)), _np(rng, (1, 9, 2, 8)), _np(rng, (1, 9, 2, 8))
    mask = np.zeros((1, 2, 6, 9), np.float32)
    mask[:, :, :, 5:] = -np.inf
    mask[:, 1, 2, :] = -np.inf  # one fully masked row
    want = np.asarray(jatt.multi_head_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                                bias=jnp.asarray(mask), use_pallas=True))
    got = tatt.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    bias=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0, 2, 1]).all() and np.isfinite(got[0, :, 0]).all()
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), atol=F32_ATOL)

    S = T = 1040  # S * T * 4 B > 4 MiB
    q, k, v = _np(rng, (1, S, 1, 16)), _np(rng, (1, T, 1, 16)), _np(rng, (1, T, 1, 16))
    b = _np(rng, (1, 1, S, T))
    want = jatt.multi_head_attention(*(jnp.asarray(a) for a in (q, k, v, b)))
    got = tatt.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v, b)))
    _close(got, want, False)


@pytest.mark.parametrize("bf16", [False, True])
def test_long_unbiased_sequences_dispatch_to_flash(monkeypatch, bf16):
    """Above the 4 MiB score budget an unbiased problem goes to flash_mha,
    as mlis_tpu's multi_head_attention does with its Pallas kernels."""
    rng = np.random.default_rng(2)
    B, S, H, Dh = 1, 1100, 2, 16
    q, k, v = (_np(rng, (B, S, H, Dh)) for _ in range(3))
    calls = []
    real = tatt.flash_mha

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tatt, "flash_mha", spy)
    got = tatt.multi_head_attention(*(_to_torch(a, bf16) for a in (q, k, v)))
    assert calls == [(B, S, H, Dh)]
    want = jatt.multi_head_attention(*(_to_jax(a, bf16) for a in (q, k, v)), use_pallas=True)
    if bf16:
        # p is cast to bf16 before the p v product on both sides; a p that
        # differs in its last float32 bits may round to the other bf16
        # neighbour, so allow two bf16 ulps of the output
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2 * BF16_RTOL, atol=1e-3)
    else:
        _close(got, want, False)
    # short sequences stay on the dense path
    calls.clear()
    tatt.multi_head_attention(*(torch.from_numpy(a[:, :64]) for a in (q, k, v)))
    assert calls == []


def _flash_pair(q, k, v, kv_len=None, block_q=64):
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  None if kv_len is None else jnp.asarray(kv_len), block_q=block_q)
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 None if kv_len is None else torch.from_numpy(kv_len))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("S,T,Dh,kv_len", [
    (300, 600, 32, None),  # tests/test_flash_attention.py's ragged case
    (64, 512, 16, [100, 512]),  # kv_len masking
    (130, 70, 16, None),  # shapes that are not block multiples
    (40, 70, 8, [70, 1, 0, 33]),  # empty and single-key rows
])
def test_flash_matches_pallas_kernel(S, T, Dh, kv_len):
    rng = np.random.default_rng(S + T)
    BH = 2 if kv_len is None else len(kv_len)
    q, k, v = _np(rng, (BH, S, Dh)), _np(rng, (BH, T, Dh)), _np(rng, (BH, T, Dh))
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)
    got, want = _flash_pair(q, k, v, lens)
    assert got.shape == (BH, S, Dh)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    if lens is not None:
        for i, n in enumerate(lens):
            if n == 0:  # a row with no valid key is zeros, not NaN
                assert np.isfinite(got[i]).all() and not got[i].any()
            else:
                ref = tatt._reference_attention(torch.from_numpy(q[i : i + 1]),
                                                torch.from_numpy(k[i : i + 1, :n]),
                                                torch.from_numpy(v[i : i + 1, :n]))
                np.testing.assert_allclose(got[i], ref[0].numpy(), atol=F32_ATOL)


def test_flash_bf16_operands():
    """bf16 inputs: bf16 q k^T and p v operands, float32 accumulation."""
    rng = np.random.default_rng(3)
    q, k, v = _np(rng, (3, 96, 32)), _np(rng, (3, 200, 32)), _np(rng, (3, 200, 32))
    lens = np.array([200, 77, 0], np.int32)
    want = np.asarray(jflash.flash_attention(*(_to_jax(a, True) for a in (q, k, v)),
                                             jnp.asarray(lens), block_q=32), np.float32)
    got = tflash.flash_attention(*(_to_torch(a, True) for a in (q, k, v)), torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    # two bf16 ulps: p rounds to bf16 before p v on both sides (see above)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 * BF16_RTOL, atol=1e-3)
    assert not got[2].float().any()


def test_flash_mha_prefix_mask():
    rng = np.random.default_rng(4)
    B, S, H, Dh = 2, 40, 2, 8
    q = _np(rng, (B, S, H, Dh))
    valid = np.stack([np.ones(S), np.r_[np.ones(25), np.zeros(15)]]).astype(bool)
    want = np.asarray(jflash.flash_mha(*(jnp.asarray(q),) * 3, kv_valid=jnp.asarray(valid)))
    t = torch.from_numpy(q)
    got = tflash.flash_mha(t, t, t, kv_valid=torch.from_numpy(valid)).numpy()
    assert got.shape == (B, S, H, Dh)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    # batch 1 ignores keys >= 25
    ref = tflash.flash_mha(t[1:], t[1:, :25], t[1:, :25]).numpy()
    np.testing.assert_allclose(got[1], ref[0], atol=F32_ATOL)


def test_single_block_size_against_truncated_reference():
    """K3's case, S = T = 1280 (1024^2 < S8 * T128 <= 2M): the Pallas
    single-block kernel has no interpret mode, so the plain flash version is
    held against dense attention over each row's first kv_len keys."""
    rng = np.random.default_rng(5)
    S = T = 1280
    q, k, v = _np(rng, (3, S, 16)), _np(rng, (3, T, 16)), _np(rng, (3, T, 16))
    lens = np.array([1280, 700, 1], np.int32)
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(lens))
    for i, n in enumerate(lens):
        want = jatt._reference_attention(jnp.asarray(q[i : i + 1]), jnp.asarray(k[i : i + 1, :n]),
                                         jnp.asarray(v[i : i + 1, :n]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[0]), atol=F32_ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(v[2, :1], (S, 16)), atol=1e-6)


def test_plain_versions_work_in_slices(monkeypatch):
    """The plain versions slice the bh axis to bound their float32 scores;
    the slicing does not change the result."""
    rng = np.random.default_rng(6)
    q, k, v = _np(rng, (5, 33, 16)), _np(rng, (5, 41, 16)), _np(rng, (5, 41, 16))
    b = _np(rng, (5, 33, 41))
    lens = torch.tensor([41, 0, 7, 41, 2], dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    whole_f = tflash.flash_attention_plain(*args, lens)
    whole_d = tatt._reference_attention(*args, torch.from_numpy(b))
    monkeypatch.setattr(tflash, "PLAIN_SCORE_BYTES", 2 * 33 * 41 * 4)
    assert len(tflash.bh_slices(5, 33, 41)) == 3
    torch.testing.assert_close(tflash.flash_attention_plain(*args, lens), whole_f, rtol=0, atol=0)
    torch.testing.assert_close(tatt._reference_attention(*args, torch.from_numpy(b)), whole_d,
                               rtol=0, atol=0)


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no path"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no path"):
        tatt.fused_attention(q, q, q)


@pytest.mark.parametrize("bf16", [False, True])
def test_packed_qkv_slices_through_multi_head_attention(bf16):
    """The ViT's inputs: q, k, v as strided slices of one packed
    (B, S, 3, H, Dh) qkv (row stride 3 H Dh), S = 70 (not a multiple of the
    kernels' 64-key tile or 128-row block); the output is (B, S, H, Dh)."""
    rng = np.random.default_rng(7)
    B, S, H, Dh = 2, 70, 3, 16
    qkv = _np(rng, (B, S, 3, H, Dh))
    jq = _to_jax(qkv, bf16)
    want = jatt.multi_head_attention(jq[:, :, 0], jq[:, :, 1], jq[:, :, 2], use_pallas=True)
    tq = _to_torch(qkv, bf16)
    q, k, v = tq[:, :, 0], tq[:, :, 1], tq[:, :, 2]
    assert q.stride(1) == 3 * H * Dh and not q.is_contiguous()
    got = tatt.multi_head_attention(q, k, v)
    assert got.shape == (B, S, H, Dh)
    if bf16:
        # one bf16 ulp is up to 2^-7 of a value just above a power of two
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2.0**-7, atol=1e-6)
    else:
        _close(got, want, False)


def test_flash_mha_strided_views_with_prefix_mask():
    """flash_mha on packed-qkv slices with a prefix-valid key mask per batch
    row (150 keys, 97 and none valid), against the Pallas flash kernel."""
    rng = np.random.default_rng(8)
    B, L, H, Dh = 3, 150, 2, 16
    qkv = _np(rng, (B, L, 3, H, Dh))
    valid = np.arange(L)[None, :] < np.array([[L], [97], [0]])
    jq = jnp.asarray(qkv)
    want = np.asarray(jflash.flash_mha(jq[:, :, 0], jq[:, :, 1], jq[:, :, 2],
                                       kv_valid=jnp.asarray(valid)))
    tq = torch.from_numpy(qkv)
    got = tflash.flash_mha(tq[:, :, 0], tq[:, :, 1], tq[:, :, 2],
                           kv_valid=torch.from_numpy(valid)).numpy()
    assert got.shape == (B, L, H, Dh)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    assert not got[2].any()


def test_use_kernel_false_runs_the_plain_version(monkeypatch):
    """use_kernel=False mirrors the reference's use_pallas=False: the plain
    attention at every size, a long unbiased problem included (no dispatch
    to flash)."""
    rng = np.random.default_rng(9)
    B, S, H, Dh = 1, 1100, 2, 16
    q, k, v = (_np(rng, (B, S, H, Dh)) for _ in range(3))
    calls = []
    monkeypatch.setattr(tatt, "flash_mha", lambda *a, **kw: calls.append(1))
    got = tatt.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), use_kernel=False)
    assert calls == []
    want = jatt.multi_head_attention(*(jnp.asarray(a) for a in (q, k, v)), use_pallas=False)
    _close(got, want, False)
