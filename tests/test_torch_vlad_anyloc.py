"""The port's VLAD (ops/pooling.vlad_aggregate) and AnyLoc
(models/anyloc.py) against mlis_tpu's on the same inputs: assignments
identical except where the two nearest centres lie within 1e-5 relative of
each other, descriptors within 1e-5 (VLAD) and 1e-4 (AnyLoc, float32
configs), cosine >= 0.999 with bf16 ViTs; the trained AnyLoc row's
encoder on shipped weights."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models.anyloc import AnyLoc as JaxAnyLoc  # noqa: E402
from mlis_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from mlis_tpu.ops import pooling as jpool  # noqa: E402
from mlis_tpu.train.pretrain_vpr import load_encoder as jax_load_encoder  # noqa: E402

from mlis_tpu_torch.models.anyloc import AnyLoc, kmeans_step  # noqa: E402
from mlis_tpu_torch.models.vit import ViTConfig  # noqa: E402
from mlis_tpu_torch.ops import pooling as tpool  # noqa: E402
from mlis_tpu_torch.train.pretrain_vpr import load_encoder  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_vpr  # noqa: E402

TINY_HW = (56, 70)  # a 4x5 patch grid from the tiny ViT's 8x8 table
TIE_REL = 1e-5  # the assignment rule's near-tie band


def _tokens(seed, B=2, N=300, D=64, K=16):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(K, D)).astype(np.float32)
    x = (c[rng.integers(0, K, (B, N))] + 0.8 * rng.normal(size=(B, N, D))).astype(np.float32)
    x[0, :3] = 0.5 * (c[0] + c[1])  # equidistant from two centres
    x[1, 0] = c[5]  # on a centre
    return x, c


def _jax_assign(x, c):
    """mlis_tpu's VLAD assignment: the first argmin of x^2 - 2 x.c + c^2."""
    xj, cj = jnp.asarray(x), jnp.asarray(c)
    xc = jnp.einsum("bnd,kd->bnk", xj, cj)
    d2 = jnp.sum(xj**2, -1, keepdims=True) - 2 * xc + jnp.sum(cj**2, -1)
    return np.asarray(jnp.argmin(d2, -1))


@pytest.mark.parametrize("seed", [0, 1])
def test_vlad_assignments_and_descriptors(seed):
    x, c = _tokens(seed)
    got_a = tpool.nearest_center(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    want_a = _jax_assign(x, c)
    d = np.sort(((x[..., None, :].astype(np.float64) - c.astype(np.float64)) ** 2).sum(-1), -1)
    near_tie = (d[..., 1] - d[..., 0]) <= TIE_REL * d[..., 1]
    assert ((got_a == want_a) | near_tie).all()
    assert near_tie.sum() < 10 and (got_a == want_a).mean() > 0.99
    want = np.asarray(jpool.vlad_aggregate(jnp.asarray(x), jnp.asarray(c)))
    got = tpool.vlad_aggregate(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert got.shape == want.shape == (2, 16 * 64)
    if (got_a == want_a).all():
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_vlad_empty_clusters_and_bf16_tokens():
    x, c = _tokens(2, N=5, K=32)  # most centres get no token: their block stays zero
    want = np.asarray(jpool.vlad_aggregate(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(c)))
    got = tpool.vlad_aggregate(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got.reshape(2, 32, 64) == 0).all(-1).sum() >= 2 * (32 - 5)


def _tiny_pair(dtype, aggregation="vlad", seed=0):
    # LayerScale at 0.5 instead of 1e-5, so that the blocks move the tokens
    ref = JaxAnyLoc(seed=seed, num_clusters=8, aggregation=aggregation, input_size=TINY_HW,
                    vit_cfg=JaxViTConfig.tiny_test(dtype=dtype[0], layerscale_init=0.5))
    port = AnyLoc(num_clusters=8, aggregation=aggregation, input_size=TINY_HW,
                  vit_cfg=ViTConfig.tiny_test(dtype=dtype[1]), device="cpu")
    return ref, carry_jax_vpr(port, jax.device_get(ref.params), centers=np.asarray(ref.centers))


def _frames(seed, n=4):
    rng = np.random.default_rng(seed)
    return np.kron(rng.integers(0, 255, (n, 8, 10), dtype=np.uint8), np.ones((8, 8), np.uint8))


@pytest.mark.parametrize("aggregation", ["vlad", "gap"])
def test_tiny_anyloc_float32(aggregation):
    ref, port = _tiny_pair((jnp.float32, torch.float32), aggregation)
    imgs = _frames(3)
    want = np.asarray(ref.encode_batch(imgs))
    got = port.encode_batch(imgs)
    assert got.shape == want.shape == (4, 8 * 64 if aggregation == "vlad" else 64)
    assert port.descriptor_dim == ref.descriptor_dim
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_tiny_anyloc_bf16_and_fit_vocabulary():
    ref, port = _tiny_pair((jnp.bfloat16, torch.bfloat16))
    imgs = _frames(4)
    want = np.asarray(ref.encode_batch(imgs))
    got = port.encode_batch(imgs)
    assert ((got * want).sum(1) >= 0.999).all()
    # k-means from the same vocabulary on the same float32 features: the
    # reference's random centres leave most clusters empty, which keep theirs
    ref32, port32 = _tiny_pair((jnp.float32, torch.float32))
    ref32.fit_vocabulary(imgs, iters=3)
    port32.fit_vocabulary(imgs, iters=3)
    np.testing.assert_allclose(port32.centers.numpy(), np.asarray(ref32.centers), atol=1e-4, rtol=0)
    moved = np.abs(port32.centers.numpy() - np.asarray(_tiny_pair((jnp.float32, torch.float32))[1]
                                                      .centers.numpy())).max(1) > 0
    assert 0 < moved.sum() < 8


def test_kmeans_step_keeps_empty_clusters():
    f = torch.tensor([[0.0, 0.0], [0.0, 1.0], [10.0, 10.0]])
    c = torch.tensor([[0.0, 0.4], [10.0, 9.0], [-50.0, -50.0]])
    np.testing.assert_allclose(kmeans_step(c, f).numpy(),
                               [[0.0, 0.5], [10.0, 10.0], [-50.0, -50.0]])


def test_random_init_is_seeded_and_leaves_the_global_rng():
    cfg = ViTConfig.tiny_test(dtype=torch.float32)
    state = torch.random.get_rng_state()
    a = AnyLoc(seed=3, num_clusters=4, vit_cfg=cfg, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    b = AnyLoc(seed=3, num_clusters=4, vit_cfg=cfg, device="cpu")
    c = AnyLoc(seed=4, num_clusters=4, vit_cfg=cfg, device="cpu")
    for (name, pa), pb, pc in zip(a.module.state_dict().items(), b.module.state_dict().values(),
                                  c.module.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.module.pos_embed, c.module.pos_embed)
    assert torch.equal(a.centers, torch.randn((4, 64), generator=torch.Generator().manual_seed(4)))
    assert a.input_size == (518, 518) and a.descriptor_dim == 4 * 64
    # flax's defaults: zero biases, LayerScale at its init, lecun-normal kernels
    assert not a.module.block0.attn.qkv.bias.any()
    assert (a.module.block0.ls1.gamma == cfg.layerscale_init).all()
    w = a.module.block1.mlp.fc2.weight.detach()  # fan-in 256
    assert abs(float(w.std()) - 256**-0.5) < 0.1 * 256**-0.5
    assert float(w.abs().max()) <= 2 * 256**-0.5 / 0.87962566103423978 + 1e-6


def _float32_tiny_configs(mp):
    """Both packages' tiny ViT config in float32 (the loaders build it
    through ``ViTConfig.tiny_test``)."""
    import mlis_tpu.models.vit as jvit

    from mlis_tpu_torch.models import vit as tvit

    jtiny, ttiny = jvit.ViTConfig.tiny_test, tvit.ViTConfig.tiny_test
    mp.setattr(jvit.ViTConfig, "tiny_test", staticmethod(lambda **kw: jtiny(
        **{"dtype": jnp.float32, **kw})))
    mp.setattr(tvit.ViTConfig, "tiny_test", staticmethod(lambda **kw: ttiny(
        **{"dtype": torch.float32, **kw})))


def test_trained_anyloc_encoder_matches_jax():
    """The anyloc row's encoder, vpr_anyloc.npz (the parallax-trained tiny
    ViT and its fitted 64-word vocabulary), in both packages with float32
    ViTs. (With the shipped bf16 ViT, tokens summed in another order move
    some patches across a near tie, and descriptors differ by up to a few
    percent; tests/test_torch_quality.py holds that row's retrieval
    recall instead.)"""
    frames = np.kron(np.random.default_rng(5).integers(0, 255, (6, 17, 23), dtype=np.uint8),
                     np.ones((8, 8), np.uint8))[:, :135, :180]
    with pytest.MonkeyPatch.context() as mp:
        _float32_tiny_configs(mp)
        want = np.asarray(jax_load_encoder(arch="anyloc")(jnp.asarray(frames)))
        got = load_encoder(arch="anyloc", device="cpu")(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (6, 64 * 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert load_encoder("checkpoints/no_such.npz", arch="anyloc", device="cpu") is None
