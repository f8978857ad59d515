"""The port's SALAD (models/salad.py) against mlis_tpu's on the same
inputs: the head on random tokens, tiny encoders with the flax parameters
carried across (descriptors within 1e-4 with float32 ViTs, cosine >= 0.999
in bf16), the trained SALAD row's encoder on vpr_salad.npz, and the
random initialisation's seeding and distributions."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models.salad import SALAD as JaxSALAD  # noqa: E402
from mlis_tpu.models.salad import SALADHead as JaxHead  # noqa: E402
from mlis_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from mlis_tpu.train.pretrain_vpr import load_encoder as jax_load_encoder  # noqa: E402

from mlis_tpu_torch.models.salad import SALAD, SALADHead  # noqa: E402
from mlis_tpu_torch.models.vit import ViTConfig  # noqa: E402
from mlis_tpu_torch.train.pretrain_vpr import load_encoder, small_salad_vit  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_vpr, from_jax_params  # noqa: E402

TINY_HW = (56, 70)
SMALL = dict(num_clusters=4, cluster_dim=16, token_dim=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_matches_flax(dtype):
    """Score and feature MLPs, the dustbin column, 3 Sinkhorn iterations,
    float32 aggregation and the token branch, on the same tokens."""
    rng = np.random.default_rng(0)
    patches = rng.normal(size=(3, 20, 48)).astype(np.float32)
    cls = rng.normal(size=(3, 48)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JaxHead(**SMALL, dtype=jdt)
    params = ref.init(jax.random.PRNGKey(1), jnp.asarray(patches), jnp.asarray(cls))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["dustbin"] = np.float32(0.3)  # away from its init, to see it carried
    want = np.asarray(ref.apply(params, jnp.asarray(patches), jnp.asarray(cls)))
    head = SALADHead(48, **SMALL, dtype=tdt)
    head.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(patches), torch.from_numpy(cls)).numpy()
    assert got.shape == want.shape == (3, 4 * 16 + 32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:  # bf16 Dense layers summed in another order
        assert ((got * want).sum(1) >= 0.999).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def _frames(seed, n=3):
    rng = np.random.default_rng(seed)
    return np.kron(rng.integers(0, 255, (n, 8, 10), dtype=np.uint8), np.ones((8, 8), np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_salad_encoder(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # LayerScale at 0.5 instead of 1e-5, so that the blocks move the tokens
    ref = JaxSALAD(vit_cfg=JaxViTConfig.tiny_test(dtype=jdt, layerscale_init=0.5),
                   input_size=TINY_HW, **SMALL)
    port = carry_jax_vpr(SALAD(vit_cfg=ViTConfig.tiny_test(dtype=tdt), input_size=TINY_HW,
                               device="cpu", **SMALL), jax.device_get(ref.params))
    imgs = _frames(1)
    want = np.asarray(ref.encode_batch(imgs))
    got = port.encode_batch(imgs)
    assert got.shape == want.shape == (3, 96) and port.descriptor_dim == ref.descriptor_dim
    if dtype == "float32":  # the head computes in bf16 in both packages
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert ((got * want).sum(1) >= 0.999).all()
    # a declared descriptor slot wider than the native 96: zero-padded
    wide = SALAD(descriptor_dim=128, vit_cfg=ViTConfig.tiny_test(dtype=tdt), input_size=TINY_HW,
                 device="cpu", **SMALL)
    assert wide.encode_batch(imgs).shape == (3, 128)


def test_trained_salad_encoder_matches_jax():
    """The salad row's encoder: the SALAD head (16 x 32 + 64) on the small
    trained ViT, vpr_salad.npz, bf16 as shipped in both packages."""
    frames = np.kron(np.random.default_rng(2).integers(0, 255, (6, 17, 23), dtype=np.uint8),
                     np.ones((8, 8), np.uint8))[:, :135, :180]
    want = np.asarray(jax_load_encoder(arch="salad")(jnp.asarray(frames)))
    got = load_encoder(arch="salad", device="cpu")(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (6, 16 * 32 + 64)
    # soft assignment: bf16 sums in another order move the descriptor smoothly
    assert ((got * want).sum(1) >= 0.999).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert small_salad_vit() == ViTConfig(dim=128, depth=4, num_heads=4, patch_size=8,
                                          pos_grid=12)
    assert load_encoder("checkpoints/no_such.npz", arch="salad", device="cpu") is None


def test_random_init_is_seeded_with_flax_distributions():
    cfg = ViTConfig.tiny_test(dtype=torch.float32)
    state = torch.random.get_rng_state()
    a = SALAD(seed=7, vit_cfg=cfg, device="cpu", **SMALL)
    assert torch.equal(torch.random.get_rng_state(), state)
    b = SALAD(seed=7, vit_cfg=cfg, device="cpu", **SMALL)
    for (name, pa), pb in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(pa, pb), name
    head = a.module.head
    assert head.dustbin.item() == 1.0 and not head.score_proj.bias.any()
    w = head.feat_hidden.weight.detach()  # fan-in 64
    assert abs(float(w.std()) - 64**-0.5) < 0.1 * 64**-0.5
    assert float(w.abs().max()) <= 2 * 64**-0.5 / 0.87962566103423978 + 1e-6
    assert SALAD.input_size == (476, 644)  # the gate's SALAD: 34x46 patches + cls
