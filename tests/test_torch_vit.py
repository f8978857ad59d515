"""The port's ViT (models/vit.py) against mlis_tpu's, float32, with the
flax parameters carried across by mlis_tpu_torch.weights.from_jax_params."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import vit as jvit  # noqa: E402

from mlis_tpu_torch.models import vit as tvit  # noqa: E402
from mlis_tpu_torch.weights import from_jax_params  # noqa: E402


@pytest.mark.parametrize("n_reg,hw", [(0, (112, 112)), (0, (98, 126)), (4, (98, 112))])
def test_vit_tokens_match_flax(n_reg, hw):
    """cls, register and patch tokens of the tiny ViT; (98, 126) and
    (98, 112) take the position table from its 8x8 grid to 7x9 and 7x8."""
    rng = np.random.default_rng(n_reg + hw[1])
    # LayerScale at 0.5 instead of 1e-5, so that the blocks move the tokens
    cfg = jvit.ViTConfig.tiny_test(dtype=jnp.float32, num_register_tokens=n_reg,
                                   layerscale_init=0.5)
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    ref = jvit.ViT(cfg)
    params = ref.init(jax.random.PRNGKey(n_reg), jnp.asarray(x))
    want = ref.apply(params, jnp.asarray(x))

    port = tvit.ViT(tvit.ViTConfig.tiny_test(dtype=torch.float32, num_register_tokens=n_reg))
    port.load_state_dict(from_jax_params(jax.device_get(params)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got["grid"] == want["grid"] == (hw[0] // 14, hw[1] // 14)
    for key in ("cls", "registers", "patches"):
        assert tuple(got[key].shape) == want[key].shape and got[key].dtype == torch.float32
        # float32 through two blocks: sums in another order, 1e-6 relative
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5)


def test_interpolate_pos_embed_cricavpr_grid():
    """CricaVPR's case: DINOv2's 37x37 table resampled to 23x23 (322 px).
    jax.image.resize antialiases a downsampling bicubic with the Keys
    kernel (a = -0.5); the port builds those weights in float64."""
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(1, 37 * 37, 32)).astype(np.float32)
    want = np.asarray(jvit._interpolate_pos_embed(jnp.asarray(pos), (23, 23)))
    got = tvit._interpolate_pos_embed(torch.from_numpy(pos), (23, 23)).numpy()
    w = tvit.resample_weights(37, 23)
    exact = np.einsum("hi,wj,ijd->hwd", w, w, pos.reshape(37, 37, 32).astype(np.float64))
    # the port is within float32 rounding of the float64 resampling; JAX's
    # float32 weights put it up to ~3.4e-6 away from it at this size
    np.testing.assert_allclose(got, exact.reshape(1, -1, 32), atol=1e-6)
    np.testing.assert_allclose(got, want, atol=5e-6)
    np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-12)
    table = torch.from_numpy(pos)
    assert tvit._interpolate_pos_embed(table, (37, 37)) is table  # the pretrain grid


@pytest.mark.parametrize("grid", [(12, 12), (8, 11), (5, 3)])
def test_interpolate_pos_embed_other_grids(grid):
    """Up-, mixed and strong downsampling of an 8x8 table."""
    rng = np.random.default_rng(grid[0])
    pos = rng.normal(size=(1, 64, 8)).astype(np.float32)
    want = np.asarray(jvit._interpolate_pos_embed(jnp.asarray(pos), grid))
    got = tvit._interpolate_pos_embed(torch.from_numpy(pos), grid).numpy()
    assert got.shape == (1, grid[0] * grid[1], 8)
    np.testing.assert_allclose(got, want, atol=5e-6)


def test_vit_configs_match_flax():
    for name in ("dinov2_vitb14", "dinov2_vits14", "tiny_test"):
        j, t = getattr(jvit.ViTConfig, name)(), getattr(tvit.ViTConfig, name)()
        for f in ("dim", "depth", "num_heads", "mlp_ratio", "patch_size", "pos_grid",
                  "num_register_tokens", "layerscale_init"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert t.dtype == torch.bfloat16


def test_vit_plain_attention_switch_matches_flax():
    """ViT(use_kernel=False) against the flax ViT built with
    use_pallas=False, as load_encoder and the trainers build it."""
    rng = np.random.default_rng(3)
    cfg = jvit.ViTConfig.tiny_test(dtype=jnp.float32, layerscale_init=0.5)
    x = rng.normal(size=(2, 98, 112, 3)).astype(np.float32)
    ref = jvit.ViT(cfg, use_pallas=False)
    params = ref.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = ref.apply(params, jnp.asarray(x))
    port = tvit.ViT(tvit.ViTConfig.tiny_test(dtype=torch.float32), use_kernel=False)
    assert all(getattr(port, f"block{i}").attn.use_kernel is False for i in range(cfg.depth))
    port.load_state_dict(from_jax_params(jax.device_get(params)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for key in ("cls", "patches"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5)
