"""The port's VPR pretraining stream (mlis_tpu_torch/train/pretrain_vpr.py)
against mlis_tpu's, on the CPU: the JAX package's draws, rebuilt from its
key splits, through the port's draw tensors, and the tiny ViT encoder in
float32 with the JAX package's parameters (``weights.carry_jax_vit``).
Bands:

* ``_sample_batch`` and ``_sample_batch_parallax``: place ids exact, at
  least 99% of the pixels within 1/255 (the renderer's rule of
  test_torch_quality_scene.py; measured: every pixel within 2e-5);
* one ``make_train_chunk`` step (clip 1, AdamW at 1e-4): the loss within
  1e-5 relative, the parameters under test_torch_parallel's Adam rule
  (within 1e-4 relative over their concatenation, entry by entry within 2
  lr);
* ``heldout_recall`` (parallax views, 16 places) on the shipped
  vpr_tiny_v2.npz in float32: equal.

``fit_anyloc`` is held in test_torch_fit_anyloc.py, ``main`` for every
arch in test_torch_pretrain_vpr_main.py.
"""

import argparse

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mlis_tpu.models.vit import ViT as JViT  # noqa: E402
from mlis_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from mlis_tpu.models.weights import load_params_npz  # noqa: E402
from mlis_tpu.train import pretrain_vpr as jpv  # noqa: E402
from test_torch_matcher_trainer import _np, _t, hold_adam_rule, jax_corner_draws  # noqa: E402
from test_torch_quality_scene import jax_texture_draws  # noqa: E402

from mlis_tpu_torch.models.vit import ViT as TViT  # noqa: E402
from mlis_tpu_torch.models.vit import ViTConfig as TViTConfig  # noqa: E402
from mlis_tpu_torch.train import pretrain_vpr as tpv  # noqa: E402
from mlis_tpu_torch.train.optim import ClippedAdam  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_vit  # noqa: E402

HW = (96, 128)
P, V = 6, 3
LR = 1e-4
PIXEL_SHARE = 0.99


def jax_batch_draws(key, n_places, views, hw) -> tpv.BatchDraws:
    """The raw draws of mlis_tpu's _sample_batch(key, ...)."""
    kt, kw, kb = jax.random.split(key, 3)
    B = n_places * views
    return tpv.BatchDraws(*jax_texture_draws(kt, n_places, *hw),
                          jax_corner_draws(jax.random.split(kw, B)),
                          _t(jax.random.uniform(kb, (B,))))


def jax_parallax_draws(key, n_places, views, hw, n_layers=3) -> tpv.ParallaxBatchDraws:
    """The raw draws of mlis_tpu's _sample_batch_parallax(key, ...)."""
    H, W = hw
    L, B = n_layers, n_places * views
    kt, km, kv, kb, ko, kot = jax.random.split(key, 6)
    mkeys = jax.random.split(km, n_places * (L - 1))
    mask = jax.vmap(lambda k: jax.random.uniform(k, (H // 40 + 2, W // 40 + 2)))(mkeys)
    pose = jax.vmap(lambda k: tuple(jax.random.uniform(s, (3,))
                                    for s in jax.random.split(k)))(jax.random.split(kv, B))

    def occ(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1), jax.random.uniform(k2, (H // 64 + 2, W // 64 + 2))

    occ_apply, occ_noise = jax.vmap(occ)(jax.random.split(ko, B))
    return tpv.ParallaxBatchDraws(
        *jax_texture_draws(kt, n_places * L, H, W),
        _t(mask).reshape(n_places, L - 1, *mask.shape[1:]), _t(pose[0]), _t(pose[1]),
        _t(jax.random.uniform(kb, (B,))), _t(occ_apply), _t(occ_noise),
        *jax_texture_draws(kot, 4, H, W))


def jax_f32_build(seed=0, arch="tiny"):
    model = JViT(JViTConfig.tiny_test(patch_size=8, dtype=jnp.float32), use_pallas=False)
    return model, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, *jpv.ENC_HW, 3)))


def port_f32_build(seed=0, arch="tiny", device="cpu"):
    vit = TViT(TViTConfig.tiny_test(patch_size=8, dtype=torch.float32), use_kernel=False)
    return vit.init_random_(torch.Generator().manual_seed(seed)).to(device).eval()


@pytest.mark.parametrize("parallax", [False, True])
def test_sample_batches_from_jax_draws(parallax):
    key = jax.random.PRNGKey(9)
    if parallax:
        want = jax.jit(lambda k: jpv._sample_batch_parallax(k, P, V, HW, 0.08))(key)
        got = tpv._sample_batch_parallax(jax_parallax_draws(key, P, V, HW), P, V, HW, 0.08)
    else:
        want = jax.jit(lambda k: jpv._sample_batch(k, P, V, HW, 0.08, 0.08))(key)
        got = tpv._sample_batch(jax_batch_draws(key, P, V, HW), P, V, HW, 0.08, 0.08)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    share = float((np.abs(got[0].numpy() - np.asarray(want[0])) <= 1 / 255).mean())
    assert share >= PIXEL_SHARE, share


def test_one_train_chunk_step_matches_jax():
    jmodel, params = jax_f32_build()
    japply = jpv._make_apply(jmodel)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR))
    chunk = jpv.make_train_chunk(japply, jopt, P, V, HW, 0.08, 0.08)
    vit = carry_jax_vit(port_f32_build(), _np(params))  # before the chunk donates them
    key = jax.random.PRNGKey(5)
    (new_params, _), losses = chunk((params, jopt.init(params)), key, 1)
    step_key = jax.random.split(key, 1)[0]

    opt = ClippedAdam(vit.parameters(), LR, weight_decay=1e-4)
    tchunk = tpv.make_train_chunk(tpv._make_apply(vit), opt, P, V, HW, 0.08, 0.08, device="cpu")
    got = tchunk(1, None, draws=[jax_batch_draws(step_key, P, V, HW)])
    np.testing.assert_allclose(got, np.asarray(losses), rtol=1e-5)
    hold_adam_rule(vit, new_params["params"], 1)


def test_heldout_recall_on_the_shipped_encoder():
    jmodel, tmpl = jax_f32_build()
    from mlis_tpu.models.convert import _match_dtypes

    params = _match_dtypes(load_params_npz("checkpoints/vpr_tiny_v2.npz")["vpr"], tmpl)
    vit = carry_jax_vit(port_f32_build(), _np(params))
    want = jpv.heldout_recall(jax.jit(jpv._make_apply(jmodel)), params, n_places=16, hw=HW,
                              seed=0, parallax=True)
    draws = jax_parallax_draws(jax.random.PRNGKey(77_000), 16, 2, HW)
    got = tpv.heldout_recall(tpv._make_apply(vit), n_places=16, hw=HW, seed=0, parallax=True,
                             device="cpu", draws=draws)
    assert got == want and want > 0.3
