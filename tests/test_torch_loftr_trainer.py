"""The port's LoFTR trainer (mlis_tpu_torch/train/loftr_trainer.py) against
mlis_tpu's, on the CPU, on the tiny lite LoFTR in float32 with the JAX
package's parameters carried across (``weights.carry_jax_matcher``) and
its draws fed through the port's draw tensors. Bands:

* coarse_gt_cells and coarse_gt_cells_parallax: target cells and validity
  exact, projected points within 1e-6 relative (two float32 ulps: 3x3
  products summed in another order; measured 1.8e-7);
* loftr_loss on the network's own features: the loss within 1e-5
  relative, n_gt equal, the gradient to the features within 1e-5 relative
  (norm over all entries);
* one LoFTRTrainer step in each pair mode from the same weights and draws:
  the loss within 1e-5 relative, n_gt equal, the parameters under
  test_torch_parallel's Adam rule (within 1e-4 relative over their
  concatenation, entry by entry within 2 lr);
* the official architecture refused by both packages.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import loftr as jl  # noqa: E402
from mlis_tpu.train import loftr_trainer as jlt  # noqa: E402
from mlis_tpu.train import matcher_trainer as jmt  # noqa: E402
from test_torch_matcher_trainer import (  # noqa: E402
    LR,
    _np,
    _t,
    hold_adam_rule,
    jax_corner_draws,
    jax_layered_draws,
)
from test_torch_quality_scene import jax_texture_draws  # noqa: E402

from mlis_tpu_torch.models import loftr as tl  # noqa: E402
from mlis_tpu_torch.train import loftr_trainer as tlt  # noqa: E402
from mlis_tpu_torch.train import matcher_trainer as tmt  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_matcher  # noqa: E402

HW = (64, 96)
GRID = (8, 12)


def tiny_loftr():
    ref = jl.LoFTR(jl.LoFTRConfig.tiny_test(dtype=jnp.float32), seed=0)
    ref._init(HW)
    port = tl.LoFTR(tl.LoFTRConfig.tiny_test(dtype=torch.float32), device="cpu")
    return ref, carry_jax_matcher(port, _np(ref.params["params"]))


def test_coarse_gt_cells_both_modes():
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    Hms = jax.vmap(lambda k: jmt.random_homography(k, *HW, 0.15))(keys)
    want = [np.stack(x) for x in zip(*(jlt.coarse_gt_cells(Hm, *GRID, HW) for Hm in Hms))]
    got = tlt.coarse_gt_cells(tmt.random_homography(jax_corner_draws(keys), *HW, 0.15), *GRID, HW)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-6, atol=1e-5)
    assert 0 < want[1].sum() < want[1].size

    _, _, lid0, lid1, Hs = (np.asarray(x) for x in jax.jit(jax.vmap(
        lambda k: jmt.render_layered_pair(k, *HW)))(keys))
    want = [np.stack(x) for x in zip(*(jlt.coarse_gt_cells_parallax(
        jnp.asarray(lid0[b]), jnp.asarray(lid1[b]), jnp.asarray(Hs[b]), *GRID, HW)
        for b in range(3)))]
    got = tlt.coarse_gt_cells_parallax(_t(lid0), _t(lid1), _t(Hs), *GRID, HW)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-6, atol=1e-5)
    assert 0 < want[1].sum() < want[1].size


def test_loftr_loss_and_its_gradient():
    ref, port = tiny_loftr()
    cfg = ref.cfg
    rng = np.random.default_rng(0)
    img0 = np.kron(rng.uniform(size=(2, 8, 12)), np.ones((8, 8))).astype(np.float32)
    img1 = np.roll(img0, 3, axis=2)
    t0, t1, f0, f1, grid = ref.net.apply(ref.params, jnp.asarray(img0[..., None]),
                                         jnp.asarray(img1[..., None]))
    assert tuple(grid) == GRID
    T = np.eye(3, dtype=np.float32)
    T[0, 2] = 3.0
    idx1, valid, target = jax.vmap(lambda Hm: jlt.coarse_gt_cells(Hm, *GRID, HW))(
        jnp.asarray(np.stack([T, T])))
    feats = (t0, t1, f0, f1)

    def jloss(ft):
        return jlt.loftr_loss(*ft, idx1, valid, target, GRID, cfg.temperature, cfg.fine_window)

    (want, want_n), want_grad = jax.value_and_grad(jloss, has_aux=True)(feats)
    tf = [_t(x).requires_grad_(True) for x in feats]
    loss, n_gt = tlt.loftr_loss(*tf, _t(idx1), _t(valid), _t(target), GRID, cfg.temperature,
                                cfg.fine_window)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert int(n_gt) == int(want_n) > 0
    loss.backward()
    got_g = np.concatenate([x.grad.numpy().ravel() for x in tf])
    want_g = np.concatenate([np.asarray(g).ravel() for g in want_grad])
    assert np.linalg.norm(got_g - want_g) <= 1e-5 * np.linalg.norm(want_g)
    # the port's network gives the same features
    out = port.net(_t(img0[..., None]), _t(img1[..., None]))
    for g, w in zip(out[:4], feats):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=2e-5)


@pytest.mark.parametrize("pair_mode", ["homography", "parallax"])
def test_one_trainer_step_matches_jax(pair_mode):
    ref, port = tiny_loftr()
    jt = jlt.LoFTRTrainer(ref, HW, learning_rate=LR, pair_mode=pair_mode)
    tt = tlt.LoFTRTrainer(port, HW, learning_rate=LR, pair_mode=pair_mode)
    B = 2
    k_img, key = jax.random.split(jax.random.PRNGKey(11))
    images = jmt.synthetic_textures(k_img, B, *HW)
    params, _, want_loss, want_n = jax.jit(jt._make_step_fn())(ref.params, jt.opt_state, images,
                                                              key)
    hkeys = jax.random.split(key, B)
    draws = (jax_layered_draws(hkeys, *HW) if pair_mode == "parallax"
             else jax_corner_draws(hkeys))
    tex = tmt.synthetic_textures(*jax_texture_draws(k_img, B, *HW), *HW)
    np.testing.assert_allclose(tex.numpy(), np.asarray(images), rtol=0, atol=1e-6)
    loss, n_gt = tt.step(tex, draws)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert int(n_gt) == int(want_n) > 0
    hold_adam_rule(port.net, params["params"], 1)


def test_official_architecture_is_refused():
    with pytest.raises(ValueError, match="inference-only"):
        jlt.LoFTRTrainer(jl.LoFTR(jl.LoFTRConfig.official_tiny()), HW)
    with pytest.raises(ValueError, match="inference-only"):
        tlt.LoFTRTrainer(tl.LoFTR(tl.LoFTRConfig.official_tiny(), device="cpu"), HW)
    with pytest.raises(ValueError, match="multiple of 8"):
        tlt.LoFTRTrainer(tl.LoFTR(tl.LoFTRConfig.tiny_test(), device="cpu"), (60, 96))
