"""The port's matcher trainer (mlis_tpu_torch/train/matcher_trainer.py) and
optimiser pieces (train/optim.py) against mlis_tpu's, on the CPU.

The JAX package's own draws, rebuilt from its key splits, go through the
port's draw tensors; the models are the JAX package's, carried across by
``weights.carry_jax_matcher``; everything runs in float32. Bands:

* gt_assignment and gt_assignment_parallax on the same inputs: exact;
* render_layered_pair: the renderer's rule of test_torch_quality_scene.py
  (both sides warp in float32 but invert and sum in their own order): at
  least 99% of the pixels within 1/255 and of the layer ids equal (measured:
  all pixels within 1e-5, layer ids equal);
* scores and matchability within 1e-5, matcher_loss within 1e-5 relative,
  its gradient within 1e-5 relative over all parameters (float32 sums in
  another order), for both heads (the Sinkhorn head fills its masked
  similarities in place: the gradient proves autograd unaffected);
* the optax schedule within 1e-6 x its peak (optax computes in float32,
  the port in float64: 2.6e-12 apart at the decay's end value of 1e-6),
  the clip within 1e-6.

The trainer's steps are in test_torch_matcher_trainer_steps.py, its held-out
metrics on the shipped matcher in test_torch_matcher_metrics.py (each file
under 60 s on one worker).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mlis_tpu.models import lightglue as jlg  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JSPC  # noqa: E402
from mlis_tpu.train import matcher_trainer as jmt  # noqa: E402
from test_torch_quality_scene import jax_texture_draws  # noqa: E402

from mlis_tpu_torch.models import lightglue as tlg  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig as TSPC  # noqa: E402
from mlis_tpu_torch.train import matcher_trainer as tmt  # noqa: E402
from mlis_tpu_torch.train import optim  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_matcher, from_jax_params  # noqa: E402

HW = (64, 96)
LR = 1e-4
PIXEL_SHARE = 0.99


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def jax_layered_draws(keys, H, W, n_layers=3) -> tmt.LayeredPairDraws:
    """The raw draws of mlis_tpu's render_layered_pair(k, H, W), one per key."""
    L = n_layers
    per = []
    for k in keys:
        kt, km, kp, kb = jax.random.split(k, 4)
        grids, gains = jax_texture_draws(kt, L, H, W)
        mkeys = jax.random.split(km, max(L - 1, 1))
        masks = np.stack([np.asarray(jax.random.uniform(mkeys[l], (H // 40 + 2, W // 40 + 2)))
                          for l in range(L - 1)])
        ka, ktr = jax.random.split(kp)
        per.append((grids, gains, masks, jax.random.uniform(ka, (3,)),
                    jax.random.uniform(ktr, (3,)), jax.random.uniform(kb, (2,))))
    return tmt.LayeredPairDraws(
        [torch.stack([p[0][i] for p in per]) for i in range(4)],
        torch.stack([p[1] for p in per]),
        *(torch.stack([_t(p[j]) for p in per]) for j in (2, 3, 4, 5)))


def jax_corner_draws(keys) -> torch.Tensor:
    return _t(jax.vmap(lambda k: jax.random.uniform(k, (4, 2)))(jnp.stack(list(keys))))


def tiny_pair(assignment="dual_softmax", kpts=48, seed=0):
    """A tiny float32 JAX LightGlue (or SuperGlue head) and the port's with
    its parameters."""
    ref = jlg.LightGlue(sp_cfg=JSPC.tiny_test(max_keypoints=kpts, dtype=jnp.float32),
                       matcher_cfg=jlg.MatcherConfig.tiny_test(dtype=jnp.float32,
                                                               assignment=assignment),
                       seed=seed)
    ref._init(kpts, kpts, HW)
    ref.sp.init_params(HW)
    port = tlg.LightGlue(sp_cfg=TSPC.tiny_test(max_keypoints=kpts, dtype=torch.float32),
                         matcher_cfg=tlg.MatcherConfig.tiny_test(dtype=torch.float32,
                                                                 assignment=assignment),
                         device="cpu")
    carry_jax_matcher(port, _np(ref.params["params"]), _np(ref.sp.params["params"]))
    return ref, port


def hold_adam_rule(port_net, want_params, steps: int, lr: float = LR) -> None:
    want = from_jax_params(_np(want_params))
    names = [n for n, _ in port_net.named_parameters()]
    a = np.concatenate([dict(port_net.named_parameters())[n].detach().numpy().ravel()
                        for n in names])
    b = np.concatenate([want[n].numpy().ravel() for n in names])
    assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
    assert np.abs(a - b).max() <= 2 * lr * steps


def _keypoint_sets(rng, B=2, K=40, H=64, W=96):
    kp0 = rng.integers(0, [W, H], size=(B, K, 2)).astype(np.float32)
    Hm = np.asarray(jmt.random_homography(jax.random.PRNGKey(3), H, W))
    proj = np.asarray(jmt.apply_homography(jnp.asarray(Hm), jnp.asarray(kp0)))
    kp1 = np.round(proj + rng.normal(0, 1.5, proj.shape)).astype(np.float32)
    kp1[:, ::5] = rng.integers(0, [W, H], size=kp1[:, ::5].shape)  # outliers
    m0 = rng.random((B, K)) > 0.15
    m1 = rng.random((B, K)) > 0.15
    return kp0, m0, kp1, m1, Hm


def test_gt_assignment_exact():
    rng = np.random.default_rng(0)
    kp0, m0, kp1, m1, Hm = _keypoint_sets(rng)
    for image_hw in (None, HW):
        want = np.stack([np.asarray(jmt.gt_assignment(
            jnp.asarray(kp0[b]), jnp.asarray(m0[b]), jnp.asarray(kp1[b]), jnp.asarray(m1[b]),
            jnp.asarray(Hm), 3.0, image_hw=image_hw)) for b in range(len(kp0))])
        got = tmt.gt_assignment(_t(kp0), _t(m0), _t(kp1), _t(m1),
                                _t(Hm)[None].expand(len(kp0), 3, 3), 3.0, image_hw=image_hw)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.sum() > 10


def test_render_layered_pair_and_parallax_gt():
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda k: jmt.render_layered_pair(k, *HW)))(keys)]
    got = [x.numpy() for x in tmt.render_layered_pair(jax_layered_draws(keys, *HW), *HW)]
    for g, w, name in zip(got, want, ("img0", "img1", "lid0", "lid1", "Hs")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    for i in (0, 1):
        share = float((np.abs(got[i] - want[i]) <= 1 / 255).mean())
        assert share >= PIXEL_SHARE, f"img{i}: {share:.5f} of pixels within 1/255"
    for i in (2, 3):
        assert float((got[i] == want[i]).mean()) >= PIXEL_SHARE
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-5)

    # the occlusion-aware GT on the JAX package's own layers: exact
    rng = np.random.default_rng(1)
    kp0 = rng.integers(0, [HW[1], HW[0]], size=(3, 40, 2)).astype(np.float32)
    proj = np.stack([np.asarray(jmt.apply_homography(jnp.asarray(want[4][b, 1]), jnp.asarray(kp0[b])))
                     for b in range(3)])
    kp1 = np.round(proj + rng.normal(0, 1.0, proj.shape)).astype(np.float32)
    m0, m1 = rng.random((3, 40)) > 0.1, rng.random((3, 40)) > 0.1
    want_gt = np.stack([np.asarray(jmt.gt_assignment_parallax(
        *(jnp.asarray(a[b]) for a in (kp0, m0, kp1, m1, want[2], want[3], want[4])), 3.0,
        image_hw=HW)) for b in range(3)])
    got_gt = tmt.gt_assignment_parallax(*(_t(a) for a in (kp0, m0, kp1, m1, *want[2:])), 3.0,
                                        image_hw=HW)
    np.testing.assert_array_equal(got_gt.numpy(), want_gt)
    assert want_gt.sum() > 5


@pytest.mark.parametrize("assignment", ["dual_softmax", "sinkhorn"])
def test_matcher_loss_matchability_and_gradient(assignment):
    ref, port = tiny_pair(assignment)
    rng = np.random.default_rng(2)
    B, K, D = 2, 24, 32
    d0, d1 = (rng.normal(size=(B, K, D)).astype(np.float32) for _ in range(2))
    c0, c1 = (rng.uniform(0, 90, size=(B, K, 2)).astype(np.float32) for _ in range(2))
    m0, m1 = rng.random((B, K)) > 0.2, rng.random((B, K)) > 0.2
    gt = np.zeros((B, K, K), bool)
    for b in range(B):
        rows = rng.choice(K, 8, replace=False)
        gt[b, rows, rng.choice(K, 8, replace=False)] = True
    gt &= m0[:, :, None] & m1[:, None, :]
    args = (d0, c0, m0, d1, c1, m1)

    def jloss(p):
        s, mp0, mp1 = ref.net.apply(p, *map(jnp.asarray, args), HW, return_matchability=True)
        return jmt.matcher_loss(s, jnp.asarray(gt), jnp.asarray(m0), jnp.asarray(m1), mp0, mp1), (
            s, mp0, mp1)

    (want_loss, want_out), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        ref.params)
    out = port.net(*map(_t, args), HW, return_matchability=True)
    for g, w in zip(out, want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-5)
    loss = tmt.matcher_loss(out[0], _t(gt), _t(m0), _t(m1), out[1], out[2])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    loss.backward()
    want_g = from_jax_params(_np(want_grad))
    got = np.concatenate([p.grad.numpy().ravel() for n, p in port.net.named_parameters()])
    ref_g = np.concatenate([want_g[n].numpy().ravel() for n, _ in port.net.named_parameters()])
    assert np.linalg.norm(got - ref_g) <= 1e-5 * np.linalg.norm(ref_g)
    # without the matchability term, the NLL alone
    s_only = port.net(*map(_t, args), HW)
    np.testing.assert_allclose(float(tmt.matcher_loss(s_only, _t(gt)).detach()),
                               float(jmt.matcher_loss(want_out[0], jnp.asarray(gt))), rtol=1e-5)


def test_optax_schedule_and_clip():
    peak, warm, steps, end = 2e-4, 300, 6000, 1e-6
    want = optax.warmup_cosine_decay_schedule(0.0, peak, warm, steps, end_value=end)
    got = optim.warmup_cosine_decay_schedule(0.0, peak, warm, steps, end_value=end)
    assert got(0) == 0.0 == float(want(0))
    for count in (0, 1, 150, warm - 1, warm, warm + 1, 3000, steps - 1, steps, steps + 50):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=0, atol=1e-6 * peak)
    rng = np.random.default_rng(3)
    for scale in (0.01, 10.0):  # below and above the max norm of 1
        grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (5,), (2, 2, 2))]
        want_c, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
        tg = [_t(g) for g in grads]
        norm = optim.clip_by_global_norm_(tg, 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for g, w in zip(tg, want_c):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
    # the first update takes lr = schedule(0) = 0: parameters unchanged
    p = torch.nn.Parameter(torch.ones(3))
    opt = optim.ClippedAdam([p], got)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3)) and opt.count == 1
    assert opt.learning_rate() == pytest.approx(peak / warm, rel=1e-12)
