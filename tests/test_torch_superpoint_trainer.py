"""The port's SuperPoint trainer (mlis_tpu_torch/train/superpoint_trainer.py)
against mlis_tpu's, on the CPU: the JAX package's draws, rebuilt from its
key splits, through the port's draw tensors, and the tiny SuperPoint in
float32 with the JAX package's parameters. Bands:

* render_shapes: corners within 1e-5 px (measured 7.6e-6); pixels equal
  except where a pixel centre lies on a polygon edge to float32 rounding
  (the cross products are summed in another order) or where the
  background's linear upsampling rounds differently: at most 0.1% of the
  pixels differ by more than 1e-6 (measured: none of 4 x 64x96 = 24,576;
  3,253 background pixels differ by at most 6e-8);
* the background upsampling against ``jax.image.resize(method="linear")``:
  within 1e-6 (measured 2.4e-7);
* corner_cell_labels with several corners per cell, invalid corners and
  corners below the last full row of cells: exact (the last corner wins);
* detector_loss and descriptor_loss within 1e-5 relative, their gradients
  within 1e-5 relative (norm over all entries);
* one joint step from the same weights and draws: the three losses within
  1e-5 relative, the parameters under test_torch_parallel's Adam rule
  (within 1e-4 relative over their concatenation, entry by entry within 2
  lr);
* corner_metrics and repeatability on the same draws: detection counts
  equal, the metrics within 0.01 (a keypoint at a top-k tie may swap).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models.superpoint import SuperPoint as JSP  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JSPC  # noqa: E402
from mlis_tpu.train import matcher_trainer as jmt  # noqa: E402
from mlis_tpu.train import superpoint_trainer as jst  # noqa: E402
from test_torch_matcher_trainer import (  # noqa: E402
    LR,
    _np,
    _t,
    hold_adam_rule,
    jax_corner_draws,
)
from test_torch_quality_scene import jax_texture_draws  # noqa: E402

from mlis_tpu_torch.models.superpoint import SuperPoint as TSP  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig as TSPC  # noqa: E402
from mlis_tpu_torch.ops.image import resize_nhwc  # noqa: E402
from mlis_tpu_torch.train import superpoint_trainer as tst  # noqa: E402
from mlis_tpu_torch.weights import from_jax_params  # noqa: E402

HW = (64, 96)
S = tst.SHAPES_PER_IMAGE


def jax_shape_draws(key, n, H, W) -> tst.ShapeDraws:
    """The raw U[0, 1) draws of mlis_tpu's render_shapes(key, n, H, W)."""
    bg, shades, centers, radii, angles = [], [], [], [], []
    for k in jax.random.split(key, n):
        k_bg, k_v, k_s = jax.random.split(k, 3)
        bg.append(jax.random.uniform(k_bg, (H // 32 + 1, W // 32 + 1)))
        shades.append(jax.random.uniform(k_s, (S,)))
        per = []
        for kv in jax.random.split(k_v, S):
            k_c, k_r = jax.random.split(kv)
            per.append((jax.random.uniform(k_c, (2,)), jax.random.uniform(k_r, (4, 2)),
                        jax.random.uniform(kv, (4,))))
        centers.append(np.stack([p[0] for p in per]))
        radii.append(np.stack([p[1] for p in per]))
        angles.append(np.stack([p[2] for p in per]))
    return tst.ShapeDraws(*(_t(np.stack(x)) for x in (bg, shades, centers, radii, angles)))


def jax_step_draws(key, n, H, W) -> tst.SuperPointDraws:
    """The draws of one step of mlis_tpu's SuperPointTrainer from ``key``."""
    k_shape, k_tex, k_hom = jax.random.split(key, 3)
    return tst.SuperPointDraws(jax_shape_draws(k_shape, n, H, W),
                               *jax_texture_draws(k_tex, n, H, W),
                               jax_corner_draws(jax.random.split(k_hom, n)))


def tiny_sp(kpts=64):
    ref = JSP(JSPC.tiny_test(max_keypoints=kpts, dtype=jnp.float32), seed=0)
    ref.init_params(HW)
    port = TSP(TSPC.tiny_test(max_keypoints=kpts, dtype=torch.float32), device="cpu")
    port.load_state(from_jax_params(_np(ref.params)))
    return ref, port


def test_render_shapes_and_background_resize():
    key = jax.random.PRNGKey(3)
    want = [np.asarray(x) for x in jax.jit(jst.render_shapes, static_argnums=(1, 2, 3))(
        key, 4, *HW)]
    got = [x.numpy() for x in tst.render_shapes(jax_shape_draws(key, 4, *HW), *HW)]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].dtype == want[0].dtype == np.float32
    off = np.abs(got[0] - want[0]) > 1e-6
    assert off.mean() <= 1e-3, f"{off.sum()} pixels differ"
    # the background's upsampling alone
    g = np.random.default_rng(0).uniform(size=(3, 4, 5)).astype(np.float32)
    for hw in (HW, (270, 360)):
        want_r = np.asarray(jax.vmap(lambda x: jax.image.resize(x, hw, method="linear"))(
            jnp.asarray(g)))
        got_r = resize_nhwc(_t(g)[..., None], hw, antialias=True)[..., 0].numpy()
        np.testing.assert_allclose(got_r, want_r, rtol=0, atol=1e-6)


def test_corner_cell_labels_with_duplicates():
    rng = np.random.default_rng(0)
    for H, W in (HW, (60, 96)):  # 60: corners below the last full row of cells
        c = rng.uniform(0, [W, H], size=(3, 60, 2)).astype(np.float32)
        c[:, 30:40] = c[:, :10] + rng.uniform(-2, 2, (3, 10, 2))  # shared cells
        c[:, 40:44] = c[:, 40:41]  # the same corner four times
        c[:, 50], c[:, 51] = (W + 5, H + 3), (-3, 5)  # outside, clipped
        v = rng.random((3, 60)) > 0.2
        want = np.asarray(jst.corner_cell_labels(jnp.asarray(c), jnp.asarray(v), H, W))
        got = tst.corner_cell_labels(_t(c), _t(v), H, W).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and (want < 64).sum() > 40


def test_detector_and_descriptor_losses():
    rng = np.random.default_rng(1)
    B, hc, wc = 2, HW[0] // 8, HW[1] // 8
    logits = rng.normal(size=(B, hc, wc, 65)).astype(np.float32)
    labels = rng.integers(0, 65, size=(B, hc, wc)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.7] = 64
    d0, d1 = (rng.normal(size=(B, hc, wc, 16)).astype(np.float32) for _ in range(2))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    Hms = jax.vmap(lambda k: jmt.random_homography(k, *HW, 0.15))(
        jax.random.split(jax.random.PRNGKey(2), B))
    want = [jax.jit(jax.value_and_grad(jst.detector_loss))(jnp.asarray(logits),
                                                            jnp.asarray(labels)),
            jax.jit(jax.value_and_grad(jst.descriptor_loss, argnums=(0, 1)),
                    static_argnums=(3, 4))(jnp.asarray(d0), jnp.asarray(d1), Hms, *HW)]
    tl, t0, t1 = (_t(x).requires_grad_(True) for x in (logits, d0, d1))
    got = [tst.detector_loss(tl, _t(labels)), tst.descriptor_loss(t0, t1, _t(Hms), *HW)]
    for (wv, wg), gv, inputs in zip(want, got, ([tl], [t0, t1])):
        np.testing.assert_allclose(float(gv.detach()), float(wv), rtol=1e-5)
        grads = torch.autograd.grad(gv, inputs)
        wg = wg if isinstance(wg, tuple) else (wg,)
        a = np.concatenate([g.numpy().ravel() for g in grads])
        b = np.concatenate([np.asarray(g).ravel() for g in wg])
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)


def test_one_joint_step_matches_jax():
    ref, port = tiny_sp()
    jt = jst.SuperPointTrainer(ref, HW, learning_rate=LR)
    tt = tst.SuperPointTrainer(port, HW, learning_rate=LR)
    key = jax.random.PRNGKey(21)
    B = 2
    params, _, loss, det, desc = jax.jit(jt._make_step_fn(B))(ref.params, jt.opt_state, key)
    got = tt.step(jax_step_draws(key, B, *HW)).numpy()
    np.testing.assert_allclose(got, [float(loss), float(det), float(desc)], rtol=1e-5)
    hold_adam_rule(port.net, params["params"], 1)
    # the stepped raw heads: the port's against the JAX package's captured one
    imgs = np.random.default_rng(3).uniform(size=(2, *HW, 1)).astype(np.float32)
    got_l, got_d = port.net.raw_head(_t(imgs))
    assert tuple(got_l.shape) == (2, HW[0] // 8, HW[1] // 8, 65)
    want_l, want_d = jt._raw_head_apply()(params, jnp.asarray(imgs))
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(want_l), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_d.detach().numpy(), np.asarray(want_d), rtol=0, atol=1e-4)


def test_corner_metrics_and_repeatability():
    ref, port = tiny_sp(kpts=96)
    jt = jst.SuperPointTrainer(ref, HW)
    tt = tst.SuperPointTrainer(port, HW)
    key = jax.random.PRNGKey(4242)
    want = jt.corner_metrics(key=key, n=4)
    got = tt.corner_metrics(jax_shape_draws(key, 4, *HW), n=4)
    assert got["n_gt"] == want["n_gt"] and got["n_detections"] == want["n_detections"]
    for k in ("corner_recall", "detector_precision"):
        assert abs(got[k] - want[k]) <= 0.01, (k, got, want)
    key = jax.random.PRNGKey(777)
    k_img, k_hom = jax.random.split(key)
    draws = (jax_texture_draws(k_img, 4, *HW), jax_corner_draws(jax.random.split(k_hom, 4)))
    w, g = jt.repeatability(key=key, n=4), tt.repeatability(draws, n=4)
    assert abs(g - w) <= 0.01 and w > 0
