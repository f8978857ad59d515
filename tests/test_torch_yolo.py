"""The port's YOLOv8 dynamic-object filter (mlis_tpu_torch/models/yolo.py)
against mlis_tpu's, float32 at ``tiny_test`` width. The JAX package's
parameter tree (its shapes from ``jax.eval_shape`` of ``YOLOv8.init``) is
filled from ``np.random.default_rng(0)`` (Kaiming-scaled kernels, batch-norm
scales in [0.5, 1.5], so that activations stay of order one; the head at
stride 8 biased towards short boxes of class 2, car, so that the masks
cover part of each frame) and carried across with
``weights.carry_jax_yolo``:

* the raw head maps within 1e-5 of their largest magnitude, and 1e-5
  relative (the same float32 convolutions summed in another order);
* ``decode_predictions``: class scores within 2 ulps and boxes within 1e-4
  px (XLA's logistic and exp round differently from PyTorch's, a few ulps
  of coordinates up to 100 px);
* ``nms_fixed`` exact, with tied scores (ties to the lower index, as
  ``lax.top_k``), over one image and over a batch;
* ``mask_dynamic_objects`` exact on planted boxes of every dynamic class
  and of static classes, and equal to the materialised (B, N, H, W) union;
* ``YOLODetector`` and ``DynamicObjectFilter`` at 64x96 on 54x72 uint8
  frames: classes and validity exact, scores within 2 ulps, boxes within
  1e-4 px, the masks and the filtering metrics equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import yolo as jy  # noqa: E402

from mlis_tpu_torch.models import yolo as ty  # noqa: E402
from mlis_tpu_torch.weights import (  # noqa: E402
    carry_jax_yolo,
    flatten_params,
    to_jax_params,
    unflatten_params,
)

RAW_TOL = 1e-5
BOX_ATOL = 1e-4
INPUT = (64, 96)


def _jax_tree_shapes(cfg):
    shapes = jax.eval_shape(jy.YOLOv8(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *INPUT, 3)))["params"]
    return {k: v.shape for k, v in flatten_params(
        jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes)).items()}


@pytest.fixture(scope="module")
def detectors():
    cfg = jy.YOLOConfig.tiny_test(dtype=jnp.float32, score_threshold=-1.0)
    rng = np.random.default_rng(0)
    flat = {}
    for k, shape in _jax_tree_shapes(cfg).items():
        if k.endswith("kernel"):
            flat[k] = rng.normal(size=shape) * (2.0 / np.prod(shape[:3])) ** 0.5
        elif k.endswith("bn_scale"):
            flat[k] = rng.uniform(0.5, 1.5, shape)
        else:
            flat[k] = 0.1 * rng.normal(size=shape)
        flat[k] = flat[k].astype(np.float32)
    bias = flat["head0_out/bias"]
    bias[0:64:16] += 4.0  # every side's first DFL bin: boxes of about a cell
    bias[64 + 2] += 2.0  # class 2, car
    params = {"params": unflatten_params(flat)}
    J = jy.YOLODetector(cfg, input_size=INPUT)
    J.params = params
    T = ty.YOLODetector(ty.YOLOConfig.tiny_test(dtype=torch.float32, score_threshold=-1.0),
                        input_size=INPUT, device="cpu")
    return J, carry_jax_yolo(T, params)


def test_raw_head_maps_match(detectors):
    J, T = detectors
    x = np.random.default_rng(0).uniform(0, 1, (2, *INPUT, 3)).astype(np.float32)
    want = [np.asarray(o) for o in J.net.apply(J.params, jnp.asarray(x))]
    with torch.no_grad():
        got = [o.numpy() for o in T.net(torch.from_numpy(x))]
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, 8, 12, 144), (2, 4, 6, 144), (2, 2, 3, 144)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RAW_TOL, atol=RAW_TOL * np.abs(w).max())


def test_decode_predictions():
    cfg = jy.YOLOConfig.tiny_test()
    rng = np.random.default_rng(1)
    raw = [rng.normal(size=(2, h, w, 4 * 16 + 80)).astype(np.float32) * 2
           for h, w in ((8, 12), (4, 6), (2, 3))]
    wb, ws = jy.decode_predictions([jnp.asarray(r) for r in raw], cfg, INPUT)
    gb, gs = ty.decode_predictions([torch.from_numpy(r) for r in raw], ty.YOLOConfig.tiny_test(),
                                   INPUT)
    assert gb.shape == wb.shape == (2, 96 + 24 + 6, 4) and gs.shape == ws.shape
    np.testing.assert_array_max_ulp(gs.numpy(), np.asarray(ws), maxulp=2)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=BOX_ATOL, rtol=0)


def _nms_case(rng, A=40):
    """Boxes in four clusters of overlaps, with tied scores and two classes."""
    centers = rng.uniform(10, 90, (4, 2))[rng.integers(0, 4, A)]
    wh = rng.uniform(8, 20, (A, 2))
    jitter = rng.uniform(-3, 3, (A, 2))
    boxes = np.concatenate([centers + jitter - wh / 2, centers + jitter + wh / 2], 1)
    scores = np.round(rng.uniform(0, 1, A), 1).astype(np.float32)  # many ties
    classes = rng.integers(0, 2, A)
    return boxes.astype(np.float32), scores, classes


def test_nms_fixed_with_ties():
    rng = np.random.default_rng(2)
    cases = [_nms_case(rng) for _ in range(3)]
    for boxes, scores, classes in cases:
        want = [np.asarray(x) for x in jy.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                                                   jnp.asarray(classes), 0.25, 0.45, max_det=16)]
        got = [x.numpy() for x in ty.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                                              torch.from_numpy(classes), 0.25, 0.45, max_det=16)]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert 0 < got[3].sum() < 16
    # a batch at once: the vmapped JAX function per image
    b, s, c = (np.stack(x) for x in zip(*cases))
    want = [np.asarray(x) for x in jax.vmap(lambda *a: jy.nms_fixed(*a, 0.25, 0.45, max_det=16))(
        jnp.asarray(b), jnp.asarray(s), jnp.asarray(c))]
    got = [x.numpy() for x in ty.nms_fixed(torch.from_numpy(b), torch.from_numpy(s),
                                          torch.from_numpy(c), 0.25, 0.45, max_det=16)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_nms_fixed_semantics():
    """The JAX package's own cases: an overlap of the same class is
    suppressed, of another class kept; the score threshold."""
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60], [0, 0, 10, 10]],
                         dtype=torch.float32)
    v = ty.nms_fixed(boxes, torch.tensor([0.9, 0.8, 0.7, 0.6]), torch.tensor([0, 0, 0, 2]),
                     0.5, 0.45, max_det=4)[3]
    assert v.tolist() == [True, False, True, True]
    v = ty.nms_fixed(boxes[[0, 2]], torch.tensor([0.9, 0.1]), torch.tensor([0, 0]), 0.25, 0.45,
                     max_det=2)[3]
    assert v.tolist() == [True, False]


def test_mask_dynamic_objects_exact():
    rng = np.random.default_rng(3)
    B, N, H, W = 3, 12, 40, 60
    imgs = rng.integers(1, 255, (B, H, W, 3), dtype=np.uint8)
    xy = rng.uniform(-5, 55, (B, N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 15, (B, N, 2))], -1).astype(np.float32)
    # every dynamic class and two static ones (56 chair, 62 tv)
    classes = np.array([0, 1, 2, 3, 5, 7, 56, 62, 0, 2, 56, 7])[None].repeat(B, 0)
    valid = rng.random((B, N)) < 0.8
    valid[:, 0] = True
    want_img, want_mask = (np.asarray(x) for x in jy.mask_dynamic_objects(
        jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid),
        dilation=2))
    got_img, got_mask = ty.mask_dynamic_objects(
        torch.from_numpy(imgs), torch.from_numpy(boxes), torch.from_numpy(classes),
        torch.from_numpy(valid), dilation=2)
    assert got_img.dtype == torch.uint8 and got_mask.dtype == torch.bool
    assert np.array_equal(got_mask.numpy(), want_mask) and np.array_equal(got_img.numpy(),
                                                                          want_img)
    assert 0 < want_mask.mean() < 1
    # the materialised union over boxes gives the same mask
    ys, xs = np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32)
    dyn = np.isin(classes, jy.DYNAMIC_COCO_CLASSES) & valid
    full = ((ys[None, None, :, None] >= boxes[..., 1, None, None] - 2)
            & (ys[None, None, :, None] <= boxes[..., 3, None, None] + 2)
            & (xs[None, None, None, :] >= boxes[..., 0, None, None] - 2)
            & (xs[None, None, None, :] <= boxes[..., 2, None, None] + 2) & dyn[..., None, None])
    assert np.array_equal(got_mask.numpy(), full.any(1))
    # a static class alone masks nothing
    _, none = ty.mask_dynamic_objects(torch.from_numpy(imgs), torch.from_numpy(boxes),
                                      torch.full((B, N), 56), torch.from_numpy(valid))
    assert not none.any()


def test_detector_and_filter_match_jax(detectors):
    J, T = detectors
    imgs = np.random.default_rng(4).integers(0, 255, (2, 54, 72, 3), dtype=np.uint8)
    want = [np.asarray(x) for x in J.detect(imgs)]
    got = [x.numpy() for x in T.detect(imgs)]
    assert got[0].shape == (2, 16, 4)
    np.testing.assert_allclose(got[0], want[0], atol=BOX_ATOL, rtol=0)
    np.testing.assert_array_max_ulp(got[1], want[1], maxulp=2)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].min() >= 0 and got[0][..., 0::2].max() <= 72 and got[0][..., 1::2].max() <= 54
    jf = jy.DynamicObjectFilter(detector=J, dilation=2)
    tf = ty.DynamicObjectFilter(detector=T, dilation=2)
    for seed in (4, 5):
        batch = np.random.default_rng(seed).integers(0, 255, (2, 54, 72, 3), dtype=np.uint8)
        wm, wmask, _ = jf.filter_batch(batch)
        gm, gmask, _ = tf.filter_batch(batch)
        assert np.array_equal(gmask.numpy(), wmask) and np.array_equal(gm.numpy(), wm)
    assert dataclasses.asdict(tf.get_metrics()) == dataclasses.asdict(jf.get_metrics())
    m = tf.get_metrics()
    assert m.total_frames == 4 and m.dynamic_object_rate == 1.0
    assert 0.0 < m.feature_filter_rate < 1.0


def test_random_init_is_seeded_with_flax_distributions():
    state = torch.random.get_rng_state()
    a = ty.YOLODetector(ty.YOLOConfig.tiny_test(), input_size=INPUT, seed=3, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    b = ty.YOLODetector(ty.YOLOConfig.tiny_test(), input_size=INPUT, seed=3, device="cpu")
    for (name, pa), pb in zip(a.net.state_dict().items(), b.net.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert bool((a.net.stem.bn_scale == 1).all()) and not a.net.head0_out.bias.any()
    w = a.net.down1.conv.weight.detach()  # fan-in 8 x 3 x 3
    assert abs(float(w.std()) - 72**-0.5) < 0.1 * 72**-0.5
    # nano: the JAX package's tree shapes, name for name
    nano = ty.YOLOv8(ty.YOLOConfig.nano())
    got = {k: v.shape for k, v in flatten_params(to_jax_params(nano.state_dict())).items()}
    assert got == _jax_tree_shapes(jy.YOLOConfig.nano())
