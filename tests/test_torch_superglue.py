"""The port's SuperGlue head (the Sinkhorn branch of
mlis_tpu_torch/models/lightglue.py MatcherNet) held against mlis_tpu's.

* ``MatcherConfig.tiny_test`` with ``assignment="sinkhorn"`` and the JAX
  package's parameters carried across (``weights.carry_jax_matcher``), on
  keypoint sets with masked suffixes of different lengths: scores within
  2e-6 absolute in float32 (float32 GEMMs and log-sum-exps summed in
  another order; the scores are probabilities), within 2^-5 in bf16 (bf16
  features through 20 transport iterations); the masked rows and columns
  stay near zero.
* ``SuperGlue`` with ``superglue_parallax.npz`` at 128 keypoints on pairs
  of the JAX package's seed-0 v2 scene: in float32 the match indices and
  validity equal, scores within 1e-4; in bf16 (as shipped) the match
  counts within 3 and the confident counts (score >= 0.5) within 8 (bf16
  SuperPoint summed in another order moves keypoints across the top-128
  cut, and the transport pools every keypoint; see
  test_torch_quality_matchers.py).
* ``detect_and_match`` on uint8 images, float32: the same matched points
  and detector counts as the JAX package's.
* ``init_random_`` draws from its own generator: the same seed gives the
  same weights, and the global RNG is left alone.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.eval import quality as jq  # noqa: E402
from mlis_tpu.models import lightglue as jlg  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JaxSPC  # noqa: E402

from mlis_tpu_torch.models import lightglue as tlg  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_matcher  # noqa: E402

CKPT = "checkpoints/superglue_parallax.npz"
TINY = dict(descriptor_dim=32, dim=32, num_heads=2, depth=2)


@pytest.fixture(scope="module")
def scene():
    return jq.make_quality_scene_v2(n_floors=2, n_places=4, hw=(135, 180), seed=0)


def _inputs():
    rng = np.random.default_rng(0)
    B, K, D = 3, 40, 32
    d0, d1 = (rng.normal(size=(B, K, D)).astype(np.float32) for _ in range(2))
    c0, c1 = ((rng.random((B, K, 2)) * [180, 135]).astype(np.float32) for _ in range(2))
    m0, m1 = np.ones((B, K), bool), np.ones((B, K), bool)
    m0[:, 30:] = False
    m1[1, 20:] = False
    m1[2, 35:] = False
    return d0, c0, m0, d1, c1, m1


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6), ("bfloat16", 2.0**-5)])
def test_sinkhorn_head_matches_jax(dtype, atol):
    d0, c0, m0, d1, c1, m1 = _inputs()
    cfg = jlg.MatcherConfig.superglue(dtype=getattr(jnp, dtype), **TINY)
    net = jlg.MatcherNet(cfg)
    params = net.init(jax.random.PRNGKey(0), d0, c0, m0, d1, c1, m1, (135, 180))
    want = np.asarray(net.apply(params, d0, c0, m0, d1, c1, m1, (135, 180)))
    port = tlg.SuperGlue(sp_cfg=SuperPointConfig.tiny_test(), device="cpu",
                         matcher_cfg=tlg.MatcherConfig.superglue(dtype=getattr(torch, dtype),
                                                                 **TINY))
    assert port.cfg.assignment == "sinkhorn" and port.cfg.match_threshold == 0.2
    carry_jax_matcher(port, jax.tree_util.tree_map(np.asarray, params["params"]))
    assert float(port.net.dustbin.detach()) == 1.0 and not hasattr(port.net, "matchability")
    with torch.no_grad():
        got = port.net(*(torch.from_numpy(x) for x in (d0, c0, m0, d1, c1, m1)), (135, 180))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    assert float(got[:, 30:].max()) < 1e-6  # masked keypoints take no transport mass
    # the matches the head gives, float32: identical
    if dtype == "float32":
        a = jlg.extract_matches(jnp.asarray(want), m0, m1, 0.2)
        b = tlg.extract_matches(got, torch.from_numpy(m0), torch.from_numpy(m1), 0.2)
        np.testing.assert_array_equal(b.idx0.numpy(), np.asarray(a.idx0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shipped_superglue_on_scene_pairs(scene, dtype):
    g = np.ascontiguousarray((scene.images.astype(np.float32) / 255.0)[..., None])
    J = jlg.SuperGlue(sp_cfg=JaxSPC(max_keypoints=128, dtype=getattr(jnp, dtype)),
                      matcher_cfg=jlg.MatcherConfig.superglue(dtype=getattr(jnp, dtype)))
    J.load_weights(CKPT, image_hw=(135, 180))
    T = tlg.SuperGlue(sp_cfg=SuperPointConfig(max_keypoints=128, dtype=getattr(torch, dtype)),
                      matcher_cfg=tlg.MatcherConfig.superglue(dtype=getattr(torch, dtype)),
                      device="cpu")
    T.load_weights(CKPT)
    im0, im1 = g[[0, 1, 2, 3]], g[[8, 9, 10, 11]]
    _, _, a = J.match_batch(jnp.asarray(im0), jnp.asarray(im1))
    _, _, b = T.match_batch(torch.from_numpy(im0), torch.from_numpy(im1))
    va, vb = np.asarray(a.valid), b.valid.numpy()
    conf_a = (va & (np.asarray(a.scores) >= 0.5)).sum(1)
    conf_b = (vb & (b.scores.numpy() >= 0.5)).sum(1)
    print(dtype, va.sum(1), vb.sum(1), conf_a, conf_b)
    assert va.sum(1).min() > 50
    if dtype == "float32":
        np.testing.assert_array_equal(b.idx0.numpy(), np.asarray(a.idx0))
        np.testing.assert_array_equal(vb, va)
        np.testing.assert_allclose(b.scores.numpy(), np.asarray(a.scores), rtol=0, atol=1e-4)
    else:
        assert np.abs(va.sum(1) - vb.sum(1)).max() <= 3
        assert np.abs(conf_a - conf_b).max() <= 8


def test_detect_and_match_float32(scene):
    J = jlg.SuperGlue(sp_cfg=JaxSPC(max_keypoints=128, dtype=jnp.float32),
                      matcher_cfg=jlg.MatcherConfig.superglue(dtype=jnp.float32))
    J.load_weights(CKPT, image_hw=(135, 180))
    T = tlg.SuperGlue(sp_cfg=SuperPointConfig(max_keypoints=128, dtype=torch.float32),
                      matcher_cfg=tlg.MatcherConfig.superglue(dtype=torch.float32), device="cpu")
    T.load_weights(CKPT)
    for q, m in ((0, 8), (2, 10)):
        want = J.detect_and_match(scene.images[q], scene.images[m])
        got = [x.numpy() for x in T.detect_and_match(scene.images[q], scene.images[m])]
        assert T.last_detector_counts == J.last_detector_counts
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)


def test_init_random_is_seeded_and_leaves_the_global_rng():
    cfg = dict(sp_cfg=SuperPointConfig.tiny_test(), device="cpu",
               matcher_cfg=tlg.MatcherConfig.superglue(**TINY))
    a, b = tlg.SuperGlue(**cfg), tlg.SuperGlue(**cfg)
    state = torch.random.get_rng_state()
    a.init_random_(0)
    b.init_random_(0)
    assert torch.equal(state, torch.random.get_rng_state())
    for (na, pa), (nb, pb) in zip(list(a.net.state_dict().items()) + list(a.sp.net.state_dict().items()),
                                  list(b.net.state_dict().items()) + list(b.sp.net.state_dict().items())):
        assert na == nb and torch.equal(pa, pb), na
    sd = a.net.state_dict()
    assert float(sd["dustbin"]) == 1.0 and float(sd["in_proj.bias"].abs().max()) == 0.0
    w = sd["in_proj.weight"]  # lecun normal over fan-in 32, cut at 2 sigma
    assert abs(float(w.std()) - 32**-0.5) < 0.05 and float(w.abs().max()) <= 2 * 32**-0.5 / 0.8796 + 1e-6
