"""The port's ORB (mlis_tpu_torch/models/orb.py) held against mlis_tpu's on
the JAX package's seed-0 v2 scene frames (135x180), float32 in [0, 1]:

* fast_detect: coordinates, scores and validity exact (the 16 ring
  margins are summed in index order, the order XLA's reduction keeps);
* _box_blur: exact (wrap-around rolls, the same sums and divisions);
* orb_detect_describe: coordinates and validity exact; descriptor bits at
  least 99.9% equal on valid keypoints (measured 99.994%): the orientation
  moments sum 961 terms, and XLA and PyTorch sum them in another order and
  round atan2 and cos in another last ulp, so a rotated test point that
  lands on .5 can move one pixel;
* hamming_mutual_match: exact on the same words;
* ORBMatcher.detect_and_match on mono8 and uint8 colour pairs: detector
  counts equal, the matched point pairs equal as sets (at least 99%),
  confidences within a bit of distance where the order is the same; fed
  the JAX package's own matches, the port's RANSAC with the JAX package's
  draws gives its inliers exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import orb as jorb  # noqa: E402
from test_torch_quality import shared_v2_scene  # noqa: E402

from mlis_tpu_torch.gating.verification import GeometricVerifier  # noqa: E402
from mlis_tpu_torch.models import orb as torb  # noqa: E402

BIT_SHARE = 0.999


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    sc = shared_v2_scene(tmp_path_factory)
    return sc.images, np.asarray(sc.K)


def _float(images):
    return np.ascontiguousarray(images.astype(np.float32) / 255.0)


def _colour(mono):
    """A uint8 BGR image with three different channels."""
    return np.stack([mono, np.roll(mono, 3, axis=1), mono // 2 + 60], axis=-1).astype(np.uint8)


def test_brief_pattern_is_the_reference_draw():
    np.testing.assert_array_equal(torb._brief_pattern(), jorb._brief_pattern())
    assert torb.FAST_RING == jorb.FAST_RING


@pytest.mark.parametrize("threshold", [0.08, 0.03])
def test_fast_detect_exact(frames, threshold):
    g = _float(frames[0][:6])
    c, s, v = (np.asarray(x) for x in jorb.fast_detect(jnp.asarray(g), 512, threshold))
    tc, ts, tv = (x.numpy() for x in torb.fast_detect(torch.from_numpy(g), 512, threshold))
    assert v.sum() > 100
    np.testing.assert_array_equal(tc, c)
    np.testing.assert_array_equal(ts, s)
    np.testing.assert_array_equal(tv, v)


def test_box_blur_exact(frames):
    g = _float(frames[0][:4])
    np.testing.assert_array_equal(torb._box_blur(torch.from_numpy(g)).numpy(),
                                  np.asarray(jorb._box_blur(jnp.asarray(g))))


def test_orb_detect_describe_bits(frames):
    g = _float(frames[0][:8])
    c, d, v = (np.asarray(x) for x in jorb.orb_detect_describe(jnp.asarray(g), 512, 0.08))
    tc, td, tv = torb.orb_detect_describe(torch.from_numpy(g), 512, 0.08)
    np.testing.assert_array_equal(tc.numpy(), c)
    np.testing.assert_array_equal(tv.numpy(), v)
    assert td.dtype == torch.int64 and int(td.min()) >= 0 and int(td.max()) < 2**32
    words = td.numpy().astype(np.uint32)
    bits = np.unpackbits(words.view(np.uint8), axis=-1)
    ref_bits = np.unpackbits(d.view(np.uint8), axis=-1)
    share = float((bits == ref_bits)[v].mean())
    print("descriptor bits equal", share)
    assert share >= BIT_SHARE


def test_hamming_mutual_match_exact(frames):
    g = _float(frames[0][[0, 8, 1, 9]])
    _, d, v = (np.asarray(x) for x in jorb.orb_detect_describe(jnp.asarray(g), 512, 0.08))
    for a, b in ((0, 1), (2, 3), (0, 3)):
        want = [np.asarray(x) for x in jorb.hamming_mutual_match(
            jnp.asarray(d[a]), jnp.asarray(v[a]), jnp.asarray(d[b]), jnp.asarray(v[b]))]
        got = torb.hamming_mutual_match(
            *(torch.from_numpy(np.array(x)) for x in (d[a].astype(np.int64), v[a],
                                                       d[b].astype(np.int64), v[b])))
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert (want[0] >= 0).sum() > 20


def test_popcount32():
    x = torch.tensor([0, 1, 2**32 - 1, 0x80000001, 0x0F0F0F0F], dtype=torch.int64)
    assert torb.popcount32(x).tolist() == [0, 1, 32, 2, 16]


@pytest.mark.parametrize("colour", [False, True])
def test_detect_and_match(frames, colour):
    images, K = frames
    jm, tm = jorb.ORBMatcher(), torb.ORBMatcher(device="cpu")
    u = torch.from_numpy(np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (512, 8))))
    for q, m in ((0, 8), (1, 9), (2, 6)):
        a, b = images[q], images[m]
        if colour:
            a, b = _colour(a), _colour(b)
        want = jm.detect_and_match(a, b)
        got = [x.numpy() for x in tm.detect_and_match(a, b)]
        assert tm.last_detector_counts == jm.last_detector_counts
        ref_set = {(tuple(x), tuple(y)) for x, y in zip(want[0], want[1])}
        got_set = {(tuple(x), tuple(y)) for x, y in zip(got[0], got[1])}
        assert len(want[0]) >= 20
        assert len(ref_set & got_set) >= 0.99 * max(len(ref_set), len(got_set))
        if np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]):
            np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-12)
        # the JAX package's matches through the port's RANSAC: equal inliers
        mask, E, ratio = jm.verify_geometric_consistency(want[0], want[1], K, 3.0)
        tmask, tE, tratio = tm.verify_geometric_consistency(want[0], want[1], K, 3.0, uniforms=u)
        assert int(tmask.sum()) == int(mask.sum()) and abs(tratio - ratio) < 1e-6


def test_orb_verifier_builds_and_verifies(frames):
    images, K = frames
    v = GeometricVerifier(matcher_type="orb", device="cpu")
    assert isinstance(v.matcher, torb.ORBMatcher)
    r = v.verify(images[0], images[8], K, 0, 8)
    assert r.num_matches >= 20 and r.num_confident_matches == -1
    assert (r.num_keypoints_query, r.num_keypoints_match) == v.matcher.last_detector_counts
    # the default draws are seeded: the same pair gives the same result
    assert v.verify(images[0], images[8], K, 0, 8).num_inliers == r.num_inliers
