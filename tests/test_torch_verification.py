"""The port's verification API (mlis_tpu_torch/gating/verification.py) held
against mlis_tpu's on pairs of the JAX package's seed-0 v2 scene (mono8,
135x180, its own K), with the JAX package's RANSAC uniforms fed to the
port through ``uniforms=``:

* ``verify`` / ``verify_batch`` (one pair of uint8 images through
  ``detect_and_match``, ``PRNGKey(0)`` for every pair) with the shipped
  parallax LightGlue in float32 at 128 keypoints: detector counts, match
  counts and confident counts equal; inliers within 1 (the float32 8-point
  solve rounds differently, ROADMAP Queue 3) and decisions equal;
* ``SemanticGeometricVerifier.verify_with_semantics`` on uint8 images: the
  floor skip, the stats, and the result of ``verify``;
* the classical branch of ``verify_pairs_batch`` (ORB, pair by pair
  through ``verify``): detector counts equal, match counts within 2 and
  inliers within 9 (a descriptor bit that moves with the last ulp of
  atan2 reorders the matches, see test_torch_orb.py), decisions equal;
* the dense branch (LoFTR, ``loftr_parallax.npz`` in float32, chunks of 3
  padded to 8, chunk s keyed ``PRNGKey(s)``): match counts equal, inliers
  within 3 (the coarse scores' last ulp can swap two matches in the top-k
  order and so RANSAC's samples) and decisions equal; ``n_conf`` is -1;
* ``_pad_pairs_pow2``, ``_build_matcher`` and RANSAC without K exactly as
  in the JAX package.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.eval import quality as jq  # noqa: E402
from mlis_tpu.gating import verification as jv  # noqa: E402
from mlis_tpu.models.lightglue import LightGlue as JaxLG  # noqa: E402
from mlis_tpu.models.lightglue import MatcherConfig as JaxMC  # noqa: E402
from mlis_tpu.models.loftr import LoFTR as JaxLoFTR  # noqa: E402
from mlis_tpu.models.loftr import LoFTRConfig as JaxLoFTRConfig  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JaxSPC  # noqa: E402
from mlis_tpu.models.weights import matcher_arch_from_npz  # noqa: E402
from mlis_tpu.ops.image import to_grayscale as jax_gray  # noqa: E402

from mlis_tpu_torch.gating import verification as tv  # noqa: E402
from mlis_tpu_torch.models.lightglue import LightGlue  # noqa: E402
from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig  # noqa: E402
from mlis_tpu_torch.models.orb import ORBMatcher  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig  # noqa: E402

HYP = 512
LG_CKPT = "checkpoints/lightglue_parallax_sp.npz"
LOFTR_CKPT = "checkpoints/loftr_parallax.npz"
PAIRS = [(0, 8), (1, 9), (2, 10), (0, 4), (3, 11)]


@pytest.fixture(scope="module")
def scene():
    sc = jq.make_quality_scene_v2(n_floors=2, n_places=4, hw=(135, 180), seed=0)
    gray = np.asarray(jax_gray(jnp.asarray(sc.images)))
    return sc.images, gray, np.asarray(sc.K)


def _key0() -> torch.Tensor:
    return torch.tensor(np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (HYP, 8))))


def _same_decisions(got, ref, inlier_band, match_band=0):
    assert [(r.query_idx, r.match_idx) for r in got] == [(r.query_idx, r.match_idx) for r in ref]
    for a, b in zip(got, ref):
        assert (a.num_keypoints_query, a.num_keypoints_match) == (
            b.num_keypoints_query, b.num_keypoints_match)
        assert abs(a.num_matches - b.num_matches) <= match_band
        assert a.num_confident_matches == b.num_confident_matches
        assert abs(a.num_inliers - b.num_inliers) <= inlier_band
        assert a.is_valid == b.is_valid
        assert (a.relative_pose is None) == (b.relative_pose is None)


@pytest.fixture(scope="module")
def lightglue_pair():
    jlg = JaxLG(sp_cfg=JaxSPC(max_keypoints=128, dtype=jnp.float32),
                matcher_cfg=JaxMC(dtype=jnp.float32, **matcher_arch_from_npz(LG_CKPT)))
    jlg.load_weights(LG_CKPT, image_hw=(135, 180))
    tlg = LightGlue.from_checkpoint(
        LG_CKPT, sp_cfg=SuperPointConfig(max_keypoints=128, dtype=torch.float32),
        dtype=torch.float32, device="cpu")
    return jlg, tlg


def test_verify_and_verify_batch(scene, lightglue_pair):
    images, _, K = scene
    jlg, tlg = lightglue_pair
    ref_v, v = jv.GeometricVerifier(matcher=jlg), tv.GeometricVerifier(matcher=tlg)
    pairs = PAIRS[:2] + PAIRS[3:4]  # two revisits and a wrong-place pair
    ref = [ref_v.verify(images[q], images[m], K, q, m) for q, m in pairs]
    got = [v.verify(images[q], images[m], K, q, m, uniforms=_key0()) for q, m in pairs]
    _same_decisions(got, ref, inlier_band=1)
    assert sum(r.is_valid for r in got) >= 2
    for a, b in zip(got, ref):
        if a.relative_pose is not None:  # same pose on the pairs both accept
            np.testing.assert_allclose(a.relative_pose[:3, :3], b.relative_pose[:3, :3], atol=1e-2)
    # verify_batch: pairs in order, the verifier's own seeded draws
    batch = v.verify_batch([(images[q], images[m]) for q, m in PAIRS[:2]], K, indices=PAIRS[:2])
    assert [(r.query_idx, r.match_idx) for r in batch] == PAIRS[:2]
    again = [v.verify(images[q], images[m], K, q, m) for q, m in PAIRS[:2]]
    assert [r.num_inliers for r in batch] == [r.num_inliers for r in again]


def test_verify_with_semantics_uint8(scene, lightglue_pair):
    images, _, K = scene
    jlg, tlg = lightglue_pair
    ref_sem = jv.SemanticGeometricVerifier(matcher=jlg)
    sem = tv.SemanticGeometricVerifier(matcher=tlg)
    q, m = PAIRS[0]
    skipped = sem.verify_with_semantics(images[q], images[m], 5, 2, K, q, m)
    assert not skipped.is_valid and skipped.num_matches == 0 and skipped.relative_pose is None
    same = sem.verify_with_semantics(images[q], images[m], 5, 5, K, q, m, uniforms=_key0())
    ref_sem.verify_with_semantics(images[q], images[m], 5, 2, K, q, m)
    ref = ref_sem.verify_with_semantics(images[q], images[m], 5, 5, K, q, m)
    _same_decisions([same], [ref], inlier_band=1)
    assert same.is_valid and same.num_confident_matches > 0
    assert sem.get_statistics() == ref_sem.get_statistics()


def test_classical_branch_is_verify_per_pair(scene):
    _, gray, K = scene
    q, m = np.asarray(PAIRS).T
    ref = jv.GeometricVerifier(matcher_type="orb").verify_pairs_batch(
        gray[q], gray[m], K, indices=PAIRS, batch_size=3)
    v = tv.GeometricVerifier(matcher=ORBMatcher(device="cpu"))
    u = _key0()[None].expand(len(PAIRS), HYP, 8)
    got = v.verify_pairs_batch(gray[q], gray[m], K, indices=PAIRS, batch_size=3, uniforms=u)
    _same_decisions(got, ref, inlier_band=9, match_band=2)
    assert all(r.num_confident_matches == -1 for r in got)
    # without uniforms every pair draws verify's own seed-0 stream
    plain = v.verify_pairs_batch(gray[q], gray[m], K, indices=PAIRS)
    single = [v.verify(gray[a], gray[b], K, a, b) for a, b in PAIRS]
    assert [r.num_inliers for r in plain] == [r.num_inliers for r in single]


def test_dense_branch(scene):
    _, gray, K = scene
    q, m = np.asarray(PAIRS).T
    jl = JaxLoFTR(JaxLoFTRConfig(dtype=jnp.float32, match_threshold=0.05))
    jl.load_weights(LOFTR_CKPT, image_hw=(135, 180))
    ref = jv.GeometricVerifier(matcher=jl).verify_pairs_batch(
        gray[q], gray[m], K, indices=PAIRS, seed=0, batch_size=3)
    draws = []
    for s in (0, 3):  # chunk s: PRNGKey(seed + s) split over the chunk padded to 8
        keys = jax.random.split(jax.random.PRNGKey(s), 8)[: min(3, len(PAIRS) - s)]
        draws.append(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (HYP, 8)))(keys)))
    lf = LoFTR(LoFTRConfig(dtype=torch.float32, match_threshold=0.05), device="cpu")
    lf.load_weights(LOFTR_CKPT)
    v = tv.GeometricVerifier(matcher=lf)
    got = v.verify_pairs_batch(gray[q], gray[m], K, indices=PAIRS, batch_size=3,
                               uniforms=torch.tensor(np.concatenate(draws)))
    _same_decisions(got, ref, inlier_band=3)
    assert all(r.num_confident_matches == -1 and r.num_keypoints_query == r.num_matches
               for r in got)
    assert sum(r.is_valid for r in got) >= 2
    # the same seed gives the same draws, another seed other ones
    a = v.verify_pairs_batch(gray[q], gray[m], K, indices=PAIRS, batch_size=3, seed=0)
    b = v.verify_pairs_batch(gray[q], gray[m], K, indices=PAIRS, batch_size=3, seed=0)
    assert [r.num_inliers for r in a] == [r.num_inliers for r in b]


def test_pad_pairs_pow2_and_build_matcher():
    for P in (1, 5, 8, 9):
        x = np.arange(P * 6, dtype=np.float32).reshape(P, 2, 3, 1)
        want = [np.asarray(t) for t in jv._pad_pairs_pow2(x, x + 1)]
        got = [t.numpy() for t in tv._pad_pairs_pow2(torch.from_numpy(x), torch.from_numpy(x + 1))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for name, cls in (("lightglue", "LightGlue"), ("superglue", "SuperGlue"), ("loftr", "LoFTR"),
                      ("orb", "ORBMatcher")):
        assert type(tv._build_matcher(name, device="cpu")).__name__ == cls
        assert type(jv._build_matcher(name)).__name__ == cls
    with pytest.raises(ValueError, match="Unknown matcher"):
        tv._build_matcher("sift")


def test_ransac_without_k(scene):
    """verify_geometric_consistency without K: the unit camera scaled by the
    largest coordinate, as in the JAX package, on the JAX package's own
    ORB matches."""
    images, _, _ = scene
    from mlis_tpu.models.orb import ORBMatcher as JaxORB

    k1, k2, _ = JaxORB().detect_and_match(images[0], images[8])
    mask, E, ratio = JaxORB().verify_geometric_consistency(k1, k2, None, 3.0)
    tmask, tE, tratio = ORBMatcher(device="cpu").verify_geometric_consistency(
        k1, k2, None, 3.0, uniforms=_key0())
    assert int(tmask.sum()) == int(mask.sum()) > 10 and abs(tratio - ratio) < 1e-6
    empty = ORBMatcher(device="cpu").verify_geometric_consistency(k1[:4], k2[:4], None)
    assert len(empty[0]) == 0 and empty[1] is None and empty[2] == 0.0
