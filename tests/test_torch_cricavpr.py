"""The port's CricaVPR (models/cricavpr.py, ops/pooling.py) against
mlis_tpu's: the pooling ops, a tiny encoder with its patch cache and
rerank, the shipped 12 x 768 ViT-B/14 checkpoint at full width, and the
full gate at its default VPR method, pair for pair."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.gating.full_gate import FullGatePipeline as JaxGate  # noqa: E402
from mlis_tpu.gating.place_recognition import PlaceMatch as JaxMatch  # noqa: E402
from mlis_tpu.gating.verification import GeometricVerifier as JaxVerifier  # noqa: E402
from mlis_tpu.models.cricavpr import CricaVPR as JaxCrica  # noqa: E402
from mlis_tpu.models.lightglue import LightGlue as JaxLG  # noqa: E402
from mlis_tpu.models.lightglue import MatcherConfig as JaxMC  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JaxSPC  # noqa: E402
from mlis_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from mlis_tpu.ops import pooling as jpool  # noqa: E402
from test_torch_full_gate import K_CAM, _scene_images, jax_ransac_uniforms  # noqa: E402

from mlis_tpu_torch.config import PipelineConfig  # noqa: E402
from mlis_tpu_torch.gating.full_gate import FullGatePipeline  # noqa: E402
from mlis_tpu_torch.gating.place_recognition import PlaceMatch, SemanticPlaceRecognition  # noqa: E402
from mlis_tpu_torch.gating.verification import GeometricVerifier  # noqa: E402
from mlis_tpu_torch.models.cricavpr import CricaVPR  # noqa: E402
from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig  # noqa: E402
from mlis_tpu_torch.models.vit import ViTConfig  # noqa: E402
from mlis_tpu_torch.ops import pooling as tpool  # noqa: E402
from mlis_tpu_torch.weights import default_crica_checkpoint, from_jax_params  # noqa: E402

TINY_HW = (98, 98)  # a 7x7 patch grid: the 8x8 position table is resampled
TINY_DIM = 96  # wider than the ViT's 64: fit_descriptor_dim zero-pads


def _tiny_pair(imagenet=True, seed=0):
    # LayerScale at 0.5 instead of 1e-5, so that the blocks move the tokens
    ref = JaxCrica(descriptor_dim=TINY_DIM, seed=seed, input_size=TINY_HW,
                   imagenet_preproc=imagenet,
                   vit_cfg=JaxViTConfig.tiny_test(dtype=jnp.float32, layerscale_init=0.5))
    port = CricaVPR(descriptor_dim=TINY_DIM, input_size=TINY_HW, imagenet_preproc=imagenet,
                    vit_cfg=ViTConfig.tiny_test(dtype=torch.float32), checkpoint=None,
                    device="cpu")
    port.load_state(from_jax_params(jax.device_get(ref.params)))
    return ref, port


def test_pooling_ops_match():
    rng = np.random.default_rng(0)
    toks = rng.normal(size=(3, 20, 16)).astype(np.float32)
    np.testing.assert_allclose(tpool.gem_pool(torch.from_numpy(toks)).numpy(),
                               np.asarray(jpool.gem_pool(jnp.asarray(toks))), rtol=1e-5, atol=1e-7)
    stack = rng.normal(size=(6, 9, 16)).astype(np.float32)
    stack[5] = -stack[0]  # a negative correlation: both directions clip at 0
    np.testing.assert_allclose(
        float(tpool.cross_correlation_score(torch.from_numpy(stack[0]), torch.from_numpy(stack[1]))),
        float(jpool.cross_correlation_score(jnp.asarray(stack[0]), jnp.asarray(stack[1]))), atol=1e-6)
    np.testing.assert_allclose(
        tpool.cross_correlation_scores_batch(torch.from_numpy(stack[0]), torch.from_numpy(stack)).numpy(),
        np.asarray(jpool.cross_correlation_scores_batch(jnp.asarray(stack[0]), jnp.asarray(stack))),
        atol=1e-6)
    qi = np.array([0, 3, 5, 1, 2], np.int32)
    ci = rng.integers(0, 6, size=(5, 4)).astype(np.int32)
    want = np.asarray(jpool.cross_correlation_scores_pairs(jnp.asarray(stack), jnp.asarray(qi),
                                                           jnp.asarray(ci), batch_size=2))
    got = tpool.cross_correlation_scores_pairs(torch.from_numpy(stack), torch.from_numpy(qi),
                                               torch.from_numpy(ci), batch_size=2).numpy()
    # float32 correlations of unit vectors: sums in another order
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert tpool.cross_correlation_scores_pairs(
        torch.from_numpy(stack), torch.zeros(0, dtype=torch.int32),
        torch.zeros((0, 4), dtype=torch.int32)).shape == (0, 4)


@pytest.mark.parametrize("imagenet", [True, False])
def test_tiny_cricavpr_descriptors_cache_and_rerank(imagenet):
    rng = np.random.default_rng(1)
    ref, port = _tiny_pair(imagenet)
    imgs = np.kron(rng.integers(0, 255, (6, 15, 20), dtype=np.uint8), np.ones((8, 8), np.uint8))
    for sl in (slice(0, 4), slice(4, 6)):  # the patch cache grows over batches
        want = np.asarray(ref.encode_batch_device(imgs[sl]))
        got = port.encode_batch_device(imgs[sl])
        assert got.shape == (sl.stop - sl.start, TINY_DIM) and got.dtype == torch.float32
        # float32 through two ViT blocks and GeM: 1e-6 relative
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
        assert not got[:, 64:].any()  # zero-padded to the descriptor slot
    assert len(port.patch_cache) == len(ref.patch_cache) == 6
    pm = port.patch_matrix()
    assert pm.shape == (6, 49, 64)
    np.testing.assert_allclose(pm.numpy(), np.asarray(ref.patch_matrix()), atol=2e-5)

    qi = np.array([0, 2, 5])
    ci = np.array([[1, 2, 3], [0, 4, 5], [1, 1, 2]])
    np.testing.assert_allclose(port.rerank_scores_all(qi, ci, batch_size=2),
                               ref.rerank_scores_all(qi, ci, batch_size=2), atol=1e-5)
    sims = [0.9, 0.4, 0.7]
    want = ref.rerank_candidates(0, [JaxMatch(0, j, s, 0.0, 30.0 * j) for j, s in zip((1, 3, 5), sims)],
                                 top_k=2)
    got = port.rerank_candidates(0, [PlaceMatch(0, j, s, 0.0, 30.0 * j) for j, s in zip((1, 3, 5), sims)],
                                 top_k=2)
    assert [m.match_idx for m in got] == [m.match_idx for m in want] and len(got) == 2
    np.testing.assert_allclose([m.similarity for m in got], [m.similarity for m in want], atol=1e-5)
    assert got[0].match_timestamp == want[0].match_timestamp


def test_shipped_vitb14_checkpoint_at_full_width():
    """vpr_crica.npz (12 blocks x 768) loaded into both packages: the
    descriptors of two 270x360 mono frames, float32."""
    from mlis_tpu.train.pretrain_vpr import load_crica_vpr

    if default_crica_checkpoint() is None:
        pytest.skip("checkpoints/vpr_crica.npz is not in the repository")
    rng = np.random.default_rng(2)
    imgs = np.kron(rng.integers(0, 255, (2, 35, 46), dtype=np.uint8),
                   np.ones((8, 8), np.uint8))[:, :270, :360]
    ref = load_crica_vpr(vit_cfg=JaxViTConfig.dinov2_vitb14(dtype=jnp.float32))
    want = np.asarray(ref.encode_batch_device(imgs))
    port = CricaVPR(vit_cfg=ViTConfig.dinov2_vitb14(dtype=torch.float32), device="cpu")
    got = port.encode_batch(imgs)
    assert got.shape == want.shape == (2, 10752)
    # unit descriptors after 12 float32 blocks: 7e-8 measured, 1e-6 allowed
    np.testing.assert_allclose(got, want, atol=1e-6)
    pw = np.asarray(ref.patch_matrix())
    pg = port.patch_matrix().numpy()
    assert pg.shape == (2, 529, 768)
    # raw patch tokens (|x| up to ~10): 2.5e-4 measured, 1e-4 relative allowed
    np.testing.assert_allclose(pg, pw, rtol=1e-4, atol=1e-3)


def test_cricavpr_gate_pair_for_pair():
    """FullGatePipeline at its default VPR method (CricaVPR, tiny ViT) in
    both packages, the reference's RANSAC draws fed to the port."""
    rng = np.random.default_rng(0)
    n = 16
    images = _scene_images(rng, n)[..., 0]  # mono8
    times = np.arange(n) * 30.0
    floors = np.asarray([5] * 8 + [2] * 8)
    lg = JaxLG(sp_cfg=JaxSPC.tiny_test(max_keypoints=64, dtype=jnp.float32),
               matcher_cfg=JaxMC.tiny_test(dtype=jnp.float32))
    jpipe = JaxGate(verifier=JaxVerifier(matcher=lg), similarity_threshold=0.9, verify_batch=8,
                    descriptor_dim=TINY_DIM, input_size=TINY_HW,
                    vit_cfg=JaxViTConfig.tiny_test(dtype=jnp.float32, layerscale_init=0.5))
    assert type(jpipe.spr.vpr).__name__ == "CricaVPR"
    ref = jpipe.process(images, times, floors, K_CAM)

    port_lg = LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=64, dtype=torch.float32),
                        matcher_cfg=MatcherConfig.tiny_test(dtype=torch.float32), device="cpu")
    port_lg.sp.load_state(from_jax_params(jax.device_get(lg.sp.params)))
    port_lg.net.load_state_dict(from_jax_params(jax.device_get(lg.params)))
    pipe = FullGatePipeline(
        verifier=GeometricVerifier(matcher=port_lg), similarity_threshold=0.9, verify_batch=8,
        matcher_weights=None, device="cpu", descriptor_dim=TINY_DIM, input_size=TINY_HW,
        vit_cfg=ViTConfig.tiny_test(dtype=torch.float32), checkpoint=None)
    assert isinstance(pipe.spr.vpr, CricaVPR)
    pipe.spr.vpr.load_state(from_jax_params(jax.device_get(jpipe.spr.vpr.params)))
    u = torch.from_numpy(jax_ransac_uniforms(ref.verified, 8, 512))
    got = pipe.process(images, times, floors, K_CAM, ransac_uniforms=u)

    assert ref.total_pairs > 0 and ref.cross_floor_rejected > 0 and ref.verified > 0
    assert (got.total_pairs, got.cross_floor_rejected, got.verified) == (
        ref.total_pairs, ref.cross_floor_rejected, ref.verified)
    assert [(r.query_idx, r.match_idx) for r in got.results] == [
        (r.query_idx, r.match_idx) for r in ref.results]
    for a, b in zip(got.results, ref.results):
        assert a.is_valid == b.is_valid and a.num_matches == b.num_matches
        # float32 sums differ in order between XLA and torch: an inlier at
        # the Sampson threshold may flip
        assert abs(a.num_inliers - b.num_inliers) <= 1
    assert got.geometrically_valid == ref.geometrically_valid
    assert len(pipe.spr.vpr.patch_cache) == n  # the rerank cache filled on the way


def test_default_config_builds_the_cricavpr_gate():
    """FullGatePipeline() and from_config(PipelineConfig()) build the
    CricaVPR gate with the shipped ViT-B/14, as mlis_tpu's do."""
    pipe = FullGatePipeline.from_config(PipelineConfig(), device="cpu")
    vpr = pipe.spr.vpr
    assert isinstance(vpr, CricaVPR) and vpr.descriptor_dim == 10752
    assert vpr.input_size == (322, 322) and vpr.module.cfg == ViTConfig.dinov2_vitb14()
    assert vpr.module.pos_embed.abs().sum() > 0  # vpr_crica.npz loaded
    assert isinstance(FullGatePipeline(device="cpu", matcher_weights=None).spr.vpr, CricaVPR)
