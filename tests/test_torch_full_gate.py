"""The port's full semantic gate held pair for pair against mlis_tpu's
two-phase path, on the inputs of tests/test_full_gate.py (tiny float32
SuperPoint and matcher, the patch encoder, 120x160 keyframes)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.gating.full_gate import FullGatePipeline as JaxGate  # noqa: E402
from mlis_tpu.gating.full_gate import _gate_compact as jax_gate_compact  # noqa: E402
from mlis_tpu.gating.place_recognition import (  # noqa: E402
    BasePlaceRecognition as JaxDB,
    SemanticPlaceRecognition as JaxSPR,
)
from mlis_tpu.gating.verification import GeometricVerifier as JaxVerifier  # noqa: E402
from mlis_tpu.models.lightglue import LightGlue as JaxLG  # noqa: E402
from mlis_tpu.models.lightglue import MatcherConfig as JaxMC  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JaxSPC  # noqa: E402
from mlis_tpu.models.weights import matcher_arch_from_npz  # noqa: E402

from mlis_tpu_torch.config import PipelineConfig  # noqa: E402
from mlis_tpu_torch.gating.full_gate import FullGatePipeline, _gate_compact  # noqa: E402
from mlis_tpu_torch.gating.place_recognition import (  # noqa: E402
    BasePlaceRecognition,
    SemanticPlaceRecognition,
)
from mlis_tpu_torch.gating.verification import GeometricVerifier  # noqa: E402
from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig  # noqa: E402
from mlis_tpu_torch.weights import from_jax_params  # noqa: E402

K_CAM = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]])
HYP = 512
VERIFY_BATCH = 8


class _PatchEncoder:
    """Deterministic cheap encoder: downsampled grayscale as descriptor."""

    def encode_batch(self, images):
        x = np.asarray(images).astype(np.float32)
        if x.ndim == 4:
            x = x.mean(-1)
        d = x[:, ::12, ::12].reshape(x.shape[0], -1)
        return d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-8)


def _scene_images(rng, n):
    bases = [
        np.kron(
            rng.integers(0, 255, (15, 20, 3), dtype=np.uint8),
            np.ones((8, 8, 1), np.uint8),
        )[:120, :160]
        for _ in range(4)
    ]
    return np.stack([bases[i % 4] for i in range(n)])


def jax_ransac_uniforms(n_surv: int, verify_batch: int, hyp: int) -> np.ndarray:
    """The uniforms mlis_tpu's two-phase path draws for each survivor:
    bucket keys PRNGKey(end offset of the bucket), split per pair."""
    out, s = [], 0
    for size in JaxGate._bucket_sizes(n_surv, verify_batch):
        take = min(size, n_surv - s)
        s += size
        keys = jax.random.split(jax.random.PRNGKey(s), size)
        u = jax.vmap(lambda k: jax.random.uniform(k, (hyp, 8)))(keys)
        out.append(np.asarray(u[:take]))
    return np.concatenate(out)


def _jax_pipeline():
    spr = JaxSPR(vpr_method=JaxDB(descriptor_dim=110, encoder=_PatchEncoder()),
                 similarity_threshold=0.9, min_time_gap=10.0)
    lg = JaxLG(sp_cfg=JaxSPC.tiny_test(max_keypoints=64, dtype=jnp.float32),
               matcher_cfg=JaxMC.tiny_test(dtype=jnp.float32))
    return JaxGate(vpr=spr, verifier=JaxVerifier(matcher=lg),
                   similarity_threshold=0.9, verify_batch=VERIFY_BATCH)


def _port_pipeline(jax_lg):
    lg = LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=64, dtype=torch.float32),
                   matcher_cfg=MatcherConfig.tiny_test(dtype=torch.float32), device="cpu")
    lg.sp.load_state(from_jax_params(jax.device_get(jax_lg.sp.params)))
    lg.net.load_state_dict(from_jax_params(jax.device_get(jax_lg.params)))
    spr = SemanticPlaceRecognition(
        vpr_method=BasePlaceRecognition(descriptor_dim=110, encoder=_PatchEncoder()),
        similarity_threshold=0.9, min_time_gap=10.0, device="cpu")
    return FullGatePipeline(vpr=spr, verifier=GeometricVerifier(matcher=lg),
                            similarity_threshold=0.9, verify_batch=VERIFY_BATCH,
                            matcher_weights=None, device="cpu")


@pytest.mark.parametrize("mono", [False, True])
def test_full_gate_pair_for_pair(mono):
    rng = np.random.default_rng(0)
    n = 16
    images = _scene_images(rng, n)
    if mono:
        images = images[..., 0]
    times = np.arange(n) * 30.0
    floors = np.asarray([5] * 8 + [2] * 8)

    jpipe = _jax_pipeline()
    ref = jpipe.process(images, times, floors, K_CAM)
    pipe = _port_pipeline(jpipe.verifier.matcher)
    u = torch.from_numpy(jax_ransac_uniforms(ref.verified, VERIFY_BATCH, HYP))
    got = pipe.process(images, times, floors, K_CAM, ransac_uniforms=u)

    assert ref.total_pairs > 0 and ref.cross_floor_rejected > 0
    assert (got.total_pairs, got.cross_floor_rejected, got.verified) == (
        ref.total_pairs, ref.cross_floor_rejected, ref.verified)
    assert [(r.query_idx, r.match_idx) for r in got.results] == [
        (r.query_idx, r.match_idx) for r in ref.results]
    for a, b in zip(got.results, ref.results):
        assert a.is_valid == b.is_valid
        assert (a.num_keypoints_query, a.num_keypoints_match) == (
            b.num_keypoints_query, b.num_keypoints_match)
        assert a.num_matches == b.num_matches
        # float32 sums differ in order between XLA and torch: an inlier at
        # the Sampson threshold may flip
        assert abs(a.num_inliers - b.num_inliers) <= 1
        assert a.num_confident_matches == b.num_confident_matches
    assert got.geometrically_valid == ref.geometrically_valid
    assert set(got.summary()["stage_seconds"]) == {"vpr", "retrieval", "verification"}


@pytest.mark.parametrize("budget", ["above", "below"])
def test_bench_call_shape_matches_the_plain_call(budget):
    """bench.py's reps call process(..., encode_batch_size=128,
    survivor_budget=b, monolithic=True); the keywords change nothing: the
    pairs and decisions equal those of the call without them, with b above
    and below the survivor count."""
    rng = np.random.default_rng(0)
    n = 16
    images = _scene_images(rng, n)[..., 0]  # mono8, as bench.py's keyframes
    times = np.arange(n) * 30.0
    floors = np.asarray([5] * 8 + [2] * 8)
    jpipe = _jax_pipeline()
    pipe = _port_pipeline(jpipe.verifier.matcher)
    plain = pipe.process(images, times, floors, K_CAM, encode_batch_size=128,
                         generator=torch.Generator().manual_seed(0))
    assert plain.verified > 1
    b = plain.verified + 5 if budget == "above" else plain.verified // 2
    pipe.spr.vpr.descriptors = []  # the database accumulates across calls
    got = pipe.process(images, times, floors, K_CAM, encode_batch_size=128,
                       survivor_budget=b, monolithic=True, upload_chunk=8,
                       generator=torch.Generator().manual_seed(0))
    assert (got.total_pairs, got.cross_floor_rejected, got.verified) == (
        plain.total_pairs, plain.cross_floor_rejected, plain.verified)
    assert [(r.query_idx, r.match_idx, r.is_valid, r.num_matches, r.num_inliers)
            for r in got.results] == [
        (r.query_idx, r.match_idx, r.is_valid, r.num_matches, r.num_inliers)
        for r in plain.results]
    assert got.geometrically_valid == plain.geometrically_valid


def test_full_gate_no_verify_and_empty():
    rng = np.random.default_rng(1)
    images = _scene_images(rng, 12)
    jpipe = _jax_pipeline()
    pipe = _port_pipeline(jpipe.verifier.matcher)
    res = pipe.process(images, np.arange(12) * 30.0, np.full(12, 5), K_CAM, verify=False)
    ref = jpipe.process(images, np.arange(12) * 30.0, np.full(12, 5), K_CAM, verify=False)
    assert (res.total_pairs, res.cross_floor_rejected, res.verified) == (
        ref.total_pairs, 0, 0)
    pipe.similarity_threshold = 1.1
    pipe.spr.vpr.descriptors = []  # the database accumulates across calls
    res = pipe.process(images, np.arange(12) * 30.0, np.full(12, 5), K_CAM)
    assert res.total_pairs == 0 and res.pairs_per_sec == 0.0


@pytest.mark.parametrize("n,k,strict", [(40, 10, True), (64, 5, False), (24, 24, True)])
def test_gate_compact_matches_np_unique(n, k, strict):
    """Compaction order is np.unique's ascending (lo, hi) order, and the
    counts equal mlis_tpu's device compaction; duplicated descriptors make
    exact ties."""
    rng = np.random.default_rng(n)
    base = rng.normal(size=(n // 4, 32)).astype(np.float32)
    db = np.concatenate([base] * 4) + 0.3 * rng.normal(size=(n, 32)).astype(np.float32)
    db[: n // 4] = db[n // 4 : n // 2]  # exact duplicates
    times = (np.arange(n) * 5.0).astype(np.float32)
    floors = rng.integers(0, 3, n)
    qi, mi, (total, rejected) = _gate_compact(
        torch.from_numpy(db), torch.from_numpy(times), torch.from_numpy(floors),
        k=k, threshold=0.2, min_time_gap=10.0, strict=strict)
    jq, jm, jstats = jax_gate_compact(
        jnp.asarray(db), jnp.asarray(times), jnp.asarray(floors, jnp.int32),
        k=k, M=n * k, threshold=0.2, min_time_gap=10.0, strict=strict)
    nsurv = int(jstats[2])
    assert (total, rejected) == (int(jstats[0]), int(jstats[1]))
    assert qi.tolist() == np.asarray(jq)[:nsurv].tolist()
    assert mi.tolist() == np.asarray(jm)[:nsurv].tolist()
    pairs = np.stack([qi.numpy(), mi.numpy()], 1)
    assert (pairs[:, 0] < pairs[:, 1]).all()
    np.testing.assert_array_equal(pairs, np.unique(pairs, axis=0))


def test_from_config_builds_the_mixvpr_gate():
    from mlis_tpu.config import PipelineConfig as JaxConfig

    d = JaxConfig().to_dict()  # every mlis_tpu field, the port reads its own
    d["vpr"].update(method="mixvpr", top_k=5, similarity_threshold=0.4)
    d["verification"].update(max_keypoints=256, min_inliers=15)
    d["gating"]["gate"]["strict_mode"] = False
    cfg = PipelineConfig.from_dict(d)
    pipe = FullGatePipeline.from_config(cfg, device="cpu")
    assert (pipe.top_k, pipe.similarity_threshold, pipe.strict_floor) == (5, 0.4, False)
    assert pipe.verifier.min_inliers == 15
    assert pipe.verifier.matcher.sp.cfg.max_keypoints == 256
    assert pipe.matcher_weights_loaded is not None  # shipped LightGlue loaded
    assert pipe.spr.vpr.descriptor_dim == 4096
    default = FullGatePipeline.from_config(PipelineConfig(), device="cpu")  # cricavpr, as in mlis_tpu
    assert type(default.spr.vpr).__name__ == "CricaVPR" and default.spr.vpr.descriptor_dim == 10752


def test_verify_pairs_batch_and_floor_skip():
    """GeometricVerifier.verify_pairs_batch (detect both sides, match, RANSAC)
    against mlis_tpu's, fed the reference's draws per batch; and the floor
    skip of SemanticGeometricVerifier."""
    from mlis_tpu.ops.image import to_grayscale as jax_gray

    from mlis_tpu_torch.gating.verification import SemanticGeometricVerifier

    rng = np.random.default_rng(2)
    colour = _scene_images(rng, 8)
    gray = np.asarray(jax_gray(jnp.asarray(colour)))
    im0, im1 = gray[[0, 1, 2, 3, 0]], gray[[4, 5, 6, 7, 5]]
    idx = [(0, 4), (1, 5), (2, 6), (3, 7), (0, 5)]
    ckpt = "checkpoints/lightglue_homog_sp.npz"
    jlg = JaxLG(sp_cfg=JaxSPC(max_keypoints=128, dtype=jnp.float32),
                matcher_cfg=JaxMC(dtype=jnp.float32, **matcher_arch_from_npz(ckpt)))
    jlg.load_weights(ckpt, image_hw=(120, 160))
    ref = JaxVerifier(matcher=jlg).verify_pairs_batch(
        im0, im1, K_CAM, indices=idx, seed=0, batch_size=3)
    draws = []
    for s in (0, 3):  # the reference draws with PRNGKey(seed + chunk start)
        keys = jax.random.split(jax.random.PRNGKey(s), min(3, 5 - s))
        draws.append(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (HYP, 8)))(keys)))
    port = GeometricVerifier(matcher=LightGlue.from_checkpoint(
        ckpt, sp_cfg=SuperPointConfig(max_keypoints=128, dtype=torch.float32),
        dtype=torch.float32, device="cpu"))
    got = port.verify_pairs_batch(im0, im1, K_CAM, indices=idx, batch_size=3,
                                  uniforms=torch.tensor(np.concatenate(draws)))
    assert [(r.query_idx, r.match_idx) for r in got] == idx
    for a, b in zip(got, ref):
        assert (a.num_keypoints_query, a.num_keypoints_match, a.num_matches) == (
            b.num_keypoints_query, b.num_keypoints_match, b.num_matches)
        assert abs(a.num_inliers - b.num_inliers) <= 1 and a.is_valid == b.is_valid
        assert a.num_confident_matches == b.num_confident_matches
    assert all(r.is_valid and r.num_matches > 40 for r in got[:4])  # identical scenes

    # the single-pair path on the uint8 images, as the reference takes them,
    # with the reference's draws for one pair (PRNGKey(0))
    from mlis_tpu.gating.verification import SemanticGeometricVerifier as JaxSemantic

    sem = SemanticGeometricVerifier(matcher=port.matcher)
    skipped = sem.verify_with_semantics(colour[0], colour[4], 5, 2, K_CAM, 0, 4)
    assert not skipped.is_valid and skipped.num_matches == 0 and skipped.relative_pose is None
    same = sem.verify_with_semantics(
        colour[0], colour[4], 5, 5, K_CAM, 0, 4,
        uniforms=torch.tensor(np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (HYP, 8)))))
    want = JaxSemantic(matcher=jlg).verify_with_semantics(colour[0], colour[4], 5, 5, K_CAM, 0, 4)
    assert (same.num_matches, same.is_valid) == (want.num_matches, want.is_valid)
    assert abs(same.num_inliers - want.num_inliers) <= 1
    assert (same.num_matches, same.is_valid) == (got[0].num_matches, got[0].is_valid)
    stats = sem.get_statistics()
    assert (stats["verified"], stats["skipped_floor_mismatch"], stats["skip_rate"]) == (1, 1, 0.5)
