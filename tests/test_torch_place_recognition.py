"""The port's retrieval API (gating/place_recognition.py, ops/knn.py)
against mlis_tpu's on the same descriptors: queries, the pairwise
similarity matrix, find_loop_closures with and without the CricaVPR
rerank (the same (query, match, is_valid) list, similarities within
1e-5), statistics, npz databases read across the two packages both ways,
process_image_sequence, and FullGatePipeline with SALAD and AnyLoc at 16
keyframes, pair for pair."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.gating import place_recognition as jpr  # noqa: E402
from mlis_tpu.gating.full_gate import FullGatePipeline as JaxGate  # noqa: E402
from mlis_tpu.gating.verification import GeometricVerifier as JaxVerifier  # noqa: E402
from mlis_tpu.models.lightglue import LightGlue as JaxLG  # noqa: E402
from mlis_tpu.models.lightglue import MatcherConfig as JaxMC  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JaxSPC  # noqa: E402
from mlis_tpu.models.vit import ViTConfig as JaxViTConfig  # noqa: E402
from mlis_tpu.ops import knn as jknn  # noqa: E402
from test_torch_full_gate import (  # noqa: E402
    K_CAM,
    _PatchEncoder,
    _scene_images,
    jax_ransac_uniforms,
)

from mlis_tpu_torch.eval.quality import decision_drift  # noqa: E402
from mlis_tpu_torch.gating import place_recognition as tpr  # noqa: E402
from mlis_tpu_torch.gating.full_gate import FullGatePipeline  # noqa: E402
from mlis_tpu_torch.gating.verification import GeometricVerifier  # noqa: E402
from mlis_tpu_torch.models.anyloc import AnyLoc  # noqa: E402
from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig  # noqa: E402
from mlis_tpu_torch.models.salad import SALAD  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig  # noqa: E402
from mlis_tpu_torch.models.vit import ViTConfig  # noqa: E402
from mlis_tpu_torch.ops import knn as tknn  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_vpr, from_jax_params  # noqa: E402

SIM_ATOL = 1e-5


def _descriptors(seed, n=24, d=32):
    """Descriptors of n frames revisiting n / 3 places, with exact
    duplicates (score ties) and floors 1/2 with some unknown."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n // 3, d)).astype(np.float32)
    desc = base[np.arange(n) % (n // 3)] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    desc[n - 1] = desc[n // 3 - 1]
    times = np.arange(n) * 7.0
    floors = [None if i % 11 == 5 else 1 + (i // (n // 2)) for i in range(n)]
    return desc, times, floors


def _fill(db, desc, times, floors, paths=True):
    for i, (d, t, f) in enumerate(zip(desc, times, floors)):
        db.add_descriptor(d, float(t), f, f"frame_{i}.png" if paths and i % 2 else None)
    return db


class _Rerank:
    """A CricaVPR-style database: a patch cache per entry and fixed
    correlation scores, defined alike in both packages."""

    use_reranking = True
    rerank_weight = 0.5

    def rerank_scores_all(self, q, idx):
        return self.cc[np.asarray(q)[:, None], np.asarray(idx)]


def _rerank_dbs(cc, n):
    J = type("J", (_Rerank, jpr.BasePlaceRecognition), {})
    T = type("T", (_Rerank, tpr.BasePlaceRecognition), {})
    j, t = J(descriptor_dim=32), T(descriptor_dim=32, device="cpu")
    for db in (j, t):
        db.cc, db.patch_cache = cc, [None] * n
    return j, t


def _same_matches(got, want):
    assert [(m.query_idx, m.match_idx, m.is_valid) for m in got] == \
        [(m.query_idx, m.match_idx, m.is_valid) for m in want]
    np.testing.assert_allclose([m.similarity for m in got], [m.similarity for m in want],
                               atol=SIM_ATOL, rtol=0)
    for a, b in zip(got, want):
        assert (a.query_timestamp, a.match_timestamp) == (b.query_timestamp, b.match_timestamp)


@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("gating", [True, False])
def test_find_loop_closures_matches(rerank, gating):
    desc, times, floors = _descriptors(0)
    n = len(desc)
    if rerank:
        # correlation scores that reorder some candidates, some into exact
        # ties of the mixed score (the re-sort is stable)
        cc = np.random.default_rng(1).uniform(size=(n, n)).astype(np.float32)
        cc[:, ::5] = 0.25
        jdb, tdb = _rerank_dbs(cc, n)
    else:
        jdb, tdb = jpr.BasePlaceRecognition(32), tpr.BasePlaceRecognition(32, device="cpu")
    ref = jpr.SemanticPlaceRecognition(_fill(jdb, desc, times, floors), similarity_threshold=0.3,
                                       min_time_gap=10.0)
    port = tpr.SemanticPlaceRecognition(_fill(tdb, desc, times, floors), similarity_threshold=0.3,
                                        min_time_gap=10.0)
    want = ref.find_loop_closures(enable_floor_gating=gating, k=6, rerank=rerank)
    got = port.find_loop_closures(enable_floor_gating=gating, k=6, rerank=rerank)
    assert len(want) > 20 and any(not m.is_valid for m in want) == gating
    _same_matches(got, want)
    assert port.get_statistics(got) == pytest.approx(ref.get_statistics(want), abs=1e-6)
    assert port.get_statistics([]) == ref.get_statistics([])
    one = tpr.SemanticPlaceRecognition(tpr.BasePlaceRecognition(32, device="cpu"))
    one.vpr.add_descriptor(desc[0], 0.0)
    assert one.find_loop_closures() == []


def test_queries_similarities_and_topk():
    desc, times, floors = _descriptors(2)
    enc = _PatchEncoder()
    jdb = _fill(jpr.BasePlaceRecognition(32, encoder=enc), desc, times, floors)
    tdb = _fill(tpr.BasePlaceRecognition(32, encoder=enc, device="cpu"), desc, times, floors)
    np.testing.assert_array_equal(tdb.floor_labels(), jdb.floor_labels())
    assert tdb.floor_labels()[5] == tpr.NO_FLOOR
    np.testing.assert_allclose(tdb.compute_all_pairwise_similarities(),
                               jdb.compute_all_pairwise_similarities(), atol=1e-6)
    # a query image through the encoder: a 12-pixel grid of a 96x32 frame
    # gives a 24-d descriptor, so both databases get 24-d entries
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 255, (6, 96, 32), dtype=np.uint8)
    jq, tq = jpr.BasePlaceRecognition(24, encoder=enc), tpr.BasePlaceRecognition(
        24, encoder=enc, device="cpu")
    for i, f in enumerate(frames[:5]):
        for db in (jq, tq):
            db.add_image(f if i != 3 else frames[0], 30.0 * i, i % 2)
    for ts, k in ((None, 3), (35.0, 4), (0.0, 10)):
        want = jq.query(frames[0], timestamp=ts, k=k)
        got = tq.query(frames[0], timestamp=ts, k=k)
        _same_matches(got, want)
        assert all(m.query_idx == 5 for m in got)
    assert tpr.BasePlaceRecognition(24, device="cpu").query(frames[0]) == []
    np.testing.assert_allclose(tq.extract_descriptor(frames[1]), jq.extract_descriptor(frames[1]))
    # every frame against the database
    js, ji = jknn.loop_closure_topk(jnp.asarray(desc), jnp.asarray(times, jnp.float32), k=5)
    ts_, ti = tknn.loop_closure_topk(torch.from_numpy(desc), torch.from_numpy(times), k=5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts_, js, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_database_files_cross_packages(tmp_path, writer):
    desc, times, floors = _descriptors(4)
    dbs = {"jax": jpr.BasePlaceRecognition(32), "port": tpr.BasePlaceRecognition(32, device="cpu")}
    _fill(dbs[writer], desc, times, floors)
    path = tmp_path / "db.npz"
    dbs[writer].save_database(path)
    reader = dbs["port" if writer == "jax" else "jax"]
    assert reader.load_database(path) == len(desc)
    for a, b in zip(reader.descriptors, dbs[writer].descriptors):
        np.testing.assert_array_equal(a.descriptor, b.descriptor)
        assert (a.timestamp, a.floor_label, a.image_path) == (b.timestamp, b.floor_label,
                                                               b.image_path)
    empty = tmp_path / "empty.npz"
    tpr.BasePlaceRecognition(32, device="cpu").save_database(empty)
    assert jpr.BasePlaceRecognition(32).load_database(empty) == 0


def test_build_vpr_menu_and_process_image_sequence():
    kw = dict(vit_cfg=ViTConfig.tiny_test(dtype=torch.float32), input_size=(56, 56))
    assert isinstance(tpr._build_vpr("salad", device="cpu", num_clusters=4, cluster_dim=8,
                                     token_dim=16, **kw), SALAD)
    assert isinstance(tpr._build_vpr("anyloc", device="cpu", num_clusters=4, **kw), AnyLoc)
    with pytest.raises(ValueError, match="Unknown VPR method"):
        tpr._build_vpr("netvlad", device="cpu")
    rng = np.random.default_rng(5)
    images = _scene_images(rng, 12)[:, :56, :56]
    times = np.arange(12) * 20.0
    floors = np.asarray([1] * 6 + [2] * 6)
    spr, got = tpr.process_image_sequence(images, times, floors, vpr_method="anyloc",
                                          batch_size=5, device="cpu", num_clusters=4, **kw)
    assert len(spr.vpr.descriptors) == 12
    # the same database in the JAX package gives the same matches
    ref = jpr.SemanticPlaceRecognition(jpr.BasePlaceRecognition(256), similarity_threshold=0.5)
    for d in spr.vpr.descriptors:
        ref.vpr.add_descriptor(d.descriptor, d.timestamp, d.floor_label)
    want = ref.find_loop_closures(enable_floor_gating=True)
    assert len(want) > 0 and any(not m.is_valid for m in want)
    _same_matches(got, want)


def _port_matcher(lg):
    """The tiny float32 matcher with the JAX package's (initialised) weights."""
    port = LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=64, dtype=torch.float32),
                     matcher_cfg=MatcherConfig.tiny_test(dtype=torch.float32), device="cpu")
    port.sp.load_state(from_jax_params(jax.device_get(lg.sp.params)))
    port.net.load_state_dict(from_jax_params(jax.device_get(lg.params)))
    return port


def _pairs(results):
    return [{"q": r.query_idx, "m": r.match_idx, "is_valid": bool(r.is_valid),
             "num_inliers": int(r.num_inliers),
             "num_confident_matches": int(r.num_confident_matches)}
            for r in results]


@pytest.mark.parametrize("method", ["salad", "anyloc"])
def test_gate_with_salad_and_anyloc_pair_for_pair(method):
    """FullGatePipeline(vpr_method=...) with small float32 encoders and the
    tiny matcher in both packages, the reference's RANSAC draws fed to the
    port: identical candidate, rejected and verified lists, decisions
    under decision_drift's float32 bands."""
    rng = np.random.default_rng(0)
    n = 16
    images = _scene_images(rng, n)[..., 0]  # mono8
    times = np.arange(n) * 30.0
    floors = np.asarray([5] * 8 + [2] * 8)
    enc = dict(input_size=(98, 98), num_clusters=4)
    if method == "salad":
        enc.update(cluster_dim=16, token_dim=32)
    lg = JaxLG(sp_cfg=JaxSPC.tiny_test(max_keypoints=64, dtype=jnp.float32),
               matcher_cfg=JaxMC.tiny_test(dtype=jnp.float32))
    # LayerScale at 0.5 instead of 1e-5, so that the blocks move the tokens
    jpipe = JaxGate(vpr_method=method, verifier=JaxVerifier(matcher=lg), similarity_threshold=0.9,
                    verify_batch=8,
                    vit_cfg=JaxViTConfig.tiny_test(dtype=jnp.float32, layerscale_init=0.5), **enc)
    ref = jpipe.process(images, times, floors, K_CAM)
    port_lg = _port_matcher(lg)
    pipe = FullGatePipeline(vpr_method=method, verifier=GeometricVerifier(matcher=port_lg),
                            similarity_threshold=0.9, verify_batch=8, matcher_weights=None,
                            device="cpu", vit_cfg=ViTConfig.tiny_test(dtype=torch.float32), **enc)
    assert type(pipe.spr.vpr).__name__ == type(jpipe.spr.vpr).__name__
    vpr = jpipe.spr.vpr
    carry_jax_vpr(pipe.spr.vpr, jax.device_get(vpr.params),
                  centers=np.asarray(vpr.centers) if method == "anyloc" else None)
    u = torch.from_numpy(jax_ransac_uniforms(ref.verified, 8, 512))
    got = pipe.process(images, times, floors, K_CAM, ransac_uniforms=u)

    assert ref.total_pairs > 0 and ref.cross_floor_rejected > 0 and ref.verified > 0
    assert (got.total_pairs, got.cross_floor_rejected, got.verified) == (
        ref.total_pairs, ref.cross_floor_rejected, ref.verified)
    assert [(r.query_idx, r.match_idx) for r in got.results] == [
        (r.query_idx, r.match_idx) for r in ref.results]
    drift, broken = decision_drift(_pairs(got.results), _pairs(ref.results), conf_band=1,
                                   inlier_band=3, bound_inliers=True)
    assert not broken, broken
    assert drift["decisions_differing"] == 0 and got.geometrically_valid == ref.geometrically_valid
