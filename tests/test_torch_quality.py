"""The port's decision-quality harness held against mlis_tpu's on the same
scene: the JAX package renders a v2 GT scene (seed 0, 2 floors x 4 places
x 2 passes at 135x180), and both packages run the LightGlue row of
bench.py's quality2 mode on it (the parallax-trained checkpoint, the
parallax-trained tiny VPR encoder, top-16 retrieval at threshold 0.30,
128 keypoints), the port with the RANSAC draws of the JAX package's
two-phase path. Both packages' pair lists are held to the band rule of
``decision_drift`` (mlis_tpu_torch/eval/quality.py): identical verified
pairs, confident matches within a band, and decisions equal except where
a count lies in the band around its cut.

float32 models, the issue's rule. With SuperPoint and LightGlue in
float32 (the JAX package's configs swapped for float32 ones inside the
test), confident matches agree within 1 (measured: equal on all 42
pairs), inliers within 3 on every pair past the confident cut (measured:
equal), decisions within the band around 6 +- 1 confident matches, 20 +- 3
inliers and 0.25 +- 0.01 ratio (measured: every decision equal). On 12
wrong-place pairs with at most 4 confident matches, inliers differ by up
to 7 though the match counts agree (41 of 42 pairs equal, one 1 apart):
there E is not pinned down and the float32 8-point solve picks another
hypothesis (ROADMAP Queue 3, "8-point hypotheses differ in float32"), so
inliers are bounded only past the confident cut; their decision is fixed
by the cut. test_float32_8_point_drift_is_rounding_not_scoring (in
test_torch_quality_f32.py, with the float32 harness run) shows that
the drift is the solve's float32 rounding: fed the JAX package's own
hypotheses, the port's scoring and selection give its inliers exactly.

bf16 models as shipped, a wider band. bf16 SuperPoint summed in another
order (oneDNN vs XLA) moves a few keypoints across the top-128 cut and
reorders others, which float32 does not: confident matches agree within
3 (measured: 2 here, 3 between the card and the CPU in chip_smoke.py
phase 7), and inliers follow the match sets (measured up to 12 apart,
not bounded); decisions may differ only within 3 of 6 confident matches,
3 of 20 inliers or 0.01 of a 0.25 ratio.

Measured on this scene: 105 candidates, 63 floor-rejected, 42 verified,
1 accepted by both in either dtype; 11 of the 42 pairs lie in the float32
band and 18 in the bf16 one, and every decision is equal in both. F1, precision and recall must be equal
whenever every decision is.
"""

import dataclasses
import os
import pickle
from typing import Any

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.eval import quality as jq  # noqa: E402
from mlis_tpu.eval.semantic_eval import LoopClosureMetrics as JaxMetrics  # noqa: E402
from mlis_tpu.gating.full_gate import FullGatePipeline as JaxGate  # noqa: E402
from mlis_tpu.gating.gate import gate_mask as jax_gate_mask  # noqa: E402
from mlis_tpu.models.weights import default_parallax_matcher_checkpoint as jax_parallax  # noqa: E402
from mlis_tpu.ops.knn import cosine_topk as jax_cosine_topk  # noqa: E402
from mlis_tpu.train.pretrain_vpr import load_encoder as jax_load_encoder  # noqa: E402

from mlis_tpu_torch.eval import quality as tq  # noqa: E402
from mlis_tpu_torch.eval.semantic_eval import LoopClosureMetrics  # noqa: E402
from mlis_tpu_torch.gating.gate import gate_mask  # noqa: E402
from mlis_tpu_torch.ops.knn import cosine_topk  # noqa: E402
from mlis_tpu_torch.train.pretrain_vpr import ENC_HW, load_encoder  # noqa: E402
from mlis_tpu_torch.weights import default_parallax_matcher_checkpoint  # noqa: E402

HW = (135, 180)
HARNESS = dict(encoder="trained_vpr_v2", top_k=16, similarity_threshold=0.30, max_keypoints=128,
               verify_batch=64, return_pairs=True)
HYP = 512
# the band rule's bands (see the module docstring): (confident, inliers)
F32_BANDS = dict(conf_band=1, inlier_band=3, bound_inliers=True)
BF16_BANDS = dict(conf_band=3, inlier_band=3, bound_inliers=False)
# tiny ViT descriptors: bf16 GEMMs summed in another order (oneDNN vs XLA);
# each descriptor component is L2-normalised, so 2^-7 (one bf16 ulp at 1)
# bounds the drift on any element
BF16_DESC_ATOL = 2.0**-7


def jax_ransac_keys(n_surv: int, verify_batch: int) -> list:
    """The RANSAC key mlis_tpu's two-phase path gives each survivor:
    bucket keys PRNGKey(end offset of the bucket), split per pair."""
    out, s = [], 0
    for size in JaxGate._bucket_sizes(n_surv, verify_batch):
        take = min(size, n_surv - s)
        s += size
        out.extend(jax.random.split(jax.random.PRNGKey(s), size)[:take])
    return out


def jax_ransac_uniforms(n_surv: int, verify_batch: int, hyp: int) -> np.ndarray:
    """The uniforms each survivor's key draws: (n_surv, hyp, 8)."""
    keys = jnp.stack(jax_ransac_keys(n_surv, verify_batch))
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (hyp, 8)))(keys))


def shared_v2_scene(tmp_path_factory):
    """The JAX package's seed-0 v2 scene (2 floors x 4 places at 135x180),
    rendered once per test run: nine of the port's test files use it and
    each render takes the JAX package ~15 s. The first test process that
    needs it pickles it under the run's temporary root, shared by the
    xdist workers of the run, and the others read it."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's directory above the workers' own
    path = root / "jax_v2_scene_2x4_135x180_seed0.pkl"
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    sc = jq.make_quality_scene_v2(n_floors=2, n_places=4, hw=HW, seed=0)
    tmp = path.with_name(f"{path.name}.{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(sc, f)
    os.replace(tmp, path)  # atomic: a reader sees the whole file or none
    return sc


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return shared_v2_scene(tmp_path_factory)


def _both_harnesses(scene, float32: bool):
    """(JAX package's run, the port's run) with JAX's RANSAC uniforms; with
    ``float32`` both run SuperPoint and LightGlue in float32 (the JAX
    package's config classes are swapped for float32 subclasses here)."""
    with pytest.MonkeyPatch.context() as mp:
        if float32:
            from mlis_tpu.models import lightglue as jlg
            from mlis_tpu.models import superpoint as jsp

            mp.setattr(jsp, "SuperPointConfig", dataclasses.dataclass(frozen=True)(
                type("SuperPointConfig", (jsp.SuperPointConfig,),
                     {"__annotations__": {"dtype": Any}, "dtype": jnp.float32})))
            mp.setattr(jlg, "MatcherConfig", dataclasses.dataclass(frozen=True)(
                type("MatcherConfig", (jlg.MatcherConfig,),
                     {"__annotations__": {"dtype": Any}, "dtype": jnp.float32})))
        ref = jq.run_gate_quality("trained", scene=scene, weights_path=jax_parallax(), **HARNESS)
    u = torch.from_numpy(jax_ransac_uniforms(ref["verified"], HARNESS["verify_batch"], HYP))
    got = tq.run_gate_quality("trained", scene=scene, weights_path=default_parallax_matcher_checkpoint(),
                              ransac_uniforms=u, device="cpu",
                              model_dtype=torch.float32 if float32 else torch.bfloat16, **HARNESS)
    return ref, got


@pytest.fixture(scope="module")
def runs(scene):
    return _both_harnesses(scene, float32=False)


def _candidates(db_scores_idx, floors, threshold):
    """(candidate pairs, floor-rejected pairs) from a top-k result."""
    scores, idx = db_scores_idx
    cand = set()
    for q in range(scores.shape[0]):
        for k in range(scores.shape[1]):
            if np.isfinite(scores[q, k]) and scores[q, k] >= threshold:
                m = int(idx[q, k])
                cand.add((min(q, m), max(q, m)))
    return cand, {p for p in cand if floors[p[0]] != floors[p[1]]}


def _hold_to_band_rule(got, ref, bands):
    """The per-pair band rule, then the scores wherever every decision agrees."""
    drift, broken = tq.decision_drift(got["pairs"], ref["pairs"], **bands)
    print(f"band rule {bands}: {drift}")
    assert not broken, broken
    if drift["decisions_differing"] == 0:
        for key in ("f1", "precision", "recall", "true_positives", "false_positives",
                    "false_negatives", "geometrically_valid"):
            assert got[key] == ref[key], key
    assert got["geometrically_valid"] >= 1  # the decision side is exercised
    return drift


def test_harness_matches_under_the_band_rule(scene, runs):
    ref, got = runs
    assert got["weights"] == ref["weights"] == "lightglue_parallax_sp.npz"
    assert got["encoder"] == ref["encoder"] == "trained_vpr_v2"
    for key in ("n_frames", "gt_pairs", "total_candidates", "verified", "strict_floor"):
        assert got[key] == ref[key], key
    assert got["total_candidates"] > got["verified"] > 0

    # candidate and floor-rejected pairs, each package with its own encoder
    # and retrieval at the harness's settings
    t = np.asarray(scene.timestamps, np.float32)
    jenc = jax_load_encoder("checkpoints/vpr_tiny_v2.npz")
    jdb = jenc(jnp.asarray(scene.images))
    j_cand, j_rej = _candidates(
        tuple(np.asarray(x) for x in jax_cosine_topk(jdb, jdb, jnp.asarray(t), jnp.asarray(t), k=16,
                                                     min_time_gap=10.0)), scene.floors, 0.30)
    tenc = load_encoder("checkpoints/vpr_tiny_v2.npz", device="cpu")
    tdb = tenc(torch.from_numpy(scene.images))
    tt = torch.from_numpy(t)
    t_cand, t_rej = _candidates(tuple(x.numpy() for x in cosine_topk(tdb, tdb, tt, tt, k=16)),
                                scene.floors, 0.30)
    assert t_cand == j_cand and t_rej == j_rej
    assert len(t_cand) == got["total_candidates"]
    assert len(t_cand) - len(t_rej) == got["verified"]

    # verified pairs in compaction order, then the per-pair band rule
    assert [(p["q"], p["m"]) for p in got["pairs"]] == [(p["q"], p["m"]) for p in ref["pairs"]]
    assert {(p["q"], p["m"]) for p in got["pairs"]} == t_cand - t_rej
    _hold_to_band_rule(got, ref, BF16_BANDS)
    assert got["retrieval_recall"] == ref["retrieval_recall"]
    assert got["gating_effectiveness"] == ref["gating_effectiveness"]
    assert got["cross_floor_rate"] == ref["cross_floor_rate"]


def test_no_floor_gate_ablation_reaches_the_traps(scene):
    """The ablation's constant floor labels send the aliased pairs on to
    verification (decisions are still scored against the real floors)."""
    out = tq.run_gate_quality("trained", scene=scene, floor_gate=False,
                              weights_path=default_parallax_matcher_checkpoint(), device="cpu",
                              **{**HARNESS, "max_keypoints": 32, "return_pairs": True})
    assert out["verified"] == out["total_candidates"] > 0
    assert any(scene.floors[p["q"]] != scene.floors[p["m"]] for p in out["pairs"])
    assert out["gating_effectiveness"] == 0.0 or out["cross_floor_rate"] > 0


def test_encoders_match_jax(scene):
    frames = scene.images[:8]
    ref = np.asarray(jax_load_encoder("checkpoints/vpr_tiny_v2.npz")(jnp.asarray(frames)))
    enc = load_encoder("checkpoints/vpr_tiny_v2.npz", device="cpu")
    got = enc(torch.from_numpy(frames)).numpy()
    assert got.shape == ref.shape == (8, 64)
    np.testing.assert_allclose(got, ref, atol=BF16_DESC_ATOL, rtol=0)
    # colour frames are averaged to grey first
    rgb = np.repeat(frames[..., None], 3, -1)
    np.testing.assert_array_equal(enc(torch.from_numpy(rgb)).numpy(), got)
    assert ENC_HW == (64, 96)  # an 8x12 patch grid from the 8x8 position table
    # the pixel encoder is float32 throughout: resampling sums differ in order
    np.testing.assert_allclose(tq._pixel_encoder(torch.from_numpy(frames)).numpy(),
                               np.asarray(jq._pixel_encoder(jnp.asarray(frames))),
                               atol=2e-6, rtol=0)
    assert load_encoder("checkpoints/no_such_encoder.npz", device="cpu") is None
    with pytest.raises(ValueError, match="unknown encoder arch"):
        load_encoder("checkpoints/vpr_salad.npz", arch="netvlad", device="cpu")


@pytest.mark.parametrize("name,ran,dim", [
    ("pixel", "pixel", 18 * 24), ("trained_vpr", "trained_vpr", 64),
    ("trained_vpr_v2", "trained_vpr_v2", 64), ("mixvpr_trained", "mixvpr_trained", 4096),
    ("cricavpr_trained", "cricavpr_trained", 10752), ("mixvpr", "mixvpr", None),
])
def test_harness_encoder_choices(scene, name, ran, dim):
    """Each encoder run_gate_quality accepts, built from its shipped
    checkpoint; a VPR method it does not know is left to the gate."""
    enc, label = tq._encoder_for(name, "cpu")
    assert label == ran
    if dim is None:
        assert enc is None
        return
    d = enc(torch.from_numpy(scene.images[:2]))
    assert d.shape == (2, dim) and bool(torch.isfinite(d).all())
    np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=1).numpy(), 1.0, atol=1e-5)


class _FixedVPR:
    """A CricaVPR-style stand-in: fixed descriptors and rerank scores."""

    def __init__(self, desc, cc, to_device):
        self.desc, self.cc, self.to_device = desc, cc, to_device
        self.patch_cache, self._patch_matrix = [1], None
        self.rerank_weight = 0.5

    def encode_batch_device(self, imgs):
        assert self.patch_cache == []  # retrieval_metrics clears the cache
        return self.to_device(self.desc)

    def rerank_scores_all(self, q, idx):
        return self.cc[np.asarray(q)[:, None], idx]


@pytest.mark.parametrize("rerank", [False, True])
def test_retrieval_metrics_same_sets_from_same_descriptors(scene, rerank):
    rng = np.random.default_rng(0)
    n = len(scene.images)
    base = rng.normal(size=(n // 2, 32)).astype(np.float32)
    # revisits near their first pass, so the GT pairs compete with traps
    desc = np.concatenate([base, base + 0.6 * rng.normal(size=base.shape).astype(np.float32)])
    desc = desc[np.argsort(np.r_[np.arange(0, n, 2), np.arange(1, n, 2)])]
    cc = rng.uniform(size=(n, n)).astype(np.float32)
    kw = dict(top_k=4, threshold=0.2, rerank=rerank)
    ref = jq.retrieval_metrics(scene, _FixedVPR(desc, cc, jnp.asarray), **kw)
    got = tq.retrieval_metrics(scene, _FixedVPR(desc, cc, torch.from_numpy), device="cpu", **kw)
    assert got == ref
    assert ref["candidates_above_threshold"] > 0
    if not rerank:
        fn_ref = jq.retrieval_metrics(scene, lambda x: jnp.asarray(desc), **kw)
        fn_got = tq.retrieval_metrics(scene, lambda x: torch.from_numpy(desc), device="cpu", **kw)
        assert fn_got == fn_ref == ref
        assert tq.retrieval_recall(scene, lambda x: torch.from_numpy(desc), top_k=4, threshold=0.2,
                                   device="cpu") == \
            jq.retrieval_recall(scene, lambda x: jnp.asarray(desc), top_k=4, threshold=0.2)


def _result(q, m, valid):
    from types import SimpleNamespace

    return SimpleNamespace(query_idx=q, match_idx=m, is_valid=valid)


@pytest.mark.parametrize("case", ["mixed", "none_accepted", "empty"])
def test_score_gate_decisions_and_metrics_match(scene, case):
    from types import SimpleNamespace

    gt = sorted(scene.gt_pairs)
    aliased = sorted(scene.aliased_pairs)
    results = {
        "mixed": [_result(*gt[0], True), _result(gt[1][1], gt[1][0], True), _result(*gt[2], False),
                  _result(*aliased[0], True), _result(0, 2, True)],
        "none_accepted": [_result(*gt[0], False)],
        "empty": [],
    }[case]
    res = SimpleNamespace(results=results, total_pairs=len(results) + 3, cross_floor_rejected=2)
    got = tq.score_gate_decisions(res, scene)
    ref = jq.score_gate_decisions(res, scene)
    assert vars(got) == vars(ref)
    for prop in ("precision", "recall", "f1_score", "cross_floor_rate", "gating_effectiveness"):
        assert getattr(got, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("fields", [
    {}, {"total_candidates": 10, "cross_floor_candidates": 4, "cross_floor_rejected": 3},
    {"true_positives": 3, "false_positives": 1, "false_negatives": 2},
    {"false_positives": 2, "false_negatives": 5},
])
def test_loop_closure_metrics_zero_division(fields):
    a, b = LoopClosureMetrics(**fields), JaxMetrics(**fields)
    for prop in ("precision", "recall", "f1_score", "cross_floor_rate", "gating_effectiveness"):
        assert getattr(a, prop) == getattr(b, prop), prop


def test_build_verifier_families():
    v, w = tq.build_verifier("trained", 32, HW, weights_path=default_parallax_matcher_checkpoint(),
                             device="cpu")
    assert w == "lightglue_parallax_sp.npz" and v.min_confident_matches == 6
    assert v.matcher.cfg.depth == 9 and v.matcher.sp.cfg.max_keypoints == 32
    v, w = tq.build_verifier("random", 32, HW, device="cpu")
    assert w == "random_init"
    # the other families build (their rows: tests/test_torch_quality_matchers.py)
    for fam, label in (("orb", "orb_weight_free"), ("superglue", "random_init"),
                       ("loftr", "random_init")):
        v, w = tq.build_verifier(fam, 32, HW, weights_path="no/such.npz", device="cpu")
        assert w == label and w == jq.build_verifier(fam, 32, HW, weights_path="no/such.npz")[1]
    with pytest.raises(ValueError, match="unknown matcher family"):
        tq.build_verifier("sift", 32, HW, device="cpu")
    assert tq.SUPERGLUE_CONFIDENT_CUT == jq.SUPERGLUE_CONFIDENT_CUT == 16
    # the floor gate the harness relies on, both packages on the same pairs
    fl = np.asarray([5, 5, 2, 2])
    lo, hi = np.asarray([0, 0, 1, 2]), np.asarray([1, 2, 3, 3])
    np.testing.assert_array_equal(
        gate_mask(torch.from_numpy(fl), torch.from_numpy(lo), torch.from_numpy(hi), True).numpy(),
        np.asarray(jax_gate_mask(jnp.asarray(fl), jnp.asarray(lo), jnp.asarray(hi), True)))

