"""The port's budgeted gate path (``survivor_budget`` without
``monolithic``) and its static compaction, held against mlis_tpu's: the
slot helpers, ``_gate_compact`` with a static slot count, and the
budgeted ``process`` on tests/test_full_gate.py's device-encoder scene
(16 keyframes at 120x160, tiny float32 SuperPoint and matcher carried
across) with mlis_tpu's draws fed in."""

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

from mlis_tpu_torch.gating.full_gate import FullGatePipeline, _gate_compact  # noqa: E402
from mlis_tpu_torch.gating.place_recognition import (  # noqa: E402
    BasePlaceRecognition,
    SemanticPlaceRecognition,
)
from mlis_tpu_torch.gating.verification import GeometricVerifier  # noqa: E402
from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig  # noqa: E402
from mlis_tpu_torch.weights import from_jax_params  # noqa: E402
from test_torch_full_gate import HYP, K_CAM, VERIFY_BATCH, _PatchEncoder, _scene_images  # noqa: E402

N_FRAMES = 16
FLOORS = np.asarray([5] * 8 + [2] * 8)
TIMES = np.arange(N_FRAMES) * 30.0


# -- the slot helpers ----------------------------------------------------------------

# tests/test_full_gate.py::test_budget_slots_quarter_octave's cases
@pytest.mark.parametrize("s,want", [
    (1, 16), (7, 16), (16, 16), (17, 20), (24, 24), (25, 28), (64, 64), (65, 80),
    (513, 640), (768, 768), (814, 896), (896, 896), (897, 1024), (1024, 1024),
    (1025, 1280),
])
def test_budget_slots_cases(s, want):
    assert FullGatePipeline._budget_slots(s) == JaxGate._budget_slots(s) == want


@pytest.mark.parametrize("B", [8, 64, 256])
def test_budget_slots_and_bucket_sizes_sweep(B):
    """Both helpers equal the JAX package's over 1..5,000."""
    for s in range(1, 5001):
        assert FullGatePipeline._budget_slots(s) == JaxGate._budget_slots(s), s
        assert FullGatePipeline._bucket_sizes(s, B) == JaxGate._bucket_sizes(s, B), (s, B)
    assert FullGatePipeline._bucket_sizes(0, B) == JaxGate._bucket_sizes(0, B) == []


# -- static compaction ---------------------------------------------------------------

def _descriptors(n: int, seed: int):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n // 4, 32)).astype(np.float32)
    db = np.concatenate([base] * 4) + 0.3 * rng.normal(size=(n, 32)).astype(np.float32)
    db[: n // 4] = db[n // 4 : n // 2]  # exact duplicates: tied scores
    return db, (np.arange(n) * 5.0).astype(np.float32), rng.integers(0, 3, n)


@pytest.mark.parametrize("slots", ["above", "equal", "below", "none_survive"])
def test_static_gate_compact_matches_jax(slots):
    """qi, mi and the stats row exact against mlis_tpu's static-M
    compaction, with M above, equal to and below the survivor count, and
    with no survivor."""
    n, k = 40, 10
    db, times, floors = _descriptors(n, 3)
    threshold = 1.5 if slots == "none_survive" else 0.2
    args = dict(k=k, threshold=threshold, min_time_gap=10.0, strict=True)
    _, _, jstats = jax_gate_compact(jnp.asarray(db), jnp.asarray(times),
                                    jnp.asarray(floors, jnp.int32), M=n * k, **args)
    nsurv = int(jstats[2])
    M = {"above": nsurv + 7, "equal": nsurv, "below": max(nsurv // 2, 1),
         "none_survive": 16}[slots]
    assert (nsurv == 0) == (slots == "none_survive")
    jq, jm, jstats = jax_gate_compact(jnp.asarray(db), jnp.asarray(times),
                                      jnp.asarray(floors, jnp.int32), M=M, **args)
    qi, mi, stats = _gate_compact(torch.from_numpy(db), torch.from_numpy(times),
                                  torch.from_numpy(floors), M=M, **args)
    assert qi.shape == mi.shape == (M,) and stats.shape == (3,)
    assert stats.tolist() == np.asarray(jstats).tolist()
    assert qi.tolist() == np.asarray(jq).tolist()
    assert mi.tolist() == np.asarray(jm).tolist()
    live = min(nsurv, M)
    assert (qi[live:] == 0).all() and (mi[live:] == 0).all()
    # the first slots are the exact compaction's survivors, in its order
    eq, em, (total, rejected) = _gate_compact(torch.from_numpy(db), torch.from_numpy(times),
                                              torch.from_numpy(floors), **args)
    assert (total, rejected, eq.numel()) == tuple(stats.tolist())
    assert qi[:live].tolist() == eq[:live].tolist() and mi[:live].tolist() == em[:live].tolist()
    with pytest.raises(ValueError, match="slot count"):
        _gate_compact(torch.from_numpy(db), torch.from_numpy(times), torch.from_numpy(floors),
                      M=n * k + 1, **args)


# -- the budgeted path ---------------------------------------------------------------

class _JaxDeviceVPR(JaxDB):
    """tests/test_full_gate.py's device-encoder database: the patch encoder
    behind ``encode_batch_device``, so the budgeted path applies."""

    def __init__(self):
        super().__init__(descriptor_dim=110, encoder=_PatchEncoder())

    def encode_batch_device(self, images):
        return jnp.asarray(self.encoder.encode_batch(np.asarray(images)))


class _DeviceVPR(BasePlaceRecognition):
    def __init__(self):
        super().__init__(descriptor_dim=110, encoder=_PatchEncoder(), device="cpu")

    def encode_batch_device(self, images):
        return torch.as_tensor(self.encoder.encode_batch(np.asarray(images)))


def jax_budget_uniforms(M: int, verify_batch: int, hyp: int = HYP) -> np.ndarray:
    """mlis_tpu's draws on its budgeted path: each bucket of the M slots
    keyed by PRNGKey(its START offset), split per slot (the last bucket
    may hold fewer slots than its size)."""
    out, s = [], 0
    for size in JaxGate._bucket_sizes(M, verify_batch):
        take = min(size, M - s)
        keys = jax.random.split(jax.random.PRNGKey(s), take)
        out.append(np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (hyp, 8)))(keys)))
        s += size
    return np.concatenate(out)


@pytest.fixture(scope="module")
def pipelines():
    spr = JaxSPR(vpr_method=_JaxDeviceVPR(), similarity_threshold=0.9, min_time_gap=10.0)
    jlg = JaxLG(sp_cfg=JaxSPC.tiny_test(max_keypoints=64, dtype=jnp.float32),
                matcher_cfg=JaxMC.tiny_test(dtype=jnp.float32))
    jpipe = JaxGate(vpr=spr, verifier=JaxVerifier(matcher=jlg), similarity_threshold=0.9,
                    verify_batch=VERIFY_BATCH)
    lg = LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=64, dtype=torch.float32),
                   matcher_cfg=MatcherConfig.tiny_test(dtype=torch.float32), device="cpu")
    lg.sp.load_state(from_jax_params(jax.device_get(jlg.sp.params)))
    lg.net.load_state_dict(from_jax_params(jax.device_get(jlg.params)))
    pspr = SemanticPlaceRecognition(vpr_method=_DeviceVPR(), similarity_threshold=0.9,
                                    min_time_gap=10.0, device="cpu")
    pipe = FullGatePipeline(vpr=pspr, verifier=GeometricVerifier(matcher=lg),
                            similarity_threshold=0.9, verify_batch=VERIFY_BATCH,
                            matcher_weights=None, device="cpu")
    images = _scene_images(np.random.default_rng(0), N_FRAMES)
    return jpipe, pipe, images


def _assert_same_results(got, ref):
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


def test_budgeted_path_matches_jax(pipelines):
    """Pairs, stats, verified, matches, inliers and decisions equal to
    mlis_tpu's budgeted path on the same slot draws; the uniforms' shape is
    the slot count's."""
    jpipe, pipe, images = pipelines
    budget = 64
    ref = jpipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=budget)
    assert ref.total_pairs > 0 and ref.cross_floor_rejected > 0 and ref.verified > 1
    M = min(budget, N_FRAMES * min(pipe.top_k, N_FRAMES))
    u = torch.from_numpy(jax_budget_uniforms(M, VERIFY_BATCH))
    got = pipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=budget, ransac_uniforms=u)
    _assert_same_results(got, ref)
    with pytest.raises(ValueError, match="budget path"):
        pipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=budget,
                     ransac_uniforms=u[: ref.verified])


def test_budget_one_equals_the_exact_path(pipelines):
    """A budget of 1 overflows: the exact path reruns, drawing from the
    generator as a plain exact call does; the counts equal mlis_tpu's."""
    jpipe, pipe, images = pipelines
    exact = pipe.process(images, TIMES, FLOORS, K_CAM,
                         generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    over = pipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=1, generator=gen)
    assert exact.verified > 1
    assert [(r.query_idx, r.match_idx, r.num_matches, r.num_inliers, r.is_valid)
            for r in over.results] == [
        (r.query_idx, r.match_idx, r.num_matches, r.num_inliers, r.is_valid)
        for r in exact.results]
    assert (over.total_pairs, over.cross_floor_rejected, over.geometrically_valid) == (
        exact.total_pairs, exact.cross_floor_rejected, exact.geometrically_valid)
    ref = jpipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=1)
    assert (over.total_pairs, over.cross_floor_rejected, over.verified) == (
        ref.total_pairs, ref.cross_floor_rejected, ref.verified)


def test_budgeted_path_empty_above_any_similarity(pipelines):
    jpipe, pipe, images = pipelines
    pipe.similarity_threshold = jpipe.similarity_threshold = 2.0
    try:
        got = pipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=64)
        ref = jpipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=64)
    finally:
        pipe.similarity_threshold = jpipe.similarity_threshold = 0.9
    assert got.total_pairs == ref.total_pairs == 0
    assert got.verified == 0 and got.results == [] and got.cross_floor_rejected == 0
