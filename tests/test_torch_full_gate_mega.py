"""The port's one-fetch gate path (``monolithic=True``), on keyframes
already on the pipeline's device and on host keyframes, held against mlis_tpu's single-program path on tests/test_full_gate.py's
tiny MixVPR scene (``ResNetConfig.tiny_test`` at 64x64, 12 keyframes,
float32 on both sides with the same parameters, its ``PRNGKey(0)`` draws
over the slots fed in); and which verify each budget path calls."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.gating.full_gate import FullGatePipeline as JaxGate  # noqa: E402
from mlis_tpu.gating.place_recognition import SemanticPlaceRecognition as JaxSPR  # noqa: E402
from mlis_tpu.gating.verification import GeometricVerifier as JaxVerifier  # noqa: E402
from mlis_tpu.models.lightglue import LightGlue as JaxLG  # noqa: E402
from mlis_tpu.models.lightglue import MatcherConfig as JaxMC  # noqa: E402
from mlis_tpu.models.mixvpr import MixVPR as JaxMixVPR  # noqa: E402
from mlis_tpu.models.mixvpr import MixVPRModule as JaxMixVPRModule  # noqa: E402
from mlis_tpu.models.resnet import ResNetConfig as JaxResNetConfig  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JaxSPC  # noqa: E402

from mlis_tpu_torch.gating.full_gate import FullGatePipeline  # noqa: E402
from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition  # noqa: E402
from mlis_tpu_torch.gating.verification import GeometricVerifier  # noqa: E402
from mlis_tpu_torch.models.layers import flax_init_  # noqa: E402
from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig  # noqa: E402
from mlis_tpu_torch.models.mixvpr import MixVPR  # noqa: E402
from mlis_tpu_torch.models.resnet import ResNetConfig  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig  # noqa: E402
from mlis_tpu_torch.weights import from_jax_params, to_jax_params  # noqa: E402
from test_torch_full_gate import HYP, K_CAM, _scene_images  # noqa: E402
from test_torch_full_gate_budget import _assert_same_results, jax_budget_uniforms  # noqa: E402

N_FRAMES = 12
FLOORS = np.asarray([5] * 6 + [2] * 6)
TIMES = np.arange(N_FRAMES) * 30.0
VERIFY_BATCH = 64


def jax_slot_uniforms(M: int, hyp: int = HYP) -> np.ndarray:
    """mlis_tpu's draws on its single-program path: PRNGKey(0) split over
    all M slots."""
    keys = jax.random.split(jax.random.PRNGKey(0), M)
    return np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (hyp, 8)))(keys))


@pytest.fixture(scope="module")
def pipelines():
    """The two pipelines on one tiny MixVPR: flax-style weights drawn for
    the port's module from torch.Generator(0) and handed to the JAX
    package's constructor in place of its eager flax init (which takes
    8-17 s on the CPU for this network)."""
    vpr = MixVPR(descriptor_dim=32, backbone_cfg=ResNetConfig.tiny_test(dtype=torch.float32),
                 input_size=(64, 64), checkpoint=None, device="cpu")
    flax_init_(vpr.module, torch.Generator().manual_seed(0))
    jparams = {"params": to_jax_params(vpr.module.state_dict())}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxMixVPRModule, "init", lambda self, rng, x: jparams)
        jvpr = JaxMixVPR(descriptor_dim=32,
                         backbone_cfg=JaxResNetConfig.tiny_test(dtype=jnp.float32),
                         input_size=(64, 64))
    jlg = JaxLG(sp_cfg=JaxSPC.tiny_test(max_keypoints=64, dtype=jnp.float32),
                matcher_cfg=JaxMC.tiny_test(dtype=jnp.float32))
    jpipe = JaxGate(vpr=JaxSPR(vpr_method=jvpr, similarity_threshold=0.8, min_time_gap=10.0),
                    verifier=JaxVerifier(matcher=jlg), similarity_threshold=0.8,
                    verify_batch=VERIFY_BATCH)
    lg = LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=64, dtype=torch.float32),
                   matcher_cfg=MatcherConfig.tiny_test(dtype=torch.float32), device="cpu")
    lg.sp.load_state(from_jax_params(jax.device_get(jlg.sp.params)))
    lg.net.load_state_dict(from_jax_params(jax.device_get(jlg.params)))
    pipe = FullGatePipeline(
        vpr=SemanticPlaceRecognition(vpr_method=vpr, similarity_threshold=0.8,
                                     min_time_gap=10.0, device="cpu"),
        verifier=GeometricVerifier(matcher=lg), similarity_threshold=0.8,
        verify_batch=VERIFY_BATCH, matcher_weights=None, device="cpu")
    images = _scene_images(np.random.default_rng(0), N_FRAMES)
    exact = pipe.process(images, TIMES, FLOORS, K_CAM, generator=torch.Generator().manual_seed(0))
    assert exact.total_pairs > 0 and exact.cross_floor_rejected > 0 and exact.verified > 1
    return jpipe, pipe, images, exact


def _slots(pipe, budget: int) -> int:
    k = min(pipe.top_k, N_FRAMES)
    return int(min(FullGatePipeline._budget_slots(min(budget, N_FRAMES * k)), N_FRAMES * k))


def test_one_fetch_path_matches_jax_single_program(pipelines):
    """Keyframes already on the pipeline's device take the one-fetch path:
    pairs, stats and decisions equal mlis_tpu's monolithic path on
    device arrays with its draws."""
    jpipe, pipe, images, exact = pipelines
    budget = exact.verified
    ref = jpipe.process(jax.device_put(images), TIMES, FLOORS, K_CAM,
                        survivor_budget=budget, monolithic=True)
    u = torch.from_numpy(jax_slot_uniforms(_slots(pipe, budget)))
    got = pipe.process(torch.from_numpy(images), TIMES, FLOORS, K_CAM, survivor_budget=budget,
                       monolithic=True, ransac_uniforms=u)
    _assert_same_results(got, ref)
    assert (got.total_pairs, got.cross_floor_rejected, got.verified) == (
        exact.total_pairs, exact.cross_floor_rejected, exact.verified)
    assert got.retrieval_s == 0.0 and got.elapsed_s > 0


def test_pipelined_path_matches_one_fetch(pipelines):
    """Host keyframes on the monolithic path are uploaded once and give
    the one-fetch path's (num_matches, num_inliers) on the same draws:
    ``upload_chunk`` changes nothing, as the JAX package pins its sliced
    upload bit-identical to its single program."""
    _, pipe, images, exact = pipelines
    budget = exact.verified
    u = torch.from_numpy(jax_slot_uniforms(_slots(pipe, budget)))
    one = pipe.process(torch.from_numpy(images), TIMES, FLOORS, K_CAM, survivor_budget=budget,
                       monolithic=True, ransac_uniforms=u)
    piped = pipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=budget, monolithic=True,
                         upload_chunk=4, ransac_uniforms=u)
    assert (piped.total_pairs, piped.cross_floor_rejected, piped.verified) == (
        one.total_pairs, one.cross_floor_rejected, one.verified)
    assert {(r.query_idx, r.match_idx): (r.num_matches, r.num_inliers) for r in piped.results} \
        == {(r.query_idx, r.match_idx): (r.num_matches, r.num_inliers) for r in one.results}


def _counting(pipe, monkeypatch):
    calls = {"_verify_survivors": 0, "_verify_compacted": 0, "_verify_slots": 0,
             "_detect_encode_once": 0, "_fetch": 0}
    for name in calls:
        orig = getattr(pipe, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(pipe, name, wrapped)
    return calls


@pytest.mark.parametrize("path", ["budgeted", "one_fetch", "one_fetch_host"])
@pytest.mark.parametrize("overflow", [False, True])
def test_budget_paths_call_the_exact_verify_only_on_overflow(pipelines, monkeypatch, path,
                                                              overflow):
    """Each budget path makes one packed fetch and no exact-path verify.
    An overflow (budget 1, and at a threshold of -1 more survivors than
    the one-fetch path's 16 slots) then runs the exact verify once; its
    results equal the exact path's, the generator rewound."""
    _, pipe, images, exact = pipelines
    if overflow:
        monkeypatch.setattr(pipe, "similarity_threshold", -1.0)
        exact = pipe.process(images, TIMES, FLOORS, K_CAM,
                             generator=torch.Generator().manual_seed(0))
        assert exact.verified > FullGatePipeline._budget_slots(1)
    calls = _counting(pipe, monkeypatch)
    budget = 1 if overflow else exact.verified
    imgs = torch.from_numpy(images) if path == "one_fetch" else images
    got = pipe.process(imgs, TIMES, FLOORS, K_CAM, survivor_budget=budget,
                       monolithic=path != "budgeted", upload_chunk=5,
                       generator=torch.Generator().manual_seed(0))
    want = {"_verify_survivors": int(overflow), "_fetch": 1,
            "_verify_compacted": int(path == "budgeted"),
            "_verify_slots": int(path != "budgeted"),
            "_detect_encode_once": int(path != "budgeted")}
    assert calls == want
    assert (got.total_pairs, got.cross_floor_rejected, got.verified) == (
        exact.total_pairs, exact.cross_floor_rejected, exact.verified)
    if overflow:
        assert [(r.query_idx, r.match_idx, r.num_inliers) for r in got.results] == [
            (r.query_idx, r.match_idx, r.num_inliers) for r in exact.results]


def test_budgeted_path_with_mixvpr_matches_jax(pipelines):
    """The budgeted path (no ``monolithic``) with MixVPR's device encoder,
    against mlis_tpu's with its START-offset bucket draws."""
    jpipe, pipe, images, exact = pipelines
    budget = exact.verified + 3
    ref = jpipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=budget)
    u = torch.from_numpy(jax_budget_uniforms(budget, VERIFY_BATCH))
    got = pipe.process(images, TIMES, FLOORS, K_CAM, survivor_budget=budget, ransac_uniforms=u)
    _assert_same_results(got, ref)
