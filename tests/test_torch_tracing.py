"""The port's tracing: the ``torch.profiler`` ranges that name the gate's
stages and host waits (``utils/profiling.span`` / ``sync_point``).

On a tiny exact-path gate (16 mono keyframes at 120x160, a tiny float32
CricaVPR whose position table is resampled, a tiny SuperPoint and
LightGlue, 8 survivors in verify batches of 3, encode batches of 8), one
``process`` call under a CPU profiler holds every range the benchmark
reads, as many times as the code's sites give; it returns what the same
call returns without a profiler, and without a profiler no range is
opened. This file imports neither JAX nor mlis_tpu."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mlis_tpu_torch.gating.full_gate import FullGatePipeline
from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition
from mlis_tpu_torch.gating.verification import GeometricVerifier
from mlis_tpu_torch.models.lightglue import LightGlue, MatcherConfig
from mlis_tpu_torch.models.superpoint import SuperPointConfig
from mlis_tpu_torch.models.vit import ViTConfig
from mlis_tpu_torch.utils import profiling

N_FRAMES = 16
ENCODE_BATCH = 8
VERIFY_BATCH = 3
SURVIVORS = 8  # 4 scenes seen 4 times; the 2 same-floor pairs of each scene survive
K_CAM = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]])
FLOORS = np.asarray([5] * 8 + [2] * 8)
TIMES = np.arange(N_FRAMES) * 30.0


def _batches(n: int, b: int) -> int:
    return -(-n // b)


# sync.<site> ranges of one exact-path call: what each site costs a call,
# an encode batch (ImageNet mean and std; the two axes of the position
# table) and a verify batch (the image size; two SVDs and two constants)
PER_CALL = {"upload_floors": 1, "upload_images": 1, "upload_scale": 1, "upload_times": 1,
            "detect_encode": 1, "counts": 1, "survivors": 2, "fetch_rows": 1,
            "fetch_pairs": 1}
PER_ENCODE_BATCH = {"upload_norm": 2, "posembed": 2}
PER_VERIFY_BATCH = {"image_size": 1, "svd": 2, "upload_const": 2}


def expected_syncs(n_frames: int, survivors: int) -> Counter:
    want = Counter({f"sync.{k}": v for k, v in PER_CALL.items()})
    for table, n in ((PER_ENCODE_BATCH, _batches(n_frames, ENCODE_BATCH)),
                     (PER_VERIFY_BATCH, _batches(survivors, VERIFY_BATCH))):
        for k, v in table.items():
            want[f"sync.{k}"] += v * n
    return want


@pytest.fixture(scope="module")
def gate():
    torch.set_grad_enabled(False)
    lg = LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=64, dtype=torch.float32),
                   matcher_cfg=MatcherConfig.tiny_test(dtype=torch.float32),
                   device="cpu").init_random_(0)
    spr = SemanticPlaceRecognition("cricavpr", vit_cfg=ViTConfig.tiny_test(dtype=torch.float32),
                                   checkpoint=None, descriptor_dim=64, input_size=(70, 70),
                                   similarity_threshold=0.99, min_time_gap=10.0, device="cpu")
    spr.vpr.module.init_random_(torch.Generator().manual_seed(0))
    pipe = FullGatePipeline(vpr=spr, verifier=GeometricVerifier(matcher=lg),
                            similarity_threshold=0.99, verify_batch=VERIFY_BATCH,
                            matcher_weights=None, device="cpu")
    rng = np.random.default_rng(0)
    bases = [np.kron(rng.integers(0, 255, (15, 20), dtype=np.uint8), np.ones((8, 8), np.uint8))
             for _ in range(4)]
    images = np.stack([bases[i % 4] for i in range(N_FRAMES)])
    call(pipe, images)  # the first call builds the fused matcher
    yield pipe, images
    torch.set_grad_enabled(True)


def call(pipe, images, **kw):
    return pipe.process(images, TIMES, FLOORS, K_CAM, encode_batch_size=ENCODE_BATCH,
                        generator=torch.Generator().manual_seed(7), **kw)


def traced(pipe, images, **kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = call(pipe, images, **kw)
    return res, Counter(e.name for e in prof.events() if e.is_user_annotation)


def _rows(res):
    return [(r.query_idx, r.match_idx, r.num_matches, r.num_inliers, r.inlier_ratio,
             r.is_valid, r.num_confident_matches) for r in res.results]


def test_every_range_of_an_exact_call(gate):
    pipe, images = gate
    res, seen = traced(pipe, images)
    assert res.verified == SURVIVORS and res.total_pairs == 24
    verify_batches = _batches(SURVIVORS, VERIFY_BATCH)
    depth = pipe.verifier.matcher.cfg.depth
    assert {name: seen[name] for name in (
        "gate.process", "gate.detect", "gate.encode", "gate.retrieval", "gate.results",
        "superpoint.nms_topk", "lightglue.match", "lightglue.attention", "lightglue.assign",
        "epipolar.ransac")} == {
        "gate.process": 1, "gate.detect": 1, "gate.encode": 1, "gate.retrieval": 1,
        "gate.results": 1, "superpoint.nms_topk": 1, "lightglue.match": verify_batches,
        "lightglue.attention": 2 * depth * verify_batches, "lightglue.assign": verify_batches,
        "epipolar.ransac": verify_batches}
    syncs = Counter({k: v for k, v in seen.items() if k.startswith("sync.")})
    assert syncs == expected_syncs(N_FRAMES, SURVIVORS)
    assert sum(syncs.values()) == 33
    assert all("." in name for name in seen)


@pytest.mark.parametrize("path", ["budgeted", "one_fetch"])
def test_budget_paths_run_inside_one_process_range(gate, path):
    """The budget paths: one ``gate.process``, one packed fetch, one result list."""
    pipe, images = gate
    kw = dict(survivor_budget=SURVIVORS, monolithic=path == "one_fetch")
    res, seen = traced(pipe, images, **kw)
    assert res.verified == SURVIVORS
    assert (seen["gate.process"], seen["gate.results"], seen["sync.fetch_rows"]) == (1, 1, 1)
    assert seen["sync.counts"] == seen["sync.survivors"] == seen["sync.fetch_pairs"] == 0


def test_results_equal_with_and_without_a_profiler(gate):
    pipe, images = gate
    res, _ = traced(pipe, images)
    plain = call(pipe, images)
    assert (res.total_pairs, res.cross_floor_rejected, res.verified) == (
        plain.total_pairs, plain.cross_floor_rejected, plain.verified)
    assert _rows(res) == _rows(plain)
    for a, b in zip(res.results, plain.results):
        for x, y in ((a.essential_matrix, b.essential_matrix), (a.relative_pose, b.relative_pose)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_no_range_is_opened_without_a_profiler(gate, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("gate.any"), profiling.sync_point("any"):
        pass
    pipe, images = gate
    assert call(pipe, images).verified == SURVIVORS

