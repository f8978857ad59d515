"""The port's sharded gate step (mlis_tpu_torch/parallel/sharded_gate.py)
in a 4-rank gloo world on the CPU, held against mlis_tpu's on 4 of its 8
virtual CPU devices with the same inputs: tests/test_sharded_gate.py's
scene (16 keyframes of 4 kron bases at 120x160, floors 8 x 5 / 8 x 2, 30 s
apart), its pixel encoder, top-5 retrieval at 0.9, the tiny float32
LightGlue (match threshold 0.01: its random weights give no probability
above the default 0.1) with the JAX package's parameters carried across, keypoints
pruned to the top 32 of 64 before the gather. RANSAC takes the JAX
package's per-device draws (``fold_in(PRNGKey(0), dev)`` split per slot)
through ``uniforms=``.

Exact: the directed statistics, the slot pairs and their validity, each
rank's ownership of its slots, matches and confident matches, the exact
mode's rerun budget and the inexact mode's ``dropped``, the bad-shard
error, and the port's sharded verdicts against its single-device fused
program on the same pair list and draws. Inliers agree with the JAX
package's within 1 (the float32 8-point solve rounds differently, ROADMAP
Queue 3). The scaling model and the FLOP counts are equal at equal
arguments.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models.lightglue import LightGlue as JaxLG, MatcherConfig as JaxMC  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JaxSPC  # noqa: E402
from mlis_tpu.parallel import scaling as jscaling  # noqa: E402
from mlis_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mlis_tpu.parallel.sharded_gate import sharded_full_gate_step as jax_step  # noqa: E402
from mlis_tpu.utils import flops as jflops  # noqa: E402
from test_torch_parallel_ranks import World  # noqa: E402
import test_torch_parallel_ranks as ranks  # noqa: E402

from mlis_tpu_torch.models.superpoint import Keypoints  # noqa: E402
from mlis_tpu_torch.ops.image import to_grayscale  # noqa: E402
from mlis_tpu_torch.ops.knn import cosine_topk  # noqa: E402
from mlis_tpu_torch.parallel import scaling  # noqa: E402
from mlis_tpu_torch.utils import flops  # noqa: E402
from mlis_tpu_torch.weights import from_jax_params  # noqa: E402

K_CAM = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]])
GATE = dict(top_k=5, threshold=0.9, min_time_gap=10.0)
N_DEV, BUDGET, MATCH_TOP_K, HYP = 4, 4, 32, 512
MATCH_THRESHOLD = 0.01  # the random tiny matcher's probabilities stay below the default 0.1


def _jax_encode(imgs):
    x = imgs.astype(jnp.float32)
    if x.ndim == 4:
        x = x.mean(-1)
    d = x[:, ::12, ::12].reshape(x.shape[0], -1)
    return d / (jnp.linalg.norm(d, axis=1, keepdims=True) + 1e-8)


def _scene(n=16):
    rng = np.random.default_rng(0)
    bases = [np.kron(rng.integers(0, 255, (15, 20, 3), dtype=np.uint8),
                     np.ones((8, 8, 1), np.uint8))[:120, :160] for _ in range(4)]
    images = np.stack([bases[i % 4] for i in range(n)])
    return images, np.arange(n) * 30.0, np.asarray([5] * (n // 2) + [2] * (n // 2))


def jax_device_uniforms(budget: int) -> np.ndarray:
    """(N_DEV * budget, HYP, 8): device d's key fold_in(PRNGKey(0), d),
    split over its slots, as the JAX package's program draws them."""
    out = []
    for d in range(N_DEV):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), d), budget)
        out.append(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (HYP, 8)))(keys)))
    return np.concatenate(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (jax result, [port result per rank])} for the main, exact-rerun,
    inexact and bad-shard calls, plus the inputs and the carried states."""
    images, times, floors = _scene()
    mesh = jax_mesh(N_DEV, 1, devices=jax.devices()[:N_DEV])
    jlg = JaxLG(sp_cfg=JaxSPC.tiny_test(max_keypoints=64, dtype=jnp.float32),
                matcher_cfg=JaxMC.tiny_test(dtype=jnp.float32, match_threshold=MATCH_THRESHOLD))
    calls = {"main": dict(per_device_budget=BUDGET),
             "rerun": dict(per_device_budget=1, exact=True),
             "inexact": dict(per_device_budget=1, exact=False)}
    ref = {name: jax_step(mesh, jlg, _jax_encode, images, times, floors, K_CAM,
                          match_top_k=MATCH_TOP_K, **GATE, **kw) for name, kw in calls.items()}
    with pytest.raises(ValueError, match="shard") as bad:
        jax_step(mesh, jlg, _jax_encode, images[:14], times[:14], floors[:14], K_CAM, **GATE)
    ref["bad"] = f"ValueError: {bad.value}"
    sp_state = {k: v.numpy() for k, v in from_jax_params(jax.device_get(jlg.sp.params)).items()}
    lg_state = {k: v.numpy() for k, v in from_jax_params(jax.device_get(jlg.params)).items()}
    port_calls = [dict(calls["main"], match_top_k=MATCH_TOP_K,
                       uniforms=jax_device_uniforms(BUDGET)),
                  dict(calls["rerun"], match_top_k=MATCH_TOP_K),
                  dict(calls["inexact"], match_top_k=MATCH_TOP_K),
                  dict(n_frames=14),
                  dict(per_device_budget=2 * BUDGET, match_top_k=MATCH_TOP_K)]
    world = World(N_DEV, str(tmp_path_factory.mktemp("gloo")))
    try:
        got = world.run(ranks.sharded_gate_runs, images, times, floors, K_CAM, sp_state,
                        lg_state, port_calls, GATE, MATCH_THRESHOLD)
    finally:
        world.close()
    out = {name: (ref.get(name), [g[i] for g in got])
           for i, name in enumerate(("main", "rerun", "inexact", "bad", "wide"))}
    out["inputs"] = (images, times, floors, sp_state, lg_state)
    return out


def test_stats_slots_and_ownership_match_jax(runs):
    (jv, js), port = runs["main"]
    images, times, floors, _, _ = runs["inputs"]
    # a host recount of the directed retrieval and gate
    desc = ranks.encode_pixels(torch.from_numpy(images))
    t = torch.from_numpy(times.astype(np.float32))
    scores, idx = (x.numpy() for x in cosine_topk(desc, desc, t, t, k=5, min_time_gap=10.0))
    valid = np.isfinite(scores) & (scores >= 0.9)
    accept = valid & (floors[:, None] == floors[idx])
    recount = (int(valid.sum()), int((valid & ~accept).sum()), int(accept.sum()))
    assert js["total"] > js["rejected"] > 0 and js["dropped"] == 0
    for v, s in port:
        assert s == js
        assert (s["total"], s["rejected"], s["accepted"]) == recount
        for key in ("qi", "mi", "slot_valid", "n_matches", "n_confident"):
            np.testing.assert_array_equal(v[key], np.asarray(jv[key]), err_msg=key)
        assert v["slot_valid"].shape == (N_DEV * BUDGET,)
        ok = v["slot_valid"]
        assert ok.sum() == s["accepted"]
        # every valid slot holds an accepted same-floor pair, owned by the
        # rank whose query slab holds its query
        assert (floors[v["qi"][ok]] == floors[v["mi"][ok]]).all()
        assert (v["qi"][ok] // (16 // N_DEV) == np.nonzero(ok)[0] // BUDGET).all()
        assert (v["n_matches"][ok] <= MATCH_TOP_K).all() and v["n_matches"][ok].max() > 0
        assert np.abs(v["n_inliers"] - np.asarray(jv["n_inliers"]))[ok].max() <= 1
        np.testing.assert_array_equal(v["n_inliers"], port[0][0]["n_inliers"])


def test_unused_slots_are_marked_and_zero(runs):
    """Twice the budget: each rank's accepted pairs fill the front of its
    slots in the same order, the rest are invalid and hold pair (0, 0)."""
    (_, _), port = runs["main"]
    _, wide = runs["wide"]
    for (v, s), (w, ws) in zip(port, wide):
        assert ws == dict(s, budget_used=2 * BUDGET)
        ok = w["slot_valid"].reshape(N_DEV, 2 * BUDGET)
        assert ok[:, :BUDGET].all() and not ok[:, BUDGET:].any()
        for key in ("qi", "mi", "n_matches"):
            got = w[key].reshape(N_DEV, 2 * BUDGET)
            np.testing.assert_array_equal(got[:, :BUDGET].reshape(-1), v[key])
        assert not w["qi"][~w["slot_valid"]].any() and not w["mi"][~w["slot_valid"]].any()


def test_sharded_verdicts_equal_the_single_device_fused_program(runs):
    """The pruned keypoints of every frame, the fused program on the same
    pair list with the same draws, on one process."""
    (_, _), port = runs["main"]
    images, _, _, sp_state, lg_state = runs["inputs"]
    lg = ranks.tiny_lightglue(sp_state, lg_state, match_threshold=MATCH_THRESHOLD)
    kp = lg.sp.detect(to_grayscale(torch.from_numpy(images), size=(120, 160)))
    kp = Keypoints(*(x[:, :MATCH_TOP_K] for x in kp))
    v = port[0][0]
    fused = lg.make_fused_match_verify((120, 160), K_CAM, 3.0)
    u = torch.from_numpy(jax_device_uniforms(BUDGET))
    out = fused(kp, torch.from_numpy(v["qi"]).long(), torch.from_numpy(v["mi"]).long(), uniforms=u)
    ok = v["slot_valid"]
    np.testing.assert_array_equal(v["n_matches"][ok], out[2].numpy()[ok])
    np.testing.assert_array_equal(v["n_inliers"][ok], out[3].numpy()[ok])
    np.testing.assert_allclose(v["inlier_ratio"][ok], out[4].numpy()[ok], rtol=0, atol=0)


def test_exact_rerun_and_inexact_drops_match_jax(runs):
    (jv, js), port = runs["rerun"]
    assert js["accepted"] > N_DEV  # overflow of a budget of 1 per device
    assert js["budget_used"] == BUDGET and js["dropped"] == 0
    assert js["verified"] == js["accepted"]
    for (v, s), (m, _) in zip(port, runs["main"][1]):
        assert s == js
        np.testing.assert_array_equal(v["n_inliers"], m["n_inliers"])
        for key in ("qi", "mi", "slot_valid", "n_matches"):
            np.testing.assert_array_equal(v[key], np.asarray(jv[key]), err_msg=key)
    (jv, js), port = runs["inexact"]
    assert js["budget_used"] == 1 and js["dropped"] == js["accepted"] - js["verified"] > 0
    for v, s in port:
        assert s == js
        np.testing.assert_array_equal(v["qi"], np.asarray(jv["qi"]))
    jerr, port = runs["bad"]
    assert all(p == jerr for p in port), (port, jerr)


def test_scaling_model_and_flops_equal_at_equal_arguments():
    for n_dev in (1, 2, 4, 8):
        for kw in (dict(), dict(desc_dim=8448, match_kpts=1024)):
            assert (scaling.gate_comm_bytes_per_device(128, n_dev, **kw)
                    == jscaling.gate_comm_bytes_per_device(128, n_dev, **kw))
        kw = dict(achieved_flops_per_s=3.1e13, ici_bytes_per_s=2e11, pairs_verified=640)
        assert (scaling.estimate_gate_scaling(n_dev=n_dev, **kw).as_dict()
                == jscaling.estimate_gate_scaling(n_dev=n_dev, **kw).as_dict())
        assert (scaling.gate_compute_flops_per_device(128, n_dev, (540, 720))
                == jscaling.gate_compute_flops_per_device(128, n_dev, (540, 720)))
    for args in ((512,), (1024, 256, 9, 256), (512, 64, 2, 32)):
        assert flops.matcher_flops(*args) == jflops.matcher_flops(*args)
    assert flops.superpoint_flops(264, 360) == jflops.superpoint_flops(264, 360)
    assert flops.resnet50_encoder_flops(270, 360) == jflops.resnet50_encoder_flops(270, 360)
    assert flops.dense_flops(7, 3, 5) == jflops.dense_flops(7, 3, 5)
    assert (flops.full_gate_flops(128, 640, (270, 360), 512)
            == jflops.full_gate_flops(128, 640, (270, 360), 512))
    # the card's defaults: an H100's NVLink rate and 0.15 of its bf16 peak
    est = scaling.estimate_gate_scaling(n_dev=8)
    assert scaling.NVLINK_BYTES_PER_S == 450e9 and flops.H100_PEAK_BF16 == 989e12
    assert est.compute_s == pytest.approx(
        scaling.gate_compute_flops_per_device(128, 8) / (0.15 * 989e12))
    assert 0.0 < est.efficiency <= 1.0 and est.comm_fraction < 0.1
