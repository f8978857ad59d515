"""The port's PCM filter and pose-graph demo (mlis_tpu_torch/opt/{pcm,
demo}.py) held against mlis_tpu's on the CPU. Both packages draw from
np.random.default_rng, so they see the same scenes, noise and candidates.

Tolerances: PCM's cycle residuals within 1e-4 relative (plus, on se3_log's
analytic branch, the float32 cancellation bound of tests/test_torch_lie.py),
keep masks and the greedy clique equal; the demo's scene, odometry and candidates within
1e-6 (indices and truth exact); candidate counts exact and ate_init within
1e-6 (relative); after the reduced solves (2 Gauss-Newton steps of 8 CG
iterations) every final ATE within 1e-4 relative, except GNC's (30 rounds
of the anneal re-weight on float32 CG iterates) within 1e-2, and every
SC / GNC / PCM decision rate equal."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mlis_tpu.opt.demo as jdemo  # noqa: E402
import mlis_tpu.opt.pcm as jpcm  # noqa: E402
import mlis_tpu_torch.opt.demo as demo  # noqa: E402
import mlis_tpu_torch.opt.pcm as pcm  # noqa: E402

DEPTH = dict(num_iters=2, cg_iters=8)
ATE_RTOL, GNC_RTOL = 1e-4, 1e-2


@pytest.fixture(scope="module")
def demo_inputs():
    scene = jdemo.build_multifloor_scene(laps=2, seed=0)
    _, _, _, init_R, init_t = jdemo.simulate_odometry(scene["gt_R"], scene["gt_t"], seed=0)
    pairs, mR, mt, is_true = jdemo.make_loop_candidates(scene, seed=0)
    return init_R, init_t, pairs, mR, mt, is_true


def test_demo_scene_odometry_and_candidates_match():
    scene, jscene = demo.build_multifloor_scene(laps=2), jdemo.build_multifloor_scene(laps=2)
    for k in ("gt_t", "floor_labels", "lap_starts", "lap_len", "floors", "elevator"):
        np.testing.assert_array_equal(np.asarray(scene[k], dtype=object),
                                      np.asarray(jscene[k], dtype=object), err_msg=k)
    np.testing.assert_allclose(scene["gt_R"], jscene["gt_R"], rtol=0, atol=1e-6)
    odo = demo.simulate_odometry(jscene["gt_R"], jscene["gt_t"], seed=0, device="cpu")
    jodo = jdemo.simulate_odometry(jscene["gt_R"], jscene["gt_t"], seed=0)
    assert odo[0] == jodo[0]
    for a, b in zip(odo[1:], jodo[1:]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    cand = demo.make_loop_candidates(jscene, seed=0, device="cpu")
    jcand = jdemo.make_loop_candidates(jscene, seed=0)
    np.testing.assert_array_equal(cand[0], jcand[0])
    np.testing.assert_array_equal(cand[3], jcand[3])
    for a, b in zip(cand[1:3], jcand[1:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows", [None, 5])
def test_pcm_cycle_residuals_and_keep_match(demo_inputs, monkeypatch, rows):
    init_R, init_t, pairs, mR, mt, is_true = demo_inputs
    if rows:  # blocks of 5 rows: the block loop's edges
        monkeypatch.setattr(pcm, "_BLOCK_PAIRS", rows * len(pairs))
    keep, r2 = pcm.pcm_filter(init_R, init_t, pairs, mR, mt, sigma_rho=0.5, sigma_omega=0.05,
                              device="cpu")
    jkeep, jr2 = jpcm.pcm_filter(init_R, init_t, pairs, mR, mt, sigma_rho=0.5, sigma_omega=0.05)
    excess = np.abs(r2 - jr2) - _cycle_r2_tolerance(demo_inputs, jr2)
    assert (excess <= 0).all(), excess.max()
    np.testing.assert_array_equal(keep, jkeep)
    assert keep[is_true].all() and not keep[~is_true].any()
    # PCM defeated by majority aliasing (tests/test_pcm.py:59-81): equal again
    sel = np.concatenate([np.where(is_true)[0][:3], np.where(~is_true)[0]])
    k2, _ = pcm.pcm_filter(init_R, init_t, pairs[sel], mR[sel], mt[sel], sigma_rho=0.5,
                           sigma_omega=0.05, device="cpu")
    jk2, _ = jpcm.pcm_filter(init_R, init_t, pairs[sel], mR[sel], mt[sel], sigma_rho=0.5,
                             sigma_omega=0.05)
    np.testing.assert_array_equal(k2, jk2)
    assert k2[3:].all() and not k2[:3].any()
    empty = pcm.pcm_filter(init_R, init_t, np.zeros((0, 2), int), mR[:0], mt[:0], device="cpu")
    assert empty[0].shape == (0,) and empty[1].shape == (0, 0)


def _cycle_r2_tolerance(demo_inputs, r2, w_rho=1 / 0.5):
    """1e-4 relative, plus for cycles on the analytic branch of se3_log
    (theta^2 >= 1e-4) the float32 cancellation bound of its rho (see
    tests/test_torch_lie.py), 4 eps |t| / theta^2 per component, carried
    into r2 = |r|^2 as 2 |r| |dr|. The cycle poses in float64."""
    R, t, pairs, mR, mt, _ = (np.asarray(x, np.float64) for x in demo_inputs)
    ci, cj = pairs[:, 0].astype(int), pairs[:, 1].astype(int)

    def rel(a, b):  # T_a^-1 T_b, broadcast
        Ra = np.swapaxes(R[a], -1, -2)
        return Ra @ R[b], np.einsum("...ij,...j->...i", Ra, t[b] - t[a])

    def comp(A, B):
        return A[0] @ B[0], np.einsum("...ij,...j->...i", A[0], B[1]) + A[1]

    Za_inv = (np.swapaxes(mR, -1, -2)[:, None], -np.einsum("aji,aj->ai", mR, mt)[:, None])
    C = comp(comp(comp(Za_inv, rel(ci[:, None], ci[None, :])), (mR[None], mt[None])),
             rel(cj[None, :], cj[:, None]))
    cos = np.clip((np.trace(C[0], axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    th2 = np.arccos(cos) ** 2
    eps = float(np.finfo(np.float32).eps)
    drho = np.where(th2 >= 1e-4, 4 * eps * np.linalg.norm(C[1], axis=-1) / np.maximum(th2, 1e-4),
                    0.0) * w_rho * np.sqrt(3)
    return 1e-4 * np.abs(r2) + 1e-6 + 2 * np.sqrt(np.abs(r2)) * drho


def test_greedy_max_clique_matches():
    rng = np.random.default_rng(5)
    for n, p in ((1, 0.0), (12, 0.3), (40, 0.5), (64, 0.8)):
        adj = rng.random((n, n)) < p
        adj = adj | adj.T
        np.testing.assert_array_equal(pcm.greedy_max_clique(adj), jpcm.greedy_max_clique(adj))
    r2 = pcm.pairwise_cycle_r2(*(torch.as_tensor(x) for x in (
        np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)), np.zeros((4, 3), np.float32),
        np.array([0, 1]), np.array([2, 3]), np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
        np.zeros((2, 3), np.float32), np.ones(6, np.float32))))
    assert float(r2.abs().max()) == 0.0  # identity cycles


def _compare_results(got, want, ate_rtol=ATE_RTOL):
    for k, v in want.items():
        if isinstance(v, (bool, int, str)):
            assert got[k] == v, k
        elif k.endswith(("false_disabled", "true_kept", "false_removed")):
            assert got[k] == v, k
        elif k == "ate_init":
            assert abs(got[k] - v) <= 1e-6 * abs(v), (got[k], v)
        elif k.endswith("solve_s"):
            continue
        else:
            rtol = GNC_RTOL if k.startswith("gnc_") else ate_rtol
            if k.endswith("cost_final"):
                rtol = 2 * GNC_RTOL if k.startswith("gnc_") else 1e-3
            assert abs(got[k] - v) <= rtol * abs(v), (k, got[k], v)


def test_run_pgo_demo_matches():
    got = demo.run_pgo_demo(seed=0, device="cpu", **DEPTH)
    want = jdemo.run_pgo_demo(seed=0, **DEPTH)
    assert set(got) == set(want)
    _compare_results(got, want)
    assert got["gate_correct"] and got["n_candidates"] == 23
