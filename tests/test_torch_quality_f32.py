"""The float32 half of test_torch_quality.py, in a file of its own so that
the test workers can run it beside the bf16 half: the harness with
SuperPoint and LightGlue in float32 on both packages (the witness for the
bf16 band, held to test_torch_quality.py's band) and the proof that its
inlier drift on wrong-place pairs is the float32 8-point solve's rounding.
The scene, the protocol and the bands are test_torch_quality.py's (see
its module docstring).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.ops import epipolar as jep  # noqa: E402
from test_torch_quality import (  # noqa: E402,F401 - scene is a fixture
    F32_BANDS,
    HARNESS,
    HYP,
    _both_harnesses,
    _hold_to_band_rule,
    jax_ransac_keys,
    scene,
)

from mlis_tpu_torch.ops import epipolar as tep  # noqa: E402


@pytest.fixture(scope="module")
def runs_f32(scene):
    """The float32 harnesses, with the inputs of every RANSAC call the
    port's harness made: (kpts1, kpts2, valid, K, uniforms, ...)."""
    captured = []
    core = tep.essential_ransac_batch_core

    def spy(*args, **kw):
        captured.append(args)
        return core(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tep, "essential_ransac_batch_core", spy)
        ref, got = _both_harnesses(scene, float32=True)
    return ref, got, captured


def test_harness_float32_matches_under_the_issue_band(runs_f32):
    """The witness for the bf16 band: with float32 models the confident
    matches agree within 1 and inliers within 3 past the confident cut."""
    ref, got, _ = runs_f32
    assert (got["verified"], got["total_candidates"]) == (ref["verified"], ref["total_candidates"])
    drift = _hold_to_band_rule(got, ref, F32_BANDS)
    assert drift["pairs"] == got["verified"] > 0


class _JaxRansacSpy:
    """mlis_tpu's essential_ransac on one pair, and the 512 unprojected
    hypotheses its compiled program solved, in draw order. A debug
    callback on ``_eight_point`` ships each hypothesis out with its sample;
    the samples the draws pick then put them back in order. Compiled once."""

    def __init__(self, mp: pytest.MonkeyPatch):
        self.seen = {}
        solve = jep._eight_point

        def spy(x1, x2):
            E = solve(x1, x2)
            jax.debug.callback(lambda a, b, e: self.seen.__setitem__(
                np.concatenate([np.ravel(a), np.ravel(b)]).tobytes(), np.asarray(e)), x1, x2, E)
            return E

        mp.setattr(jep, "_eight_point", spy)
        self.ransac = jax.jit(lambda *args: jep.essential_ransac.__wrapped__(*args))

    def __call__(self, kpts1, kpts2, valid, K, key):
        self.seen.clear()
        args = [jnp.asarray(np.asarray(x)) for x in (kpts1, kpts2, valid, K)]
        res = self.ransac(*args, key)
        jax.effects_barrier()
        x1, x2 = (np.asarray(jep.normalize_points(a, args[3])) for a in args[:2])
        v = np.asarray(valid)
        u = np.asarray(jax.random.uniform(key, (HYP, 8)))
        n = int(v.sum())
        idx = np.argsort(~v, kind="stable")[np.minimum((u * max(n, 1)).astype(np.int32),
                                                       max(n - 1, 0))]
        samples = np.concatenate([x1[idx].reshape(HYP, -1), x2[idx].reshape(HYP, -1)], axis=1)
        keys = np.stack([np.frombuffer(k, np.float32) for k in self.seen])
        dist = np.abs(samples[:, None, :] - keys[None]).max(-1)
        assert dist.min(1).max() == 0.0  # every drawn sample found, bit for bit
        return res, np.stack(list(self.seen.values()))[dist.argmin(1)]


def test_float32_8_point_drift_is_rounding_not_scoring(runs_f32):
    """Where float32 inliers drift from the JAX package's (wrong-place
    pairs, E not pinned down), the cause is the 8-point solve's rounding:
    given the JAX package's own 512 hypotheses per pair, the port's scoring
    and selection give its inliers exactly on every pair, while the two
    packages' hypotheses differ by less than float32 eps x cond(A8^T A8 +
    1e-10 I), more as cond grows (a draw that repeats a correspondence
    makes A8 rank-deficient, cond above 1e10)."""
    ref, got, captured = runs_f32
    k1, k2, valid, uniforms = (torch.cat([c[i] for c in captured]) for i in (0, 1, 2, 4))
    K = captured[0][3]
    keys = jax_ransac_keys(ref["verified"], HARNESS["verify_batch"])
    assert len(keys) == k1.shape[0] == got["verified"]
    x1, x2 = tep.normalize_points(k1, K), tep.normalize_points(k2, K)
    thr = tep.sampson_threshold(K, 3.0)
    drifted = [p for p, (a, b) in enumerate(zip(got["pairs"], ref["pairs"]))
               if a["num_inliers"] != b["num_inliers"]]
    rel, cond = [], []
    with pytest.MonkeyPatch.context() as mp:
        jax_ransac = _JaxRansacSpy(mp)
        for p in range(k1.shape[0]):
            np.testing.assert_array_equal(uniforms[p].numpy(),
                                          np.asarray(jax.random.uniform(keys[p], (HYP, 8))))
            jres, Es = jax_ransac(k1[p], k2[p], valid[p], K, keys[p])
            fed = tep.score_hypotheses(torch.from_numpy(Es)[None], x1[p : p + 1], x2[p : p + 1],
                                       valid[p : p + 1], thr)
            assert int(fed.num_inliers[0]) == int(jres.num_inliers), p
            if p in drifted:
                Et = tep.sample_hypotheses(x1[p : p + 1], x2[p : p + 1], valid[p : p + 1],
                                           uniforms[p : p + 1])[0].numpy()
                rel.append(np.abs(Et - Es).max((1, 2)) / np.abs(Es).max((1, 2)))
                cond.append(_normal_equation_cond(x1[p].numpy(), x2[p].numpy(), valid[p].numpy(),
                                                  uniforms[p].numpy()))
    rel, cond = np.concatenate(rel), np.concatenate(cond)
    eps = float(np.finfo(np.float32).eps)
    drift = max(abs(got["pairs"][p]["num_inliers"] - ref["pairs"][p]["num_inliers"])
                for p in drifted)
    print(f"{len(drifted)} pairs whose float32 inliers drift, by up to {drift}")
    medians = []
    for lo, hi in ((0, 1e6), (1e6, 1e10), (1e10, np.inf)):
        m = (cond >= lo) & (cond < hi)
        assert m.any()
        medians.append(float(np.median(rel[m])))
        print(f"cond(A8^T A8 + 1e-10 I) in [{lo:.0e}, {hi:.0e}): {int(m.sum())} hypotheses, "
              f"relative difference median {medians[-1]:.2e} max {rel[m].max():.2e}, "
              f"eps x cond median {eps * np.median(cond[m]):.2e}")
        assert medians[-1] < eps * np.median(cond[m])
    assert len(drifted) >= 1 and medians == sorted(medians)


def _normal_equation_cond(x1, x2, valid, uniforms) -> np.ndarray:
    """cond(A8^T A8 + 1e-10 I) in float64 for each hypothesis' sample."""
    n = int(valid.sum())
    idx = np.argsort(~valid, kind="stable")[np.minimum((uniforms * max(n, 1)).astype(np.int64),
                                                       max(n - 1, 0))]
    h1 = np.concatenate([x1[idx], np.ones((*idx.shape, 1))], -1).astype(np.float64)
    h2 = np.concatenate([x2[idx], np.ones((*idx.shape, 1))], -1).astype(np.float64)
    A8 = (h2[..., :, None] * h1[..., None, :]).reshape(*idx.shape, 9)[..., :8]
    return np.linalg.cond(np.swapaxes(A8, -1, -2) @ A8 + 1e-10 * np.eye(8))
