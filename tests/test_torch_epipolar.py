"""The port's essential-matrix RANSAC and pose recovery against mlis_tpu's,
fed the reference's own hypothesis draws, on synthetic two-view scenes
with known motion, noise and outliers.

Tolerances: the 8-point hypotheses solve ill-conditioned normal equations
in float32 by Gauss-Jordan without pivoting, so XLA and torch hypotheses
differ by ~1e-4 relative; a point at the Sampson threshold may then flip.
Inlier counts are held to +-1, E up to sign and the pose to 1e-3."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.ops import epipolar as je  # noqa: E402

from mlis_tpu_torch.ops import epipolar as te  # noqa: E402

K = np.array([[200.0, 0, 180.0], [0, 200.0, 135.0], [0, 0, 1.0]])


def _rot(ax, ay, az):
    cx, sx, cy, sy, cz, sz = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def scene(seed, n=160, n_valid=140, outliers=30, noise=0.3):
    """Correspondences x2 ~ R x1 + t in pixels, a valid prefix of n_valid."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(4, 10, n)]
    R = _rot(*rng.uniform(-0.15, 0.15, 3))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)

    def proj(P):
        p = P @ K.T
        return p[:, :2] / p[:, 2:]

    k1 = proj(X) + rng.normal(0, noise, (n, 2))
    k2 = proj(X @ R.T + t) + rng.normal(0, noise, (n, 2))
    k2[:outliers] = rng.uniform(0, 360, (outliers, 2))
    valid = np.arange(n) < n_valid
    return k1.astype(np.float32), k2.astype(np.float32), valid, R, t


def _jax_batch(k1, k2, valid, key, hyp, subset=0):
    return je.essential_ransac_batch(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(valid),
                                     jnp.asarray(K, jnp.float32), key, hyp, 3.0, subset)


def _draws(key, P, hyp):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (hyp, 8)))(jax.random.split(key, P)))


def _assert_e_close(e_got, e_want, atol=1e-3):
    s = np.sign((e_got * e_want).sum())
    np.testing.assert_allclose(s * e_got, e_want, atol=atol)


@pytest.mark.parametrize("subset", [0, 48])
def test_ransac_batch_matches_mlis_tpu_with_fed_draws(subset):
    scenes = [scene(s) for s in range(4)]
    k1 = np.stack([s[0] for s in scenes])
    k2 = np.stack([s[1] for s in scenes])
    valid = np.stack([s[2] for s in scenes])
    valid[2, 100:] = False  # shorter valid prefix on one pair
    key = jax.random.PRNGKey(11)
    (res, T, good) = _jax_batch(k1, k2, valid, key, 256, subset)
    u = torch.tensor(_draws(key, 4, 256))
    got, T_t, good_t = te.essential_ransac_batch(
        torch.from_numpy(k1), torch.from_numpy(k2), torch.from_numpy(valid),
        torch.from_numpy(K), 256, 3.0, subset, uniforms=u)
    assert np.abs(got.num_inliers.numpy() - np.asarray(res.num_inliers)).max() <= 1
    np.testing.assert_allclose(got.inlier_ratio.numpy(), np.asarray(res.inlier_ratio), atol=0.01)
    for p in range(4):
        _assert_e_close(got.E[p].numpy(), np.asarray(res.E[p]))
        np.testing.assert_allclose(T_t[p].numpy(), np.asarray(T[p]), atol=1e-3)
        assert (got.inlier_mask[p].numpy() != np.asarray(res.inlier_mask[p])).sum() <= 1
    assert (got.num_inliers.numpy() >= 55).all()
    # the recovered motion is near the planted one (a fixed hypothesis
    # budget on 0.3 px noise: a few degrees)
    for p, (_, _, _, R, t) in enumerate(scenes):
        np.testing.assert_allclose(T_t[p, :3, :3].numpy(), R, atol=0.1)
        assert float(T_t[p, :3, 3].numpy() @ t) > 0.9


def test_single_pair_api_and_generator_draws():
    k1, k2, valid, R, t = scene(5)
    key = jax.random.PRNGKey(2)
    ref = je.essential_ransac(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(valid),
                              jnp.asarray(K, jnp.float32), key, 128, 3.0)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (128, 8))))
    args = (torch.from_numpy(k1), torch.from_numpy(k2), torch.from_numpy(valid), torch.from_numpy(K))
    got = te.essential_ransac(*args, 128, 3.0, uniforms=u)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 1
    _assert_e_close(got.E.numpy(), np.asarray(ref.E))
    T_ref, good_ref, det_ref = je.recover_pose(ref.E, jnp.asarray(k1), jnp.asarray(k2), ref.inlier_mask,
                                               jnp.asarray(K, jnp.float32))
    T, good, det = te.recover_pose(got.E, args[0], args[1], got.inlier_mask, args[3])
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), atol=1e-3)
    assert abs(int(good) - int(good_ref)) <= 1 and float(det) == pytest.approx(1.0, abs=1e-4)
    # production draws come from a torch.Generator; the scene is easy enough
    # that any seed finds the motion
    g = torch.Generator().manual_seed(0)
    drawn = te.essential_ransac(*args, 256, 3.0, generator=g)
    assert int(drawn.num_inliers) >= int(ref.num_inliers) - 3


def test_pieces_match_mlis_tpu():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(8, 8)).astype(np.float32)
    M = M @ M.T + 8 * np.eye(8, dtype=np.float32)
    b = rng.normal(size=8).astype(np.float32)
    np.testing.assert_allclose(
        te._gauss_jordan_solve(torch.from_numpy(M)[None], torch.from_numpy(b)[None])[0].numpy(),
        np.asarray(je._gauss_jordan_solve(jnp.asarray(M), jnp.asarray(b))), rtol=1e-5, atol=1e-6)
    k1, k2, _, R, t = scene(4, outliers=0, noise=0.0)
    x1 = te.normalize_points(torch.from_numpy(k1), torch.from_numpy(K).float())
    x2 = te.normalize_points(torch.from_numpy(k2), torch.from_numpy(K).float())
    E = te._eight_point(x1[:16], x2[:16])
    E_ref = je._eight_point(jnp.asarray(x1[:16].numpy()), jnp.asarray(x2[:16].numpy()))
    # the unprojected solve is ill-conditioned in float32 (see the module
    # docstring); projected, both land on the true essential matrix
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_true = (tx @ R).astype(np.float32)
    Ep = te._project_essential(E)
    _assert_e_close(Ep.numpy() / np.linalg.norm(Ep.numpy()), E_true / np.linalg.norm(E_true))
    Ep_ref = np.asarray(je._project_essential(E_ref))
    _assert_e_close(Ep.numpy(), Ep_ref)
    np.testing.assert_allclose(torch.linalg.svdvals(Ep).numpy(), [1, 1, 0], atol=1e-5)
    err = te.sampson_error(Ep[None, None], x1[None], x2[None])[0, 0].numpy()
    err_ref = np.asarray(je.sampson_error(jnp.asarray(Ep.numpy()), jnp.asarray(x1.numpy()),
                                          jnp.asarray(x2.numpy())))
    np.testing.assert_allclose(err, err_ref, rtol=1e-4, atol=1e-12)
    assert err.max() < 1e-8  # noise-free correspondences satisfy the projected E
