"""The port's GT-scene renderer held against mlis_tpu's: the JAX package's
own random draws, rebuilt from its key splits, go through the port's
render step, and the scene must come out as the JAX package renders it.

Exact: floors, timestamps, K (values and dtype), GT pairs, aliased pairs.
Images: at least 99% of pixels within one uint8 level. Both sides warp in
float32 but invert the homographies and sum the bilinear taps in their
own order, so a pixel whose value sits at a level boundary (or a mask
value at its 0.5 cut) can land one level, or one layer, apart. Measured
at 2 floors x 4 places at 135x180 (16 frames, 388,800 pixels each): every
pixel of v1 and of v2 within one level; 22 pixels of v1 (0.0057%) and 8
of v2 (0.0021%) one level apart, the rest equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.eval import quality as jq  # noqa: E402
from mlis_tpu.train import matcher_trainer as jmt  # noqa: E402

from mlis_tpu_torch.eval import quality as tq  # noqa: E402
from mlis_tpu_torch.train import matcher_trainer as tmt  # noqa: E402

HW = (135, 180)
N_FLOORS, N_PLACES = 2, 4
PIXEL_SHARE = 0.99  # share of pixels that must lie within one uint8 level


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_texture_draws(key, n, H, W):
    """The raw draws of mlis_tpu's synthetic_textures(key, n, H, W)."""
    k1, k2 = jax.random.split(key)
    scale_keys = jax.random.split(k1, 4)
    grids = [_t(jax.random.uniform(scale_keys[i], (n, H // s + 1, W // s + 1)))
             for i, s in enumerate(tmt.TEXTURE_SCALES)]
    return grids, _t(jax.random.normal(k2, (n, 2)))


def jax_draws_v1(seed, n_places, hw):
    """make_quality_scene's draws: split(key, 3) into textures, one warp key
    per frame, brightness."""
    H, W = hw
    k_tex, k_warp, k_bright = jax.random.split(jax.random.PRNGKey(seed), 3)
    N = 4 * n_places
    corners = jax.vmap(lambda k: jax.random.uniform(k, (4, 2)))(jax.random.split(k_warp, N))
    return tq.SceneDrawsV1(*jax_texture_draws(k_tex, n_places, H, W), _t(corners),
                           _t(jax.random.uniform(k_bright, (N,))))


def jax_draws_v2(seed, n_floors, n_places, hw, n_layers=3):
    """make_quality_scene_v2's draws, with its key reuse: every rotation
    draw from pose_keys[0], every translation draw from pose_keys[1], the
    occluder switch from occ_keys[0], and each occluder mask from its own
    occ_keys[i] (occ_keys[0] included)."""
    H, W = hw
    P, F, L = n_places, n_floors, n_layers
    N = F * 2 * P
    k_fam, k_uni, k_mask, k_pose, k_occ, k_bright, k_occtex = jax.random.split(
        jax.random.PRNGKey(seed), 7)
    mask_keys = jax.random.split(k_mask, P * L).reshape(P, L, 2)
    mask_noise = np.stack([
        np.stack([np.asarray(jax.random.uniform(mask_keys[p, l], (H // 40 + 2, W // 40 + 2)))
                  for l in range(L - 1)])
        for p in range(P)])
    pose_keys = jax.random.split(k_pose, N)
    occ_keys = jax.random.split(k_occ, N)
    occ_noise = jax.vmap(lambda k: jax.random.uniform(k, (H // 64 + 2, W // 64 + 2)))(occ_keys)
    return tq.SceneDrawsV2(
        *jax_texture_draws(k_fam, P * L, H, W),
        *jax_texture_draws(k_uni, F * P * L, H, W),
        _t(mask_noise),
        _t(jax.random.uniform(pose_keys[0], (N, 3))),
        _t(jax.random.uniform(pose_keys[min(1, N - 1)], (N, 3))),
        _t(jax.random.uniform(occ_keys[0], (N,))),
        _t(occ_noise),
        _t(jax.random.uniform(k_bright, (N,))),
        *jax_texture_draws(k_occtex, 8, H, W),
    )


def assert_same_scene(got, ref):
    np.testing.assert_array_equal(got.floors, ref.floors)
    assert got.floors.dtype == ref.floors.dtype
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    assert got.timestamps.dtype == ref.timestamps.dtype
    np.testing.assert_array_equal(got.K, ref.K)
    assert got.K.dtype == ref.K.dtype
    assert got.gt_pairs == ref.gt_pairs
    assert got.aliased_pairs == ref.aliased_pairs
    assert got.images.dtype == ref.images.dtype == np.uint8
    assert got.images.shape == ref.images.shape
    diff = np.abs(got.images.astype(np.int16) - ref.images.astype(np.int16))
    share = float((diff <= 1).mean())
    assert share >= PIXEL_SHARE, f"only {share:.5f} of pixels within one level"
    return share


@pytest.fixture(scope="module")
def scene_v2_ref():
    return jq.make_quality_scene_v2(n_floors=N_FLOORS, n_places=N_PLACES, hw=HW, seed=0)


def test_v1_render_from_jax_draws():
    ref = jq.make_quality_scene(n_places=N_PLACES, hw=HW, seed=1)
    got = tq.render_quality_scene(jax_draws_v1(1, N_PLACES, HW), n_places=N_PLACES, hw=HW)
    assert_same_scene(got, ref)
    assert len(got.gt_pairs) == 2 * N_PLACES and len(got.aliased_pairs) == 4 * N_PLACES


def test_v2_render_from_jax_draws(scene_v2_ref):
    got = tq.render_quality_scene_v2(jax_draws_v2(0, N_FLOORS, N_PLACES, HW),
                                     n_floors=N_FLOORS, n_places=N_PLACES, hw=HW)
    assert_same_scene(got, scene_v2_ref)
    np.testing.assert_array_equal(np.unique(got.floors), [2, 5])
    assert len(got.gt_pairs) == N_FLOORS * N_PLACES


def test_textures_and_warp_alone():
    H, W = HW
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jmt.synthetic_textures(key, 3, H, W))
    got = tmt.synthetic_textures(*jax_texture_draws(key, 3, H, W), H, W)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)

    u = jax.random.uniform(jax.random.PRNGKey(8), (4, 2))
    jax_hm = jmt.random_homography(jax.random.PRNGKey(8), H, W, 0.08)
    hm = tmt.random_homography(_t(u), H, W, 0.08)
    np.testing.assert_allclose(hm.numpy(), np.asarray(jax_hm), rtol=1e-4, atol=1e-6)
    # warp alone: a projective homography whose inverse is exact in float32
    # (entries powers of two), so both sides sample at the same source
    # coordinates, and part of the frame maps from outside the source
    exact = np.asarray([[1, 0, 0], [0, 1, 0], [-2.0**-10, 2.0**-11, 1]], np.float32)
    ref_w = np.asarray(jmt.warp_image(jnp.asarray(ref[0]), jnp.asarray(exact)))
    got_w = tmt.warp_image(torch.from_numpy(ref[0].copy()), torch.from_numpy(exact))
    np.testing.assert_allclose(got_w.numpy(), ref_w, atol=1e-5, rtol=0)
    assert (ref_w == 0).mean() > 0.01  # the zero fill outside the view is exercised
    # the random homography: each side inverts it in its own float32 order,
    # so a source coordinate near x = 180 may move by ~2 ulp (3e-5 px) and a
    # pixel next to a block edge (a jump of up to ~0.6) by ~2e-5
    hm32 = np.array(jax_hm, np.float32)
    ref_r = np.asarray(jmt.warp_image(jnp.asarray(ref[0]), jnp.asarray(hm32)))
    got_r = tmt.warp_image(torch.from_numpy(ref[0].copy()), torch.from_numpy(hm32))
    np.testing.assert_allclose(got_r.numpy(), ref_r, atol=5e-5, rtol=0)
    # batched warps equal one-by-one warps
    both = tmt.warp_image(torch.from_numpy(ref[:2].copy()),
                          torch.from_numpy(np.stack([hm32, exact])))
    np.testing.assert_array_equal(both[0].numpy(), got_r.numpy())
    pts = np.asarray([[0.0, 0.0], [10.5, 20.25], [W - 1.0, H - 1.0]], np.float32)
    np.testing.assert_allclose(
        tmt.apply_homography(torch.from_numpy(hm32), torch.from_numpy(pts)).numpy(),
        np.asarray(jmt.apply_homography(jnp.asarray(hm32), jnp.asarray(pts))), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("coverage,block", [(0.22, 40), (0.40, 40), (0.20, 64)])
def test_blob_mask_is_exact(coverage, block):
    H, W = HW
    keys = jax.random.split(jax.random.PRNGKey(11), 6)
    for k in keys:
        ref = np.asarray(jq._blob_mask(k, H, W, coverage, block))
        u = _t(jax.random.uniform(k, (H // block + 2, W // block + 2)))
        np.testing.assert_array_equal(tq._blob_mask(u, H, W, coverage, block).numpy(), ref)


def test_pose_pieces_match():
    angles = np.asarray([[0.05, -0.03, 0.08], [0.0, 0.0, 0.0]], np.float32)
    got = tq._rotation_matrix(torch.from_numpy(angles))
    for a, g in zip(angles, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(jq._rotation_matrix(jnp.asarray(a))),
                                   atol=1e-7)
    K = jnp.asarray([[100.0, 0, 90.0], [0, 100.0, 67.5], [0, 0, 1.0]])
    t = np.asarray([0.3, -0.2, 1.1], np.float32)
    ref = jq._plane_homography(K, jnp.linalg.inv(K), jnp.asarray(got[0].numpy()), jnp.asarray(t), 7.0)
    Kt = torch.from_numpy(np.asarray(K))
    mine = tq._plane_homography(Kt, torch.linalg.inv(Kt), got[0], torch.from_numpy(t), 7.0)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_torch_draws_render_a_full_scene_deterministically():
    a = tq.make_quality_scene_v2(n_floors=N_FLOORS, n_places=N_PLACES, hw=HW, seed=3, device="cpu")
    b = tq.make_quality_scene_v2(n_floors=N_FLOORS, n_places=N_PLACES, hw=HW, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.images, b.images)
    assert a.images.shape == (2 * N_FLOORS * N_PLACES, *HW) and a.images.dtype == np.uint8
    assert 20 < a.images.mean() < 235 and a.images.std() > 10
    c = tq.make_quality_scene_v2(n_floors=N_FLOORS, n_places=N_PLACES, hw=HW, seed=4, device="cpu")
    assert (a.images != c.images).mean() > 0.5
    v1 = tq.make_quality_scene(n_places=N_PLACES, hw=HW, seed=3, device="cpu")
    assert v1.images.shape == (4 * N_PLACES, *HW) and v1.K.dtype == np.float64
