"""The port's VPR fine-tuning demo (mlis_tpu_torch/train/vpr_finetune_demo.py)
against mlis_tpu's: the aliasing set rendered from the JAX package's own
draws (labels exact; pixels within 5e-5, float32 homography solves and
warps in another order: measured 1.5e-5 at the demo's size), the
retrieval metrics exactly, and ``run_demo`` at its defaults held to
tests/test_vpr_finetune.py's contract, trained data-parallel over a
4-rank gloo world.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mlis_tpu.train import vpr_finetune_demo as jdemo  # noqa: E402
from test_torch_parallel_ranks import World  # noqa: E402
import test_torch_parallel_ranks as ranks  # noqa: E402

from mlis_tpu_torch.train import vpr_finetune_demo as tdemo  # noqa: E402
from mlis_tpu_torch.train.matcher_trainer import TEXTURE_SCALES  # noqa: E402


def jax_aliasing_draws(n_places, n_views, hw, seed=0) -> dict:
    """The raw U[0, 1) and N(0, 1) draws mlis_tpu's make_aliasing_images
    takes from PRNGKey(seed), in the port's ``draws`` layout."""
    H, W = hw
    N = 2 * n_places * n_views
    k_tex, k_cue, k_warp, k_b = jax.random.split(jax.random.PRNGKey(seed), 4)
    k1, k2 = jax.random.split(k_tex)
    grids = [jax.random.uniform(k, (n_places, H // s + 1, W // s + 1))
             for k, s in zip(jax.random.split(k1, 4), TEXTURE_SCALES)]
    corners = jax.vmap(lambda k: jax.random.uniform(k, (4, 2)))(jax.random.split(k_warp, N))
    draws = {"grids": grids, "gains": jax.random.normal(k2, (n_places, 2)),
             "cue": jax.random.uniform(k_cue, (2, 4, 6)), "corners": corners,
             "bright": jax.random.uniform(k_b, (N,))}
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.asarray(x)), draws)


def test_aliasing_images_from_jax_draws():
    n_places, n_views, hw = 3, 2, (32, 48)
    want = jdemo.make_aliasing_images(n_places=n_places, n_views=n_views, hw=hw)
    got = tdemo.make_aliasing_images(n_places=n_places, n_views=n_views, hw=hw,
                                     draws=jax_aliasing_draws(n_places, n_views, hw),
                                     device="cpu")
    assert got[0].shape == want[0].shape == (2 * n_places * n_views, *hw, 3)
    assert got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=5e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int32


def test_aliasing_set_construction_and_metrics():
    """tests/test_vpr_finetune.py's construction check on the port's own
    draws, and retrieval_metrics equal on the same descriptors."""
    images, place_ids, floors = tdemo.make_aliasing_images(n_places=3, n_views=2, hw=(32, 48),
                                                           device="cpu")
    assert images.shape == (12, 32, 48, 3)
    assert len(set(place_ids.tolist())) == 6 and set(floors.tolist()) == {2, 5}
    flat = images[..., 0].reshape(12, -1)
    flat = flat - flat.mean(1, keepdims=True)
    flat /= np.linalg.norm(flat, axis=1, keepdims=True) + 1e-8
    sims = flat @ flat.T
    aliased = [sims[i, i + 6] for i in range(6)]  # same plan, other floor
    unrelated = [sims[a, b] for a in range(6) for b in range(a + 1, 6)
                 if place_ids[a] != place_ids[b]]
    assert np.mean(aliased) > np.mean(unrelated) + 0.1
    desc = np.random.default_rng(0).normal(size=(12, 16)).astype(np.float32)
    for k in (1, 5):
        assert (tdemo.retrieval_metrics(desc, place_ids, floors, k)
                == jdemo.retrieval_metrics(desc, place_ids, floors, k))


def test_finetune_reduces_cross_floor_retrieval(tmp_path):
    """run_demo's 150 steps, every rank of the world in the data axis."""
    world = World(4, str(tmp_path))
    try:
        results = world.run(ranks.finetune_demo, 150)
    finally:
        world.close()
    r = results[0]
    assert all(o == r for o in results)
    print(r)
    assert r["steps"] == 150 and r["n_images"] == 64
    assert r["loss_last"] < r["loss_first"] * 0.5
    before, after = r["before"], r["after"]
    assert after["cross_floor_false_rate"] <= before["cross_floor_false_rate"] - 0.15, r
    assert after["same_floor_recall"] >= 0.9, r
    assert after["same_floor_recall"] > before["same_floor_recall"], r
