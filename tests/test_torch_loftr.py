"""The port's LoFTR (mlis_tpu_torch/models/loftr.py) held against mlis_tpu's
in-env LoFTR, the architecture the shipped checkpoints hold.

Pieces at ``LoFTRConfig.tiny_test`` with the JAX package's parameters
carried across (``weights.carry_jax_matcher``), in float32: linear
attention, one linear-attention layer, the whole coarse network and the
fine refinement within 2e-6 absolute (float32 GEMMs and einsums summed in
another order: a few ulps of the unit-scale activations); in bf16 the
coarse tokens within 2^-6 (a few bf16 ulps after four layers).
``coarse_match`` gives the same indices and validity in float32 with both
normalisations and ``border_rm``, the dual-softmax scores within 2e-6
(a last ulp of the two softmaxes). The resize contract (270x360
-> 264x360, keypoints scaled back) agrees with ``jax.image.resize
(method="linear")`` within 2^-15 on [0, 1] images: both compute the
triangle filter's weights in float32 from sample coordinates up to 270,
whose float32 ulp is 2^-15.

``LoFTRConfig(official=True)`` builds the official architecture, held
in tests/test_torch_loftr_official.py.

The shipped ``loftr_parallax.npz`` in both packages on pairs of the JAX
package's seed-0 v2 scene (135x180, resized to 128x176): in float32 the
valid masks and the matched coarse cells are equal, the refined points
within 1e-4 px and the scores within 1e-5; in bf16 (as shipped) at least
98% of each pair's matched cells are shared (measured: all but one of
1262) and the match counts within 2%.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import loftr as jl  # noqa: E402
from mlis_tpu.models.weights import load_params_npz as jax_load_params  # noqa: E402
from test_torch_quality import shared_v2_scene  # noqa: E402

from mlis_tpu_torch.models import loftr as tl  # noqa: E402
from mlis_tpu_torch.ops.image import resize_nhwc  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_matcher, from_jax_params  # noqa: E402

F32_ATOL = 2e-6
CKPT = "checkpoints/loftr_parallax.npz"


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def scene_gray(tmp_path_factory):
    sc = shared_v2_scene(tmp_path_factory)
    return np.ascontiguousarray((sc.images.astype(np.float32) / 255.0)[..., None])


def test_linear_attention_and_layer():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, n, 2, 16)).astype(np.float32) for n in (30, 45, 45))
    want = np.asarray(jl.linear_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tl.linear_attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)

    x, src = (rng.normal(size=(2, n, 32)).astype(np.float32) for n in (30, 45))
    layer = jl.LinearAttnLayer(32, 2, jnp.float32)
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(src))
    want = np.asarray(layer.apply(params, jnp.asarray(x), jnp.asarray(src)))
    port = tl.LinearAttnLayer(32, 2, torch.float32)
    port.load_state_dict(from_jax_params(_np_tree(params)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loftr_net_and_fine_refine(scene_gray, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    J = jl.LoFTR(jl.LoFTRConfig.tiny_test(dtype=jdt))
    T = tl.LoFTR(tl.LoFTRConfig.tiny_test(dtype=tdt), device="cpu")
    im0, im1 = scene_gray[[0, 1]][:, :128, :176], scene_gray[[8, 9]][:, :128, :176]
    J._init((128, 176))
    carry_jax_matcher(T, _np_tree(J.params["params"]))
    t0, t1, f0, f1, hw = (J.net.apply(J.params, jnp.asarray(im0), jnp.asarray(im1)))
    with torch.no_grad():
        u0, u1, e0, e1, thw = T.net(torch.from_numpy(im0), torch.from_numpy(im1))
    assert tuple(thw) == tuple(hw) == (16, 22)
    atol = F32_ATOL if dtype == "float32" else 2.0**-6
    for a, b in ((t0, u0), (t1, u1), (f0, e0), (f1, e1)):
        assert b.dtype == tdt
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=0, atol=atol)
    if dtype == "bfloat16":
        return
    # fine refinement from the same inputs
    rng = np.random.default_rng(3)
    fm = rng.normal(size=(2, 64, 88, 16)).astype(np.float32)
    xy = (rng.integers(0, 22, (2, 20, 2)) * 4 + 1.5).astype(np.float32)
    cf = rng.normal(size=(2, 20, 16)).astype(np.float32)
    want = np.asarray(jl.fine_refine(jnp.asarray(fm), jnp.asarray(xy), jnp.asarray(cf), 5, 2))
    got = tl.fine_refine(*(torch.from_numpy(x) for x in (fm, xy, cf)), 5, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("normalize,border_rm", [("l2", 0), ("sqrt_dim", 0), ("l2", 2),
                                                 ("sqrt_dim", 2)])
def test_coarse_match_exact(normalize, border_rm):
    rng = np.random.default_rng(4)
    base = rng.normal(size=(2, 12 * 15, 32)).astype(np.float32)
    t0 = base + 0.3 * rng.normal(size=base.shape).astype(np.float32)
    t1 = base[:, rng.permutation(base.shape[1])] + 0.3 * rng.normal(size=base.shape).astype(np.float32)
    kw = dict(normalize=normalize, grid_hw=(12, 15), border_rm=border_rm)
    want = [np.asarray(x) for x in jl.coarse_match(jnp.asarray(t0), jnp.asarray(t1), 0.1, 0.02, 64,
                                                   **kw)]
    got = [x.numpy() for x in tl.coarse_match(torch.from_numpy(t0), torch.from_numpy(t1), 0.1,
                                              0.02, 64, **kw)]
    assert want[3].sum() > 5
    for i in (0, 1, 3):  # indices and validity
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=F32_ATOL)


def test_resize_contract():
    x = np.random.default_rng(0).random((2, 270, 360, 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 264, 360, 1), method="linear"))
    got = resize_nhwc(torch.from_numpy(x), (264, 360)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-15)


def test_checkpoint_round_trip_and_official_refused(tmp_path):
    T = tl.LoFTR(device="cpu")
    T.load_weights(CKPT)
    out = tmp_path / "loftr.npz"
    T.save_weights(str(out))
    ref = jax_load_params(CKPT)["loftr"]
    back = jax_load_params(str(out))["loftr"]
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back) == 204
    for path, v in flat_ref:
        np.testing.assert_array_equal(flat_back[path], v)
    # official=True builds the kornia architecture (tests/test_torch_loftr_official.py)
    official = tl.LoFTR(tl.LoFTRConfig.official_tiny(), device="cpu")
    assert isinstance(official.net, tl.OfficialLoFTRMatcher)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shipped_checkpoint_on_scene_pairs(scene_gray, dtype):
    J = jl.LoFTR(jl.LoFTRConfig(dtype=getattr(jnp, dtype), match_threshold=0.05))
    J.load_weights(CKPT, image_hw=(135, 180))
    T = tl.LoFTR(tl.LoFTRConfig(dtype=getattr(torch, dtype), match_threshold=0.05), device="cpu")
    T.load_weights(CKPT)
    im0, im1 = scene_gray[[0, 1, 2, 3]], scene_gray[[8, 9, 10, 11]]
    a = [np.asarray(x) for x in J.match_batch(jnp.asarray(im0), jnp.asarray(im1))]
    b = [x.numpy() for x in T.match_batch(torch.from_numpy(im0), torch.from_numpy(im1))]
    for p in range(4):
        va, vb = a[3][p], b[3][p]
        cells_a = {tuple(x) for x in np.round(a[0][p][va], 3)}
        cells_b = {tuple(x) for x in np.round(b[0][p][vb], 3)}
        assert va.sum() > 100
        if dtype == "float32":
            np.testing.assert_array_equal(vb, va)
            assert cells_a == cells_b
            np.testing.assert_allclose(b[1][p][vb], a[1][p][va], rtol=0, atol=1e-4)
            np.testing.assert_allclose(b[2][p], a[2][p], rtol=0, atol=1e-5)
        else:
            assert len(cells_a & cells_b) >= 0.98 * max(len(cells_a), len(cells_b))
            assert abs(int(va.sum()) - int(vb.sum())) <= 0.02 * int(va.sum())
