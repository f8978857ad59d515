"""The port's SuperPoint against mlis_tpu's, float32, with the SuperPoint
weights shipped in lightglue_homog_sp.npz."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import superpoint as jsp  # noqa: E402
from mlis_tpu.models.convert import _match_dtypes  # noqa: E402
from mlis_tpu.models.weights import load_params_npz  # noqa: E402

from mlis_tpu_torch.models import superpoint as tsp  # noqa: E402
from mlis_tpu_torch.weights import load_npz  # noqa: E402

CKPT = "checkpoints/lightglue_homog_sp.npz"


def _blocky(rng, h, w, n=2):
    base = np.kron(rng.integers(0, 255, (h // 8 + 1, w // 8 + 1)), np.ones((8, 8)))[:h, :w]
    return np.stack([np.roll(base, 3 * i, 1) for i in range(n)]).astype(np.float32)[..., None] / 255.0


@pytest.mark.parametrize("hw,k", [((96, 128), 256), ((64, 80), 512)])
def test_detect_matches_with_shipped_weights(hw, k):
    rng = np.random.default_rng(hw[0])
    imgs = _blocky(rng, *hw)
    ref = jsp.SuperPoint(jsp.SuperPointConfig(max_keypoints=k, dtype=jnp.float32))
    ref.init_params(hw)
    ref.params = _match_dtypes({"params": load_params_npz(CKPT)["superpoint"]}, ref.params)
    want = ref.detect(jnp.asarray(imgs))
    port = tsp.SuperPoint(tsp.SuperPointConfig(max_keypoints=k, dtype=torch.float32), device="cpu")
    port.load_state(load_npz(CKPT)["superpoint"])
    got = port.detect(torch.from_numpy(imgs))
    # keypoint order (score-sorted, ties to the lower index) and masks exactly
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    m = got.mask.numpy()
    assert m.sum() > 20 and (np.diff(m.astype(int), axis=1) <= 0).all()  # prefix-valid
    # float32 conv stacks sum in different orders (oneDNN vs XLA)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=2e-6)
    np.testing.assert_allclose(got.descriptors.numpy()[m], np.asarray(want.descriptors)[m], atol=2e-6)


def test_nms_topk_and_sampling_on_fed_maps():
    rng = np.random.default_rng(1)
    heat = rng.random((2, 40, 48)).astype(np.float32)
    heat[0, 5:9, 5:9] = 0.7  # a plateau: ties inside one NMS window
    heat[1] = np.round(heat[1], 1)  # many exact ties for top-k
    want = np.asarray(jsp.nms_heatmap(jnp.asarray(heat), 4))
    got = tsp.nms_heatmap(torch.from_numpy(heat), 4).numpy()
    np.testing.assert_array_equal(got, want)
    for h in (heat, want):
        jc, js, jm = jsp.topk_keypoints(jnp.asarray(h), 64, 0.3)
        tc, ts, tm = tsp.topk_keypoints(torch.tensor(h), 64, 0.3)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    dmap = rng.normal(size=(2, 5, 6, 16)).astype(np.float32)
    coords = rng.uniform(-4, 52, size=(2, 30, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tsp.sample_descriptors(torch.from_numpy(dmap), torch.from_numpy(coords)).numpy(),
        np.asarray(jsp.sample_descriptors(jnp.asarray(dmap), jnp.asarray(coords))),
        atol=1e-6)
