"""The port's image preprocessing, cosine retrieval and MixVPR encoder
against mlis_tpu on the same numpy inputs."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models.base import fit_descriptor_dim as jax_fit  # noqa: E402
from mlis_tpu.models.resnet import ResNetConfig as JaxResNetConfig  # noqa: E402
from mlis_tpu.ops import image as jimage  # noqa: E402
from mlis_tpu.ops import knn as jknn  # noqa: E402
from mlis_tpu.train.pretrain_vpr import load_mixvpr_vpr  # noqa: E402

from mlis_tpu_torch.gating.place_recognition import SemanticPlaceRecognition  # noqa: E402
from mlis_tpu_torch.models.base import fit_descriptor_dim  # noqa: E402
from mlis_tpu_torch.models.mixvpr import MixVPR  # noqa: E402
from mlis_tpu_torch.models.resnet import ResNetConfig  # noqa: E402
from mlis_tpu_torch.models.vit import ViTConfig  # noqa: E402
from mlis_tpu_torch.ops import image as timage  # noqa: E402
from mlis_tpu_torch.ops import knn as tknn  # noqa: E402

# float32 image resampling: the two libraries sum the filter taps in
# different orders
IMG_ATOL = 2e-5


@pytest.mark.parametrize("shape", [(2, 270, 360), (2, 270, 360, 1), (2, 60, 80, 3)])
@pytest.mark.parametrize("size", [(320, 320), (264, 360), (40, 40)])
def test_preprocess_imagenet(shape, size):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, shape, dtype=np.uint8)
    want = np.asarray(jimage.preprocess_imagenet(jnp.asarray(x), size))
    got = timage.preprocess_imagenet(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=IMG_ATOL * 5)  # /std scales by up to 4.5


@pytest.mark.parametrize("shape,size,bgr", [
    ((3, 270, 360), (264, 360), True), ((2, 40, 50, 3), None, True),
    ((2, 40, 50, 3), (32, 48), False), ((40, 50, 3), None, True)])
def test_to_grayscale(shape, size, bgr):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 255, shape, dtype=np.uint8)
    # mlis_tpu's jitted to_grayscale cannot take bgr (it is not static):
    # hand it the channel-reversed image instead
    want = np.asarray(jimage.to_grayscale(jnp.asarray(x if bgr else x[..., ::-1]), size=size))
    got = timage.to_grayscale(torch.from_numpy(x), size=size, bgr=bgr).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=IMG_ATOL)


def _duplicated_db(rng, n_base=6, reps=4, d=32):
    base = rng.normal(size=(n_base, d)).astype(np.float32)
    return np.concatenate([base] * reps)  # exact duplicates -> exact score ties


@pytest.mark.parametrize("compute", ["bf16", "f32"])
@pytest.mark.parametrize("chunk", [5, 1024])
def test_cosine_topk_ties_go_to_the_lower_index(compute, chunk):
    rng = np.random.default_rng(2)
    db = _duplicated_db(rng)
    times = (np.arange(len(db)) * 4.0).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if compute == "bf16" else (jnp.float32, torch.float32)
    js, ji = jknn.cosine_topk(jnp.asarray(db), jnp.asarray(db), jnp.asarray(times),
                              jnp.asarray(times), k=7, min_time_gap=6.0, chunk=chunk,
                              compute_dtype=jdt)
    ts, ti = tknn.cosine_topk(torch.from_numpy(db), torch.from_numpy(db),
                              torch.from_numpy(times), torch.from_numpy(times), k=7,
                              min_time_gap=6.0, chunk=chunk, compute_dtype=tdt)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    # each query's duplicates tie at the top: listed in ascending index order
    for q in range(len(db)):
        dup = [i for i in range(q % 6, len(db), 6) if abs(times[i] - times[q]) >= 6.0]
        assert ti[q, : len(dup)].tolist() == dup


def test_cosine_topk_without_times_and_pairwise_similarity():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    db = rng.normal(size=(20, 16)).astype(np.float32)
    js, ji = jknn.cosine_topk(jnp.asarray(q), jnp.asarray(db), k=4)
    ts, ti = tknn.cosine_topk(torch.from_numpy(q), torch.from_numpy(db), k=4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    want = np.asarray(jknn.pairwise_similarity(jnp.asarray(db), chunk=7))
    got = tknn.pairwise_similarity(torch.from_numpy(db), chunk=7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_fit_descriptor_dim():
    x = np.arange(12.0, dtype=np.float32).reshape(2, 6)
    for dim in (4, 6, 9):
        np.testing.assert_array_equal(
            fit_descriptor_dim(torch.from_numpy(x), dim).numpy(), np.asarray(jax_fit(jnp.asarray(x), dim)))


def test_mixvpr_descriptors_match_with_shipped_weights():
    """Held in float32 with vpr_mixvpr.npz loaded on both sides."""
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 255, (2, 270, 360), dtype=np.uint8)
    jv = load_mixvpr_vpr(backbone_cfg=JaxResNetConfig(crop_stage=3, dtype=jnp.float32))
    want = np.asarray(jv.encode_batch_device(jnp.asarray(imgs)))
    tv = MixVPR(backbone_cfg=ResNetConfig(crop_stage=3, dtype=torch.float32), device="cpu")
    got = tv.encode_batch(imgs)
    assert got.shape == want.shape == (2, 4096)
    # float32 through a ResNet-50: accumulation order differs (oneDNN vs XLA)
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose((got * want).sum(1), 1.0, atol=1e-5)


def test_semantic_place_recognition_builds_mixvpr_and_database():
    spr = SemanticPlaceRecognition("mixvpr", similarity_threshold=0.3, device="cpu",
                                   backbone_cfg=ResNetConfig.tiny_test(dtype=torch.float32),
                                   input_size=(64, 64), checkpoint=None)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 255, (3, 48, 64), dtype=np.uint8)
    added = spr.add_images_batch(imgs, [0.0, 1.0, 2.0], [1, 1, 2])
    assert len(added) == 3 and spr.vpr.build_descriptor_matrix().shape == (3, 4096)
    np.testing.assert_array_equal(spr.vpr.timestamps(), [0.0, 1.0, 2.0])
    with pytest.raises(ValueError, match="Unknown VPR method"):
        SemanticPlaceRecognition("netvlad", device="cpu")
    salad = SemanticPlaceRecognition("SALAD", device="cpu", input_size=(56, 56),
                                     vit_cfg=ViTConfig.tiny_test(dtype=torch.float32))
    assert type(salad.vpr).__name__ == "SALAD" and salad.vpr.descriptor_dim == 8448
