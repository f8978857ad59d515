"""The port's torch-checkpoint converters (mlis_tpu_torch/models/convert.py)
and every encoder's ``load_torch_state_dict`` against mlis_tpu's.

No official checkpoint is in the repository, so the state dicts are drawn
from ``np.random.default_rng`` under the official parameter names, with
Kaiming-scaled weights (0.5x for LoFTR, as tests/test_convert.py draws
them) so that deep activations stay of order one. Each converter, fed the
same dict, gives the JAX package's tree exactly (keys, dtypes and values,
``np.array_equal``), the port's template coming from its own modules
through ``weights.to_jax_params``. The encoders, with the JAX class's other
parameters carried across and the same dict loaded on both sides, give its
descriptors within 1e-5 in float32 (the same float32 convolutions and GEMMs
summed in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import convert as jconv  # noqa: E402

from mlis_tpu_torch.models import convert as tconv  # noqa: E402
from mlis_tpu_torch.weights import carry_jax_vpr, flatten_params, to_jax_params  # noqa: E402

DESC_ATOL = 1e-5


def _w(rng, shape, scale=1.0):
    fan_in = int(np.prod(shape[1:]))
    return (rng.normal(size=shape) * (2.0 / fan_in) ** 0.5 * scale).astype(np.float32)


def _bn(rng, sd, prefix, ch):
    sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, ch).astype(np.float32)
    sd[f"{prefix}.bias"] = (0.1 * rng.normal(size=ch)).astype(np.float32)
    sd[f"{prefix}.running_mean"] = (0.1 * rng.normal(size=ch)).astype(np.float32)
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, ch).astype(np.float32)


def fake_resnet_sd(rng, stage_sizes, width, crop_stage):
    """torchvision ResNet (bottleneck) layout."""
    sd = {"conv1.weight": _w(rng, (width, 3, 7, 7))}
    _bn(rng, sd, "bn1", width)
    in_ch = width
    for stage, n_blocks in enumerate(stage_sizes[:crop_stage]):
        feats = width * 2**stage
        for b in range(n_blocks):
            tp = f"layer{stage + 1}.{b}"
            sd[f"{tp}.conv1.weight"] = _w(rng, (feats, in_ch, 1, 1))
            sd[f"{tp}.conv2.weight"] = _w(rng, (feats, feats, 3, 3))
            sd[f"{tp}.conv3.weight"] = _w(rng, (feats * 4, feats, 1, 1))
            for i, ch in ((1, feats), (2, feats), (3, feats * 4)):
                _bn(rng, sd, f"{tp}.bn{i}", ch)
            if b == 0:
                sd[f"{tp}.downsample.0.weight"] = _w(rng, (feats * 4, in_ch, 1, 1))
                _bn(rng, sd, f"{tp}.downsample.1", feats * 4)
            in_ch = feats * 4
    return sd


def fake_dinov2_sd(rng, dim, depth, patch, pos_grid, mlp_ratio=4.0):
    """facebookresearch/dinov2 layout (the keys convert_dinov2_torch reads)."""
    hidden = int(dim * mlp_ratio)
    sd = {
        "patch_embed.proj.weight": _w(rng, (dim, 3, patch, patch)),
        "patch_embed.proj.bias": (0.1 * rng.normal(size=dim)).astype(np.float32),
        "cls_token": (0.02 * rng.normal(size=(1, 1, dim))).astype(np.float32),
        "pos_embed": (0.02 * rng.normal(size=(1, pos_grid**2 + 1, dim))).astype(np.float32),
        "norm.weight": rng.uniform(0.5, 1.5, dim).astype(np.float32),
        "norm.bias": (0.1 * rng.normal(size=dim)).astype(np.float32),
    }
    for i in range(depth):
        tp = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{tp}.{n}.weight"] = rng.uniform(0.5, 1.5, dim).astype(np.float32)
            sd[f"{tp}.{n}.bias"] = (0.1 * rng.normal(size=dim)).astype(np.float32)
        for name, shape in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)),
                            ("mlp.fc1", (hidden, dim)), ("mlp.fc2", (dim, hidden))):
            sd[f"{tp}.{name}.weight"] = _w(rng, shape)
            sd[f"{tp}.{name}.bias"] = (0.1 * rng.normal(size=shape[0])).astype(np.float32)
        sd[f"{tp}.ls1.gamma"] = rng.uniform(0.1, 0.5, dim).astype(np.float32)
        sd[f"{tp}.ls2.gamma"] = rng.uniform(0.1, 0.5, dim).astype(np.float32)
    return sd


def fake_superpoint_sd(rng, chans=(64, 64, 128, 128), desc_dim=256):
    """magicleap SuperPointNet layout."""
    sd, in_ch = {}, 1
    for i, c in enumerate(chans, 1):
        for j, suffix in enumerate("ab"):
            sd[f"conv{i}{suffix}.weight"] = _w(rng, (c, in_ch if j == 0 else c, 3, 3))
            sd[f"conv{i}{suffix}.bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        in_ch = c
    for name, shape in (("convPa", (256, in_ch, 3, 3)), ("convPb", (65, 256, 1, 1)),
                        ("convDa", (256, in_ch, 3, 3)), ("convDb", (desc_dim, 256, 1, 1))):
        sd[f"{name}.weight"] = _w(rng, shape)
        sd[f"{name}.bias"] = (0.1 * rng.normal(size=shape[0])).astype(np.float32)
    return sd


def fake_lightglue_sd(rng, descriptor_dim, d, num_heads, depth):
    """cvg/LightGlue (superpoint variant) layout."""
    def lin(name, o, i):
        sd[f"{name}.weight"] = _w(rng, (o, i))
        sd[f"{name}.bias"] = (0.1 * rng.normal(size=o)).astype(np.float32)

    sd = {"posenc.Wr.weight": rng.normal(size=(d // num_heads // 2, 2)).astype(np.float32)}
    lin("input_proj", d, descriptor_dim)
    for i in range(depth):
        tp = f"transformers.{i}"
        lin(f"{tp}.self_attn.Wqkv", 3 * d, d)
        lin(f"{tp}.self_attn.out_proj", d, d)
        for blk in ("self_attn", "cross_attn"):
            lin(f"{tp}.{blk}.ffn.0", 2 * d, 2 * d)
            sd[f"{tp}.{blk}.ffn.1.weight"] = rng.uniform(0.5, 1.5, 2 * d).astype(np.float32)
            sd[f"{tp}.{blk}.ffn.1.bias"] = (0.1 * rng.normal(size=2 * d)).astype(np.float32)
            lin(f"{tp}.{blk}.ffn.3", d, 2 * d)
        lin(f"{tp}.cross_attn.to_qk", d, d)
        lin(f"{tp}.cross_attn.to_v", d, d)
        lin(f"{tp}.cross_attn.to_out", d, d)
        lin(f"log_assignment.{i}.final_proj", d, d)
        lin(f"log_assignment.{i}.matchability", 1, d)
    return sd


def fake_loftr_sd(rng, cfg_kw, scale=0.5):
    """The official LoFTR layout, drawn over tests/loftr_torch_ref.LoFTRTorch's
    own state dict (BN / LayerNorm scales in [0.5, 1.5])."""
    from loftr_torch_ref import LoFTRTorch

    sd = {}
    for k, v in LoFTRTorch(**cfg_kw).state_dict().items():
        shape = tuple(v.shape)
        if "num_batches" in k:
            sd[k] = np.zeros(shape, np.int64)
        elif "running_var" in k or (v.ndim == 1 and k.endswith("weight")):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif v.ndim == 1:
            sd[k] = (0.1 * rng.normal(size=shape)).astype(np.float32)
        else:
            sd[k] = _w(rng, shape, scale)
    return sd


LOFTR_TINY = dict(initial_dim=16, block_dims=(16, 24, 32), d_coarse=32, d_fine=16, nhead=2,
                  depth=1)


def _shape_template(net, *inputs):
    """The flax tree ``net.init`` would give, as zeros of its shapes and
    dtypes (the converters read nothing else of a template); traced with
    ``jax.eval_shape``, so nothing is compiled."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), *inputs)["params"]
    return jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes)


def _templates(name):
    """(JAX template, port template, official state dict) per converter."""
    rng = np.random.default_rng(0)
    if name == "resnet":
        from mlis_tpu.models.resnet import ResNet as JResNet, ResNetConfig as JRC
        from mlis_tpu_torch.models.resnet import ResNet, ResNetConfig

        return (_shape_template(JResNet(JRC.tiny_test()), jnp.zeros((1, 64, 64, 3))),
                to_jax_params(ResNet(ResNetConfig.tiny_test()).state_dict()),
                fake_resnet_sd(rng, (1, 1), 8, 2))
    if name == "dinov2":
        from mlis_tpu.models.vit import ViT as JViT, ViTConfig as JVC
        from mlis_tpu_torch.models.vit import ViT, ViTConfig

        return (_shape_template(JViT(JVC.tiny_test()), jnp.zeros((1, 56, 56, 3))),
                to_jax_params(ViT(ViTConfig.tiny_test()).state_dict()),
                fake_dinov2_sd(rng, 64, 2, 14, 8))
    if name == "superpoint":
        from mlis_tpu.models.superpoint import SuperPoint as JSP, SuperPointConfig as JSPC
        from mlis_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig

        return (_shape_template(JSP(JSPC()).net, jnp.zeros((1, 64, 64, 1))),
                to_jax_params(SuperPoint(SuperPointConfig(), device="cpu").net.state_dict()),
                fake_superpoint_sd(rng))
    if name == "lightglue":
        from mlis_tpu.models import lightglue as jlg
        from mlis_tpu_torch.models import lightglue as tlg
        from mlis_tpu_torch.models.superpoint import SuperPointConfig

        d, c, m = jnp.zeros((1, 16, 32)), jnp.zeros((1, 16, 2)), jnp.ones((1, 16), bool)
        net = jlg.MatcherNet(jlg.MatcherConfig.tiny_test())
        t = tlg.LightGlue(sp_cfg=SuperPointConfig.tiny_test(max_keypoints=16),
                          matcher_cfg=tlg.MatcherConfig.tiny_test(), device="cpu")
        return (_shape_template(net, d, c, m, d, c, m, (64, 64)),
                to_jax_params(t.net.state_dict(), scan_prefixes=("blocks",)),
                fake_lightglue_sd(rng, 32, 32, 2, 2))
    from mlis_tpu.models.loftr import LoFTRConfig as JLC, OfficialLoFTRMatcher
    from mlis_tpu_torch.models.loftr import LoFTR, LoFTRConfig

    im = jnp.zeros((1, 64, 64, 1))
    return (_shape_template(OfficialLoFTRMatcher(JLC.official_tiny()), im, im),
            to_jax_params(LoFTR(LoFTRConfig.official_tiny(), device="cpu").net.state_dict()),
            fake_loftr_sd(rng, LOFTR_TINY))


CONVERTERS = {"resnet": "convert_resnet_torch", "dinov2": "convert_dinov2_torch",
              "superpoint": "convert_superpoint_torch", "lightglue": "convert_lightglue_torch",
              "loftr": "convert_loftr_torch"}


def _assert_trees_equal(got, want):
    g, w = flatten_params(got), flatten_params(jax.device_get(want))
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        v = np.asarray(v)
        assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
        assert np.array_equal(g[k], v), k


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_gives_the_jax_tree_bit_for_bit(name):
    """The port's converter on the port's template gives exactly the JAX
    converter's tree on the JAX template; torch tensors give the same as
    numpy arrays."""
    jtemplate, ttemplate, sd = _templates(name)
    want = getattr(jconv, CONVERTERS[name])(sd, jtemplate)
    got = getattr(tconv, CONVERTERS[name])(sd, ttemplate)
    _assert_trees_equal(got, want)
    got_t = getattr(tconv, CONVERTERS[name])({k: torch.from_numpy(v) for k, v in sd.items()},
                                             ttemplate)
    _assert_trees_equal(got_t, want)


def test_loftr_converter_takes_the_lightning_layout():
    """The raw lightning checkpoint: ``{"state_dict": {"matcher.<key>": ...}}``
    and a flat ``matcher.``-prefixed dict give the flat dict's tree."""
    jtemplate, ttemplate, sd = _templates("loftr")
    flat = tconv.convert_loftr_torch(sd, ttemplate)
    prefixed = {f"matcher.{k}": v for k, v in sd.items()}
    _assert_trees_equal(tconv.convert_loftr_torch({"state_dict": prefixed}, ttemplate), flat)
    _assert_trees_equal(tconv.convert_loftr_torch(prefixed, ttemplate), flat)
    _assert_trees_equal(tconv.convert_loftr_torch({"state_dict": prefixed}, ttemplate),
                        jconv.convert_loftr_torch({"state_dict": prefixed}, jtemplate))


def test_match_dtypes_rejects_shape_mismatch_and_missing_keys():
    jtemplate, ttemplate, sd = _templates("dinov2")
    bad = dict(sd, cls_token=np.zeros((1, 1, 128), np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        tconv.convert_dinov2_torch(bad, ttemplate)
    with pytest.raises(ValueError, match="shape mismatch"):
        tconv._match_dtypes({"a": np.zeros(3)}, {"a": np.zeros(4, np.float32)})
    with pytest.raises(KeyError, match="missing 'b'"):
        tconv._match_dtypes({"a": np.zeros(3)}, {"a": np.zeros(3), "b": np.zeros(1)})
    out = tconv._match_dtypes({"a": np.arange(3, dtype=np.float64)}, {"a": np.zeros(3, np.float16)})
    assert out["a"].dtype == np.float16


def _frames(seed, n=3, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 255, (n, hw[0] // 8, hw[1] // 8, 3), dtype=np.uint8)
    return np.kron(cells, np.ones((1, 8, 8, 1), np.uint8))


def _encoders(name):
    """(JAX encoder, port encoder with the JAX parameters carried, official
    state dict, input frames), float32 at tiny sizes."""
    rng = np.random.default_rng(1)
    if name == "mixvpr":
        from mlis_tpu.models.mixvpr import MixVPR as J
        from mlis_tpu.models.resnet import ResNetConfig as JRC
        from mlis_tpu_torch.models.mixvpr import MixVPR
        from mlis_tpu_torch.models.resnet import ResNetConfig

        j = J(descriptor_dim=64, backbone_cfg=JRC.tiny_test(dtype=jnp.float32), input_size=(64, 64))
        t = MixVPR(descriptor_dim=64, backbone_cfg=ResNetConfig.tiny_test(dtype=torch.float32),
                   input_size=(64, 64), checkpoint=None, device="cpu")
        return j, carry_jax_vpr(t, jax.device_get(j.params)), fake_resnet_sd(rng, (1, 1), 8, 2), \
            _frames(2)
    from mlis_tpu.models.vit import ViTConfig as JVC
    from mlis_tpu_torch.models.vit import ViTConfig

    jcfg, tcfg = JVC.tiny_test(dtype=jnp.float32), ViTConfig.tiny_test(dtype=torch.float32)
    sd = fake_dinov2_sd(rng, 64, 2, 14, 8)
    if name == "cricavpr":
        from mlis_tpu.models.cricavpr import CricaVPR as J
        from mlis_tpu_torch.models.cricavpr import CricaVPR

        j = J(descriptor_dim=64, vit_cfg=jcfg, input_size=(56, 56))
        t = CricaVPR(descriptor_dim=64, vit_cfg=tcfg, input_size=(56, 56), checkpoint=None,
                     device="cpu")
    elif name == "salad":
        from mlis_tpu.models.salad import SALAD as J
        from mlis_tpu_torch.models.salad import SALAD

        small = dict(num_clusters=4, cluster_dim=16, token_dim=32)
        j = J(vit_cfg=jcfg, input_size=(56, 70), **small)
        t = SALAD(vit_cfg=tcfg, input_size=(56, 70), device="cpu", **small)
    else:
        from mlis_tpu.models.anyloc import AnyLoc as J
        from mlis_tpu_torch.models.anyloc import AnyLoc

        j = J(vit_cfg=jcfg, input_size=(56, 56), num_clusters=4)
        t = AnyLoc(vit_cfg=tcfg, input_size=(56, 56), num_clusters=4, device="cpu")
        return j, carry_jax_vpr(t, jax.device_get(j.params), centers=np.asarray(j.centers)), sd, \
            _frames(2)
    return j, carry_jax_vpr(t, jax.device_get(j.params)), sd, _frames(2)


@pytest.mark.parametrize("name", ["mixvpr", "cricavpr", "salad", "anyloc"])
def test_encoder_load_torch_state_dict_matches_jax(name):
    """Each encoder's ``load_torch_state_dict`` on the same official dict:
    the descriptors equal the JAX class's within 1e-5 in float32, and the
    loaded backbone differs from the one before (the load took)."""
    j, t, sd, frames = _encoders(name)
    before = t.encode_batch(frames)
    j.load_torch_state_dict(sd)
    t.load_torch_state_dict(sd)
    want = np.asarray(j.encode_batch(frames))
    got = t.encode_batch(frames)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=DESC_ATOL, rtol=0)
    assert np.abs(got - before).max() > 100 * DESC_ATOL


def test_encoder_without_a_converter_raises():
    from mlis_tpu_torch.models.base import TorchEncoderVPR

    class Plain(TorchEncoderVPR):
        pass

    with pytest.raises(NotImplementedError, match="Plain has no converter"):
        Plain(descriptor_dim=8, device="cpu").load_torch_state_dict({})
