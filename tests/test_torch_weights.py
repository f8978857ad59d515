"""The port's checkpoint reader against mlis_tpu's: layouts, per-depth
splits and dtypes."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from mlis_tpu.models import weights as jw  # noqa: E402

from mlis_tpu_torch import weights as tw  # noqa: E402
from mlis_tpu_torch.models.lightglue import MatcherConfig, MatcherNet  # noqa: E402
from mlis_tpu_torch.models.mixvpr import MixVPR  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig, SuperPointNet  # noqa: E402

LG = "checkpoints/lightglue_homog_sp.npz"
VPR = "checkpoints/vpr_mixvpr.npz"


def test_npz_reader_matches_mlis_tpu():
    for path in (LG, VPR):
        ref = jw.flatten_params(jw.load_params_npz(path))
        got = tw.flatten_params(tw.load_params_npz(path))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], ref[k])
    assert tw.matcher_arch_from_npz(LG) == jw.matcher_arch_from_npz(LG)
    assert tw.default_matcher_checkpoint().endswith("lightglue_homog_sp.npz")
    assert jw.default_matcher_checkpoint() == tw.default_matcher_checkpoint()


def test_dense_conv_and_scan_layouts():
    raw = jw.load_params_npz(LG)
    sd = tw.load_npz(LG)
    m, sp = sd["matcher"], sd["superpoint"]
    # Dense (in, out) -> Linear (out, in)
    np.testing.assert_array_equal(m["in_proj.weight"].numpy(), raw["matcher"]["in_proj"]["kernel"].T)
    # nn.scan stack (9, 512, 512) -> nine per-layer Linear weights
    stack = raw["matcher"]["blocks"]["cross"]["ffn1"]["kernel"]
    assert stack.shape == (9, 512, 512)
    for layer in range(9):
        np.testing.assert_array_equal(
            m[f"blocks.{layer}.cross.ffn1.weight"].numpy(), stack[layer].T)
    assert f"blocks.{9}.cross.ffn1.weight" not in m
    np.testing.assert_array_equal(
        m["blocks.4.self.ffn_norm.weight"].numpy(), raw["matcher"]["blocks"]["self"]["ffn_norm"]["scale"][4])
    # Conv HWIO -> OIHW
    np.testing.assert_array_equal(
        sp["desc_conv.weight"].numpy(),
        raw["superpoint"]["desc_conv"]["kernel"].transpose(3, 2, 0, 1))
    assert all(v.dtype == torch.float32 for v in list(m.values()) + list(sp.values()))
    # every key lands on a module parameter
    net = MatcherNet(MatcherConfig(**tw.matcher_arch_from_npz(LG)))
    net.load_state_dict(m, strict=True)
    SuperPointNet(SuperPointConfig()).load_state_dict(sp, strict=True)


def test_mixvpr_state_dict_and_batchnorm_names():
    sd = tw.load_npz(VPR)["vpr"]
    raw = jw.load_params_npz(VPR)["vpr"]["params"]
    bn = raw["backbone"]["layer3_0"]["bn2"]
    for flax_name, torch_name in (("scale", "weight"), ("bias", "bias"),
                                  ("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_array_equal(
            sd[f"backbone.layer3_0.bn2.{torch_name}"].numpy(), bn[flax_name])
    vpr = MixVPR(checkpoint=VPR, device="cpu")
    assert vpr.module.aggregator.mix0.fc1.weight.shape == (400, 400)


def test_from_jax_params_unwraps_params_and_keeps_raw_leaves():
    tree = {"params": {"posenc": {"Wr": np.ones((2, 3), np.float16)},
                       "d": {"kernel": np.arange(6.0).reshape(2, 3), "bias": np.zeros(3)}}}
    sd = tw.from_jax_params(tree)
    assert sd["posenc.Wr"].shape == (2, 3) and sd["posenc.Wr"].dtype == torch.float32
    np.testing.assert_array_equal(sd["d.weight"].numpy(), np.arange(6.0).reshape(2, 3).T)
    with pytest.raises(ValueError, match="rank 3"):
        tw.from_jax_params({"x": {"kernel": np.zeros((2, 2, 2))}})
