"""``pretrain_vpr.main`` of the port for its two full-size archs, mixvpr and
cricavpr, with ``--tiny --device cpu``. Their backbones (ResNet-50 at
320x320, ViT-B/14 at 322x322) take minutes a step on the CPU, so the
builders are patched to the same classes at test widths
(``ResNetConfig.tiny_test`` at 64x64, ``ViTConfig.tiny_test`` at 56x56):
the npz's tree matches the JAX package's modules of those configurations
leaf for leaf and shape for shape (its loader's ``_match_dtypes``), the
parameters move, and MixVPR's frozen batch-norm statistics train, as they
do in the JAX package, whose ResNet keeps them in its ``params``.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models.convert import _match_dtypes  # noqa: E402
from mlis_tpu.models.weights import load_params_npz  # noqa: E402

from mlis_tpu_torch.models.layers import flax_init_  # noqa: E402
from mlis_tpu_torch.models.mixvpr import MixVPRModule  # noqa: E402
from mlis_tpu_torch.models.resnet import ResNetConfig  # noqa: E402
from mlis_tpu_torch.models.vit import ViT, ViTConfig  # noqa: E402
from mlis_tpu_torch.train import pretrain_vpr as tpv  # noqa: E402
from mlis_tpu_torch.weights import load_npz  # noqa: E402

SMALL_HW = {"mixvpr": (64, 64), "cricavpr": (56, 56)}


def _run(tmp_path, arch, *extra):
    out = tmp_path / f"{arch}.npz"
    hist = tpv.main(["--tiny", "--device", "cpu", "--arch", arch, "--out", str(out), *extra])
    log = json.loads(out.with_name(f"{arch}_log.json").read_text())
    return out, hist, log


def _small_build(orig):
    def build(seed=0, arch="tiny", device="cpu"):
        gen = torch.Generator().manual_seed(seed)
        if arch == "mixvpr":
            cfg = ResNetConfig.tiny_test()
            n = (SMALL_HW["mixvpr"][0] // (4 * 2 ** (cfg.crop_stage - 1))) ** 2
            return flax_init_(MixVPRModule(cfg, n), gen).to(device).eval()
        if arch == "cricavpr":
            return ViT(ViTConfig.tiny_test(), use_kernel=False).init_random_(gen).to(device).eval()
        return orig(seed, arch, device)

    return build


def _jax_template(arch):
    if arch == "mixvpr":
        from mlis_tpu.models.mixvpr import MixVPRModule as JMix
        from mlis_tpu.models.resnet import ResNetConfig as JRC

        model = JMix(JRC.tiny_test())
    else:
        from mlis_tpu.models.vit import ViT as JViT
        from mlis_tpu.models.vit import ViTConfig as JViTConfig

        model = JViT(JViTConfig.tiny_test(), use_pallas=False)
    return model.init(jax.random.PRNGKey(0), jnp.zeros((1, *SMALL_HW[arch], 3)))


@pytest.mark.parametrize("arch", ["mixvpr", "cricavpr"])
def test_main_full_archs_at_test_widths(tmp_path, monkeypatch, arch):
    monkeypatch.setattr(tpv, "_build_model", _small_build(tpv._build_model))
    monkeypatch.setattr(tpv, "ARCH_HW", SMALL_HW)
    before = {k: v.clone() for k, v in tpv._build_model(0, arch).state_dict().items()}
    out, hist, log = _run(tmp_path, arch)
    assert log["config"]["arch"] == arch and np.isfinite([x for _, x in hist["loss"]]).all()
    tree = load_params_npz(str(out))["vpr"]
    tmpl = _jax_template(arch)
    _match_dtypes(tree, tmpl)  # every template leaf present with its shape
    assert len(jax.tree_util.tree_leaves(tree)) == len(jax.tree_util.tree_leaves(tmpl))
    after = load_npz(str(out))["vpr"]
    assert set(after) == set(before)
    if arch == "mixvpr":  # the batch-norm statistics trained
        bn = [k for k in after if k.endswith("running_var")]
        assert bn and any(not torch.allclose(after[k], before[k], atol=1e-3) for k in bn)
    assert any(not torch.allclose(after[k], before[k], atol=1e-3) for k in after)
