"""The port's VPR pretraining driver, ``pretrain_vpr.main``, for every arch
with ``--tiny --device cpu`` and its outputs under ``tmp_path``, and the
npz it writes read by the JAX package's loaders:

* tiny (``--parallax``, warm-started from vpr_tiny_v2.npz), salad and
  anyloc at the driver's own tiny settings: ``mlis_tpu.train.pretrain_vpr.
  load_encoder`` loads each npz, and its descriptors agree with the port's
  ``load_encoder`` on the same images (both bf16: cosine >= 0.99; AnyLoc's
  hard VLAD assignment flips on bf16 rounding, so only its shape and
  finiteness are held);
* the npz's tree matches the JAX package's template leaf for leaf and
  shape for shape (its loader's ``_match_dtypes``).

mixvpr and cricavpr are in test_torch_pretrain_vpr_archs.py.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models.convert import _match_dtypes  # noqa: E402
from mlis_tpu.models.weights import load_params_npz  # noqa: E402
from mlis_tpu.train import pretrain_vpr as jpv  # noqa: E402

from mlis_tpu_torch.train import pretrain_vpr as tpv  # noqa: E402

def _images(n=4, hw=(96, 128)):
    rng = np.random.default_rng(0)
    base = np.kron(rng.integers(0, 255, (n, hw[0] // 8, hw[1] // 8)), np.ones((8, 8)))
    return base.astype(np.uint8)


def _run(tmp_path, arch, *extra):
    out = tmp_path / f"{arch}.npz"
    hist = tpv.main(["--tiny", "--device", "cpu", "--arch", arch, "--out", str(out), *extra])
    log = json.loads(out.with_name(f"{arch}_log.json").read_text())
    return out, hist, log


@pytest.mark.parametrize("arch,extra", [
    ("tiny", ("--parallax", "--init-from", "checkpoints/vpr_tiny_v2.npz")),
    ("salad", ()),
    ("anyloc", ("--clusters", "16")),
])
def test_main_and_the_jax_loader(tmp_path, arch, extra):
    out, hist, log = _run(tmp_path, arch, *extra)
    assert out.exists() and log["config"]["arch"] == arch
    if arch == "anyloc":
        assert 0.0 <= hist["best_recall_at_1"] <= 1.0 and log["backbone"].endswith("v2.npz")
    else:
        assert [e[0] for e in hist["eval"]] == [0, 30]
        assert np.isfinite([x for _, x in hist["loss"]]).all() and len(hist["loss"]) == 3
    if arch == "tiny":  # warm-started from the shipped encoder: it retrieves
        assert hist["eval"][0][1] > 0.3
    # the JAX loader's own check: every leaf of its template present with its
    # shape, and no leaf more
    tree = load_params_npz(str(out))["vpr"]
    tmpl = jpv._build_model(0, arch="tiny" if arch == "anyloc" else arch)[1]
    _match_dtypes(tree, tmpl)
    assert len(jax.tree_util.tree_leaves(tree)) == len(jax.tree_util.tree_leaves(tmpl))
    imgs = _images()
    want = np.asarray(jpv.load_encoder(str(out), arch=arch)(jnp.asarray(imgs)))
    got = tpv.load_encoder(str(out), arch=arch, device="cpu")(imgs).numpy()
    assert got.shape == want.shape and np.isfinite(want).all()
    if arch != "anyloc":  # VLAD's hard assignment flips on bf16 rounding
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
        assert cos.min() >= 0.99, cos
