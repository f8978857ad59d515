"""The port's pretraining drivers (mlis_tpu_torch/train/driver.py,
pretrain_matcher.py, pretrain_loftr.py, pretrain_superpoint.py) on the
CPU: ``run_chunked_training``'s save rules against the JAX package's loop
on one scripted trainer (the same saves in the same order, the same
history), each driver's ``main`` with ``--tiny --device cpu`` and its
outputs under ``tmp_path``, and every npz it writes read by the JAX
package's loaders (its parameters equal at float16 rounding, the
checkpoints' format) and the JAX package's own npz read back by the port.
The VPR driver is in test_torch_pretrain_vpr.py.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import lightglue as jlg  # noqa: E402
from mlis_tpu.models import loftr as jl  # noqa: E402
from mlis_tpu.models.convert import _match_dtypes  # noqa: E402
from mlis_tpu.models.superpoint import SuperPoint as JSP  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JSPC  # noqa: E402
from mlis_tpu.models.weights import load_params_npz  # noqa: E402
from mlis_tpu.train import driver as jdriver  # noqa: E402

from mlis_tpu_torch.models import lightglue as tlg  # noqa: E402
from mlis_tpu_torch.models import loftr as tl  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig as TSPC  # noqa: E402
from mlis_tpu_torch.train import driver as tdriver  # noqa: E402
from mlis_tpu_torch.train import pretrain_loftr, pretrain_matcher, pretrain_superpoint  # noqa: E402
from mlis_tpu_torch.weights import from_jax_params, load_npz  # noqa: E402

TINY_HW = (64, 96)


class ScriptedTrainer:
    """train_chunk / match_metrics / save_checkpoint with scripted recalls."""

    def __init__(self, recalls, log):
        self.recalls, self.log, self.evals = list(recalls), log, 0

    def train_chunk(self, n, batch_size):
        self.log.append(("chunk", n, batch_size))
        return np.linspace(1.0, 0.5, n).astype(np.float32)

    def match_metrics(self, images):
        r = self.recalls[self.evals]
        self.evals += 1
        return {"recall": r, "precision": 1.0 - r, "n_gt": 10, "n_pred": 5}

    def save_checkpoint(self, path):
        self.log.append(("save", Path(path).name))


@pytest.mark.parametrize("recalls", [(0.5, 0.1, 0.3, 0.2, 0.4), (0.0, 0.0, 0.0, 0.0, 0.0),
                                     (0.9, 0.2, 0.2, 0.6, 0.6)])
def test_chunked_training_save_rules_match_jax(tmp_path, recalls):
    """Steps 23 in chunks of 5, evals every 10 (and at the end), .latest
    every 7: the first eval after training always saves, later ones only on
    a better recall; the reported best is the saved weights' recall, never
    step 0's."""
    runs = []
    for name, fn in (("jax", jdriver.run_chunked_training),
                     ("port", tdriver.run_chunked_training)):
        log = []
        out = tmp_path / name / "m.npz"
        out.parent.mkdir()
        hist = fn(ScriptedTrainer(recalls, log), None, out, out.with_name("m_log.json"),
                  {"config": {}}, steps=23, chunk=5, batch=2, eval_every=10, save_every=7)
        on_disk = json.loads(out.with_name("m_log.json").read_text())
        hist.pop("wall_s"), on_disk.pop("wall_s")
        runs.append((log, json.loads(json.dumps(hist)), on_disk))
    (jlog, jhist, jdisk), (tlog, thist, tdisk) = runs
    assert tlog == jlog and thist == jhist and tdisk == jdisk
    saves = [s for s in tlog if s[0] == "save"]
    assert saves[0] == ("save", "m.npz") and ("save", "m.latest.npz") in saves
    assert thist["best_recall"] == max(recalls[1:4])  # evals at 10, 20 and 23


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _assert_same_state(port_state, jax_tree, scan_prefixes=("blocks",)):
    want = from_jax_params(_np(jax_tree), scan_prefixes)
    assert set(want) == set(port_state)
    for k, v in want.items():
        got = port_state[k].detach().cpu().float().numpy()
        np.testing.assert_array_equal(got.astype(np.float16), v.numpy().astype(np.float16), k)


@pytest.mark.parametrize("arch,mode", [("lightglue", "homography"), ("superglue", "parallax")])
def test_pretrain_matcher_tiny_and_its_npz_across_packages(tmp_path, arch, mode):
    out = tmp_path / "m.npz"
    argv = ["--tiny", "--device", "cpu", "--out", str(out), "--arch", arch, "--steps", "4",
            "--chunk", "2", "--eval-every", "2", "--save-every", "3"]
    hist = pretrain_matcher.main(argv + (["--parallax"] if mode == "parallax" else []))
    assert out.exists() and out.with_suffix(".latest.npz").exists()
    log = json.loads((tmp_path / "m_log.json").read_text())
    assert log["config"]["parallax"] == (mode == "parallax") and len(log["loss"]) == 2
    assert np.isfinite([loss for _, loss in log["loss"]]).all()
    assert [e[0] for e in hist["eval"]] == [0, 2, 4]

    # the JAX package's loader reads it
    assignment = "sinkhorn" if arch == "superglue" else "dual_softmax"
    cls = jlg.SuperGlue if arch == "superglue" else jlg.LightGlue
    ref = cls(sp_cfg=JSPC.tiny_test(max_keypoints=48),
              matcher_cfg=jlg.MatcherConfig.tiny_test(assignment=assignment))
    ref.load_weights(str(out), image_hw=TINY_HW)
    tcls = tlg.SuperGlue if arch == "superglue" else tlg.LightGlue
    port = tcls(sp_cfg=TSPC.tiny_test(max_keypoints=48),
                matcher_cfg=tlg.MatcherConfig.tiny_test(assignment=assignment), device="cpu")
    port.load_weights(str(out))
    _assert_same_state(port.net.state_dict(), ref.params)
    _assert_same_state(port.sp.net.state_dict(), ref.sp.params)
    # and the port reads the JAX package's save_weights
    back = tmp_path / "jax.npz"
    ref.save_weights(str(back))
    port2 = tcls(sp_cfg=TSPC.tiny_test(max_keypoints=48),
                 matcher_cfg=tlg.MatcherConfig.tiny_test(assignment=assignment), device="cpu")
    port2.load_weights(str(back))
    for k, v in port.net.state_dict().items():
        assert torch.equal(port2.net.state_dict()[k], v), k


def test_pretrain_matcher_sp_init_and_init_from(tmp_path):
    sp_out = tmp_path / "sp.npz"
    pretrain_superpoint.main(["--tiny", "--device", "cpu", "--out", str(sp_out), "--steps", "2",
                              "--chunk", "1", "--eval-every", "2"])
    m_out = tmp_path / "m.npz"
    pretrain_matcher.main(["--tiny", "--device", "cpu", "--out", str(m_out), "--steps", "2",
                           "--chunk", "1", "--eval-every", "2", "--sp-init", str(sp_out)])
    sp = load_npz(str(sp_out))["superpoint"]
    shipped = load_npz(str(m_out))["superpoint"]
    for k, v in sp.items():  # the frozen front end is the trained one
        assert torch.equal(shipped[k], v), k
    m2 = tmp_path / "m2.npz"
    pretrain_matcher.main(["--tiny", "--device", "cpu", "--out", str(m2), "--steps", "2",
                           "--chunk", "1", "--eval-every", "2", "--init-from", str(m_out)])
    assert m2.exists()


@pytest.mark.parametrize("mode", ["homography", "parallax"])
def test_pretrain_loftr_tiny_and_its_npz_across_packages(tmp_path, mode):
    out = tmp_path / "lf.npz"
    argv = ["--tiny", "--device", "cpu", "--out", str(out), "--steps", "3", "--chunk", "2",
            "--eval-every", "2", "--save-every", "2"]
    hist = pretrain_loftr.main(argv + (["--parallax"] if mode == "parallax" else []))
    assert out.exists() and [e[0] for e in hist["eval"]] == [0, 2, 3]
    ref = jl.LoFTR(jl.LoFTRConfig.tiny_test())
    ref.load_weights(str(out), image_hw=TINY_HW)
    port = tl.LoFTR(tl.LoFTRConfig.tiny_test(), device="cpu")
    port.load_weights(str(out))
    _assert_same_state(port.net.state_dict(), ref.params, ())
    back = tmp_path / "jax.npz"
    ref.save_weights(str(back))
    port2 = tl.LoFTR(tl.LoFTRConfig.tiny_test(), device="cpu")
    port2.load_weights(str(back))
    for k, v in port.net.state_dict().items():
        assert torch.equal(port2.net.state_dict()[k], v), k


def test_pretrain_superpoint_tiny_and_its_npz_across_packages(tmp_path):
    out = tmp_path / "sp.npz"
    hist = pretrain_superpoint.main(["--tiny", "--device", "cpu", "--out", str(out), "--steps",
                                     "4", "--chunk", "2", "--eval-every", "2"])
    assert out.exists()
    assert [e[0] for e in hist["eval"]] == [0, 2, 4] and "repeatability" in hist["eval"][1][1]
    assert np.isfinite(np.asarray([x[1:] for x in hist["loss"]])).all()
    # the JAX package reads it as pretrain_matcher --sp-init does
    ref = JSP(JSPC.tiny_test(max_keypoints=64))
    tmpl = ref.init_params(TINY_HW)
    loaded = _match_dtypes({"params": load_params_npz(str(out))["superpoint"]}, tmpl)
    _assert_same_state(load_npz(str(out))["superpoint"], loaded, ())
    assert jnp.isfinite(ref.net.apply(loaded, jnp.zeros((1, *TINY_HW, 1)))[0]).all()
