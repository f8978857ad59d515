"""MatcherTrainer.parallax_match_metrics of the port against mlis_tpu's on the
shipped lightglue_parallax_sp.npz, float32 on both sides, at 4 layered
pairs of 270x360 and 512 keypoints drawn from the JAX package's key 991:
n_gt equal, recall and precision within 0.02 (a prediction near the 0.1
match threshold may flip; measured equal to 1e-7).
"""

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.models import lightglue as jlg  # noqa: E402
from mlis_tpu.models.superpoint import SuperPointConfig as JSPC  # noqa: E402
from mlis_tpu.train import matcher_trainer as jmt  # noqa: E402
from test_torch_matcher_trainer import jax_layered_draws  # noqa: E402

from mlis_tpu_torch.models import lightglue as tlg  # noqa: E402
from mlis_tpu_torch.models.superpoint import SuperPointConfig as TSPC  # noqa: E402
from mlis_tpu_torch.train import matcher_trainer as tmt  # noqa: E402


def test_parallax_match_metrics_on_the_shipped_matcher():
    ckpt = "checkpoints/lightglue_parallax_sp.npz"
    hw = (270, 360)
    ref = jlg.LightGlue(sp_cfg=JSPC(max_keypoints=512, dtype=jnp.float32),
                       matcher_cfg=jlg.MatcherConfig(dtype=jnp.float32))
    ref.load_weights(ckpt, image_hw=hw)
    port = tlg.LightGlue(sp_cfg=TSPC(max_keypoints=512, dtype=torch.float32),
                         matcher_cfg=tlg.MatcherConfig(dtype=torch.float32), device="cpu")
    port.load_weights(ckpt)
    key = jax.random.PRNGKey(991)
    want = jmt.MatcherTrainer(ref, hw, pair_mode="parallax").parallax_match_metrics(4, key)
    got = tmt.MatcherTrainer(port, hw, pair_mode="parallax").parallax_match_metrics(
        4, jax_layered_draws(jax.random.split(key, 4), *hw))
    assert got["n_gt"] == want["n_gt"] > 100
    assert abs(got["recall"] - want["recall"]) <= 0.02
    assert abs(got["precision"] - want["precision"]) <= 0.02
