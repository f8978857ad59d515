"""Two MatcherTrainer steps of the port (mlis_tpu_torch/train/matcher_trainer.py)
against mlis_tpu's, on the CPU, in homography and in parallax mode: the
tiny float32 LightGlue of test_torch_matcher_trainer.py with the JAX
package's parameters, its images and the draws rebuilt from its trainer's
own key chain. Bands: the losses within 1e-5 relative, n_gt equal, the
parameters under test_torch_parallel's Adam rule (all within 1e-4 relative
over their concatenation; entry by entry within Adam's own bound of 2 lr a
step); the frozen SuperPoint unchanged.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mlis_tpu.train import matcher_trainer as jmt  # noqa: E402
from test_torch_matcher_trainer import (  # noqa: E402
    HW,
    LR,
    _np,
    hold_adam_rule,
    jax_corner_draws,
    jax_layered_draws,
    tiny_pair,
)

from mlis_tpu_torch.train import matcher_trainer as tmt  # noqa: E402
from mlis_tpu_torch.weights import from_jax_params  # noqa: E402


@pytest.mark.parametrize("pair_mode", ["homography", "parallax"])
def test_two_trainer_steps_match_jax(pair_mode):
    ref, port = tiny_pair()
    jt = jmt.MatcherTrainer(ref, HW, learning_rate=LR, seed=0, pair_mode=pair_mode)
    tt = tmt.MatcherTrainer(port, HW, learning_rate=LR, seed=0, pair_mode=pair_mode)
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(0)
    B = 3
    for _ in range(2):
        images = rng.uniform(0, 1, size=(B, *HW)).astype(np.float32)
        images = np.kron(images[:, ::8, ::8], np.ones((8, 8), np.float32))
        key, sub = jax.random.split(key)  # the JAX trainer's own key chain
        hkeys = jax.random.split(sub, B)
        draws = (jax_layered_draws(hkeys, *HW) if pair_mode == "parallax"
                 else jax_corner_draws(hkeys))
        want_loss, want_n = jt.train_batch(images)
        got_loss, got_n = tt.train_batch(images, draws)
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
        assert got_n == want_n > 0
    hold_adam_rule(port.net, ref.params["params"], 2)
    # the frozen front end has not moved
    for n, v in from_jax_params(_np(ref.sp.params["params"])).items():
        assert torch.equal(port.sp.net.state_dict()[n], v)
