"""The port's log-space Sinkhorn (ops/sinkhorn.py) against mlis_tpu's on
the same float32 inputs: log-plans within 1e-5."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mlis_tpu.ops import sinkhorn as jsk  # noqa: E402

from mlis_tpu_torch.ops import sinkhorn as tsk  # noqa: E402

# float32 logsumexp over the same rows, summed in another order
ATOL = 1e-5


@pytest.mark.parametrize("shape,iters", [((5, 7), 20), ((2, 30, 65), 3), ((2, 3, 16, 9), 1)])
def test_sinkhorn_log_uniform_marginals(shape, iters):
    rng = np.random.default_rng(len(shape) + iters)
    s = (3.0 * rng.normal(size=shape)).astype(np.float32)
    want = np.asarray(jsk.sinkhorn_log(jnp.asarray(s), num_iters=iters))
    got = tsk.sinkhorn_log(torch.from_numpy(s), num_iters=iters)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # after the last column update the columns meet their marginals
    np.testing.assert_allclose(np.exp(got.numpy()).sum(-2), 1.0 / shape[-1], rtol=1e-4)


def test_sinkhorn_log_given_marginals_and_bf16_scores():
    rng = np.random.default_rng(1)
    s = rng.normal(size=(3, 6, 4)).astype(np.float32)
    mu = np.log(rng.dirichlet(np.ones(6), size=3)).astype(np.float32)
    nu = np.log(rng.dirichlet(np.ones(4), size=3)).astype(np.float32)
    want = np.asarray(jsk.sinkhorn_log(jnp.asarray(s), 7, jnp.asarray(mu), jnp.asarray(nu)))
    got = tsk.sinkhorn_log(torch.from_numpy(s), 7, torch.from_numpy(mu), torch.from_numpy(nu))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # bf16 scores are widened to float32 first, as in the reference
    sb = torch.from_numpy(s).to(torch.bfloat16)
    want = np.asarray(jsk.sinkhorn_log(jnp.asarray(sb.float().numpy()).astype(jnp.bfloat16), 3))
    np.testing.assert_allclose(tsk.sinkhorn_log(sb, 3).numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("M,N,alpha", [(8, 5, 1.0), (3, 12, -0.5), (1, 1, 2.0)])
def test_sinkhorn_with_dustbin(M, N, alpha):
    rng = np.random.default_rng(M * N)
    s = rng.normal(size=(2, M, N)).astype(np.float32)
    want = np.asarray(jsk.sinkhorn_with_dustbin(jnp.asarray(s), jnp.float32(alpha), 20))
    got = tsk.sinkhorn_with_dustbin(torch.from_numpy(s), torch.tensor(alpha), 20)
    assert tuple(got.shape) == (2, M + 1, N + 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
