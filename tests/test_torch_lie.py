"""The port's Lie-group maps (mlis_tpu_torch/opt/lie.py) held against
mlis_tpu's on the CPU: float32 values within 1e-6 on seeded axis-angles,
among them angles of 1e-9 to 1e-3 and angles within 0.1% of the Taylor
cutoff (theta^2 = _SMALL; the translation parts just above it at 5e-5, see
the test), float64 values within 1e-12; forward- and reverse-mode
Jacobians at the identity finite and within 1e-5 of jax.jacfwd; hat and vee
exact; the elementwise 3 x 3 products equal to matmul in float64."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mlis_tpu.opt.lie as jlie  # noqa: E402
import mlis_tpu_torch.opt.lie as lie  # noqa: E402

ATOL = 1e-6  # float32 maps; the two packages' sin/cos/atan2 differ in the last bit
JAC_ATOL = 1e-5


def _axis_angles(rng, n):
    """n seeded axis-angles: a third at 1e-9..1e-3 rad, a third within 0.1%
    of the Taylor cutoff, a third at 0..2 rad."""
    k = n // 3
    mags = np.concatenate([
        10 ** rng.uniform(-9, -3, k),
        np.sqrt(lie._SMALL) * (1 + rng.uniform(-1e-3, 1e-3, k)),
        rng.uniform(0, 2, n - 2 * k),
    ])
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return (axes * mags[:, None]).astype(np.float32)


def test_small_cutoff_and_constants_match():
    assert lie._SMALL == jlie._SMALL


def _maps(mod, xp, w, xi, R_in, t_in):
    """Every map of a lie module as numpy arrays: the exps on (w, xi), the
    logs, compositions and inverses on the given poses (R_in, t_in)."""
    R, t = xp(R_in), xp(t_in)
    a, b = slice(0, len(xi) // 2), slice(len(xi) // 2, len(xi))
    outs = {
        "so3_exp": mod.so3_exp(xp(w)), "se3_exp": mod.se3_exp(xp(xi)),
        "so3_log": mod.so3_log(R), "se3_log": mod.se3_log(R, t),
        "compose": mod.se3_compose(R[a], t[a], R[b], t[b]),
        "inv": mod.se3_inv(R, t), "retract": mod.se3_retract(R[a], t[a], xp(xi[b])),
    }
    return {k: np.concatenate([np.asarray(x).reshape(len(x), -1) for x in v], 1)
            if isinstance(v, tuple) else np.asarray(v).reshape(len(v), -1) for k, v in outs.items()}


def test_so3_and_se3_maps_match_mlis_tpu():
    """Float32 within 1e-6, except the translation parts in the band just
    above the Taylor cutoff (_SMALL <= theta^2 < 4 _SMALL). There
    1 - cos(theta) cancels in float32 in both packages' formulas: B carries
    a relative error of about eps/theta^2, which reaches se3_exp's t as
    eps |rho| / theta and se3_log's rho (through k = (1 - A/2B)/theta^2) as
    eps |t| / theta^2, and a last-bit difference between the two packages'
    sin/cos moves them by that much. The band is held at four times those
    bounds. In float64 every map agrees within 1e-12."""
    rng = np.random.default_rng(0)
    w = _axis_angles(rng, 384)
    xi = np.concatenate([rng.normal(size=(384, 3)).astype(np.float32), w], 1)
    R_in, t_in = (np.asarray(x) for x in jlie.se3_exp(jnp.asarray(xi)))
    got = _maps(lie, torch.as_tensor, w, xi, R_in, t_in)
    want = _maps(jlie, jnp.asarray, w, xi, R_in, t_in)
    eps = float(np.finfo(np.float32).eps)
    th2 = (w.astype(np.float64) ** 2).sum(1)
    band = (th2 >= lie._SMALL) & (th2 < 4 * lie._SMALL)
    assert band.sum() >= 32 and (~band).sum() >= 256
    rho = np.linalg.norm(xi[:, :3], axis=1)
    bound = {  # per-row tolerance of the translation columns
        "se3_exp": np.where(band, 4 * eps * rho / np.sqrt(th2), ATOL),
        "se3_log": np.where(band, 4 * eps * np.linalg.norm(t_in, axis=1) / th2, ATOL),
        "retract": np.where(band[192:], 4 * eps * rho[192:] / np.sqrt(th2[192:]), ATOL),
    }
    for k in got:
        diff = np.abs(got[k] - want[k])
        if k in bound:  # (rows, [R 9 |] translation 3 [| omega 3])
            cols = slice(0, 3) if k == "se3_log" else slice(9, 12)
            assert (diff[:, cols] <= bound[k][:, None]).all(), (k, diff[:, cols].max())
            diff[:, cols] = 0
        assert diff.max() <= ATOL, (k, diff.max())
    assert (bound["se3_log"][band] < 2e-2).all()  # the band's bound stays small

    w64, xi64 = w.astype(np.float64), xi.astype(np.float64)
    with jax.enable_x64(True):
        R64, t64 = (np.asarray(x) for x in jlie.se3_exp(jnp.asarray(xi64)))
        want64 = _maps(jlie, jnp.asarray, w64, xi64, R64, t64)
    got64 = _maps(lie, torch.as_tensor, w64, xi64, R64, t64)
    for k in got64:
        np.testing.assert_allclose(got64[k], want64[k], rtol=0, atol=1e-12, err_msg=k)


def test_hat_vee_and_products_are_exact():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(64, 3))
    w32 = w.astype(np.float32)
    np.testing.assert_array_equal(lie.hat(torch.as_tensor(w32)).numpy(),
                                  np.asarray(jlie.hat(jnp.asarray(w32))))
    W = lie.hat(torch.as_tensor(w)).numpy()
    want = np.zeros((64, 3, 3))
    want[:, 0, 1], want[:, 0, 2], want[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    want -= want.transpose(0, 2, 1)
    np.testing.assert_array_equal(W, want)
    np.testing.assert_array_equal(lie.vee(torch.as_tensor(W)).numpy(), w)
    a, b = rng.normal(size=(2, 64, 3, 3))
    np.testing.assert_allclose(lie.matmul3(torch.as_tensor(a), torch.as_tensor(b)).numpy(), a @ b,
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(lie.matvec3(torch.as_tensor(a), torch.as_tensor(w)).numpy(),
                               np.einsum("bij,bj->bi", a, w), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("mode", ["jacfwd", "jacrev"])
def test_jacobians_at_identity_finite_and_match(mode):
    """The double where: the unselected branch's derivative stays finite, so
    the tangent at the identity is not NaN; d log(exp(xi)) / dxi = I."""

    def t_fn(x):
        R, t = lie.se3_exp(x)
        return torch.cat([lie.se3_log(R, t), R.reshape(-1), t, lie.so3_log(lie.so3_exp(x[3:]))])

    def j_fn(x):
        R, t = jlie.se3_exp(x)
        return jnp.concatenate([jlie.se3_log(R, t), R.ravel(), t, jlie.so3_log(jlie.so3_exp(x[3:]))])

    got = getattr(torch.func, mode)(t_fn)(torch.zeros(6)).numpy()
    want = np.asarray(jax.jacfwd(j_fn)(jnp.zeros(6, jnp.float32)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=JAC_ATOL)
    np.testing.assert_allclose(got[:6], np.eye(6), rtol=0, atol=1e-4)


def test_clip_shares_the_derivative_at_a_bound_as_jax_does():
    for x in (0.0, 1.0, 0.5):
        g = torch.func.grad(lambda s: lie.clip(s, 0.0, 1.0))(torch.tensor(x))
        want = jax.grad(lambda s: jnp.clip(s, 0.0, 1.0))(x)
        assert float(g) == float(want), x
