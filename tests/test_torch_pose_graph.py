"""The port's pose-graph solver (mlis_tpu_torch/opt/pose_graph.py) held
against mlis_tpu's on the CPU, on a 48-pose circle with drifted odometry,
a true loop closure and a false one.

Tolerances: build_factors exactly equal; the residual vector within 1e-5
at a seeded perturbation (but for float32 cancellation just above the
Taylor cutoff, see the test), within 1e-12 in float64. The solves run at few iterations: float32 CG on
these graphs (condition numbers of 1e10 and more: a 1e3-weighted anchor
beside 1e-6 damping) amplifies last-bit differences in the reductions, so
the float32 solves are held within 2e-3 m of pose and 2e-3 of relative
cost, their < 0.5 decisions equal; the same solves in float64 agree within
1e-8, which shows the two packages compute the same thing."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import mlis_tpu.opt.pose_graph as jpg  # noqa: E402
import mlis_tpu_torch.opt.pose_graph as pg  # noqa: E402
from mlis_tpu_torch.opt.lie import se3_compose, se3_exp, se3_inv  # noqa: E402

POSE_ATOL = 2e-3  # m, float32 solves
COST_RTOL = 2e-3
F64_ATOL = 1e-8


def _circle_graph(N=48, seed=0):
    """GT circle of radius 5, odometry with noise, the integrated init, a true
    loop closure (N-1 -> 0) and a false one (N/2 -> 0 claimed identity)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, N, endpoint=False)
    gt_t = np.stack([np.cos(th) * 5, np.sin(th) * 5, np.zeros(N)], 1)
    w = np.zeros((N, 6))
    w[:, 5] = th + np.pi / 2
    gt_R = se3_exp(torch.as_tensor(w))[0]
    gt_t_t = torch.as_tensor(gt_t)
    Rr, tr = se3_compose(*se3_inv(gt_R[:-1], gt_t_t[:-1]), gt_R[1:], gt_t_t[1:])
    noise = rng.normal(size=(N - 1, 6)) * [0.02, 0.02, 0.005, 0.002, 0.002, 0.01]
    eR, et = se3_compose(Rr, tr, *se3_exp(torch.as_tensor(noise)))
    R0, t0 = [gt_R[0]], [gt_t_t[0]]
    for k in range(N - 1):
        Rn, tn = se3_compose(R0[-1], t0[-1], eR[k], et[k])
        R0.append(Rn)
        t0.append(tn)
    lR, lt = se3_compose(*se3_inv(gt_R[N - 1], gt_t_t[N - 1]), gt_R[0], gt_t_t[0])
    edges = [(i, i + 1) for i in range(N - 1)] + [(N - 1, 0), (N // 2, 0)]
    eR = np.concatenate([eR.numpy(), lR.numpy()[None], np.eye(3)[None]])
    et = np.concatenate([et.numpy(), lt.numpy()[None], np.zeros((1, 3))])
    sw = np.zeros(len(edges), bool)
    sw[-2:] = True
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(N=N, edges=edges, eR=f32(eR), et=f32(et), switchable=sw, gt_t=gt_t,
                R0=f32(torch.stack(R0)), t0=f32(torch.stack(t0)))


@pytest.fixture(scope="module")
def graph():
    return _circle_graph()


def _factors(g, with_false=True, **kw):
    """Both packages' factors: odometry, the true loop closure, the false one
    (with_false), z priors and one dz factor; loop edges switchable."""
    n = len(g["edges"]) - (0 if with_false else 1)
    args = (g["N"], g["edges"][:n], g["eR"][:n], g["et"][:n])
    kw = dict(sigma_rho=0.05, sigma_omega=0.02, prior_z=np.linspace(0, 0.3, g["N"]),
              sigma_z=0.4, dz_edges=[(3, 20, 0.1)], switchable=g["switchable"][:n], **kw)
    return jpg.build_factors(*args, **kw), pg.build_factors(*args, device="cpu", **kw)


def _as64(fj, ft):
    fj = jpg.PoseGraphFactors(*[x.astype(jnp.float64) if x.dtype == jnp.float32 else x for x in fj])
    ft = pg.PoseGraphFactors(*[x.double() if x.is_floating_point() else x for x in ft])
    return fj, ft


def test_build_factors_equal(graph):
    for kw in ({}, {"pad_edges": 100}):
        fj, ft = _factors(graph, **kw)
        assert ft._fields == fj._fields
        for name, a, b in zip(fj._fields, fj, ft):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        assert ft.edge_i.shape[0] == (kw.get("pad_edges") or 64)
    moved = ft.to("cpu")
    assert isinstance(moved, pg.PoseGraphFactors) and moved.edge_R.dtype == torch.float32
    empty = pg.build_factors(4, [], np.zeros((0, 3, 3)), np.zeros((0, 3)), device="cpu")
    assert empty.edge_i.shape == (1,) and float(empty.edge_mask.sum()) == 0


@pytest.mark.parametrize("huber", [None, 2.0])
def test_residuals_match_at_a_perturbation(graph, huber):
    """Within 1e-5, but the translation components of the edges on the
    analytic branch (theta^2 >= _SMALL) carry four times the float32 bound
    of se3_log's rho there, eps |rho| / theta^2, times the edge's weight:
    1 - cos(theta) cancels in both packages (tests/test_torch_lie.py), most
    just above the cutoff. Float64 within 1e-12."""
    fj, ft = _factors(graph)
    rng = np.random.default_rng(3)
    N, E = graph["N"], ft.edge_i.shape[0]
    xi = (rng.normal(size=(N, 6)) * 0.05).astype(np.float32)
    ds = (rng.normal(size=E) * 0.1).astype(np.float32)
    s = rng.uniform(0.2, 1.0, E).astype(np.float32)
    R0, t0 = graph["R0"], graph["t0"]

    def both(fj, ft, cast):
        want = jpg._residuals(*(jnp.asarray(cast(x)) for x in (xi, ds, R0, t0, s)), fj,
                              (jnp.asarray(cast(R0[0])), jnp.asarray(cast(t0[0]))), huber, 10.0)
        R, t = torch.as_tensor(cast(R0)), torch.as_tensor(cast(t0))
        got = pg._residuals(*(torch.as_tensor(cast(x)) for x in (xi, ds)), R, t,
                            torch.as_tensor(cast(s)), ft, se3_inv(ft.edge_R, ft.edge_t),
                            se3_inv(R[0], t[0]), huber, 10.0)
        return got.numpy(), np.asarray(want)

    got, want = both(fj, ft, lambda x: x)
    Rp, tp = pg.se3_retract(torch.as_tensor(R0), torch.as_tensor(t0), torch.as_tensor(xi))
    logs = pg._between_log(Rp, tp, ft, se3_inv(ft.edge_R, ft.edge_t)).numpy()
    th2 = (logs[:, 3:].astype(np.float64) ** 2).sum(1)
    above = th2 >= 1e-4  # the analytic branch
    tol = np.full((E, 6), 1e-5 + 1e-5 * np.abs(want[: E * 6].reshape(E, 6)))
    eps = float(np.finfo(np.float32).eps)
    tol[above, :3] += (4 * eps * np.linalg.norm(logs[above, :3], axis=1) / th2[above])[:, None] \
        * ft.edge_w[above, :3].numpy()
    assert (np.abs(got[: E * 6] - want[: E * 6]) <= tol.ravel()).all()
    np.testing.assert_allclose(got[E * 6 :], want[E * 6 :], rtol=1e-5, atol=1e-5)
    r2 = pg._edge_r2(torch.as_tensor(R0), torch.as_tensor(t0), ft, se3_inv(ft.edge_R, ft.edge_t))
    np.testing.assert_allclose(r2.numpy(), np.asarray(jpg._edge_r2(jnp.asarray(R0), jnp.asarray(t0),
                                                                    fj)), rtol=1e-5, atol=1e-4)
    with jax.enable_x64(True):
        fj64, ft64 = _as64(fj, ft)
        got64, want64 = both(fj64, ft64, lambda x: np.asarray(x, np.float64))
    np.testing.assert_allclose(got64, want64, rtol=0, atol=1e-12)


SOLVES = {  # name: (solver keywords, whether the false closure is in the graph)
    "plain": (dict(num_iters=3, cg_iters=12), False),
    "huber": (dict(num_iters=3, cg_iters=12, huber_delta=2.0), True),
    # Switchable Constraints with the false closure: its third step leaves a
    # cost of 3e4 whose float32 value differs by percents between packages
    "sc": (dict(num_iters=2, cg_iters=8), True),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_optimize_pose_graph_matches(graph, name):
    kw, with_false = SOLVES[name]
    fj, ft = _factors(graph, with_false=with_false)
    R0, t0 = graph["R0"], graph["t0"]
    Rj, tj, cj, sj = (np.asarray(x) for x in jpg.optimize_pose_graph(
        jnp.asarray(R0), jnp.asarray(t0), fj, **kw))
    Rt, tt, ct, st = (x.numpy() for x in pg.optimize_pose_graph(R0, t0, ft, **kw))
    assert ct.shape == cj.shape == (kw["num_iters"] + 1,) and st.shape == sj.shape
    np.testing.assert_allclose(tt, tj, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(ct, cj, rtol=COST_RTOL)
    np.testing.assert_array_equal(st < 0.5, sj < 0.5)
    assert (st[len(graph["edges"]):] == 1.0).all()  # padding switches stay on
    assert np.abs(np.einsum("bij,bkj->bik", Rt, Rt) - np.eye(3)).max() < 1e-5

    with jax.enable_x64(True):
        fj64, ft64 = _as64(fj, ft)
        tj64 = np.asarray(jpg.optimize_pose_graph(jnp.asarray(R0, jnp.float64),
                                                  jnp.asarray(t0, jnp.float64), fj64, **kw)[1])
    tt64 = pg.optimize_pose_graph(R0.astype(np.float64), t0.astype(np.float64), ft64, **kw)[1]
    assert tt64.dtype == torch.float64
    np.testing.assert_allclose(tt64.numpy(), tj64, rtol=0, atol=F64_ATOL)


def test_solvers_differentiate_under_inference_mode_and_no_grad(graph):
    _, ft = _factors(graph)
    kw = dict(num_iters=2, cg_iters=6)
    want = pg.optimize_pose_graph(graph["R0"], graph["t0"], ft, **kw)
    with torch.inference_mode():
        R0, t0 = torch.as_tensor(graph["R0"]), torch.as_tensor(graph["t0"])
        f_inf = pg.PoseGraphFactors(*(x.clone() for x in ft))
        assert R0.is_inference() and f_inf.edge_R.is_inference()
        got_inf = pg.optimize_pose_graph(R0, t0, f_inf, **kw)
        gnc_inf = pg.optimize_pose_graph_gnc(R0, t0, f_inf, outer_iters=2, inner_iters=1,
                                             cg_iters=4)
    with torch.no_grad():
        got_ng = pg.optimize_pose_graph(graph["R0"], graph["t0"], ft, **kw)
    gnc = pg.optimize_pose_graph_gnc(graph["R0"], graph["t0"], ft, outer_iters=2, inner_iters=1,
                                     cg_iters=4)
    for got in (got_inf, got_ng):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(gnc_inf, gnc):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        pg.optimize_pose_graph(graph["R0"], graph["t0"], ft, cuda_graph=True)
