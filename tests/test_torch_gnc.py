"""The port's Graduated Non-Convexity solver (optimize_pose_graph_gnc)
held against mlis_tpu's on the CPU, on test_torch_pose_graph.py's circle
with a true and a false loop closure.

Tolerances: a short anneal (3 rounds) in float32 within 2e-3 m of pose and
2e-3 of relative cost, the weights within 1e-3 and their < 0.5 decisions
equal; the TLS unit trap of tests/test_pose_graph.py:213-250 over the full
30-round anneal (one Gauss-Newton step of 8 CG iterations a round): the
decisions equal and the trap's own outcome (false closure off, true kept,
padding weights exactly 1). Over 30 rounds the float32 poses of the two
packages part by up to ~0.1 m on this graph (each round re-weights on
poses that CG at a condition number of 1e10 and more leaves
rounding-dependent), so the full anneal's poses are held in float64, where
they agree within 1e-5 m."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_pose_graph import _as64, _circle_graph, _factors, jpg, pg  # noqa: E402

POSE_ATOL = 2e-3
COST_RTOL = 2e-3
F64_ATOL = 1e-5


@pytest.fixture(scope="module")
def graph():
    return _circle_graph()


def _solve_both(graph, dtype=np.float32, **kw):
    fj, ft = _factors(graph)
    R0, t0 = graph["R0"].astype(dtype), graph["t0"].astype(dtype)
    if dtype == np.float64:
        fj, ft = _as64(fj, ft)
    want = [np.asarray(x) for x in jpg.optimize_pose_graph_gnc(
        jnp.asarray(R0), jnp.asarray(t0), fj, **kw)]
    got = [x.numpy() for x in pg.optimize_pose_graph_gnc(R0, t0, ft, **kw)]
    return got, want


@pytest.mark.parametrize("cost_type,barcsq,inner", [("gm", 16.81, 2), ("tls", 500.0, 1)])
def test_gnc_short_anneal_matches(graph, cost_type, barcsq, inner):
    kw = dict(cost_type=cost_type, barcsq=barcsq, outer_iters=3, inner_iters=inner, cg_iters=8)
    (Rt, tt, ct, wt), (Rj, tj, cj, wj) = _solve_both(graph, **kw)
    assert ct.shape == cj.shape == (4,) and wt.shape == wj.shape
    np.testing.assert_allclose(tt, tj, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(ct, cj, rtol=COST_RTOL)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(wt < 0.5, wj < 0.5)
    with jax.enable_x64(True):
        (_, t64, c64, w64), (_, tj64, cj64, wj64) = _solve_both(graph, np.float64, **kw)
    np.testing.assert_allclose(t64, tj64, rtol=0, atol=1e-9)
    np.testing.assert_allclose(w64, wj64, rtol=0, atol=1e-9)
    with pytest.raises(ValueError):
        pg.optimize_pose_graph_gnc(graph["R0"], graph["t0"], _factors(graph)[1], cost_type="huber")


def test_gnc_tls_unit_trap(graph):
    """Truncated least squares over the full anneal: the false closure's
    weight goes to 0, the true closure's stays 1 (TLS is binary), the
    odometry and padding weights stay exactly 1."""
    kw = dict(cost_type="tls", barcsq=500.0, outer_iters=30, inner_iters=1, cg_iters=8)
    (_, tt, ct, wt), (_, tj, cj, wj) = _solve_both(graph, **kw)
    n = len(graph["edges"])
    np.testing.assert_array_equal(wt < 0.5, wj < 0.5)
    assert wt[n - 1] < 0.01 and wt[n - 2] > 0.99  # false off, true kept
    assert (wt[n:] == 1.0).all() and (wt[: n - 2] == 1.0).all()
    assert np.isfinite(tt).all() and np.isfinite(ct).all() and ct.shape == (31,)
    with jax.enable_x64(True):
        (_, t64, _, w64), (_, tj64, _, wj64) = _solve_both(graph, np.float64, **kw)
    np.testing.assert_allclose(t64, tj64, rtol=0, atol=F64_ATOL)
    np.testing.assert_array_equal(w64 < 0.5, wj64 < 0.5)
