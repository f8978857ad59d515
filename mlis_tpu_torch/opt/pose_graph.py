"""SE(3) pose-graph optimiser: Gauss-Newton with matrix-free conjugate
gradients, on torch tensors.

Counterpart of ``mlis_tpu/opt/pose_graph.py``. It consumes the semantic
gate's factor emitters: between factors for odometry and (gated) loop
closures, the per-pose z priors of ``ContextualPriorFactor.floor_priors``
and elevator dz factors.

- Factor sets are padded, masked, static-shape tensors
  (:class:`PoseGraphFactors`); padded edges have ``edge_mask = 0`` and
  index pose 0 (the solvers spread them over the poses), so their residual
  and its derivative are exactly 0.
- The normal equations (J^T J + lam I) p = -J^T r are solved matrix-free:
  J v through ``torch.func.jvp``, J^T u through the function that
  ``torch.func.vjp`` returns, made once per Gauss-Newton step, and a
  fixed number of CG iterations. No Jacobian is formed.
- The retraction is the right perturbation T <- T @ Exp(xi)
  (``opt/lie.py``); after each step the rotations are re-orthonormalised
  as U V^T of their SVD. A strong 6-dof anchor on pose 0 fixes the gauge.
- Nothing in a loop reads a value back to the host: the cost trace, the
  switches and the GNC weights stay tensors until the caller reads them.

The JAX package compiles a whole solve into one program. Eager PyTorch
dispatches every operation, several hundred kernels per CG step, so on the
card each Gauss-Newton step runs its first CG iteration eagerly, captures
the iteration once in a CUDA graph and replays it for the rest
(``cuda_graph``): the same kernels in the same order on the same buffers.
The graph is captured again at every step, because the vjp closure's
saved tensors are new at every step; the SVD stays outside it.

The solvers run with autograd on even when the caller holds
``torch.inference_mode()`` or ``torch.no_grad()``: they copy inference
tensors out of inference mode first.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mlis_tpu_torch.opt.lie import clip, matmul3, se3_compose, se3_inv, se3_log, se3_retract


class PoseGraphFactors(NamedTuple):
    """Padded, masked factor tensors.

    Between factors measure Z = T_i^-1 T_j; residual = Log(Z^-1 T_i^-1 T_j)
    weighted per component by ``edge_w`` ([rho x3, omega x3]
    sqrt-information). Z priors pull pose z toward the floor-height
    expectation; dz factors constrain elevator transitions
    (z_j - z_i = expected dz). Index tensors are int64.
    """

    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    edge_R: torch.Tensor  # (E, 3, 3) measured relative rotation
    edge_t: torch.Tensor  # (E, 3) measured relative translation
    edge_w: torch.Tensor  # (E, 6) sqrt-information per tangent component
    edge_mask: torch.Tensor  # (E,) 1.0 = live factor, 0.0 = padding
    edge_switch: torch.Tensor  # (E,) 1.0 = switchable loop edge (SC / GNC)
    prior_z: torch.Tensor  # (N,) expected z per pose
    prior_w: torch.Tensor  # (N,) 1/sigma_z
    prior_mask: torch.Tensor  # (N,)
    dz_i: torch.Tensor  # (D,) int64
    dz_j: torch.Tensor  # (D,) int64
    dz: torch.Tensor  # (D,) expected z_j - z_i
    dz_w: torch.Tensor  # (D,) 1/sigma_dz
    dz_mask: torch.Tensor  # (D,)

    def to(self, device) -> "PoseGraphFactors":
        return PoseGraphFactors(*(x.to(device) for x in self))


def build_factors(
    n_poses: int,
    edges: Sequence[Tuple[int, int]],
    edge_R: np.ndarray,
    edge_t: np.ndarray,
    sigma_rho: float = 0.05,
    sigma_omega: float = 0.01,
    edge_sigmas: Optional[np.ndarray] = None,  # (E, 2) per-edge overrides
    prior_z: Optional[np.ndarray] = None,
    sigma_z: float = 0.5,
    dz_edges: Sequence[Tuple[int, int, float]] = (),
    sigma_dz: float = 0.3,
    pad_edges: Optional[int] = None,
    switchable: Optional[np.ndarray] = None,  # (E,) bool: loop edges that get a
    # Switchable-Constraints variable (Suenderhauf & Protzel 2012)
    device="cuda",
) -> PoseGraphFactors:
    """Assemble :class:`PoseGraphFactors` on ``device`` from host lists.

    ``prior_z`` is typically ``ContextualPriorFactor.floor_priors()[0]``;
    ``dz_edges`` are (i, j, expected_dz) from elevator transition factors.
    ``pad_edges`` sets the between-factor count; by default it is rounded
    up to a power of two, as in the JAX package.
    """
    e = len(edges)
    pad = pad_edges or max(1, 1 << (e - 1).bit_length() if e else 1)
    assert pad >= e, (pad, e)
    ei = np.zeros(pad, np.int64)
    ej = np.zeros(pad, np.int64)
    eR = np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))
    et = np.zeros((pad, 3), np.float32)
    ew = np.zeros((pad, 6), np.float32)
    em = np.zeros(pad, np.float32)
    esw = np.zeros(pad, np.float32)
    if e:
        ei[:e] = [i for i, _ in edges]
        ej[:e] = [j for _, j in edges]
        eR[:e] = np.asarray(edge_R, np.float32)
        et[:e] = np.asarray(edge_t, np.float32)
        if edge_sigmas is None:
            edge_sigmas = np.tile(np.asarray([[sigma_rho, sigma_omega]], np.float32), (e, 1))
        ew[:e, :3] = 1.0 / edge_sigmas[:, :1]
        ew[:e, 3:] = 1.0 / edge_sigmas[:, 1:2]
        em[:e] = 1.0
        if switchable is not None:
            esw[:e] = np.asarray(switchable, np.float32)

    rest = {
        "prior_z": np.zeros(n_poses, np.float32),
        "prior_w": np.zeros(n_poses, np.float32),
        "prior_mask": np.zeros(n_poses, np.float32),
        "dz_i": np.zeros(1, np.int64),
        "dz_j": np.zeros(1, np.int64),
        "dz": np.zeros(1, np.float32),
        "dz_w": np.zeros(1, np.float32),
        "dz_mask": np.zeros(1, np.float32),
    }
    if prior_z is not None:
        rest["prior_z"] = np.asarray(prior_z, np.float32)
        rest["prior_w"] = np.full(n_poses, 1.0 / sigma_z, np.float32)
        rest["prior_mask"] = np.ones(n_poses, np.float32)
    if dz_edges:
        d = len(dz_edges)
        rest["dz_i"] = np.asarray([i for i, _, _ in dz_edges], np.int64)
        rest["dz_j"] = np.asarray([j for _, j, _ in dz_edges], np.int64)
        rest["dz"] = np.asarray([v for _, _, v in dz_edges], np.float32)
        rest["dz_w"] = np.full(d, 1.0 / sigma_dz, np.float32)
        rest["dz_mask"] = np.ones(d, np.float32)
    dev = torch.device(device)
    return PoseGraphFactors(
        edge_i=torch.as_tensor(ei, device=dev),
        edge_j=torch.as_tensor(ej, device=dev),
        edge_R=torch.as_tensor(eR, device=dev),
        edge_t=torch.as_tensor(et, device=dev),
        edge_w=torch.as_tensor(ew, device=dev),
        edge_mask=torch.as_tensor(em, device=dev),
        edge_switch=torch.as_tensor(esw, device=dev),
        **{k: torch.as_tensor(v, device=dev) for k, v in rest.items()},
    )


def _between_log(R, t, f: PoseGraphFactors, zinv, extra=None) -> torch.Tensor:
    """(E, 6) unweighted between-factor logs Log(Z^-1 T_i^-1 T_j) at (R, t),
    ``zinv`` = (Z^-1 rotations, translations). ``extra`` = (R (3, 3), t (3,))
    appends one more error pose, logged in the same batch (one sweep of
    kernels instead of two)."""
    Ri_inv, ti_inv = se3_inv(R[f.edge_i], t[f.edge_i])
    Rrel, trel = se3_compose(Ri_inv, ti_inv, R[f.edge_j], t[f.edge_j])
    Rerr, terr = se3_compose(zinv[0], zinv[1], Rrel, trel)
    if extra is not None:
        Rerr, terr = torch.cat([Rerr, extra[0][None]]), torch.cat([terr, extra[1][None]])
    return se3_log(Rerr, terr)


def _residuals(xi, ds, R, t, s, f: PoseGraphFactors, zinv, anchor_inv, huber_delta,
               switch_prior_w):
    """Flat weighted residual vector at tangent perturbation xi (N, 6) and
    switch perturbation ds (E,) around switch state s (E,); ``zinv`` are the
    measurements' inverses and ``anchor_inv`` pose 0's initial inverse.

    Switchable Constraints (Suenderhauf & Protzel, IROS 2012): each loop
    edge with ``edge_switch = 1`` gets a scalar s that scales its residual,
    plus a prior (1 - s) pulling it on; the optimiser turns outlier
    closures off by driving their s to 0. Rigid edges keep scale 1."""
    E = f.edge_i.shape[0]
    Rp, tp = se3_retract(R, t, xi)
    # the 6-dof gauge anchor on pose 0 rides the between factors' log
    logs = _between_log(Rp, tp, f, zinv, se3_compose(*anchor_inv, Rp[0], tp[0]))
    r_edge = logs[:E] * f.edge_w * f.edge_mask[:, None]
    s_cur = s + ds
    # clip only the applied scale (the gradient flows inside [0, 1]; the
    # linear prior below pulls wanderers back into range)
    scale = torch.where(f.edge_switch > 0, clip(s_cur, 0.0, 1.0), 1.0)
    r_edge = r_edge * scale[:, None]
    if huber_delta is not None:
        # IRLS-style robust reweighting: each edge's residual block scaled
        # by sqrt(w_huber), the weight frozen so GN sees a quadratic model
        nrm = torch.sqrt((r_edge**2).sum(-1) + 1e-12)
        w = torch.clamp(huber_delta / nrm, max=1.0).detach()
        r_edge = r_edge * torch.sqrt(w)[:, None]
    r_switch = (1.0 - s_cur) * switch_prior_w * f.edge_switch * f.edge_mask
    r_prior = (tp[:, 2] - f.prior_z) * f.prior_w * f.prior_mask  # (N,)
    r_dz = (tp[f.dz_j, 2] - tp[f.dz_i, 2] - f.dz) * f.dz_w * f.dz_mask  # (D,)
    r_anchor = logs[E] * 1e3
    return torch.cat([r_edge.reshape(-1), r_switch, r_prior, r_dz, r_anchor])


def _edge_r2(R, t, f: PoseGraphFactors, zinv) -> torch.Tensor:
    """Whitened squared between-factor residuals at (R, t): (E,) sums of the
    6 information-weighted tangent components (padding rows -> 0)."""
    r = _between_log(R, t, f, zinv) * f.edge_w * f.edge_mask[:, None]
    return (r * r).sum(-1)


def _dot(a, b):
    return (a * b).sum()


def _cg(matvec, b, iters: int, graph: bool):
    """Fixed-iteration conjugate gradient from x0 = 0. With ``graph`` the
    first iteration runs eagerly and the rest replay it from a CUDA graph
    captured on the current stream (which must not be the default one)."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rs = _dot(b, b)

    def body():
        Ap = matvec(p)
        alpha = rs / torch.clamp(_dot(p, Ap), min=1e-20)
        x.add_(alpha * p)
        r.sub_(alpha * Ap)
        rs_new = _dot(r, r)
        p.mul_(rs_new / torch.clamp(rs, min=1e-20)).add_(r)
        rs.copy_(rs_new)

    if iters <= 0:
        return x
    body()
    if graph and iters > 1:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=torch.cuda.current_stream()):
            body()
        for _ in range(iters - 1):
            g.replay()
        del g
    else:
        for _ in range(iters - 1):
            body()
    return x


def _gn_step(res, n_params: int, like: torch.Tensor, cg_iters: int, damping: float, graph: bool):
    """(step, cost) of one Gauss-Newton step of residual function ``res``
    around 0: CG on (J^T J + damping I) step = -J^T r."""
    zero = torch.zeros(n_params, dtype=like.dtype, device=like.device)
    r0, pullback = torch.func.vjp(res, zero)
    b = -pullback(r0)[0]

    def normal_matvec(v):
        jv = torch.func.jvp(res, (zero,), (v,))[1]
        return pullback(jv)[0] + damping * v

    step = _cg(normal_matvec, b, cg_iters, graph)
    return step, 0.5 * _dot(r0, r0)


def _orthonormalise(R):
    """U V^T of each rotation's SVD (float32 drift of the retractions)."""
    u, _, vt = torch.linalg.svd(R)
    return matmul3(u, vt)


@contextlib.contextmanager
def _solver_context(device: torch.device, graph: bool):
    """Autograd on, outside inference mode; on the card a side stream, so
    the vjp's forward and the captured backward share one stream."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.inference_mode(False))
        stack.enter_context(torch.enable_grad())
        if graph:
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            stack.enter_context(torch.cuda.stream(side))
        yield
    if graph:
        torch.cuda.current_stream(device).wait_stream(side)


def _to_caller(out: tuple, graph: bool) -> tuple:
    """The solver's outputs, made on the side stream, marked as used on the
    caller's stream, so the allocator keeps them until its work is done."""
    if graph:
        for x in out:
            x.record_stream(torch.cuda.current_stream(x.device))
    return out


def _inputs(R0, t0, factors: PoseGraphFactors):
    """Copies on the factors' device and in their float type (float32 from
    :func:`build_factors`), outside inference mode."""
    dev, dtype = factors.edge_i.device, factors.edge_R.dtype

    def fresh(x, dtype=None):
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        return x.clone() if x.is_inference() else x

    f = PoseGraphFactors(*(fresh(x) for x in factors))
    R0, t0 = fresh(R0, dtype), fresh(t0, dtype)
    # Padded edges index pose 0 and contribute exactly zero; spread them over
    # the poses instead (edge k on pose k mod N at both ends), so the vjp's
    # deterministic scatter-add (a sort, then one serial run per distinct
    # index) finds no run of tens of thousands on pose 0. The sums it forms
    # gain only exact zeros.
    spread = torch.arange(f.edge_i.shape[0], device=dev) % R0.shape[0]
    dead = f.edge_mask == 0
    f = f._replace(edge_i=torch.where(dead, spread, f.edge_i),
                   edge_j=torch.where(dead, spread, f.edge_j))
    return R0, t0, f


def _use_graph(cuda_graph: Optional[bool], factors: PoseGraphFactors) -> bool:
    on_card = factors.edge_i.device.type == "cuda"
    if cuda_graph and not on_card:
        raise ValueError("cuda_graph needs the factors on a CUDA device")
    return on_card if cuda_graph is None else bool(cuda_graph)


def optimize_pose_graph(
    R0,  # (N, 3, 3) initial rotations
    t0,  # (N, 3) initial translations
    factors: PoseGraphFactors,
    num_iters: int = 15,
    cg_iters: int = 64,
    damping: float = 1e-6,
    huber_delta: Optional[float] = None,
    # Switchable-Constraints prior weight (1/sigma of the s -> 1 pull). SC is
    # sensitive to it: on the demo scene w=10 disables exactly the false
    # closures, w=5 lands in a bad local minimum, w<=2 turns true closures
    # off too (the JAX package's sweep, BENCH_NOTES.md)
    switch_prior_w: float = 10.0,
    cuda_graph: Optional[bool] = None,
):
    """Gauss-Newton over the factor graph on the factors' device.

    Returns (R, t, cost_trace, switches): cost_trace has num_iters + 1
    entries (initial cost first); switches (E,) are the final
    Switchable-Constraints values of the edges flagged in
    ``factors.edge_switch`` (1.0 elsewhere). Each CG step evaluates one jvp
    and one vjp of the residual sweep; the switch variables ride the same
    flat parameter vector as the pose tangents. ``cuda_graph`` (default:
    on for CUDA factors) replays the CG iterations from a CUDA graph.
    """
    graph = _use_graph(cuda_graph, factors)
    with _solver_context(factors.edge_i.device, graph):
        R0, t0, factors = _inputs(R0, t0, factors)
        zinv, anchor_inv = se3_inv(factors.edge_R, factors.edge_t), se3_inv(R0[0], t0[0])
        N, E = R0.shape[0], factors.edge_i.shape[0]
        s0 = torch.ones(E, dtype=R0.dtype, device=R0.device)
        r_init = _residuals(t0.new_zeros(N, 6), torch.zeros_like(s0), R0, t0, s0, factors,
                            zinv, anchor_inv, huber_delta, switch_prior_w)
        costs = [0.5 * _dot(r_init, r_init)]
        R, t, s = R0, t0, s0
        for _ in range(num_iters):

            def res(p, R=R, t=t, s=s):
                return _residuals(p[: N * 6].reshape(N, 6), p[N * 6 :], R, t, s, factors, zinv,
                                  anchor_inv, huber_delta, switch_prior_w)

            step, cost = _gn_step(res, N * 6 + E, R0, cg_iters, damping, graph)
            Rn, t = se3_retract(R, t, step[: N * 6].reshape(N, 6))
            s = s + step[N * 6 :]
            R = _orthonormalise(Rn)
            costs.append(cost)
        out = (R.detach(), t.detach(), torch.stack(costs).detach(), s.detach())
    return _to_caller(out, graph)


def optimize_pose_graph_gnc(
    R0,
    t0,
    factors: PoseGraphFactors,
    cost_type: str = "gm",
    barcsq: float = 16.81,
    mu_step: float = 1.4,
    # the anneal must run to mu = 1 (GM): mu0 ~ 2 r2max / barcsq is ~1e3 on a
    # drifted init, needing ~log_1.4(mu0) ~ 21+ rounds; a short schedule stops
    # with weights ~1 and rejects nothing
    outer_iters: int = 30,
    inner_iters: int = 3,
    cg_iters: int = 64,
    damping: float = 1e-6,
    cuda_graph: Optional[bool] = None,
):
    """Graduated Non-Convexity robust optimisation (Yang et al., RA-L 2020),
    the outlier rejection the reference configures for Kimera-RPGO on this
    dataset (Geman-McClure cost, mu step 1.4).

    GNC edges are those flagged in ``factors.edge_switch`` (the loop
    closures, as for Switchable Constraints); odometry, priors and the
    anchor stay quadratic. Each between factor gets a weight w in [0, 1]
    scaling its sqrt-information; GNC alternates a weighted Gauss-Newton
    solve and a closed-form weight update under a graduated surrogate cost,
    annealing mu each round.

    cost_type: "gm" (Geman-McClure: weights anneal smoothly, mu -> 1) or
    "tls" (Truncated Least Squares: weights converge to binary, mu -> inf).
    barcsq is the squared inlier threshold on the whitened 6-dof residual
    (default chi2(0.99, 6 dof)). For TLS it must sit above each inlier
    edge's residual at the estimate reachable without that edge: TLS never
    re-opens an edge whose residual stays over the threshold.

    Returns (R, t, cost_trace, weights): cost_trace (outer_iters + 1,) is
    the weighted cost at the start of each outer round plus the final
    weighted cost at the returned estimate; weights (E,) are the final GNC
    weights (1.0 for non-GNC edges); weight < 0.5 = rejected.
    """
    if cost_type not in ("gm", "tls"):
        raise ValueError(f"cost_type must be 'gm' or 'tls': {cost_type!r}")
    cost_is_gm = cost_type == "gm"
    graph = _use_graph(cuda_graph, factors)
    with _solver_context(factors.edge_i.device, graph):
        R0, t0, factors = _inputs(R0, t0, factors)
        zinv, anchor_inv = se3_inv(factors.edge_R, factors.edge_t), se3_inv(R0[0], t0[0])
        N, E = R0.shape[0], factors.edge_i.shape[0]
        gnc_mask = factors.edge_switch > 0
        ones = torch.ones(E, dtype=R0.dtype, device=R0.device)
        zeros = torch.zeros_like(ones)
        # GNC owns the robustness: the inner solve is plain GN (no SC scaling,
        # no Huber) on weight-scaled factors
        f_plain = factors._replace(edge_switch=torch.zeros_like(factors.edge_switch))

        def weighted(w):
            return f_plain._replace(edge_w=f_plain.edge_w * torch.sqrt(w)[:, None])

        # mu from the worst GNC-edge residual at the initial estimate
        r2_0 = _edge_r2(R0, t0, factors, zinv)
        rmax2 = torch.clamp(torch.where(gnc_mask, r2_0, zeros).max(), min=barcsq)
        if cost_is_gm:
            mu = torch.clamp(2.0 * rmax2 / barcsq, min=1.0)
        else:
            mu = torch.clamp(barcsq / torch.clamp(2.0 * rmax2 - barcsq, min=1e-6), 1e-6, 1e6)

        R, t, w = R0, t0, ones
        costs = []
        for _ in range(outer_iters):
            f_w = weighted(w)
            for k in range(inner_iters):

                def res(p, R=R, t=t, f_w=f_w):
                    return _residuals(p.reshape(N, 6), zeros, R, t, ones, f_w, zinv, anchor_inv,
                                      None, 0.0)

                step, cost = _gn_step(res, N * 6, R0, cg_iters, damping, graph)
                Rn, t = se3_retract(R, t, step.reshape(N, 6))
                R = _orthonormalise(Rn)
                if k == 0:
                    costs.append(cost)
            r2 = _edge_r2(R, t, factors, zinv)
            if cost_is_gm:
                w_new = (mu * barcsq / (r2 + mu * barcsq)) ** 2
                mu_n = torch.clamp(mu / mu_step, min=1.0)
            else:
                th_hi = (mu + 1.0) / mu * barcsq
                th_lo = mu / (mu + 1.0) * barcsq
                w_mid = torch.sqrt(barcsq * mu * (mu + 1.0) / torch.clamp(r2, min=1e-12)) - mu
                w_new = torch.where(r2 >= th_hi, zeros,
                                    torch.where(r2 <= th_lo, ones, torch.clamp(w_mid, 0.0, 1.0)))
                mu_n = mu * mu_step
            w = torch.where(gnc_mask, w_new, ones)
            mu = mu_n
        # final weighted cost at the returned estimate (the per-round entries
        # are start-of-round costs, one solve behind)
        r_fin = _residuals(t0.new_zeros(N, 6), zeros, R, t, ones, weighted(w), zinv, anchor_inv,
                           None, 0.0)
        costs.append(0.5 * _dot(r_fin, r_fin))
        out = (R.detach(), t.detach(), torch.stack(costs).detach(), w.detach())
    return _to_caller(out, graph)
