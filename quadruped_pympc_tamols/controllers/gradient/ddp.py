"""DDP / iLQR solver option for the gradient MPC family.

Counterpart of the reference's DDP nlp-solver option (reference config.py `use_DDP`,
selected into acados solver options in centroidal_nmpc_nominal.py:202-273). acados'
DDP solves the unconstrained multiple-shooting NLS problem; here the same Gauss-Newton
stage cost is minimized with a Riccati backward pass over the horizon and a
line-searched nonlinear forward pass, and the friction-cone inequality set is enforced
by stage-wise projection during the forward rollout (the same clamping semantics the
sampling path uses, reference centroidal_nmpc_jax.py:270-314) — projection rather than
an interior point keeps the whole solve a pair of `lax.scan`s, which is the
compiler-friendly shape for a 12-stage, 12-state problem.

The backward pass is sequential in the horizon by nature; every stage is a handful of
12x12 matmuls/solves, so the whole pass is latency- not throughput-bound and XLA keeps
it on-chip. Batching over gait candidates/scenarios is a plain `vmap`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...config import Config
from ...dynamics.srbd import make_params
from .ocp import (
    OCPDims,
    _stage_wrench,
    linearize_dynamics,
    q_diag_gradient,
    r_diag_gradient,
    rollout_nominal,
    step_fn,
)
from .parallel_riccati import lqr_backward_associative
from .sqp import RTISolution


def project_cone(u, contact, mu, grf_min, grf_max):
    """Project a stacked (12,) GRF vector onto the per-leg friction cone / bounds.

    Swing legs are zeroed; stance fz is clamped to [grf_min, grf_max] and the
    tangential components to the mu*fz box (reference centroidal_nmpc_jax.py:270-314).
    """
    f = u.reshape(4, 3)
    fz = jnp.clip(f[:, 2], grf_min, grf_max) * contact
    lim = mu * fz
    fx = jnp.clip(f[:, 0], -lim, lim)
    fy = jnp.clip(f[:, 1], -lim, lim)
    return jnp.stack([fx, fy, fz], axis=1).reshape(12)


def make_ddp_solver(cfg: Config, integrator: str = "euler"):
    """Build the jitted DDP solve with the same signature as make_rti_solver:
    ``solve(x0, feet_traj, contact_seq, Xref, Uref, U_warm, ext_wrench) ->
    RTISolution``."""
    dims = OCPDims(horizon=cfg.mpc.horizon)
    H, nx, nu = dims.horizon, dims.nx, dims.nu
    gp = cfg.mpc.gradient
    srbd = make_params(cfg)
    dts = cfg.mpc.dts()
    q_diag = jnp.asarray(q_diag_gradient())
    r_diag = jnp.asarray(r_diag_gradient(cfg.robot.name))
    lm = gp.levenberg_marquardt
    mu, grf_min, grf_max = cfg.mpc.mu, cfg.mpc.grf_min, cfg.mpc.grf_max
    ddp_iters = max(1, gp.ddp_iters)
    alphas = jnp.asarray([1.0, 0.6, 0.3, 0.1], jnp.float32)

    def _stage_cost(xn, u, xref, uref):
        ex = xn - xref
        eu = u - uref
        return jnp.sum(ex * ex * q_diag) + jnp.sum(eu * eu * r_diag)

    def _backward(lin, U, Xref, Uref):
        """Riccati recursion. The stage cost lives on (x_{k+1}, u_k), so the state
        quadratic is folded into V_{k+1} before each stage step."""
        A, B, xbar = lin.A, lin.B, lin.xbar
        I_u = jnp.eye(nu)

        def body(carry, inp):
            vx, Vxx = carry
            Ak, Bk, xnext, uk, xrefk, urefk = inp
            vx_eff = vx + q_diag * (xnext - xrefk)
            Vxx_eff = Vxx + jnp.diag(q_diag)
            Qu = Bk.T @ vx_eff + r_diag * (uk - urefk)
            Quu = Bk.T @ Vxx_eff @ Bk + jnp.diag(r_diag) + lm * I_u
            Qux = Bk.T @ Vxx_eff @ Ak
            kK = jnp.linalg.solve(Quu, jnp.concatenate([Qu[:, None], Qux], axis=1))
            kff, Kfb = -kK[:, 0], -kK[:, 1:]
            vx_new = Ak.T @ vx_eff + Qux.T @ kff
            Vxx_new = Ak.T @ Vxx_eff @ Ak + Qux.T @ Kfb
            Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)
            return (vx_new, Vxx_new), (kff, Kfb)

        init = (jnp.zeros(nx), jnp.zeros((nx, nx)))
        _, (kff, Kfb) = jax.lax.scan(
            body, init,
            (A, B, xbar[1:], U, Xref, Uref), reverse=True)
        return kff, Kfb

    def _backward_associative(lin, U, Xref, Uref):
        """The SAME Riccati recursion as _backward in O(log H) depth
        (parallel_riccati.py, SURVEY 2.7/P5), via an exact reduction to the
        tracking-LQR form.

        Delta coordinates around the (defect-free) nominal rollout: dx_{k+1} =
        A_k dx_k + B_k du_k. The input linear term r_diag*(U-Uref) is absorbed by
        completing the square with the shift m = R_f^{-1} r_diag (U-Uref)
        (R_f = diag(r_diag) + lm*I, diagonal): w = du + m turns it into a pure
        quadratic with affine dynamics term c_k = -B_k m_k. Stage state costs sit
        on dx_{k+1} (the DDP stage cost is on the NEXT state), so the LQR sees
        Q_0 = 0 and the last one becomes the terminal cost."""
        A, B, xbar = lin.A, lin.B, lin.xbar
        m = (r_diag * (U - Uref)) / (r_diag + lm)  # (H, nu)
        c = -jnp.einsum("knm,km->kn", B, m)
        g = q_diag * (xbar[1:] - Xref)  # (H, nx) cost gradients at dx_{k+1} = 0
        Qk = jnp.diag(q_diag)
        Qs = jnp.concatenate([jnp.zeros((1, nx, nx)),
                              jnp.tile(Qk[None], (H - 1, 1, 1))], axis=0)
        qs = jnp.concatenate([jnp.zeros((1, nx)), -g[:-1]], axis=0)
        Rs = jnp.tile((jnp.diag(r_diag) + lm * jnp.eye(nu))[None], (H, 1, 1))
        K, kff_lqr, _, _ = lqr_backward_associative(A, c, B, Qs, qs, Rs, Qk, -g[-1])
        # LQR law w = -K dx + kff  ->  du = -K dx + (kff - m); the forward pass
        # applies u = Ubar + alpha*kff_ddp + Kfb_ddp (x - xbar).
        return kff_lqr - m, -K

    def _forward(alpha, x0, Ubar, xbar, kff, Kfb, feet_traj, contact_seq, Xref, Uref,
                 wrench, p_dyn):
        def body(carry, inp):
            x, cost = carry
            ub, xb, kf, Kf, feet, c, dt, xref, uref, wk = inp
            u = ub + alpha * kf + Kf @ (x - xb)
            u = project_cone(u, c, mu, grf_min, grf_max)
            xn = step_fn(x, u, feet, c, p_dyn, dt, integrator, wk)
            return (xn, cost + _stage_cost(xn, u, xref, uref)), u

        (xF, cost), U = jax.lax.scan(
            body, (x0, jnp.float32(0.0)),
            (Ubar, xbar[:-1], kff, Kfb, feet_traj, contact_seq.T, dts, Xref, Uref,
             wrench))
        return cost, U

    v_forward = jax.vmap(_forward,
                         in_axes=(0,) + (None,) * 11)

    # Backward-pass selection (config mpc.gradient.riccati_backward): 'auto'
    # switches to the parallel-in-time pass once the horizon is long enough for
    # O(log H) depth to beat the sequential recursion's latency.
    mode = gp.riccati_backward
    if mode == "auto":
        mode = "associative" if H >= 24 else "sequential"
    backward_fn = _backward_associative if mode == "associative" else _backward

    def solve(x0, feet_traj, contact_seq, Xref, Uref, U_warm, ext_wrench=None,
              srbd_rt=None):
        # srbd_rt: optional runtime SRBDParams (use_inertia_recomputation), same
        # contract as make_rti_solver's solve.
        p_dyn = srbd if srbd_rt is None else srbd_rt
        wrench = _stage_wrench(ext_wrench, H)  # (H, 6), stage-limited compensation
        # Start from the cone-projected warm start so the first linearization is
        # feasible.
        U = jax.vmap(project_cone, in_axes=(0, 0, None, None, None))(
            U_warm, contact_seq.T, mu, grf_min, grf_max)
        for _ in range(ddp_iters):  # static small loop
            xbar = rollout_nominal(x0, U, feet_traj, contact_seq, p_dyn, dts,
                                   integrator, wrench)
            lin = linearize_dynamics(xbar, U, feet_traj, contact_seq, p_dyn, dts,
                                     integrator, wrench)
            kff, Kfb = backward_fn(lin, U, Xref, Uref)
            costs, Us = v_forward(alphas, x0, U, xbar, kff, Kfb, feet_traj,
                                  contact_seq, Xref, Uref, wrench, p_dyn)
            costs = jnp.where(jnp.isfinite(costs), costs, jnp.float32(3.4e38))
            best = jnp.argmin(costs)
            U = Us[best]
            cost = costs[best]
        xs = rollout_nominal(x0, U, feet_traj, contact_seq, p_dyn, dts, integrator,
                             wrench)
        grfs = U[0].reshape(4, 3)
        zero = jnp.float32(0.0)
        return RTISolution(U, grfs, xs[1], cost, zero, zero)

    return jax.jit(solve), dims
