"""Optimal-control-problem machinery for the gradient MPC family.

The reference builds its OCP symbolically in CasADi and hands it to acados for C code
generation (controllers/gradient/nominal/centroidal_nmpc_nominal.py:78-274 +
centroidal_model_nominal.py:310-339). Here the same single-rigid-body OCP is expressed
directly on the shared jnp dynamics (dynamics/srbd.py): stage Jacobians come from
jax.jacfwd of the discrete step, and the multiple-shooting problem is CONDENSED into a
dense QP over the input sequence — a dense (N*nu)^2 Hessian assembled by a handful
of small matmuls and factorized once per IP iteration, instead of sparse stage-wise
elimination, at these sizes (nx=12, nu=12, N=12).

Cost weights mirror the reference's hand-tuned LINEAR_LS values
(centroidal_nmpc_nominal.py:501-551): Q = diag(0,0,1500, 200,200,200, 500,500,0,
20,20,50) on the base state, R = 0.001 * I on the GRFs; the z-force reference is the
per-stage gravity share m*g/n_stance (:1195-1210).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config import Config
from ...dynamics.srbd import SRBDParams, fd


@dataclasses.dataclass(frozen=True)
class OCPDims:
    nx: int = 12
    nu: int = 12  # 4 legs x 3 GRF components
    horizon: int = 12

    @property
    def nU(self) -> int:
        return self.nu * self.horizon


def q_diag_gradient() -> np.ndarray:
    """(12,) base-state weights (reference centroidal_nmpc_nominal.py:504-508)."""
    return np.array([0, 0, 1500, 200, 200, 200, 500, 500, 0, 20, 20, 50], dtype=np.float32)


def r_diag_gradient(robot: str = "aliengo") -> np.ndarray:
    """(12,) GRF weights (reference :516-522; hyqreal uses 1e-5)."""
    v = 1e-5 if robot.startswith("hyqreal") else 1e-3
    return np.full(12, v, dtype=np.float32)


def step_fn(x, u, feet, contact, params: SRBDParams, dt, integrator: str = "euler",
            ext_wrench=None):
    """Discrete dynamics x_{k+1} = F(x_k, u_k); u is the stacked (12,) GRF vector.

    ``ext_wrench`` (6,) = world-frame external [force, torque] entering the balance
    exactly like the reference's wrench parameters (centroidal_model_nominal.py
    external_wrench params; config external_wrenches_compensation)."""
    forces = u.reshape(4, 3)

    def f(xx):
        d = fd(xx, feet, forces, contact, params)
        if ext_wrench is not None:
            from ...utils.frames import world_to_body_rot

            d = d.at[3:6].add(ext_wrench[:3] / params.mass)
            tau_b = world_to_body_rot(xx[6:9]) @ ext_wrench[3:]
            d = d.at[9:12].add(jnp.asarray(params.inertia_inv) @ tau_b)
        return d

    if integrator == "rk4":
        k1 = f(x)
        k2 = f(x + 0.5 * dt * k1)
        k3 = f(x + 0.5 * dt * k2)
        k4 = f(x + dt * k3)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return x + dt * f(x)


class Linearization(NamedTuple):
    A: jnp.ndarray  # (H, nx, nx)
    B: jnp.ndarray  # (H, nx, nu)
    xbar: jnp.ndarray  # (H+1, nx) nominal rollout


def _stage_wrench(ext_wrench, H):
    """Normalize ext_wrench to per-stage (H, 6): the reference compensates the
    estimated wrench only for the first external_wrenches_compensation_num_step
    stages (centroidal_nmpc_input_rates.py:1360-1373), so callers may pass a
    stage-varying (H, 6) array; a plain (6,) wrench broadcasts to every stage."""
    if ext_wrench is None:
        return jnp.zeros((H, 6), jnp.float32)
    ext_wrench = jnp.asarray(ext_wrench)
    if ext_wrench.ndim == 1:
        return jnp.broadcast_to(ext_wrench, (H, 6))
    return ext_wrench


def rollout_nominal(x0, U, feet_traj, contact_seq, params, dts, integrator="euler",
                    ext_wrench=None):
    """Forward-simulate the nominal trajectory under the input sequence U (H, nu)."""
    w = _stage_wrench(ext_wrench, U.shape[0])

    def body(x, inp):
        u, feet, c, dt, wk = inp
        xn = step_fn(x, u, feet, c, params, dt, integrator, wk)
        return xn, xn

    _, xs = jax.lax.scan(body, x0, (U, feet_traj, contact_seq.T, dts, w))
    return jnp.concatenate([x0[None], xs], axis=0)  # (H+1, nx)


def linearize_dynamics(xbar, U, feet_traj, contact_seq, params, dts, integrator="euler",
                       ext_wrench=None):
    """Stage Jacobians A_k = dF/dx, B_k = dF/du along the nominal trajectory."""
    w = _stage_wrench(ext_wrench, U.shape[0])

    def jac(x, u, feet, c, dt, wk):
        A = jax.jacfwd(lambda xx: step_fn(xx, u, feet, c, params, dt, integrator,
                                          wk))(x)
        B = jax.jacfwd(lambda uu: step_fn(x, uu, feet, c, params, dt, integrator,
                                          wk))(u)
        return A, B

    A, B = jax.vmap(jac)(xbar[:-1], U, feet_traj, contact_seq.T, dts, w)
    return Linearization(A, B, xbar)


def condense(lin: Linearization, dims: OCPDims):
    """Prediction operators for the condensed QP (deviation variables).

    delta_x_{k+1} = A_k delta_x_k + B_k delta_u_k, delta_x_0 = x0 - xbar_0.
    Returns F (H, nx, nx) with delta_x_{k+1} = F[k] @ delta_x0 + sum_j G[k,j] delta_u_j,
    and G (H, H, nx, nu) lower block triangular.

    H=12 stages of 12x12 products: assembled with static Python loops (tiny, fully
    unrolled by XLA).
    """
    H = dims.horizon
    A, B = lin.A, lin.B
    F = [None] * H
    G = [[None] * H for _ in range(H)]
    F[0] = A[0]
    G[0][0] = B[0]
    for k in range(1, H):
        F[k] = A[k] @ F[k - 1]
        for j in range(k):
            G[k][j] = A[k] @ G[k - 1][j]
        G[k][k] = B[k]
    zero = jnp.zeros_like(B[0])
    Gm = jnp.stack([jnp.stack([G[k][j] if j <= k else zero for j in range(H)]) for k in range(H)])
    Fm = jnp.stack(F)
    return Fm, Gm


def condensed_cost(Fm, Gm, xbar, x0, Xref, Uref, Ubar, q_diag, r_diag, dims: OCPDims):
    """Dense Hessian/gradient of the condensed QP in delta_U.

    cost = sum_k ||x_{k+1} - xref_{k+1}||^2_Q + ||u_k - uref_k||^2_R with
    x_{k+1} = xbar_{k+1} + F[k] dx0 + (G dU)_{k}.
    Returns (Hm (nU, nU), g (nU,)).
    """
    H, nx, nu = dims.horizon, dims.nx, dims.nu
    dx0 = x0 - xbar[0]
    # e_k = predicted error at stage k+1 with dU = 0.
    e = xbar[1:] + jnp.einsum("kij,j->ki", Fm, dx0) - Xref  # (H, nx)
    Gt = Gm.transpose(1, 3, 0, 2).reshape(H * nu, H * nx)  # dU-major operator G^T
    Qw = jnp.tile(q_diag, (H,))
    g_state = Gt @ (Qw * e.reshape(-1))
    Hm_state = (Gt * Qw[None, :]) @ Gt.T
    Rw = jnp.tile(r_diag, (H,))
    du_ref = (Ubar - Uref).reshape(-1)
    g = g_state + Rw * du_ref
    Hm = Hm_state + jnp.diag(Rw)
    return Hm, g


def friction_cone_rows(mu, grf_min, grf_max, contact_seq, dims: OCPDims,
                       stance_min_force: float = 0.0):
    """Per-stage inequality C_k u_k <= d_k (6 rows per leg: fz bounds + 4 cone rows,
    reference friction-cone h-constraints centroidal_nmpc_nominal.py:430-499).

    For swing legs the fz upper bound collapses toward 0 so sampled forces stay off
    (their forces do not enter the dynamics anyway; the reference achieves this by
    zeroing references and masking in the model).

    ``stance_min_force`` raises the per-leg fz LOWER bound to this value on
    stance stages only (config gradient.stance_min_force — keeps lightly loaded
    feet's friction cones open during weight transfers on sparse terrain; swing
    legs keep fz >= grf_min).

    Returns C (H, 24, nu), d (H, 24).
    """
    rows = []
    for leg in range(4):
        base = np.zeros((6, 12), dtype=np.float32)
        ex, ey, ez = leg * 3, leg * 3 + 1, leg * 3 + 2
        base[0, ez] = -1.0  # -fz <= -grf_min
        base[1, ez] = 1.0  # fz <= fz_max(stage, leg)
        base[2, ex], base[2, ez] = 1.0, -mu  # fx - mu fz <= 0
        base[3, ex], base[3, ez] = -1.0, -mu
        base[4, ey], base[4, ez] = 1.0, -mu
        base[5, ey], base[5, ez] = -1.0, -mu
        rows.append(base)
    C_single = np.concatenate(rows, axis=0)  # (24, 12)
    H = dims.horizon
    C = jnp.tile(jnp.asarray(C_single), (H, 1, 1))  # (callers may keep only d)
    fz_max = grf_max * contact_seq.T + 1e-3  # (H, 4): ~0 for swing legs
    d = jnp.zeros((H, 24))
    for leg in range(4):
        d = d.at[:, leg * 6 + 0].set(
            -(grf_min + stance_min_force * contact_seq.T[:, leg]))
        d = d.at[:, leg * 6 + 1].set(fz_max[:, leg])
    return C, d


def build_feet_trajectory(feet_now, ref_feet_list, contact_seq, horizon):
    """Per-stage foot positions over the horizon (host-side numpy).

    Stance feet hold their current position; at each in-horizon touch-down the leg
    jumps to its (next) reference foothold — mirroring the reference's
    idx_ref_foot_to_assign advance (centroidal_nmpc_nominal.py:1165-1235) and the
    model's gated foot dynamics.

    Args:
        feet_now: (4, 3) current foot positions.
        ref_feet_list: (4, K, 3) per-leg reference foothold sequence (K >= 1).
        contact_seq: (4, H).
    Returns (H, 4, 3).
    """
    feet_now = np.asarray(feet_now, np.float64)
    ref = np.asarray(ref_feet_list, np.float64)
    if ref.ndim == 2:
        ref = ref[:, None, :]
    seq = np.asarray(contact_seq)
    out = np.zeros((horizon, 4, 3))
    for leg in range(4):
        idx = 0
        pos = feet_now[leg] if seq[leg, 0] == 1 else ref[leg, 0]
        for k in range(horizon):
            if k > 0 and seq[leg, k] == 1 and seq[leg, k - 1] == 0:
                pos = ref[leg, min(idx, ref.shape[1] - 1)]
                idx += 1
            out[k, leg] = pos
    return out
