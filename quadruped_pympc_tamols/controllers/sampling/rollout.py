"""Batch-first (structure-of-arrays) SRB rollout for sampling MPC.

Layout: every per-sample quantity lives in its own (N,) row (samples along the
minor, contiguous axis), so each elementwise op of the body is one dense pass over
N floats. The raw spline forces arrive step-major as (H, 12, N) — each scan step
slices one contiguous (12, N) block — and the gravity-share /
contact-masking / friction-clamp force model (reference centroidal_nmpc_jax.py:376-409
and :270-314) is applied inside the loop body so it fuses with the dynamics.

The physics matches dynamics/srbd.py exactly (same Newton-Euler equations,
reference centroidal_model_jax.py:93-174); test_sampling_rollout.py asserts parity.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ...dynamics.srbd import SRBDParams


@dataclasses.dataclass(frozen=True)
class ForceModelParams:
    """Static force-model constants (reference centroidal_nmpc_jax.py:39-41,159-164)."""

    scale_x: float  # max_force_x / max_force_z
    scale_y: float  # max_force_y / max_force_z
    grf_min: float
    grf_max: float
    mu: float


def apply_force_model_rows(raw12, contact4, share, fm: ForceModelParams):
    """Map one step's 12 raw force rows to physical GRFs.

    raw12: (12, ...) rows ordered [leg][axis]; contact4: (4,) stance mask; share:
    scalar gravity-share force, or (4,) PER-LEG shares (equilibrium_share).
    Returns (12, ...) physical force rows."""
    per_leg = getattr(share, "ndim", 0) >= 1
    out = []
    for leg in range(4):
        cl = contact4[leg]
        sh = share[leg] if per_leg else share
        fx = raw12[leg * 3 + 0] * (cl * fm.scale_x)
        fy = raw12[leg * 3 + 1] * (cl * fm.scale_y)
        fz = (sh + raw12[leg * 3 + 2]) * cl
        fz = jnp.clip(fz, fm.grf_min, fm.grf_max)
        lim_x = fm.mu * fz
        fx = jnp.clip(fx, -lim_x, lim_x)
        fy = jnp.clip(fy, -lim_x, lim_x)
        out.extend([fx, fy, fz])
    return out


def equilibrium_share(feet, com_pos, contact_seq, mass, gravity, grf_max):
    """Static-equilibrium per-leg vertical force distribution, (H, 4).

    The plain gravity share m*g/n_stance loads every stance leg EQUALLY; on a
    slope (or any stance where the CoM is off-center) equilibrium demands an
    unequal fore/aft split, and the sampling deltas must rediscover that coupled
    pattern from scratch after every lift-off reset — measured: the sampling
    family stalls at the base of the reference course's 15 deg ramp while the
    gradient family (which SOLVES for the distribution) climbs. This computes
    the least-norm f_z >= 0 with sum(f_z) = m*g and zero CoM moment,
        f = A^T (A A^T + eps I)^(-1) b,   A = [c; (p_x - com_x) c; (p_y - com_y) c]
    per horizon stage (regularized: with 2 stance legs the 3 constraints are
    only met in the least-squares sense, which IS the right fore/aft split).
    """
    b = jnp.array([mass * gravity, 0.0, 0.0], jnp.float32)
    dx = feet[:, 0] - com_pos[0]
    dy = feet[:, 1] - com_pos[1]

    def per_stage(c):
        A = jnp.stack([c, dx * c, dy * c])  # (3, 4)
        M = A @ A.T + 1e-3 * jnp.eye(3, dtype=jnp.float32)
        f = A.T @ jnp.linalg.solve(M, b)
        return jnp.clip(f, 0.0, grf_max)

    return jax.vmap(per_stage)(contact_seq.T.astype(jnp.float32))  # (H, 4)


def rollout_costs_soa(state12, feet, ref12, raw_steps, contact_seq, share, dts, q_diag,
                      params: SRBDParams, fm: ForceModelParams,
                      saturate: float = 1.0e6, unroll: int = 1,
                      zmp_weight: float = 0.0, zmp_margin: float = 0.04):
    """Integrate all samples through the horizon and return accumulated costs.

    Args:
        state12: (12,) initial base state (shared by all samples).
        feet: (4, 3) foot positions (static within the rollout, like the reference).
        ref12: (12,) reference state.
        raw_steps: (H, 12, N) raw spline outputs, step-major (see
            splines.make_step_major_basis).
        contact_seq: (4, H) stance masks.
        share: (H,) per-step gravity-share force m*g/n_stance, or (H, 4)
            per-leg equilibrium shares (see equilibrium_share).
        dts: (H,) per-stage integration steps.
        q_diag: (12,) diagonal state-cost weights — a HOST numpy array (static),
            so zero-weight terms vanish at trace time.
        params: SRBDParams.
        fm: ForceModelParams.
        unroll: lax.scan unroll factor (compile-time/runtime tradeoff).

    Returns:
        (N,) costs with NaN/Inf saturated (reference centroidal_nmpc_jax.py:686-687).
    """
    N = raw_steps.shape[-1]
    dtype = raw_steps.dtype

    m = params.mass
    g = params.gravity
    I = params.inertia
    Iinv = params.inertia_inv

    ones = jnp.ones((N,), dtype)
    rows0 = tuple(state12[i] * ones for i in range(12))
    cost0 = jnp.zeros((N,), dtype)
    contact_t = contact_seq.T  # (H, 4)

    def step(carry, inp):
        (px, py, pz, vx, vy, vz, rr, pp, yy, wx, wy, wz), cost = carry
        raw, c, sh, dt = inp  # (12, N), (4,), scalar, scalar

        f = apply_force_model_rows(raw, c, sh, fm)

        Fx = Fy = Fz = 0.0
        Tx = Ty = Tz = 0.0
        for leg in range(4):
            fx, fy, fz = f[leg * 3 + 0], f[leg * 3 + 1], f[leg * 3 + 2]
            Fx, Fy, Fz = Fx + fx, Fy + fy, Fz + fz
            rx = feet[leg, 0] - px
            ry = feet[leg, 1] - py
            rz = feet[leg, 2] - pz
            Tx = Tx + (ry * fz - rz * fy)
            Ty = Ty + (rz * fx - rx * fz)
            Tz = Tz + (rx * fy - ry * fx)

        ax, ay, az = Fx / m, Fy / m, Fz / m - g

        sr, cr = jnp.sin(rr), jnp.cos(rr)
        sp, cp = jnp.sin(pp), jnp.cos(pp)
        sy, cy = jnp.sin(yy), jnp.cos(yy)
        tp = sp / cp

        # rpy_dot = Einv(roll, pitch) @ omega.
        r_dot = wx + sr * tp * wy + cr * tp * wz
        p_dot = cr * wy - sr * wz
        y_dot = (sr * wy + cr * wz) / cp

        # Body-frame torque: tau_b = R_w2b(ZYX) @ tau_w.
        tbx = cp * cy * Tx + cp * sy * Ty - sp * Tz
        tby = (sr * sp * cy - cr * sy) * Tx + (sr * sp * sy + cr * cy) * Ty + sr * cp * Tz
        tbz = (cr * sp * cy + sr * sy) * Tx + (cr * sp * sy - sr * cy) * Ty + cr * cp * Tz

        # Gyroscopic term omega x (I omega); I is a constant 3x3.
        Iwx = I[0, 0] * wx + I[0, 1] * wy + I[0, 2] * wz
        Iwy = I[1, 0] * wx + I[1, 1] * wy + I[1, 2] * wz
        Iwz = I[2, 0] * wx + I[2, 1] * wy + I[2, 2] * wz
        gx = wy * Iwz - wz * Iwy
        gy = wz * Iwx - wx * Iwz
        gz = wx * Iwy - wy * Iwx

        mx, my, mz = tbx - gx, tby - gy, tbz - gz
        wdx = Iinv[0, 0] * mx + Iinv[0, 1] * my + Iinv[0, 2] * mz
        wdy = Iinv[1, 0] * mx + Iinv[1, 1] * my + Iinv[1, 2] * mz
        wdz = Iinv[2, 0] * mx + Iinv[2, 1] * my + Iinv[2, 2] * mz

        px, py, pz = px + vx * dt, py + vy * dt, pz + vz * dt
        vx, vy, vz = vx + ax * dt, vy + ay * dt, vz + az * dt
        rr, pp, yy = rr + r_dot * dt, pp + p_dot * dt, yy + y_dot * dt
        wx, wy, wz = wx + wdx * dt, wy + wdy * dt, wz + wdz * dt

        rows = (px, py, pz, vx, vy, vz, rr, pp, yy, wx, wy, wz)
        # q_diag is host numpy: zero-weight rows are skipped at trace time.
        for i in range(12):
            w_i = float(q_diag[i])
            if w_i != 0.0:
                e = rows[i] - ref12[i]
                cost = cost + w_i * e * e
        if zmp_weight > 0.0:
            # ZMP-band COST (config sampling.zmp_weight) — the sampling
            # family's analogue of the gradient family's soft ZMP band
            # (variants.make_support_residual; reference
            # centroidal_nmpc_nominal.py:914-934). During 2-stance phases the
            # ZMP approximation p = com_xy - (com_z/g) a_xy is penalized
            # quadratically beyond ``zmp_margin`` of the stance support
            # segment. Trace-time gated: zero weight compiles to nothing
            # (reference parity).
            zx = px - (pz / g) * ax
            zy = py - (pz / g) * ay
            pairs = ((0, 3, 1, 2), (1, 2, 0, 3), (0, 2, 1, 3),
                     (1, 3, 0, 2), (0, 1, 2, 3), (2, 3, 0, 1))
            pen = 0.0
            for i, j, k, l in pairs:
                mask = c[i] * c[j] * (1.0 - c[k]) * (1.0 - c[l])
                axp, ayp = feet[i, 0], feet[i, 1]
                vxp, vyp = feet[j, 0] - axp, feet[j, 1] - ayp
                denom = vxp * vxp + vyp * vyp + 1e-9
                t = jnp.clip(((zx - axp) * vxp + (zy - ayp) * vyp) / denom,
                             0.0, 1.0)
                dxp = zx - (axp + t * vxp)
                dyp = zy - (ayp + t * vyp)
                dist = jnp.sqrt(dxp * dxp + dyp * dyp + 1e-12)
                pen = pen + mask * jnp.square(
                    jnp.maximum(dist - zmp_margin, 0.0))
            cost = cost + zmp_weight * pen
        return (rows, cost), None

    (_, cost), _ = jax.lax.scan(step, (rows0, cost0), (raw_steps, contact_t, share, dts),
                                unroll=unroll)
    bad = jnp.isnan(cost) | jnp.isinf(cost)
    return jnp.where(bad, saturate, cost)
