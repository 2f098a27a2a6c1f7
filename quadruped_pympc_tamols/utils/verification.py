"""Solver-accuracy verification ladder.

BASELINE.md sets a <=1e-3 control-parity bar against acados, but acados/CasADi are
not installable here; what CAN be measured exactly is the gap between the
production fixed-iteration f32 interior point and a trusted high-accuracy
reference on the SAME QP matrices. This module provides that reference — a
float64 numpy Mehrotra predictor-corrector run to machine-precision
complementarity (200 iterations with early convergence) — plus the harness that
captures REAL tick QPs from a closed-loop walk and reports the gap. Used by
tests/test_f64_ladder.py and ``bench.py`` (the ``qp_gap_vs_f64`` field).

The QPs come from sqp.make_rti_solver_split(..., return_assembler=True), so they
are byte-for-byte the matrices the production feedback phase solves (same
linearization, condensing, warm-start shift and contact bounds).
"""
from __future__ import annotations

import numpy as np


def pdip_solve_np_f64(Hm, g, C, d, iters: int = 200, tol: float = 1e-12):
    """Reference-grade dense QP solve: min 0.5 z'Hz + g'z s.t. Cz <= d.

    Float64 Mehrotra predictor-corrector (the same algorithm family as the
    production qp.pdip_solve_mehrotra and HPIPM) run until the complementarity
    and primal residuals fall below ``tol`` (or ``iters``, whichever first).
    Host numpy — no f32 rounding, no iteration cap pressure. Returns (z, mu).
    """
    Hm = np.asarray(Hm, np.float64)
    g = np.asarray(g, np.float64)
    C = np.asarray(C, np.float64)
    d = np.asarray(d, np.float64)
    n, m = g.shape[0], d.shape[0]
    z = np.zeros(n)
    s = np.maximum(d - C @ z, 1.0)
    lam = np.ones(m)
    I = np.eye(n) * 1e-12

    def max_step(v, dv):
        neg = dv < 0
        if not np.any(neg):
            return 1.0
        return min(1.0, 0.995 * np.min(-v[neg] / dv[neg]))

    for _ in range(iters):
        r_d = Hm @ z + g + C.T @ lam
        r_p = C @ z + s - d
        mu = float(lam @ s) / m
        if mu < tol and np.max(np.maximum(r_p, 0.0), initial=0.0) < tol \
                and np.max(np.abs(r_d)) < 1e-8:
            break
        w = lam / s
        K = Hm + (C.T * w[None, :]) @ C + I
        # Adaptive regularization: near-degenerate active sets (e.g. a forced
        # soft-slack violation driving lam/s to 1e12 on zl-scaled rows) can
        # push K numerically indefinite; inflating the PRIMAL regularization
        # only damps the Newton step — convergence is still judged by the
        # unregularized residuals. Scale-aware: K's diagonal can reach 1e15 on
        # augmented soft-slack systems, where an absolute 1e-12 is below ulp.
        reg = 1e-14 * float(np.max(np.diag(K)))
        while True:
            try:
                L = np.linalg.cholesky(K + reg * np.eye(n))
                break
            except np.linalg.LinAlgError:
                reg *= 1e3
                if reg > 1e-2 * float(np.max(np.diag(K))):
                    raise

        def kkt(r_c):
            rhs = -r_d - C.T @ ((lam * r_p - r_c) / s)
            dz = np.linalg.solve(L.T, np.linalg.solve(L, rhs))
            ds = -r_p - C @ dz
            dlam = -(r_c + lam * ds) / s
            return dz, ds, dlam

        dz_a, ds_a, dlam_a = kkt(lam * s)
        a_aff = min(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = float((lam + a_aff * dlam_a) @ (s + a_aff * ds_a)) / m
        sigma = np.clip((mu_aff / max(mu, 1e-300)) ** 3, 0.0, 1.0)
        dz, ds, dlam = kkt(lam * s - sigma * mu + dlam_a * ds_a)
        alpha = min(max_step(s, ds), max_step(lam, dlam))
        z = z + alpha * dz
        s = np.maximum(s + alpha * ds, 1e-300)
        lam = np.maximum(lam + alpha * dlam, 1e-300)
    return z, float(lam @ s) / m


def capture_tick_qps(cfg, n_ticks: int = 20, duration: float = 3.0,
                     vel=(0.3, 0.0, 0.0), seed: int = 0):
    """Record the condensed-QP inputs of ``n_ticks`` REAL closed-loop MPC ticks.

    Runs the SRB closed-loop harness (full stack: gait -> footholds -> MPC ->
    plant) with the nominal gradient MPC and intercepts every ``solve`` call's
    inputs. Returns a list of dicts with keys x0, feet_traj, seq, Xref, Uref,
    U_warm. Skips the first 5 ticks (standing start — trivially interior QPs).
    """
    from ..sim.srb_harness import SRBClosedLoopHarness

    h = SRBClosedLoopHarness(cfg, seed=seed)
    mpc = h.ctrl.controller
    orig_solve = mpc.solve
    records = []

    def recording_solve(x0, feet_traj, seq, Xref, Uref, U_warm, wrench, srbd_rt):
        records.append(dict(
            x0=np.array(x0, np.float32), feet_traj=np.array(feet_traj, np.float32),
            seq=np.array(seq, np.float32), Xref=np.array(Xref, np.float32),
            Uref=np.array(Uref, np.float32), U_warm=np.array(U_warm, np.float32)))
        return orig_solve(x0, feet_traj, seq, Xref, Uref, U_warm, wrench, srbd_rt)

    mpc.solve = recording_solve
    n_steps = int(duration / cfg.sim.dt)
    v = np.asarray(vel, np.float64)
    for _ in range(n_steps):
        h.step(v)
        if len(records) >= n_ticks + 5:
            break
    mpc.solve = orig_solve
    return records[5:5 + n_ticks]


def soft_qp_augment_np(Hm, g, C, d, S, zl: float = 1000.0, Zl: float = 1.0):
    """Float64 numpy twin of qp.soft_qp_solve's slack augmentation (same zl-row
    scaling), so the f64 reference solves the EXACT augmented problem the
    production f32 path solves."""
    Hm = np.asarray(Hm, np.float64)
    g = np.asarray(g, np.float64)
    C = np.asarray(C, np.float64)
    d = np.asarray(d, np.float64)
    S = np.asarray(S, np.float64)
    n, ns = g.shape[0], S.shape[1]
    H_aug = np.zeros((n + ns, n + ns))
    H_aug[:n, :n] = Hm
    H_aug[np.arange(n, n + ns), np.arange(n, n + ns)] = Zl
    g_aug = np.concatenate([g, np.full(ns, zl)])
    C_aug = np.concatenate([
        np.concatenate([C, -S], axis=1),
        np.concatenate([np.zeros((ns, n)), -zl * np.eye(ns)], axis=1)], axis=0)
    d_aug = np.concatenate([d, np.zeros(ns)])
    return H_aug, g_aug, C_aug, d_aug


def capture_variant_ticks(cfg, n_ticks: int = 10, duration: float = 3.0,
                          vel=(0.3, 0.0, 0.0), seed: int = 0):
    """Record the solver inputs of real closed-loop ticks of a VARIANT
    controller (use_zmp_stability / use_static_stability / augmented-state
    families — the soft-slacked QP path). Same harness seam as
    capture_tick_qps, intercepting VariantGradientMPC.solve."""
    from ..sim.srb_harness import SRBClosedLoopHarness

    h = SRBClosedLoopHarness(cfg, seed=seed)
    mpc = h.ctrl.controller
    orig_solve = mpc.solve
    records = []

    def recording_solve(x0, feet_traj, seq, Xref, Uref, U_warm, wrench):
        records.append(dict(
            x0=np.array(x0, np.float32), feet_traj=np.array(feet_traj, np.float32),
            seq=np.array(seq, np.float32), Xref=np.array(Xref, np.float32),
            Uref=np.array(Uref, np.float32), U_warm=np.array(U_warm, np.float32),
            wrench=np.array(wrench, np.float32)))
        return orig_solve(x0, feet_traj, seq, Xref, Uref, U_warm, wrench)

    mpc.solve = recording_solve
    n_steps = int(duration / cfg.sim.dt)
    v = np.asarray(vel, np.float64)
    for _ in range(n_steps):
        h.step(v)
        if len(records) >= n_ticks + 5:
            break
    mpc.solve = orig_solve
    return mpc, records[5:5 + n_ticks]


def soft_qp_ladder_report(cfg=None, n_ticks: int = 10):
    """f64 ladder for the SOFT-slacked QP path (L1/L2 penalties, the acados
    zl/Zl role — qp.soft_qp_solve), uncovered by the plain ladder: captures
    real ticks of the nominal variant with the ZMP band stability constraint
    (the production stone-crossing configuration), re-assembles the exact
    condensed QP at each tick's warm start, and compares the f32 production
    soft solve against the f64 Mehrotra reference on the SAME augmented
    matrices. Also reports how many ticks had an ACTIVE slack (t > 1e-4 in the
    f64 solution), so the L1/L2 machinery is verifiably exercised."""
    import jax

    from .. import make_config
    from ..controllers.gradient.qp import soft_qp_solve
    from ..controllers.gradient.sqp import qp_solver_for
    from ..controllers.gradient.variants import make_variant_solver

    if cfg is None:
        cfg = make_config("aliengo", mpc_type="nominal",
                          **{"sim.visual_foothold_adaptation": "blind",
                             "mpc.gradient.use_zmp_stability": True})
    mpc, ticks = capture_variant_ticks(cfg, n_ticks=n_ticks)
    _, dims, assemble, S_big = make_variant_solver(cfg, mpc.spec,
                                                   return_assembler=True)
    assert S_big is not None, "config does not produce a soft-slacked QP"
    qp_fn, iters = qp_solver_for(cfg.mpc.gradient)
    soft_jit = jax.jit(lambda Hm, g, C, d: soft_qp_solve(
        Hm, g, C, d, S_big, solver=qp_fn, iters=iters).z)

    grf_dev, mu_ref, active = [], [], 0
    for t in ticks:
        Hm, g, C, d = jax.device_get(assemble(
            t["x0"], t["feet_traj"], t["seq"], t["Xref"], t["Uref"], t["U_warm"],
            t["wrench"]))
        z32 = np.asarray(jax.device_get(soft_jit(Hm, g, C, d)))
        H_a, g_a, C_a, d_a = soft_qp_augment_np(Hm, g, C, d, S_big)
        z64_aug, mu = pdip_solve_np_f64(H_a, g_a, C_a, d_a)
        mu_ref.append(mu)
        n = g.shape[0]
        if np.max(z64_aug[n:]) > 1e-4:
            active += 1
        u0_32 = t["U_warm"][0, :12] + z32[:12]
        u0_64 = t["U_warm"][0, :12].astype(np.float64) + z64_aug[:12]
        grf_dev.append(np.max(np.abs(u0_32 - u0_64)))
    total_load = float(cfg.robot.mass * cfg.gravity)
    return {
        "n_ticks": len(ticks),
        "n_active_slack_ticks": active,
        "soft_qp_gap_vs_f64_max_N": float(np.max(grf_dev)),
        "soft_qp_gap_vs_f64_mean_N": float(np.mean(grf_dev)),
        "soft_qp_gap_vs_f64_rel": float(np.max(grf_dev) / total_load),
        "f64_mu_max": float(np.max(mu_ref)),
    }


def srb_rollout_cost_np_f64(state12, feet, ref12, raw_steps, contact_seq, share,
                            dts, q_diag, mass, gravity, inertia, fm):
    """Float64 numpy twin of the sampling rollout cost for ONE parameter vector
    (controllers/sampling/rollout.rollout_costs_soa, N=1): same force model
    (gravity share, contact masking, friction clamp), Newton-Euler SRB Euler
    integration and quadratic state cost, evaluated without f32 rounding."""
    x = np.asarray(state12, np.float64).copy()
    feet = np.asarray(feet, np.float64)
    ref = np.asarray(ref12, np.float64)
    I = np.asarray(inertia, np.float64)
    Iinv = np.linalg.inv(I)
    cost = 0.0
    H = raw_steps.shape[0]
    for n in range(H):
        raw = np.asarray(raw_steps[n], np.float64)  # (12,)
        F = np.zeros(3)
        T = np.zeros(3)
        for leg in range(4):
            c = float(contact_seq[leg, n])
            sh = share[n][leg] if np.ndim(share[n]) else share[n]
            fx = raw[leg * 3 + 0] * (c * fm.scale_x)
            fy = raw[leg * 3 + 1] * (c * fm.scale_y)
            fz = np.clip((sh + raw[leg * 3 + 2]) * c, fm.grf_min, fm.grf_max)
            lim = fm.mu * fz
            fx, fy = np.clip(fx, -lim, lim), np.clip(fy, -lim, lim)
            f = np.array([fx, fy, fz])
            r = feet[leg] - x[0:3]
            F += f
            T += np.cross(r, f)
        acc = F / mass - np.array([0.0, 0.0, gravity])
        sr, cr = np.sin(x[6]), np.cos(x[6])
        sp, cp = np.sin(x[7]), np.cos(x[7])
        sy, cy = np.sin(x[8]), np.cos(x[8])
        Einv = np.array([[1, sr * sp / cp, cr * sp / cp],
                         [0, cr, -sr],
                         [0, sr / cp, cr / cp]])
        Rwb = np.array([
            [cp * cy, cp * sy, -sp],
            [sr * sp * cy - cr * sy, sr * sp * sy + cr * cy, sr * cp],
            [cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cr * cp]])
        w = x[9:12]
        wd = Iinv @ (Rwb @ T - np.cross(w, I @ w))
        dt = float(dts[n])
        x[0:3] += x[3:6] * dt
        x[3:6] += acc * dt
        x[6:9] += (Einv @ w) * dt
        x[9:12] += wd * dt
        e = x - ref
        cost += float(np.sum(np.asarray(q_diag, np.float64) * e * e))
    return cost


def capture_sampling_ticks(cfg, n_ticks: int = 12, duration: float = 3.0,
                           vel=(0.3, 0.0, 0.0), seed: int = 0):
    """Record real sampling-MPC tick inputs + the post-solve incumbent
    parameters from a closed-loop walk (SamplingMPC.solve seam)."""
    from ..sim.srb_harness import SRBClosedLoopHarness

    h = SRBClosedLoopHarness(cfg, seed=seed)
    mpc = h.ctrl.controller
    orig_solve = mpc.solve
    records = []

    def recording_solve(state12, feet, ref12, ref_feet, seq, cur, prev, st):
        out, new_st = orig_solve(state12, feet, ref12, ref_feet, seq, cur, prev, st)
        records.append(dict(
            state12=np.array(state12, np.float32), feet=np.array(feet, np.float32),
            ref12=np.array(ref12, np.float32),
            ref_feet=np.array(ref_feet, np.float32),
            seq=np.array(seq, np.float32), cur=np.array(cur, np.float32),
            params=np.array(new_st.best_parameters, np.float32)))
        return out, new_st

    mpc.solve = recording_solve
    n_steps = int(duration / cfg.sim.dt)
    v = np.asarray(vel, np.float64)
    for _ in range(n_steps):
        h.step(v)
        if len(records) >= n_ticks + 5:
            break
    mpc.solve = orig_solve
    return records[5:5 + n_ticks]


def rollout_ladder_report(cfg=None, n_ticks: int = 12):
    """f64 ladder for the SAMPLING rollout cost: on real captured tick states
    and their solved incumbent parameters, the production f32 spline GEMM and
    rollout cost (splines.spline_forces + rollout_costs_soa) are compared to a
    float64 numpy twin. Reports the max relative
    cost gap — the f32 rounding the optimizer's argmin/softmax actually sees."""
    import jax
    import jax.numpy as jnp

    from .. import make_config, replace_config
    from ..config import SamplingParams
    from ..controllers.sampling.rollout import (
        ForceModelParams,
        rollout_costs_soa,
    )
    from ..controllers.sampling.splines import make_step_major_basis, spline_forces
    from ..dynamics.srbd import make_params

    if cfg is None:
        cfg = make_config("aliengo", mpc_type="sampling")
        cfg = replace_config(cfg, **{"mpc.sampling.num_samples": 512,
                                     "sim.visual_foothold_adaptation": "blind"})
    ticks = capture_sampling_ticks(cfg, n_ticks=n_ticks)
    sp = cfg.mpc.sampling
    H = cfg.mpc.horizon
    srbd = make_params(cfg)
    dts = cfg.mpc.dts()
    q_diag = np.asarray(cfg.mpc.cost.as_vector())
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z,
                          sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)
    W = make_step_major_basis(sp.parametrization, H, sp.num_splines)  # (H*12, P)

    # The production f32 path end to end: the spline GEMM on the device at the
    # default deployment's sample width (the GEMM's precision can depend on its
    # shape), then the rollout of the tick's own column.
    width = SamplingParams.num_samples
    cost32_fn = jax.jit(lambda s, f, r, p, seq, sh: rollout_costs_soa(
        s, f, r, spline_forces(W, jnp.tile(p[:, None], (1, width)))[..., :1], seq, sh,
        jnp.asarray(dts, jnp.float32), q_diag, srbd, fm))

    rels = []
    for t in ticks:
        feet_eff = np.where(t["cur"][:, None] == 0.0, t["ref_feet"], t["feet"])
        share = (srbd.mass * 9.81
                 / np.maximum(t["seq"].sum(axis=0), 1.0)).astype(np.float32)
        c32 = float(jax.device_get(cost32_fn(
            jnp.asarray(t["state12"]), jnp.asarray(feet_eff),
            jnp.asarray(t["ref12"]), jnp.asarray(t["params"]),
            jnp.asarray(t["seq"]), jnp.asarray(share)))[0])
        raw64 = (W.astype(np.float64) @ t["params"].astype(np.float64)).reshape(H, 12)
        c64 = srb_rollout_cost_np_f64(
            t["state12"], feet_eff, t["ref12"], raw64, t["seq"],
            share.astype(np.float64), dts, q_diag, float(srbd.mass),
            float(srbd.gravity), np.asarray(srbd.inertia), fm)
        rels.append(abs(c32 - c64) / max(abs(c64), 1e-9))
    return {
        "rollout_ladder_n_ticks": len(ticks),
        "rollout_gap_vs_f64_rel": float(np.max(rels)),
        "rollout_gap_vs_f64_mean_rel": float(np.mean(rels)),
    }


def qp_ladder_report(cfg, ticks=None, n_ticks: int = 20):
    """Quantify the production-f32 vs reference-f64 gap on real tick QPs.

    Returns a dict: max/mean first-stage GRF deviation [N], max relative
    deviation vs the total vertical load, the f64 residual quality, and the
    IPM budget the production solve ran with.
    """
    import jax

    from ..controllers.gradient.sqp import make_rti_solver_split, qp_solver_for

    if ticks is None:
        ticks = capture_tick_qps(cfg, n_ticks=n_ticks)
    *_, assemble_qp = make_rti_solver_split(cfg, return_assembler=True)
    qp_fn, iters = qp_solver_for(cfg.mpc.gradient)
    qp_jit = jax.jit(lambda Hm, g, C, d: qp_fn(Hm, g, C, d, iters=iters).z)

    grf_dev = []
    mu_ref = []
    for t in ticks:
        Hm, g, C, d = jax.device_get(assemble_qp(
            t["x0"], t["feet_traj"], t["seq"], t["Xref"], t["Uref"], t["U_warm"]))
        z32 = np.asarray(jax.device_get(qp_jit(Hm, g, C, d)))
        z64, mu = pdip_solve_np_f64(Hm, g, C, d)
        mu_ref.append(mu)
        # First-stage GRFs are the control the plant sees.
        u0_32 = t["U_warm"][0] + z32[:12]
        u0_64 = t["U_warm"][0].astype(np.float64) + z64[:12]
        grf_dev.append(np.max(np.abs(u0_32 - u0_64)))
    total_load = float(cfg.robot.mass * cfg.gravity)
    return {
        "n_ticks": len(ticks),
        "iters": iters,
        "qp_gap_vs_f64_max_N": float(np.max(grf_dev)),
        "qp_gap_vs_f64_mean_N": float(np.mean(grf_dev)),
        "qp_gap_vs_f64_rel": float(np.max(grf_dev) / total_load),
        "f64_mu_max": float(np.max(mu_ref)),
    }
