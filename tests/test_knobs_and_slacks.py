"""Behavioral tests for the config knobs the reference implements and for the
soft (slacked) constraint path:

* external_wrenches_compensation_num_step — stage-limited wrench compensation
  (reference centroidal_nmpc_input_rates.py:1360-1373);
* passive_arm_compensation — predicted arm-wrench state vs static estimate in the
  collaborative dynamics (centroidal_model_collaborative.py:266-271);
* use_residual_dynamics_decay — 1/(k+1) residual bound decay in the lyapunov OCP
  (centroidal_nmpc_lyapunov.py:667-687);
* integral state must not accumulate K x per tick under the batched gait optimizer;
* soft stability rows: an infeasible margin degrades gracefully instead of NaN-ing
  into the previous-GRF fallback (acados slack weights zl/Zl = 1000/1,
  centroidal_nmpc_nominal.py:147-163).
"""
import numpy as np
import pytest

from quadruped_pympc_tamols import make_config, replace_config
from quadruped_pympc_tamols.controllers.gradient import VariantGradientMPC
from quadruped_pympc_tamols.controllers.gradient.sqp import (
    BatchedGradientMPC,
    GradientMPC,
    build_stage_wrench,
)


def _standing(cfg, z=None):
    z = cfg.sim.ref_z if z is None else z
    state = dict(position=np.array([0.0, 0.0, z]), linear_velocity=np.zeros(3),
                 orientation=np.zeros(3), angular_velocity=np.zeros(3),
                 foot_FL=np.array([0.25, 0.15, 0.0]), foot_FR=np.array([0.25, -0.15, 0.0]),
                 foot_RL=np.array([-0.25, 0.15, 0.0]), foot_RR=np.array([-0.25, -0.15, 0.0]))
    ref = dict(ref_position=np.array([0.0, 0.0, cfg.sim.ref_z]),
               ref_linear_velocity=np.zeros(3), ref_orientation=np.zeros(3),
               ref_angular_velocity=np.zeros(3),
               ref_foot_FL=state["foot_FL"][None], ref_foot_FR=state["foot_FR"][None],
               ref_foot_RL=state["foot_RL"][None], ref_foot_RR=state["foot_RR"][None])
    return state, ref


# ---------------------------------------------------------------------------
# external_wrenches_compensation_num_step
def test_build_stage_wrench_masks_stages():
    cfg = make_config("aliengo")
    cfg = replace_config(cfg, **{
        "mpc.gradient.external_wrenches_compensation_num_step": 3})
    w = build_stage_wrench(cfg, np.array([10.0, 0, 0, 0, 0, 0]), 12)
    assert w.shape == (12, 6)
    assert np.all(w[:3, 0] == 10.0) and np.all(w[3:] == 0.0)
    # num_step = 0 disables compensation entirely.
    cfg0 = replace_config(cfg, **{
        "mpc.gradient.external_wrenches_compensation_num_step": 0})
    assert np.all(build_stage_wrench(cfg0, np.ones(6), 12) == 0.0)


def test_wrench_num_step_changes_solution():
    """The stage-limited wrench must produce a solution strictly between the
    no-wrench and the full-horizon-wrench solutions."""
    wrench = np.array([30.0, 0.0, 0.0, 0.0, 0.0, 0.0])

    def grfs_with_num_step(ns, w):
        cfg = make_config("aliengo")
        cfg = replace_config(cfg, **{
            "mpc.gradient.external_wrenches_compensation_num_step": ns})
        mpc = GradientMPC(cfg)
        state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.02)
        seq = np.ones((4, cfg.mpc.horizon))
        grfs, *_ = mpc.compute_control(state, ref, seq, external_wrenches=w)
        return grfs

    g_none = grfs_with_num_step(12, None)
    g_zero = grfs_with_num_step(0, wrench)
    g_short = grfs_with_num_step(2, wrench)
    g_full = grfs_with_num_step(12, wrench)
    # num_step=0 == no wrench at all.
    np.testing.assert_allclose(g_zero, g_none, atol=1e-5)
    # A wrench applied to 2 stages does something, and less than the full horizon.
    d_short = np.abs(g_short - g_none).max()
    d_full = np.abs(g_full - g_none).max()
    assert d_short > 1e-3, "stage-limited wrench had no effect"
    assert d_full > d_short, f"full {d_full} should exceed short {d_short}"


# ---------------------------------------------------------------------------
# passive_arm_compensation
def test_passive_arm_compensation_switch():
    """True: the predicted arm state drives the dynamics and the static estimate is
    ignored. False: the static external-wrench estimate enters the balance."""
    wrench = np.array([25.0, 0.0, 0.0, 0.0, 0.0, 0.0])

    def grfs(passive, w):
        cfg = make_config("aliengo", mpc_type="collaborative")
        cfg = replace_config(cfg, **{
            "mpc.gradient.passive_arm_compensation": passive})
        mpc = VariantGradientMPC(cfg, "collaborative")
        state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.02)
        seq = np.ones((4, cfg.mpc.horizon))
        out, *_ = mpc.compute_control(state, ref, seq, external_wrenches=w)
        return out

    # With the predicted-state path, a static estimate is ignored (arm state = 0).
    np.testing.assert_allclose(grfs(True, wrench), grfs(True, None), atol=1e-5)
    # With the static path, the estimate must shift the solution.
    d = np.abs(grfs(False, wrench) - grfs(False, None)).max()
    assert d > 1e-3, "static wrench path had no effect"


# ---------------------------------------------------------------------------
# use_residual_dynamics_decay
def test_residual_decay_tightens_bound():
    """With a tilted base (eta^T eta near the bound), the decayed bound constrains
    late stages harder -> the solution changes; at rest both solve identically."""
    def solve(decay, tilt):
        cfg = make_config("aliengo", mpc_type="lyapunov")
        cfg = replace_config(cfg, **{
            "mpc.gradient.use_residual_dynamics_decay": decay,
            "mpc.gradient.residual_dynamics_upper_bound": 0.2})
        mpc = VariantGradientMPC(cfg, "lyapunov")
        state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.02)
        state["orientation"] = np.array([tilt, 0.0, 0.0])
        seq = np.ones((4, cfg.mpc.horizon))
        grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
        assert np.all(np.isfinite(grfs))
        return grfs

    g_decay = solve(True, 0.35)
    g_plain = solve(False, 0.35)
    assert np.abs(g_decay - g_plain).max() > 1e-3, \
        "decay did not change an eta-active solve"


# ---------------------------------------------------------------------------
# batched gait optimizer side effects
def test_optimize_gait_leaves_integral_untouched():
    cfg = make_config("aliengo")
    cfg = replace_config(cfg, **{"mpc.gradient.use_integrators": True,
                                 "mpc.optimize_step_freq": True})
    batched = BatchedGradientMPC(cfg)
    state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.04)  # tracking error -> integral
    H = cfg.mpc.horizon
    seqs = np.ones((len(cfg.mpc.step_freq_available), 4, H), np.float32)
    # Prime the integral through one REAL tick.
    batched.inner.compute_control(state, ref, seqs[0])
    integ_before = batched.inner.integral.copy()
    assert np.any(integ_before != 0.0)
    batched.optimize_gait(state, ref, seqs)
    np.testing.assert_array_equal(batched.inner.integral, integ_before)


# ---------------------------------------------------------------------------
# soft (slacked) stability constraints
def test_infeasible_stability_margin_degrades_gracefully():
    """A stability margin no 2-stance pose can satisfy must NOT collapse the solver:
    the slacked row soaks the violation and the GRFs stay finite and sensible."""
    cfg = make_config("aliengo")
    cfg = replace_config(cfg, **{"mpc.gradient.use_static_stability": True,
                                 "mpc.gradient.trot_stability_margin": 5.0})
    mpc = VariantGradientMPC(cfg, "nominal")
    state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.02)
    # Diagonal 2-stance (trot): the stability row is active and unsatisfiable.
    seq = np.zeros((4, cfg.mpc.horizon), np.float32)
    seq[0, :] = 1.0
    seq[3, :] = 1.0
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0, "soft-constrained solve must not hit the NaN fallback"
    assert np.all(np.isfinite(grfs))
    total_fz = grfs[:, 2].sum()
    weight = cfg.robot.mass * 9.81
    assert 0.4 * weight < total_fz < 2.5 * weight, f"total fz {total_fz:.1f}"


def test_feasible_margin_soft_matches_hard_closely():
    """With a comfortably feasible margin the slacks stay inactive: the soft solve
    must reproduce the plain nominal solve (slack column prices inactive rows)."""
    def grfs(use_stab):
        cfg = make_config("aliengo")
        cfg = replace_config(cfg, **{"mpc.gradient.use_static_stability": use_stab,
                                     "mpc.gradient.trot_stability_margin": 0.001})
        mpc = VariantGradientMPC(cfg, "nominal")
        state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.02)
        seq = np.ones((4, cfg.mpc.horizon), np.float32)  # full stance: row inactive
        out, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
        assert status == 0
        return out

    np.testing.assert_allclose(grfs(True), grfs(False), atol=0.5)
