"""RTI prepare/feedback split (acados rti_phase 1/2, reference
srbd_controller_interface.py:242-245, centroidal_nmpc_nominal.py:1442-1452).

The split must be EXACT when the prediction is exact: solve(x0, ...) ==
feedback(prepare(x0, ...), x0, ...) by construction, and the dx0 correction term
must make the feedback first-order-consistent when the measured state deviates
from the prediction.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from quadruped_pympc_tamols import make_config, replace_config
from quadruped_pympc_tamols.controllers.gradient import make_rti_solver_split
from quadruped_pympc_tamols.controllers.gradient.sqp import GradientMPC


def _problem(cfg):
    H = cfg.mpc.horizon
    x0 = jnp.zeros(12).at[2].set(cfg.sim.ref_z - 0.02)
    feet_traj = jnp.tile(jnp.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                                      [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                                     jnp.float32), (H, 1, 1))
    seq = jnp.ones((4, H))
    Xref = jnp.tile(jnp.zeros(12).at[2].set(cfg.sim.ref_z), (H, 1))
    Uref = jnp.zeros((H, 12)).at[:, 2::3].set(cfg.robot.mass * 9.81 / 4)
    return x0, feet_traj, seq, Xref, Uref


def test_split_matches_one_shot_solve_exactly():
    cfg = make_config("aliengo")
    solve, prepare, feedback, dims = make_rti_solver_split(cfg)
    x0, feet_traj, seq, Xref, Uref = _problem(cfg)
    U_warm = Uref

    ref = solve(x0, feet_traj, seq, Xref, Uref, U_warm)
    prep = prepare(x0, feet_traj, seq, Xref, Uref, U_warm)
    out = feedback(prep, x0, feet_traj, seq, Xref, Uref)
    # atol covers f32 fusion-order noise between the two compiled programs
    # (forces are O(60 N); observed deviation ~4e-5).
    np.testing.assert_allclose(np.asarray(out.U), np.asarray(ref.U), atol=1e-3)
    np.testing.assert_allclose(np.asarray(out.cost), np.asarray(ref.cost), rtol=1e-4)


def test_feedback_dx0_correction_tracks_measurement():
    """Feedback with a perturbed measured state must move toward the fresh solve at
    that state — much closer than ignoring the measurement entirely."""
    cfg = make_config("aliengo")
    solve, prepare, feedback, dims = make_rti_solver_split(cfg)
    x0, feet_traj, seq, Xref, Uref = _problem(cfg)
    U_warm = Uref

    prep = prepare(x0, feet_traj, seq, Xref, Uref, U_warm)
    x_meas = x0 + jnp.zeros(12).at[2].set(-0.015).at[3].set(0.08)

    fresh = np.asarray(solve(x_meas, feet_traj, seq, Xref, Uref, U_warm).U)
    stale = np.asarray(feedback(prep, x0, feet_traj, seq, Xref, Uref).U)
    fb = np.asarray(feedback(prep, x_meas, feet_traj, seq, Xref, Uref).U)
    err_fb = np.abs(fb - fresh).max()
    err_stale = np.abs(stale - fresh).max()
    assert err_fb < 0.35 * err_stale, f"fb {err_fb:.3f} vs stale {err_stale:.3f}"


def test_host_wrapper_runs_split_path():
    """GradientMPC: prepare dispatched via compute_rti_prepare, next tick consumes
    it (feedback), and the result stays consistent with the one-shot path."""
    cfg = make_config("aliengo")
    cfg = replace_config(cfg, **{"mpc.gradient.use_RTI": True})
    state = dict(position=np.array([0.0, 0.0, cfg.sim.ref_z - 0.02]),
                 linear_velocity=np.zeros(3), orientation=np.zeros(3),
                 angular_velocity=np.zeros(3),
                 foot_FL=np.array([0.25, 0.15, 0.0]), foot_FR=np.array([0.25, -0.15, 0.0]),
                 foot_RL=np.array([-0.25, 0.15, 0.0]), foot_RR=np.array([-0.25, -0.15, 0.0]))
    ref = dict(ref_position=np.array([0.0, 0.0, cfg.sim.ref_z]),
               ref_linear_velocity=np.zeros(3), ref_orientation=np.zeros(3),
               ref_angular_velocity=np.zeros(3),
               ref_foot_FL=state["foot_FL"][None], ref_foot_FR=state["foot_FR"][None],
               ref_foot_RL=state["foot_RL"][None], ref_foot_RR=state["foot_RR"][None])
    seq = np.ones((4, cfg.mpc.horizon))

    split = GradientMPC(cfg)
    plain = GradientMPC(cfg)
    for i in range(4):
        g_split, *_ = split.compute_control(state, ref, seq)
        assert split._prep is None  # consumed (or not yet prepared)
        prep = split.compute_rti_prepare()
        assert prep is not None
        g_plain, *_ = plain.compute_control(state, ref, seq)
        # Same stationary problem: split path must agree to solver tolerance.
        assert np.abs(g_split - g_plain).max() < 2.0, (i, g_split, g_plain)
    assert np.all(np.isfinite(g_split))
