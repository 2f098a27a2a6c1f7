"""Gait-adaptive sampling MPC: in-rollout timer parity, frequency selection, and
constraint satisfaction."""
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_pympc_tamols import make_config, replace_config
from quadruped_pympc_tamols.controllers.sampling import GaitAdaptiveSamplingMPC
from quadruped_pympc_tamols.controllers.sampling.gait_adaptive import _timer_sequence


def stepwise_jax_pgg(phase0, step_freq, duty, mpc_dt, horizon):
    """Independent numpy re-implementation of PeriodicGaitGeneratorJax
    (reference helpers/periodic_gait_generator_jax.py:68-89,136-151): wrap-at-1
    before advancing; the timer advances before the first column."""
    t = np.array(phase0, np.float64)
    seq = np.zeros((4, horizon))
    for i in range(horizon):
        t = np.where(t >= 1.0, 0.0, t)
        t = t + mpc_dt * step_freq
        seq[:, i] = (t < duty).astype(float)
    return seq


def test_timer_sequence_matches_reference_semantics():
    phase0 = np.array([0.5, 1.0, 1.0, 0.5])
    for f in (1.4, 2.0, 2.4):
        got = np.asarray(_timer_sequence(jnp.asarray(phase0, jnp.float32), f, 0.65, 0.02, 12))
        want = stepwise_jax_pgg(phase0, f, 0.65, 0.02, 12)
        np.testing.assert_array_equal(got, want)


def _problem(cfg):
    state = dict(
        position=np.array([0.0, 0.0, cfg.sim.ref_z]),
        linear_velocity=np.array([0.2, 0.0, 0.0]),
        orientation=np.zeros(3), angular_velocity=np.zeros(3),
        foot_FL=np.array([0.25, 0.15, 0.0]), foot_FR=np.array([0.25, -0.15, 0.0]),
        foot_RL=np.array([-0.25, 0.15, 0.0]), foot_RR=np.array([-0.25, -0.15, 0.0]))
    ref = dict(
        ref_position=np.array([0.0, 0.0, cfg.sim.ref_z]),
        ref_linear_velocity=np.array([0.2, 0.0, 0.0]),
        ref_orientation=np.zeros(3), ref_angular_velocity=np.zeros(3),
        ref_foot_FL=state["foot_FL"], ref_foot_FR=state["foot_FR"],
        ref_foot_RL=state["foot_RL"], ref_foot_RR=state["foot_RR"])
    return state, ref


@pytest.mark.parametrize("optimize", [False, True])
def test_gait_adaptive_solver(optimize):
    cfg = make_config("aliengo", mpc_type="sampling")
    cfg = replace_config(cfg, **{"mpc.sampling.num_samples": 300,
                                 "mpc.optimize_step_freq": True})
    mpc = GaitAdaptiveSamplingMPC(cfg, seed=3)
    state, ref = _problem(cfg)
    seq = np.ones((4, cfg.mpc.horizon))
    phase = np.array([0.5, 1.0, 1.0, 0.5])
    out = mpc.compute_control(state, ref, seq, seq[:, 0], np.ones(4), phase,
                              nominal_step_frequency=1.4, optimize_swing=optimize)
    g = np.asarray(out.grfs)
    assert np.all(np.isfinite(g))
    assert np.all(g[:, 2] >= -1e-5) and np.all(g[:, 2] <= cfg.mpc.grf_max + 1e-4)
    assert np.all(np.abs(g[:, 0]) <= cfg.mpc.mu * g[:, 2] + 1e-4)
    bf = float(out.best_freq)
    if optimize:
        assert any(abs(bf - f) < 1e-5 for f in cfg.mpc.step_freq_available)
    else:
        assert abs(bf - 1.4) < 1e-5
    assert np.isfinite(float(out.best_cost))


def test_frequency_changes_cost_landscape():
    """Sanity: different candidate frequencies yield different contact patterns."""
    phase = jnp.asarray([0.5, 1.0, 1.0, 0.5], jnp.float32)
    s1 = np.asarray(_timer_sequence(phase, 1.4, 0.65, 0.02, 12))
    s2 = np.asarray(_timer_sequence(phase, 2.4, 0.65, 0.02, 12))
    assert not np.array_equal(s1, s2)
