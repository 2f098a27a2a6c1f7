"""Gait-generator parity: the closed-form contact sequence must match a step-by-step
numpy re-implementation of the reference timer (periodic_gait_generator.py:48-118)."""
import jax.numpy as jnp
import numpy as np

from quadruped_pympc_tamols import GAITS, GaitType, make_config
from quadruped_pympc_tamols.config import GAIT_PHASE_OFFSETS
from quadruped_pympc_tamols.gait import (
    PeriodicGaitGenerator,
    contact_sequence,
    make_timer_dts,
)


def stepwise_reference_sequence(phase0, step_freq, duty, horizon, dt):
    """Numpy re-implementation of the reference timer loop."""
    phase = np.array(phase0, dtype=np.float64)
    seq = np.zeros((4, horizon))
    seq[:, 0] = (np.mod(phase, 1.0) < duty).astype(float)
    for i in range(1, horizon):
        phase = np.mod(phase + dt * step_freq, 1.0)
        seq[:, i] = (phase < duty).astype(float)
    return seq


def test_contact_sequence_matches_stepwise_timer():
    cfg = make_config("aliengo")
    gait = GAITS["trot"]
    t_off = make_timer_dts(cfg.mpc)
    phase0 = np.asarray(GAIT_PHASE_OFFSETS[gait.gait_type])
    got = np.asarray(
        contact_sequence(jnp.asarray(phase0), gait.step_freq, gait.duty_factor, jnp.asarray(t_off))
    )
    want = stepwise_reference_sequence(phase0, gait.step_freq, gait.duty_factor,
                                       cfg.mpc.horizon, cfg.mpc.dt)
    np.testing.assert_array_equal(got, want)


def test_all_gaits_have_valid_sequences():
    cfg = make_config("go2")
    t_off = make_timer_dts(cfg.mpc)
    for name, gait in GAITS.items():
        phase0 = jnp.asarray(GAIT_PHASE_OFFSETS[gait.gait_type])
        seq = np.asarray(
            contact_sequence(phase0, gait.step_freq, gait.duty_factor, jnp.asarray(t_off),
                             full_stance=(gait.gait_type == GaitType.FULL_STANCE))
        )
        assert seq.shape == (4, cfg.mpc.horizon)
        assert set(np.unique(seq)).issubset({0.0, 1.0})
        if gait.gait_type == GaitType.FULL_STANCE:
            assert np.all(seq == 1.0)
        else:
            # Each leg must both touch down and lift off over a few gait cycles.
            long_t = jnp.asarray(np.arange(0, 200) * cfg.mpc.dt, jnp.float32)
            seq_long = np.asarray(contact_sequence(phase0, gait.step_freq, gait.duty_factor, long_t))
            assert np.all(seq_long.sum(axis=1) > 0)
            assert np.all(seq_long.sum(axis=1) < 200)


def test_trot_diagonal_pairing():
    """In trot, FL/RR share phase and FR/RL share phase."""
    gait = GAITS["trot"]
    phase0 = jnp.asarray(GAIT_PHASE_OFFSETS[gait.gait_type])
    t = jnp.asarray(np.arange(0, 100) * 0.02, jnp.float32)
    seq = np.asarray(contact_sequence(phase0, gait.step_freq, gait.duty_factor, t))
    np.testing.assert_array_equal(seq[0], seq[3])
    np.testing.assert_array_equal(seq[1], seq[2])


def test_host_generator_runs_and_matches_pure_function():
    cfg = make_config("aliengo")
    pgg = PeriodicGaitGenerator(GAITS["trot"], cfg.mpc.horizon)
    t_off = make_timer_dts(cfg.mpc)
    # advance the timer a while
    for _ in range(123):
        pgg.run(cfg.sim.dt, pgg.step_freq)
    seq_host = pgg.compute_contact_sequence(t_off)
    seq_pure = np.asarray(
        contact_sequence(jnp.asarray(pgg.phase_signal), pgg.step_freq, pgg.duty_factor,
                         jnp.asarray(t_off))
    )
    np.testing.assert_array_equal(seq_host, seq_pure)


def test_batched_over_frequencies():
    """The gait-adaptive path needs sequences batched over candidate step freqs."""
    cfg = make_config("aliengo")
    gait = GAITS["trot"]
    t_off = jnp.asarray(make_timer_dts(cfg.mpc))
    freqs = jnp.asarray([1.4, 2.0, 2.4])
    phase0 = jnp.tile(jnp.asarray(GAIT_PHASE_OFFSETS[gait.gait_type]), (3, 1))
    seq = contact_sequence(phase0, freqs, gait.duty_factor, t_off)
    assert seq.shape == (3, 4, cfg.mpc.horizon)
    # Higher frequency → legs cycle faster → sequences differ.
    assert not np.array_equal(np.asarray(seq[0]), np.asarray(seq[2]))
