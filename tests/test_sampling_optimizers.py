"""XLA sampling solver: the optimizer updates against direct formulas, the
zero-noise incumbent, chained iterations, and the gait-adaptive solver at one
fixed frequency against the plain solver. All at <= 1,024 samples."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_pympc_tamols import make_config, replace_config
from quadruped_pympc_tamols.controllers.sampling import (
    SamplingState, make_gait_adaptive_solver, make_sampling_solver)
from quadruped_pympc_tamols.controllers.sampling.sampling_mpc import (
    optimizer_update, sample_noise)
from quadruped_pympc_tamols.controllers.sampling.splines import (
    make_step_major_basis, spline_forces)

N = 513  # divisible by the three gait-adaptive frequency groups
METHODS = ["random_sampling", "mppi", "cem_mppi"]
ZERO_NOISE = {"mpc.sampling.sigma_random": (0.0, 0.0, 0.0),
              "mpc.sampling.sigma_mppi": 0.0}


def _cfg(method="random_sampling", **over):
    return replace_config(make_config("aliengo", mpc_type="sampling"),
                          **{"mpc.sampling.method": method,
                             "mpc.sampling.num_samples": N, **over})


def _tick(cfg, swing=True):
    """(state12, feet, ref12, ref_feet, seq, cur, prev): 4 cm low, asked to walk."""
    x = jnp.asarray([0.0, 0.0, cfg.sim.ref_z - 0.04, 0.1, 0, 0, 0, 0, 0, 0, 0, 0],
                    jnp.float32)
    feet = jnp.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                        [-0.25, 0.15, 0], [-0.25, -0.15, 0]], jnp.float32)
    ref = jnp.asarray([0.0, 0.0, cfg.sim.ref_z, 0.3, 0, 0, 0, 0, 0, 0, 0, 0], jnp.float32)
    seq = np.ones((4, cfg.mpc.horizon), np.float32)
    if swing:
        seq[1, 6:] = seq[2, 6:] = 0.0
    seq = jnp.asarray(seq)
    return x, feet, ref, feet, seq, seq[:, 0], seq[:, 0]


def _state(P, scale=0.0, sigma=3.0, seed=0):
    params = scale * jax.random.normal(jax.random.PRNGKey(seed + 100), (P,), jnp.float32)
    return SamplingState(params, jax.random.PRNGKey(seed), jnp.full(P, sigma, jnp.float32))


def _cost_of(cfg, tick, params):
    """Rollout cost of one parameter vector: a zero-noise solve evaluates only
    the incumbent."""
    solve, _ = make_sampling_solver(replace_config(cfg, **ZERO_NOISE), method="random_sampling")
    out, _ = solve(*tick, SamplingState(params, jax.random.PRNGKey(0), jnp.zeros_like(params)))
    return float(out.best_cost)


def _random_update_inputs(P=8, n=64, seed=0):
    rng = np.random.default_rng(seed)
    best = rng.normal(size=P)
    noise = rng.normal(size=(P, n)) * np.geomspace(0.02, 20.0, P)[:, None]
    noise[:, 0] = 0.0
    costs = rng.uniform(0.0, 6.0, n)
    return best, best[:, None] + noise, noise, costs


@pytest.mark.parametrize("method", METHODS)
def test_zero_noise_solve_returns_incumbent(method):
    cfg = _cfg(method, **ZERO_NOISE)
    solve, P = make_sampling_solver(cfg)
    st = _state(P, scale=0.5, sigma=0.0)
    out, st2 = solve(*_tick(cfg), st)
    costs = np.asarray(out.costs)
    np.testing.assert_array_equal(costs, costs[0])
    np.testing.assert_allclose(np.asarray(st2.best_parameters),
                               np.asarray(st.best_parameters), atol=1e-6)
    assert float(out.best_cost) == costs[0]


@pytest.mark.parametrize("method", METHODS)
def test_sample_noise_keeps_incumbent_column(method):
    sp = _cfg(method).mpc.sampling
    noise = np.asarray(sample_noise(sp, method, jax.random.PRNGKey(1),
                                    jnp.full(8, 2.0), 8, 97))
    assert noise.shape == (8, 97) and noise.dtype == np.float32
    np.testing.assert_array_equal(noise[:, 0], 0.0)
    assert np.all(np.std(noise[:, 1:], axis=1) > 0.1)


def test_mppi_update_is_softmax_weighted_mean():
    sp = _cfg("mppi").mpc.sampling
    best, params_vec, noise, costs = _random_update_inputs()
    sigma = jnp.ones(8, jnp.float32)
    new, new_sigma = optimizer_update(
        sp, "mppi", *(jnp.asarray(a, jnp.float32) for a in (best, params_vec, noise, costs)),
        sigma)
    w = np.exp(-(costs - costs.min()) / sp.mppi_temperature)
    w /= w.sum()
    np.testing.assert_allclose(np.asarray(new), params_vec @ w, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(new_sigma), np.asarray(sigma))


def test_cem_sigma_refit_is_clipped_elite_std():
    sp = _cfg("cem_mppi").mpc.sampling
    best, params_vec, noise, costs = _random_update_inputs(seed=1)
    _, new_sigma = optimizer_update(
        sp, "cem_mppi",
        *(jnp.asarray(a, jnp.float32) for a in (best, params_vec, noise, costs)),
        jnp.ones(8, jnp.float32))
    elite = noise[:, np.argsort(costs)[:sp.cem_elite]]
    want = np.clip(np.sqrt(np.var(elite, axis=1, ddof=1) + 1e-8),
                   sp.cem_sigma_min, sp.cem_sigma_max)
    assert want.min() == sp.cem_sigma_min and want.max() == sp.cem_sigma_max
    np.testing.assert_allclose(np.asarray(new_sigma), want, rtol=1e-5)


def test_mppi_moves_toward_lower_cost():
    cfg = _cfg("mppi")
    solve, P = make_sampling_solver(cfg)
    tick = _tick(cfg)
    st = _state(P)
    _, st2 = solve(*tick, st)
    assert _cost_of(cfg, tick, st2.best_parameters) < _cost_of(cfg, tick, st.best_parameters)


def test_cem_changes_sigma():
    cfg = _cfg("cem_mppi")
    solve, P = make_sampling_solver(cfg)
    st = _state(P, sigma=cfg.mpc.sampling.sigma_cem_mppi)
    out, st2 = solve(*_tick(cfg), st)
    sigma = np.asarray(st2.sigma)
    assert not np.allclose(sigma, np.asarray(st.sigma))
    np.testing.assert_array_equal(sigma, np.asarray(out.sigma))
    assert np.all(sigma >= cfg.mpc.sampling.cem_sigma_min)
    assert np.all(sigma <= cfg.mpc.sampling.cem_sigma_max)


def test_chained_iterations_do_not_raise_best_cost():
    """Iteration 1 of a 3-iteration solve is the 1-iteration solve (same key);
    every later iteration keeps its incumbent as column 0."""
    cfg1 = _cfg()
    cfg3 = _cfg(**{"mpc.sampling.num_iterations": 3})
    tick = _tick(cfg1)
    solve1, P = make_sampling_solver(cfg1)
    solve3, _ = make_sampling_solver(cfg3)
    out1, _ = solve1(*tick, _state(P))
    out3, st3 = solve3(*tick, _state(P))
    assert float(out3.best_cost) <= float(out1.best_cost) * (1 + 1e-6)
    np.testing.assert_allclose(_cost_of(cfg1, tick, st3.best_parameters),
                               float(out3.best_cost), rtol=1e-5)


@pytest.mark.parametrize("optimize_swing", [False, True])
def test_gait_adaptive_at_one_frequency_equals_plain_solver(optimize_swing):
    """Full stance (duty 1) and zero-order forces: the in-rollout gait timer, its
    stance counters and the traced basis reduce to the plain solver's, so the
    two solvers draw the same noise and pick the same sample; the gait-adaptive
    cost carries the constant frequency regularization on top."""
    freq = 2.0
    cfg = _cfg(**{"mpc.sampling.parametrization": "zero_order",
                  "gait_params.duty_factor": 1.0,
                  "mpc.step_freq_available": (freq,) if optimize_swing else (1.4, 2.0, 2.4)})
    x, feet, ref, ref_feet, _, _, _ = _tick(cfg)
    seq = jnp.ones((4, cfg.mpc.horizon), jnp.float32)
    ga, P = make_gait_adaptive_solver(cfg)
    plain, _ = make_sampling_solver(cfg)
    st = _state(P, scale=0.3)
    out_ga, st_ga = ga(x, feet, ref, ref_feet, jnp.zeros(4, jnp.float32), jnp.float32(freq),
                       jnp.asarray(optimize_swing), seq, seq[:, 0], seq[:, 0], st)
    out_p, st_p = plain(x, feet, ref, ref_feet, seq, seq[:, 0], seq[:, 0], st)
    assert float(out_ga.best_freq) == freq
    np.testing.assert_allclose(np.asarray(st_ga.best_parameters),
                               np.asarray(st_p.best_parameters), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_ga.grfs), np.asarray(out_p.grfs), atol=1e-4)
    reg = (freq - 1.3) ** 2 * 100.0
    np.testing.assert_allclose(float(out_ga.best_cost) - reg, float(out_p.best_cost),
                               rtol=1e-5)


def test_spline_forces_is_step_major_basis_product():
    sp = _cfg().mpc.sampling
    H = 12
    W = make_step_major_basis(sp.parametrization, H, sp.num_splines)
    params = np.random.default_rng(0).normal(size=(W.shape[1], 16)).astype(np.float32)
    raw = np.asarray(spline_forces(W, jnp.asarray(params)))
    assert raw.shape == (H, 12, 16)
    np.testing.assert_allclose(raw, (W.astype(np.float64) @ params).reshape(H, 12, 16),
                               rtol=1e-5, atol=1e-5)
