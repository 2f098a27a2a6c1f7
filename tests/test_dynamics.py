"""Golden tests of the SRB dynamics against an independent numpy re-derivation of the
reference equations (centroidal_model_jax.py:93-174 / centroidal_model_nominal.py:205-272)."""
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_pympc_tamols import make_config
from quadruped_pympc_tamols.dynamics import fd, integrate_euler, integrate_rk4, make_params


def numpy_reference_fd(state, feet, forces, contact, mass, inertia, g=9.81):
    """Independent numpy implementation of the SRB Newton-Euler equations."""
    com = state[0:3]
    vel = state[3:6]
    roll, pitch, yaw = state[6:9]
    omega = state[9:12]

    lin_acc = np.array([0.0, 0.0, -g])
    torque_w = np.zeros(3)
    for i in range(4):
        lin_acc = lin_acc + contact[i] * forces[i] / mass
        torque_w = torque_w + contact[i] * np.cross(feet[i] - com, forces[i])

    # omega = E @ rpy_dot with E from reference centroidal_model_jax.py:124-129.
    E = np.array(
        [
            [1.0, 0.0, -np.sin(pitch)],
            [0.0, np.cos(roll), np.cos(pitch) * np.sin(roll)],
            [0.0, -np.sin(roll), np.cos(pitch) * np.cos(roll)],
        ]
    )
    rpy_dot = np.linalg.solve(E, omega)

    # ZYX body-from-world rotation (reference centroidal_model_jax.py:141-155).
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    b_R_w = np.array(
        [
            [cp * cy, cp * sy, -sp],
            [sr * sp * cy - cr * sy, sr * sp * sy + cr * cy, sr * cp],
            [cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cr * cp],
        ]
    )
    omega_dot = np.linalg.solve(
        inertia, b_R_w @ torque_w - np.cross(omega, inertia @ omega)
    )
    return np.concatenate([vel, lin_acc, rpy_dot, omega_dot])


@pytest.fixture(scope="module")
def setup():
    cfg = make_config("aliengo")
    params = make_params(cfg)
    rng = np.random.default_rng(0)
    state = rng.normal(0, 0.3, 12)
    state[2] = 0.35
    feet = rng.normal(0, 0.3, (4, 3))
    forces = rng.normal(0, 40.0, (4, 3))
    contact = np.array([1.0, 0.0, 1.0, 1.0])
    return cfg, params, state, feet, forces, contact


def test_fd_matches_reference_equations(setup):
    cfg, params, state, feet, forces, contact = setup
    got = np.asarray(fd(jnp.asarray(state, jnp.float32), jnp.asarray(feet, jnp.float32),
                        jnp.asarray(forces, jnp.float32), jnp.asarray(contact, jnp.float32),
                        params))
    want = numpy_reference_fd(state, feet, forces, contact,
                              cfg.robot.mass, cfg.robot.inertia_matrix())
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fd_batched_broadcasts(setup):
    _, params, state, feet, forces, contact = setup
    B = 7
    states = jnp.asarray(np.tile(state, (B, 1)), jnp.float32)
    feet_b = jnp.asarray(np.tile(feet, (B, 1, 1)), jnp.float32)
    forces_b = jnp.asarray(np.tile(forces, (B, 1, 1)), jnp.float32)
    out = fd(states, feet_b, forces_b, jnp.asarray(contact, jnp.float32), params)
    assert out.shape == (B, 12)
    np.testing.assert_allclose(out[0], out[5], rtol=1e-6)


def test_euler_integration(setup):
    cfg, params, state, feet, forces, contact = setup
    dt = 0.02
    nxt = np.asarray(integrate_euler(
        jnp.asarray(state, jnp.float32), jnp.asarray(feet, jnp.float32),
        jnp.asarray(forces, jnp.float32), jnp.asarray(contact, jnp.float32), params, dt))
    want = state + numpy_reference_fd(state, feet, forces, contact,
                                      cfg.robot.mass, cfg.robot.inertia_matrix()) * dt
    np.testing.assert_allclose(nxt, want, rtol=3e-4, atol=3e-4)


def test_rk4_beats_euler_accuracy(setup):
    cfg, params, state, feet, forces, contact = setup
    s = jnp.asarray(state, jnp.float32)
    f = jnp.asarray(feet, jnp.float32)
    u = jnp.asarray(forces, jnp.float32)
    c = jnp.asarray(contact, jnp.float32)
    dt = 0.02
    # Fine-step Euler as ground truth.
    ref = s
    n = 200
    for _ in range(n):
        ref = integrate_euler(ref, f, u, c, params, dt / n)
    e1 = np.linalg.norm(np.asarray(integrate_euler(s, f, u, c, params, dt)) - np.asarray(ref))
    e4 = np.linalg.norm(np.asarray(integrate_rk4(s, f, u, c, params, dt)) - np.asarray(ref))
    assert e4 <= e1 + 1e-5


def test_gravity_only_freefall(setup):
    _, params, state, feet, forces, _ = setup
    c0 = jnp.zeros(4)
    out = np.asarray(fd(jnp.asarray(state, jnp.float32), jnp.asarray(feet, jnp.float32),
                        jnp.asarray(forces, jnp.float32), c0, params))
    np.testing.assert_allclose(out[3:6], [0, 0, -9.81], atol=1e-5)
