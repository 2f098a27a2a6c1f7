"""Single-rigid-body (centroidal) dynamics — the ONE dynamics implementation.

The reference duplicates these Newton-Euler equations six times (CasADi:
controllers/gradient/nominal/centroidal_model_nominal.py:205-272 and four variant
models; JAX: controllers/sampling/centroidal_model_jax.py:93-162). Here a single pure,
batch-first jnp implementation serves the sampling rollouts, the gradient SQP's
linearization (via jax.jacfwd), and the on-device scenario simulator.

State layout (12,): [com_pos(3), com_vel(3), rpy(3), omega_body(3)].
Feet positions (4,3) and ground-reaction forces (4,3) are inputs; contact (4,) masks
stance legs. All ops broadcast over arbitrary leading batch dimensions.

Equations (matching reference centroidal_model_jax.py:93-162 exactly):
    com_acc   = (1/m) * sum_i c_i * f_i + g
    rpy_dot   = Einv(roll, pitch) @ omega
    omega_dot = I^-1 ( R_w2b @ sum_i c_i * (p_i - com) x f_i  -  omega x (I omega) )
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..utils.frames import conj_euler_rates_inv, world_to_body_rot


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SRBDParams:
    """Dynamic parameters; a pytree so it can be batched per-scenario."""

    mass: Any  # scalar
    inertia: Any  # (3,3)
    inertia_inv: Any  # (3,3)
    gravity: Any  # scalar (positive magnitude)

    def tree_flatten(self):
        return (self.mass, self.inertia, self.inertia_inv, self.gravity), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def make_params(cfg: Config, dtype=np.float32) -> SRBDParams:
    # NOTE: leaves are HOST numpy arrays. Solver factories close over these params;
    # numpy constants embed directly into the lowered program, whereas device arrays
    # would be fetched back from the accelerator during MLIR lowering.
    inertia = np.asarray(cfg.robot.inertia_matrix())
    return SRBDParams(
        mass=np.asarray(cfg.robot.mass, dtype),
        inertia=np.asarray(inertia, dtype),
        inertia_inv=np.asarray(np.linalg.inv(inertia), dtype),
        gravity=np.asarray(cfg.gravity, dtype),
    )


def fd(state, feet, forces, contact, params: SRBDParams):
    """State derivative of the SRB model.

    Args:
        state: (..., 12) [pos, vel, rpy, omega].
        feet: (..., 4, 3) foot positions in world frame.
        forces: (..., 4, 3) ground-reaction forces in world frame.
        contact: (..., 4) stance mask (1=stance, 0=swing).
        params: SRBDParams (leaves broadcastable against the batch).

    Returns:
        (..., 12) time derivative.
    """
    com = state[..., 0:3]
    vel = state[..., 3:6]
    rpy = state[..., 6:9]
    omega = state[..., 9:12]

    c = contact[..., :, None]  # (...,4,1)
    f_eff = forces * c

    g_vec = jnp.stack(
        [jnp.zeros_like(params.gravity), jnp.zeros_like(params.gravity), -params.gravity], -1
    )
    com_acc = jnp.sum(f_eff, axis=-2) / params.mass[..., None] + g_vec

    # World-frame torque about the CoM from stance feet.
    lever = feet - com[..., None, :]
    torque_w = jnp.sum(jnp.cross(lever, f_eff), axis=-2)

    roll, pitch = rpy[..., 0], rpy[..., 1]
    rpy_dot = jnp.einsum("...ij,...j->...i", conj_euler_rates_inv(roll, pitch), omega)

    b_R_w = world_to_body_rot(rpy)
    torque_b = jnp.einsum("...ij,...j->...i", b_R_w, torque_w)
    I_omega = jnp.einsum("...ij,...j->...i", params.inertia, omega)
    gyro = jnp.cross(omega, I_omega)
    omega_dot = jnp.einsum("...ij,...j->...i", params.inertia_inv, torque_b - gyro)

    return jnp.concatenate([vel, com_acc, rpy_dot, omega_dot], axis=-1)


def integrate_euler(state, feet, forces, contact, params: SRBDParams, dt):
    """Explicit Euler step (reference centroidal_model_jax.py:164-174).

    ``dt`` may be scalar or batched; feet stay static across the step (the rollout
    treats foot positions as stage parameters, as the reference does)."""
    return state + fd(state, feet, forces, contact, params) * jnp.asarray(dt)[..., None]


def integrate_rk4(state, feet, forces, contact, params: SRBDParams, dt):
    """Classic RK4 with zero-order-hold inputs; optional higher-accuracy integrator
    (the reference's gradient path offers ERK4 via acados, centroidal_nmpc_nominal.py
    solver options)."""
    dt = jnp.asarray(dt)[..., None]
    k1 = fd(state, feet, forces, contact, params)
    k2 = fd(state + 0.5 * dt * k1, feet, forces, contact, params)
    k3 = fd(state + 0.5 * dt * k2, feet, forces, contact, params)
    k4 = fd(state + dt * k3, feet, forces, contact, params)
    return state + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
