"""Analytic 3-DoF quadruped leg kinematics in JAX.

The reference solves IK numerically with damped least squares over MuJoCo FK
(helpers/inverse_kinematics/inverse_kinematics_numeric_mujoco.py:34-122, 5 iterations
per control step, crossing the Python<->C boundary each iteration). A standard
quadruped leg (hip-roll, hip-pitch, knee-pitch with an abduction offset) has a closed
form, so we use analytic FK/IK — branch-free, batched over legs and scenarios,
and differentiable (the Jacobian is one jacfwd away).

Leg model (hip frame, x forward, y left, z up; all legs identical up to the side sign
of the abduction offset d):
    p = Rx(q1) @ ([0, d, 0] + Ry(q2) @ [0, 0, -l3] + Ry(q2) @ Ry(q3) @ [0, 0, -l4]),
    x = -l3 sin(q2) - l4 sin(q2 + q3)
    y = d cos(q1) + E sin(q1)
    z = d sin(q1) - E cos(q1),    E = l3 cos(q2) + l4 cos(q2 + q3).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RobotParams

# Abduction offset side signs (FL, FR, RL, RR): left +, right -.
SIDE_SIGN = np.array([1.0, -1.0, 1.0, -1.0], dtype=np.float32)


class LegKinematics:
    """Per-leg FK/IK/Jacobian; all methods broadcast over leading batch dims."""

    def __init__(self, robot: RobotParams):
        self.d_abd = robot.hip_offset_y
        self.l3 = robot.thigh_length
        self.l4 = robot.calf_length
        # Per-joint (lo, hi) limits: IK solutions are clamped into them so an
        # out-of-reach target saturates at the joint stops instead of the
        # kinematic singularity. A straight-knee target (q3 -> 0) at the reach
        # boundary sends the swing PD through the singularity and flings the leg
        # (observed on go1, whose short legs hit the boundary most often).
        self.q_lo = np.array([lim[0] for lim in robot.joint_limits], np.float32)
        self.q_hi = np.array([lim[1] for lim in robot.joint_limits], np.float32)
        # Hip joint positions in the base frame (4, 3).
        self.hip_offsets_b = np.array(
            [
                [robot.hip_x, robot.hip_y, 0.0],
                [robot.hip_x, -robot.hip_y, 0.0],
                [-robot.hip_x, robot.hip_y, 0.0],
                [-robot.hip_x, -robot.hip_y, 0.0],
            ],
            dtype=np.float32,
        )
        self._jac = jax.jit(jax.vmap(self._jac_single))
        self._fk_all = jax.jit(jax.vmap(self.fk, in_axes=(0, 0)))
        self._ik_all = jax.jit(jax.vmap(self.ik, in_axes=(0, 0)))

    # -- single leg ---------------------------------------------------------
    def fk(self, q, side_sign):
        """q (..., 3) joint angles -> foot position in the hip frame (..., 3)."""
        d = self.d_abd * side_sign
        q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
        s1, c1 = jnp.sin(q1), jnp.cos(q1)
        s2, c2 = jnp.sin(q2), jnp.cos(q2)
        s23, c23 = jnp.sin(q2 + q3), jnp.cos(q2 + q3)
        E = self.l3 * c2 + self.l4 * c23
        x = -self.l3 * s2 - self.l4 * s23
        y = d * c1 + E * s1
        z = d * s1 - E * c1
        return jnp.stack([x, y, z], axis=-1)

    def ik(self, p, side_sign):
        """Foot position in the hip frame (..., 3) -> joint angles (..., 3).

        Closed form; the target is clamped to the reachable annulus, mirroring the
        saturation role of the reference's damped iterations."""
        d = self.d_abd * side_sign
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        l3, l4 = self.l3, self.l4

        yz2 = y * y + z * z
        E2 = jnp.maximum(yz2 - d * d, 1e-9)
        E = jnp.sqrt(E2)
        q1 = jnp.arctan2(z, y) + jnp.arctan2(E, d * jnp.ones_like(E))
        q1 = jnp.arctan2(jnp.sin(q1), jnp.cos(q1))  # wrap to (-pi, pi]

        r2 = x * x + E2
        r2 = jnp.clip(r2, (l3 - l4) ** 2 + 1e-9, (l3 + l4) ** 2 - 1e-9)
        cos_knee = (r2 - l3 * l3 - l4 * l4) / (2 * l3 * l4)
        q3 = -jnp.arccos(jnp.clip(cos_knee, -1.0, 1.0))  # knee bends backward
        # q2 from the in-plane 2-link (sagittal target (x, -E)):
        # q2 = atan2(-x, E) + atan2(l4 sin(-q3), l3 + l4 cos(-q3)).
        alpha = jnp.arctan2(-x, E)
        beta = jnp.arctan2(l4 * jnp.sin(-q3), l3 + l4 * jnp.cos(-q3))
        q2 = alpha + beta
        q = jnp.stack([q1, q2, q3], axis=-1)
        return jnp.clip(q, self.q_lo, self.q_hi)

    def _jac_single(self, q, side_sign):
        return jax.jacfwd(lambda qq: self.fk(qq, side_sign))(q)

    # -- all legs -----------------------------------------------------------
    def fk_all(self, q_legs):
        """(4, 3) joints -> (4, 3) hip-frame foot positions."""
        return self._fk_all(q_legs, jnp.asarray(SIDE_SIGN))

    def ik_all(self, p_legs):
        return self._ik_all(p_legs, jnp.asarray(SIDE_SIGN))

    def jacobians(self, q_legs):
        """(4, 3) joints -> (4, 3, 3) hip-frame foot Jacobians."""
        return self._jac(q_legs, jnp.asarray(SIDE_SIGN))

    # -- world-frame helpers --------------------------------------------------
    def hips_world(self, base_pos, R_b2w):
        """(3,), (3,3) -> (4, 3) hip positions in world."""
        return base_pos + self.hip_offsets_b @ R_b2w.T

    def ik_world(self, feet_world, base_pos, R_b2w):
        """World-frame foot targets -> joint angles (uses rigid base pose)."""
        hips = self.hips_world(base_pos, R_b2w)
        p_hip = jnp.einsum("ij,lj->li", R_b2w.T, feet_world - hips)
        return self.ik_all(p_hip)

    # -- numpy host twins ------------------------------------------------------
    # Per-tick IK is ~100 scalar FLOPs; on an accelerator a chain of (4,3)-shaped
    # trig ops is latency-bound, so the control loop computes it on the host (zero
    # round trips).
    def ik_all_np(self, p_legs):
        """numpy twin of ik_all: (4, 3) hip-frame targets -> (4, 3) joints."""
        p = np.asarray(p_legs, np.float64)
        d = self.d_abd * SIDE_SIGN.astype(np.float64)
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        l3, l4 = self.l3, self.l4
        yz2 = y * y + z * z
        E2 = np.maximum(yz2 - d * d, 1e-9)
        E = np.sqrt(E2)
        q1 = np.arctan2(z, y) + np.arctan2(E, d)
        q1 = np.arctan2(np.sin(q1), np.cos(q1))
        r2 = np.clip(x * x + E2, (l3 - l4) ** 2 + 1e-9, (l3 + l4) ** 2 - 1e-9)
        cos_knee = (r2 - l3 * l3 - l4 * l4) / (2 * l3 * l4)
        q3 = -np.arccos(np.clip(cos_knee, -1.0, 1.0))
        alpha = np.arctan2(-x, E)
        beta = np.arctan2(l4 * np.sin(-q3), l3 + l4 * np.cos(-q3))
        q2 = alpha + beta
        q = np.stack([q1, q2, q3], axis=1)
        return np.clip(q, self.q_lo[None, :], self.q_hi[None, :])

    def ik_world_np(self, feet_world, base_pos, R_b2w):
        """numpy twin of ik_world."""
        hips = np.asarray(base_pos) + self.hip_offsets_b @ np.asarray(R_b2w).T
        p_hip = (np.asarray(feet_world) - hips) @ np.asarray(R_b2w)
        return self.ik_all_np(p_hip)

    def compute_solution(self, base_pos, base_rpy, des_foot_FL, des_foot_FR,
                         des_foot_RL, des_foot_RR):
        """Reference-compatible entry (inverse_kinematics_numeric_mujoco.py
        compute_solution): returns the 12-vector of joint targets. Pure host numpy
        (per-tick path; see ik_all_np)."""
        from ..utils.frames import euler_xyz_to_rot_np

        R = euler_xyz_to_rot_np(np.asarray(base_rpy))
        feet = np.stack([np.asarray(des_foot_FL).reshape(3),
                         np.asarray(des_foot_FR).reshape(3),
                         np.asarray(des_foot_RL).reshape(3),
                         np.asarray(des_foot_RR).reshape(3)])
        return self.ik_world_np(feet, np.asarray(base_pos), R).reshape(12)
