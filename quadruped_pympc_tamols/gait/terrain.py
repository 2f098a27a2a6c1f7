"""Terrain slope/height estimation from stance-foot geometry.

Re-derivation of the reference TerrainEstimator (helpers/terrain_estimator.py:13-104):
fit roll/pitch from pairwise z-differences of the (lift-off) foot positions in the
horizontal frame, EMA-smoothed 0.99/0.01; terrain height is an EMA 0.2/0.8 of the mean
foot z. Pure function + tiny stateful wrapper.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.frames import yaw_rot3


def estimate_terrain_step(base_position, yaw, feet_pos, prev_roll, prev_pitch, prev_height,
                          roll_activated=False, pitch_activated=True):
    """One estimator update. feet_pos: (..., 4, 3) world (FL, FR, RL, RR order).

    Returns (roll, pitch, height) EMA states.
    """
    R = yaw_rot3(yaw)
    rel = jnp.einsum("...ij,...kj->...ki", R, feet_pos - base_position[..., None, :])
    fl, fr, rl, rr = rel[..., 0, :], rel[..., 1, :], rel[..., 2, :], rel[..., 3, :]

    front_diff = fl - fr
    back_diff = rl - rr
    left_diff = fl - rl
    right_diff = fr - rr

    pitch = 0.5 * (
        jnp.arctan(jnp.abs(left_diff[..., 2]) / jnp.abs(left_diff[..., 0] + 0.001))
        + jnp.arctan(jnp.abs(right_diff[..., 2]) / jnp.abs(right_diff[..., 0] + 0.001))
    )
    roll = 0.5 * (
        jnp.arctan(jnp.abs(front_diff[..., 2]) / jnp.abs(front_diff[..., 1] + 0.001))
        + jnp.arctan(jnp.abs(back_diff[..., 2]) / jnp.abs(back_diff[..., 1] + 0.001))
    )
    roll = jnp.where(front_diff[..., 2] * 0.5 + back_diff[..., 2] * 0.5 < 0, -roll, roll)
    pitch = jnp.where(left_diff[..., 2] * 0.5 + right_diff[..., 2] * 0.5 > 0, -pitch, pitch)

    new_roll = jnp.where(roll_activated, prev_roll * 0.99 + roll * 0.01, 0.0)
    new_pitch = jnp.where(pitch_activated, prev_pitch * 0.99 + pitch * 0.01, 0.0)

    z_mean = jnp.mean(feet_pos[..., 2], axis=-1)
    new_height = prev_height * 0.2 + z_mean * 0.8
    return new_roll, new_pitch, new_height


estimate_terrain = estimate_terrain_step

_estimate_jit = jax.jit(estimate_terrain_step, static_argnames=("roll_activated", "pitch_activated"))


class TerrainEstimator:
    """Stateful host wrapper mirroring the reference class."""

    def __init__(self):
        self.terrain_roll = 0.0
        self.terrain_pitch = 0.0
        self.terrain_height = 0.0
        self.roll_activated = False
        self.pitch_activated = True
        # Operator-commanded reference-pitch offset (the console's pitch commands,
        # reference ros2/console.py pitch deltas); added on top of the EMA estimate.
        self.pitch_offset = 0.0

    def compute_terrain_estimation(self, base_position, yaw, feet_pos, current_contact=None):
        import numpy as np

        # Pure numpy on the host path: this is a handful of scalar ops per tick,
        # cheaper on the host than a device dispatch and readback. The
        # jitted estimate_terrain_step stays for batched on-device use.
        from ..utils.frames import yaw_rot3_np

        feet = np.asarray(feet_pos.data if hasattr(feet_pos, "data") else feet_pos)
        R = yaw_rot3_np(yaw)
        rel = (feet - np.asarray(base_position)[None, :]) @ R.T
        fl, fr, rl, rr = rel
        front_diff, back_diff = fl - fr, rl - rr
        left_diff, right_diff = fl - rl, fr - rr
        pitch = 0.5 * (np.arctan(abs(left_diff[2]) / abs(left_diff[0] + 0.001))
                       + np.arctan(abs(right_diff[2]) / abs(right_diff[0] + 0.001)))
        roll = 0.5 * (np.arctan(abs(front_diff[2]) / abs(front_diff[1] + 0.001))
                      + np.arctan(abs(back_diff[2]) / abs(back_diff[1] + 0.001)))
        if front_diff[2] * 0.5 + back_diff[2] * 0.5 < 0:
            roll = -roll
        if left_diff[2] * 0.5 + right_diff[2] * 0.5 > 0:
            pitch = -pitch
        self.terrain_roll = float(self.terrain_roll * 0.99 + roll * 0.01) \
            if self.roll_activated else 0.0
        self.terrain_pitch = float(self.terrain_pitch * 0.99 + pitch * 0.01) \
            if self.pitch_activated else 0.0
        self.terrain_height = float(self.terrain_height * 0.2 + feet[:, 2].mean() * 0.8)
        return (self.terrain_roll, self.terrain_pitch + self.pitch_offset,
                self.terrain_height)
