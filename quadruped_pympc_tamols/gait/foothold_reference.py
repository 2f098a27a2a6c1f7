"""Raibert-style reference foothold generation, vectorized over legs.

Re-derivation of the reference FootholdReferenceGenerator
(helpers/foothold_reference_generator.py:53-199): footholds are placed under the hips
in the yaw-aligned horizontal frame, pushed forward by half a stance time of desired
velocity (clipped to 1.5*hip_height) plus a capture-point-like correction
sqrt(h/g)*(v_avg - v_ref) clipped to ±5 cm, then rotated back to world. The z comes
from the per-leg lift-off height. All of it is a single batched jnp function here.
"""
from __future__ import annotations

import collections

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GRAVITY, GaitType
from ..utils.frames import (
    euler_xyz_to_rot,
    euler_xyz_to_rot_np,
    yaw_rot2,
    yaw_rot3,
    yaw_rot3_np,
)
from ..utils.legs import Legs

# Stance-width y offset signs per leg (FL, FR, RL, RR): left legs widen +, right legs -.
# (reference foothold_reference_generator.py:126-129)
_Y_OFFSET_SIGN = np.array([1.0, -1.0, 1.0, -1.0], dtype=np.float32)


import functools


@functools.partial(jax.jit, static_argnames=("hip_offset",))
def _raibert_jit(*args, **kw):
    return raibert_footholds(*args, **kw)


def raibert_footholds(
    base_pos,  # (..., 3)
    base_rpy,  # (..., 3)
    base_vel_mavg_xy_h,  # (..., 2) moving-average base velocity, horizontal frame
    ref_base_vel_xy,  # (..., 2) desired velocity, world frame
    hips_pos,  # (..., 4, 3) world
    liftoff_z,  # (..., 4) per-leg lift-off heights
    stance_time,  # scalar
    hip_height,  # scalar
    com_height_nominal,  # scalar
    hip_offset: float = 0.1,
    com_pos_offset_b=None,  # (..., 3) manual CoM offset in base frame (hack in reference :32)
    gravity: float = GRAVITY,
):
    """Returns reference footholds (..., 4, 3) in the world frame."""
    yaw = base_rpy[..., 2]
    R2 = yaw_rot2(yaw)  # world->horizontal

    ref_vel_h = jnp.einsum("...ij,...j->...i", R2, ref_base_vel_xy)

    delta_ref_h = jnp.clip(0.5 * stance_time * ref_vel_h, -1.5 * hip_height, 1.5 * hip_height)
    err_comp = jnp.sqrt(com_height_nominal / gravity) * (base_vel_mavg_xy_h - ref_vel_h)
    err_comp = jnp.clip(err_comp, -0.05, 0.05)

    hips_h = jnp.einsum("...ij,...kj->...ki", R2, hips_pos[..., :2] - base_pos[..., None, :2])
    feet_h = hips_h.at[..., 1].add(hip_offset * _Y_OFFSET_SIGN)
    feet_h = feet_h + delta_ref_h[..., None, :] + err_comp[..., None, :]

    feet_w_xy = (
        jnp.einsum("...ji,...kj->...ki", R2, feet_h) + base_pos[..., None, :2]
    )
    if com_pos_offset_b is not None:
        R_b2w = euler_xyz_to_rot(base_rpy)
        off_w = jnp.einsum("...ij,...j->...i", R_b2w, com_pos_offset_b)
        feet_w_xy = feet_w_xy + off_w[..., None, :2]

    return jnp.concatenate([feet_w_xy, liftoff_z[..., :, None]], axis=-1)


class FootholdReferenceGenerator:
    """Stateful host wrapper: tracks lift-off/touch-down positions across contact
    transitions and the base-velocity moving average, then calls the pure kernel.

    Mirrors reference FootholdReferenceGenerator (foothold_reference_generator.py:14-199).
    """

    def __init__(self, stance_time: float, lift_off_positions: Legs, hip_height: float,
                 vel_moving_average_length: int = 20):
        self.stance_time = stance_time
        self.hip_height = hip_height
        self.hip_offset = 0.1
        self.base_vel_hist = collections.deque(maxlen=vel_moving_average_length)
        self.lift_off_positions = Legs(np.asarray(lift_off_positions.data, np.float64).copy())
        self.touch_down_positions = Legs(np.asarray(lift_off_positions.data, np.float64).copy())
        self.lift_off_positions_h = Legs(np.asarray(lift_off_positions.data, np.float64).copy())
        self.touch_down_positions_h = Legs(np.asarray(lift_off_positions.data, np.float64).copy())
        self.com_pos_offset_b = np.zeros(3)
        self.com_pos_offset_w = np.zeros(3)
        self.last_reference_footholds = Legs.zeros((3,))

    def compute_footholds_reference(
        self, base_position, base_ori_euler_xyz, base_xy_lin_vel, ref_base_xy_lin_vel,
        hips_position: Legs, com_height_nominal: float,
    ) -> Legs:
        yaw = base_ori_euler_xyz[2]
        R2 = np.array([[np.cos(yaw), np.sin(yaw)], [-np.sin(yaw), np.cos(yaw)]])
        self.base_vel_hist.append(R2 @ np.asarray(base_xy_lin_vel))
        vel_mavg_h = np.mean(self.base_vel_hist, axis=0)

        # numpy twin of raibert_footholds: a dozen scalar-sized ops per tick, cheaper
        # on the host than a device dispatch and readback. The jitted kernel
        # stays for batched on-device use (parallel/scenario_engine.py).
        ref_vel_h = R2 @ np.asarray(ref_base_xy_lin_vel)
        delta_ref_h = np.clip(0.5 * self.stance_time * ref_vel_h,
                              -1.5 * self.hip_height, 1.5 * self.hip_height)
        err_comp = np.clip(np.sqrt(com_height_nominal / 9.81) * (vel_mavg_h - ref_vel_h),
                           -0.05, 0.05)
        hips = np.asarray(hips_position.data)
        hips_h = (hips[:, :2] - np.asarray(base_position)[None, :2]) @ R2.T
        feet_h = hips_h.copy()
        feet_h[:, 1] += self.hip_offset * _Y_OFFSET_SIGN
        feet_h += delta_ref_h[None, :] + err_comp[None, :]
        feet_w_xy = feet_h @ R2 + np.asarray(base_position)[None, :2]
        off_w = euler_xyz_to_rot_np(base_ori_euler_xyz) @ np.asarray(self.com_pos_offset_b)
        feet_w_xy = feet_w_xy + off_w[None, :2]
        liftoff_z = np.asarray(self.lift_off_positions.data)[:, 2]
        ref = Legs(np.concatenate([feet_w_xy, liftoff_z[:, None]], axis=1))
        # numpy on purpose: eager jnp here costs device round trips per tick.
        self.com_pos_offset_w = euler_xyz_to_rot_np(base_ori_euler_xyz) @ \
            np.asarray(self.com_pos_offset_b)
        self.last_reference_footholds = Legs(ref.data.copy())
        return ref

    def _yaw3(self, base_ori_euler_xyz):
        return yaw_rot3_np(base_ori_euler_xyz[2])

    def update_lift_off_positions(self, previous_contact, current_contact, feet_pos: Legs,
                                  gait_type, base_position, base_ori_euler_xyz):
        """Track lift-off points: freeze at stance->swing edges; while in swing, keep
        the horizontal-frame point rigidly attached to the moving base
        (reference foothold_reference_generator.py:159-178)."""
        R = self._yaw3(base_ori_euler_xyz)
        lo = np.asarray(self.lift_off_positions.data)
        lo_h = np.asarray(self.lift_off_positions_h.data)
        feet = np.asarray(feet_pos.data)
        for leg in range(4):
            if gait_type == GaitType.FULL_STANCE:
                lo[leg] = feet[leg]
            elif previous_contact[leg] == 1 and current_contact[leg] == 0:
                lo[leg] = feet[leg]
                lo_h[leg] = R @ (lo[leg] - base_position)
            elif previous_contact[leg] == 0 and current_contact[leg] == 0:
                lo[leg] = R.T @ lo_h[leg] + base_position
        self.lift_off_positions = Legs(lo)
        self.lift_off_positions_h = Legs(lo_h)

    def update_touch_down_positions(self, previous_contact, current_contact, feet_pos: Legs,
                                    gait_type, base_position, base_ori_euler_xyz):
        """Symmetric tracking for touch-down points
        (reference foothold_reference_generator.py:180-199)."""
        R = self._yaw3(base_ori_euler_xyz)
        td = np.asarray(self.touch_down_positions.data)
        td_h = np.asarray(self.touch_down_positions_h.data)
        feet = np.asarray(feet_pos.data)
        for leg in range(4):
            if gait_type == GaitType.FULL_STANCE:
                td[leg] = feet[leg]
            elif previous_contact[leg] == 0 and current_contact[leg] == 1:
                td[leg] = feet[leg]
                td_h[leg] = R @ (td[leg] - base_position)
            elif previous_contact[leg] == 1 and current_contact[leg] == 1:
                td[leg] = R.T @ td_h[leg] + base_position
        self.touch_down_positions = Legs(td)
        self.touch_down_positions_h = Legs(td_h)
