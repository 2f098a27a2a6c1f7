"""Swing-foot trajectory generation and Cartesian tracking control.

Three generators mirror the reference's options (helpers/swing_trajectory_controller.py
:15-23):

* ``bezier_ref`` (default): 6th-degree Bezier with P0=P1=P2=lift_off and
  P4=P5=P6=touch_down (zero velocity/acceleration at both ends) and P3 solved so the
  curve midpoint reaches max(z0, zf) + step_height (reference
  swing_generators/bezier_ref_swing_trajectory_generator.py:62-122). Implemented as a
  closed-form batched jnp function — one call evaluates all legs (and batches).
* ``explicit``: two chained cubic Beziers with a step-height apex (reference
  swing_generators/explicit_swing_trajectory_generator.py:57-74).
* ``scipy``: 5-waypoint clamped cubic spline with reflex re-planning from the contact
  hitpoint with a raised apex (reference
  swing_generators/scipy_swing_trajectory_generator.py:25-91).

The Cartesian swing tracking law matches the reference
(swing_trajectory_controller.py:83-91):
    tau = J^T (Kp e_p + Kd e_v) [+ M J^+ (a_des - Jdot qdot) + h].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Binomial coefficients of the degree-6 Bernstein basis.
_C6 = np.array([1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0], dtype=np.float32)


def _bernstein6(s):
    """(..., 7) basis, plus first and second derivatives w.r.t. s."""
    s = jnp.asarray(s)
    i = jnp.arange(7, dtype=s.dtype)
    si = s[..., None] ** i
    ti = (1.0 - s[..., None]) ** (6 - i)
    b = _C6 * si * ti
    # d/ds [C s^i (1-s)^(6-i)] = C [i s^(i-1)(1-s)^(6-i) - (6-i) s^i (1-s)^(5-i)]
    s_ = s[..., None]
    si_m1 = jnp.where(i > 0, s_ ** jnp.maximum(i - 1, 0), 0.0)
    ti_m1 = jnp.where(i < 6, (1.0 - s_) ** jnp.maximum(5 - i, 0), 0.0)
    db = _C6 * (i * si_m1 * ti - (6 - i) * si * ti_m1)
    si_m2 = jnp.where(i > 1, s_ ** jnp.maximum(i - 2, 0), 0.0)
    ti_m2 = jnp.where(i < 5, (1.0 - s_) ** jnp.maximum(4 - i, 0), 0.0)
    d2b = _C6 * (
        i * (i - 1) * si_m2 * ti
        - 2 * i * (6 - i) * si_m1 * ti_m1
        + (6 - i) * (5 - i) * si * ti_m2
    )
    return b, db, d2b


def bezier_swing_refs(swing_time, swing_period, step_height, lift_off, touch_down,
                      liftoff_boost: float = 0.0, v0=None, v0_mask=None):
    """Desired foot (pos, vel, acc) on the degree-6 Bezier swing curve.

    Args:
        swing_time: (...,) current time within the swing phase.
        swing_period: scalar total swing duration.
        step_height: scalar apex height above max(lift_off_z, touch_down_z).
        lift_off: (..., 3), touch_down: (..., 3).
        liftoff_boost: raise P1/P2 by (boost/2, boost)*step_height above P0 so the
            foot leaves the ground with an UPWARD initial velocity instead of the
            reference's v=a=0 clamp — on sparse terrain the zero-velocity start
            drags the toe at stone-top height across the stone's own far rim
            (measured ~7 cm z tracking lag in early swing). P3 is compensated so
            the apex height stays exactly step_height. 0 = reference parity.
        v0: optional (..., 3) INITIAL VELOCITY of the curve — velocity-matched
            re-planning (a planner retarget mid-swing otherwise commands an
            instantaneous velocity step, and the discontinuity flings the foot
            at the calibrated swing gains; round-4 chasm postmortem). Where
            ``v0_mask`` is set it replaces the boost-derived start (P1 = P0 +
            v0 T/6, P2 = P0 + v0 T/3: v(0) = v0, a(0) = 0), with the same
            midpoint compensation so the apex height is preserved.
        v0_mask: (...,) 1.0 where ``v0`` applies, 0.0 for the boost start.

    Returns:
        (pos, vel, acc), each (..., 3). Broadcasts over legs/batches.
    """
    s = jnp.clip(swing_time / swing_period, 0.0, 1.0)
    p0 = lift_off
    pf = touch_down

    # step_height may be scalar or per-leg (...,) (the fleet's reflex analogue
    # raises individual legs' apexes); keep the boost terms broadcast-safe.
    d = jnp.asarray(liftoff_boost * step_height, jnp.float32)
    up = jnp.zeros_like(p0).at[..., 2].set(1.0)
    # e = v(0) * T: the boost start is e = 3 d z_hat (v(0) = 6 (P1 - P0)/T).
    e = 3.0 * d[..., None] * up
    if v0 is not None:
        e_v = v0 * jnp.asarray(swing_period)[..., None]
        m = jnp.asarray(v0_mask)[..., None]
        e = m * e_v + (1.0 - m) * e
    z_mid = jnp.maximum(p0[..., 2], pf[..., 2]) + step_height
    # Midpoint: z(0.5) = (p0 + 6 p1 + 15 p2 + 20 p3 + 22 pf)/64 with the shifted
    # P1/P2 contributing an extra 6 e_z/64 — folded into p3_z.
    p3_z = (64.0 * z_mid - 22.0 * p0[..., 2] - 22.0 * pf[..., 2]) / 20.0 \
        - 6.0 * e[..., 2] / 20.0
    p3 = jnp.concatenate(
        [0.5 * (p0[..., :2] + pf[..., :2]), p3_z[..., None]], axis=-1
    )
    p1 = p0 + e / 6.0
    p2 = p0 + e / 3.0
    # Control points (..., 7, 3): [p0, p1, p2, p3, pf, pf, pf]
    cp = jnp.stack([p0, p1, p2, p3, pf, pf, pf], axis=-2)

    b, db, d2b = _bernstein6(s)
    period = jnp.asarray(swing_period)[..., None]  # per-leg periods broadcast
    pos = jnp.einsum("...i,...ij->...j", b, cp)
    vel = jnp.einsum("...i,...ij->...j", db, cp) / period
    acc = jnp.einsum("...i,...ij->...j", d2b, cp) / (period**2)
    return pos, vel, acc


def _cubic_bezier(p0, pf, t):
    """Cubic Bezier with zero end velocities; returns (pos, vel, acc) at t in [0,1]."""
    d = pf - p0
    b = t * t * (3.0 - 2.0 * t)
    db = 6.0 * t * (1.0 - t)
    d2b = 6.0 - 12.0 * t
    return p0 + d * b[..., None], d * db[..., None], d * d2b[..., None]


def explicit_swing_refs(swing_time, swing_period, step_height, lift_off, touch_down):
    """Two chained cubic Beziers: up to the apex in the first half, down in the second
    (reference explicit_swing_trajectory_generator.py:57-74)."""
    half = swing_period / 2.0
    apex = jnp.concatenate(
        [
            0.5 * (lift_off[..., :2] + touch_down[..., :2]),
            (jnp.maximum(lift_off[..., 2], touch_down[..., 2]) + step_height)[..., None],
        ],
        axis=-1,
    )
    t = jnp.clip(swing_time, 0.0, swing_period)
    first = t < half
    t1 = jnp.clip(t / half, 0.0, 1.0)
    t2 = jnp.clip((t - half) / half, 0.0, 1.0)
    p_up, v_up, a_up = _cubic_bezier(lift_off, apex, t1)
    p_dn, v_dn, a_dn = _cubic_bezier(apex, touch_down, t2)
    f = first[..., None]
    pos = jnp.where(f, p_up, p_dn)
    vel = jnp.where(f, v_up, v_dn) / half
    acc = jnp.where(f, a_up, a_dn) / (half * half)
    return pos, vel, acc


bezier_swing_refs_jit = jax.jit(bezier_swing_refs)
explicit_swing_refs_jit = jax.jit(explicit_swing_refs)


def _bernstein6_np(s):
    """numpy twin of _bernstein6; s (...,) -> (b, db, d2b) each (..., 7)."""
    i = np.arange(7, dtype=np.float64)
    s_ = np.asarray(s, np.float64)[..., None]
    si = s_ ** i
    ti = (1.0 - s_) ** (6 - i)
    b = _C6 * si * ti
    si_m1 = np.where(i > 0, s_ ** np.maximum(i - 1, 0), 0.0)
    ti_m1 = np.where(i < 6, (1.0 - s_) ** np.maximum(5 - i, 0), 0.0)
    db = _C6 * (i * si_m1 * ti - (6 - i) * si * ti_m1)
    si_m2 = np.where(i > 1, s_ ** np.maximum(i - 2, 0), 0.0)
    ti_m2 = np.where(i < 5, (1.0 - s_) ** np.maximum(4 - i, 0), 0.0)
    d2b = _C6 * (i * (i - 1) * si_m2 * ti - 2 * i * (6 - i) * si_m1 * ti_m1
                 + (6 - i) * (5 - i) * si * ti_m2)
    return b, db, d2b


def swing_refs_np(generator, swing_time, swing_period, step_height, lift_off,
                  touch_down, liftoff_boost: float = 0.0, v0=None, v0_mask=None):
    """numpy host twin of bezier/explicit swing refs, vectorized over legs.

    The per-tick swing math is ~1k scalar FLOPs; on an accelerator a chain of
    (4,3)-shaped ops is bound by per-op latency, so the host computes it with zero
    device round trips. All args (4,)/(4,3); per-leg periods supported.
    ``v0``/``v0_mask`` (4, 3)/(4,): velocity-matched curve starts per leg (see
    bezier_swing_refs).
    """
    t = np.asarray(swing_time, np.float64)
    period = np.asarray(swing_period, np.float64)
    sh = np.asarray(step_height, np.float64)
    p0 = np.asarray(lift_off, np.float64)
    pf = np.asarray(touch_down, np.float64)
    if generator == "explicit":
        half = period / 2.0
        apex = np.concatenate(
            [0.5 * (p0[:, :2] + pf[:, :2]),
             (np.maximum(p0[:, 2], pf[:, 2]) + sh)[:, None]], axis=1)
        tc = np.clip(t, 0.0, period)
        first = tc < half
        t1 = np.clip(tc / half, 0.0, 1.0)
        t2 = np.clip((tc - half) / half, 0.0, 1.0)

        def cb(a, b, tt):
            d = b - a
            bb = tt * tt * (3.0 - 2.0 * tt)
            return (a + d * bb[:, None], d * (6.0 * tt * (1.0 - tt))[:, None],
                    d * (6.0 - 12.0 * tt)[:, None])
        pu, vu, au = cb(p0, apex, t1)
        pd_, vd, ad = cb(apex, pf, t2)
        f = first[:, None]
        return (np.where(f, pu, pd_), np.where(f, vu, vd) / half[..., None],
                np.where(f, au, ad) / (half * half)[..., None])
    s = np.clip(t / period, 0.0, 1.0)
    d = liftoff_boost * sh
    up = np.zeros_like(p0)
    up[:, 2] = 1.0
    # e = v(0) * T; boost start is e = 3 d z_hat (see bezier_swing_refs).
    e = (3.0 * d * up if np.ndim(d) == 0 else 3.0 * d[:, None] * up)
    if v0 is not None:
        m = np.asarray(v0_mask, np.float64)[:, None]
        e = m * (np.asarray(v0, np.float64) * period[..., None]) + (1.0 - m) * e
    z_mid = np.maximum(p0[:, 2], pf[:, 2]) + sh
    p3_z = (64.0 * z_mid - 22.0 * p0[:, 2] - 22.0 * pf[:, 2]) / 20.0 - 6.0 * e[:, 2] / 20.0
    p3 = np.concatenate([0.5 * (p0[:, :2] + pf[:, :2]), p3_z[:, None]], axis=1)
    p1 = p0 + e / 6.0
    p2 = p0 + e / 3.0
    cp = np.stack([p0, p1, p2, p3, pf, pf, pf], axis=1)  # (4, 7, 3)
    b, db, d2b = _bernstein6_np(s)
    pos = np.einsum("li,lij->lj", b, cp)
    vel = np.einsum("li,lij->lj", db, cp) / period[..., None]
    acc = np.einsum("li,lij->lj", d2b, cp) / (period ** 2)[..., None]
    return pos, vel, acc


def make_swing_ik_step(robot, generator: str = "bezier_ref"):
    """One fused per-control-step kernel: all-leg swing references + whole-body IK.

    The unfused path dispatches one device call per swing leg plus eager jnp ops for
    the IK (3+ host->device round trips per 2 ms step — fatal for the 500 Hz
    real-robot budget, ros2/run_controller.py:85-91). This returns a single jitted
    function:

        step(t, period, step_h, lift_off, touch_down, swing_mask, stance_des,
             base_pos, base_rpy) -> (des_pos (4,3), des_vel, des_acc, des_q (4,3))

    where per-leg reflex re-planning is expressed by the (host-adjusted) t/period/
    step_h/lift_off arrays, swing_mask selects swing legs, and stance legs pass
    their foothold through to the IK.
    """
    from ..kinematics.leg_ik import LegKinematics
    from ..utils.frames import euler_xyz_to_rot

    kin = LegKinematics(robot)
    refs_fn = explicit_swing_refs if generator == "explicit" else bezier_swing_refs
    v_refs = jax.vmap(refs_fn)

    def step(t, period, step_h, lift_off, touch_down, swing_mask, stance_des,
             base_pos, base_rpy):
        pos, vel, acc = v_refs(t, period, step_h, lift_off, touch_down)
        m = swing_mask[:, None]
        des_pos = m * pos + (1.0 - m) * stance_des
        des_vel = m * vel
        des_acc = m * acc
        R = euler_xyz_to_rot(base_rpy)
        des_q = kin.ik_world(des_pos, base_pos, R)
        return des_pos, des_vel, des_acc, des_q

    return jax.jit(step)


def swing_cartesian_torque(des_pos, des_vel, des_acc, foot_pos, foot_vel, J, J_dot,
                           q_dot, h, mass_matrix, kp, kd,
                           feedback_linearization=True):
    """Cartesian swing-tracking torque for ONE leg (numpy, host path).

    tau = J^T (Kp e_p + Kd e_v) [+ M J^+ (a_des + Kp e_p + Kd e_v - J_dot q_dot) + h]
    (reference swing_trajectory_controller.py:83-91). Single source for both the
    per-leg controller method and the whole-body fused host path."""
    e_p = np.asarray(des_pos).reshape(3) - np.asarray(foot_pos).reshape(3)
    e_v = np.asarray(des_vel).reshape(3) - np.asarray(foot_vel).reshape(3)
    fb = kp * e_p + kd * e_v
    Jm = np.asarray(J)
    tau = Jm.T @ fb
    if feedback_linearization:
        acc = np.asarray(des_acc).reshape(3) + fb
        # Damped least-squares inverse: near a singular leg pose (straight or
        # fully folded — routine when stepping between stone tops and the deck)
        # the exact pinv explodes and the resulting torque spike slams the
        # joints to their limits (measured: calf driven to -2.7 rad mid-swing).
        Jinv = Jm.T @ np.linalg.inv(Jm @ Jm.T + 2e-3 * np.eye(3))
        tau = tau + np.asarray(mass_matrix) @ Jinv @ (
            acc - np.asarray(J_dot) @ np.asarray(q_dot).reshape(3)) \
            + np.asarray(h).reshape(3)
    return tau


class SwingTrajectoryController:
    """Host-side swing clocks, event detection and torque computation.

    Mirrors the reference SwingTrajectoryController
    (helpers/swing_trajectory_controller.py:4-165).
    """

    def __init__(self, step_height, swing_period, position_gain_fb, velocity_gain_fb,
                 generator: str = "bezier_ref", reflex_max_step_height: float | None = None,
                 liftoff_boost: float = 0.0):
        # 'scipy' is an explicit alias of 'bezier_ref' (see config.SimParams): the
        # reference's scipy generator exists for reflex re-planning, implemented here
        # natively in compute_trajectory_references.
        self.generator = "bezier_ref" if generator == "scipy" else generator
        self.step_height = step_height
        self.swing_period = swing_period
        self.position_gain_fb = position_gain_fb
        self.velocity_gain_fb = velocity_gain_fb
        self.reflex_max_step_height = (
            reflex_max_step_height if reflex_max_step_height is not None else 1.6 * step_height
        )
        self.liftoff_boost = liftoff_boost
        self.swing_time = [0.0, 0.0, 0.0, 0.0]
        self.use_feedback_linearization = True
        self.use_friction_compensation = True
        self.rising_edge_detected = False
        # Mid-swing re-targets (terrain planner moved the touchdown): re-plan the
        # remaining swing from this point, same mechanism as reflex re-planning.
        self.retarget_points: list = [None] * 4
        self.retarget_moments = [-1.0] * 4
        # Velocity-matched retargets: start the re-planned curve at this
        # velocity (None = the reference's v=0 clamp) and optionally override
        # its apex height (None = step_height above the new start — which near
        # the apex commands a fresh full-height climb from wherever the foot
        # already is; the round-4 chasm postmortem measured the resulting
        # command discontinuity flinging the foot to z=0.36).
        self.retarget_vels: list = [None] * 4
        self.retarget_apexes: list = [None] * 4

    def retarget(self, leg_id, from_point, at_moment, velocity=None, apex=None):
        """Re-plan leg_id's remaining swing from ``from_point`` (reached at
        ``at_moment`` into the swing) toward the (new) touchdown target.
        ``velocity`` (3,) starts the curve velocity-matched; ``apex`` overrides
        the re-planned curve's apex height above max(start_z, touchdown_z)."""
        self.retarget_points[leg_id] = np.asarray(from_point, np.float64).copy()
        self.retarget_moments[leg_id] = float(at_moment)
        self.retarget_vels[leg_id] = (None if velocity is None
                                      else np.asarray(velocity, np.float64).copy())
        self.retarget_apexes[leg_id] = None if apex is None else float(apex)

    def regenerate_swing_trajectory_generator(self, step_height, swing_period):
        self.step_height = step_height
        self.swing_period = swing_period

    # -- trajectory ---------------------------------------------------------
    def compute_trajectory_references(self, swing_time, lift_off, touch_down,
                                      hitmoment=-1.0, hitpoint=None,
                                      hit_step_height=None, hit_velocity=None):
        """Per-leg desired (pos, vel, acc). Reflex re-planning: when an early-stance
        hitpoint exists, restart the curve from the hitpoint with a raised apex and the
        remaining time compressed (reference scipy_swing_trajectory_generator.py:25-47).
        ``hit_step_height`` overrides the re-plan apex (reflex_max by default;
        planner re-targets pass a continuity-preserving apex). ``hit_velocity``
        starts the re-planned curve velocity-matched (planner re-targets)."""
        lift_off = np.asarray(lift_off, np.float64).reshape(3)
        touch_down = np.asarray(touch_down, np.float64).reshape(3)
        step_height = self.step_height
        period = self.swing_period
        t = swing_time
        v0 = None
        if hitpoint is not None and hitmoment >= 0.0:
            lift_off = np.asarray(hitpoint, np.float64).reshape(3)
            step_height = (self.reflex_max_step_height if hit_step_height is None
                           else hit_step_height)
            period = max(self.swing_period - hitmoment, 1e-3)
            t = swing_time - hitmoment
            v0 = hit_velocity
        if self.generator == "explicit":
            pos, vel, acc = explicit_swing_refs_jit(
                jnp.float32(t), jnp.float32(period), jnp.float32(step_height),
                jnp.asarray(lift_off, jnp.float32), jnp.asarray(touch_down, jnp.float32))
        elif v0 is not None:
            pos, vel, acc = bezier_swing_refs_jit(
                jnp.float32(t), jnp.float32(period), jnp.float32(step_height),
                jnp.asarray(lift_off, jnp.float32), jnp.asarray(touch_down, jnp.float32),
                jnp.float32(self.liftoff_boost),
                jnp.asarray(v0, jnp.float32), jnp.float32(1.0))
        else:
            pos, vel, acc = bezier_swing_refs_jit(
                jnp.float32(t), jnp.float32(period), jnp.float32(step_height),
                jnp.asarray(lift_off, jnp.float32), jnp.asarray(touch_down, jnp.float32),
                jnp.float32(self.liftoff_boost))
        return np.asarray(pos), np.asarray(vel), np.asarray(acc)

    # -- control ------------------------------------------------------------
    def compute_swing_control_cartesian_space(
        self, leg_id, q_dot, J, J_dot, lift_off, touch_down, foot_pos, foot_vel,
        h, mass_matrix, early_stance_hitmoment=-1.0, early_stance_hitpoint=None,
    ):
        hm, hp, hit_sh, hit_v = early_stance_hitmoment, early_stance_hitpoint, None, None
        if hp is None and self.retarget_points[leg_id] is not None:
            # Planner-moved touchdown: same re-planning, velocity-matched start
            # and a continuity-preserving apex when provided.
            hm, hp = self.retarget_moments[leg_id], self.retarget_points[leg_id]
            hit_sh = (self.step_height if self.retarget_apexes[leg_id] is None
                      else self.retarget_apexes[leg_id])
            hit_v = self.retarget_vels[leg_id]
        des_pos, des_vel, des_acc = self.compute_trajectory_references(
            self.swing_time[leg_id], lift_off, touch_down, hm, hp, hit_sh, hit_v)
        tau = swing_cartesian_torque(
            des_pos, des_vel, des_acc, foot_pos, foot_vel, J, J_dot, q_dot, h,
            mass_matrix, self.position_gain_fb, self.velocity_gain_fb,
            self.use_feedback_linearization)
        return tau, des_pos, des_vel

    # -- clocks & events -----------------------------------------------------
    def update_swing_time(self, current_contact, dt):
        for leg in range(4):
            if current_contact[leg] == 0:
                if self.swing_time[leg] < self.swing_period:
                    self.swing_time[leg] += dt
            else:
                self.swing_time[leg] = 0.0
                self.retarget_points[leg] = None
                self.retarget_moments[leg] = -1.0
                self.retarget_vels[leg] = None
                self.retarget_apexes[leg] = None

    def check_apex_condition(self, current_contact, interval=0.02, phase=0.5):
        """1 when any swing leg is within ±interval of ``phase``*period into its
        swing (reference swing_trajectory_controller.py:129-138 checks mid-swing;
        terrain planners may trigger earlier so the foot has more swing time left to
        reach an adapted foothold)."""
        mid = self.swing_period * phase
        for leg in range(4):
            if current_contact[leg] == 0 and abs(self.swing_time[leg] - mid) < interval:
                return 1
        return 0

    def check_full_stance_condition(self, current_contact):
        return int(all(c != 0 for c in current_contact))

    def check_touch_down_condition(self, current_contact, previous_contact,
                                   contact_sequence, lookahead=3):
        """Rising-edge + stable-stance detector gating gait optimization
        (reference swing_trajectory_controller.py:148-165)."""
        if np.all(np.asarray(current_contact) == 1) and not np.all(np.asarray(previous_contact) == 1):
            self.rising_edge_detected = True
        stable = np.all(contact_sequence[:, 0:lookahead] == 1)
        next_lift = not np.all(contact_sequence[:, lookahead] == 1)
        if self.rising_edge_detected and stable and next_lift:
            self.rising_edge_detected = False
            return 1
        return 0
