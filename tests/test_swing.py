"""Bezier swing generator: boundary conditions, apex constraint, batched evaluation
(mirrors the reference's own self-checks,
swing_generators/bezier_ref_swing_trajectory_generator.py:389-424)."""
import jax.numpy as jnp
import numpy as np

from quadruped_pympc_tamols.gait.swing import (
    SwingTrajectoryController,
    bezier_swing_refs,
    explicit_swing_refs,
)

LO = np.array([0.0, 0.0, 0.0])
TD = np.array([0.2, 0.05, 0.02])
H = 0.08
T = 0.4


def test_boundary_conditions():
    for t, target in [(0.0, LO), (T, TD)]:
        pos, vel, acc = bezier_swing_refs(t, T, H, jnp.asarray(LO), jnp.asarray(TD))
        np.testing.assert_allclose(np.asarray(pos), target, atol=1e-5)
        np.testing.assert_allclose(np.asarray(vel), 0.0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(acc), 0.0, atol=1e-3)


def test_midpoint_height():
    pos, _, _ = bezier_swing_refs(T / 2, T, H, jnp.asarray(LO), jnp.asarray(TD))
    z_expected = max(LO[2], TD[2]) + H
    np.testing.assert_allclose(float(pos[2]), z_expected, atol=1e-4)
    np.testing.assert_allclose(np.asarray(pos[:2]), 0.5 * (LO[:2] + TD[:2]), atol=1e-5)


def test_batched_over_legs():
    los = jnp.asarray(np.tile(LO, (4, 1)), jnp.float32)
    tds = jnp.asarray(np.tile(TD, (4, 1)), jnp.float32)
    times = jnp.asarray([0.0, 0.1, 0.2, 0.3])
    pos, vel, acc = bezier_swing_refs(times, T, H, los, tds)
    assert pos.shape == (4, 3) and vel.shape == (4, 3) and acc.shape == (4, 3)


def test_velocity_is_derivative_of_position():
    eps = 1e-4
    t = 0.13
    p1, v, _ = bezier_swing_refs(t, T, H, jnp.asarray(LO), jnp.asarray(TD))
    p2, _, _ = bezier_swing_refs(t + eps, T, H, jnp.asarray(LO), jnp.asarray(TD))
    fd = (np.asarray(p2) - np.asarray(p1)) / eps
    np.testing.assert_allclose(fd, np.asarray(v), atol=1e-2)


def test_explicit_generator_reaches_apex():
    pos, _, _ = explicit_swing_refs(T / 2, T, H, jnp.asarray(LO), jnp.asarray(TD))
    np.testing.assert_allclose(float(pos[2]), max(LO[2], TD[2]) + H, atol=1e-5)
    pos0, _, _ = explicit_swing_refs(0.0, T, H, jnp.asarray(LO), jnp.asarray(TD))
    posT, _, _ = explicit_swing_refs(T, T, H, jnp.asarray(LO), jnp.asarray(TD))
    np.testing.assert_allclose(np.asarray(pos0), LO, atol=1e-6)
    np.testing.assert_allclose(np.asarray(posT), TD, atol=1e-6)


def test_controller_events():
    stc = SwingTrajectoryController(H, T, 500.0, 10.0)
    contact = [0, 1, 1, 0]
    # drive leg 0 close to apex
    stc.swing_time = [T / 2, 0.0, 0.0, 0.1]
    assert stc.check_apex_condition(contact) == 1
    assert stc.check_full_stance_condition([1, 1, 1, 1]) == 1
    assert stc.check_full_stance_condition(contact) == 0

    seq = np.ones((4, 12))
    seq[:, 3] = 0  # first 3 columns stable stance, leg lifts at the lookahead column
    assert stc.check_touch_down_condition(np.array([1, 1, 1, 1]), np.array([1, 0, 1, 1]),
                                          seq, lookahead=3) == 1


def test_reflex_replanning_raises_apex():
    stc = SwingTrajectoryController(H, T, 500.0, 10.0, reflex_max_step_height=0.2)
    hit = np.array([0.1, 0.02, 0.05])
    t_mid_of_replanned = 0.1 + (T - 0.1) / 2
    pos, _, _ = stc.compute_trajectory_references(t_mid_of_replanned, LO, TD,
                                                  hitmoment=0.1, hitpoint=hit)
    assert pos[2] > max(hit[2], TD[2]) + 0.19


def test_numpy_twins_match_jitted():
    """Host numpy twins (per-tick path) match the jitted kernels exactly."""
    import jax.numpy as jnp

    from quadruped_pympc_tamols import ROBOTS
    from quadruped_pympc_tamols.gait.swing import (
        bezier_swing_refs,
        explicit_swing_refs,
        swing_refs_np,
    )
    from quadruped_pympc_tamols.kinematics import LegKinematics

    t = np.array([0.05, 0.12, 0.2, 0.0])
    period = np.full(4, 0.25)
    sh = np.full(4, 0.11)
    lo = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.02],
                   [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]])
    td = lo + np.array([0.07, 0.01, 0.0])
    for gen, fn in (("bezier_ref", bezier_swing_refs), ("explicit", explicit_swing_refs)):
        p_np, v_np, a_np = swing_refs_np(gen, t, period, sh, lo, td)
        import jax
        p_j, v_j, a_j = jax.vmap(fn)(jnp.asarray(t, jnp.float32),
                                     jnp.asarray(period, jnp.float32),
                                     jnp.asarray(sh, jnp.float32),
                                     jnp.asarray(lo, jnp.float32),
                                     jnp.asarray(td, jnp.float32))
        np.testing.assert_allclose(p_np, np.asarray(p_j), atol=1e-5)
        np.testing.assert_allclose(v_np, np.asarray(v_j), atol=1e-4)
        np.testing.assert_allclose(a_np, np.asarray(a_j), atol=2e-3)

    kin = LegKinematics(ROBOTS["aliengo"])
    p_hip = np.array([[0.02, 0.1, -0.33], [-0.04, -0.12, -0.3],
                      [0.0, 0.09, -0.35], [0.05, -0.1, -0.28]])
    np.testing.assert_allclose(kin.ik_all_np(p_hip), np.asarray(kin.ik_all(p_hip)),
                               atol=1e-5)


def test_swing_retarget_replans_to_new_target():
    """After retarget(), the remaining swing re-plans from the retarget point and
    lands exactly on the (new) touchdown at the end of the period."""
    from quadruped_pympc_tamols.gait.swing import SwingTrajectoryController

    stc = SwingTrajectoryController(step_height=0.1, swing_period=0.3,
                                    position_gain_fb=1000, velocity_gain_fb=20)
    stc.swing_time[1] = 0.15
    mid = np.array([0.30, -0.15, 0.08])
    stc.retarget(1, mid, 0.15)
    new_td = np.array([0.45, -0.15, 0.0])
    # The control entry picks up the retarget automatically (normal apex).
    stc.swing_time[1] = 0.3 - 1e-9
    tau, pos, vel = stc.compute_swing_control_cartesian_space(
        leg_id=1, q_dot=np.zeros(3), J=np.eye(3), J_dot=np.zeros((3, 3)),
        lift_off=np.array([0.25, -0.15, 0.0]), touch_down=new_td,
        foot_pos=mid, foot_vel=np.zeros(3), h=np.zeros(3),
        mass_matrix=np.eye(3))
    np.testing.assert_allclose(pos, new_td, atol=1e-3)
    # Touchdown clears the retarget.
    stc.update_swing_time([1, 1, 1, 1], 0.002)
    assert stc.retarget_points[1] is None


def test_velocity_matched_bezier_start():
    """Velocity-matched re-planning (round-4 chasm postmortem): with v0 given,
    the curve starts at exactly v0 with zero initial acceleration, ends on the
    touchdown with v=0, and the apex height is preserved — on both the jnp
    curve and its numpy host twin."""
    import jax.numpy as jnp

    from quadruped_pympc_tamols.gait.swing import (
        bezier_swing_refs,
        swing_refs_np,
    )

    period, sh = 0.3, 0.1
    lo = jnp.asarray([0.25, -0.15, 0.05], jnp.float32)
    td = jnp.asarray([0.55, -0.10, 0.0], jnp.float32)
    v0 = jnp.asarray([0.8, 0.2, 0.4], jnp.float32)
    eps = 1e-3
    p0, vel0, acc0 = bezier_swing_refs(0.0, period, sh, lo, td,
                                       v0=v0, v0_mask=1.0)
    np.testing.assert_allclose(np.asarray(p0), np.asarray(lo), atol=1e-5)
    np.testing.assert_allclose(np.asarray(vel0), np.asarray(v0), atol=1e-4)
    assert np.all(np.abs(np.asarray(acc0)) < 1e-2)
    # End clamp unchanged.
    p1, vel1, _ = bezier_swing_refs(period, period, sh, lo, td,
                                    v0=v0, v0_mask=1.0)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(td), atol=1e-5)
    assert np.all(np.abs(np.asarray(vel1)) < 1e-4)
    # Apex preserved: z at midpoint = max(lo_z, td_z) + step_height.
    pm, _, _ = bezier_swing_refs(period / 2, period, sh, lo, td,
                                 v0=v0, v0_mask=1.0)
    assert abs(float(pm[2]) - (0.05 + sh)) < 1e-5
    # numpy twin agrees along the curve.
    for s in (0.0, 0.1, 0.15, 0.25, 0.3):
        pj, vj, aj = bezier_swing_refs(jnp.float32(s), period, sh, lo, td,
                                       v0=v0, v0_mask=1.0)
        pn, vn, an = swing_refs_np(
            "bezier_ref", np.full(4, s), np.full(4, period), np.full(4, sh),
            np.tile(np.asarray(lo), (4, 1)), np.tile(np.asarray(td), (4, 1)),
            v0=np.tile(np.asarray(v0), (4, 1)), v0_mask=np.ones(4))
        np.testing.assert_allclose(pn[2], np.asarray(pj), atol=1e-5)
        np.testing.assert_allclose(vn[2], np.asarray(vj), atol=1e-4)
    # v0_mask=0 rows reduce exactly to the boost start (here boost=0 -> v(0)=0).
    _, vz, _ = bezier_swing_refs(0.0, period, sh, lo, td,
                                 v0=v0, v0_mask=0.0)
    assert np.all(np.abs(np.asarray(vz)) < 1e-5)


def test_retarget_velocity_and_apex_flow_through_controller():
    """retarget(velocity=..., apex=...) reaches the curve: the re-planned
    command at the retarget moment moves at the recorded velocity, and the apex
    override caps the re-planned curve's height."""
    from quadruped_pympc_tamols.gait.swing import SwingTrajectoryController

    stc = SwingTrajectoryController(step_height=0.1, swing_period=0.3,
                                    position_gain_fb=1000, velocity_gain_fb=20)
    mid = np.array([0.30, -0.15, 0.08])
    v_cmd = np.array([0.5, 0.0, 0.2])
    stc.swing_time[1] = 0.15
    stc.retarget(1, mid, 0.15, velocity=v_cmd, apex=0.03)
    new_td = np.array([0.45, -0.15, 0.0])
    _, pos, vel = stc.compute_swing_control_cartesian_space(
        leg_id=1, q_dot=np.zeros(3), J=np.eye(3), J_dot=np.zeros((3, 3)),
        lift_off=np.array([0.25, -0.15, 0.0]), touch_down=new_td,
        foot_pos=mid, foot_vel=np.zeros(3), h=np.zeros(3),
        mass_matrix=np.eye(3))
    np.testing.assert_allclose(pos, mid, atol=1e-3)
    np.testing.assert_allclose(vel, v_cmd, atol=2e-3)
    # Apex override: curve max z stays near max(start, td) + apex, well below
    # the default step_height plan.
    zs = []
    for s in np.linspace(0.15, 0.3, 31):
        stc.swing_time[1] = s
        _, p, _ = stc.compute_swing_control_cartesian_space(
            leg_id=1, q_dot=np.zeros(3), J=np.eye(3), J_dot=np.zeros((3, 3)),
            lift_off=np.array([0.25, -0.15, 0.0]), touch_down=new_td,
            foot_pos=mid, foot_vel=np.zeros(3), h=np.zeros(3),
            mass_matrix=np.eye(3))
        zs.append(p[2])
    assert max(zs) < 0.08 + 0.03 + 0.02, f"apex not capped: {max(zs):.3f}"
