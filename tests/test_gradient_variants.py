"""Gradient-MPC variants: input_rates (GRF-in-state smoothing), collaborative
(passive-arm wrench), lyapunov (transverse states + V_dot constraint)."""
import numpy as np
import pytest

from quadruped_pympc_tamols import make_config
from quadruped_pympc_tamols.controllers.gradient import VariantGradientMPC
from quadruped_pympc_tamols.controllers.gradient.sqp import GradientMPC


def _standing(cfg, z=None):
    z = cfg.sim.ref_z if z is None else z
    state = dict(position=np.array([0.0, 0.0, z]), linear_velocity=np.zeros(3),
                 orientation=np.zeros(3), angular_velocity=np.zeros(3),
                 foot_FL=np.array([0.25, 0.15, 0.0]), foot_FR=np.array([0.25, -0.15, 0.0]),
                 foot_RL=np.array([-0.25, 0.15, 0.0]), foot_RR=np.array([-0.25, -0.15, 0.0]))
    ref = dict(ref_position=np.array([0.0, 0.0, cfg.sim.ref_z]),
               ref_linear_velocity=np.zeros(3), ref_orientation=np.zeros(3),
               ref_angular_velocity=np.zeros(3),
               ref_foot_FL=state["foot_FL"][None], ref_foot_FR=state["foot_FR"][None],
               ref_foot_RL=state["foot_RL"][None], ref_foot_RR=state["foot_RR"][None])
    return state, ref


@pytest.mark.parametrize("variant", ["input_rates", "collaborative", "lyapunov"])
def test_variant_standing_sane(variant):
    cfg = make_config("aliengo", mpc_type=variant)
    mpc = VariantGradientMPC(cfg, variant)
    state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.02)
    seq = np.ones((4, cfg.mpc.horizon))
    # A few warm ticks (input_rates needs force states to ramp from zero).
    for _ in range(6):
        grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0
    assert np.all(np.isfinite(grfs))
    total_fz = grfs[:, 2].sum()
    weight = cfg.robot.mass * 9.81
    assert 0.5 * weight < total_fz < 2.0 * weight, f"total fz {total_fz:.1f}"
    # Friction cone on applied forces.
    assert np.all(np.abs(grfs[:, 0]) <= cfg.mpc.mu * grfs[:, 2] + 1.0)


def test_input_rates_smoother_than_nominal():
    """The rate-penalized variant must produce smoother force profiles across MPC
    ticks than the nominal controller under the same disturbance sequence."""
    def tick_deltas(make):
        cfg = make_config("aliengo")
        mpc = make(cfg)
        state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.03)
        seq = np.ones((4, cfg.mpc.horizon))
        rng = np.random.default_rng(0)
        for _ in range(20):  # reach steady state (force states ramp from zero)
            mpc.compute_control(state, ref, seq)
        prev, deltas = None, []
        for i in range(10):
            s = dict(state)
            s["position"] = state["position"] + rng.normal(0, 0.005, 3)
            grfs, *_ = mpc.compute_control(s, ref, seq)
            if prev is not None:
                deltas.append(np.abs(grfs - prev).max())
            prev = grfs
        return np.mean(deltas)

    d_nominal = tick_deltas(lambda c: GradientMPC(c))
    d_rates = tick_deltas(lambda c: VariantGradientMPC(c, "input_rates"))
    assert d_rates < d_nominal, f"rates {d_rates:.2f} vs nominal {d_nominal:.2f}"


def test_lyapunov_vdot_constraint_active():
    """With a tracking error, the returned force deltas must satisfy the linearized
    Lyapunov-decrease constraint: V_dot <= small tolerance."""
    cfg = make_config("aliengo", mpc_type="lyapunov")
    mpc = VariantGradientMPC(cfg, "lyapunov")
    state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.05)
    state["linear_velocity"] = np.array([0.1, 0.0, 0.0])
    seq = np.ones((4, cfg.mpc.horizon))
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0

    K1 = np.asarray(cfg.mpc.gradient.K_z1)
    K2 = np.asarray(cfg.mpc.gradient.K_z2)
    z1 = state["position"] - ref["ref_position"]
    z2 = (state["linear_velocity"] - ref["ref_linear_velocity"]) + K1 * z1
    # The QP variable is the force DELTA; recover it from the applied force.
    phi = np.zeros(3)
    F_star = cfg.robot.mass * (-(K1 + K2) * z2 + K1 * K1 * z1
                               - np.array([0, 0, -9.81])) - phi
    delta = grfs - (F_star / 4.0)[None, :]
    F_delta = delta.sum(axis=0)
    v_dot = (-z1 @ (K1 * z1) - z2 @ (K2 * z2) + z1 @ z2
             + z2 @ F_delta / cfg.robot.mass)
    assert v_dot <= 0.5, f"V_dot {v_dot:.3f} not decreasing"


def test_collaborative_wrench_state_evolves():
    cfg = make_config("aliengo", mpc_type="collaborative")
    mpc = VariantGradientMPC(cfg, "collaborative")
    state, ref = _standing(cfg)
    state["linear_velocity"] = np.array([0.4, 0.0, 0.0])  # moving -> arm loads up
    seq = np.ones((4, cfg.mpc.horizon))
    mpc.compute_control(state, ref, seq)
    assert np.any(np.abs(mpc.extra_state[:2]) > 1e-6), "arm wrench never loaded"


def test_dispatch_builds_variants():
    from quadruped_pympc_tamols.interfaces import SRBDControllerInterface
    for t in ("input_rates", "collaborative", "lyapunov"):
        cfg = make_config("aliengo", mpc_type=t)
        iface = SRBDControllerInterface(cfg)
        assert iface.controller.spec.name == t


def test_kinodynamic_standing():
    cfg = make_config("aliengo", mpc_type="kinodynamic")
    mpc = VariantGradientMPC(cfg, "kinodynamic")
    state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.02)
    # Nominal standing joints from IK round trip.
    from quadruped_pympc_tamols.kinematics import LegKinematics
    import jax.numpy as jnp
    from quadruped_pympc_tamols.utils.frames import euler_xyz_to_rot
    kin = LegKinematics(cfg.robot)
    feet = np.stack([state[f"foot_{leg}"] for leg in ("FL", "FR", "RL", "RR")])
    q0 = np.asarray(kin.ik_world(jnp.asarray(feet, jnp.float32),
                                 jnp.asarray(state["position"], jnp.float32),
                                 euler_xyz_to_rot(jnp.zeros(3))))
    for i, leg in enumerate(("FL", "FR", "RL", "RR")):
        state[f"joint_{leg}"] = q0[i]
    seq = np.ones((4, cfg.mpc.horizon))
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0
    assert np.all(np.isfinite(grfs))
    total = grfs[:, 2].sum()
    w = cfg.robot.mass * 9.81
    assert 0.4 * w < total < 2.5 * w, f"total fz {total:.1f}"
    assert mpc.nmpc_joints_pos.shape == (cfg.mpc.horizon, 12)
    assert np.all(np.isfinite(mpc.nmpc_joints_pos))


def test_nominal_stability_constraint_zmp():
    """With ZMP stability on, during a diagonal 2-stance the commanded forces keep
    the ZMP within the margin of the support segment."""
    from quadruped_pympc_tamols import replace_config
    from quadruped_pympc_tamols.utils.analysis import support_polygon_margin

    cfg = make_config("aliengo", mpc_type="nominal")
    cfg = replace_config(cfg, **{"mpc.gradient.use_zmp_stability": True})
    mpc = VariantGradientMPC(cfg, "nominal")
    state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.02)
    state["linear_velocity"] = np.array([0.2, 0.05, 0.0])
    seq = np.ones((4, cfg.mpc.horizon))
    seq[1, :] = 0.0  # FR swing
    seq[2, :] = 0.0  # RL swing -> FL/RR diagonal stance
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0
    feet = np.stack([state[f"foot_{leg}"] for leg in ("FL", "FR", "RL", "RR")])
    a_xy = (grfs[:, :2] * seq[:, 0:1]).sum(axis=0) / cfg.robot.mass
    zmp = state["position"][:2] - (state["position"][2] / 9.81) * a_xy
    margin = support_polygon_margin(zmp, feet, seq[:, 0])
    # Distance to the diagonal segment must be within the configured margin (plus
    # linearization slack).
    assert -margin <= cfg.mpc.gradient.trot_stability_margin + 0.05, \
        f"ZMP {-margin:.3f} m from support segment"


def test_dispatch_uses_variant_core_for_stability():
    from quadruped_pympc_tamols import replace_config
    from quadruped_pympc_tamols.interfaces import SRBDControllerInterface

    cfg = make_config("aliengo", mpc_type="nominal")
    cfg = replace_config(cfg, **{"mpc.gradient.use_static_stability": True})
    iface = SRBDControllerInterface(cfg)
    assert iface.controller.spec.name == "nominal"
    assert iface.controller.spec.n_ineq == 25


def test_foothold_optimization_runs_and_respects_box():
    """use_foothold_optimization: feet become decision variables (nx=24, nu=24);
    optimized touchdowns stay inside the constraint box around the reference."""
    from quadruped_pympc_tamols.controllers.gradient import VariantGradientMPC

    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"mpc.gradient.use_foothold_optimization": True,
                         "mpc.gradient.use_foothold_constraints": True})
    mpc = VariantGradientMPC(cfg, "nominal")
    assert mpc.spec.name == "foothold"
    assert mpc.spec.nx == 24 and mpc.spec.nu == 24

    state, ref = _standing(cfg)
    # FR swings and touches down mid-horizon; target foothold 6 cm forward.
    seq = np.ones((4, cfg.mpc.horizon))
    seq[1, :5] = 0.0
    ref = dict(ref)
    ref["ref_foot_FR"] = (np.asarray(state["foot_FR"]) + [0.06, 0.0, 0.0])[None]
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0 and np.isfinite(cost)
    hw = np.asarray(cfg.mpc.gradient.foothold_box_halfwidth)
    target = np.asarray(ref["ref_foot_FR"]).reshape(3)
    assert np.all(np.abs(fh[1, :2] - target[:2]) <= hw + 1e-5)
    # Stance legs keep their (pinned) current position as foothold.
    np.testing.assert_allclose(fh[0], np.asarray(state["foot_FL"]).reshape(3),
                               atol=1e-5)
    # GRFs still on the cone.
    st = seq[:, 0] == 1
    assert np.all(np.abs(grfs[st, 0]) <= cfg.mpc.mu * grfs[st, 2] + 1e-3)


def test_foothold_optimization_moves_foothold_under_disturbance():
    """With a lateral velocity error the optimizer should shift the touchdown
    location rather than return the raw reference."""
    from quadruped_pympc_tamols.controllers.gradient import VariantGradientMPC

    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"mpc.gradient.use_foothold_optimization": True})
    mpc = VariantGradientMPC(cfg, "nominal")
    state, ref = _standing(cfg)
    state = dict(state)
    state["linear_velocity"] = np.array([0.5, 0.3, 0.0])  # uncommanded drift
    seq = np.ones((4, cfg.mpc.horizon))
    seq[1, :5] = 0.0
    seq[2, :5] = 0.0
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0
    moved = np.linalg.norm(fh[1, :2] - np.asarray(ref["ref_foot_FR"]).reshape(3)[:2])
    assert moved > 1e-4  # the optimizer used the foothold degree of freedom


def test_kinodynamic_joints_reach_wb_layer():
    """The kinodynamic OCP's joint trajectories flow through the controller
    interface into the whole-body layer as joint PD targets (reference
    srbd_controller_interface.py:184-207, wb_interface.py:440-443)."""
    from quadruped_pympc_tamols.interfaces.controller_interface import (
        SRBDControllerInterface,
    )

    cfg = make_config("aliengo", mpc_type="kinodynamic")
    iface = SRBDControllerInterface(cfg)
    state, ref = _standing(cfg)
    state = dict(state)
    for leg, p in zip(("FL", "FR", "RL", "RR"),
                      ([0.0, 0.8, -1.6],) * 4):
        state[f"joint_{leg}"] = np.asarray(p)
    seq = np.ones((4, cfg.mpc.horizon))
    iface.compute_control(state, ref, seq, current_contact=seq[:, 0])
    assert iface.nmpc_joints_pos is not None
    assert iface.nmpc_joints_pos.shape[1] == 12
    assert np.all(np.isfinite(iface.nmpc_joints_pos))


def test_foothold_stance_proximity_freezes_last_swing_stage():
    """Foot states must not move on the final swing stage before touchdown (the
    reference's (1-stance)(1-stance_proximity) velocity gate)."""
    from quadruped_pympc_tamols.controllers.gradient import VariantGradientMPC

    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"mpc.gradient.use_foothold_optimization": True})
    mpc = VariantGradientMPC(cfg, "nominal")
    state, ref = _standing(cfg)
    state = dict(state)
    state["linear_velocity"] = np.array([0.5, 0.2, 0.0])
    seq = np.ones((4, cfg.mpc.horizon))
    seq[1, :5] = 0.0  # FR touches down at stage 5 -> proximity on stage 4
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0
    X = mpc.last_X  # (H+1, 24): foot states at columns 12:24
    fr = X[:, 15:18]  # FR foot state trajectory
    # Stage 4 is the last swing stage (proximity=1): the foot must NOT move across
    # the 4 -> 5 transition, while it is free to move earlier in the swing.
    np.testing.assert_allclose(fr[5], fr[4], atol=1e-6)
    moved_early = np.linalg.norm(fr[4] - fr[0])
    assert moved_early > 1e-4  # the optimizer did use the earlier swing stages
