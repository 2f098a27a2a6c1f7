"""Gradient RTI-SQP MPC: QP-solver optimality (KKT), physical sanity of the GRFs,
foot-trajectory construction, closed-loop regulation, batched gait optimization."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_pympc_tamols import make_config
from quadruped_pympc_tamols.controllers.gradient import (
    BatchedGradientMPC,
    GradientMPC,
    build_feet_trajectory,
    pdip_solve,
)
from quadruped_pympc_tamols.dynamics import integrate_euler, make_params


def test_pdip_tiny_qp_analytic():
    """min 0.5 z^T H z + g^T z s.t. z <= 1 with H=I, g=(-3, 0.5):
    unconstrained z = (3, -0.5); with the box, z* = (1, -0.5)."""
    Hm = jnp.eye(2)
    g = jnp.asarray([-3.0, 0.5])
    C = jnp.eye(2)
    d = jnp.ones(2)
    sol = pdip_solve(Hm, g, C, d, iters=25)
    np.testing.assert_allclose(np.asarray(sol.z), [1.0, -0.5], atol=1e-3)


def test_pdip_kkt_random_qp():
    rng = np.random.default_rng(0)
    n, m = 20, 30
    A = rng.normal(size=(n, n))
    Hm = jnp.asarray(A @ A.T + np.eye(n), jnp.float32)
    g = jnp.asarray(rng.normal(size=n), jnp.float32)
    C = jnp.asarray(rng.normal(size=(m, n)), jnp.float32)
    d = jnp.asarray(rng.uniform(0.5, 2.0, size=m), jnp.float32)
    sol = pdip_solve(Hm, g, C, d, iters=30)
    # KKT: stationarity, primal feasibility, complementarity.
    stat = np.asarray(Hm @ sol.z + g + C.T @ sol.lam)
    assert np.max(np.abs(stat)) < 1e-2
    assert float(sol.primal_res) < 1e-4
    assert float(sol.gap) < 1e-4


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


def test_standing_equilibrium_grfs():
    cfg = make_config("aliengo", mpc_type="nominal")
    mpc = GradientMPC(cfg)
    state, ref = _standing(cfg)
    seq = np.ones((4, cfg.mpc.horizon))
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0
    share = cfg.robot.mass * 9.81 / 4
    # At the reference state the optimum is the gravity-share distribution.
    np.testing.assert_allclose(grfs[:, 2], share, rtol=0.05)
    np.testing.assert_allclose(grfs[:, :2], 0.0, atol=2.0)
    # Friction cone.
    assert np.all(np.abs(grfs[:, 0]) <= cfg.mpc.mu * grfs[:, 2] + 1e-3)


def test_below_reference_pushes_up():
    cfg = make_config("aliengo", mpc_type="nominal")
    mpc = GradientMPC(cfg)
    state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.06)
    seq = np.ones((4, cfg.mpc.horizon))
    grfs, *_ = mpc.compute_control(state, ref, seq)
    assert grfs[:, 2].sum() > cfg.robot.mass * 9.81 * 1.05


def test_swing_legs_zero_force():
    cfg = make_config("aliengo", mpc_type="nominal")
    mpc = GradientMPC(cfg)
    state, ref = _standing(cfg)
    seq = np.ones((4, cfg.mpc.horizon))
    seq[1, :] = 0.0  # FR fully in swing
    seq[2, :6] = 0.0
    grfs, *_ = mpc.compute_control(state, ref, seq)
    np.testing.assert_allclose(grfs[1], 0.0, atol=1e-6)
    np.testing.assert_allclose(grfs[2], 0.0, atol=1e-6)  # masked by current contact
    assert grfs[[0, 3], 2].sum() > cfg.robot.mass * 9.81 * 0.8


def test_feet_trajectory_touchdown_advance():
    feet = np.array([[0.2, 0.1, 0.0]] * 4)
    ref = np.array([[[0.3, 0.1, 0.0]]] * 4)
    seq = np.ones((4, 8))
    seq[0, 2:5] = 0.0  # FL swings stages 2-4, touches down at 5
    traj = build_feet_trajectory(feet, ref, seq, 8)
    np.testing.assert_allclose(traj[0, 0], feet[0])
    np.testing.assert_allclose(traj[4, 0], feet[0])  # still swing: holds old pos
    np.testing.assert_allclose(traj[5, 0], ref[0, 0])  # touched down at new foothold
    np.testing.assert_allclose(traj[7, 0], ref[0, 0])
    np.testing.assert_allclose(traj[:, 1], np.tile(feet[1], (8, 1)))  # always-stance leg never moves


def test_closed_loop_height_regulation_gradient():
    cfg = make_config("aliengo", mpc_type="nominal")
    params = make_params(cfg)
    mpc = GradientMPC(cfg)
    state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.05)
    seq = np.ones((4, cfg.mpc.horizon))
    feet = jnp.asarray(np.stack([state[f"foot_{leg}"] for leg in ("FL", "FR", "RL", "RR")]),
                       jnp.float32)
    x = jnp.asarray(np.concatenate([state["position"], state["linear_velocity"],
                                    state["orientation"], state["angular_velocity"]]),
                    jnp.float32)
    err0 = abs(float(x[2]) - cfg.sim.ref_z)
    for _ in range(100):
        sd = dict(state)
        sd["position"], sd["linear_velocity"] = np.asarray(x[:3]), np.asarray(x[3:6])
        sd["orientation"], sd["angular_velocity"] = np.asarray(x[6:9]), np.asarray(x[9:12])
        grfs, *_ = mpc.compute_control(sd, ref, seq)
        x = integrate_euler(x, feet, jnp.asarray(grfs), jnp.ones(4), params, 0.01)
    err = abs(float(x[2]) - cfg.sim.ref_z)
    assert err < err0 * 0.5, f"height error {err0:.3f} -> {err:.3f}"
    assert abs(float(x[6])) < 0.05 and abs(float(x[7])) < 0.05


def test_batched_gait_optimization():
    cfg = make_config("aliengo", mpc_type="nominal")
    bmpc = BatchedGradientMPC(cfg)
    state, ref = _standing(cfg)
    K = len(cfg.mpc.step_freq_available)
    seqs = np.ones((K, 4, cfg.mpc.horizon))
    seqs[1, 0, 4:8] = 0.0
    seqs[2, 1, 2:9] = 0.0
    costs, best = bmpc.optimize_gait(state, ref, seqs)
    assert len(costs) == K
    assert best in cfg.mpc.step_freq_available
    # Standing at the reference: full stance (candidate 0) should win.
    assert best == cfg.mpc.step_freq_available[0]


def test_as_rti_levels_run():
    """AS-RTI-A..D map to extra synchronous GN iterations (reference config.py:126-130)."""
    from quadruped_pympc_tamols import replace_config

    cfg = make_config("aliengo", mpc_type="nominal")
    cfg = replace_config(cfg, **{"mpc.gradient.use_RTI": True,
                                 "mpc.gradient.as_rti_type": "AS-RTI-B",
                                 "mpc.gradient.as_rti_iter": 2})
    mpc = GradientMPC(cfg)
    state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.03)
    seq = np.ones((4, cfg.mpc.horizon))
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0
    assert grfs[:, 2].sum() > cfg.robot.mass * 9.81


def test_external_wrench_compensation():
    """A steady downward external force must raise the commanded total Fz by about
    the same amount (reference external_wrenches_compensation, config.py:156-159)."""
    cfg = make_config("aliengo", mpc_type="nominal")
    mpc = GradientMPC(cfg)
    state, ref = _standing(cfg)
    seq = np.ones((4, cfg.mpc.horizon))
    for _ in range(8):  # converge the RTI warm start
        g0, *_ = mpc.compute_control(state, ref, seq)
    mpc.reset()
    push_down = np.array([0.0, 0.0, -50.0, 0.0, 0.0, 0.0])
    for _ in range(8):
        g1, *_ = mpc.compute_control(state, ref, seq, external_wrenches=push_down)
    extra = g1[:, 2].sum() - g0[:, 2].sum()
    assert 30.0 < extra < 70.0, f"wrench compensation produced {extra:.1f} N"


def test_ddp_standing_equilibrium():
    """The DDP solver option (use_DDP) reaches the same gravity-share equilibrium as
    the condensed-QP path on a four-leg stance."""
    cfg = make_config("aliengo", mpc_type="nominal", **{"mpc.gradient.use_DDP": True})
    mpc = GradientMPC(cfg)
    state, ref = _standing(cfg)
    seq = np.ones((4, cfg.mpc.horizon))
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0
    share = cfg.robot.mass * 9.81 / 4
    np.testing.assert_allclose(grfs[:, 2], share, rtol=0.05)
    # Forward-pass projection keeps the solution inside the cone by construction.
    assert np.all(np.abs(grfs[:, 0]) <= cfg.mpc.mu * grfs[:, 2] + 1e-4)
    assert np.all(np.abs(grfs[:, 1]) <= cfg.mpc.mu * grfs[:, 2] + 1e-4)
    assert np.all(grfs[:, 2] <= cfg.mpc.grf_max + 1e-3)


def test_ddp_matches_sqp_cost():
    """On a trot stance below reference height, DDP's nonlinear objective lands within
    a few percent of the interior-point SQP answer."""
    cfg_sqp = make_config("aliengo", mpc_type="nominal")
    cfg_ddp = make_config("aliengo", mpc_type="nominal",
                          **{"mpc.gradient.use_DDP": True, "mpc.gradient.ddp_iters": 6})
    state, ref = _standing(cfg_sqp, z=cfg_sqp.sim.ref_z - 0.04)
    seq = np.ones((4, cfg_sqp.mpc.horizon))
    seq[1, 3:9] = 0.0
    seq[2, 3:9] = 0.0
    *_, cost_sqp = GradientMPC(cfg_sqp).compute_control(state, ref, seq)
    grfs, *_, cost_ddp = GradientMPC(cfg_ddp).compute_control(state, ref, seq)
    assert np.all(np.isfinite(grfs))
    assert cost_ddp <= cost_sqp * 1.10 + 1.0


def test_ddp_swing_legs_zero_force():
    cfg = make_config("aliengo", mpc_type="nominal", **{"mpc.gradient.use_DDP": True})
    mpc = GradientMPC(cfg)
    state, ref = _standing(cfg)
    seq = np.ones((4, cfg.mpc.horizon))
    seq[1, :] = 0.0
    grfs, *_ = mpc.compute_control(state, ref, seq)
    np.testing.assert_allclose(grfs[1], 0.0, atol=1e-6)
    assert grfs[[0, 2, 3], 2].sum() > cfg.robot.mass * 9.81 * 0.8


def test_runtime_inertia_recomputation():
    """use_inertia_recomputation: solve with the composite inertia as a runtime
    param; a heavier tensor changes the solution without recompilation."""
    cfg = make_config("aliengo", mpc_type="nominal")
    mpc = GradientMPC(cfg)
    state, ref = _standing(cfg)
    state = dict(state)
    state["angular_velocity"] = np.array([0.4, 0.3, 0.0])  # make inertia matter
    seq = np.ones((4, cfg.mpc.horizon))
    g0, *_ , c0 = mpc.compute_control(state, ref, seq)
    mpc.reset()
    I = cfg.robot.inertia_matrix()
    g1, *_, c1 = mpc.compute_control(state, ref, seq, inertia=I)
    mpc.reset()
    g2, *_, c2 = mpc.compute_control(state, ref, seq, inertia=I * 3.0,
                                     mass=cfg.robot.mass)
    # Same inertia as static -> same solution; scaled inertia -> different forces.
    np.testing.assert_allclose(g1, g0, atol=0.5)
    assert np.abs(g2 - g1).max() > 0.5
    assert np.isfinite(c1) and np.isfinite(c2)


def test_recentering_far_from_origin():
    """The controller interface recenters around the base xy (reference
    perform_scaling): solving 10 km from the origin yields the same GRFs as at the
    origin despite float32 solvers."""
    from quadruped_pympc_tamols.interfaces.controller_interface import (
        SRBDControllerInterface,
    )

    def solve_at(offset):
        cfg = make_config("aliengo", mpc_type="nominal")
        iface = SRBDControllerInterface(cfg)
        state, ref = _standing(cfg, z=cfg.sim.ref_z - 0.03)
        state = dict(state); ref = dict(ref)
        off = np.array([offset, offset / 2, 0.0])
        for k in ("foot_FL", "foot_FR", "foot_RL", "foot_RR"):
            state[k] = np.asarray(state[k]) + off
        state["position"] = np.asarray(state["position"]) + off
        ref["ref_position"] = np.asarray(ref["ref_position"]) + off
        for k in ("ref_foot_FL", "ref_foot_FR", "ref_foot_RL", "ref_foot_RR"):
            ref[k] = np.asarray(ref[k]) + off
        seq = np.ones((4, cfg.mpc.horizon))
        grfs, fh, freq, pred = iface.compute_control(state, ref, seq)
        return np.asarray(grfs.data), np.asarray(fh.data), np.asarray(pred)

    g0, fh0, p0 = solve_at(0.0)
    g1, fh1, p1 = solve_at(10000.0)
    np.testing.assert_allclose(g1, g0, atol=0.5)
    # Outputs come back in WORLD coordinates.
    np.testing.assert_allclose(fh1[:, 0] - fh0[:, 0], 10000.0, atol=1e-3)
    np.testing.assert_allclose(p1[0] - p0[0], 10000.0, atol=1e-3)


def test_stance_min_force_floor():
    """gradient.stance_min_force: the QP's fz lower bound rises to the floor on
    stance legs only — in a 4-stance hover every stance leg carries at least the
    floor, and a swing leg stays at ~zero (round-4 chasm postmortem: lightly
    loaded stone feet slid off when any lateral request exited their cone)."""
    import jax.numpy as jnp

    from quadruped_pympc_tamols.controllers.gradient import GradientMPC

    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"mpc.gradient.stance_min_force": 20.0})
    mpc = GradientMPC(cfg)
    H = cfg.mpc.horizon
    state = {
        "position": np.array([0.0, 0.0, 0.33]),
        "linear_velocity": np.zeros(3), "orientation": np.zeros(3),
        "angular_velocity": np.zeros(3),
        "foot_FL": np.array([0.25, 0.15, 0.0]),
        "foot_FR": np.array([0.25, -0.15, 0.0]),
        "foot_RL": np.array([-0.25, 0.15, 0.0]),
        "foot_RR": np.array([-0.25, -0.15, 0.0]),
    }
    ref = {
        "ref_position": np.array([0.0, 0.0, 0.35]),
        "ref_linear_velocity": np.zeros(3), "ref_orientation": np.zeros(3),
        "ref_angular_velocity": np.zeros(3),
        "ref_foot_FL": state["foot_FL"][None], "ref_foot_FR": state["foot_FR"][None],
        "ref_foot_RL": state["foot_RL"][None], "ref_foot_RR": state["foot_RR"][None],
    }
    # FR swings over the second half of the horizon; 4-stance at step 0.
    seq = np.ones((4, H), np.float32)
    seq[1, H // 2:] = 0.0
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0
    assert np.all(grfs[:, 2] >= 20.0 - 0.5), f"stance floor violated: {grfs[:, 2]}"
    # And the floor binds only where it should: a swing-phase stage keeps the
    # swinging leg's force at ~0 (check stage H-1 of the plan for FR).
    U_last = mpc.U_warm[-1].reshape(4, 3)  # shifted plan's last stage
    assert U_last[1, 2] < 1.0, f"swing leg carries force: {U_last[1, 2]}"


@pytest.mark.parametrize("mode", ["balance", "robust"])
def test_qp_budget_is_the_same_on_every_backend(monkeypatch, mode):
    """The Mehrotra budget is the f64 ladder's knee, which the CPU backend and
    the GPU share (14 'balance' iterations; 'robust' adds 4): no backend
    table decides it."""
    import jax

    from quadruped_pympc_tamols import replace_config
    from quadruped_pympc_tamols.controllers.gradient.sqp import qp_solver_for

    gp = replace_config(make_config("aliengo", mpc_type="nominal"),
                        **{"mpc.gradient.solver_mode": mode}).mpc.gradient
    budgets = set()
    for backend in ("cpu", "gpu", "rocm"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        budgets.add(qp_solver_for(gp)[1])
    assert budgets == {18 if mode == "robust" else 14}
