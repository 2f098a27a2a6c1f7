"""IK backends: numeric damped-LS and joint-limit QP vs the analytic closed form
(counterparts of the reference's three IK solvers, wb_interface.py:10-11)."""
import numpy as np
import pytest

from quadruped_pympc_tamols import ROBOTS, make_config
from quadruped_pympc_tamols.kinematics import LegKinematics, NumericIK, QPIK


def _reachable_targets(robot, rng):
    """Random hip-frame foot targets in the locomotion workspace via FK of random
    joints (extreme folds near the limits need a warm start, as on the real robot)."""
    legs = LegKinematics(robot)
    lb = np.array([-0.5, -0.4, -2.2])
    ub = np.array([0.5, 1.4, -0.8])
    q = rng.uniform(lb, ub, size=(4, 3)).astype(np.float32)
    return np.asarray(legs.fk_all(q)), q


@pytest.mark.parametrize("solver_cls", [NumericIK, QPIK])
def test_ik_round_trip(solver_cls):
    robot = ROBOTS["aliengo"]
    legs = LegKinematics(robot)
    rng = np.random.default_rng(3)
    solver = solver_cls(robot)
    for _ in range(5):
        p, _ = _reachable_targets(robot, rng)
        q = solver.solve_hip_frame(p)
        p_back = np.asarray(legs.fk_all(q))
        np.testing.assert_allclose(p_back, p, atol=2e-3)


def test_numeric_matches_analytic():
    robot = ROBOTS["go2"] if "go2" in ROBOTS else ROBOTS["aliengo"]
    legs = LegKinematics(robot)
    rng = np.random.default_rng(7)
    solver = NumericIK(robot, iterations=8)
    p, _ = _reachable_targets(robot, rng)
    q_num = np.asarray(solver.solve_hip_frame(p))
    q_ana = np.asarray(legs.ik_all(p))
    # Same foot position even if a different (equivalent) joint branch is found.
    np.testing.assert_allclose(np.asarray(legs.fk_all(q_num)),
                               np.asarray(legs.fk_all(q_ana)), atol=2e-3)


def test_qp_ik_respects_joint_limits():
    robot = ROBOTS["aliengo"]
    solver = QPIK(robot, iterations=5)
    lb = np.array([l for l, _ in robot.joint_limits])
    ub = np.array([u for _, u in robot.joint_limits])
    # Unreachable target far outside the workspace: solution must stay in the box.
    p = np.tile(np.array([1.5, 1.5, -1.5], np.float32), (4, 1))
    q = np.asarray(solver.solve_hip_frame(p))
    assert np.all(q >= lb - 1e-4) and np.all(q <= ub + 1e-4)


def test_reference_compatible_entry():
    robot = ROBOTS["aliengo"]
    solver = NumericIK(robot)
    base = np.array([0.1, -0.05, robot.hip_height])
    feet = dict(FL=[0.35, 0.1, 0.0], FR=[0.35, -0.2, 0.0],
                RL=[-0.15, 0.1, 0.0], RR=[-0.15, -0.2, 0.0])
    q12 = solver.compute_solution(base, np.zeros(3), feet["FL"], feet["FR"],
                                  feet["RL"], feet["RR"])
    assert q12.shape == (12,) and np.all(np.isfinite(q12))
    # Verify by world-frame FK of the analytic model.
    legs = LegKinematics(robot)
    hips = np.asarray(legs.hips_world(base, np.eye(3)))
    p_hip = np.stack([np.asarray(feet[k]) - hips[i]
                      for i, k in enumerate(("FL", "FR", "RL", "RR"))])
    p_back = np.asarray(legs.fk_all(q12.reshape(4, 3)))
    np.testing.assert_allclose(p_back, p_hip, atol=2e-3)


def test_wb_interface_ik_selection():
    from quadruped_pympc_tamols.interfaces.wb_interface import WBInterface
    from quadruped_pympc_tamols.utils.legs import Legs

    cfg = make_config("aliengo", **{"sim.ik_solver": "numeric"})
    feet = Legs(np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                          [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]]))
    wb = WBInterface(cfg, feet)
    assert isinstance(wb.ik, NumericIK)


def test_config_enum_validation_raises():
    with pytest.raises(ValueError, match="ik_solver"):
        make_config("aliengo", **{"sim.ik_solver": "bogus"})
    with pytest.raises(ValueError, match="method"):
        make_config("aliengo", **{"mpc.sampling.method": "genetic"})
