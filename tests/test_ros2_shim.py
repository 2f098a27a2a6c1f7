"""ROS2 shim: message schemas, state assembly and packing run WITHOUT rclpy; the
rclpy node class import-guards cleanly (reference ros2/run_controller.py:97-107,
msgs_ws/src/dls2_interface/msg/*.msg)."""
import numpy as np
import pytest

from quadruped_pympc_tamols import make_config
from quadruped_pympc_tamols.runtime import (
    BaseState,
    BlindState,
    ControllerNode,
    QuadrupedPyMPCRosNode,
    RobotStateAssembler,
    pack_control_signal,
    pack_trajectory_generator,
    rclpy_available,
)
from quadruped_pympc_tamols.runtime.ros2_node import (
    Pose,
    Screw,
    quat_wxyz_to_euler_xyz,
)
from quadruped_pympc_tamols.utils.legs import Legs


def _standing_messages(cfg):
    import jax.numpy as jnp

    from quadruped_pympc_tamols.kinematics import LegKinematics
    from quadruped_pympc_tamols.utils.frames import euler_xyz_to_rot

    kin = LegKinematics(cfg.robot)
    base_pos = np.array([0.0, 0.0, cfg.sim.ref_z])
    feet = np.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                       [-0.25, 0.15, 0], [-0.25, -0.15, 0]], float)
    q = np.asarray(kin.ik_world(jnp.asarray(feet, jnp.float32),
                                jnp.asarray(base_pos, jnp.float32),
                                euler_xyz_to_rot(jnp.zeros(3))))
    base = BaseState(pose=Pose(position=base_pos),
                     velocity=Screw(linear=np.array([0.1, 0.0, 0.0])))
    blind = BlindState(joints_position=q.reshape(12),
                       joints_velocity=np.zeros(12))
    return base, blind, feet


def test_quat_to_euler_roundtrip():
    # yaw 90deg: q = (cos45, 0, 0, sin45)
    e = quat_wxyz_to_euler_xyz([np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)])
    np.testing.assert_allclose(e, [0, 0, np.pi / 2], atol=1e-6)
    e = quat_wxyz_to_euler_xyz([1, 0, 0, 0])
    np.testing.assert_allclose(e, 0.0, atol=1e-9)


def test_state_assembly_reconstructs_feet():
    """FK on the BlindState joints reproduces the feet the IK was seeded with."""
    cfg = make_config("aliengo", mpc_type="sampling")
    base, blind, feet = _standing_messages(cfg)
    s = RobotStateAssembler(cfg).assemble(base, blind)
    np.testing.assert_allclose(np.asarray(s["feet_pos"].data), feet, atol=5e-3)
    np.testing.assert_allclose(s["base_ori_euler_xyz"], 0.0, atol=1e-7)
    jac = np.asarray(s["feet_jac"].data)
    assert jac.shape == (4, 3, 3)
    assert np.all(np.abs(np.linalg.det(jac)) > 1e-5), "singular leg Jacobian"
    # Foot velocity from pure base translation = base velocity.
    np.testing.assert_allclose(np.asarray(s["feet_vel"].data),
                               np.tile([0.1, 0, 0], (4, 1)), atol=1e-6)


def test_controller_tick_from_messages():
    """Full message-to-torque path: assemble -> ControllerNode.control_tick ->
    ControlSignal/TrajectoryGenerator packing (no ROS anywhere)."""
    cfg = make_config("aliengo", mpc_type="sampling",
                      **{"mpc.sampling.num_samples": 256,
                         "sim.visual_foothold_adaptation": "blind"})
    base, blind, feet = _standing_messages(cfg)
    assembler = RobotStateAssembler(cfg)
    node = ControllerNode(cfg, Legs(feet), mpc_mode="inline")
    try:
        s = assembler.assemble(base, blind)
        tau, des_q, des_qd = node.control_tick(
            lambda: s, np.array([0.2, 0.0, 0.0]), np.zeros(3), 0.004)
        sig = pack_control_signal(tau, 7, 123.4)
        assert sig.torques.shape == (12,)
        assert np.all(np.isfinite(sig.torques))
        assert sig.sequence_id == 7
        tg = pack_trajectory_generator(node, des_q, des_qd, 7, 123.4)
        assert tg.joints_position.shape == (12,)
        assert tg.swing_period.shape == (4,)
        assert len(tg.stance_legs) == 4
    finally:
        node.shutdown()


def test_rclpy_node_guard():
    cfg = make_config("aliengo", mpc_type="sampling")
    if rclpy_available():  # pragma: no cover - not in this environment
        pytest.skip("rclpy installed; guard not exercised")
    with pytest.raises(ImportError, match="rclpy"):
        QuadrupedPyMPCRosNode(cfg)


def _msg_fields(path):
    """Field names of a .msg IDL file, in declaration order."""
    fields = []
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        typ, name = line.split()
        fields.append((typ, name))
    return fields


def test_msg_idl_matches_dataclasses():
    """The shipped .msg IDL files (runtime/msgs/dls2_interface/msg/, the buildable
    ROS2 interface package) are field-for-field twins of the dataclass schemas —
    same names, same order (reference msgs_ws/src/dls2_interface/msg/*.msg)."""
    import dataclasses
    import pathlib

    from quadruped_pympc_tamols.runtime import ros2_node as rn

    msg_dir = (pathlib.Path(rn.__file__).parent / "msgs" / "dls2_interface" / "msg")
    schemas = {
        "Pose": rn.Pose, "Screw": rn.Screw, "BaseState": rn.BaseState,
        "BlindState": rn.BlindState, "ControlSignal": rn.ControlSignal,
        "TrajectoryGenerator": rn.TrajectoryGenerator, "TimeDebug": rn.TimeDebug,
        "FeetContactState": rn.FeetContactState, "Imu": rn.Imu,
    }
    for name, cls in schemas.items():
        idl = _msg_fields(msg_dir / f"{name}.msg")
        dc = [f.name for f in dataclasses.fields(cls)]
        assert [n for _, n in idl] == dc, f"{name}.msg fields diverge from dataclass"
    # Every IDL file in the package has a schema (no orphan messages).
    assert {p.stem for p in msg_dir.glob("*.msg")} == set(schemas)


def test_node_to_node_loopback_walks():
    """SimulatorNode <-> ControllerBridge over a LocalTransport: the full
    dataclass-message transport path (BaseState/BlindState out of the physics
    node, ControlSignal/TrajectoryGenerator back) walks the robot, exactly the
    run_simulator.py <-> run_controller.py pairing of the reference (both sides
    see ONLY messages — no shared state)."""
    pytest.importorskip("mujoco")
    from quadruped_pympc_tamols.runtime import (ControllerBridge,
                                                    LocalTransport,
                                                    SimulatorNode)

    cfg = make_config("aliengo", mpc_type="sampling",
                      **{"mpc.sampling.num_samples": 500,
                         "sim.visual_foothold_adaptation": "blind"})
    bus = LocalTransport()
    sim = SimulatorNode(cfg, bus, scene="flat", rate_hz=500.0)
    ctl = ControllerBridge(cfg, bus, mpc_mode="inline", rate_hz=250.0)
    try:
        # Before any state message: the controller refuses to act.
        assert ctl.tick(np.array([0.2, 0, 0]), np.zeros(3)) is False

        x0 = sim.env.base_pos[0]
        for t in range(1250):  # 2.5 s at 500 Hz, controller at 250 Hz
            sim.step()
            if t % 2 == 0:
                assert ctl.tick(np.array([0.25, 0, 0]), np.zeros(3))
            z = sim.env.base_pos[2]
            assert z > 0.5 * cfg.sim.ref_z, f"fell at t={t * sim.sim_dt:.2f}s"
        assert sim.env.base_pos[0] - x0 > 0.3, "loopback robot did not walk"
        assert bus.published["/base_state"] == 1250
        assert bus.published["/quadruped_pympc_torques"] == 625
        assert bus.published["/time_debug"] == 625
    finally:
        ctl.shutdown()
