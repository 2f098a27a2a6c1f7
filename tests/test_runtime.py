"""Native control bus (C++ seq-lock over POSIX shm), controller node concurrency
modes, and the tuning console."""
import os
import threading
import time

import numpy as np
import pytest

from quadruped_pympc_tamols import make_config, replace_config
from quadruped_pympc_tamols.runtime.control_bus import (
    PAYLOAD_DOUBLES,
    ControlBus,
    pack_control_block,
    unpack_control_block,
)


def test_bus_roundtrip():
    name = f"/qpympc_test_{os.getpid()}"
    w = ControlBus(name, create=True)
    r = ControlBus(name, create=False)
    try:
        seq0, _ = r.read()
        assert seq0 == 0  # nothing published yet
        block = pack_control_block(np.arange(12), np.arange(12) + 100,
                                   np.zeros(12), np.zeros(12), np.zeros(12),
                                   np.arange(12) * 0.5, 1.8, 0.7, 1.2)
        w.write(block)
        seq, data = r.read()
        assert seq == 2  # one complete publish
        d = unpack_control_block(data)
        np.testing.assert_allclose(d["grfs"].reshape(12), np.arange(12))
        np.testing.assert_allclose(d["footholds"].reshape(12), np.arange(12) + 100)
        assert d["best_freq"] == 1.8
    finally:
        r.close()
        w.close()


def test_bus_concurrent_reader_never_tears():
    """Hammer the bus from a writer thread; every snapshot the reader sees must be
    internally consistent (payload filled with a single value per publish)."""
    name = f"/qpympc_tear_{os.getpid()}"
    w = ControlBus(name, create=True)
    r = ControlBus(name, create=False)
    stop = threading.Event()
    torn = []

    def writer():
        i = 0
        while not stop.is_set():
            w.write(np.full(PAYLOAD_DOUBLES, float(i)))
            i += 1

    th = threading.Thread(target=writer)
    th.start()
    try:
        t_end = time.time() + 1.0
        reads = 0
        while time.time() < t_end:
            seq, data = r.read()
            if seq:
                if not np.all(data == data[0]):
                    torn.append(data)
                reads += 1
        assert reads > 1000
        assert not torn, f"torn read: {torn[0][:5]}"
    finally:
        stop.set()
        th.join()
        r.close()
        w.close()


def test_bus_wait_new():
    name = f"/qpympc_wait_{os.getpid()}"
    w = ControlBus(name, create=True)
    try:
        seq, data = w.wait_new(0, timeout_s=0.05)
        assert seq == 0 and data is None  # timeout
        w.write(np.full(PAYLOAD_DOUBLES, 7.0))
        seq, data = w.wait_new(0, timeout_s=0.5)
        assert seq == 2 and data[0] == 7.0
    finally:
        w.close()


@pytest.mark.parametrize("mode", ["inline", "thread", "shared_memory"])
def test_controller_node_modes(mode):
    from quadruped_pympc_tamols.runtime.controller_node import ControllerNode
    from quadruped_pympc_tamols.utils.legs import Legs

    cfg = make_config("aliengo", mpc_type="sampling", gait="full_stance")
    cfg = replace_config(cfg, **{"mpc.sampling.num_samples": 200,
                                 "sim.visual_foothold_adaptation": "blind"})
    feet = Legs(np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                          [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]]))
    node = ControllerNode(cfg, feet, mpc_mode=mode,
                          bus_name=f"/qpympc_node_{os.getpid()}_{mode}")

    def provider():
        return dict(
            com_pos=np.array([0.0, 0.0, 0.33]), base_pos=np.array([0.0, 0.0, 0.35]),
            base_lin_vel=np.zeros(3), base_ori_euler_xyz=np.zeros(3),
            base_ang_vel=np.zeros(3), feet_pos=feet,
            hip_pos=Legs(np.asarray(feet.data) + np.array([0, 0, 0.35])),
            joints_pos=Legs(np.tile([0.0, 0.8, -1.6], (4, 1))),
            joints_vel=Legs.zeros((3,)),
            feet_jac=Legs(np.tile(np.eye(3), (4, 1, 1))),
            feet_jac_dot=Legs.zeros((3, 3)),
            feet_vel=Legs.zeros((3,)),
            legs_qfrc_bias=Legs.zeros((3,)),
            legs_mass_matrix=Legs(np.tile(np.eye(3) * 0.1, (4, 1, 1))),
        )

    try:
        # The async modes must eventually produce nonzero stance torques; under
        # CPU contention the background solver may need a while, so poll with a
        # deadline instead of a fixed tick count.
        deadline = time.time() + 20.0
        tau_arr = np.zeros((4, 3))
        while time.time() < deadline:
            tau, des_q, des_qd = node.control_tick(
                provider, np.zeros(3), np.zeros(3), cfg.sim.dt)
            tau_arr = np.asarray(tau.data)
            if np.any(np.abs(tau_arr) > 1.0):
                break
            time.sleep(0.01)
        assert np.any(np.abs(tau_arr) > 1.0), f"{mode}: no torque produced"
        assert np.all(np.isfinite(tau_arr))
    finally:
        node.shutdown()


def test_console_commands():
    from quadruped_pympc_tamols.interfaces.wrapper import QuadrupedPyMPCWrapper
    from quadruped_pympc_tamols.runtime.console import Console
    from quadruped_pympc_tamols.utils.legs import Legs

    cfg = make_config("aliengo", mpc_type="sampling")
    cfg = replace_config(cfg, **{"mpc.sampling.num_samples": 64})
    w = QuadrupedPyMPCWrapper(cfg, Legs.zeros((3,)))
    con = Console(w)
    assert "walking" in con.execute("start")
    assert con.walking
    con.execute("vel 0.4 0.0 0.1")
    np.testing.assert_allclose(con.velocity_cmd[:2], [0.4, 0.0])
    assert "pace" in con.execute("gait pace")
    assert w.wb_interface.pgg.step_freq == 1.4
    con.execute("step_freq 2.0")
    assert w.wb_interface.pgg.step_freq == 2.0
    con.execute("stance_width 0.12")
    assert w.wb_interface.frg.hip_offset == 0.12
    assert "unknown command" in con.execute("bogus 1")
    assert "unknown gait" in con.execute("gait bogus")
    assert "stopped" in con.execute("stop")


def test_console_new_commands():
    import numpy as np

    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.interfaces.wrapper import QuadrupedPyMPCWrapper
    from quadruped_pympc_tamols.runtime.console import Console
    from quadruped_pympc_tamols.utils.legs import Legs

    cfg = make_config("aliengo", **{"mpc.sampling.num_samples": 100,
                                    "sim.visual_foothold_adaptation": "blind"})
    feet = Legs(np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                          [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]]))
    con = Console(QuadrupedPyMPCWrapper(cfg, feet))
    assert "kp=30" in con.execute("impedance_gains 30 3")
    assert con.impedance_gains == (30.0, 3.0)
    con.execute("pitch_delta 0.05")
    con.execute("pitch_delta 0.02")
    te = con.wrapper.wb_interface.terrain_estimator
    assert abs(te.pitch_offset - 0.07) < 1e-9
    # The offset rides on top of the EMA estimate in the returned pitch.
    _, pitch, _ = te.compute_terrain_estimation(np.zeros(3), 0.0, feet)
    assert abs(pitch - 0.07) < 1e-6
