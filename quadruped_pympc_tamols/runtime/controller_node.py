"""Deployment-path control node: WBC loop with pipelined MPC.

Counterpart of the reference ROS2 controller node (ros2/run_controller.py:97-560)
without the ROS dependency: a high-rate whole-body/torque loop fed by an MPC running
in one of three concurrency modes (:47-83, :231-362):

* "inline"  — solve in the control loop (simplest);
* "thread"  — MPC in a background thread, latest-solution handoff under a mutex;
* "shared_memory" — MPC in a separate OS process publishing through the native
  seq-locked ControlBus (runtime/control_bus.cpp), the real-robot configuration.

State I/O is abstracted behind a provider callable so the same node runs against the
MuJoCo env (sim-in-the-loop, the reference's run_simulator.py pairing) or a real
state-estimator bridge. Loop timing is measured and saturated like the reference
(:435-446).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..config import Config
from ..interfaces.controller_interface import SRBDControllerInterface
from ..interfaces.wb_interface import WBInterface
from ..utils.legs import Legs
from .control_bus import ControlBus, pack_control_block, unpack_control_block


class ControllerNode:
    def __init__(self, cfg: Config, initial_feet_pos: Legs, mpc_mode: str = "inline",
                 bus_name: str = "/qpympc_control", seed: int = 0):
        assert mpc_mode in ("inline", "pipelined", "thread", "shared_memory")
        if mpc_mode == "pipelined":
            # Async-dispatch pipelining for the SAMPLING path (the RTI split's
            # twin, config sampling.pipelined): solves run inline but one tick
            # deep — dispatch now, consume last tick's result.
            from ..config import replace_config
            cfg = replace_config(cfg, **{"mpc.sampling.pipelined": True})
            mpc_mode = "inline"
        self.cfg = cfg
        self.mpc_mode = mpc_mode
        self.wb = WBInterface(cfg, initial_feet_pos)
        self.ctrl = SRBDControllerInterface(cfg, seed=seed)
        self.loop_dt_saturation = 0.005  # reference :444-446
        self._latest = None
        self._latest_lock = threading.Lock()
        self._mpc_inputs = None
        self._stop = threading.Event()
        self._solve_ms = 0.0
        self.best_freq = cfg.gait_params.step_freq

        if mpc_mode == "thread":
            self._thread = threading.Thread(target=self._mpc_thread_main, daemon=True)
            self._thread.start()
        elif mpc_mode == "shared_memory":
            self.bus = ControlBus(bus_name, create=True)
            self._last_seq = 0
            self._thread = threading.Thread(target=self._mpc_bus_main, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    def _solve(self, inputs):
        state_current, ref_state, contact_seq, optimize_swing = inputs
        t0 = time.perf_counter()
        grfs, footholds, freq, predicted = self.ctrl.compute_control(
            state_current, ref_state, contact_seq,
            current_contact=self.wb.current_contact,
            previous_contact=self.wb.previous_contact,
            phase_signal=self.wb.pgg.phase_signal,
            optimize_swing=optimize_swing)
        self._solve_ms = (time.perf_counter() - t0) * 1e3
        return grfs, footholds, freq, predicted

    def _mpc_thread_main(self):
        while not self._stop.is_set():
            inputs = self._mpc_inputs
            if inputs is None:
                time.sleep(0.0005)
                continue
            out = self._solve(inputs)
            with self._latest_lock:
                self._latest = out

    def _mpc_bus_main(self):
        while not self._stop.is_set():
            inputs = self._mpc_inputs
            if inputs is None:
                time.sleep(0.0005)
                continue
            grfs, footholds, freq, predicted = self._solve(inputs)
            block = pack_control_block(
                np.asarray(grfs.data), np.asarray(footholds.data),
                np.zeros(12), np.zeros(12), np.zeros(12),
                np.asarray(predicted).reshape(-1)[:12], freq,
                self._solve_ms, 0.0)
            self.bus.write(block)

    # ------------------------------------------------------------------
    def control_tick(self, state_provider, ref_base_lin_vel, ref_base_ang_vel,
                     simulation_dt: float):
        """One WBC tick: update planners, (maybe) solve MPC, map torques.

        ``state_provider`` supplies the robot state dict with the same keys the
        MuJoCo env readers produce (see sim/simulation.py).
        """
        s = state_provider()
        (state_current, ref_state, contact_seq, step_height, optimize_swing) = \
            self.wb.update_state_and_reference(
                s["com_pos"], s["base_pos"], s["base_lin_vel"], s["base_ori_euler_xyz"],
                s["base_ang_vel"], s["feet_pos"], s["hip_pos"], s["joints_pos"],
                s.get("heightmaps"), simulation_dt, ref_base_lin_vel, ref_base_ang_vel)

        inputs = (state_current, ref_state, contact_seq, optimize_swing)
        if self.mpc_mode == "inline":
            out = self._solve(inputs)
            grfs, footholds, freq, predicted = out
        else:
            self._mpc_inputs = inputs
            if self.mpc_mode == "thread":
                with self._latest_lock:
                    out = self._latest
                if out is None:
                    grfs, footholds = Legs.zeros((3,)), s["feet_pos"]
                    freq = self.best_freq
                else:
                    grfs, footholds, freq, _ = out
            else:  # shared_memory
                seq, block = self.bus.read()
                if seq == 0:
                    grfs, footholds = Legs.zeros((3,)), s["feet_pos"]
                    freq = self.best_freq
                else:
                    d = unpack_control_block(block)
                    grfs = Legs(d["grfs"])
                    footholds = Legs(d["footholds"])
                    freq = d["best_freq"]
        self.best_freq = freq

        tau, des_q, des_qd = self.wb.compute_stance_and_swing_torque(
            simulation_dt, s["joints_pos"], s["joints_vel"], s["feet_jac"],
            s["feet_jac_dot"], s["feet_pos"], s["feet_vel"], s["legs_qfrc_bias"],
            s["legs_mass_matrix"], grfs, footholds, optimize_swing, freq,
            base_pos=s["base_pos"], base_rpy=s["base_ori_euler_xyz"],
            legs_qfrc_passive=s.get("legs_qfrc_passive"),
            # Optional estimator-provided contact points for the geom_contact
            # reflex (None -> detector falls back to the tracking trigger).
            contact_points=s.get("contact_points"),
            # Kinodynamic variant: the OCP's joint plan overrides the IK targets
            # (reference srbd_controller_interface.py:184-207).
            nmpc_joints_pos=getattr(self.ctrl, "nmpc_joints_pos",
                                    None),
            nmpc_joints_vel=getattr(self.ctrl, "nmpc_joints_vel",
                                    None))
        return tau, des_q, des_qd

    def shutdown(self):
        self._stop.set()
        if self.mpc_mode == "shared_memory":
            self._thread.join(timeout=1.0)
            self.bus.close()
        elif self.mpc_mode == "thread":
            self._thread.join(timeout=1.0)
