"""Whole-body interface: planners + low-level control around the MPC.

Counterpart of the reference WBInterface (interfaces/wb_interface.py:22-484): owns the
gait generator, foothold reference generator, swing controller, terrain estimator,
TAMOLS planner, velocity modulator, early-stance detector and IK, and exposes

* ``update_state_and_reference`` — gait timing + contact sequence, lift-off/touch-down
  tracking, Raibert reference footholds, terrain-aware adaptation at swing apex,
  terrain slope/height estimation, reference assembly (:108-302);
* ``compute_stance_and_swing_torque`` — stance tau = -J^T f, per-leg Cartesian swing
  tracking, friction compensation, IK -> joint PD targets, saturation (:304-467).

The compute-heavy pieces (TAMOLS scoring, swing curves, IK) are the jitted kernels of
their modules; this class is the thin stateful host shell around them.
"""
from __future__ import annotations

import numpy as np

from ..config import Config, LEGS
from ..gait.foothold_reference import FootholdReferenceGenerator
from ..gait.modulation import EarlyStanceDetector, VelocityModulator
from ..gait.periodic import PeriodicGaitGenerator, make_timer_dts
from ..gait.swing import SwingTrajectoryController
from ..gait.terrain import TerrainEstimator
from ..kinematics.leg_ik import LegKinematics
from ..utils.legs import Legs


class WBInterface:
    def __init__(self, cfg: Config, initial_feet_pos: Legs):
        self.cfg = cfg
        # cfg.gait_params is the canonical gait source (make_config seeds it from
        # GAITS[gait]); reading the static table here would silently ignore
        # gait_params.* overrides (step_freq/duty_factor experiments).
        gait = cfg.gait_params
        self.pgg = PeriodicGaitGenerator(gait, cfg.mpc.horizon)
        self.timer_dts = make_timer_dts(cfg.mpc)

        stance_time = gait.stance_time
        self.frg = FootholdReferenceGenerator(stance_time, initial_feet_pos,
                                              cfg.robot.hip_height)
        self.step_height = cfg.sim.step_height
        self.stc = SwingTrajectoryController(
            step_height=cfg.sim.step_height,
            swing_period=gait.swing_period,
            position_gain_fb=cfg.sim.swing_position_gain_fb,
            velocity_gain_fb=cfg.sim.swing_velocity_gain_fb,
            generator=cfg.sim.swing_generator,
            reflex_max_step_height=cfg.sim.reflex_max_step_height,
            liftoff_boost=cfg.sim.swing_liftoff_boost,
        )
        self.terrain_estimator = TerrainEstimator()
        if cfg.sim.ik_solver == "numeric":
            from ..kinematics.ik_solvers import NumericIK
            self.ik = NumericIK(cfg.robot)
        elif cfg.sim.ik_solver == "qp":
            from ..kinematics.ik_solvers import QPIK
            self.ik = QPIK(cfg.robot)
        else:
            self.ik = LegKinematics(cfg.robot)
        # Fused host path (all-leg swing refs + analytic IK in numpy, zero device
        # calls per control step); only the closed-form IK is stateless enough.
        self._fused_host_path = isinstance(self.ik, LegKinematics)
        # Leg geometry for the reach-aware swing command clamp
        # (sim.swing_reach_clamp): hip positions in base frame + the linkage's
        # true maximum hip-to-foot distance.
        kin_tmp = self.ik if isinstance(self.ik, LegKinematics) \
            else LegKinematics(cfg.robot)
        self._hip_off = np.asarray(kin_tmp.hip_offsets_b, np.float64)
        self._leg_reach = float(np.hypot(
            cfg.robot.hip_offset_y,
            cfg.robot.thigh_length + cfg.robot.calf_length))
        self.vm = VelocityModulator(activated=cfg.sim.velocity_modulator)
        # Reflexes run for EVERY controller family, as in the reference
        # (wb_interface.py:362-365) — the detector itself is solver-agnostic.
        self.esd = EarlyStanceDetector(
            trigger_mode=cfg.sim.reflex_trigger_mode,
            activated=cfg.sim.reflex_trigger_mode != "off",
        )
        # Reflex RE-PLANNING is a property of the swing generator, exactly as in
        # the reference: only its scipy generator consumes hitpoints
        # (scipy_swing_trajectory_generator.py:25-47); bezier_ref/explicit accept
        # and ignore them (bezier_ref_swing_trajectory_generator.py:227-238). The
        # detector still runs and exposes its state either way.
        self._reflex_replanning = cfg.sim.swing_generator == "scipy"
        if cfg.sim.visual_foothold_adaptation != "blind":
            from ..planner.tamols import TamolsPlanner
            self.vfa = TamolsPlanner(cfg)
        else:
            self.vfa = None

        self.current_contact = np.ones(4)
        self._last_td_targets = None  # (4, 3) swing touchdown targets
        self._hold_active = np.zeros(4, bool)  # late-touchdown hold latch
        self._hold_ticks = np.zeros(4, int)  # hold duration (safety cap)
        self.previous_contact = np.ones(4)
        self.last_des_foot_pos = Legs.zeros((3,))
        # Commanded foot velocities of the last tick: the velocity-matched
        # retarget starts the re-planned curve from the COMMANDED state so the
        # command stays continuous (see update_state_and_reference).
        self._last_des_foot_vel = np.zeros((4, 3))
        # Moving-average base velocity for the foothold planner: the raw MuJoCo
        # velocity oscillates +-0.3 m/s during stumbles, and feeding it to the
        # TAMOLS reach/stability predictions flips forward candidates infeasible
        # exactly when a good foothold matters most (same smoothing the Raibert
        # generator applies to its capture-point term).
        import collections
        self._vel_hist = collections.deque(maxlen=20)

    # ------------------------------------------------------------------
    def update_state_and_reference(
        self, com_pos, base_pos, base_lin_vel, base_ori_euler_xyz, base_ang_vel,
        feet_pos: Legs, hip_pos: Legs, joints_pos: Legs, heightmaps,
        simulation_dt: float, ref_base_lin_vel, ref_base_ang_vel,
    ):
        cfg = self.cfg
        state_current = dict(
            position=np.asarray(com_pos) + self.frg.com_pos_offset_w,
            linear_velocity=np.asarray(base_lin_vel),
            orientation=np.asarray(base_ori_euler_xyz),
            angular_velocity=np.asarray(base_ang_vel),
            foot_FL=feet_pos.FL, foot_FR=feet_pos.FR,
            foot_RL=feet_pos.RL, foot_RR=feet_pos.RR,
            joint_FL=joints_pos.FL, joint_FR=joints_pos.FR,
            joint_RL=joints_pos.RL, joint_RR=joints_pos.RR,
        )

        if self.vm.activated:
            ref_base_lin_vel, ref_base_ang_vel = self.vm.modulate_velocities(
                np.asarray(ref_base_lin_vel), np.asarray(ref_base_ang_vel),
                feet_pos, hip_pos)

        if self.pgg.start_and_stop_activated:
            self.pgg.update_start_and_stop(
                feet_pos, hip_pos, self.frg.hip_offset, base_pos, base_ori_euler_xyz,
                base_lin_vel, base_ang_vel, ref_base_lin_vel, ref_base_ang_vel,
                self.current_contact)

        self.pgg.run(simulation_dt, self.pgg.step_freq)
        contact_sequence = self.pgg.compute_contact_sequence(self.timer_dts)

        self.previous_contact = self.current_contact.copy()
        self.current_contact = contact_sequence[:, 0].copy()

        if cfg.sim.late_touchdown_hold > 0.0 and self._last_td_targets is not None:
            # Late-touchdown hold (config sim.late_touchdown_hold): refuse the
            # timer's swing->stance flip while the foot is still far above the
            # leg's TOUCHDOWN TARGET (not the commanded curve point — a
            # re-planned swing's command can itself sit mid-arc when the timer
            # runs out). The swing keeps pressing the foot down (clock
            # saturated at the swing end) instead of the MPC loading a phantom
            # support mid-air.
            feet_arr = np.asarray(feet_pos.data)
            hold_xy = cfg.sim.late_touchdown_hold_xy
            for leg in range(4):
                late = feet_arr[leg, 2] > self._last_td_targets[leg, 2] \
                    + cfg.sim.late_touchdown_hold
                if hold_xy > 0.0 and not late:
                    # Lateral hold: low but laterally off-target is still not
                    # a touchdown (see config late_touchdown_hold_xy).
                    late = np.linalg.norm(feet_arr[leg, :2]
                                          - self._last_td_targets[leg, :2]) \
                        > hold_xy
                if late and self._hold_ticks[leg] * simulation_dt > 0.5:
                    # Safety cap: a target that stays unreachable (e.g. the
                    # base stopped advancing) must not hold the leg in swing
                    # forever — a perpetual 3-legged stance is worse than an
                    # off-target contact. 0.5 s is > 2 full hind-hop holds
                    # measured on the chasm; reached only in degenerate states.
                    late = False
                if self.previous_contact[leg] == 0 \
                        and self.current_contact[leg] == 1 \
                        and late:
                    self.current_contact[leg] = 0.0
                    # The MPC must not load the phantom support either: zero
                    # the held leg's FIRST contact column so force is
                    # redistributed to the real supports during the hold
                    # (previously only current_contact flipped and
                    # the SRB model still allocated GRF to the airborne foot).
                    contact_sequence[leg, 0] = 0.0
                    # Latch: while held, the MPC sees the timer's all-stance
                    # sequence and reports the AIRBORNE foot as this leg's
                    # "foothold" — without the latch that poisons the hold's
                    # own target one tick later and releases it mid-air
                    # (measured).
                    self._hold_active[leg] = True
                    self._hold_ticks[leg] += 1
                else:
                    self._hold_active[leg] = False
                    self._hold_ticks[leg] = 0

        self.frg.update_lift_off_positions(self.previous_contact, self.current_contact,
                                           feet_pos, self.pgg.gait_type, base_pos,
                                           base_ori_euler_xyz)
        self.frg.update_touch_down_positions(self.previous_contact, self.current_contact,
                                             feet_pos, self.pgg.gait_type, base_pos,
                                             base_ori_euler_xyz)
        ref_feet_pos = self.frg.compute_footholds_reference(
            base_pos, base_ori_euler_xyz, np.asarray(base_lin_vel)[:2],
            np.asarray(ref_base_lin_vel)[:2], hip_pos, cfg.sim.ref_z)

        # Terrain-aware foothold adaptation at the swing apex (reference :230-246).
        # The compute runs once per swing when heightmaps are available; applying the
        # stored adaptation and the full-stance reset do NOT depend on fresh sensing.
        ref_feet_constraints = None
        self._vel_hist.append(np.asarray(base_lin_vel, np.float64).copy())
        if self.vfa is not None:
            if heightmaps is not None \
                    and self.stc.check_apex_condition(self.current_contact, interval=0.01,
                                                      phase=cfg.tamols.trigger_phase) \
                    and not self.vfa.initialized:
                seeds = np.asarray(ref_feet_pos.data)
                # Per-leg foothold ANCHOR: a swinging leg's current position
                # is airborne (the adaptation runs at its apex) — its foothold
                # identity is the LIFT-OFF position. Consumed only by the
                # gap-lattice extensions (progression cost, 'foot' fallback);
                # the stability diagonal / foot separation keep the CURRENT
                # feet (reference parity — anchoring the trot's
                # simultaneously-swinging diagonal partner was measured to
                # break flat-ground adaptation).
                feet_anchor = np.asarray(feet_pos.data).copy()
                lo_pos = np.asarray(self.frg.lift_off_positions.data)
                for leg in range(4):
                    if self.current_contact[leg] == 0:
                        feet_anchor[leg] = lo_pos[leg]
                # Flight-time reach gate inputs (tamols.max_foot_speed): per-leg
                # remaining swing time — swing legs get what's left of THIS
                # swing; stance legs plan their NEXT swing with the full period.
                t_remain = np.full(4, self.stc.swing_period, np.float64)
                for leg in range(4):
                    if self.current_contact[leg] == 0:
                        t_remain[leg] = max(
                            self.stc.swing_period - self.stc.swing_time[leg], 1e-3)
                self.vfa.compute_adaptation(
                    heightmaps, seeds,
                    np.asarray(hip_pos.data), np.asarray(base_pos),
                    np.mean(self._vel_hist, axis=0), self.current_contact,
                    np.asarray(feet_pos.data), own_anchor=feet_anchor,
                    t_remain=t_remain)
                # When the planner moved a touchdown substantially, RE-PLAN the
                # remaining swing from the current foot position (the reflex
                # re-planning machinery) instead of evaluating the stale lift-off
                # curve mid-flight — otherwise the foot descends on the old arc and
                # lands short of the stone. The re-plan starts VELOCITY-MATCHED
                # from the commanded curve point (command continuity: a v=0
                # restart is an instantaneous commanded velocity step that the
                # 1000 N/m swing PD turns into a fling — round-4 chasm
                # postmortem) and preserves the ORIGINAL apex plan instead of
                # commanding a fresh full-height climb from wherever the foot is.
                if cfg.tamols.retarget_swing:
                    adapted = np.asarray(self.vfa.footholds_adaptation)
                    feet_now_arr = np.asarray(feet_pos.data)
                    des_prev = np.asarray(self.last_des_foot_pos.data)
                    lo_arr = np.asarray(self.frg.lift_off_positions.data)
                    vmatch = cfg.tamols.retarget_velocity_match
                    for leg in range(4):
                        if self.current_contact[leg] == 0 and \
                                np.linalg.norm(adapted[leg, :2] - seeds[leg, :2]) > 0.03:
                            t_sw = float(self.stc.swing_time[leg])
                            in_flight = vmatch and t_sw > 1.5 * self.cfg.sim.dt
                            # config tamols.retarget_velocity_match: mid-flight
                            # retargets start from the COMMANDED point with the
                            # commanded velocity and a continuity-preserving
                            # apex (the lattice-hop mechanism); otherwise the
                            # measured foot with the v=0 clamp (parity with
                            # the course-tuned behavior).
                            start = des_prev[leg] if in_flight else feet_now_arr[leg]
                            vel = (self._last_des_foot_vel[leg]
                                   if in_flight else None)
                            apex = None
                            if in_flight:
                                apex = float(np.clip(
                                    max(lo_arr[leg, 2], adapted[leg, 2])
                                    + self.stc.step_height
                                    - max(start[2], adapted[leg, 2]),
                                    0.02, self.stc.step_height))
                            self.stc.retarget(leg, start, t_sw, velocity=vel,
                                              apex=apex)
            if self.stc.check_full_stance_condition(self.current_contact):
                self.vfa.reset()
            adapted, constraints = self.vfa.get_footholds_adapted(
                np.asarray(ref_feet_pos.data))
            ref_feet_pos = Legs(np.asarray(adapted))
            ref_feet_constraints = constraints

        # Terrain slope/height + reference rotation (reference :251-267).
        terrain_roll, terrain_pitch, terrain_height = \
            self.terrain_estimator.compute_terrain_estimation(
                base_pos, base_ori_euler_xyz[2], self.frg.lift_off_positions,
                self.current_contact)

        ref_pos = np.array([0.0, 0.0, cfg.sim.ref_z + terrain_height])
        # Rotate the commanded velocity into the terrain frame with the reference's
        # slope heuristics (wb_interface.py:262-267).
        from scipy.spatial.transform import Rotation as R

        ref_base_lin_vel = R.from_euler("xyz", [terrain_roll, terrain_pitch, 0]).as_matrix() \
            @ np.asarray(ref_base_lin_vel, np.float64)
        if terrain_pitch > 0.0:
            ref_base_lin_vel[2] = -ref_base_lin_vel[2]
        if abs(terrain_pitch) > 0.2:
            ref_base_lin_vel[0] /= 2.0
            ref_base_lin_vel[2] *= 2.0

        # Close the loop on the CoM height, not the base height (reference :273).
        ref_pos[2] -= np.asarray(base_pos)[2] - (np.asarray(com_pos)[2]
                                                 + self.frg.com_pos_offset_w[2])

        ref_state = dict(
            ref_foot_FL=ref_feet_pos.FL.reshape(1, 3),
            ref_foot_FR=ref_feet_pos.FR.reshape(1, 3),
            ref_foot_RL=ref_feet_pos.RL.reshape(1, 3),
            ref_foot_RR=ref_feet_pos.RR.reshape(1, 3),
            ref_foot_constraints=ref_feet_constraints,
            ref_linear_velocity=np.asarray(ref_base_lin_vel),
            ref_angular_velocity=np.asarray(ref_base_ang_vel),
            ref_orientation=np.array([terrain_roll, terrain_pitch, 0.0]),
            ref_position=ref_pos,
        )

        if cfg.mpc.optimize_step_freq:
            optimize_swing = self.stc.check_touch_down_condition(
                self.current_contact, self.previous_contact, contact_sequence,
                lookahead=3)
        else:
            optimize_swing = 0

        return state_current, ref_state, contact_sequence, self.step_height, optimize_swing

    # ------------------------------------------------------------------
    def compute_stance_and_swing_torque(
        self, simulation_dt, qpos_js: Legs, qvel_js: Legs, feet_jac: Legs,
        feet_jac_dot: Legs, feet_pos: Legs, feet_vel: Legs, legs_qfrc_bias: Legs,
        legs_mass_matrix: Legs, nmpc_GRFs: Legs, nmpc_footholds: Legs,
        optimize_swing: int, best_sample_freq: float, base_pos=None, base_rpy=None,
        legs_qfrc_passive: Legs | None = None, contact_points=None,
        nmpc_joints_pos=None, nmpc_joints_vel=None,
    ):
        """Returns (tau: Legs, des_joints_pos: Legs, des_joints_vel: Legs)."""
        # Remember the swing touchdown targets for the late-touchdown hold
        # (next tick's update_state_and_reference); legs currently HELD keep
        # their latched target (see the hold block).
        new_td = np.asarray(nmpc_footholds.data, np.float64)
        if self._last_td_targets is None:
            self._last_td_targets = new_td.copy()
        else:
            keep = self._hold_active[:, None]
            self._last_td_targets = np.where(keep, self._last_td_targets, new_td)
        if optimize_swing == 1:
            self.pgg.step_freq = float(best_sample_freq)
            self.frg.stance_time = self.pgg.duty_factor / self.pgg.step_freq
            swing_period = (1 - self.pgg.duty_factor) / self.pgg.step_freq
            self.stc.regenerate_swing_trajectory_generator(self.step_height, swing_period)

        self.esd.update_detection(
            feet_pos, self.last_des_foot_pos, self.frg.lift_off_positions,
            nmpc_footholds, self.stc.swing_time, self.stc.swing_period,
            self.current_contact, self.previous_contact,
            contact_points=contact_points)

        # Stance torque tau = -J^T f (reference :369-372).
        tau = np.zeros((4, 3))
        jac = np.asarray(feet_jac.data)  # (4, 3, 3) world-frame foot Jacobians
        grfs = np.asarray(nmpc_GRFs.data)
        for leg in range(4):
            tau[leg] = -jac[leg].T @ grfs[leg]

        self.stc.update_swing_time(self.current_contact, simulation_dt)

        des_foot_pos = np.zeros((4, 3))
        des_foot_vel = np.zeros((4, 3))
        if self._fused_host_path:
            stc = self.stc
            t_eff = np.asarray(stc.swing_time, np.float32).copy()
            period = np.full(4, stc.swing_period, np.float32)
            step_h = np.full(4, stc.step_height, np.float32)
            lo = np.asarray(self.frg.lift_off_positions.data, np.float32).copy()
            v0 = np.zeros((4, 3), np.float32)
            v0_mask = np.zeros(4, np.float32)
            for leg in range(4):
                hm, hp = ((self.esd.hitmoments[leg], self.esd.hitpoints[leg])
                          if self._reflex_replanning else (-1.0, None))
                if hp is None and stc.retarget_points[leg] is not None:
                    # Planner-moved touchdown: same re-planning, with a
                    # velocity-matched start and continuity-preserving apex
                    # when the retarget recorded them.
                    hm, hp = stc.retarget_moments[leg], stc.retarget_points[leg]
                    if stc.retarget_apexes[leg] is not None:
                        step_h[leg] = stc.retarget_apexes[leg]
                    if stc.retarget_vels[leg] is not None:
                        v0[leg] = stc.retarget_vels[leg]
                        v0_mask[leg] = 1.0
                elif hp is not None and hm >= 0.0:
                    step_h[leg] = stc.reflex_max_step_height
                if hp is not None and hm >= 0.0:
                    # Reflex re-planning from the hitpoint
                    # (reference scipy_swing_trajectory_generator.py:25-47).
                    lo[leg] = np.asarray(hp, np.float32)
                    period[leg] = max(stc.swing_period - hm, 1e-3)
                    t_eff[leg] = t_eff[leg] - hm
            swing_mask = (np.asarray(self.current_contact) == 0).astype(np.float32)
            td = np.asarray(nmpc_footholds.data, np.float32).copy()
            # Swing-target overdrive (see config.sim.touchdown_overdrive): aim the
            # curve end slightly below the planned foothold so contact is made
            # before the gait timer declares stance. MPC footholds are untouched.
            td[:, 2] -= self.cfg.sim.touchdown_overdrive
            # Pure host numpy: this is ~1k scalar FLOPs per tick; the jitted twin
            # is a chain of tiny-shape device ops bound by per-op latency, plus a
            # host round trip. See swing_refs_np.
            from ..gait.swing import swing_refs_np
            from ..utils.frames import euler_xyz_to_rot_np

            pos, vel, acc = swing_refs_np(self.stc.generator, t_eff, period, step_h,
                                          lo, td,
                                          liftoff_boost=self.stc.liftoff_boost,
                                          v0=v0, v0_mask=v0_mask)
            m = swing_mask[:, None].astype(np.float64)
            # Stance legs HOLD their current position: their IK/PD target must
            # not be the NEXT foothold (td), or the joint impedance drags planted
            # feet toward future touchdowns — measured sliding stance feet off
            # stepping stones. Feedforward tau = -J^T f carries stance; the PD
            # contributes ~zero there (reference sim applies feedforward only,
            # simulation.py:683-696).
            feet_arr = np.asarray(feet_pos.data, np.float64)
            des_foot_pos = m * pos + (1.0 - m) * feet_arr
            des_foot_vel = m * vel
            des_acc = m * acc
            # Reach-aware command clamp (config sim.swing_reach_clamp): a swing
            # command outside the leg's physical sphere slams the knee into its
            # joint limit at full extension and the limit impulse flings the
            # foot (measured chasm hop traces). Clamp the command onto the
            # sphere around the CURRENT hip and kill the outward-radial
            # commanded velocity; the foot then presses at the boundary and
            # completes the touchdown as the base advances.
            if self.cfg.sim.swing_reach_clamp > 0.0:
                R_b = euler_xyz_to_rot_np(base_rpy)
                hips_w = np.asarray(base_pos)[None, :] + self._hip_off @ R_b.T
                r_safe = self.cfg.sim.swing_reach_clamp * self._leg_reach
                for leg in range(4):
                    if self.current_contact[leg] == 0:
                        v = des_foot_pos[leg] - hips_w[leg]
                        d = float(np.linalg.norm(v))
                        if d > r_safe:
                            # While clamped and still far from the touchdown
                            # target in xy, hold ALTITUDE instead of descending
                            # along the curve — a clamped descent lands short
                            # on whatever is under the ray (measured: hind
                            # hops accepted rim landings 0.12 m from center).
                            # The late-touchdown hold defers the timer; the
                            # advancing base sweeps the sphere forward and the
                            # descent completes over the target.
                            dxy = float(np.linalg.norm(td[leg, :2]
                                                       - des_foot_pos[leg, :2]))
                            if dxy > 0.04:
                                des_foot_pos[leg, 2] = max(
                                    des_foot_pos[leg, 2], td[leg, 2] + 0.05)
                                v = des_foot_pos[leg] - hips_w[leg]
                                d = float(np.linalg.norm(v))
                            u = v / d
                            des_foot_pos[leg] = hips_w[leg] + u * r_safe
                            out_rad = float(des_foot_vel[leg] @ u)
                            if out_rad > 0.0:
                                des_foot_vel[leg] -= out_rad * u
                            des_acc[leg] = 0.0
            des_q = self.ik.ik_world_np(des_foot_pos, np.asarray(base_pos),
                                        euler_xyz_to_rot_np(base_rpy))
            from ..gait.swing import swing_cartesian_torque
            feet = np.asarray(feet_pos.data)
            fvel = np.asarray(feet_vel.data)
            jdot = np.asarray(feet_jac_dot.data)
            qd = np.asarray(qvel_js.data).reshape(4, 3)
            h_b = np.asarray(legs_qfrc_bias.data).reshape(4, 3)
            M = np.asarray(legs_mass_matrix.data)
            for leg in range(4):
                if self.current_contact[leg] == 0:
                    tau[leg] = swing_cartesian_torque(
                        des_foot_pos[leg], des_foot_vel[leg], des_acc[leg],
                        feet[leg], fvel[leg], jac[leg], jdot[leg], qd[leg],
                        h_b[leg], M[leg], stc.position_gain_fb,
                        stc.velocity_gain_fb, stc.use_feedback_linearization)
        else:
            for leg, leg_name in enumerate(LEGS):
                if self.current_contact[leg] == 0:
                    t, p, v = self.stc.compute_swing_control_cartesian_space(
                        leg_id=leg,
                        q_dot=np.asarray(qvel_js[leg_name]).reshape(3),
                        J=jac[leg],
                        J_dot=np.asarray(feet_jac_dot[leg_name]),
                        lift_off=self.frg.lift_off_positions[leg_name],
                        touch_down=(np.asarray(nmpc_footholds[leg_name]).reshape(3)
                                    - np.array([0.0, 0.0,
                                                self.cfg.sim.touchdown_overdrive])),
                        foot_pos=np.asarray(feet_pos[leg_name]),
                        foot_vel=np.asarray(feet_vel[leg_name]),
                        h=np.asarray(legs_qfrc_bias[leg_name]).reshape(3),
                        mass_matrix=np.asarray(legs_mass_matrix[leg_name]),
                        early_stance_hitmoment=(self.esd.hitmoments[leg]
                                                if self._reflex_replanning else -1.0),
                        early_stance_hitpoint=(self.esd.hitpoints[leg]
                                               if self._reflex_replanning else None),
                    )
                    tau[leg] = t
                    des_foot_pos[leg] = p
                    des_foot_vel[leg] = v
                else:
                    # Hold current position (see fused-path comment above).
                    des_foot_pos[leg] = np.asarray(feet_pos[leg_name]).reshape(3)

        self.last_des_foot_pos = Legs(des_foot_pos.copy())
        self._last_des_foot_vel = des_foot_vel.copy()

        # Friction compensation (reference :411-415).
        if self.stc.use_friction_compensation and legs_qfrc_passive is not None:
            tau = tau - np.asarray(legs_qfrc_passive.data)

        # IK -> joint PD targets (reference :425-438).
        if not self._fused_host_path:
            des_q = self.ik.compute_solution(
                np.asarray(base_pos), np.asarray(base_rpy), des_foot_pos[0],
                des_foot_pos[1], des_foot_pos[2], des_foot_pos[3]).reshape(4, 3)
        des_qd = np.zeros((4, 3))
        for leg in range(4):
            # Damped inverse (see swing_cartesian_torque): a near-singular leg
            # otherwise yields huge joint-velocity targets.
            Jm = jac[leg]
            des_qd[leg] = Jm.T @ np.linalg.inv(Jm @ Jm.T + 2e-3 * np.eye(3)) \
                @ des_foot_vel[leg]

        # Kinodynamic variant: the OCP's joint trajectories override the IK targets
        # (reference wb_interface.py:440-443).
        if nmpc_joints_pos is not None:
            des_q = np.asarray(nmpc_joints_pos)[0].reshape(4, 3)
            if nmpc_joints_vel is not None:
                des_qd = np.asarray(nmpc_joints_vel)[0].reshape(4, 3)

        # Saturation (reference :446-465).
        q_now = np.asarray(qpos_js.data).reshape(4, 3)
        qd_now = np.asarray(qvel_js.data).reshape(4, 3)
        des_q = q_now + np.clip(des_q - q_now, -3.0, 3.0)
        des_qd = qd_now + np.clip(des_qd - qd_now, -10.0, 10.0)

        return Legs(tau), Legs(des_q), Legs(des_qd)

    def reset(self, initial_feet_pos: Legs):
        self.pgg.reset()
        self.frg.lift_off_positions = Legs(np.asarray(initial_feet_pos.data).copy())
        if self.vfa is not None:
            self.vfa.reset()
        self.esd.reset()
        self.current_contact = np.ones(4)
        self._last_td_targets = None  # (4, 3) swing touchdown targets
        self._hold_active = np.zeros(4, bool)  # late-touchdown hold latch
        self._hold_ticks = np.zeros(4, int)  # hold duration (safety cap)
        self.previous_contact = np.ones(4)
        self._last_des_foot_vel = np.zeros((4, 3))
        self._vel_hist.clear()
