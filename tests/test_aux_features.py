"""Auxiliary feature coverage: nonuniform discretization, start-stop gait,
dataset generation, offline ZMP analysis, input prediction."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_pympc_tamols import GAITS, make_config, replace_config
from quadruped_pympc_tamols.config import GAIT_PHASE_OFFSETS, GaitType
from quadruped_pympc_tamols.gait import PeriodicGaitGenerator, make_timer_dts
from quadruped_pympc_tamols.utils.legs import Legs


def test_nonuniform_discretization_dts_and_timer():
    cfg = make_config("aliengo")
    cfg = replace_config(cfg, **{"mpc.use_nonuniform_discretization": True})
    dts = cfg.mpc.dts()
    assert dts.shape == (12,)
    np.testing.assert_allclose(dts[:2], 0.01, rtol=1e-5)
    np.testing.assert_allclose(dts[2:], 0.02, rtol=1e-5)
    # Timer offsets: fine steps while i < horizon_fine_grained, then coarse
    # (mirrors reference periodic_gait_generator.py:104-117 column stepping).
    t = make_timer_dts(cfg.mpc)
    assert t[0] == 0.0
    np.testing.assert_allclose(np.diff(t)[0], 0.01, rtol=1e-4)
    np.testing.assert_allclose(np.diff(t)[1:], 0.02, rtol=1e-4)


def test_nonuniform_sampling_solver_runs():
    from quadruped_pympc_tamols.controllers.sampling import SamplingMPC

    cfg = make_config("aliengo", mpc_type="sampling")
    cfg = replace_config(cfg, **{"mpc.use_nonuniform_discretization": True,
                                 "mpc.sampling.num_samples": 128})
    mpc = SamplingMPC(cfg, seed=0)
    state = dict(position=np.array([0.0, 0.0, 0.33]), linear_velocity=np.zeros(3),
                 orientation=np.zeros(3), angular_velocity=np.zeros(3),
                 foot_FL=np.array([0.25, 0.15, 0.0]), foot_FR=np.array([0.25, -0.15, 0.0]),
                 foot_RL=np.array([-0.25, 0.15, 0.0]), foot_RR=np.array([-0.25, -0.15, 0.0]))
    ref = dict(ref_position=np.array([0.0, 0.0, 0.35]), ref_linear_velocity=np.zeros(3),
               ref_orientation=np.zeros(3), ref_angular_velocity=np.zeros(3),
               ref_foot_FL=state["foot_FL"], ref_foot_FR=state["foot_FR"],
               ref_foot_RL=state["foot_RL"], ref_foot_RR=state["foot_RR"])
    out = mpc.compute_control(state, ref, np.ones((4, 12)), np.ones(4), np.ones(4))
    assert np.all(np.isfinite(np.asarray(out.grfs)))


def test_start_and_stop_gait():
    """Energy-saving start/stop (reference periodic_gait_generator.py:128-196):
    idle + feet under hips -> full stance; motion command -> gait restored."""
    cfg = make_config("aliengo")
    pgg = PeriodicGaitGenerator(GAITS["trot"], cfg.mpc.horizon)
    pgg.start_and_stop_activated = True
    rp = cfg.robot
    hips = Legs(np.array([[rp.hip_x, rp.hip_y, 0.35], [rp.hip_x, -rp.hip_y, 0.35],
                          [-rp.hip_x, rp.hip_y, 0.35], [-rp.hip_x, -rp.hip_y, 0.35]]))
    # Feet exactly under hips incl. the stance-width offset the check removes.
    feet = np.asarray(hips.data).copy()
    feet[:, 2] = 0.0
    feet[:, 1] += 0.1 * np.array([1, -1, 1, -1])
    feet = Legs(feet)
    base = np.array([0.0, 0.0, 0.35])
    pgg.update_start_and_stop(feet, hips, 0.1, base, np.zeros(3), np.zeros(3),
                              np.zeros(3), np.zeros(3), np.zeros(3), np.ones(4))
    assert pgg.gait_type == GaitType.FULL_STANCE
    seq = pgg.compute_contact_sequence(make_timer_dts(cfg.mpc))
    assert np.all(seq == 1.0)
    # Commanded motion restores the previous gait.
    pgg.update_start_and_stop(feet, hips, 0.1, base, np.zeros(3), np.zeros(3),
                              np.zeros(3), np.array([0.3, 0, 0]), np.zeros(3),
                              np.ones(4))
    assert pgg.gait_type == GaitType.TROT


def test_zmp_analysis_util():
    from quadruped_pympc_tamols.utils.analysis import (
        support_polygon_margin,
        zmp_from_grfs,
    )

    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0],
                     [-0.25, 0.15, 0], [-0.25, -0.15, 0]], float)
    grfs = np.tile([0.0, 0.0, 60.0], (4, 1))
    zmp = zmp_from_grfs(np.zeros(3), grfs, feet, np.ones(4))
    np.testing.assert_allclose(zmp, 0.0, atol=1e-9)  # symmetric load -> center
    # 4-stance: center is inside the polygon.
    assert support_polygon_margin(zmp, feet, np.ones(4)) > 0.1
    # Outside point.
    assert support_polygon_margin(np.array([1.0, 0.0]), feet, np.ones(4)) < 0
    # Diagonal 2-stance: margin is minus the distance to the segment.
    c2 = np.array([1.0, 0, 0, 1.0])
    m = support_polygon_margin(np.array([0.0, 0.0]), feet, c2)
    np.testing.assert_allclose(m, 0.0, atol=1e-9)  # center lies on the diagonal


@pytest.mark.skipif(pytest.importorskip("mujoco") is None, reason="mujoco")
def test_generate_dataset(tmp_path):
    from quadruped_pympc_tamols.sim.generate_dataset import generate_dataset

    cfg = make_config("aliengo", mpc_type="sampling", gait="full_stance")
    cfg = replace_config(cfg, **{"mpc.sampling.num_samples": 200,
                                 "sim.visual_foothold_adaptation": "blind"})
    paths = generate_dataset(cfg, str(tmp_path), num_episodes=1,
                             episode_duration_s=0.3, vel_range=(0.0, 0.0))
    assert os.path.exists(paths[0])
    data = np.load(paths[0])
    assert data["base_pos"].shape[0] > 100
    assert "ctrl__nmpc_GRFs" in data
    motion = np.load(os.path.join(tmp_path, "motion_0.npz"))
    assert motion["fps"] == 50.0
    assert motion["joints_pos"].shape[1:] == (4, 3)


def test_geom_contact_reflex_trigger():
    """geom_contact mode: a swing-leg contact whose normal opposes the swing
    direction (< 60 deg) triggers early stance; a grazing side contact does not."""
    from quadruped_pympc_tamols.gait.modulation import EarlyStanceDetector

    esd = EarlyStanceDetector(trigger_mode="geom_contact")
    feet = Legs(np.array([[0.25, 0.15, 0.05], [0.25, -0.15, 0.05],
                          [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]]))
    td = Legs(np.asarray(feet.data) + np.array([0.1, 0.0, -0.05]))  # forward-down
    lo = feet
    swing_time = [0.05, 0.05, 0.0, 0.0]
    current_contact = np.array([0, 0, 1, 1])
    # FL hits a wall: normal pointing backward into the foot (opposes swing dir).
    pts = [[(np.array([0.28, 0.15, 0.03]), np.array([-1.0, 0.0, 0.0]))],
           # FR grazes sideways: normal orthogonal to the swing direction.
           [(np.array([0.25, -0.17, 0.03]), np.array([0.0, 1.0, 0.0]))],
           [], []]
    esd.update_detection(feet, feet, lo, td, swing_time, 0.2, current_contact,
                         contact_points=pts)
    assert esd.early_stance[0] is True
    assert esd.hitpoints[0] is not None
    assert esd.hitmoments[0] == pytest.approx(0.05)
    assert esd.early_stance[1] is False
    # Touchdown clears the flag.
    esd.update_detection(feet, feet, lo, td, swing_time, 0.2,
                         np.array([1, 0, 1, 1]), contact_points=[[], [], [], []])
    assert esd.early_stance[0] is False


def test_env_feet_contact_points():
    mujoco_mod = pytest.importorskip("mujoco")
    del mujoco_mod
    from quadruped_pympc_tamols.sim.mujoco_env import QuadrupedEnv

    cfg = make_config("aliengo", **{"sim.visual_foothold_adaptation": "blind"})
    env = QuadrupedEnv(cfg, scene="flat")
    for _ in range(50):  # settle onto the ground
        env.step(Legs(np.zeros((4, 3))))
    pts = env.feet_contact_points()
    assert len(pts) == 4
    touching = [len(p) > 0 for p in pts]
    assert any(touching)
    for leg_pts in pts:
        for pos, normal in leg_pts:
            # Ground contact normal points up into the foot.
            assert normal[2] > 0.7


def test_h5_episode_export(tmp_path):
    pytest.importorskip("h5py")
    pytest.importorskip("mujoco")
    from quadruped_pympc_tamols.sim.generate_dataset import generate_dataset

    cfg = make_config("aliengo", mpc_type="sampling",
                      **{"mpc.sampling.num_samples": 200,
                         "sim.visual_foothold_adaptation": "blind"})
    generate_dataset(cfg, str(tmp_path), num_episodes=1, episode_duration_s=0.1,
                     h5=True)
    import h5py
    with h5py.File(tmp_path / "episode_0.h5", "r") as f:
        assert "base_pos" in f and "time" in f
        assert f["base_pos"].shape[1] == 3


def test_replace_config_validates():
    cfg = make_config("aliengo")
    with pytest.raises(ValueError, match="ik_solver"):
        replace_config(cfg, **{"sim.ik_solver": "bogus"})


def test_geom_contact_falls_back_to_tracking_without_points():
    """The runtime node has no physics engine: geom_contact mode with no contact
    points must still trigger on tracking error (safety regression)."""
    from quadruped_pympc_tamols.gait.modulation import EarlyStanceDetector

    esd = EarlyStanceDetector(trigger_mode="geom_contact")
    feet = Legs(np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.05],
                          [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]]))
    des = Legs(np.asarray(feet.data) + np.array([0.15, 0.0, 0.0]))  # big error
    td = Legs(np.asarray(feet.data) + np.array([0.2, 0.0, 0.0]))
    esd.update_detection(feet, des, feet, td, [0.05, 0.0, 0.0, 0.0], 0.2,
                         np.array([0, 1, 1, 1]), contact_points=None)
    assert esd.early_stance[0] is True


def test_logger_sigint_flush(tmp_path):
    import os as _os
    import signal

    from quadruped_pympc_tamols.observability.logger import EpisodeLogger

    path = str(tmp_path / "ep.npz")
    logger = EpisodeLogger(path, flush_every=10_000, flush_on_sigint=True)
    logger.buffers["x"].append(np.arange(3.0))
    with pytest.raises(KeyboardInterrupt):
        _os.kill(_os.getpid(), signal.SIGINT)
    assert _os.path.exists(path)
    assert np.allclose(np.load(path)["x"][0], [0, 1, 2])
    signal.signal(signal.SIGINT, signal.default_int_handler)


def test_late_touchdown_hold_defers_stance_flip():
    """sim.late_touchdown_hold: a timer swing->stance flip is refused while the
    foot is still above its touchdown target by more than the hold distance,
    and the latched target is immune to the airborne-foothold feedback (the
    MPC reports the held leg's airborne position as its foothold — without the
    latch that poisoned the comparison and released the hold mid-air)."""
    import numpy as np

    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.interfaces.wb_interface import WBInterface
    from quadruped_pympc_tamols.utils.legs import Legs

    cfg = make_config("aliengo", **{"sim.late_touchdown_hold": 0.06,
                                    "sim.visual_foothold_adaptation": "blind"})
    feet0 = Legs(np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                           [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]]))
    wb = WBInterface(cfg, feet0)
    hips = Legs(np.asarray(feet0.data) + np.array([0.0, 0.0, 0.35]))
    joints = Legs.zeros((3,))

    def tick(feet):
        wb.update_state_and_reference(
            com_pos=np.array([0.0, 0.0, 0.35]), base_pos=np.array([0.0, 0.0, 0.35]),
            base_lin_vel=np.array([0.2, 0.0, 0.0]), base_ori_euler_xyz=np.zeros(3),
            base_ang_vel=np.zeros(3), feet_pos=feet, hip_pos=hips,
            joints_pos=joints, heightmaps=None, simulation_dt=0.002,
            ref_base_lin_vel=np.array([0.2, 0.0, 0.0]),
            ref_base_ang_vel=np.zeros(3))

    # Targets on the ground for every leg.
    wb._last_td_targets = np.asarray(feet0.data, np.float64).copy()

    # Walk the gait timer until some leg swings, with its physical foot HIGH.
    held_seen = False
    for _ in range(3000):
        feet_arr = np.asarray(feet0.data).copy()
        swing = np.where(wb.current_contact == 0)[0]
        for leg in swing:
            feet_arr[leg, 2] = 0.25  # far above the target
        tick(Legs(feet_arr))
        # Any timer flip for a high foot must have been refused.
        for leg in range(4):
            if wb._hold_active[leg]:
                held_seen = True
                assert wb.current_contact[leg] == 0.0
                # Latched target survives an airborne-foothold update.
                old = wb._last_td_targets[leg].copy()
                poison = np.asarray(feet0.data, np.float64).copy()
                poison[leg, 2] = 0.25
                new_td = np.where(wb._hold_active[:, None],
                                  wb._last_td_targets, poison)
                np.testing.assert_allclose(new_td[leg], old)
        if held_seen:
            break
    assert held_seen, "the hold never engaged over a full gait cycle"

    # The held leg flips to stance once the foot reaches its target height.
    held = int(np.where(wb._hold_active)[0][0])
    feet_arr = np.asarray(feet0.data).copy()
    tick(Legs(feet_arr))  # foot back on the ground
    assert wb.current_contact[held] == 1.0
    assert not wb._hold_active[held]


def test_late_touchdown_hold_time_cap():
    """The hold releases after 0.5 s even when the target never becomes
    reachable (round-5 safety cap): a perpetual 3-legged stance is worse than
    an off-target contact."""
    import numpy as np

    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.interfaces.wb_interface import WBInterface
    from quadruped_pympc_tamols.utils.legs import Legs

    cfg = make_config("aliengo", **{"sim.late_touchdown_hold": 0.06,
                                    "sim.visual_foothold_adaptation": "blind"})
    feet0 = Legs(np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                           [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]]))
    wb = WBInterface(cfg, feet0)
    hips = Legs(np.asarray(feet0.data) + np.array([0.0, 0.0, 0.35]))
    joints = Legs.zeros((3,))

    def tick(feet):
        wb.update_state_and_reference(
            com_pos=np.array([0.0, 0.0, 0.35]), base_pos=np.array([0.0, 0.0, 0.35]),
            base_lin_vel=np.array([0.2, 0.0, 0.0]), base_ori_euler_xyz=np.zeros(3),
            base_ang_vel=np.zeros(3), feet_pos=feet, hip_pos=hips,
            joints_pos=joints, heightmaps=None, simulation_dt=0.002,
            ref_base_lin_vel=np.array([0.2, 0.0, 0.0]),
            ref_base_ang_vel=np.zeros(3))

    wb._last_td_targets = np.asarray(feet0.data, np.float64).copy()
    max_hold = np.zeros(4, int)
    for _ in range(4000):
        feet_arr = np.asarray(feet0.data).copy()
        for leg in np.where(wb.current_contact == 0)[0]:
            feet_arr[leg, 2] = 0.25  # target NEVER reachable
        tick(Legs(feet_arr))
        max_hold = np.maximum(max_hold, wb._hold_ticks)
    assert max_hold.max() > 0, "hold never engaged"
    # 0.5 s at the 2 ms tick = 250 ticks; the cap releases just past it.
    assert max_hold.max() <= 252, f"hold not capped: {max_hold}"
