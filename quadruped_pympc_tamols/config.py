"""Typed, frozen, jit-static configuration for the quadruped MPC framework.

This replaces the reference's module-level dict/global config system
(reference quadruped_pympc/config.py:72-281) with hashable frozen dataclasses that
can close over jitted solver factories (static under XLA tracing). Robot physical
constants (mass/inertia per robot) mirror the values in the reference config
(config.py:19-66); hip heights approximate the gym_quadruped RobotConfig values the
reference pulls in at config.py:11-16.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np

GRAVITY = 9.81

# Leg ordering used everywhere: index 0=FL, 1=FR, 2=RL, 3=RR.
LEGS = ("FL", "FR", "RL", "RR")


class GaitType(enum.IntEnum):
    """Gait families (reference: helpers/quadruped_utils.py:12-22)."""

    TROT = 0
    PACE = 1
    BOUNDING = 2
    CIRCULARCRAWL = 3
    BFDIAGONALCRAWL = 4
    BACKDIAGONALCRAWL = 5
    FRONTDIAGONALCRAWL = 6
    FULL_STANCE = 7
    # Direct-register crawl (beyond the reference's six): per-side
    # front-then-hind swing order FL -> RL -> FR -> RR, so each front foot
    # VACATES its foothold one beat before the same-side hind arrives. On
    # stone lattices a hind leg must time-share the front leg's stone (one
    # stone per column per lane); every reference crawl swings the hind
    # BEFORE its front vacates, and the planner's foot-separation exclusion
    # then (correctly) pushes the hind to the stone's rim (measured on the
    # chasm: RL targeted d=0.09 rim cells whenever FL still stood on the
    # column-2 stone).
    REGISTERCRAWL = 8


# Per-leg phase offsets for each gait (reference: helpers/periodic_gait_generator.py:24-39).
GAIT_PHASE_OFFSETS: dict[GaitType, Tuple[float, float, float, float]] = {
    GaitType.TROT: (0.5, 1.0, 1.0, 0.5),
    GaitType.PACE: (0.8, 0.3, 0.8, 0.3),
    GaitType.BOUNDING: (0.5, 0.5, 0.0, 0.0),
    GaitType.CIRCULARCRAWL: (0.0, 0.25, 0.75, 0.5),
    GaitType.BFDIAGONALCRAWL: (0.0, 0.25, 0.5, 0.75),
    GaitType.BACKDIAGONALCRAWL: (0.0, 0.5, 0.75, 0.25),
    GaitType.FRONTDIAGONALCRAWL: (0.5, 1.0, 0.75, 1.25),
    GaitType.FULL_STANCE: (0.0, 0.5, 0.5, 0.0),
    # Swing windows (duty 0.8): FL (0.05-0.25), FR (0.30-0.50),
    # RL (0.55-0.75), RR (0.80-1.00) — fronts first, then hinds, sides
    # alternating; each hind arrives a HALF CYCLE after its front vacated
    # (the same-side-consecutive variant (0.75, 0.25, 0.5, 0.0) demanded a
    # front-right -> back-left ZMP jump in 0.05 phase and fell on the deck).
    GaitType.REGISTERCRAWL: (0.75, 0.5, 0.25, 0.0),
}


@dataclasses.dataclass(frozen=True)
class RobotParams:
    """Physical constants of a quadruped robot.

    ``inertia`` is a row-major 3x3 tuple-of-tuples so the dataclass stays hashable
    (jit-static). Use :meth:`inertia_matrix` for the ndarray view.
    """

    name: str
    mass: float
    inertia: Tuple[Tuple[float, float, float], ...]
    hip_height: float
    # Kinematic reach band used by the TAMOLS planner (reference config.py:234-237).
    l_min: float = 0.15
    l_max: float = 0.45
    # Leg geometry for the analytic FK/IK (hip->thigh offset, thigh & calf lengths)
    # and hip-joint placement on the trunk (|x|, |y| of the hip joints in base frame).
    hip_offset_y: float = 0.083
    thigh_length: float = 0.25
    calf_length: float = 0.25
    hip_x: float = 0.2399
    hip_y: float = 0.051
    # Per-joint (lower, upper) limits for (hip-roll, hip-pitch, knee); used by the
    # QP IK's box constraints (counterpart of the URDF limits the reference's QP IK
    # reads through Pinocchio, inverse_kinematics_qp.py:33-49).
    joint_limits: Tuple[Tuple[float, float], ...] = (
        (-0.87, 0.87), (-1.0, 3.9), (-2.77, -0.60))
    # Optional per-robot override of the mass-proportional scale used by
    # make_config (None -> max(1, mass/aliengo_mass)). NOTE: the scale applies to
    # BOTH the swing/impedance gains AND the sampling exploration sigmas (Newtons).
    # Empirical: very light robots chatter at the aliengo gains (mini_cheetah walks
    # at 0.5, falls at 1.0).
    gain_scale: float | None = None

    def inertia_matrix(self) -> np.ndarray:
        return np.asarray(self.inertia, dtype=np.float64)


def _sym(m: np.ndarray) -> Tuple[Tuple[float, float, float], ...]:
    return tuple(tuple(float(v) for v in row) for row in m)


_GO_INERTIA = _sym(
    np.array(
        [
            [1.58460467e-01, 1.21660000e-04, -1.55444692e-02],
            [1.21660000e-04, 4.68645637e-01, -3.12000000e-05],
            [-1.55444692e-02, -3.12000000e-05, 5.24474661e-01],
        ]
    )
)
_ALIENGO_INERTIA = _sym(
    np.array(
        [
            [0.2310941359705289, -0.0014987128245817424, -0.021400468992761768],
            [-0.0014987128245817424, 1.4485084687476608, 0.0004641447134275615],
            [-0.021400468992761768, 0.0004641447134275615, 1.503217877350808],
        ]
    )
)
_HYQ_INERTIA = _sym(
    np.array(
        [
            [4.55031444e00, 2.75249434e-03, -5.11957307e-01],
            [2.75249434e-03, 2.02411774e01, -7.38560592e-04],
            [-5.11957307e-01, -7.38560592e-04, 2.14269772e01],
        ]
    )
)

# Mass/inertia values per robot mirror reference config.py:19-66; l_min/l_max mirror
# the tamols_params tables at config.py:234-237.
ROBOTS: dict[str, RobotParams] = {
    # go1 stands ~0.27 m; at 0.30 (63% of total reach left) an out-of-reach swing
    # target occurs every few strides and the trot stalls at ~0.1 m/s (measured;
    # at 0.27 the nominal family tracks 0.25 m/s with vel_err 0.05).
    "go1": RobotParams("go1", 12.019, _GO_INERTIA, hip_height=0.27, l_min=0.15, l_max=0.45,
                       hip_offset_y=0.08, thigh_length=0.213, calf_length=0.213,
                       hip_x=0.1881, hip_y=0.04675),
    "go2": RobotParams("go2", 15.019, _GO_INERTIA, hip_height=0.28, l_min=0.15, l_max=0.45,
                       hip_offset_y=0.0955, thigh_length=0.213, calf_length=0.213,
                       hip_x=0.1934, hip_y=0.0465),
    "aliengo": RobotParams("aliengo", 24.637, _ALIENGO_INERTIA, hip_height=0.35, l_min=0.1,
                           l_max=0.55, hip_offset_y=0.083, thigh_length=0.25, calf_length=0.25,
                           hip_x=0.2399, hip_y=0.051),
    "b2": RobotParams("b2", 83.49, _ALIENGO_INERTIA, hip_height=0.485, l_min=0.25, l_max=0.75,
                      hip_offset_y=0.12, thigh_length=0.35, calf_length=0.35,
                      hip_x=0.3285, hip_y=0.072),
    "hyqreal1": RobotParams("hyqreal1", 108.40, _HYQ_INERTIA, hip_height=0.5, l_min=0.25,
                            l_max=0.75, hip_offset_y=0.11, thigh_length=0.36, calf_length=0.38,
                            hip_x=0.44, hip_y=0.112),
    "hyqreal2": RobotParams("hyqreal2", 126.69, _HYQ_INERTIA, hip_height=0.5, l_min=0.25,
                            l_max=0.75, hip_offset_y=0.11, thigh_length=0.36, calf_length=0.38,
                            hip_x=0.44, hip_y=0.112),
    "mini_cheetah": RobotParams("mini_cheetah", 12.5, _GO_INERTIA, hip_height=0.225, l_min=0.12,
                                l_max=0.40, hip_offset_y=0.062, thigh_length=0.209, calf_length=0.195,
                                hip_x=0.19, hip_y=0.049, gain_scale=0.5),
    "spot": RobotParams("spot", 50.34, _ALIENGO_INERTIA, hip_height=0.48, l_min=0.20, l_max=0.60,
                        hip_offset_y=0.11, thigh_length=0.32, calf_length=0.33,
                        hip_x=0.29785, hip_y=0.055),
}


@dataclasses.dataclass(frozen=True)
class GaitParams:
    """One gait's timing (reference config.py:249-254)."""

    gait_type: GaitType = GaitType.TROT
    step_freq: float = 1.4
    duty_factor: float = 0.65

    @property
    def phase_offsets(self) -> Tuple[float, float, float, float]:
        return GAIT_PHASE_OFFSETS[self.gait_type]

    @property
    def stance_time(self) -> float:
        return self.duty_factor / self.step_freq

    @property
    def swing_period(self) -> float:
        return (1.0 - self.duty_factor) / self.step_freq


# Named gait presets (reference config.py:249-254).
GAITS: dict[str, GaitParams] = {
    "trot": GaitParams(GaitType.TROT, 1.4, 0.65),
    "pace": GaitParams(GaitType.PACE, 1.4, 0.7),
    "crawl": GaitParams(GaitType.BACKDIAGONALCRAWL, 0.5, 0.8),
    "crawl_register": GaitParams(GaitType.REGISTERCRAWL, 0.5, 0.8),
    "bound": GaitParams(GaitType.BOUNDING, 1.8, 0.65),
    "full_stance": GaitParams(GaitType.FULL_STANCE, 2.0, 0.65),
}


@dataclasses.dataclass(frozen=True)
class CostWeights:
    """Diagonal state-cost weights of the sampling MPC
    (reference controllers/sampling/centroidal_nmpc_jax.py:118-131)."""

    com_z: float = 1500.0
    vel_x: float = 200.0
    vel_y: float = 200.0
    vel_z: float = 200.0
    roll: float = 500.0
    pitch: float = 500.0
    yaw: float = 0.0
    rate_x: float = 20.0
    rate_y: float = 20.0
    rate_z: float = 50.0

    def as_vector(self) -> np.ndarray:
        """(12,) diagonal of Q over [pos(3), vel(3), rpy(3), rates(3)]."""
        return np.array(
            [0.0, 0.0, self.com_z, self.vel_x, self.vel_y, self.vel_z,
             self.roll, self.pitch, self.yaw, self.rate_x, self.rate_y, self.rate_z],
            dtype=np.float32,
        )


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Sampling-MPC knobs (reference config.py:175-190 and centroidal_nmpc_jax.py:39-41)."""

    method: str = "random_sampling"  # 'random_sampling' | 'mppi' | 'cem_mppi'
    parametrization: str = "cubic_spline"  # 'cubic_spline' | 'linear_spline' | 'zero_order'
    num_splines: int = 2
    num_samples: int = 10000
    num_iterations: int = 1
    sigma_mppi: float = 3.0
    sigma_cem_mppi: float = 3.0
    sigma_random: Tuple[float, float, float] = (0.2, 3.0, 10.0)
    shift_solution: bool = False
    # Noise-to-force scaling caps (reference centroidal_nmpc_jax.py:39-41).
    max_force_x: float = 10.0
    max_force_y: float = 10.0
    max_force_z: float = 30.0
    # Per-leg static-equilibrium gravity share instead of the uniform
    # m*g/n_stance split (rollout.equilibrium_share): on slopes the sampler then
    # explores around the correct fore/aft load distribution instead of
    # rediscovering it after every lift-off reset. False = reference parity.
    equilibrium_share: bool = False
    # Host-side async pipelining (the sampling twin of the RTI prepare/feedback
    # split): each tick DISPATCHES this tick's solve without blocking and
    # consumes the PREVIOUS tick's (by now completed) result — one-tick-stale
    # GRFs, same latest-available-solution semantics as the reference's
    # thread/queue MPC modes (ros2/run_controller.py:231-303). Hides the
    # device round trip behind the plant step.
    pipelined: bool = False
    mppi_temperature: float = 1.0
    cem_elite: int = 10
    cem_sigma_min: float = 0.2
    cem_sigma_max: float = 5.0
    # ZMP-band rollout COST — the sampling family's analogue of the gradient
    # family's soft ZMP band constraint (gradient.use_zmp_stability; reference
    # centroidal_nmpc_nominal.py:914-934): during 2-stance phases, rollouts
    # whose ZMP approximation leaves the stance support segment by more than
    # zmp_margin pay quadratically. Built for the stone-field regime where
    # mixed-height stances destabilized the sampling family (round-5 attempt
    # ladder, test_sampling_family_stone_field_entry). 0 = reference parity
    # (compiles to nothing).
    zmp_weight: float = 0.0
    zmp_margin: float = 0.04


@dataclasses.dataclass(frozen=True)
class GradientParams:
    """Gradient-MPC knobs (reference config.py:105-171)."""

    use_RTI: bool = False
    as_rti_type: str = "Standard"  # Standard | AS-RTI-A..D
    as_rti_iter: int = 1
    use_DDP: bool = False
    ddp_iters: int = 4
    num_qp_iterations: int = 1
    solver_mode: str = "balance"  # balance | robust | speed | crazy_speed
    # The reference knob controls an EXPLICIT pre-solve trajectory fill
    # (centroidal_nmpc_nominal.py:1048-1113) on top of acados' internal
    # previous-solution memory. Here the solver's RTI-shifted U_warm IS that
    # internal memory (sqp.py), so the always-on behavior maps to acados'
    # default and this flag is config-surface parity only.
    use_warm_start: bool = False
    use_integrators: bool = False
    alpha_integrator: float = 0.1
    integrator_cap: Tuple[float, ...] = (0.5, 0.2, 0.2, 0.0, 0.0, 1.0)
    use_foothold_optimization: bool = False
    use_foothold_constraints: bool = False
    # Half-widths (x, y) of the foothold box around the reference foothold when
    # use_foothold_constraints (the VFA/TAMOLS box emission,
    # visual_foothold_adaptation.py:213-222).
    foothold_box_halfwidth: Tuple[float, float] = (0.15, 0.1)
    use_static_stability: bool = False
    use_zmp_stability: bool = False
    trot_stability_margin: float = 0.04
    pace_stability_margin: float = 0.1
    crawl_stability_margin: float = 0.04
    # L1/L2 penalty weights of the SOFT constraint rows (acados zl/Zl,
    # reference centroidal_nmpc_nominal.py:147-163; defaults are the
    # reference's). Tunable per deployment: at zl=1000 an active stability row
    # is near-hard — once the IPM's soft path became f64-accurate (the
    # w_cap/lam0 fix, see qp.py) configurations tuned against the old
    # under-enforced solver needed their slack weights re-tuned rather than
    # relying on solver mushiness (measured: the chasm crawl's ZMP band).
    slack_l1: float = 1000.0
    slack_l2: float = 1.0
    use_input_prediction: bool = False
    external_wrenches_compensation: bool = True
    external_wrenches_compensation_num_step: int = 15
    passive_arm_compensation: bool = True
    # Lyapunov variant gains (reference config.py:167-170).
    K_z1: Tuple[float, float, float] = (1.0, 1.0, 10.0)
    K_z2: Tuple[float, float, float] = (1.0, 4.0, 10.0)
    residual_dynamics_upper_bound: float = 30.0
    use_residual_dynamics_decay: bool = False
    # QP algorithm: 'mehrotra' (predictor-corrector, HPIPM-style; ~half the
    # factorizations of 'basic' at equal accuracy) | 'basic' (fixed-sigma PDIP).
    qp_algorithm: str = "mehrotra"
    # Interior-point QP iteration budget for the 'basic' algorithm; mirrors HPIPM
    # mode caps (reference centroidal_nmpc_nominal.py:242-251).
    qp_iters: int = 18
    qp_iters_speed: int = 10
    qp_iters_crazy_speed: int = 5
    levenberg_marquardt: float = 1e-3
    # Per-leg minimum normal force [N] on STANCE legs (hard rows in the
    # friction-cone block; swing legs keep fz >= grf_min = 0). On sparse
    # terrain the optimizer otherwise unloads a stone foot to near-zero normal
    # force during weight transfers, where any lateral force request exits the
    # friction cone and the foot slides off the stone (round-4 chasm
    # postmortem measured stance feet sliding up to 9 cm across their stones
    # during roll onsets). A floor of ~10-20 N keeps every planted foot's cone
    # open. 0 = reference parity (no such constraint in acados' cone rows,
    # centroidal_nmpc_nominal.py:430-499).
    stance_min_force: float = 0.0
    # Riccati backward pass for the DDP solver: 'sequential' (O(H) scan),
    # 'associative' (O(log H)-depth associative scan, SURVEY 2.7/P5 — the
    # parallel-in-time formulation in parallel_riccati.py), or 'auto'
    # (associative for horizons >= 24, where stage-parallelism beats the
    # sequential recursion's latency; sequential for the production H=12).
    riccati_backward: str = "auto"


@dataclasses.dataclass(frozen=True)
class TamolsParams:
    """TAMOLS foothold-scoring parameters (reference config.py:209-243)."""

    # Swing fraction at which adaptation triggers (reference: mid-swing apex,
    # wb_interface.py:232; earlier leaves more swing time to reach the stone).
    trigger_phase: float = 0.5
    # Re-plan the remaining swing from the current foot position when adaptation
    # moves the touchdown > 3 cm (otherwise the foot descends on the stale
    # lift-off curve and lands short of the moved target).
    retarget_swing: bool = True
    # Velocity-matched retargets (round-5 chasm mechanism): the re-plan starts
    # from the COMMANDED point at the commanded velocity with a
    # continuity-preserving apex, instead of the measured foot with the v=0
    # clamp and a fresh full apex. Essential for long lattice hops (the v=0
    # restart commands a velocity discontinuity the swing PD turns into a
    # fling); default OFF for parity with the round-4-tuned course runs.
    retarget_velocity_match: bool = False
    # Flight-time-aware reach model (round-4 chasm postmortem: the planner
    # happily selected a column-2 stone 0.4 m away with 0.2 s of swing left,
    # and the executed hop landed ~20 cm short). When > 0, a candidate is
    # HARD-infeasible for a swinging leg unless the remaining swing time can
    # physically close the xy distance from the foot's CURRENT position at
    # this achievable mean foot speed [m/s]; stance legs are gated with the
    # full swing period (their swing starts fresh). An all-infeasible result
    # falls through to tamols.fallback, i.e. "can't reach anything safe in
    # time -> land on known ground now, hop NEXT swing with full time".
    # <= 0 disables (reference parity: the reference's reach constraint is
    # leg-length only, visual_foothold_adaptation.py:375-395).
    max_foot_speed: float = 0.0
    # Evaluate the kinematic reach band at the PREDICTED hip at touchdown
    # (hip + v * t_remain, capped at 1 s) instead of the current hip
    # (reference parity: visual_foothold_adaptation.py:375-395 uses the
    # current hip; its lift-off check already predicts hip + v * 0.3).
    # On a forward lattice walk the current hip UNDERSTATES reach for forward
    # candidates by v * t_swing — measured on the chasm: the hind legs' next
    # column sat at 0.57 m from the current hip (infeasible at l_max = 0.55)
    # but 0.52 m from the hip at touchdown, so every hind adaptation re-landed
    # on its old column and the body outran its support polygon.
    predict_hip_at_touchdown: bool = False
    # Candidate search radius around the seed foothold: heightmap cells beyond
    # it are infeasible (reference visual_foothold_adaptation.py:245-259 builds
    # its grid within this radius). search_resolution is that grid's step; here
    # candidates ARE the heightmap cells, so heightmap_resolution plays the role.
    search_radius: float = 0.32
    # Along-heading semi-axis of the (elliptical) candidate search region; the
    # default (= search_radius) is the reference's isotropic disc. Shrink for
    # sparse terrain: forward snaps land at the reach limit (see planner/tamols.py).
    search_radius_forward: float = 0.32
    # Backward semi-axis: a touchdown moved BEHIND the Raibert seed mid-swing
    # demands a velocity reversal the leg cannot track (measured forward
    # overshoots of 0.2+ m onto stone rims). Default keeps the isotropic disc.
    search_radius_back: float = 0.32
    search_resolution: float = 0.04
    gradient_delta: float = 0.04
    weight_edge_avoidance: float = 10.0
    weight_roughness: float = 10.0
    weight_deviation: float = 2.0
    # Declared by the reference but its cost term is commented out there
    # (visual_foothold_adaptation.py:323-330, '这个cost有很大问题'); kept for
    # config-surface parity, intentionally unused — nominal_kinematic covers it.
    weight_kinematic: float = 2.0
    weight_nominal_kinematic: float = 0.0
    weight_reference_tracking: float = 10.0
    weight_stability: float = 20.0
    stability_margin: float = 0.06
    stability_hard: bool = False
    stability_soft: bool = True
    estimated_swing_time: float = 0.25
    h_des: float = 0.35  # defaults to robot hip height when built via make_config
    slope_threshold: float = 0.7
    constraint_box_dx: float = 0.05
    constraint_box_dy: float = 0.05
    # Full-foot-support hard constraint: reject candidates whose +-gradient_delta
    # patch, after plane detrending (smooth slopes pass; the projector is the
    # roughness term's), spans more than this residual range — the foot would
    # straddle a ledge (stone rims, stair noses). A 5 cm ledge leaves a ~0.02-0.035
    # residual span depending on where the edge cuts the patch, so ~0.015 is a
    # good working value. >=1.0 disables it (reference parity: the reference has
    # no such term and lands on rims its edge cost can't see).
    support_margin: float = 1.0
    # Soft companion to support_margin: penalty weight on the height span of a
    # wider (+-2*gradient_delta) ring, pushing the argmin toward stone/pocket
    # INTERIORS instead of the first feasible cell past a rim (landing margin
    # against swing-tracking error). Active only when support_margin < 1.
    weight_support: float = 20.0
    # Leg-crossing hard guard: candidates less than this far onto the leg's own
    # side of the body centerline (yaw-aligned frame) are infeasible. Prevents
    # stance-width collapse when sparse terrain pulls both same-axle feet toward
    # one stone. <=0 disables (reference parity: no such constraint there).
    lateral_margin: float = 0.0
    # Foot-collision exclusion: candidates closer than this (xy) to any OTHER
    # leg's current foot are infeasible (base sway can otherwise double-book one
    # stone for two legs). <=0 disables (reference parity).
    foot_separation: float = 0.0
    # Lattice progression for LATTICE terrains (the chasm stress scene: stones
    # on a fixed pitch over deep gaps). Round 3's bimodal stay/hop anchor cost
    # (stride_pitch) REGRESSED field entry — its discounted "stay" anchor made
    # re-landing in place the cheapest feasible choice exactly where
    # progression had to happen (measured; see the round-3 README postmortem)
    # — and is deleted. This redesign follows that postmortem: never discount
    # "stay", and let the terrain feasibility masks pick the target ahead.
    # When min_advance > 0, candidates that advance less than min_advance
    # along the heading FROM THE LEG'S CURRENT FOOT pay a quadratic penalty
    # (saturated at min_advance, so where no feasible cell ahead exists the
    # near cells tie and the baseline costs decide — field entry from the
    # deck proceeds un-anchored); the support/rim/reach masks then make the
    # nearest plateau interior at least min_advance ahead the argmin.
    # <=0 disables (default; no reference counterpart).
    min_advance: float = 0.0
    weight_progression: float = 30.0
    # Progression engages PER LEG, only where the terrain within
    # progression_foot_radius of the leg's CURRENT foot spans more than
    # gate_range of height — i.e. the foot itself stands on the gap lattice
    # (or at the deck edge, one stride from the first column). Round 3 gated
    # on the whole sensing window and engaged while the feet were still
    # mid-deck (measured again with an in-radius gate: 0.35 m deck
    # strides, y-drift and a roll at the deck edge).
    progression_gate_range: float = 0.15
    progression_foot_radius: float = 0.15
    # When NO candidate passes the hard constraints: 'seed' falls back to the
    # height-snapped Raibert seed (reference parity,
    # visual_foothold_adaptation.py:223-228); 'foot' re-lands on the leg's
    # CURRENT foothold — on gap lattices the seed under a drifting base is
    # often a rim/gap cell (measured on the chasm: an all-infeasible FR fell
    # back onto a stone rim and the robot rolled), while the current foot is
    # known solid ground.
    fallback: str = "seed"
    # Sensor z-offset applied by heightmap lookups (reference visual_foothold_adaptation.py:35).
    sensor_z_offset: float = 0.02
    # Per-leg heightmap sensing window (rows along heading x cols lateral, at
    # `resolution` m/cell). Defaults mirror the reference's 13x7 @ 4 cm sensors
    # (simulation.py:489-509). Sparse terrains (stepping stones) need a wider
    # LATERAL window: with 7 cols (+-0.14 m) a seed in the dead zone between
    # stone columns only ever sees stone RIMS, so the planner walks the robot
    # along edges; 13 cols (+-0.26 m) reaches the neighbors' interiors.
    heightmap_rows: int = 13
    heightmap_cols: int = 7
    heightmap_resolution: float = 0.04


@dataclasses.dataclass(frozen=True)
class MPCParams:
    """Shared MPC shape/limits (reference config.py:72-103)."""

    type: str = "sampling"  # 'nominal'|'input_rates'|'sampling'|'collaborative'|'lyapunov'|'kinodynamic'
    horizon: int = 12
    dt: float = 0.02
    mu: float = 0.5
    grf_max: float = 241.69  # mass*g by default; rebuilt in make_config
    grf_min: float = 0.0
    use_nonuniform_discretization: bool = False
    horizon_fine_grained: int = 2
    dt_fine_grained: float = 0.01
    optimize_step_freq: bool = False
    step_freq_available: Tuple[float, ...] = (1.4, 2.0, 2.4)
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    gradient: GradientParams = dataclasses.field(default_factory=GradientParams)
    cost: CostWeights = dataclasses.field(default_factory=CostWeights)

    def dts(self) -> np.ndarray:
        """Per-stage integration steps, honoring nonuniform discretization
        (reference centroidal_model_jax.py:42-53)."""
        if self.use_nonuniform_discretization:
            fine = np.full(self.horizon_fine_grained, self.dt_fine_grained)
            coarse = np.full(self.horizon - self.horizon_fine_grained, self.dt)
            return np.concatenate([fine, coarse]).astype(np.float32)
        return np.full(self.horizon, self.dt, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Simulation / whole-body-layer knobs (reference config.py:194-281)."""

    dt: float = 0.002
    mpc_frequency: float = 100.0
    gait: str = "trot"
    # 'bezier_ref' | 'scipy' | 'explicit'. 'scipy' is an accepted alias of
    # 'bezier_ref': the reference's scipy generator exists for its reflex
    # re-planning, which the bezier path implements natively (gait/swing.py
    # compute_trajectory_references).
    swing_generator: str = "bezier_ref"
    # Stiffer than the reference's 500/10 (config.py:198-199): with 500/10 the swing
    # feet droop ~4 cm below the commanded arc, graze the ground mid-swing, and the
    # braking impulse destabilizes the (absolute-force) gradient controllers. 1000/20
    # tracks the arc cleanly for both solver families.
    swing_position_gain_fb: float = 1000.0
    swing_velocity_gain_fb: float = 20.0
    impedance_joint_position_gain: float = 10.0
    impedance_joint_velocity_gain: float = 2.0
    step_height: float = 0.105  # 0.3*hip_height by default; rebuilt in make_config
    ref_z: float = 0.35  # hip_height by default
    visual_foothold_adaptation: str = "tamols"  # 'blind'|'height'|'tamols'
    # IK backend (reference wb_interface.py:10-11 selects by import):
    # 'analytic' (closed form, default) | 'numeric' (damped LS) | 'qp' (joint-limit QP).
    ik_solver: str = "analytic"
    # Raise the bezier's P1/P2 by (boost/2, boost)*step_height so the foot leaves
    # the ground with an upward initial velocity (gait/swing.py bezier_swing_refs).
    # 0 = the reference's v=a=0 liftoff clamp; ~1.0 helps sparse terrain where the
    # toe otherwise drags across the lift-off stone's far rim.
    swing_liftoff_boost: float = 0.0
    # Lower the SWING target below the planned foothold z by this much [m]. The
    # TAMOLS foothold z deliberately carries the reference's sensor offsets
    # (+0.02 FastHeightMap + 0.005 candidate lift, visual_foothold_adaptation.py
    # :31-35,:192) so the swing curve ends ~2.5 cm ABOVE the physical surface;
    # with the timer-driven stance handoff the foot is then still airborne when
    # the MPC starts loading it — measured on the stepping-stones course as a
    # nose-dive on late-contact front legs (a crawl's support triangle has no
    # redundancy). Overdriving the target presses the foot into real contact
    # before the timer flips. Applied to the swing/IK target only, never to the
    # MPC foothold.
    touchdown_overdrive: float = 0.0
    # Late-touchdown hold (gap-lattice extension, 0 disables): the gait TIMER
    # can flip a leg to stance while its foot is still high above the target
    # (measured on the chasm: a 0.2 m entry hop whose 0.2 s swing ran out of
    # time "landed" 0.2 m in the air — the MPC then allocated force to the
    # phantom support and the robot rolled within one step). With a hold, a
    # leg whose foot is more than this distance [m] above its commanded
    # touchdown point stays in SWING (the swing clock saturates, so the
    # controller keeps pressing it down onto the target) until it closes in.
    late_touchdown_hold: float = 0.0
    # Lateral companion to the hold (round 5): defer the stance flip while the
    # foot is more than this far [m] from its touchdown target in XY — a foot
    # that is LOW but laterally off gets accepted by the height-only hold and
    # loads a stone rim (measured: hind hops accepted at 2 cm above target but
    # 0.11 m lateral, on the rim). While held, the saturated swing clock keeps
    # commanding the target, buying the PD the lateral close. 0 disables.
    late_touchdown_hold_xy: float = 0.0
    # Reach-aware swing command clamp (fraction of the leg's PHYSICAL reach
    # sqrt(hip_offset_y^2 + (thigh+calf)^2); <= 0 disables = reference parity).
    # A swing target just outside the reachable sphere of the CURRENT hip
    # drives the knee into its joint limit at full extension, and the limit
    # impulse + saturated PD fling the foot (round-4/5 chasm traces: a clean
    # 0.41 m hop tracked to 2 cm, then the foot left at ~6 m/s the tick the
    # hip-to-command distance crossed the linkage length; the planner's
    # l_max=0.55 reach gate mirrors the reference and exceeds the real 0.50 m
    # linkage). Clamping the COMMAND to the sphere makes the foot press at the
    # boundary instead — as the base advances, the sphere sweeps forward and
    # the touchdown completes (the late-touchdown hold covers the timer).
    swing_reach_clamp: float = 0.0
    reflex_trigger_mode: str = "tracking"  # 'tracking'|'geom_contact'|'off'
    reflex_max_step_height: float = 0.175  # 0.5*hip_height
    velocity_modulator: bool = True
    scene: str = "flat"
    use_inertia_recomputation: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level immutable configuration bundle."""

    robot: RobotParams
    mpc: MPCParams
    sim: SimParams
    gait_params: GaitParams
    tamols: TamolsParams
    gravity: float = GRAVITY

    @property
    def hip_height(self) -> float:
        return self.robot.hip_height


def make_config(
    robot: str = "aliengo",
    mpc_type: str = "sampling",
    gait: str = "trot",
    **overrides,
) -> Config:
    """Build a fully-resolved Config with robot-derived defaults.

    Mirrors the derived values the reference computes at import time:
    grf_max = mass*g (config.py:90), step_height = 0.3*hip_height (config.py:202),
    ref_z = hip_height (config.py:266), tamols h_des = hip_height (config.py:231).
    """
    rp = ROBOTS[robot]
    # Mass-proportional scaling anchored at aliengo: leg inertia and required
    # forces grow with robot mass, so the Cartesian swing / joint-impedance gains
    # and the sampling exploration sigmas (which are in NEWTONS of force delta)
    # scale with it — an 83 kg b2 with aliengo gains has droopy swings (verified
    # closed-loop). Floored at 1: lighter robots track fine (better, measured) at
    # the aliengo values. Note max_force_x/y/z are consumed only as x/z, y/z cone
    # RATIOS (invariant under uniform scaling), so they stay at defaults.
    scale = rp.gain_scale if rp.gain_scale is not None \
        else max(1.0, rp.mass / ROBOTS["aliengo"].mass)
    s_rand = SamplingParams().sigma_random
    mpc = MPCParams(type=mpc_type, grf_max=rp.mass * GRAVITY,
                    sampling=SamplingParams(
                        sigma_mppi=3.0 * scale,
                        sigma_cem_mppi=3.0 * scale,
                        sigma_random=tuple(s * scale for s in s_rand)))
    sim = SimParams(gait=gait, step_height=0.3 * rp.hip_height, ref_z=rp.hip_height,
                    swing_position_gain_fb=1000.0 * scale,
                    swing_velocity_gain_fb=20.0 * scale,
                    impedance_joint_position_gain=10.0 * scale,
                    impedance_joint_velocity_gain=2.0 * scale)
    tam = TamolsParams(h_des=rp.hip_height)
    cfg = Config(robot=rp, mpc=mpc, sim=sim, gait_params=GAITS[gait], tamols=tam)
    if overrides:
        cfg = replace_config(cfg, **overrides)
    validate_config(cfg)
    return cfg


_ENUM_FIELDS = {
    "mpc.type": ("sampling", "nominal", "input_rates", "lyapunov", "collaborative",
                 "kinodynamic"),
    "mpc.sampling.method": ("random_sampling", "mppi", "cem_mppi"),
    "mpc.sampling.parametrization": ("zero_order", "linear_spline", "cubic_spline"),
    "mpc.gradient.solver_mode": ("balance", "robust", "speed", "crazy_speed"),
    "mpc.gradient.qp_algorithm": ("mehrotra", "basic"),
    "mpc.gradient.as_rti_type": ("Standard", "AS-RTI-A", "AS-RTI-B", "AS-RTI-C",
                                 "AS-RTI-D"),
    "mpc.gradient.riccati_backward": ("sequential", "associative", "auto"),
    "sim.swing_generator": ("bezier_ref", "scipy", "explicit"),
    "sim.visual_foothold_adaptation": ("blind", "height", "tamols"),
    "sim.reflex_trigger_mode": ("tracking", "geom_contact", "off"),
    "sim.ik_solver": ("analytic", "numeric", "qp"),
    "tamols.fallback": ("seed", "foot"),
}


def validate_config(cfg: Config) -> None:
    """Eager enum validation so a typo fails at construction, not at first solve
    (the reference's untyped dict config fails late; see SURVEY §5 config notes)."""
    for path, allowed in _ENUM_FIELDS.items():
        obj = cfg
        for p in path.split("."):
            obj = getattr(obj, p)
        if obj not in allowed:
            raise ValueError(f"config {path}={obj!r} not in {allowed}")


def replace_config(cfg: Config, **overrides) -> Config:
    """Functional update helper with dotted paths, e.g.
    ``replace_config(cfg, **{"mpc.sampling.method": "mppi"})``."""
    for path, value in overrides.items():
        parts = path.split(".")
        objs = [cfg]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        for obj, name in zip(reversed(objs), reversed(parts)):
            value = dataclasses.replace(obj, **{name: value})
        cfg = value
    validate_config(cfg)
    return cfg
