"""Fully-jittable closed-loop scenario engine for on-device batched simulation.

The reference generates data by forking 4 OS processes, each running a full MuJoCo
sim + MPC (simulation/batched_simulations.py:22-58 — "thousands of scenarios" at 4 at
a time). Here the scenario loop itself becomes a pure function: gait timing,
foothold reference, sampling MPC solve, SRB physics and kinematic swing feet are all
jnp, so ONE vmap runs thousands of scenarios per device and shard_map spreads them
across a mesh (see parallel/sharded.py). This is the "training step" of this
framework: massively parallel MPC control loops.

Simplifications vs the host WBInterface (wb_interface.py), chosen to keep the state
pytree small while preserving the control structure: the base-velocity moving average
uses the instantaneous velocity and state knowledge is perfect. Reflexes have an
on-device analogue (``reflexes=True``, see make_scenario_step).

Terrain: pass ``terrain="boxes" | "stairs"`` to the step
factories and every scenario carries its OWN procedurally-generated heightfield as
pytree state (make_terrain_generator). Each tick then senses per-leg 13x13 grids
out of the scenario's heightfield and runs the SAME fused TAMOLS scorer as the
host stack (planner/tamols.py) to adapt the Raibert footholds; swing touch-downs
land on the terrain surface. ``terrain=None`` (default) keeps the original flat
fleet. Everything stays one pure function — thousands of rough-terrain MPC loops
per chip under vmap + shard_map.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GAIT_PHASE_OFFSETS, Config
from ..controllers.sampling.sampling_mpc import SamplingState, make_sampling_solver
from ..dynamics.srbd import integrate_euler, make_params
from ..gait.foothold_reference import raibert_footholds
from ..gait.periodic import contact_sequence, make_timer_dts
from ..gait.swing import bezier_swing_refs
from ..kinematics.leg_ik import LegKinematics
from ..utils.frames import euler_xyz_to_rot


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ScenarioState:
    """One scenario's full closed-loop state (a pytree; vmap over leading dims)."""

    x: Any  # (12,) base state
    feet: Any  # (4, 3)
    phase: Any  # (4,) gait phase
    swing_time: Any  # (4,)
    liftoff: Any  # (4, 3)
    prev_contact: Any  # (4,)
    mpc: SamplingState
    terrain: Any = None  # (R, C) per-scenario heightfield; (1, 1) zeros when flat
    # Early-stance reflex re-plan state (host counterpart: EarlyStanceDetector
    # hitpoints/hitmoments + the scipy generator's re-plan, reference
    # early_stance_detector.py:36-128): the moment into the swing the surface
    # graze was detected (-1 = no reflex this swing) and the commanded point
    # it was detected at.
    reflex: Any = None  # (4,) hitmoment [s]; -1 when inactive
    hitpoint: Any = None  # (4, 3) commanded point at the graze

    def tree_flatten(self):
        return (self.x, self.feet, self.phase, self.swing_time, self.liftoff,
                self.prev_contact, self.mpc, self.terrain, self.reflex,
                self.hitpoint), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# Fixed geometry of the per-scenario heightfield: 64 x 64 cells at 8 cm covering
# x in [-0.5, 4.5], y in [-2.5, 2.5] around the walk corridor. Static (it embeds
# into the compiled program); only the heights vary per scenario.
TERRAIN_ROWS = 64
TERRAIN_COLS = 64
TERRAIN_RES = 0.08
TERRAIN_CENTER = (2.0, 0.0)


def make_terrain_generator(kind: str):
    """Per-scenario procedural heightfields, ``gen(key) -> (R, C)`` heights.

    * ``boxes``  — 20 random box bumps 2-8 cm high (the random_boxes scene
      distribution, sim/mjcf.py);
    * ``stairs`` — ascending steps of random rise/run (the stairs scene);
    * ``perlin`` — continuous value-noise roughness up to 9 cm (two octaves of
      bilinear-upsampled random lattices — the perlin scene class the host sim
      covers; reference config.py:275-279). Peaks exceed the nominal swing
      apex, so mid-swing surface grazes genuinely occur (what the reflex
      analogue detects).
    The spawn neighbourhood stays flat so every scenario starts standing.
    """
    i = (np.arange(TERRAIN_ROWS) - (TERRAIN_ROWS - 1) / 2) * TERRAIN_RES + TERRAIN_CENTER[0]
    j = (np.arange(TERRAIN_COLS) - (TERRAIN_COLS - 1) / 2) * TERRAIN_RES + TERRAIN_CENTER[1]
    gx = np.broadcast_to(i[:, None], (TERRAIN_ROWS, TERRAIN_COLS)).astype(np.float32)
    gy = np.broadcast_to(j[None, :], (TERRAIN_ROWS, TERRAIN_COLS)).astype(np.float32)

    if kind == "boxes":
        def gen(key):
            k1, k2, k3 = jax.random.split(key, 3)
            centers = jax.random.uniform(
                k1, (20, 2), minval=jnp.asarray([0.7, -2.0]),
                maxval=jnp.asarray([4.2, 2.0]))
            half = jax.random.uniform(k2, (20, 2), minval=0.08, maxval=0.3)
            h = jax.random.uniform(k3, (20,), minval=0.02, maxval=0.08)
            inside = ((jnp.abs(gx[None] - centers[:, 0, None, None]) <= half[:, 0, None, None])
                      & (jnp.abs(gy[None] - centers[:, 1, None, None]) <= half[:, 1, None, None]))
            hm = jnp.max(jnp.where(inside, h[:, None, None], 0.0), axis=0)
            return jnp.where(gx < 0.4, 0.0, hm)
    elif kind == "stairs":
        def gen(key):
            k1, k2 = jax.random.split(key)
            rise = jax.random.uniform(k1, minval=0.03, maxval=0.06)
            run = jax.random.uniform(k2, minval=0.28, maxval=0.4)
            n = jnp.clip(jnp.floor((gx - 0.6) / run), 0.0, 7.0)
            return n * rise
    elif kind == "perlin":
        def gen(key):
            k1, k2 = jax.random.split(key)
            coarse = jax.random.uniform(k1, (9, 9), minval=-1.0, maxval=1.0)
            fine = jax.random.uniform(k2, (17, 17), minval=-1.0, maxval=1.0)
            h = (jax.image.resize(coarse, (TERRAIN_ROWS, TERRAIN_COLS), "linear")
                 + 0.5 * jax.image.resize(fine, (TERRAIN_ROWS, TERRAIN_COLS),
                                          "linear"))
            h = 0.09 * (h - jnp.min(h)) / (jnp.max(h) - jnp.min(h) + 1e-6)
            # Blend in from the flat spawn pad instead of a step edge.
            return h * jnp.clip((gx - 0.2) / 0.6, 0.0, 1.0)
    else:
        raise ValueError(f"unknown terrain kind {kind!r}")
    return gen


def make_terrain_adapter(cfg: Config):
    """Per-tick terrain sensing + TAMOLS adaptation for the fleet.

    Returns ``adapt(terrain_h, seeds, hips, base_pos, base_vel, yaw, cur, feet)
    -> (footholds (4,3), td_z (4,))``: per-leg 13x13 grids are sampled out of the
    scenario's heightfield (nearest-cell, same as the host cKDTree role) and
    scored by the SAME fused TAMOLS kernel the host stack runs
    (planner/tamols.py); td_z is the raw surface height at the chosen foothold
    (no sensor offsets) for the kinematic touch-down."""
    from ..planner.heightmap import GridHeightMap, lookup_nearest
    from ..planner.tamols import make_tamols_scorer

    scorer = make_tamols_scorer(cfg, strategy="tamols")
    tp = cfg.tamols
    rows, cols = tp.heightmap_rows, tp.heightmap_cols

    def adapt(terrain_h, seeds, hips, base_pos, base_vel, yaw, cur, feet,
              own_anchor):
        ghm = GridHeightMap(jnp.asarray(TERRAIN_CENTER, jnp.float32),
                            jnp.float32(0.0), jnp.float32(TERRAIN_RES), terrain_h)
        leg_hms = GridHeightMap(
            center=seeds[:, :2],
            yaw=jnp.full(4, yaw, jnp.float32),
            resolution=jnp.full(4, tp.heightmap_resolution, jnp.float32),
            heights=jnp.zeros((4, rows, cols), jnp.float32))
        # vmap over the leg axis (cell_world_xy assumes unbatched grid geometry).
        pts = jax.vmap(GridHeightMap.cell_world_xy)(leg_hms)  # (4, rows, cols, 2)
        leg_hms = GridHeightMap(leg_hms.center, leg_hms.yaw, leg_hms.resolution,
                                lookup_nearest(ghm, pts))
        res = scorer(leg_hms, seeds, hips, base_pos, base_vel, cur, feet,
                     own_anchor)
        td_z = lookup_nearest(ghm, res.footholds[:, :2])
        return res.footholds, td_z

    return adapt


def init_scenario_state(cfg: Config, num_params: int, key,
                        terrain_gen=None) -> ScenarioState:
    rp = cfg.robot
    x = jnp.zeros(12, jnp.float32).at[2].set(cfg.sim.ref_z)
    feet = jnp.asarray(
        [[rp.hip_x, rp.hip_y + 0.1, 0.0], [rp.hip_x, -rp.hip_y - 0.1, 0.0],
         [-rp.hip_x, rp.hip_y + 0.1, 0.0], [-rp.hip_x, -rp.hip_y - 0.1, 0.0]],
        jnp.float32)
    k_terrain, key = jax.random.split(key)
    terrain = (terrain_gen(k_terrain) if terrain_gen is not None
               else jnp.zeros((1, 1), jnp.float32))
    return ScenarioState(
        x=x, feet=feet,
        phase=jnp.asarray(GAIT_PHASE_OFFSETS[cfg.gait_params.gait_type], jnp.float32),
        swing_time=jnp.zeros(4, jnp.float32),
        liftoff=feet,
        prev_contact=jnp.ones(4, jnp.float32),
        mpc=SamplingState(jnp.zeros(num_params, jnp.float32), key,
                          jnp.full(num_params, cfg.mpc.sampling.sigma_cem_mppi, jnp.float32)),
        terrain=terrain,
        reflex=jnp.full(4, -1.0, jnp.float32),
        hitpoint=jnp.zeros((4, 3), jnp.float32),
    )


def make_scenario_step(cfg: Config, num_samples: int | None = None,
                       terrain: str | None = None, reflexes: bool = False):
    """Build one pure control tick: (ScenarioState, cmd_vel (3,)) -> (state', metrics).

    The tick runs at the MPC rate (1/mpc_frequency); physics substeps at sim dt.
    With ``terrain`` ("boxes"/"stairs"/"perlin"), footholds are TAMOLS-adapted
    against the scenario's own heightfield and touch-downs land on the surface
    (init the state with ``terrain_gen=make_terrain_generator(terrain)``).
    With ``reflexes`` (terrain only), the early-stance reflex runs on-device:
    a swing foot whose commanded Bezier point GRAZES the sensed surface
    mid-swing (clearance under 5 cm — the fleet's kinematic feet track
    perfectly, so the host detector's tracking-error trigger has no signal
    here; a graze is what an early strike looks like under perfect tracking)
    has its swing RE-PLANNED from the hitpoint: the remaining curve restarts
    at the recorded (hitpoint, hitmoment) with the remaining time compressed
    and the reflex apex — the SAME re-plan the host scipy generator performs
    (reference early_stance_detector.py:36-128 +
    scipy_swing_trajectory_generator.py:25-47), as a pure state update.
    ``metrics["reflex_triggers"]`` counts firings. Returns the step function
    and the parameter count.
    """
    solve, P = make_sampling_solver(cfg, num_samples)
    srbd = make_params(cfg)
    kin = LegKinematics(cfg.robot)
    gait = cfg.gait_params
    t_off = make_timer_dts(cfg.mpc)
    dt_ctrl = 1.0 / cfg.sim.mpc_frequency
    n_sub = max(1, int(round(dt_ctrl / cfg.sim.dt)))
    dt_sub = dt_ctrl / n_sub
    hip_offsets = kin.hip_offsets_b  # numpy constant
    adapt = make_terrain_adapter(cfg) if terrain is not None else None
    use_reflex = bool(reflexes) and terrain is not None

    def step(s: ScenarioState, cmd_vel):
        phase = jnp.mod(s.phase + dt_ctrl * gait.step_freq, 1.0)
        seq = contact_sequence(phase, gait.step_freq, gait.duty_factor, t_off)
        cur = seq[:, 0]
        prev = s.prev_contact

        # Lift-off tracking (stance -> swing edge).
        liftoff_edge = (prev == 1.0) & (cur == 0.0)
        liftoff = jnp.where(liftoff_edge[:, None], s.feet, s.liftoff)

        # Swing clocks.
        swing_time = jnp.where(cur == 0.0, s.swing_time + dt_ctrl, 0.0)

        # Raibert reference footholds.
        R = euler_xyz_to_rot(s.x[6:9])
        hips = s.x[0:3] + hip_offsets @ R.T
        ref_feet = raibert_footholds(
            s.x[0:3], s.x[6:9], s.x[3:5], cmd_vel[:2], hips,
            jnp.zeros(4), gait.stance_time, cfg.robot.hip_height, cfg.sim.ref_z)

        if adapt is not None:
            # Terrain-aware foothold adaptation (the host stack's apex-gated
            # TAMOLS pass, run every tick here — the fused scorer is ~1% of the
            # rollout batch's work). Swing legs take the adapted target; the
            # planner's per-leg anchor is the LIFT-OFF position for swinging
            # legs (their current kinematic position is airborne).
            feet_anchor = jnp.where(cur[:, None] == 0.0, liftoff, s.feet)
            adapted, td_z = adapt(s.terrain, ref_feet, hips, s.x[0:3], s.x[3:6],
                                  s.x[8], cur, s.feet, feet_anchor)
            ref_feet = jnp.where(cur[:, None] == 0.0, adapted, ref_feet)
        else:
            td_z = jnp.zeros(4, jnp.float32)

        ref12 = jnp.concatenate([
            jnp.asarray([0.0, 0.0, cfg.sim.ref_z], jnp.float32), cmd_vel,
            jnp.zeros(6, jnp.float32)])
        if adapt is not None:
            # Reference height rides the stance surface (terrain estimator role).
            ground = jnp.sum(s.feet[:, 2] * cur) / jnp.maximum(jnp.sum(cur), 1.0)
            ref12 = ref12.at[2].add(ground)

        out, mpc_state = solve(s.x, s.feet, ref12, ref_feet, seq, cur, prev, s.mpc)

        # Physics substeps under the commanded GRFs (contacts held over the tick).
        def sub(x, _):
            return integrate_euler(x, s.feet, out.grfs, cur, srbd, dt_sub), None
        x_next, _ = jax.lax.scan(sub, s.x, None, length=n_sub)

        # Kinematic feet: swing follows the Bezier toward the reference
        # foothold; touch-down lands on the terrain surface (z=0 when flat).
        # A tripped leg's swing is RE-PLANNED from its hitpoint with the
        # remaining time compressed and the reflex apex — the host scipy
        # generator's re-plan (reference
        # scipy_swing_trajectory_generator.py:25-47), not just an apex raise.
        swing_period = gait.swing_period
        hit_active = (s.reflex >= 0.0) if use_reflex \
            else jnp.zeros(4, bool)
        t_eff = jnp.where(hit_active, swing_time - s.reflex, swing_time)
        period_eff = jnp.where(hit_active,
                               jnp.maximum(swing_period - s.reflex, 1e-3),
                               swing_period)
        lo_eff = jnp.where(hit_active[:, None], s.hitpoint, liftoff)
        step_h = jnp.where(hit_active, cfg.sim.reflex_max_step_height,
                           cfg.sim.step_height)
        pos, _, _ = bezier_swing_refs(t_eff, period_eff, step_h,
                                      lo_eff, ref_feet)
        touchdown_edge = (prev == 0.0) & (cur == 1.0)
        feet = jnp.where(cur[:, None] == 0.0, pos, s.feet)
        feet = jnp.where(touchdown_edge[:, None],
                         ref_feet.at[:, 2].set(td_z), feet)

        reflex, hitpoint = s.reflex, s.hitpoint
        n_trig = jnp.float32(0.0)
        if use_reflex:
            from ..planner.heightmap import GridHeightMap, lookup_nearest
            ghm = GridHeightMap(jnp.asarray(TERRAIN_CENTER, jnp.float32),
                                jnp.float32(0.0), jnp.float32(TERRAIN_RES),
                                s.terrain)
            surf = lookup_nearest(ghm, pos[:, :2])
            mid_swing = (cur == 0.0) & (swing_time > 0.2 * swing_period) \
                & (swing_time < 0.8 * swing_period)
            trip = mid_swing & (pos[:, 2] < surf + 0.05) & ~hit_active
            n_trig = jnp.sum(trip.astype(jnp.float32))
            reflex = jnp.where(trip, swing_time, reflex)
            hitpoint = jnp.where(trip[:, None], pos, hitpoint)
            reflex = jnp.where(touchdown_edge, -1.0, reflex)

        metrics = dict(
            best_cost=out.best_cost,
            vel_error=jnp.linalg.norm(x_next[3:5] - cmd_vel[:2]),
            height_error=jnp.abs(x_next[2] - (jnp.sum(feet[:, 2] * cur)
                                              / jnp.maximum(jnp.sum(cur), 1.0)
                                              + cfg.sim.ref_z)),
            grf_total=jnp.sum(out.grfs[:, 2]),
            reflex_triggers=n_trig,
        )
        s_next = ScenarioState(x_next, feet, phase, swing_time, liftoff, cur,
                               mpc_state, s.terrain, reflex, hitpoint)
        return s_next, metrics

    return step, P
