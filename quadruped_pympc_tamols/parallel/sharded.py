"""Multi-device scaling: jax.sharding Mesh + shard_map collectives.

Maps the reference's parallelism dimensions (SURVEY 2.7) onto a device mesh:

* P1 (rollout batch): the sample batch of the sampling MPC shards over the mesh's
  "sample" axis; each device rolls out its shard and the winner is reduced with
  pmin/psum over the interconnect — replacing the reference's single-GPU vmap
  (centroidal_nmpc_jax.py:176-177).
* P3 (scenario fan-out): independent closed-loop scenarios shard over the "scenario"
  axis (vmap within a device, shard_map across devices) — replacing
  batched_simulations.py's 4 OS processes; fleet metrics reduce with psum.

Everything compiles under a CPU host-platform mesh for testing
(xla_force_host_platform_device_count) and runs unchanged on several GPUs.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import Config
from ..controllers.sampling.rollout import ForceModelParams, apply_force_model_rows, rollout_costs_soa
from ..controllers.sampling.sampling_mpc import SamplingState
from ..controllers.sampling.splines import (make_step_major_basis, num_params_per_leg,
                                           spline_forces)
from ..dynamics.srbd import integrate_euler, make_params


def scenario_mesh(n_scenario: int, n_sample: int, devices=None) -> Mesh:
    """Mesh with ("scenario", "sample") axes over the first n_scenario*n_sample devices."""
    devices = devices if devices is not None else jax.devices()
    need = n_scenario * n_sample
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_scenario, n_sample)
    return Mesh(arr, ("scenario", "sample"))


def _sharded_iteration_factory(cfg: Config, n_local: int, method: str):
    """Per-device sampling iteration with cross-device winner reduction over the
    'sample' mesh axis. Returns f(state12, feet, ref12, seq, best_params, key, sigma)
    -> (new_params, best_cost)."""
    sp = cfg.mpc.sampling
    H = cfg.mpc.horizon
    P_leg = num_params_per_leg(sp.parametrization, H, sp.num_splines)
    Pn = 4 * P_leg
    W_big = make_step_major_basis(sp.parametrization, H, sp.num_splines)
    dts = cfg.mpc.dts()
    srbd = make_params(cfg)
    Qdiag = cfg.mpc.cost.as_vector()
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)
    n3 = n_local // 3

    def _noise(key, sigma, keep_col0):
        """keep_col0: 1.0 only on shard 0 — otherwise every shard would carry a
        duplicate zero-noise incumbent, which (for cem_mppi) floods the global
        elite set with identical columns and collapses the refit sigma."""
        if method == "random_sampling":
            k1, k2, k3, k4 = jax.random.split(key, 4)
            g1 = sp.sigma_random[0] * jax.random.normal(k1, (Pn, n3))
            g2 = sp.sigma_random[1] * jax.random.normal(k2, (Pn, n3))
            u3 = jax.random.uniform(k3, (Pn, n_local - 1 - 2 * n3),
                                    minval=-sp.sigma_random[2], maxval=sp.sigma_random[2])
            col0 = (1.0 - keep_col0) * sp.sigma_random[1] * jax.random.normal(k4, (Pn, 1))
            return jnp.concatenate([col0, g1, g2, u3], 1).astype(jnp.float32)
        # mppi: fixed sigma; cem_mppi: the per-parameter adaptive sigma vector.
        scale = sigma[:, None] if method == "cem_mppi" else sp.sigma_mppi
        k1, k2 = jax.random.split(key)
        col0 = (1.0 - keep_col0) * scale * jax.random.normal(k2, (Pn, 1))
        return jnp.concatenate(
            [col0, scale * jax.random.normal(k1, (Pn, n_local - 1))], 1
        ).astype(jnp.float32)

    def iteration(state12, feet, ref12, seq, best_params, key, sigma):
        # Each sample-shard draws its own noise slice via axis-index key folding;
        # the incumbent zero-noise column exists ONLY on shard 0.
        idx = jax.lax.axis_index("sample")
        key = jax.random.fold_in(key, idx)
        noise = _noise(key, sigma, (idx == 0).astype(jnp.float32))
        params_vec = best_params[:, None] + noise
        raw = spline_forces(W_big, params_vec)
        n_stance = jnp.sum(seq, axis=0)
        share = srbd.mass * 9.81 / jnp.maximum(n_stance, 1.0)
        costs = rollout_costs_soa(state12, feet, ref12, raw, seq, share, dts, Qdiag,
                                  srbd, fm)

        local_best = jnp.min(costs)
        global_best = jax.lax.pmin(local_best, "sample")

        new_sigma = sigma
        if method == "random_sampling":
            li = jnp.argmin(costs)
            local_winner = params_vec[:, li]
            is_winner = (local_best == global_best).astype(jnp.float32)
            cnt = jax.lax.psum(is_winner, "sample")
            new_params = jax.lax.psum(local_winner * is_winner, "sample") / cnt
        else:  # mppi / cem_mppi: softmax with GLOBAL normalization over all shards
            w = jnp.exp(-(costs - global_best) / sp.mppi_temperature)
            denom = jax.lax.psum(jnp.sum(w), "sample")
            update = jax.lax.psum(noise @ w, "sample") / denom
            new_params = best_params + update
            if method == "cem_mppi":
                # EXACT global top-k elites: per-shard top-k, all_gather the k
                # candidate columns (Pn x k floats), re-top-k globally —
                # identical to the single-chip elite set (reference
                # centroidal_nmpc_jax.py:1075-1081).
                k = min(sp.cem_elite, n_local)
                neg_vals, li = jax.lax.top_k(-costs, k)
                elite_local = jnp.take(params_vec, li, axis=1)  # (Pn, k)
                elites = jax.lax.all_gather(elite_local, "sample", axis=1,
                                            tiled=True)  # (Pn, n_dev*k)
                vals = jax.lax.all_gather(-neg_vals, "sample", axis=0, tiled=True)
                _, gi = jax.lax.top_k(-vals, sp.cem_elite)
                elite = jnp.take(elites, gi, axis=1)  # (Pn, cem_elite)
                # Same refit as the single-chip solver (sampling_mpc.py): unbiased
                # variance + epsilon, then clamp.
                var = jnp.var(elite, axis=1, ddof=1) + 1e-8
                new_sigma = jnp.clip(jnp.sqrt(var),
                                     sp.cem_sigma_min, sp.cem_sigma_max)
        return new_params, global_best, new_sigma

    return iteration, Pn


def make_sharded_sampling_solver(cfg: Config, mesh: Mesh, num_samples: int | None = None,
                                 method: str | None = None):
    """Sampling MPC with the rollout batch sharded over the mesh's 'sample' axis.

    Returns ``solve(state12, feet, ref12, seq, mpc_state) -> (grfs, new_state,
    best_cost)`` (jitted, inputs replicated)."""
    sp = cfg.mpc.sampling
    method = method or sp.method
    if method not in ("random_sampling", "mppi", "cem_mppi"):
        raise ValueError("sharded solver supports random_sampling | mppi | cem_mppi")
    N = num_samples or sp.num_samples
    n_dev = mesh.shape["sample"]
    n_local = N // n_dev
    iteration, Pn = _sharded_iteration_factory(cfg, n_local, method)

    H = cfg.mpc.horizon
    W_big = make_step_major_basis(sp.parametrization, H, sp.num_splines)
    srbd = make_params(cfg)
    dts = cfg.mpc.dts()
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)

    def _extract(params, seq, state12, feet):
        raw0 = W_big[0:12] @ params
        share0 = srbd.mass * 9.81 / jnp.maximum(jnp.sum(seq[:, 0]), 1.0)
        grfs = jnp.stack(apply_force_model_rows(raw0, seq[:, 0], share0, fm)).reshape(4, 3)
        pred = integrate_euler(state12, feet, grfs, seq[:, 0], srbd, dts[0])
        return grfs, pred

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P(), P(), P(), P()),
             out_specs=(P(), P(), P()), check_vma=False)
    def _solve(state12, feet, ref12, seq, mpc_state):
        new_params, best_cost, new_sigma = iteration(
            state12, feet, ref12, seq, mpc_state.best_parameters, mpc_state.key,
            mpc_state.sigma)
        key = jax.random.split(mpc_state.key)[0]
        grfs, _ = _extract(new_params, seq, state12, feet)
        return grfs, SamplingState(new_params, key, new_sigma), best_cost

    return jax.jit(_solve), Pn


def make_multichip_step(cfg: Config, mesh: Mesh, scenarios_per_device: int = 1,
                        num_samples: int = 240, terrain: str | None = None):
    """The full multi-chip 'training step': a fleet of closed-loop MPC scenarios.

    Scenarios shard over the 'scenario' mesh axis (data-parallel fan-out); within
    each scenario the sampling batch shards over the 'sample' axis (tensor-parallel
    analogue) with pmin/psum winner reduction; fleet-wide tracking metrics reduce
    with psum over both axes. With ``terrain`` ("boxes"/"stairs") every scenario
    carries its own procedural heightfield and runs the fused TAMOLS scorer on
    per-leg sensed grids each tick (the rough-terrain fleet).
    Returns (step, init) where ``step(states, cmd_vels) -> (states',
    fleet_metrics)`` is jitted over the mesh.
    """
    from .scenario_engine import (ScenarioState, init_scenario_state,
                                  make_terrain_adapter, make_terrain_generator)

    n_sample = mesh.shape["sample"]
    n_scen = mesh.shape["scenario"]
    B = n_scen * scenarios_per_device
    n_local = num_samples // n_sample
    method = "random_sampling"
    iteration, Pn = _sharded_iteration_factory(cfg, n_local, method)

    sp = cfg.mpc.sampling
    H = cfg.mpc.horizon
    W_big = make_step_major_basis(sp.parametrization, H, sp.num_splines)
    srbd = make_params(cfg)
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)
    from ..config import GAIT_PHASE_OFFSETS
    from ..gait.foothold_reference import raibert_footholds
    from ..gait.periodic import contact_sequence, make_timer_dts
    from ..gait.swing import bezier_swing_refs
    from ..kinematics.leg_ik import LegKinematics
    from ..utils.frames import euler_xyz_to_rot

    kin = LegKinematics(cfg.robot)
    gait = cfg.gait_params
    t_off = make_timer_dts(cfg.mpc)
    dt_ctrl = 1.0 / cfg.sim.mpc_frequency
    n_sub = max(1, int(round(dt_ctrl / cfg.sim.dt)))
    dt_sub = dt_ctrl / n_sub
    dts = cfg.mpc.dts()
    adapt = make_terrain_adapter(cfg) if terrain is not None else None
    terrain_gen = make_terrain_generator(terrain) if terrain is not None else None

    def scenario_tick(s: ScenarioState, cmd_vel):
        phase = jnp.mod(s.phase + dt_ctrl * gait.step_freq, 1.0)
        seq = contact_sequence(phase, gait.step_freq, gait.duty_factor, t_off)
        cur = seq[:, 0]
        prev = s.prev_contact
        liftoff_edge = (prev == 1.0) & (cur == 0.0)
        liftoff = jnp.where(liftoff_edge[:, None], s.feet, s.liftoff)
        swing_time = jnp.where(cur == 0.0, s.swing_time + dt_ctrl, 0.0)

        R = euler_xyz_to_rot(s.x[6:9])
        hips = s.x[0:3] + kin.hip_offsets_b @ R.T
        ref_feet = raibert_footholds(s.x[0:3], s.x[6:9], s.x[3:5], cmd_vel[:2], hips,
                                     jnp.zeros(4), gait.stance_time,
                                     cfg.robot.hip_height, cfg.sim.ref_z)
        if adapt is not None:
            feet_anchor = jnp.where(cur[:, None] == 0.0, liftoff, s.feet)
            adapted, td_z = adapt(s.terrain, ref_feet, hips, s.x[0:3], s.x[3:6],
                                  s.x[8], cur, s.feet, feet_anchor)
            ref_feet = jnp.where(cur[:, None] == 0.0, adapted, ref_feet)
        else:
            td_z = jnp.zeros(4, jnp.float32)
        ref12 = jnp.concatenate([jnp.asarray([0.0, 0.0, cfg.sim.ref_z], jnp.float32),
                                 cmd_vel, jnp.zeros(6, jnp.float32)])
        if adapt is not None:
            ground = jnp.sum(s.feet[:, 2] * cur) / jnp.maximum(jnp.sum(cur), 1.0)
            ref12 = ref12.at[2].add(ground)

        # Warm-start reset + sharded sampling iteration (pmin/psum over 'sample').
        keep = jnp.repeat(~liftoff_edge, Pn // 4).astype(jnp.float32)
        params0 = s.mpc.best_parameters * keep
        new_params, best_cost, new_sigma = iteration(s.x, s.feet, ref12, seq, params0,
                                                     s.mpc.key, s.mpc.sigma)
        key = jax.random.split(s.mpc.key)[0]

        raw0 = W_big[0:12] @ new_params
        share0 = srbd.mass * 9.81 / jnp.maximum(jnp.sum(cur), 1.0)
        grfs = jnp.stack(apply_force_model_rows(raw0, cur, share0, fm)).reshape(4, 3)

        def sub(x, _):
            return integrate_euler(x, s.feet, grfs, cur, srbd, dt_sub), None
        x_next, _ = jax.lax.scan(sub, s.x, None, length=n_sub)

        pos, _, _ = bezier_swing_refs(swing_time, gait.swing_period,
                                      cfg.sim.step_height, liftoff, ref_feet)
        touchdown_edge = (prev == 0.0) & (cur == 1.0)
        feet = jnp.where(cur[:, None] == 0.0, pos, s.feet)
        feet = jnp.where(touchdown_edge[:, None], ref_feet.at[:, 2].set(td_z), feet)

        s2 = ScenarioState(x_next, feet, phase, swing_time, liftoff, cur,
                           SamplingState(new_params, key, new_sigma), s.terrain,
                           s.reflex, s.hitpoint)
        vel_err = jnp.linalg.norm(x_next[3:5] - cmd_vel[:2])
        return s2, (vel_err, best_cost)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("scenario"), P("scenario")), out_specs=(P("scenario"), P()),
             check_vma=False)
    def _step(states, cmd_vels):
        s2, (vel_err, cost) = jax.vmap(scenario_tick)(states, cmd_vels)
        # Fleet-wide metric reduction over BOTH mesh axes (DP-style all-reduce).
        fleet_vel_err = jax.lax.psum(jnp.sum(vel_err), "scenario") / B
        fleet_cost = jax.lax.psum(jnp.sum(cost), "scenario") / B
        return s2, jnp.stack([fleet_vel_err, fleet_cost])

    def init(seed: int = 0):
        keys = jax.random.split(jax.random.PRNGKey(seed), B)
        states = jax.vmap(lambda k: init_scenario_state(cfg, Pn, k,
                                                        terrain_gen))(keys)
        return states

    return jax.jit(_step), init, Pn
