"""Smoke test of the controller stack on one NVIDIA GPU.

    python chip_smoke.py          # every one-device phase, on one GPU
    python chip_smoke.py --four   # only the four-GPU mesh path and its comparison

Drives the main path through the entry points a user calls, at the width of the
default deployment (``make_config("aliengo", mpc_type="sampling")``: 10,000
samples, H=12, cubic spline, 100 Hz MPC):

* device    — the first device must be a GPU (no CPU fallback); prints the card's
              name and power limit and the JAX version;
* sampling  — ``SRBClosedLoopHarness`` walks 3 s at 0.3 m/s and
              ``ControllerNode(mpc_mode="inline")`` runs 50 ticks, for each of
              random_sampling, mppi and cem_mppi;
* gradient  — the same for the nominal RTI-SQP controller;
* tamols    — ``make_tamols_scorer`` on a perlin heightfield, GPU against CPU;
* ladders   — the f64 verification ladders (utils/verification.py), held to the
              CPU tests' bounds: the plain reference for every solver on the path;
* fleet     — ``make_scenario_step`` (perlin terrain, reflexes) at 80 scenarios x
              10,000 samples for 20 steps, with zero-noise parity against the CPU
              backend on 8 scenarios.

Each phase prints its own line; a failed phase makes the script exit non-zero.
The last line of a passing run is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Bounds of the CPU tests (tests/test_f64_ladder.py).
QP_GAP_MAX_N, QP_GAP_REL = 0.6, 2.5e-3
SOFT_GAP_ACTIVE_N, SOFT_GAP_INACTIVE_N = 8.0, 0.6
ROLLOUT_GAP_REL = 1e-5

VEL = (0.3, 0.0, 0.0)
WALK_S = 3.0
NODE_TICKS = 50
FLEET_SCENARIOS, FLEET_STEPS, PARITY_SCENARIOS, PARITY_STEPS = 80, 20, 8, 5
# GPU-vs-CPU tolerances: same f32 program on two backends (libm, fusion and
# reduction order differ), so agreement to float32 rounding scaled by the
# quantity's size.
TAMOLS_ATOL_M = 1e-5
FLEET_ATOL = 1e-3


def gpu_card() -> str:
    """`name, power.limit` of the card, read by nvidia-smi in a child process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    """The first JAX device, which must be a GPU; exits non-zero otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        raise SystemExit(2)
    return dev


# --------------------------------------------------------------------------
# Shared inputs
def default_feet():
    from quadruped_pympc_tamols.utils.legs import Legs

    return Legs(np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                          [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]]))


def synthetic_provider(feet):
    """Standing-robot state in the MuJoCo readers' schema (no simulator)."""
    from quadruped_pympc_tamols.utils.legs import Legs

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
    return provider


def check_walk(cfg, duration=WALK_S, vel=VEL, walks=True):
    """Closed-loop walk on the SRB plant; the CPU walking tests' assertions.

    ``walks=False`` holds the run only to finite states: cem_mppi at the
    default settings falls on this plant on the CPU backend as well (see
    ROADMAP), so its walk is reported, not asserted."""
    from quadruped_pympc_tamols.sim import SRBClosedLoopHarness

    h = SRBClosedLoopHarness(cfg, seed=0)
    hist = h.run(duration, np.asarray(vel))
    z = hist[:, 2]
    assert np.all(np.isfinite(hist)), "state diverged"
    if not walks:
        return hist[-1, 0] - hist[0, 0], bool(np.all(z > 0.15))
    assert np.all(z > 0.15), f"robot collapsed: min z {z.min():.3f}"
    assert np.all(np.abs(hist[:, 6]) < 0.5) and np.all(np.abs(hist[:, 7]) < 0.5), \
        "robot tipped over"
    dist = hist[-1, 0] - hist[0, 0]
    assert dist > 0.5 * vel[0] * duration, \
        f"tracked {dist:.2f} m of {vel[0] * duration:.2f} m commanded"
    assert abs(np.mean(z[len(z) // 2:]) - cfg.sim.ref_z) < 0.08
    return dist, True


def node_ticks(cfg, n_ticks=NODE_TICKS):
    """Inline ControllerNode ticks; returns per-tick wall times [ms] after the
    first (compiling) tick."""
    from quadruped_pympc_tamols.runtime.controller_node import ControllerNode

    feet = default_feet()
    node = ControllerNode(cfg, feet, mpc_mode="inline")
    provider = synthetic_provider(feet)
    times = []
    try:
        for _ in range(n_ticks + 1):
            t0 = time.perf_counter()
            tau, _, _ = node.control_tick(provider, np.zeros(3), np.zeros(3), cfg.sim.dt)
            tau = np.asarray(tau.data)
            times.append((time.perf_counter() - t0) * 1e3)
            assert np.all(np.isfinite(tau)), "non-finite torques"
        assert np.any(np.abs(tau) > 1.0), "no torque produced"
    finally:
        node.shutdown()
    return np.asarray(times[1:])


# --------------------------------------------------------------------------
# Phases
def phase_sampling(card, num_samples=None, walk_s=WALK_S, n_ticks=NODE_TICKS):
    from quadruped_pympc_tamols import make_config, replace_config

    base = make_config("aliengo", mpc_type="sampling")
    over = {"sim.visual_foothold_adaptation": "blind"}
    if num_samples:
        over["mpc.sampling.num_samples"] = num_samples
    lines = []
    for method in ("random_sampling", "mppi", "cem_mppi"):
        cfg = replace_config(base, **over, **{"mpc.sampling.method": method})
        dist, upright = check_walk(cfg, walk_s, walks=method != "cem_mppi")
        t = node_ticks(cfg, n_ticks)
        walked = f"walked {dist:.2f} m" if upright else f"fell (finite states, x {dist:.2f} m)"
        lines.append(f"{method} N={cfg.mpc.sampling.num_samples}: {walked}; "
                     f"info: inline node tick p50={np.percentile(t, 50):.3f} ms "
                     f"p99={np.percentile(t, 99):.3f} ms ({card})")
    return lines


def phase_gradient(card, walk_s=WALK_S, n_ticks=NODE_TICKS):
    from quadruped_pympc_tamols import make_config

    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"sim.visual_foothold_adaptation": "blind"})
    dist, _ = check_walk(cfg, walk_s)
    t = node_ticks(cfg, n_ticks)
    return [f"nominal RTI-SQP: walked {dist:.2f} m; info: inline node tick "
            f"p50={np.percentile(t, 50):.3f} ms p99={np.percentile(t, 99):.3f} ms ({card})"]


def tamols_inputs(cfg, n_cases=16, seed=0):
    """Per-leg sensed grids (default window) cut out of perlin heightfields, with
    base poses walking over them."""
    import jax
    import jax.numpy as jnp

    from quadruped_pympc_tamols.parallel.scenario_engine import (
        TERRAIN_CENTER, TERRAIN_RES, make_terrain_generator)
    from quadruped_pympc_tamols.planner.heightmap import GridHeightMap, lookup_nearest

    tp = cfg.tamols
    gen = make_terrain_generator("perlin")
    rng = np.random.default_rng(seed)
    nominal = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                        [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]], np.float32)
    cases = []
    for i in range(n_cases):
        terrain = gen(jax.random.PRNGKey(seed + i))
        ghm = GridHeightMap(jnp.asarray(TERRAIN_CENTER, jnp.float32), jnp.float32(0.0),
                            jnp.float32(TERRAIN_RES), terrain)
        base = np.array([rng.uniform(0.8, 3.5), rng.uniform(-0.5, 0.5),
                         cfg.sim.ref_z + 0.05], np.float32)
        feet = nominal + base * np.array([1, 1, 0], np.float32)
        seeds = feet + np.array([0.08, 0.0, 0.0], np.float32)
        hips = feet.copy()
        hips[:, 2] = base[2]
        leg_hms = GridHeightMap(
            center=jnp.asarray(seeds[:, :2]), yaw=jnp.zeros(4, jnp.float32),
            resolution=jnp.full(4, tp.heightmap_resolution, jnp.float32),
            heights=jnp.zeros((4, tp.heightmap_rows, tp.heightmap_cols), jnp.float32))
        pts = jax.vmap(GridHeightMap.cell_world_xy)(leg_hms)
        leg_hms = GridHeightMap(leg_hms.center, leg_hms.yaw, leg_hms.resolution,
                                lookup_nearest(ghm, pts))
        contact = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
        args = (leg_hms, jnp.asarray(seeds), jnp.asarray(hips), jnp.asarray(base),
                jnp.asarray([0.3, 0.0, 0.0], jnp.float32), jnp.asarray(contact),
                jnp.asarray(feet), jnp.asarray(feet))
        cases.append(jax.device_get(args))
    return cases


def phase_tamols(n_cases=16):
    import jax

    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.planner.tamols import make_tamols_scorer

    cfg = make_config("aliengo", mpc_type="sampling")
    scorer = make_tamols_scorer(cfg, strategy="tamols")
    dev, cpu = jax.devices()[0], jax.devices("cpu")[0]
    worst, rough = 0.0, 0
    for args in tamols_inputs(cfg, n_cases):
        a = jax.device_get(scorer(*jax.device_put(args, dev)))
        b = jax.device_get(scorer(*jax.device_put(args, cpu)))
        assert np.all(np.asarray(a.feasible) == np.asarray(b.feasible)), "feasibility differs"
        err = float(np.max(np.abs(np.asarray(a.footholds) - np.asarray(b.footholds))))
        worst = max(worst, err)
        np.testing.assert_allclose(a.footholds, b.footholds, atol=TAMOLS_ATOL_M)
        np.testing.assert_allclose(a.best_cost, b.best_cost, rtol=1e-4, atol=1e-6)
        rough += int(np.ptp(np.asarray(args[0].heights)) > 0.01)
    assert rough == n_cases, "heightmaps are not rough"
    return [f"{n_cases} perlin cases, {cfg.tamols.heightmap_rows}x"
            f"{cfg.tamols.heightmap_cols} window: max |foothold GPU - CPU| = "
            f"{worst:.2e} m (bound {TAMOLS_ATOL_M:g} m)"]


def phase_ladders():
    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.utils.verification import (
        qp_ladder_report, rollout_ladder_report, soft_qp_ladder_report)

    qp = qp_ladder_report(make_config(
        "aliengo", mpc_type="nominal", **{"sim.visual_foothold_adaptation": "blind"}),
        n_ticks=20)
    assert qp["n_ticks"] == 20 and qp["f64_mu_max"] < 1e-10, qp
    assert qp["qp_gap_vs_f64_max_N"] < QP_GAP_MAX_N, qp
    assert qp["qp_gap_vs_f64_rel"] < QP_GAP_REL, qp
    soft = soft_qp_ladder_report(make_config(
        "aliengo", mpc_type="nominal",
        **{"sim.visual_foothold_adaptation": "blind",
           "mpc.gradient.use_static_stability": True,
           "mpc.gradient.trot_stability_margin": -0.03}), n_ticks=10)
    assert soft["n_active_slack_ticks"] == soft["n_ticks"], soft
    assert soft["soft_qp_gap_vs_f64_max_N"] < SOFT_GAP_ACTIVE_N, soft
    soft2 = soft_qp_ladder_report(make_config(
        "aliengo", mpc_type="nominal",
        **{"sim.visual_foothold_adaptation": "blind",
           "mpc.gradient.use_zmp_stability": True}), n_ticks=10)
    assert soft2["soft_qp_gap_vs_f64_max_N"] < SOFT_GAP_INACTIVE_N, soft2
    roll = rollout_ladder_report(n_ticks=12)
    assert roll["rollout_ladder_n_ticks"] == 12, roll
    assert roll["rollout_gap_vs_f64_rel"] < ROLLOUT_GAP_REL, roll
    return [f"QP: max {qp['qp_gap_vs_f64_max_N']:.4f} N (bound {QP_GAP_MAX_N}), "
            f"rel {qp['qp_gap_vs_f64_rel']:.2e} (bound {QP_GAP_REL})",
            f"soft QP, active slacks: max {soft['soft_qp_gap_vs_f64_max_N']:.4f} N "
            f"(bound {SOFT_GAP_ACTIVE_N}); ZMP band: max "
            f"{soft2['soft_qp_gap_vs_f64_max_N']:.4f} N (bound {SOFT_GAP_INACTIVE_N})",
            f"sampling rollout: max rel {roll['rollout_gap_vs_f64_rel']:.2e} "
            f"(bound {ROLLOUT_GAP_REL})"]


def zero_noise(cfg):
    from quadruped_pympc_tamols import replace_config

    return replace_config(cfg, **{"mpc.sampling.sigma_random": (0.0, 0.0, 0.0),
                                  "mpc.sampling.sigma_mppi": 0.0})


def make_fleet(cfg, n_scenarios, seed=0):
    """(jitted vmapped step, initial states, cmd) of the perlin/reflex fleet."""
    import jax
    import jax.numpy as jnp

    from quadruped_pympc_tamols.parallel import (
        init_scenario_state, make_scenario_step, make_terrain_generator)

    step, P = make_scenario_step(cfg, terrain="perlin", reflexes=True)
    gen = make_terrain_generator("perlin")
    keys = jax.random.split(jax.random.PRNGKey(seed), n_scenarios)
    states = jax.vmap(lambda k: init_scenario_state(cfg, P, k, gen))(keys)
    cmd = jnp.asarray(VEL, jnp.float32)
    return jax.jit(jax.vmap(step, in_axes=(0, None))), states, cmd


def phase_fleet(card, n_scenarios=FLEET_SCENARIOS, n_steps=FLEET_STEPS,
                n_parity=PARITY_SCENARIOS, parity_steps=PARITY_STEPS):
    import jax

    from quadruped_pympc_tamols import make_config

    cfg = make_config("aliengo", mpc_type="sampling")
    N = cfg.mpc.sampling.num_samples
    dev, cpu = jax.devices()[0], jax.devices("cpu")[0]

    step, states, cmd = make_fleet(cfg, n_scenarios)
    states, m = step(states, cmd)
    jax.block_until_ready(states)
    t0 = time.perf_counter()
    trig = 0.0
    for _ in range(n_steps - 1):
        states, m = step(states, cmd)
        trig += float(np.sum(m["reflex_triggers"]))
    jax.block_until_ready(states)
    wall = time.perf_counter() - t0
    x = np.asarray(states.x)
    assert np.all(np.isfinite(x)) and np.all(np.isfinite(np.asarray(states.feet))), \
        "fleet state diverged"
    assert np.all(x[:, 2] > 0.15), f"a scenario collapsed: min z {x[:, 2].min():.3f}"
    peak = dev.memory_stats().get("peak_bytes_in_use") if dev.platform == "gpu" else None

    # Zero-noise parity: the same fleet program on the GPU and on the CPU backend.
    step0, s0, cmd0 = make_fleet(zero_noise(cfg), n_parity, seed=1)
    a = jax.device_put((s0, cmd0), dev)
    b = jax.device_put((s0, cmd0), cpu)
    for _ in range(parity_steps):
        a = (step0(*a)[0], a[1])
        b = (step0(*b)[0], b[1])
    xa, xb = jax.device_get((a[0].x, b[0].x))
    fa, fb = jax.device_get((a[0].feet, b[0].feet))
    err = float(max(np.max(np.abs(xa - xb)), np.max(np.abs(fa - fb))))
    assert err < FLEET_ATOL, f"zero-noise GPU/CPU gap {err:.3e} >= {FLEET_ATOL}"
    return [f"{n_scenarios} scenarios x {N} samples, {n_steps} steps finite; "
            f"reflex triggers {trig:.0f}",
            f"info: {n_scenarios * (n_steps - 1) / wall:.1f} scenario-steps/s, "
            f"peak_bytes_in_use={peak} ({card})",
            f"zero-noise parity vs CPU on {n_parity} scenarios x {parity_steps} steps: "
            f"max |state gap| {err:.2e} (bound {FLEET_ATOL:g})"]


def phase_four(n_dev=4, num_samples=None, scenarios_per_device=20):
    """The four-device mesh path: the sharded fleet and the sharded sampling
    solver, each against the same computation on one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.controllers.sampling import (
        SamplingState, make_sampling_solver)
    from quadruped_pympc_tamols.controllers.sampling.rollout import (
        ForceModelParams, rollout_costs_soa)
    from quadruped_pympc_tamols.controllers.sampling.splines import make_step_major_basis
    from quadruped_pympc_tamols.dynamics.srbd import make_params
    from quadruped_pympc_tamols.parallel import (
        make_multichip_step, make_sharded_sampling_solver, scenario_mesh)

    devs = jax.devices()
    assert len(devs) >= n_dev, f"needs {n_dev} devices, has {len(devs)}"
    cfg = make_config("aliengo", mpc_type="sampling")
    N = num_samples or cfg.mpc.sampling.num_samples
    lines = []

    def on_distinct_devices(arr):
        shard_devs = {s.device for s in arr.addressable_shards}
        assert len(shard_devs) == n_dev, f"shards on {len(shard_devs)} devices"

    # 1. Fleet: scenario=n_dev x sample=1 against one device, same scenarios/keys.
    mesh = scenario_mesh(n_dev, 1)
    step, init, _ = make_multichip_step(cfg, mesh, scenarios_per_device,
                                        num_samples=N, terrain="perlin")
    B = n_dev * scenarios_per_device
    states = init(seed=0)
    states = jax.device_put(states, NamedSharding(mesh, P("scenario")))
    cmd = jax.device_put(jnp.tile(jnp.asarray(VEL, jnp.float32), (B, 1)),
                         NamedSharding(mesh, P("scenario")))
    s_multi, m_multi = step(states, cmd)
    on_distinct_devices(states.x)
    on_distinct_devices(s_multi.x)
    mesh1 = scenario_mesh(1, 1, devices=devs[:1])
    step1, init1, _ = make_multichip_step(cfg, mesh1, B, num_samples=N, terrain="perlin")
    s_one, m_one = step1(jax.device_put(init1(seed=0), devs[0]),
                         jax.device_put(np.asarray(cmd), devs[0]))
    gap = float(np.max(np.abs(np.asarray(s_multi.x) - np.asarray(s_one.x))))
    assert gap < FLEET_ATOL, f"sharded fleet vs one device: {gap:.3e}"
    np.testing.assert_allclose(np.asarray(m_multi), np.asarray(m_one), rtol=1e-4)
    lines.append(f"fleet scenario={n_dev} x sample=1, {B} scenarios x {N} samples: "
                 f"shards on {n_dev} devices {sorted(str(s.device) for s in s_multi.x.addressable_shards)}; "
                 f"max |state - one-device state| {gap:.2e}")

    # 2. Sharded sampling solver: scenario=1 x sample=n_dev.
    mesh_s = scenario_mesh(1, n_dev)
    x0 = jnp.asarray([0.02, -0.01, cfg.sim.ref_z - 0.03, 0.1, 0, 0, 0, 0, 0, 0, 0, 0],
                     jnp.float32)
    feet = jnp.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                        [-0.25, 0.15, 0], [-0.25, -0.15, 0]], jnp.float32)
    ref12 = jnp.zeros(12, jnp.float32).at[2].set(cfg.sim.ref_z).at[3].set(0.3)
    seq = np.ones((4, cfg.mpc.horizon), np.float32)
    seq[1, 6:] = seq[2, 6:] = 0.0
    seq = jnp.asarray(seq)

    cfg0 = zero_noise(cfg)
    solve_sh, Pn = make_sharded_sampling_solver(cfg0, mesh_s, num_samples=N)
    params = 0.5 * jax.random.normal(jax.random.PRNGKey(3), (Pn,), jnp.float32)
    st = SamplingState(params, jax.random.PRNGKey(0),
                       jnp.full(Pn, cfg.mpc.sampling.sigma_cem_mppi, jnp.float32))
    grfs_sh, st_sh, cost_sh = solve_sh(x0, feet, ref12, seq, st)
    on_distinct_devices(grfs_sh)
    solve1, _ = make_sampling_solver(cfg0, num_samples=N)
    out1, _ = solve1(*jax.device_put((x0, feet, ref12, feet, seq, seq[:, 0], seq[:, 0], st),
                                     devs[0]))
    np.testing.assert_allclose(np.asarray(grfs_sh), np.asarray(out1.grfs), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(cost_sh), float(out1.best_cost), rtol=1e-5)
    lines.append(f"sharded solver scenario=1 x sample={n_dev}, zero noise: GRFs match "
                 f"one device (max gap {np.max(np.abs(np.asarray(grfs_sh) - np.asarray(out1.grfs))):.2e} N)")

    # With noise: the returned winner is the sample at the global minimum.
    solve_n, _ = make_sharded_sampling_solver(cfg, mesh_s, num_samples=N)
    _, st_n, cost_n = solve_n(x0, feet, ref12, seq, st)
    sp = cfg.mpc.sampling
    W = make_step_major_basis(sp.parametrization, cfg.mpc.horizon, sp.num_splines)
    srbd = make_params(cfg)
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)
    share = srbd.mass * 9.81 / np.maximum(np.asarray(seq).sum(0), 1.0)

    def cost_of(p):
        raw = (W @ np.asarray(p, np.float64)).astype(np.float32).reshape(cfg.mpc.horizon, 12, 1)
        return float(jax.jit(lambda r: rollout_costs_soa(
            x0, feet, ref12, r, seq, jnp.asarray(share, jnp.float32),
            jnp.asarray(cfg.mpc.dts()), cfg.mpc.cost.as_vector(), srbd, fm))(
                jax.device_put(raw, devs[0]))[0])

    c_winner, c_incumbent = cost_of(st_n.best_parameters), cost_of(params)
    np.testing.assert_allclose(c_winner, float(cost_n), rtol=1e-4)
    assert float(cost_n) <= c_incumbent * (1 + 1e-5), (float(cost_n), c_incumbent)
    lines.append(f"sharded solver with noise: winner cost {float(cost_n):.4f} = "
                 f"re-evaluated {c_winner:.4f} (incumbent {c_incumbent:.4f})")
    return lines


# --------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh path and its one-GPU comparison")
    args = ap.parse_args(argv)

    if not (ROOT / "quadruped_pympc_tamols").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from quadruped_pympc_tamols.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = require_gpu()
    card = gpu_card()
    print(f"[device] {card}", flush=True)
    print(f"[device] jax {jax.__version__}; {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    if args.four:
        phases = [("four", lambda: phase_four(4))]
    else:
        phases = [("sampling", lambda: phase_sampling(card)),
                  ("gradient", lambda: phase_gradient(card)),
                  ("tamols", phase_tamols),
                  ("ladders", phase_ladders),
                  ("fleet", lambda: phase_fleet(card))]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            lines = fn()
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s", flush=True)
            failed.append(name)
            continue
        for line in lines:
            print(f"[{name}] {line}", flush=True)
        print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    n = len(jax.devices())
    if args.four:
        assert n == 4, f"--four ran on {n} devices"
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind, "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
