"""Controller benchmark on one NVIDIA GPU.

    python bench.py             # one JSON line of device timings (needs a GPU)
    python bench.py --scaling   # CPU multi-process simulation of multi-host scaling

Reference baselines: < 2 ms for 10k parallel sampling rollouts on an RTX 4050
mobile GPU and < 5 ms for the gradient feedback loop on an i7-13700H
(BASELINE.md). Solve times are per-solve device times measured by chaining K
full solves inside one jitted loop (controller state threads through, so every
solve does real work: fresh noise, rollouts, optimizer update, GRF extraction).
The tick latency is the served path of one robot: dispatch, solve and readback
of the GRFs, per call.

Every timed metric is measured in PASSES interleaved passes over pre-built,
pre-warmed thunks; the value is the median over passes and ``spread_pct`` is
(max - min) / median. Any failure raises: no metric is dropped.
"""
import json
import sys
import time

import numpy as np

BASELINE_MS = 2.0
CHAIN = 50
PASSES = 3
REPS = 10


def best_of(thunk, divisor, n=2):
    """Minimum normalized elapsed time [ms] over n runs of thunk() (which must
    block until the device is done)."""
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        thunk()
        best = min(best, (time.perf_counter() - t0) / divisor * 1e3)
    return best


def chained(fn, carry0, reps=REPS):
    """Warm ``fn`` (a jitted carry -> carry chain of CHAIN solves) and return a
    thunk timing one solve."""
    import jax

    jax.block_until_ready(fn(carry0))

    def run():
        c = carry0
        for _ in range(reps):
            c = fn(c)
        jax.block_until_ready(c)
    return lambda: best_of(run, reps * CHAIN)


def tick_inputs(cfg):
    import jax.numpy as jnp

    state12 = jnp.asarray([0.0, 0.0, cfg.sim.ref_z - 0.03, 0.1, 0, 0, 0, 0, 0, 0, 0, 0],
                          jnp.float32)
    feet = jnp.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                        [-0.25, 0.15, 0], [-0.25, -0.15, 0]], jnp.float32)
    ref12 = jnp.asarray([0.0, 0.0, cfg.sim.ref_z, 0.2, 0, 0, 0, 0, 0, 0, 0, 0],
                        jnp.float32)
    seq = np.ones((4, cfg.mpc.horizon), np.float32)
    seq[1, 6:] = 0.0
    seq[2, 6:] = 0.0
    seq = jnp.asarray(seq)
    return state12, feet, ref12, seq, seq[:, 0], jnp.ones(4, jnp.float32)


def build_sampling(cfg):
    """XLA sampling solves chained in one jit: the default deployment, the
    sample-count curve, the MPPI/CEM optimizers, a closed-loop chain (the
    predicted state feeds the next solve) and the gait-adaptive solver."""
    import jax
    import jax.numpy as jnp

    from quadruped_pympc_tamols.controllers.sampling import (
        SamplingState, make_gait_adaptive_solver, make_sampling_solver)

    state12, feet, ref12, seq, cur, prev = tick_inputs(cfg)

    def state0(P):
        return SamplingState(jnp.zeros(P, jnp.float32), jax.random.PRNGKey(0),
                             jnp.full(P, cfg.mpc.sampling.sigma_cem_mppi, jnp.float32))

    def chain_of(solve, P, closed_loop=False):
        @jax.jit
        def chain(carry):
            def body(_, carry):
                x, s = carry
                out, s = solve(x, feet, ref12, feet, seq, cur, prev, s)
                return (out.predicted_state if closed_loop else x, s)
            return jax.lax.fori_loop(0, CHAIN, body, carry)
        return chained(chain, (state12, state0(P)))

    chains = {}
    for key, n, method in (("xla_solve_ms", None, None),
                           ("solve_ms_n10240", 10240, "random_sampling"),
                           ("solve_ms_n40960", 40960, "random_sampling"),
                           ("solve_ms_n163840", 163840, "random_sampling"),
                           ("mppi_solve_ms_n10240", 10240, "mppi"),
                           ("cem_mppi_solve_ms_n10240", 10240, "cem_mppi")):
        chains[key] = chain_of(*make_sampling_solver(cfg, n, method))
    chains["closed_loop_solve_ms_n10240"] = chain_of(
        *make_sampling_solver(cfg, 10240, "random_sampling"), closed_loop=True)

    ga_solve, P = make_gait_adaptive_solver(cfg, 9216, "random_sampling")
    phase = jnp.asarray([0.1, 0.6, 0.6, 0.1], jnp.float32)

    @jax.jit
    def ga_chain(s):
        def body(_, s):
            return ga_solve(state12, feet, ref12, feet, phase, jnp.float32(1.4),
                            jnp.asarray(True), seq, cur, prev, s)[1]
        return jax.lax.fori_loop(0, CHAIN, body, s)
    chains["gait_adaptive_solve_ms_n9216"] = chained(ga_chain, state0(P))

    # Served tick: one solve per call, ending in a host readback of the GRFs.
    solve, P = make_sampling_solver(cfg)
    st = state0(P)
    out, st = solve(state12, feet, ref12, feet, seq, cur, prev, st)
    np.asarray(out.grfs)

    def latency():
        s, enq, tick = st, [], []
        for _ in range(200):
            t0 = time.perf_counter()
            out, s = solve(state12, feet, ref12, feet, seq, cur, prev, s)
            t1 = time.perf_counter()
            np.asarray(out.grfs)
            t2 = time.perf_counter()
            enq.append((t1 - t0) * 1e3)
            tick.append((t2 - t0) * 1e3)
        return {"enqueue_ms": float(np.median(enq)),
                "tick_ms_p50": float(np.median(tick)),
                "tick_ms_p99": float(np.percentile(tick, 99))}

    return [lambda: {k: fn() for k, fn in chains.items()}, latency]


def build_gradient():
    """Gradient RTI-SQP solve and its latency-critical feedback phase."""
    import jax
    import jax.numpy as jnp

    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.controllers.gradient import make_rti_solver_split

    gcfg = make_config("aliengo", mpc_type="nominal")
    solve, prepare, feedback, dims = make_rti_solver_split(gcfg)
    H = dims.horizon
    x0 = jnp.zeros(12).at[2].set(0.30)
    feet_traj = jnp.tile(jnp.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                                      [-0.25, 0.15, 0], [-0.25, -0.15, 0]], jnp.float32),
                         (H, 1, 1))
    seq = jnp.ones((4, H))
    Xref = jnp.tile(jnp.zeros(12).at[2].set(0.35), (H, 1))
    Uref = jnp.zeros((H, 12)).at[:, 2::3].set(gcfg.robot.mass * 9.81 / 4)

    @jax.jit
    def chain(U):
        return jax.lax.fori_loop(
            0, CHAIN, lambda _, U: solve(x0, feet_traj, seq, Xref, Uref, U).U, U)

    prep = prepare(x0, feet_traj, seq, Xref, Uref, Uref)

    @jax.jit
    def fb_chain(x):
        def body(_, x):
            out = feedback(prep, x, feet_traj, seq, Xref, Uref)
            return x0 + 1e-9 * out.U[0, 0]  # data dependency serializes the solves
        return jax.lax.fori_loop(0, CHAIN, body, x)

    t_solve = chained(chain, jnp.zeros((H, 12)), reps=5)
    t_fb = chained(fb_chain, x0, reps=5)
    return [lambda: {"rti_sqp_solve_ms": t_solve(), "rti_feedback_phase_ms": t_fb()}]


def build_tamols(cfg):
    """Fused TAMOLS scoring of all cells of the four legs' default windows."""
    import jax
    import jax.numpy as jnp

    from chip_smoke import tamols_inputs
    from quadruped_pympc_tamols.planner.tamols import make_tamols_scorer

    adapt = make_tamols_scorer(cfg, strategy="tamols")
    args = jax.device_put(tamols_inputs(cfg, n_cases=1)[0])

    @jax.jit
    def chain(acc):
        return jax.lax.fori_loop(
            0, CHAIN, lambda _, acc: acc + adapt(*args).footholds[:, :2].sum(), acc)
    t = chained(chain, jnp.float32(0.0), reps=1)
    return [lambda: {"tamols_score_ms": t()}]


def build_wb_tick(cfg):
    """Fused per-control-step whole-body kernel (all-leg swing refs + IK)."""
    import jax
    import jax.numpy as jnp

    from quadruped_pympc_tamols.gait.swing import make_swing_ik_step

    step = make_swing_ik_step(cfg.robot)
    t = jnp.asarray([0.1, 0.0, 0.0, 0.1])
    period = jnp.full(4, 0.25)
    sh = jnp.full(4, cfg.sim.step_height)
    lo = jnp.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                      [-0.25, 0.15, 0], [-0.25, -0.15, 0]], jnp.float32)
    td = lo + jnp.asarray([0.06, 0.0, 0.0])
    mask = jnp.asarray([1.0, 0.0, 0.0, 1.0])
    bp = jnp.zeros(3).at[2].set(cfg.sim.ref_z)

    @jax.jit
    def chain(x):
        def body(_, acc):
            q = step(t, period, sh, lo, td, mask, td, bp + acc * 0, jnp.zeros(3))[3]
            return acc + q.sum()
        return jax.lax.fori_loop(0, CHAIN, body, x)
    tt = chained(chain, jnp.float32(0.0), reps=1)
    return [lambda: {"wb_swing_ik_tick_ms": tt()}]


def build_fleet(cfg, n_scenarios=80, n_steps=10):
    """On-device closed-loop scenario fleet (perlin terrain, TAMOLS, reflexes) at
    the reference's batched-datagen size: 80 scenarios x the default 10,000
    samples."""
    import jax

    from chip_smoke import make_fleet

    step, states, cmd = make_fleet(cfg, n_scenarios)

    @jax.jit
    def chain(s):
        return jax.lax.fori_loop(0, n_steps, lambda _, s: step(s, cmd)[0], s)
    jax.block_until_ready(chain(states))

    def run():
        ms = best_of(lambda: jax.block_until_ready(chain(states)), n_steps)
        return {"fleet_scenario_steps_per_s": n_scenarios * 1e3 / ms}
    return [run]


def ladders():
    """Deterministic solver-accuracy gaps against the float64 references
    (tests/test_f64_ladder.py), run once outside the timed passes."""
    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.utils.verification import (
        qp_ladder_report, rollout_ladder_report)

    qp = qp_ladder_report(make_config("aliengo", mpc_type="nominal",
                                      **{"sim.visual_foothold_adaptation": "blind"}),
                          n_ticks=20)
    roll = rollout_ladder_report()
    return {"qp_ladder_n_ticks": qp["n_ticks"], "qp_ipm_iters": qp["iters"],
            "qp_gap_vs_f64_max_N": qp["qp_gap_vs_f64_max_N"],
            "qp_gap_vs_f64_rel": qp["qp_gap_vs_f64_rel"],
            "rollout_gap_vs_f64_rel": roll["rollout_gap_vs_f64_rel"]}


def main():
    from chip_smoke import gpu_card, require_gpu
    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = require_gpu()
    card = gpu_card()
    cfg = make_config("aliengo", mpc_type="sampling")

    thunks = (build_sampling(cfg) + build_gradient() + build_tamols(cfg)
              + build_wb_tick(cfg) + build_fleet(cfg))
    samples: dict[str, list] = {}
    for _ in range(PASSES):
        for t in thunks:
            for k, v in t().items():
                samples.setdefault(k, []).append(v)
    med = {k: float(np.median(v)) for k, v in samples.items()}
    spread = {k: 100.0 * (max(v) - min(v)) / float(np.median(v))
              for k, v in samples.items()}

    headline = med["xla_solve_ms"]
    result = {
        "metric": "sampling_mpc_10k_rollout_solve_ms",
        "value": headline,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / headline,
        "solves_per_s": 1e3 / headline,
        **med,
        "rti_sqp_vs_5ms_baseline": 5.0 / med["rti_sqp_solve_ms"],
        **ladders(),
        "num_samples": cfg.mpc.sampling.num_samples,
        "horizon": cfg.mpc.horizon,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "noise_model": f"median of {PASSES} interleaved passes; "
                       "spread_pct = (max - min) / median",
        "spread_pct": dict(sorted(spread.items())),
    }
    print(json.dumps(result))


def scaling_main():
    """`python bench.py --scaling`: a CPU simulation of multi-host scaling.

    Forks real jax.distributed process groups on the local CPU (every "host"
    is a process on this machine, sharing its cores) and reports fleet
    throughput and parallel efficiency per process count. It measures the
    distributed runtime's overhead, not device speed."""
    from quadruped_pympc_tamols.parallel.multihost import scaling_table

    rows = scaling_table(proc_counts=(1, 2, 4), local_devices=2, n_steps=8,
                         scenarios_per_device=4, num_samples=512)
    print(json.dumps({"metric": "multihost_scaling_cpu_simulation", "rows": rows}))


if __name__ == "__main__":
    if "--scaling" in sys.argv:
        scaling_main()
    else:
        main()
