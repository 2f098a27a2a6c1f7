"""Multi-chip sharding on the 8-device virtual CPU mesh: sharded sampling solver
(sample-axis pmin/psum reductions), fleet scenario step, and the graft entry points."""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadruped_pympc_tamols import make_config, replace_config
from quadruped_pympc_tamols.controllers.sampling import SamplingState
from quadruped_pympc_tamols.parallel import (
    make_multichip_step,
    make_sharded_sampling_solver,
    scenario_mesh,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual CPU devices"
    return scenario_mesh(4, 2)


def _inputs(cfg):
    state12 = jnp.zeros(12, jnp.float32).at[2].set(cfg.sim.ref_z - 0.04)
    feet = jnp.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                        [-0.25, 0.15, 0], [-0.25, -0.15, 0]], jnp.float32)
    ref12 = jnp.zeros(12, jnp.float32).at[2].set(cfg.sim.ref_z)
    seq = jnp.ones((4, cfg.mpc.horizon), jnp.float32)
    return state12, feet, ref12, seq


@pytest.mark.parametrize("method", ["random_sampling", "mppi"])
def test_sharded_sampling_solver(mesh, method):
    cfg = make_config("aliengo", mpc_type="sampling")
    solve, P = make_sharded_sampling_solver(cfg, mesh, num_samples=240, method=method)
    state12, feet, ref12, seq = _inputs(cfg)
    st = SamplingState(jnp.zeros(P, jnp.float32), jax.random.PRNGKey(0),
                       jnp.full(P, 3.0, jnp.float32))
    grfs, st2, cost = solve(state12, feet, ref12, seq, st)
    g = np.asarray(grfs)
    assert g.shape == (4, 3) and np.all(np.isfinite(g))
    assert np.all(g[:, 2] >= -1e-5)
    assert float(cost) < 1e6
    # A second call with the carried state improves or holds the cost.
    grfs2, st3, cost2 = solve(state12, feet, ref12, seq, st2)
    assert np.isfinite(float(cost2))


def test_multichip_fleet_step(mesh):
    cfg = make_config("aliengo", mpc_type="sampling")
    step, init, P = make_multichip_step(cfg, mesh, scenarios_per_device=2,
                                        num_samples=48)
    states = init(seed=0)
    B = 4 * 2
    cmd = jnp.tile(jnp.asarray([0.3, 0.0, 0.0], jnp.float32), (B, 1))
    for _ in range(3):
        states, metrics = step(states, cmd)
    m = np.asarray(metrics)
    assert m.shape == (2,) and np.all(np.isfinite(m))
    xs = np.asarray(states.x)
    assert xs.shape == (B, 12)
    assert np.all(np.isfinite(xs))
    assert np.all(xs[:, 2] > 0.1), "fleet scenarios collapsed"


def test_multichip_terrain_fleet_walks_boxes(mesh):
    """The 8-device fleet step runs ROUGH-TERRAIN scenarios —
    per-scenario procedural heightfields as pytree state, per-leg heightmap
    sensing + the fused TAMOLS scorer adapting footholds every tick, touch-downs
    landing on the surface — and the psum fleet metrics stay finite while the
    fleet makes forward progress."""
    cfg = make_config("aliengo", mpc_type="sampling")
    step, init, P = make_multichip_step(cfg, mesh, scenarios_per_device=2,
                                        num_samples=48, terrain="boxes")
    states = init(seed=0)
    B = 4 * 2
    terr = np.asarray(states.terrain)
    assert terr.shape[0] == B and terr.shape[1:] != (1, 1)
    assert np.any(terr > 0.015), "procedural terrain is flat"
    assert not np.allclose(terr[0], terr[1]), "scenarios share one heightfield"
    cmd = jnp.tile(jnp.asarray([0.25, 0.0, 0.0], jnp.float32), (B, 1))
    x0 = np.asarray(states.x)[:, 0].copy()
    for _ in range(60):  # 0.6 s of closed loop at 100 Hz (standing start)
        states, metrics = step(states, cmd)
    m = np.asarray(metrics)
    assert m.shape == (2,) and np.all(np.isfinite(m))
    xs = np.asarray(states.x)
    assert np.all(np.isfinite(xs))
    assert np.all(xs[:, 2] > 0.1), "fleet scenarios collapsed"
    assert np.mean(xs[:, 0] - x0) > 0.02, "fleet made no forward progress"
    feet = np.asarray(states.feet)
    # At least one scenario planted a foot on raised terrain (TAMOLS-adapted
    # touch-down took the surface height, not z=0).
    assert np.max(feet[..., 2]) > 0.015, "no touch-down ever landed on a box"


def test_terrain_generators_shapes():
    from quadruped_pympc_tamols.parallel import make_terrain_generator

    for kind in ("boxes", "stairs", "perlin"):
        gen = make_terrain_generator(kind)
        h = np.asarray(gen(jax.random.PRNGKey(1)))
        assert h.shape == (64, 64)
        assert np.all(h >= 0.0) and np.max(h) > 0.01
        # Spawn neighbourhood stays flat (scenarios start standing at x=0).
        assert np.all(h[:6] == 0.0)  # rows cover x < 0
    gen = make_terrain_generator("boxes")
    h1 = np.asarray(gen(jax.random.PRNGKey(1)))
    h2 = np.asarray(gen(jax.random.PRNGKey(2)))
    assert not np.allclose(h1, h2), "terrain does not vary with the key"
    # Perlin is CONTINUOUS roughness: a large fraction of mid-field cells is
    # strictly between the extremes (boxes/stairs are piecewise-flat).
    gp = make_terrain_generator("perlin")
    hp = np.asarray(gp(jax.random.PRNGKey(3)))[20:50]
    frac_mid = np.mean((hp > 0.2 * hp.max()) & (hp < 0.8 * hp.max()))
    assert frac_mid > 0.3, f"perlin field not continuous (mid frac {frac_mid:.2f})"


def test_perlin_fleet_with_reflexes():
    """The on-device fleet covers perlin-class
    CONTINUOUS roughness and runs the early-stance reflex — a swing foot whose
    commanded Bezier point grazes the sensed surface mid-swing (under the 5 cm
    clearance margin; kinematic feet track perfectly, so a graze is what an
    early strike looks like here) has its swing RE-PLANNED from the recorded
    (hitpoint, hitmoment) with compressed remaining time and the reflex apex —
    the host scipy-generator re-plan as a pure state update, not just an apex
    raise. The test asserts RECOVERY BEHAVIOR, not just the trigger count:
    after a firing, the re-planned command must climb away from the hitpoint
    within a few ticks."""
    from quadruped_pympc_tamols.parallel import (
        init_scenario_state,
        make_scenario_step,
        make_terrain_generator,
    )

    cfg = make_config("aliengo", mpc_type="sampling")
    step, P = make_scenario_step(cfg, num_samples=48, terrain="perlin",
                                 reflexes=True)
    gen = make_terrain_generator("perlin")
    B = 6
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states = jax.vmap(lambda k: init_scenario_state(cfg, P, k, gen))(keys)
    vstep = jax.jit(jax.vmap(step, in_axes=(0, None)))
    cmd = jnp.asarray([0.25, 0.0, 0.0], jnp.float32)
    x0 = np.asarray(states.x)[:, 0].copy()
    triggers = 0.0
    recoveries = []  # (commanded z rise 4 ticks after a firing, hitpoint z)
    pending = []  # (ticks_left, scenario, leg, hitpoint_z)
    for _ in range(150):  # 1.5 s at 100 Hz
        prev_active = np.asarray(states.reflex) >= 0.0
        states, metrics = vstep(states, cmd)
        triggers += float(np.sum(np.asarray(metrics["reflex_triggers"])))
        now_active = np.asarray(states.reflex) >= 0.0
        hp = np.asarray(states.hitpoint)
        for b, leg in zip(*np.where(now_active & ~prev_active)):
            pending.append([4, b, leg, hp[b, leg, 2]])
        nxt = []
        feet = np.asarray(states.feet)
        for item in pending:
            item[0] -= 1
            b, leg = item[1], item[2]
            if item[0] == 0:
                # Still in the same swing (reflex active) -> the re-planned
                # command must have climbed off the hitpoint.
                if now_active[b, leg]:
                    recoveries.append(feet[b, leg, 2] - item[3])
            else:
                nxt.append(item)
        pending = nxt
    xs = np.asarray(states.x)
    assert np.all(np.isfinite(xs))
    assert np.all(xs[:, 2] > 0.1), "fleet scenarios collapsed"
    assert np.mean(xs[:, 0] - x0) > 0.05, "fleet made no forward progress"
    assert triggers > 0, "reflex never fired on continuous roughness"
    assert len(recoveries) > 0, "no reflex swing lasted long enough to judge"
    assert np.median(recoveries) > 0.005, \
        f"re-planned swings did not climb off the hitpoint: {recoveries}"


def test_graft_entry_points():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", Path(__file__).parent.parent / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    out = fn(*args)
    jax.block_until_ready(out)
    assert np.all(np.isfinite(np.asarray(out[0].grfs)))

    mod.dryrun_multichip(8)


def test_sharded_cem_mppi_exact_topk():
    """Sharded CEM-MPPI: the global elite set (distributed top-k via per-shard
    top-k + all_gather) matches single-chip semantics — sigma adapts per parameter
    and stays within the configured clamp."""
    import jax.numpy as jnp

    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.controllers.sampling import SamplingState
    from quadruped_pympc_tamols.parallel import (
        make_sharded_sampling_solver,
        scenario_mesh,
    )

    cfg = make_config("aliengo", mpc_type="sampling",
                      **{"mpc.sampling.method": "cem_mppi",
                         "mpc.sampling.num_samples": 64 * 4})
    mesh = scenario_mesh(2, 4)
    solve, P = make_sharded_sampling_solver(cfg, mesh, method="cem_mppi")
    sp = cfg.mpc.sampling
    state12 = jnp.zeros(12).at[2].set(cfg.sim.ref_z - 0.03)
    feet = jnp.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                        [-0.25, 0.15, 0], [-0.25, -0.15, 0]], jnp.float32)
    ref12 = jnp.zeros(12).at[2].set(cfg.sim.ref_z)
    seq = jnp.ones((4, cfg.mpc.horizon))
    st = SamplingState(jnp.zeros(P, jnp.float32), jax.random.PRNGKey(0),
                       jnp.full(P, sp.sigma_cem_mppi, jnp.float32))
    costs = []
    for _ in range(4):
        grfs, st, best = solve(state12, feet, ref12, seq, st)
        costs.append(float(best))
    sig = np.asarray(st.sigma)
    assert np.all(sig >= sp.cem_sigma_min - 1e-6)
    assert np.all(sig <= sp.cem_sigma_max + 1e-6)
    assert sig.std() > 1e-6  # per-parameter adaptation actually happened
    assert costs[-1] <= costs[0] + 1e-3  # iterations do not regress
    assert np.all(np.isfinite(np.asarray(grfs)))
