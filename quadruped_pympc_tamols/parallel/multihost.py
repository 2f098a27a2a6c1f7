"""Multi-host scaling: jax.distributed process groups.

The reference has no distributed backend at all — its widest fan-out is 4 OS
processes on one box (reference simulation/batched_simulations.py:22-58).
This module is the missing scaling axis of SURVEY §2.7/P3: **scenarios shard over
hosts (network), samples shard over the devices within a host (NVLink)**, with the
same `shard_map` program as the single-host path (parallel/sharded.py) — JAX SPMD
means the mesh shape is the only thing that changes.

Topology
--------
A mesh with axes ("scenario", "sample") over all global devices, rows grouped by
process so that:

* the "sample" axis (rollout-batch pmin/psum/all_gather reductions — the chatty
  collectives) stays INSIDE one host, on the intra-host interconnect;
* the "scenario" axis (independent closed-loop scenarios; one psum per step for
  fleet metrics) crosses hosts — exactly the traffic that tolerates network
  latency.

Every process runs this same program (standard JAX multi-controller SPMD): inputs
are global `jax.Array`s built from process-local shards with
`jax.make_array_from_process_local_data`; fleet metrics come back fully replicated
so every host can read them.

Local simulation
----------------
`launch_local_multihost(n_proc, ...)` forks N local CPU processes (each with K
virtual XLA host devices) around a 127.0.0.1 coordinator — the same code path as a
real cluster (cross-process collectives run over the coordinator's TCP
transport), used by `__graft_entry__.dryrun_multihost` and the tests. On real
hardware, call `init_multihost()` with the cluster's coordinator address, process
count and process id, and run
`python -m quadruped_pympc_tamols.parallel.multihost` on every host.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np


def find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Initialize the JAX process group (idempotent).

    With no arguments, defers to jax.distributed.initialize() auto-detection
    (SLURM and the other cluster environments JAX recognizes). With explicit
    arguments, joins the given coordinator — this is what the local-simulation
    workers use.
    """
    import jax

    # NB: no jax.process_count() guard here — reading it would initialize the XLA
    # backend, after which jax.distributed.initialize() refuses to run.
    kw = {}
    if coordinator_address is not None:
        kw = dict(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError as e:  # already part of a process group
        if "already" not in str(e):
            raise


def multihost_mesh(samples_per_host: int | None = None):
    """Global ("scenario", "sample") mesh with the sample axis inside each host.

    Devices are laid out so every "sample"-axis ring is a single process's local
    devices and the "scenario" axis crosses processes. With L local
    devices per host and samples_per_host = n (a divisor of L), each host
    contributes L/n scenario rows of n sample columns.
    """
    import jax
    from jax.sharding import Mesh

    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    L = jax.local_device_count()
    n = samples_per_host or L
    if L % n:
        raise ValueError(f"samples_per_host={n} must divide local device count {L}")
    arr = np.array(devs).reshape(len(devs) // n, n)
    return Mesh(arr, ("scenario", "sample"))


def make_multihost_fleet(cfg, mesh, scenarios_per_device: int = 1,
                         num_samples: int = 240):
    """Multi-host fleet step: same SPMD program as make_multichip_step, plus the
    process-local -> global array plumbing.

    Returns (step, init, n_global_scenarios) where ``init(seed)`` builds the
    fleet's ScenarioStates as global jax.Arrays (each host materializes only its
    own scenarios) and ``step(states, cmd_vels) -> (states', metrics)`` with
    metrics fully replicated across hosts.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .scenario_engine import init_scenario_state
    from .sharded import make_multichip_step

    step, _local_init, Pn = make_multichip_step(
        cfg, mesh, scenarios_per_device=scenarios_per_device,
        num_samples=num_samples)

    n_scen_rows = mesh.shape["scenario"]
    B = n_scen_rows * scenarios_per_device
    sharding = NamedSharding(mesh, P("scenario"))

    # Scenario rows owned by this process (mesh rows are process-grouped).
    row_procs = [r[0].process_index for r in mesh.devices]
    my_rows = [i for i, p in enumerate(row_procs) if p == jax.process_index()]

    def _globalize(local_pytree):
        return jax.tree.map(
            lambda x: jax.make_array_from_process_local_data(
                sharding, np.asarray(x)), local_pytree)

    def init(seed: int = 0):
        keys = jax.random.split(jax.random.PRNGKey(seed), B)
        my_idx = np.concatenate(
            [np.arange(r * scenarios_per_device, (r + 1) * scenarios_per_device)
             for r in my_rows])
        local = jax.vmap(lambda k: init_scenario_state(cfg, Pn, k))(keys[my_idx])
        return _globalize(local)

    def globalize_cmd(cmd_local):
        """(B_local, 3) per-process command velocities -> global array."""
        return _globalize(np.asarray(cmd_local, np.float32))

    return step, init, globalize_cmd, B, len(my_rows) * scenarios_per_device


def run_fleet(n_steps: int = 5, scenarios_per_device: int = 2,
              num_samples: int = 48, samples_per_host: int | None = None,
              seed: int = 0, robot: str = "aliengo"):
    """Run a closed-loop MPC fleet over the initialized process group.

    Returns (metrics_last, wall_s_per_step, B) — metrics are the fleet-wide
    psum-reduced [vel_err, best_cost], identical on every host.
    """
    import jax
    import jax.numpy as jnp

    from ..config import make_config, replace_config

    mesh = multihost_mesh(samples_per_host)
    n_sample = mesh.shape["sample"]
    cfg = make_config(robot, mpc_type="sampling")
    cfg = replace_config(cfg, **{"mpc.sampling.num_samples": num_samples})

    step, init, globalize_cmd, B, B_local = make_multihost_fleet(
        cfg, mesh, scenarios_per_device=scenarios_per_device,
        num_samples=max(num_samples, 3 * n_sample))
    states = init(seed)
    cmd = globalize_cmd(np.tile([0.3, 0.0, 0.0], (B_local, 1)))

    # Compile step (first call), then time the rest.
    states, metrics = step(states, cmd)
    jax.block_until_ready(metrics)
    t0 = time.perf_counter()
    for _ in range(n_steps - 1):
        states, metrics = step(states, cmd)
    jax.block_until_ready(metrics)
    wall = (time.perf_counter() - t0) / max(1, n_steps - 1)
    return np.asarray(metrics), wall, B


def launch_local_multihost(n_proc: int, local_devices: int = 2, n_steps: int = 5,
                           scenarios_per_device: int = 2, num_samples: int = 48,
                           timeout_s: float = 600.0) -> dict:
    """Fork n_proc local CPU worker processes around a localhost coordinator and
    run the multi-host fleet. Returns process 0's JSON report.

    This exercises the REAL multi-process path: jax.distributed handshake, global
    meshes spanning processes, cross-process psum over the scenario axis.

    The workers run on the CPU platform: N processes must not each reserve an
    accelerator's memory (a JAX process takes most of a GPU's memory when it
    first touches it).
    """
    from ..utils.compile_cache import compile_cache_env

    port = find_free_port()
    # Workers share the repo's persistent compile cache so repeated
    # local-simulation runs skip XLA compiles.
    env_base = compile_cache_env(os.environ)
    env_base["JAX_PLATFORMS"] = "cpu"
    env_base["XLA_FLAGS"] = (
        env_base.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", "").strip()
        + f" --xla_force_host_platform_device_count={local_devices}").strip()
    env_base.pop("JAX_PLATFORM_NAME", None)

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for pid in range(n_proc):
        cmd = [sys.executable, "-m",
               "quadruped_pympc_tamols.parallel.multihost",
               "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", str(n_proc), "--process-id", str(pid),
               "--steps", str(n_steps),
               "--scenarios-per-device", str(scenarios_per_device),
               "--num-samples", str(num_samples)]
        procs.append(subprocess.Popen(
            cmd, env=env_base, cwd=repo_root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    deadline = time.time() + timeout_s
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError("multihost worker timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        if rc != 0:
            raise RuntimeError(f"multihost worker failed rc={rc}:\n{err[-4000:]}")
    report = None
    for rc, out, err in outs:
        for line in out.splitlines():
            if line.startswith("{"):
                report = json.loads(line)
    if report is None:
        raise RuntimeError("no worker report found")
    return report


def scaling_table(proc_counts=(1, 2), local_devices: int = 2, n_steps: int = 6,
                  scenarios_per_device: int = 2, num_samples: int = 48) -> list:
    """Scaling-efficiency measurement (BASELINE.md north-star: solves/s at 1 chip /
    1 host / N>=2 hosts). Runs the same fleet program at each simulated host count
    and reports throughput + parallel efficiency vs the 1-host run.

    Two efficiency columns, because the local simulation runs every "host" on ONE
    physical machine (all simulated hosts share the same CPU cores):

    * ``efficiency`` = thru_N / (N * thru_1): true weak-scaling efficiency. Only
      meaningful on real hardware where hosts have disjoint cores/chips; locally
      it is bounded by 1/N because total compute is fixed.
    * ``fixed_hw_efficiency`` = thru_N / thru_1: distributed-runtime overhead at
      fixed hardware — what the local simulation CAN measure honestly. 1.0 means
      splitting the fleet across process boundaries (jax.distributed handshake +
      cross-process psum per step) costs nothing vs one process on the same cores.
    """
    rows = []
    base = None
    for n in proc_counts:
        rep = launch_local_multihost(
            n, local_devices=local_devices, n_steps=n_steps,
            scenarios_per_device=scenarios_per_device, num_samples=num_samples)
        thru = rep["scenario_steps_per_s"]
        if base is None:
            base = thru / n  # per-host baseline from the first entry
        rows.append({
            "hosts": n,
            "devices": rep["global_devices"],
            "fleet_scenarios": rep["fleet_scenarios"],
            "step_wall_ms": round(rep["step_wall_s"] * 1e3, 2),
            "scenario_steps_per_s": thru,
            "efficiency": round(thru / (n * base), 3),
            "fixed_hw_efficiency": round(thru / (base * proc_counts[0]), 3),
        })
    return rows


def _main():
    ap = argparse.ArgumentParser(description="multi-host fleet worker")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--scenarios-per-device", type=int, default=2)
    ap.add_argument("--num-samples", type=int, default=48)
    ap.add_argument("--samples-per-host", type=int, default=None)
    args = ap.parse_args()

    import jax

    init_multihost(args.coordinator, args.num_processes, args.process_id)
    metrics, wall_per_step, B = run_fleet(
        n_steps=args.steps, scenarios_per_device=args.scenarios_per_device,
        num_samples=args.num_samples, samples_per_host=args.samples_per_host)
    assert np.all(np.isfinite(metrics)), f"non-finite fleet metrics: {metrics}"
    if jax.process_index() == 0:
        print(json.dumps({
            "processes": jax.process_count(),
            "global_devices": jax.device_count(),
            "local_devices": jax.local_device_count(),
            "fleet_scenarios": int(B),
            "fleet_vel_err": float(metrics[0]),
            "fleet_cost": float(metrics[1]),
            "step_wall_s": round(wall_per_step, 4),
            "scenario_steps_per_s": round(B / wall_per_step, 1),
        }))
    jax.distributed.shutdown()


if __name__ == "__main__":
    _main()
