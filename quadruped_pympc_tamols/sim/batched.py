"""Batched MuJoCo simulations + on-device scenario fan-out.

Counterpart of the reference batched_simulations.py (22-89: 4 OS processes x 20
randomized episodes each, headless, with success-rate/tracking-error aggregation).
Two tiers:

* ``run_batched_simulations`` — host-process fan-out over full-physics MuJoCo
  episodes (velocity/friction randomization), aggregated into fleet statistics. Uses
  multiprocessing when worker_count > 1, inline otherwise.
* For thousands of scenarios, the ON-DEVICE engine (parallel/scenario_engine.py +
  parallel/sharded.py) replaces process fan-out entirely: vmapped closed-loop MPC
  scenarios sharded over the chip mesh.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp

import numpy as np

from ..config import Config


@dataclasses.dataclass
class FleetStats:
    episodes: int
    success_rate: float
    mean_tracking_error: float
    std_tracking_error: float
    mean_distance: float


def _run_worker(args):
    cfg, n_eps, duration, vel_range, friction_range, seed = args
    # Host-farm workers run on CPU: N spawned processes must not each reserve
    # the accelerator's memory (a JAX process takes most of a GPU's memory when
    # it first touches it). The device tier for scenario fan-out is
    # parallel/scenario_engine.py instead.
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass  # backend already initialized (inline mode) — leave it be
    from .simulation import run_simulation

    out = []
    results = run_simulation(cfg, num_episodes=n_eps, episode_duration_s=duration,
                             ref_base_lin_vel=("random", *vel_range),
                             friction_range=friction_range, seed=seed)
    for r in results:
        out.append((not r.fell, r.mean_vel_error, r.distance))
    return out


def run_batched_simulations(cfg: Config, num_processes: int = 2,
                            episodes_per_process: int = 4,
                            episode_duration_s: float = 2.0,
                            vel_range=(0.1, 0.4), friction_range=(0.6, 1.0),
                            seed: int = 0, inline: bool = False) -> FleetStats:
    """Randomized-episode success-rate harness (reference batched_simulations.py).

    NOTE: with num_processes > 1 the workers are SPAWNED — call this from under an
    ``if __name__ == "__main__":`` guard in scripts (standard multiprocessing
    semantics) or the re-imported main module will fan out recursively. Workers
    force the CPU JAX platform (see _run_worker)."""
    jobs = [(cfg, episodes_per_process, episode_duration_s, vel_range, friction_range,
             seed + i * episodes_per_process) for i in range(num_processes)]
    if inline or num_processes == 1:
        all_results = [r for job in jobs for r in _run_worker(job)]
    else:
        with mp.get_context("spawn").Pool(num_processes) as pool:
            all_results = [r for chunk in pool.map(_run_worker, jobs) for r in chunk]

    ok = np.array([r[0] for r in all_results], dtype=float)
    err = np.array([r[1] for r in all_results])
    dist = np.array([r[2] for r in all_results])
    return FleetStats(
        episodes=len(all_results),
        success_rate=float(ok.mean()),
        mean_tracking_error=float(err.mean()),
        std_tracking_error=float(err.std()),
        mean_distance=float(dist.mean()),
    )
