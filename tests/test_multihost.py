"""Multi-host scaling path: real jax.distributed process groups.

The reference's widest fan-out is 4 OS processes on one box
(reference simulation/batched_simulations.py:22-58); it has no distributed
backend at all (SURVEY §2.7). These tests fork REAL worker processes around a
localhost coordinator and run the closed-loop MPC fleet on a global mesh whose
"scenario" axis crosses processes — the same code path as a multi-host cluster
(cross-process psum rides the coordinator's TCP transport standing in for the
network).
"""
import numpy as np

from quadruped_pympc_tamols.parallel.multihost import (
    launch_local_multihost,
    multihost_mesh,
)


def test_two_process_fleet_runs_and_reduces():
    rep = launch_local_multihost(n_proc=2, local_devices=2, n_steps=3)
    assert rep["processes"] == 2
    assert rep["global_devices"] == 4
    assert rep["local_devices"] == 2
    # 2 hosts x (2 local devices / 2 sample cols = 1 scenario row) x 2 per device
    assert rep["fleet_scenarios"] == 4
    assert np.isfinite(rep["fleet_vel_err"]) and rep["fleet_vel_err"] < 2.0
    assert np.isfinite(rep["fleet_cost"])
    assert rep["scenario_steps_per_s"] > 0


def test_multihost_mesh_sample_axis_stays_on_host():
    """Single-process sanity: mesh rows group by process so sample-axis collectives
    never cross hosts (here all devices are local, so it reduces to a shape check)."""
    mesh = multihost_mesh(samples_per_host=2)
    assert mesh.axis_names == ("scenario", "sample")
    assert mesh.shape["sample"] == 2
    for row in mesh.devices:
        assert len({d.process_index for d in row}) == 1


def test_four_process_fleet_table():
    """4-process table refresh: the widest local stand-in
    for a multi-host cluster — 4 forked jax.distributed workers x 2 virtual
    devices on a global (scenario, sample) mesh, run alongside the round's
    fleet changes (hitpoint-re-plan reflexes ride the same scenario engine)."""
    rep = launch_local_multihost(n_proc=4, local_devices=2, n_steps=2)
    assert rep["processes"] == 4
    assert rep["global_devices"] == 8
    assert np.isfinite(rep["fleet_vel_err"]) and rep["fleet_vel_err"] < 2.0
    assert np.isfinite(rep["fleet_cost"])
    assert rep["scenario_steps_per_s"] > 0
