"""Sampling-based MPC (random-sampling / MPPI / CEM-MPPI) — fully fused on device.

JAX re-design of the reference Sampling_MPC
(controllers/sampling/centroidal_nmpc_jax.py:20-1097). One jitted call performs:

  noise generation -> force-trajectory GEMM (params @ spline basis) -> gravity-share +
  contact masking + friction-cone clamping (elementwise over the whole
  (N, H, 4, 3) force tensor) -> lax.scan SRB integration accumulating quadratic state
  cost -> optimizer update (argmin / MPPI softmax / CEM sigma refit) -> first-step GRF
  extraction -> one-step predicted state.

Differences from the reference implementation (behavior preserved):
* The reference vmaps a per-sample Python rollout whose inner loop re-evaluates the
  splines per leg per step (centroidal_nmpc_jax.py:341-494). Here the linear
  parametrizations are folded into a single matmul (see splines.py) and the rollout is
  batch-first, so XLA sees large fused elementwise ops instead of 10k tiny programs.
* Warm-start handling (swing-leg parameter reset at lift-off edges, reference
  centroidal_nmpc_jax.py:612-625; optional solution shift :513-561) happens inside the
  same jit, so the controller never round-trips parameters to the host.
* Sampling iterations (config num_sampling_iterations, reference
  srbd_controller_interface.py:118-180) run as an in-jit lax.scan.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config import Config
from ...dynamics.srbd import SRBDParams, integrate_euler, make_params
from .rollout import (ForceModelParams, apply_force_model_rows,
                      equilibrium_share, rollout_costs_soa)
from .splines import (
    make_shift_basis,
    make_spline_basis,
    make_step_major_basis,
    num_params_per_leg,
    spline_forces,
)

_COST_SATURATION = 1.0e6


class SolveOutput(NamedTuple):
    grfs: Any  # (4, 3) world-frame ground reaction forces for the first step
    footholds: Any  # (4, 3) — zeros; sampling MPC does not optimize footholds
    predicted_state: Any  # (12,) one-step-ahead base state
    best_parameters: Any  # (4*P_leg,)
    best_cost: Any  # scalar
    costs: Any  # (N,) all rollout costs (diagnostics)
    sigma: Any  # (4*P_leg,) CEM sigma state (unchanged unless cem_mppi)
    best_freq: Any  # scalar step frequency (constant here; gait-adaptive overrides)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SamplingState:
    """Device-side controller state carried across MPC ticks."""

    best_parameters: Any  # (4*P_leg,)
    key: Any  # PRNG key
    sigma: Any  # (4*P_leg,) CEM sigma

    def tree_flatten(self):
        return (self.best_parameters, self.key, self.sigma), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def sample_noise(sp, method: str, key, sigma, P: int, N: int):
    """(P, N) exploration noise in SoA layout (samples on the minor axis); column 0
    is zero (the incumbent), reference centroidal_nmpc_jax.py:644-677 / :804-812 /
    :951-958. random_sampling mixes two Gaussian and one uniform third."""
    if method == "random_sampling":
        n3 = N // 3
        k1, k2, k3 = jax.random.split(key, 3)
        g1 = sp.sigma_random[0] * jax.random.normal(k1, (P, n3))
        g2 = sp.sigma_random[1] * jax.random.normal(k2, (P, n3))
        u3 = jax.random.uniform(k3, (P, N - 1 - 2 * n3),
                                minval=-sp.sigma_random[2], maxval=sp.sigma_random[2])
        noise = jnp.concatenate([g1, g2, u3], axis=1)
    elif method == "mppi":
        noise = sp.sigma_mppi * jax.random.normal(key, (P, N - 1))
    elif method == "cem_mppi":
        noise = jax.random.normal(key, (P, N - 1)) * sigma[:, None]
    else:
        raise ValueError(f"unknown sampling method {method!r}")
    return jnp.concatenate([jnp.zeros((P, 1)), noise], axis=1).astype(jnp.float32)


def optimizer_update(sp, method: str, best_params, params_vec, noise, costs, sigma):
    """One optimizer step over sampled parameters ``params_vec = best_params +
    noise`` (P, N) with rollout ``costs`` (N,). Returns (new_params, new_sigma).

    * random_sampling: the lowest-cost sample;
    * mppi: the softmax(-cost / temperature)-weighted mean of the samples
      (reference centroidal_nmpc_jax.py:827-836);
    * cem_mppi: the MPPI mean plus the elite sigma refit — the unbiased std of
      the ``cem_elite`` lowest-cost noise columns, clipped
      (reference centroidal_nmpc_jax.py:1075-1081).
    """
    best_idx = jnp.argmin(costs)
    if method == "random_sampling":
        return params_vec[:, best_idx], sigma
    w = jnp.exp(-(costs - costs[best_idx]) / sp.mppi_temperature)
    w = w / jnp.sum(w)
    new_params = best_params + noise @ w
    if method == "cem_mppi":
        elite = noise[:, jax.lax.top_k(-costs, sp.cem_elite)[1]]  # (P, K)
        var = jnp.var(elite, axis=1, ddof=1) + 1e-8
        sigma = jnp.clip(jnp.sqrt(var), sp.cem_sigma_min, sp.cem_sigma_max)
    return new_params, sigma


def make_sampling_solver(cfg: Config, num_samples: int | None = None, method: str | None = None):
    """Build the jitted sampling-MPC solve function for a static config.

    Returns ``solve(state12, feet, ref12, contact_seq, prev_contact, sampling_state)
    -> (SolveOutput, SamplingState)``.
    """
    sp = cfg.mpc.sampling
    method = method or sp.method
    if method not in ("random_sampling", "mppi", "cem_mppi"):
        raise ValueError(f"unknown sampling method {method!r}")
    N = num_samples or sp.num_samples
    H = cfg.mpc.horizon
    P_leg = num_params_per_leg(sp.parametrization, H, sp.num_splines)
    P = 4 * P_leg

    # Step-major block-diagonal basis: one GEMM produces every sample's whole raw
    # force trajectory in the rollout's native (H, 12, N) layout. Factory constants
    # stay HOST numpy so they embed as MLIR constants without a device round trip.
    W_big = make_step_major_basis(sp.parametrization, H, sp.num_splines)
    dts = cfg.mpc.dts()  # (H,)
    srbd = make_params(cfg)
    Qdiag = cfg.mpc.cost.as_vector()  # host numpy (12,), static for the rollout
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)
    shift_W = make_shift_basis(sp.parametrization, H, sp.num_splines,
                               1.0 / cfg.sim.mpc_frequency)

    use_eq_share = sp.equilibrium_share

    def _share(contact_seq, state12=None, feet=None):
        """(H,) gravity-share m*g/n_stance (reference :377-385), or the (H, 4)
        static-equilibrium per-leg distribution when sampling.equilibrium_share
        (rollout.equilibrium_share — lets the sampler explore around the correct
        fore/aft split on slopes instead of rediscovering it every lift-off)."""
        if use_eq_share and state12 is not None:
            return equilibrium_share(feet, state12[:3], contact_seq, srbd.mass,
                                     9.81, fm.grf_max)
        n_stance = jnp.sum(contact_seq, axis=0)
        return srbd.mass * 9.81 / jnp.maximum(n_stance, 1.0)

    def _grf_step0(params, contact_seq, state12=None, feet=None):
        """params (P,) -> (4, 3) physical first-step GRFs (extraction path,
        reference centroidal_nmpc_jax.py:707-746)."""
        raw0 = W_big[0:12] @ params  # (12,)
        rows = apply_force_model_rows(raw0, contact_seq[:, 0],
                                      _share(contact_seq, state12, feet)[0], fm)
        return jnp.stack(rows).reshape(4, 3)

    def _one_iteration(carry, _, state12, feet, ref12, contact_seq):
        best_params, key, sigma = carry
        key, sub = jax.random.split(key)
        noise = sample_noise(sp, method, sub, sigma, P, N)
        params_vec = best_params[:, None] + noise
        raw = spline_forces(W_big, params_vec)
        costs = rollout_costs_soa(state12, feet, ref12, raw, contact_seq,
                                  _share(contact_seq, state12, feet), dts, Qdiag,
                                  srbd, fm, _COST_SATURATION,
                                  zmp_weight=sp.zmp_weight,
                                  zmp_margin=sp.zmp_margin)

        new_params, new_sigma = optimizer_update(sp, method, best_params, params_vec,
                                                 noise, costs, sigma)
        return (new_params, key, new_sigma), (jnp.min(costs), costs)

    def solve(state12, feet, ref12, ref_feet, contact_seq, current_contact, previous_contact,
              sampling_state: SamplingState):
        """Full MPC tick.

        Args:
            state12: (12,) base state [pos, vel, rpy, omega].
            feet: (4, 3) current foot positions (world).
            ref12: (12,) reference base state.
            ref_feet: (4, 3) reference footholds — substituted for swing feet
                (reference centroidal_nmpc_jax.py:588-595).
            contact_seq: (4, H) stance sequence.
            current_contact / previous_contact: (4,) stance masks for warm-start reset.
            sampling_state: SamplingState carried across ticks.
        """
        best_params = sampling_state.best_parameters
        # Swing-leg warm-start reset at lift-off edges (reference :612-625).
        liftoff_edge = (previous_contact == 1.0) & (current_contact == 0.0)  # (4,)
        keep = jnp.repeat(~liftoff_edge, P_leg).astype(jnp.float32)
        best_params = best_params * keep

        if sp.shift_solution:
            # Evaluate each leg's spline slightly ahead and fold into the first knots
            # (a corrected version of reference shift_solution :513-561).
            leg_params = best_params.reshape(4, P_leg)
            shifted0 = jnp.einsum("lp,pa->la", leg_params, shift_W)  # (4, 3)
            first_knots = _first_knot_indices()
            for a in range(3):
                leg_params = leg_params.at[:, first_knots[a]].set(shifted0[:, a])
            best_params = leg_params.reshape(P)

        # Substitute swing feet by their reference footholds.
        feet_eff = jnp.where(current_contact[:, None] == 0.0, ref_feet, feet)

        carry = (best_params, sampling_state.key, sampling_state.sigma)
        it = partial(_one_iteration, state12=state12, feet=feet_eff, ref12=ref12,
                     contact_seq=contact_seq)
        (best_params, key, sigma), (best_costs, all_costs) = jax.lax.scan(
            it, carry, None, length=sp.num_iterations
        )

        # First-step GRF from the final parameters (reference :707-746).
        grfs = _grf_step0(best_params, contact_seq, state12, feet_eff)

        predicted_state = integrate_euler(
            state12, feet_eff, grfs, contact_seq[:, 0], srbd, dts[0]
        )

        out = SolveOutput(
            grfs=grfs,
            footholds=jnp.zeros((4, 3), jnp.float32),
            predicted_state=predicted_state,
            best_parameters=best_params,
            best_cost=best_costs[-1],
            costs=all_costs[-1],
            sigma=sigma,
            best_freq=jnp.asarray(cfg.gait_params.step_freq, jnp.float32),
        )
        return out, SamplingState(best_params, key, sigma)

    def _first_knot_indices():
        if sp.parametrization == "zero_order":
            return [0, H, 2 * H]
        if sp.parametrization == "linear_spline":
            s1 = sp.num_splines + 1
            return [0, s1, 2 * s1]
        return [1, 5, 9]  # cubic: first interior knot of x/y/z in chunk 0

    return jax.jit(solve), P


class SamplingMPC:
    """Host-facing wrapper holding the device-side SamplingState.

    API mirrors the reference Sampling_MPC + SRBDControllerInterface usage:
    ``compute_control(state_dict, ref_dict, contact_seq, current, previous)``.
    """

    def __init__(self, cfg: Config, num_samples: int | None = None, method: str | None = None,
                 seed: int = 42):
        self.cfg = cfg
        self.solve, self.num_parameters = make_sampling_solver(cfg, num_samples, method)
        sp = cfg.mpc.sampling
        self.state = SamplingState(
            best_parameters=jnp.zeros(self.num_parameters, jnp.float32),
            key=jax.random.PRNGKey(seed),
            sigma=jnp.full(self.num_parameters, sp.sigma_cem_mppi, jnp.float32),
        )

    def compute_control(self, state_current: dict, ref_state: dict, contact_sequence,
                        current_contact, previous_contact):
        """state_current/ref_state use the reference's dict schema
        (wb_interface.py:152-166 and :275-291)."""
        state12 = jnp.asarray(
            np.concatenate([
                np.asarray(state_current["position"]).reshape(3),
                np.asarray(state_current["linear_velocity"]).reshape(3),
                np.asarray(state_current["orientation"]).reshape(3),
                np.asarray(state_current["angular_velocity"]).reshape(3),
            ]), jnp.float32)
        feet = jnp.asarray(np.stack([
            np.asarray(state_current[f"foot_{leg}"]).reshape(3) for leg in ("FL", "FR", "RL", "RR")
        ]), jnp.float32)
        ref12 = jnp.asarray(np.concatenate([
            np.asarray(ref_state["ref_position"]).reshape(3),
            np.asarray(ref_state["ref_linear_velocity"]).reshape(3),
            np.asarray(ref_state["ref_orientation"]).reshape(3),
            np.asarray(ref_state["ref_angular_velocity"]).reshape(3),
        ]), jnp.float32)
        ref_feet = jnp.asarray(np.stack([
            np.asarray(ref_state[f"ref_foot_{leg}"]).reshape(3) for leg in ("FL", "FR", "RL", "RR")
        ]), jnp.float32)

        out, self.state = self.solve(
            state12, feet, ref12, ref_feet,
            jnp.asarray(np.asarray(contact_sequence), jnp.float32),
            jnp.asarray(np.asarray(current_contact), jnp.float32),
            jnp.asarray(np.asarray(previous_contact), jnp.float32),
            self.state,
        )
        return out

    def reset(self):
        self.state = SamplingState(
            best_parameters=jnp.zeros_like(self.state.best_parameters),
            key=self.state.key,
            sigma=jnp.full_like(self.state.sigma, self.cfg.mpc.sampling.sigma_cem_mppi),
        )
