"""Gait-adaptive sampling MPC: step frequency optimized inside the rollout.

Re-design of the reference Sampling_MPC gait-adaptive variant
(controllers/sampling/centroidal_nmpc_jax_gait_adaptive.py): every sample draws a
candidate step frequency; its contact sequence is recomputed from the gait phase, the
per-leg spline phase advances only during stance (stance-step counters), and a
frequency-regularization term (f-1.3)^2*100 is added to the cost (:341-356, :500).
The best sample returns both GRF parameters and ``best_step_frequency`` (:688-705).

Batched formulation: the frequency candidates are few (config
step_freq_available, reference config.py:103), so instead of giving each of 10k
samples an independently-sampled frequency (reference draws with
jax.random.choice, :692), the sample batch is PARTITIONED into K equal groups, one
per candidate. Each group's contact sequence, stance counters and spline basis are
built in-trace as a dense (H*12, P) operator, so the group's force trajectories are
again a single GEMM and the SoA rollout (rollout.py) is reused unchanged. Noise is
i.i.d. across samples, so the deterministic partition is statistically equivalent to
the reference's random assignment.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...config import Config
from ...dynamics.srbd import make_params
from .rollout import ForceModelParams, apply_force_model_rows, rollout_costs_soa
from .sampling_mpc import (_COST_SATURATION, SamplingState, SolveOutput,
                           optimizer_update, sample_noise)
from .splines import num_params_per_leg


def _timer_sequence(phase, step_freq, duty, mpc_dt, horizon):
    """(4, H) contact sequence of the in-rollout gait timer.

    Matches PeriodicGaitGeneratorJax.compute_contact_sequence (reference
    helpers/periodic_gait_generator_jax.py:136-151) exactly, including its
    discard-overflow wrap (t >= 1 resets to 0, not t-1) and the advance BEFORE the
    first column. Runs once per frequency candidate, so an exact H-step scan is
    negligible next to the sample rollout.
    """
    def body(t, _):
        t = jnp.where(t >= 1.0, 0.0, t)
        t = t + mpc_dt * step_freq
        return t, (t < duty).astype(jnp.float32)

    _, cols = jax.lax.scan(body, phase, None, length=horizon)
    return cols.T  # (4, H)


def _traced_leg_basis(parametrization, counters, horizon_legs, H, S, P_leg):
    """Per-leg spline basis with data-dependent stance phase, built in-trace.

    Args:
        counters: (4, H) stance-step counter per leg/step (reference :345-356 —
            starts at -1, +1 on each stance step).
        horizon_legs: (4,) per-leg stance count + 1 (reference :347-350).

    Returns:
        (4, H, 3, P_leg) weights W with f_a(leg, n) = params_leg @ W[leg, n, a].
    """
    s = counters.astype(jnp.float32)  # (4, H) spline step argument
    hl = horizon_legs.astype(jnp.float32)[:, None]  # (4, 1)
    iota = jnp.arange(P_leg, dtype=jnp.int32)

    def onehot(idx):  # idx (4, H) int -> (4, H, P_leg)
        return (iota[None, None, :] == idx[:, :, None]).astype(jnp.float32)

    if parametrization == "zero_order":
        idx = jnp.clip(s.astype(jnp.int32), 0, H - 1)
        base = onehot(idx)  # weight for f_x at position idx
        W = jnp.stack(
            [base,
             onehot(idx + H),
             onehot(idx + 2 * H)], axis=2)
        return W

    # Chunk index from STATIC horizon boundaries (reference :187-189 uses
    # self.horizon, not the per-leg stance count).
    boundaries = jnp.linspace(0.0, float(H), S + 1)
    idx = jnp.sum((s[:, :, None] >= boundaries[None, None, :-1]).astype(jnp.int32),
                  axis=-1) - 1
    idx = jnp.clip(idx, 0, S - 1)
    q = s / (hl / S) - idx.astype(jnp.float32)

    if parametrization == "linear_spline":
        shift = S + 1
        w0 = (1.0 - q)[:, :, None] * onehot(idx)
        w1 = q[:, :, None] * onehot(idx + 1)
        per_axis = []
        for a in range(3):
            off = a * shift
            per_axis.append(
                (1.0 - q)[:, :, None] * onehot(idx + off) + q[:, :, None] * onehot(idx + 1 + off)
            )
        del w0, w1
        return jnp.stack(per_axis, axis=2)

    # cubic_spline (Catmull-Rom slopes, reference :204-257; stride 10 quirk kept).
    a_b = 2 * q**3 - 3 * q**2 + 1
    b_b = q**3 - 2 * q**2 + q
    c_b = -2 * q**3 + 3 * q**2
    d_b = q**3 - q**2
    si = 10 * idx
    per_axis = []
    for a in range(3):
        base = si + 4 * a
        w = (
            (-b_b / 2.0)[:, :, None] * onehot(base + 0)
            + (a_b - d_b / 2.0)[:, :, None] * onehot(base + 1)
            + (b_b / 2.0 + c_b)[:, :, None] * onehot(base + 2)
            + (d_b / 2.0)[:, :, None] * onehot(base + 3)
        )
        per_axis.append(w)
    return jnp.stack(per_axis, axis=2)


def make_gait_adaptive_solver(cfg: Config, num_samples: int | None = None,
                              method: str | None = None):
    """Build the jitted gait-adaptive solve.

    Returns ``solve(state12, feet, ref12, ref_feet, phase, nominal_freq,
    optimize_swing, contact_seq0, current_contact, previous_contact, state)
    -> (SolveOutput, SamplingState)``.
    """
    sp = cfg.mpc.sampling
    method = method or sp.method
    if method not in ("random_sampling", "mppi", "cem_mppi"):
        raise ValueError(f"unknown sampling method {method!r}")
    N = num_samples or sp.num_samples
    H = cfg.mpc.horizon
    S = sp.num_splines
    P_leg = num_params_per_leg(sp.parametrization, H, S)
    P = 4 * P_leg
    K = len(cfg.mpc.step_freq_available)
    Ng = N // K
    duty = cfg.gait_params.duty_factor
    mpc_dt = cfg.mpc.dt

    dts = cfg.mpc.dts()  # host numpy: embeds as a constant
    srbd = make_params(cfg)
    Qdiag = cfg.mpc.cost.as_vector()
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)
    freq_avail = np.asarray(cfg.mpc.step_freq_available, np.float32)

    def _group_costs(state12, feet, ref12, params_g, freq, phase):
        """Cost of one candidate-frequency group. params_g (P, Ng)."""
        seq = _timer_sequence(phase, freq, duty, mpc_dt, H)  # (4, H)
        counters = jnp.cumsum(seq, axis=1) - 1.0  # (4, H), starts at -1 + contact
        horizon_legs = jnp.sum(seq, axis=1) + 1.0  # (4,)
        Wleg = _traced_leg_basis(sp.parametrization, counters, horizon_legs, H, S, P_leg)

        leg_params = params_g.reshape(4, P_leg, Ng)
        # raw[leg, n, axis, sample] then step-major (H, 12, Ng).
        raw = jnp.einsum("lhap,lpn->lhan", Wleg, leg_params,
                         precision=jax.lax.Precision.HIGHEST)  # see spline_forces
        raw = jnp.moveaxis(raw, 0, 1).reshape(H, 12, Ng)

        n_stance = jnp.sum(seq, axis=0)
        share = srbd.mass * 9.81 / jnp.maximum(n_stance, 1.0)
        costs = rollout_costs_soa(state12, feet, ref12, raw, seq, share, dts, Qdiag,
                                  srbd, fm, _COST_SATURATION,
                                  zmp_weight=sp.zmp_weight,
                                  zmp_margin=sp.zmp_margin)
        # Frequency regularization (reference :500).
        costs = costs + (freq - 1.3) ** 2 * 100.0
        return costs

    def solve(state12, feet, ref12, ref_feet, phase, nominal_freq, optimize_swing,
              contact_seq0, current_contact, previous_contact, sstate: SamplingState):
        best_params = sstate.best_parameters
        liftoff_edge = (previous_contact == 1.0) & (current_contact == 0.0)
        best_params = best_params * jnp.repeat(~liftoff_edge, P_leg).astype(jnp.float32)

        feet_eff = jnp.where(current_contact[:, None] == 0.0, ref_feet, feet)

        key, sub = jax.random.split(sstate.key)
        noise = sample_noise(sp, method, sub, sstate.sigma, P, N)
        params_vec = best_params[:, None] + noise

        # Candidate frequencies: the available set when optimizing, else nominal
        # (reference :688-692).
        freqs = jnp.where(optimize_swing, freq_avail, jnp.full((K,), 1.0) * nominal_freq)

        group_costs = []
        for k in range(K):  # static loop over few candidates
            pg = jax.lax.dynamic_slice_in_dim(params_vec, k * Ng, Ng, axis=1)
            group_costs.append(_group_costs(state12, feet_eff, ref12, pg, freqs[k], phase))
        costs = jnp.concatenate(group_costs)  # (K*Ng,)

        best_idx = jnp.argmin(costs)
        best_cost = costs[best_idx]
        best_freq = freqs[best_idx // Ng]

        n_used = K * Ng
        new_params, new_sigma = optimizer_update(
            sp, method, best_params, params_vec[:, :n_used], noise[:, :n_used], costs,
            sstate.sigma)

        # First-step GRF under the CURRENT contact state (reference :705-760 uses the
        # host-provided contact sequence for extraction).
        leg_params = new_params.reshape(4, P_leg)
        w0 = _traced_leg_basis(sp.parametrization, jnp.zeros((4, 1)), jnp.ones((4,)),
                               H, S, P_leg)[:, 0]  # (4, 3, P_leg)
        raw0 = jnp.einsum("lap,lp->la", w0, leg_params).reshape(12)
        share0 = srbd.mass * 9.81 / jnp.maximum(jnp.sum(contact_seq0[:, 0]), 1.0)
        rows = apply_force_model_rows(raw0, contact_seq0[:, 0], share0, fm)
        grfs = jnp.stack(rows).reshape(4, 3)

        from ...dynamics.srbd import integrate_euler
        predicted_state = integrate_euler(state12, feet_eff, grfs, contact_seq0[:, 0],
                                          srbd, dts[0])

        out = SolveOutput(
            grfs=grfs,
            footholds=jnp.zeros((4, 3), jnp.float32),
            predicted_state=predicted_state,
            best_parameters=new_params,
            best_cost=best_cost,
            costs=costs,
            sigma=new_sigma,
            best_freq=best_freq,
        )
        return out, SamplingState(new_params, key, new_sigma)

    return jax.jit(solve), P


class GaitAdaptiveSamplingMPC:
    """Host wrapper; mirrors the reference usage through
    SRBDControllerInterface (srbd_controller_interface.py:118-180)."""

    def __init__(self, cfg: Config, num_samples: int | None = None,
                 method: str | None = None, seed: int = 42):
        self.cfg = cfg
        self.solve, self.num_parameters = make_gait_adaptive_solver(cfg, num_samples, method)
        self.state = SamplingState(
            best_parameters=jnp.zeros(self.num_parameters, jnp.float32),
            key=jax.random.PRNGKey(seed),
            sigma=jnp.full(self.num_parameters, cfg.mpc.sampling.sigma_cem_mppi, jnp.float32),
        )

    def compute_control(self, state_current: dict, ref_state: dict, contact_sequence,
                        current_contact, previous_contact, phase_signal,
                        nominal_step_frequency, optimize_swing):
        state12 = jnp.asarray(np.concatenate([
            np.asarray(state_current["position"]).reshape(3),
            np.asarray(state_current["linear_velocity"]).reshape(3),
            np.asarray(state_current["orientation"]).reshape(3),
            np.asarray(state_current["angular_velocity"]).reshape(3)]), jnp.float32)
        feet = jnp.asarray(np.stack([
            np.asarray(state_current[f"foot_{leg}"]).reshape(3)
            for leg in ("FL", "FR", "RL", "RR")]), jnp.float32)
        ref12 = jnp.asarray(np.concatenate([
            np.asarray(ref_state["ref_position"]).reshape(3),
            np.asarray(ref_state["ref_linear_velocity"]).reshape(3),
            np.asarray(ref_state["ref_orientation"]).reshape(3),
            np.asarray(ref_state["ref_angular_velocity"]).reshape(3)]), jnp.float32)
        ref_feet = jnp.asarray(np.stack([
            np.asarray(ref_state[f"ref_foot_{leg}"]).reshape(3)
            for leg in ("FL", "FR", "RL", "RR")]), jnp.float32)

        out, self.state = self.solve(
            state12, feet, ref12, ref_feet,
            jnp.asarray(np.asarray(phase_signal), jnp.float32),
            jnp.asarray(float(nominal_step_frequency), jnp.float32),
            jnp.asarray(bool(optimize_swing)),
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
