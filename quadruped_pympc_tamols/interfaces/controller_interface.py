"""MPC controller dispatch layer.

Counterpart of the reference SRBDControllerInterface
(interfaces/srbd_controller_interface.py:27-245): selects the controller family from
config, normalizes its outputs, and masks the returned GRFs by the CURRENT contact
(:225-230). The sampling path runs its iterations inside one jit (no per-iteration
host loop as in the reference :118-180); the gradient path exposes the RTI
prepare/feedback split.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..utils.legs import Legs


def recenter_state_and_reference(state_current: dict, ref_state: dict):
    """Shift the world so the base is at xy=0 (reference perform_scaling,
    centroidal_nmpc_nominal.py:1116-1135): float32 solvers lose torque-arm
    precision at O(100 m) absolute coordinates. Returns (state, ref, shift);
    position-valued OUTPUTS must add ``shift`` back."""
    shift = np.zeros(3)
    shift[:2] = np.asarray(state_current["position"], np.float64).reshape(3)[:2]
    state_current = dict(state_current)
    ref_state = dict(ref_state)
    for k in ("position", "foot_FL", "foot_FR", "foot_RL", "foot_RR"):
        state_current[k] = np.asarray(state_current[k], np.float64).reshape(3) - shift
    for k in ("ref_position", "ref_foot_FL", "ref_foot_FR", "ref_foot_RL",
              "ref_foot_RR"):
        ref_state[k] = np.asarray(ref_state[k], np.float64).reshape(-1, 3) - shift
    ref_state["ref_position"] = ref_state["ref_position"].reshape(3)
    return state_current, ref_state, shift


class SRBDControllerInterface:
    def __init__(self, cfg: Config, seed: int = 42):
        self.cfg = cfg
        self.type = cfg.mpc.type
        self.best_sample_freq = cfg.gait_params.step_freq

        if self.type == "sampling":
            if cfg.mpc.optimize_step_freq:
                from ..controllers.sampling.gait_adaptive import GaitAdaptiveSamplingMPC
                self.controller = GaitAdaptiveSamplingMPC(cfg, seed=seed)
            else:
                from ..controllers.sampling.sampling_mpc import SamplingMPC
                self.controller = SamplingMPC(cfg, seed=seed)
        elif self.type == "nominal":
            if (cfg.mpc.gradient.use_static_stability
                    or cfg.mpc.gradient.use_zmp_stability
                    or cfg.mpc.gradient.use_foothold_optimization):
                from ..controllers.gradient.variants import VariantGradientMPC
                self.controller = VariantGradientMPC(cfg, "nominal")
            else:
                from ..controllers.gradient.sqp import GradientMPC
                self.controller = GradientMPC(cfg)
        elif self.type in ("input_rates", "lyapunov", "collaborative", "kinodynamic"):
            from ..controllers.gradient.variants import VariantGradientMPC
            self.controller = VariantGradientMPC(cfg, self.type)
        else:
            raise ValueError(f"unsupported mpc type {self.type!r}")
        # Only the nominal RTI solver consumes runtime inertia; callers use this to
        # skip computing the composite tensor entirely (it's a Python loop over all
        # MuJoCo bodies).
        self.consumes_inertia = type(self.controller).__name__ == "GradientMPC"

    def compute_control(self, state_current: dict, ref_state: dict, contact_sequence,
                        inertia=None, mass=None, external_wrenches=None,
                        current_contact=None, previous_contact=None,
                        phase_signal=None, optimize_swing: int = 0):
        """Returns (nmpc_GRFs: Legs, nmpc_footholds: Legs, best_sample_freq,
        nmpc_predicted_state)."""
        cur = np.asarray(current_contact if current_contact is not None
                         else contact_sequence[:, 0], np.float32)
        prev = np.asarray(previous_contact if previous_contact is not None else cur,
                          np.float32)

        state_current, ref_state, shift = recenter_state_and_reference(
            state_current, ref_state)

        if self.type == "sampling":
            import jax

            if self.cfg.mpc.optimize_step_freq:
                out = self.controller.compute_control(
                    state_current, ref_state, contact_sequence, cur, prev,
                    phase_signal if phase_signal is not None else np.zeros(4),
                    self.best_sample_freq, optimize_swing)
            else:
                out = self.controller.compute_control(
                    state_current, ref_state, contact_sequence, cur, prev)
            if self.cfg.mpc.sampling.pipelined:
                # Async pipelining (config sampling.pipelined): hand back the
                # PREVIOUS tick's solution (its futures have completed during the
                # plant step) and leave this tick's solve in flight. The warm
                # start / PRNG state on device already advanced correctly —
                # only the host-visible result is one tick stale.
                prev_out = getattr(self, "_inflight", None)
                self._inflight = out
                if prev_out is not None:
                    out = prev_out
            out = jax.device_get(out)  # one batched fetch of every field
            if self.cfg.mpc.optimize_step_freq and optimize_swing:
                self.best_sample_freq = float(out.best_freq)
            grfs = np.asarray(out.grfs)
            footholds = np.stack([
                np.asarray(ref_state[f"ref_foot_{leg}"]).reshape(3)
                for leg in ("FL", "FR", "RL", "RR")])
            predicted = np.asarray(out.predicted_state)
        else:
            # Runtime inertia (use_inertia_recomputation) is supported by the nominal
            # RTI solver; the augmented-state variants keep static params. A callable
            # is evaluated lazily here, only when actually consumed.
            extra = {}
            if inertia is not None and self.consumes_inertia:
                extra = dict(inertia=inertia() if callable(inertia) else inertia,
                             mass=mass)
            grfs, footholds, predicted, status, cost = self.controller.compute_control(
                state_current, ref_state, contact_sequence,
                external_wrenches=external_wrenches, **extra)
            # Kinodynamic variant: joint trajectories consumed directly by the
            # whole-body layer (reference srbd_controller_interface.py:184-207).
            self.nmpc_joints_pos = getattr(self.controller, "nmpc_joints_pos", None)
            self.nmpc_joints_vel = getattr(self.controller, "nmpc_joints_vel", None)

        # Mask by current contact (reference srbd_controller_interface.py:225-230).
        grfs = grfs * cur[:, None]
        # Undo the recentering on position-valued outputs (GRFs are invariant).
        footholds = np.asarray(footholds, np.float64) + shift
        predicted = np.asarray(predicted, np.float64).copy()
        predicted[:3] = predicted[:3] + shift
        return Legs(grfs), Legs(footholds), self.best_sample_freq, predicted

    def compute_rti(self):
        """RTI preparation phase (reference :242-245). The sampling solver is one
        fused device call, so preparation reduces to the warm-start shift done
        post-solve."""
        if hasattr(self.controller, "compute_rti_prepare"):
            self.controller.compute_rti_prepare()

    def reset(self):
        self.controller.reset()
        self.best_sample_freq = self.cfg.gait_params.step_freq
        self._inflight = None


class SRBDBatchedControllerInterface:
    """Batched gait-frequency optimization (counterpart of
    interfaces/srbd_batched_controller_interface.py:32-80)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        from ..controllers.gradient.sqp import BatchedGradientMPC
        self.controller = BatchedGradientMPC(cfg)

    def optimize_gait(self, state_current: dict, ref_state: dict, pgg_phase_signal,
                      pgg_duty_factor):
        """Builds one contact sequence per candidate step frequency from the current
        gait phase (reference :64-76) and returns the best frequency."""
        import jax.numpy as jnp

        from ..gait.periodic import contact_sequence, make_timer_dts

        # Same float32 recentering as the main solve; only the best FREQUENCY is
        # returned, so there is nothing to shift back.
        state_current, ref_state, _ = recenter_state_and_reference(
            state_current, ref_state)

        t_off = make_timer_dts(self.cfg.mpc)
        freqs = jnp.asarray(self.cfg.mpc.step_freq_available)
        phase = jnp.tile(jnp.asarray(pgg_phase_signal, jnp.float32), (len(freqs), 1))
        seqs = contact_sequence(phase, freqs, pgg_duty_factor, jnp.asarray(t_off))
        costs, best = self.controller.optimize_gait(state_current, ref_state,
                                                    np.asarray(seqs))
        return best
