"""RTI-SQP gradient MPC on the condensed interior-point QP.

JAX replacement for the reference's acados pipeline
(Acados_NMPC_Nominal, controllers/gradient/nominal/centroidal_nmpc_nominal.py):
Gauss-Newton SQP on the shared SRB dynamics, with

* the real-time-iteration split (prepare = linearize + condense at the predicted
  state; feedback = refresh the gradient with the measured x0 and run the IP solve) —
  mirroring acados' rti_phase 1/2 (reference srbd_controller_interface.py:242-245,
  centroidal_nmpc_nominal.py:1442-1452);
* gravity-share z-force references per stance leg (:1195-1210);
* per-stage foot positions advanced at in-horizon touch-downs (:1165-1235), built by
  ocp.build_feet_trajectory;
* solver-failure fallback: non-finite solutions reuse the previous GRF (:1654-1685);
* batched gait candidates by vmapping the whole solve over contact sequences
  (replacing AcadosOcpBatchSolver, centroidal_nmpc_gait_adaptive.py:56-71), with the
  frequency-deviation penalty cost + 3*(f_n - f_0)^2 (:1230-1242);
* optional integral action on (z, vx, vy, vz, roll, pitch) mirroring the reference's
  integrator states (config use_integrators, centroidal_nmpc_nominal.py integral
  states; applied here as reference offsets with the same alpha and caps).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ...config import Config
from ...dynamics.srbd import make_params
from .ocp import (
    OCPDims,
    build_feet_trajectory,
    condense,
    friction_cone_rows,
    linearize_dynamics,
    q_diag_gradient,
    r_diag_gradient,
    rollout_nominal,
)
from .qp import pdip_solve, pdip_solve_mehrotra


class RTISolution(NamedTuple):
    U: jnp.ndarray  # (H, nu) optimal GRF sequence
    grfs: jnp.ndarray  # (4, 3) first-stage GRFs
    predicted_state: jnp.ndarray  # (12,) state after the first stage
    cost: jnp.ndarray  # nonlinear objective of the returned trajectory
    qp_gap: jnp.ndarray
    qp_primal_res: jnp.ndarray


class PrepState(NamedTuple):
    """Products of the RTI preparation phase (linearize + condense + Hessian),
    computed at the PREDICTED state before the measurement arrives — the acados
    rti_phase=1 equivalent (reference srbd_controller_interface.py:242-245)."""

    xbar: jnp.ndarray  # (H+1, nx) nominal rollout at the predicted state
    Ubar: jnp.ndarray  # (H, nu) inputs the linearization was taken at
    Fm: jnp.ndarray  # (H, nx, nx) prediction operator for the dx0 term
    Gt: jnp.ndarray  # (H*nu, H*nx) transposed input-prediction operator
    Hm: jnp.ndarray  # (H*nu, H*nu) condensed Gauss-Newton Hessian


def build_stage_wrench(cfg: Config, external_wrenches, H: int) -> np.ndarray:
    """Per-stage (H, 6) compensated wrench: the estimate is applied only to the
    first external_wrenches_compensation_num_step stages — a disturbance estimated
    NOW need not persist over the whole horizon (reference
    centroidal_nmpc_input_rates.py:1360-1373 and the collaborative/kinodynamic
    twins; config.py:159)."""
    gp = cfg.mpc.gradient
    if external_wrenches is None or not gp.external_wrenches_compensation:
        return np.zeros((H, 6), np.float32)
    w6 = np.asarray(external_wrenches, np.float32).reshape(6)
    mask = (np.arange(H) < gp.external_wrenches_compensation_num_step)[:, None]
    return (w6[None, :] * mask).astype(np.float32)


def _qp_iters(gp) -> int:
    return {"balance": gp.qp_iters, "robust": gp.qp_iters + 6,
            "speed": gp.qp_iters_speed, "crazy_speed": gp.qp_iters_crazy_speed}[gp.solver_mode]


def qp_solver_for(gp):
    """(solver_fn, iters) for the configured QP algorithm + mode.

    Mehrotra predictor-corrector (default, the HPIPM-style IPM) reaches the
    basic solver's accuracy in ~half the factorizations. Its 'balance' budget
    of 14 iterations is the knee of the f64 ladder (tests/test_f64_ladder.py:
    20 real tick QPs vs a machine-precision f64 solve, bound 0.6 N) on both
    the CPU backend and an H100: at 10 iterations the worst tick reads 3.5 N
    on the CPU and 3.2 N on the GPU, at 8 about 12 N on both. 'robust' adds 4;
    'speed'/'crazy_speed' are fixed caps."""
    if gp.qp_algorithm == "mehrotra":
        iters = {"balance": 14, "robust": 18, "speed": 6, "crazy_speed": 4}[gp.solver_mode]
        return pdip_solve_mehrotra, iters
    return pdip_solve, _qp_iters(gp)


def make_rti_solver(cfg: Config, integrator: str = "euler"):
    """Build the jitted solve. Returns ``solve(x0, feet_traj, contact_seq, Xref,
    Uref, U_warm) -> RTISolution`` plus the dims."""
    solve, _, _, dims = make_rti_solver_split(cfg, integrator)
    return solve, dims


def make_rti_solver_split(cfg: Config, integrator: str = "euler",
                          return_assembler: bool = False):
    """Full RTI machinery: ``(solve, prepare, feedback, dims)``.

    With ``return_assembler=True`` a fifth element is returned:
    ``assemble_qp(x0, feet_traj, contact_seq, Xref, Uref, U_warm) ->
    (Hm, g, C, d)`` — the EXACT dense condensed QP the production feedback phase
    hands to the interior point (min 0.5 z'Hz + g'z s.t. Cz <= d, with
    U = U_warm + z.reshape(H, nu)). This is the seam for the f64 verification
    ladder (tests/test_f64_ladder.py): re-solving these matrices with a
    high-accuracy f64 solver quantifies the production fixed-iteration f32 gap
    (BASELINE.md's <=1e-3 acados-parity bar).

    * ``solve(x0, feet_traj, contact_seq, Xref, Uref, U_warm, wrench, srbd_rt)``
      — the one-shot SQP/RTI solve (linearize + condense + IP per iteration).
    * ``prepare(x_pred, feet_traj, contact_seq, Xref, Uref, U_warm, wrench,
      srbd_rt) -> PrepState`` — acados rti_phase=1: linearize + condense + build
      the Hessian at the PREDICTED state (plus the AS-RTI extra iterations,
      arXiv:2403.07101); dispatched asynchronously, it overlaps the plant step.
    * ``feedback(prep, x0, feet_traj, contact_seq, Xref, Uref, wrench, srbd_rt)``
      — acados rti_phase=2: refresh the gradient with the MEASURED x0 (the dx0
      term rides the prediction operator F, so the stale linearization is exact
      to first order) + fresh contact bounds, then one IP solve. This is the
      latency-critical path: it skips the 24 jacfwds, the condensing and the
      Hessian build (reference centroidal_nmpc_nominal.py:1442-1452).
    """
    dims = OCPDims(horizon=cfg.mpc.horizon)
    H, nx, nu = dims.horizon, dims.nx, dims.nu
    gp = cfg.mpc.gradient
    srbd = make_params(cfg)
    # Host numpy constants (embed directly into the lowered program).
    dts = cfg.mpc.dts()
    q_diag = q_diag_gradient()
    r_diag = r_diag_gradient(cfg.robot.name)
    C_single = np.asarray(
        jax.device_get(friction_cone_rows(cfg.mpc.mu, cfg.mpc.grf_min, cfg.mpc.grf_max,
                                          jnp.ones((4, H)), dims)[0][0]))
    C_big = np.kron(np.eye(H, dtype=np.float32), C_single)  # (24H, 12H), host numpy
    qp_fn, iters = qp_solver_for(gp)
    lm = gp.levenberg_marquardt
    # RTI: one GN iteration per tick; AS-RTI-A..D add as_rti_iter extra iterations
    # (the reference runs those as approximate solves in acados' preparation phase,
    # arXiv:2403.07101; with a ~1 ms fused solve they run synchronously here).
    if gp.use_RTI:
        extra = gp.as_rti_iter if gp.as_rti_type != "Standard" else 0
        sqp_iters = 1 + max(0, extra)
    else:
        sqp_iters = max(1, gp.num_qp_iterations)

    def _stage_d(contact_seq):
        _, d = friction_cone_rows(cfg.mpc.mu, cfg.mpc.grf_min, cfg.mpc.grf_max,
                                  contact_seq, dims,
                                  stance_min_force=gp.stance_min_force)
        return d.reshape(-1)  # (24H,)

    def _objective(x0, U, feet_traj, contact_seq, Xref, Uref, wrench, p):
        xs = rollout_nominal(x0, U, feet_traj, contact_seq, p, dts, integrator,
                             wrench)
        ex = xs[1:] - Xref
        eu = U - Uref
        return jnp.sum(ex * ex * q_diag) + jnp.sum(eu * eu * r_diag)

    Qw = jnp.tile(jnp.asarray(q_diag), (H,))
    Rw = jnp.tile(jnp.asarray(r_diag), (H,))

    def _linearize_condense(x_lin, Ubar, feet_traj, contact_seq, wrench, p):
        """Preparation-phase work: rollout + Jacobians + condensing + Hessian."""
        xbar = rollout_nominal(x_lin, Ubar, feet_traj, contact_seq, p, dts,
                               integrator, wrench)
        lin = linearize_dynamics(xbar, Ubar, feet_traj, contact_seq, p, dts,
                                 integrator, wrench)
        Fm, Gm = condense(lin, dims)
        Gt = Gm.transpose(1, 3, 0, 2).reshape(H * nu, H * nx)
        Hm = (Gt * Qw[None, :]) @ Gt.T + jnp.diag(Rw) + lm * jnp.eye(H * nu)
        return PrepState(xbar, Ubar, Fm, Gt, Hm)

    def _feedback_step(prep: PrepState, x0, contact_seq, Xref, Uref):
        """Feedback-phase work: gradient refresh at the measured x0 + IP solve.
        The measurement enters through dx0 = x0 - xbar[0] riding the prediction
        operator F (the initial-state 'constraint' of the condensed QP)."""
        dx0 = x0 - prep.xbar[0]
        e = prep.xbar[1:] + jnp.einsum("kij,j->ki", prep.Fm, dx0) - Xref  # (H, nx)
        g = prep.Gt @ (Qw * e.reshape(-1)) + Rw * (prep.Ubar - Uref).reshape(-1)
        d_shift = _stage_d(contact_seq) - C_big @ prep.Ubar.reshape(-1)
        sol = qp_fn(prep.Hm, g, C_big, d_shift, iters=iters)
        return prep.Ubar + sol.z.reshape(H, nu), sol

    def solve(x0, feet_traj, contact_seq, Xref, Uref, U_warm, ext_wrench=None,
              srbd_rt=None):
        # srbd_rt: optional runtime SRBDParams (use_inertia_recomputation — the
        # reference feeds mass/inertia as per-stage OCP parameters,
        # centroidal_nmpc_nominal.py:1297-1330). None compiles the static params in.
        p = srbd if srbd_rt is None else srbd_rt
        wrench = jnp.zeros(6) if ext_wrench is None else ext_wrench
        U = U_warm
        for _ in range(sqp_iters):  # static small loop
            prep = _linearize_condense(x0, U, feet_traj, contact_seq, wrench, p)
            U, sol = _feedback_step(prep, x0, contact_seq, Xref, Uref)
        cost = _objective(x0, U, feet_traj, contact_seq, Xref, Uref, wrench, p)
        xs = rollout_nominal(x0, U, feet_traj, contact_seq, p, dts, integrator,
                             wrench)
        grfs = U[0].reshape(4, 3)
        return RTISolution(U, grfs, xs[1], cost, sol.gap, sol.primal_res)

    def prepare(x_pred, feet_traj, contact_seq, Xref, Uref, U_warm, ext_wrench=None,
                srbd_rt=None):
        p = srbd if srbd_rt is None else srbd_rt
        wrench = jnp.zeros(6) if ext_wrench is None else ext_wrench
        U = U_warm
        # AS-RTI-A..D: extra approximate iterations belong to the preparation
        # phase (they refine the linearization point, arXiv:2403.07101).
        for _ in range(max(0, sqp_iters - 1)):
            prep = _linearize_condense(x_pred, U, feet_traj, contact_seq, wrench, p)
            U, _ = _feedback_step(prep, x_pred, contact_seq, Xref, Uref)
        return _linearize_condense(x_pred, U, feet_traj, contact_seq, wrench, p)

    def feedback(prep: PrepState, x0, feet_traj, contact_seq, Xref, Uref,
                 ext_wrench=None, srbd_rt=None):
        p = srbd if srbd_rt is None else srbd_rt
        wrench = jnp.zeros(6) if ext_wrench is None else ext_wrench
        U, sol = _feedback_step(prep, x0, contact_seq, Xref, Uref)
        cost = _objective(x0, U, feet_traj, contact_seq, Xref, Uref, wrench, p)
        xs = rollout_nominal(x0, U, feet_traj, contact_seq, p, dts, integrator,
                             wrench)
        return RTISolution(U, U[0].reshape(4, 3), xs[1], cost, sol.gap,
                           sol.primal_res)

    if not return_assembler:
        return jax.jit(solve), jax.jit(prepare), jax.jit(feedback), dims

    def assemble_qp(x0, feet_traj, contact_seq, Xref, Uref, U_warm):
        prep = _linearize_condense(x0, U_warm, feet_traj, contact_seq,
                                   jnp.zeros((H, 6)), srbd)
        dx0 = x0 - prep.xbar[0]
        e = prep.xbar[1:] + jnp.einsum("kij,j->ki", prep.Fm, dx0) - Xref
        g = prep.Gt @ (Qw * e.reshape(-1)) + Rw * (U_warm - Uref).reshape(-1)
        d_shift = _stage_d(contact_seq) - C_big @ U_warm.reshape(-1)
        return prep.Hm, g, jnp.asarray(C_big), d_shift

    return jax.jit(solve), jax.jit(prepare), jax.jit(feedback), dims, \
        jax.jit(assemble_qp)


class GradientMPC:
    """Host-facing nominal gradient MPC (counterpart of Acados_NMPC_Nominal).

    ``compute_control`` takes the same state/reference dict schema as the reference
    (wb_interface.py:152-166, :275-291) and returns first-stage GRFs + footholds +
    the one-step predicted state, with warm starting, integral action and
    failure fallback.
    """

    def __init__(self, cfg: Config, integrator: str = "euler"):
        self.cfg = cfg
        self.prepare = self.feedback = None
        if cfg.mpc.gradient.use_DDP:
            # DDP nlp-solver option (reference config.py use_DDP): Riccati backward
            # pass + projected forward rollout instead of the condensed IP QP.
            from .ddp import make_ddp_solver
            self.solve, self.dims = make_ddp_solver(cfg, integrator)
        else:
            self.solve, self.prepare, self.feedback, self.dims = \
                make_rti_solver_split(cfg, integrator)
        H = self.dims.horizon
        self.U_warm = np.zeros((H, 12), np.float32)
        self.previous_grfs = np.zeros((4, 3), np.float32)
        self.integral = np.zeros(6, np.float32)
        self._prev_ok = False
        # RTI split state: _prep holds the device-side PrepState dispatched by
        # compute_rti_prepare (never blocked on); _last holds the tick inputs the
        # preparation linearizes against.
        self._prep = None
        self._last = None

    # -- reference assembly -------------------------------------------------
    def _build_refs(self, state, reference, contact_seq, commit_integral=True):
        cfg = self.cfg
        H = self.dims.horizon
        xref1 = np.concatenate([
            np.asarray(reference["ref_position"]).reshape(3),
            np.asarray(reference["ref_linear_velocity"]).reshape(3),
            np.asarray(reference["ref_orientation"]).reshape(3),
            np.asarray(reference["ref_angular_velocity"]).reshape(3)]).astype(np.float32)

        if cfg.mpc.gradient.use_integrators:
            # Integral action with the reference's alpha and caps
            # (config.py:111-113): accumulate tracking error on
            # (z, vx, vy, vz, roll, pitch) and bias the reference.
            # commit_integral=False leaves the stored integral untouched — the
            # batched gait optimizer evaluates K candidates per tick and must not
            # accumulate K times (the integral advances once, in compute_control).
            x_now = np.concatenate([
                np.asarray(state["position"]).reshape(3),
                np.asarray(state["linear_velocity"]).reshape(3),
                np.asarray(state["orientation"]).reshape(3),
                np.asarray(state["angular_velocity"]).reshape(3)])
            err = x_now - xref1
            sel = np.array([2, 3, 4, 5, 6, 7])
            alpha = cfg.mpc.gradient.alpha_integrator
            cap = np.asarray(cfg.mpc.gradient.integrator_cap)
            integral = np.clip(self.integral + err[sel] * alpha, -cap, cap)
            if commit_integral:
                self.integral = integral
            xref1 = xref1.copy()
            xref1[sel] -= integral

        Xref = np.tile(xref1, (H, 1))
        # Gravity-share z-force reference per stage (reference :1195-1210).
        seq = np.asarray(contact_seq, np.float32)
        n_st = np.maximum(seq.sum(axis=0), 1.0)
        share = cfg.robot.mass * cfg.gravity / n_st  # (H,)
        Uref = np.zeros((H, 12), np.float32)
        for leg in range(4):
            Uref[:, leg * 3 + 2] = share * seq[leg]
        # numpy out: jit converts all call arguments in one dispatch; pre-converting
        # with jnp.asarray would pay one host->device transfer per array.
        return Xref, Uref

    def _build_inputs(self, state, reference, contact_seq):
        feet_now = np.stack([np.asarray(state[f"foot_{leg}"]).reshape(3)
                             for leg in ("FL", "FR", "RL", "RR")])
        ref_feet = np.stack([np.asarray(reference[f"ref_foot_{leg}"]).reshape(-1, 3)
                             for leg in ("FL", "FR", "RL", "RR")])
        feet_traj = build_feet_trajectory(feet_now, ref_feet, contact_seq,
                                          self.dims.horizon)
        x0 = np.concatenate([
            np.asarray(state["position"]).reshape(3),
            np.asarray(state["linear_velocity"]).reshape(3),
            np.asarray(state["orientation"]).reshape(3),
            np.asarray(state["angular_velocity"]).reshape(3)]).astype(np.float32)
        return x0, np.asarray(feet_traj, np.float32)

    # -- main entry ---------------------------------------------------------
    def compute_control(self, state, reference, contact_sequence, constraint=None,
                        external_wrenches=None, inertia=None, mass=None):
        seq = np.asarray(contact_sequence, np.float32)[:, : self.dims.horizon]
        x0, feet_traj = self._build_inputs(state, reference, seq)
        Xref, Uref = self._build_refs(state, reference, seq)
        wrench = build_stage_wrench(self.cfg, external_wrenches, self.dims.horizon)
        # Fresh warm starts seed from the gravity-share reference: at f = 0 the SRB
        # torque balance has zero force/foothold sensitivity, which starves the first
        # Gauss-Newton step (the reference warm-starts analogously, :1048-1113).
        U_ws = Uref if not np.any(self.U_warm) else self.U_warm
        srbd_rt = None
        if inertia is not None or mass is not None:
            # Runtime inertia/mass (use_inertia_recomputation): recomputed whole-body
            # tensor from the sim/estimator replaces the static trunk values.
            from ...dynamics.srbd import SRBDParams, make_params

            base = make_params(self.cfg)
            I_rt = np.asarray(inertia, np.float32) if inertia is not None else base.inertia
            srbd_rt = SRBDParams(
                mass=np.asarray(mass if mass is not None else base.mass, np.float32),
                inertia=I_rt,
                inertia_inv=np.linalg.inv(I_rt).astype(np.float32),
                gravity=base.gravity)
        # One batched fetch for the whole solution (per-field np.asarray would pay
        # one device round trip each).
        if self._prep is not None:
            # RTI feedback phase: reuse the preparation's linearization; the
            # measured x0 and the FRESH contact bounds/references enter here
            # (acados rti_phase=2, reference centroidal_nmpc_nominal.py:1442-1452).
            out = jax.device_get(self.feedback(self._prep, x0, feet_traj, seq,
                                               Xref, Uref, wrench, srbd_rt))
            self._prep = None
        else:
            out = jax.device_get(self.solve(x0, feet_traj, seq, Xref, Uref, U_ws,
                                            wrench, srbd_rt))
        U = np.asarray(out.U)
        if not np.all(np.isfinite(U)):
            # Failure fallback (reference :1654-1685): previous GRFs, reset warm start.
            grfs = self.previous_grfs
            self.U_warm[:] = 0.0
            status = 1
            predicted = x0
            self._last = None  # never prepare against a failed iterate
        else:
            grfs = np.asarray(out.grfs) * seq[:, 0:1]
            self.previous_grfs = grfs.copy()
            # Shift warm start one stage (RTI-style).
            self.U_warm = np.concatenate([U[1:], U[-1:]], axis=0)
            status = 0
            predicted = np.asarray(out.predicted_state)
            self._last = (feet_traj, seq, Xref, Uref, wrench, srbd_rt,
                          predicted.astype(np.float32))

        # First touch-down foothold per leg (the position feet hold after their first
        # in-horizon touch-down; equals current position if no touch-down occurs).
        td = np.asarray(feet_traj)
        fh = np.empty((4, 3), np.float32)
        for leg in range(4):
            fh[leg] = td[-1, leg]
            for k in range(1, self.dims.horizon):
                if seq[leg, k] == 1 and seq[leg, k - 1] == 0:
                    fh[leg] = td[k, leg]
                    break
        return grfs, fh, predicted, status, float(out.cost)

    def compute_rti_prepare(self, *args, **kwargs):
        """RTI preparation phase (acados rti_phase=1, reference
        srbd_controller_interface.py:242-245): linearize + condense + build the
        Hessian at the PREDICTED next state, using the just-shifted warm start.
        The jitted call is dispatched asynchronously (JAX returns device futures)
        so it overlaps the plant step / whole-body control; the next
        compute_control consumes it in the cheap feedback phase."""
        if self.prepare is None or not self.cfg.mpc.gradient.use_RTI \
                or self._last is None:
            return None
        feet_traj, seq, Xref, Uref, wrench, srbd_rt, predicted = self._last
        self._prep = self.prepare(predicted, feet_traj, seq, Xref, Uref,
                                  self.U_warm, wrench, srbd_rt)  # not blocked on
        return self._prep

    def reset(self):
        # Rebind (never zero in place): returned arrays may alias these.
        self.U_warm = np.zeros_like(self.U_warm)
        self.integral = np.zeros_like(self.integral)
        self.previous_grfs = np.zeros_like(self.previous_grfs)
        self._prep = None
        self._last = None


class BatchedGradientMPC:
    """Gait-adaptive batch: one vmapped solve over candidate step frequencies
    (counterpart of Acados_NMPC_GaitAdaptive + SRBDBatchedControllerInterface,
    srbd_batched_controller_interface.py:32-80)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.inner = GradientMPC(cfg)
        solve = self.inner.solve
        self.vsolve = jax.jit(jax.vmap(solve, in_axes=(None, 0, 0, None, 0, None)))

    def optimize_gait(self, state, reference, contact_sequences):
        """contact_sequences: (K, 4, H) one per candidate frequency. Returns
        (costs, best_freq)."""
        cfg = self.cfg
        K = len(cfg.mpc.step_freq_available)
        seqs = np.asarray(contact_sequences, np.float32)[:, :, : self.inner.dims.horizon]
        feet, xrefs, urefs = [], [], []
        for k in range(K):
            x0, ft = self.inner._build_inputs(state, reference, seqs[k])
            # commit_integral=False: candidate evaluation must be side-effect-free
            # on the integral state (otherwise it accumulates K x per tick).
            Xref, Uref = self.inner._build_refs(state, reference, seqs[k],
                                                commit_integral=False)
            feet.append(ft); xrefs.append(Xref); urefs.append(Uref)
        out = self.vsolve(x0, jnp.stack(feet), jnp.asarray(seqs), xrefs[0],
                          jnp.stack(urefs), jnp.asarray(self.inner.U_warm))
        costs = np.array(out.cost)
        f0 = cfg.mpc.step_freq_available[0]
        for k in range(1, K):
            costs[k] += 3 * (cfg.mpc.step_freq_available[k] - f0) ** 2
        best = int(np.argmin(costs))
        return costs, cfg.mpc.step_freq_available[best]
