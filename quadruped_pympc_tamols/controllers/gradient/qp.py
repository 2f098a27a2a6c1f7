"""Dense primal-dual interior-point QP solver, fixed iteration count, batched.

JAX replacement for HPIPM (the reference's QP engine,
centroidal_nmpc_nominal.py:202, :242-251): the condensed QP's dense Hessian
(N*nu = 144 square) is factorized with one Cholesky per IP iteration; a
fixed iteration budget mirrors HPIPM's mode caps (10 for 'speed', 5 for
'crazy_speed'). Everything is jnp with static shapes, so the solver vmaps over gait
candidates (replacing AcadosOcpBatchSolver's OpenMP threads,
centroidal_nmpc_gait_adaptive.py:56-71) and over scenarios across chips.

Problem form:  min 0.5 z^T H z + g^T z   s.t.  C z <= d.
Infeasible-start primal-dual path following with slack variables:
  C z + s = d,  s > 0,  lam > 0,  s o lam -> 0.

Every product runs at full float32 precision (``_mm``): under the GPU's
default TF32 matmuls the residuals and KKT matrix lose digits, and the f64
ladder (tests/test_f64_ladder.py) measured a 1.35 N worst first-stage GRF
error on an H100 at 14 iterations, against 0.001 N at full precision.
"""
from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp

_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
_dot = partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)


class QPSolution(NamedTuple):
    z: jnp.ndarray
    lam: jnp.ndarray
    s: jnp.ndarray
    gap: jnp.ndarray  # final complementarity mu
    primal_res: jnp.ndarray  # max(C z - d, 0) infinity norm


def pdip_solve(Hm, g, C, d, iters: int = 18, reg: float = 1e-7, sigma: float = 0.2,
               z0=None, mu_floor: float = 1e-4, sl_min: float = 1e-6, lam0=None,
               w_cap: float = 1e4):
    """Solve one dense QP. Shapes: Hm (n, n), g (n,), C (m, n), d (m,).

    Fixed ``iters`` Newton steps on the perturbed KKT system with fraction-to-boundary
    step sizes; returns the final iterate (no early exit — static control flow for
    XLA). Float32-safe: the barrier target is floored at ``mu_floor`` and slack/dual
    magnitudes at ``sl_min`` so the iteration stays finite once converged (a raw IP
    collapses below f32 precision after ~11 iterations). For batches, vmap this
    function.
    """
    n = g.shape[0]
    m = d.shape[0]

    z = jnp.zeros(n) if z0 is None else z0
    # Strictly positive initialization. lam0 lets callers start rows whose optimal
    # multiplier is far from 1 (e.g. slack-penalty rows at zl ~ 1e3) on-scale; a
    # uniform start needs the whole iteration budget just to traverse the scale gap.
    s = jnp.maximum(d - _mm(C, z), 1.0)
    lam = jnp.ones(m) if lam0 is None else lam0

    I = jnp.eye(n) * reg

    def body(carry, _):
        z, lam, s = carry
        r_d = _mm(Hm, z) + g + _mm(C.T, lam)
        r_p = _mm(C, z) + s - d
        mu = _dot(lam, s) / m
        r_c = lam * s - sigma * jnp.maximum(mu, mu_floor)

        s_safe = jnp.maximum(s, sl_min)
        # Clamp the active-constraint stiffness: keeps K's conditioning within f32
        # Cholesky range (unbounded lam/s produces NaN pivots once converged,
        # and caps >1e4 measurably destabilize the plain-QP iteration itself).
        # Soft-slacked problems NEED w up to ~1e7 — active soft rows carry
        # multipliers at the zl=1e3 scale, and the f64 ladder measured 43-78 N
        # first-stage GRF errors when the old fixed 1e4 cap truncated them —
        # so soft_qp_solve raises w_cap, paired with Jacobi equilibration.
        w = jnp.clip(lam / s_safe, 0.0, w_cap)  # (m,)
        rhs = -r_d - _mm(C.T, (lam * r_p - r_c) / s_safe)
        K = Hm + _mm(C.T * w[None, :], C) + I
        if w_cap > 1e5:
            # Jacobi equilibration: at stiff caps K spans ~10 orders of
            # magnitude and the raw f32 Cholesky can lose positive-
            # definiteness. The + I here re-adds reg on the UNIT-diagonal
            # scaled matrix — i.e. deliberate reg-RELATIVE damping
            # (reg*diag(K) in the unscaled space) that keeps the f32
            # factorization positive definite; the f64 ladder bounds the
            # resulting bias.
            Dinv = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(K), 1e-12))
            L = jnp.linalg.cholesky(K * Dinv[:, None] * Dinv[None, :] + I)
            dz = Dinv * jax.scipy.linalg.cho_solve((L, True), Dinv * rhs)
        else:
            L = jnp.linalg.cholesky(K)
            dz = jax.scipy.linalg.cho_solve((L, True), rhs)
        ds = -r_p - _mm(C, dz)
        dlam = -(r_c + lam * ds) / s_safe

        # Fraction-to-boundary.
        def max_step(v, dv):
            ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
            return jnp.minimum(1.0, 0.995 * jnp.min(ratio))

        alpha = jnp.minimum(max_step(s, ds), max_step(lam, dlam))
        z = z + alpha * dz
        s = jnp.maximum(s + alpha * ds, sl_min)
        lam = jnp.maximum(lam + alpha * dlam, sl_min)
        return (z, lam, s), None

    (z, lam, s), _ = jax.lax.scan(body, (z, lam, s), None, length=iters)
    gap = _dot(lam, s) / m
    primal_res = jnp.max(jnp.maximum(_mm(C, z) - d, 0.0))
    return QPSolution(z, lam, s, gap, primal_res)


def soft_qp_solve(Hm, g, C, d, S, zl: float = 1000.0, Zl: float = 1.0,
                  solver=None, iters: int = 8):
    """Solve the QP with L1/L2-penalized slacks on the rows selected by S.

    Mirrors acados' soft h-constraints (reference centroidal_nmpc_nominal.py:147-163,
    zl=1000/Zl=1): rows i with a slack t_j (S[i, j] = 1) relax to C_i z <= d_i + t_j,
    t_j >= 0, and the objective gains zl*t + 0.5*Zl*t^2 — an infeasible stability or
    foothold stage then degrades gracefully instead of collapsing the interior point
    (hard-infeasible QPs have empty feasible sets -> NaN iterates -> the controller's
    previous-GRF fallback).

    Augmented problem over v = [z; t]:
        min 0.5 v^T blkdiag(H, Zl I) v + [g; zl 1]^T v
        s.t. [C  -S] v <= d,   -t <= 0.

    Args:
        S: (m, ns) static 0/1 selection matrix (numpy; ns slack variables).
        solver: pdip_solve or pdip_solve_mehrotra (default mehrotra).
    Returns a QPSolution whose z is the ORIGINAL decision vector (n,).
    """
    solver = solver or pdip_solve_mehrotra
    n = g.shape[0]
    ns = S.shape[1]
    H_aug = jnp.zeros((n + ns, n + ns)).at[:n, :n].set(Hm)
    H_aug = H_aug.at[jnp.arange(n, n + ns), jnp.arange(n, n + ns)].set(Zl)
    g_aug = jnp.concatenate([g, jnp.full(ns, zl, g.dtype)])
    C_top = jnp.concatenate([C, -jnp.asarray(S, C.dtype)], axis=1)
    # The nonnegativity rows are written as -zl * t <= 0: scaling by zl puts their
    # optimal multipliers at O(1) (stationarity: zl - lam_row - zl * nu = 0 -> nu ~ 1
    # on inactive soft rows) and lands the barrier stiffness on the t-diagonal of the
    # Newton matrix, where it harmlessly pins dt = 0. Unscaled (-I) rows need
    # nu ~ zl, which the w-clamp in the solvers truncates -> underestimated
    # stiffness -> post-convergence drift (measured: 165 N vs 64 N first-stage fz on
    # an INACTIVE stability row). mu_floor = 1e-4 makes the convergence freeze
    # engage at the augmented problem's f32 complementarity plateau.
    C_bot = jnp.concatenate(
        [jnp.zeros((ns, n), C.dtype), -zl * jnp.eye(ns, dtype=C.dtype)], axis=1)
    C_aug = jnp.concatenate([C_top, C_bot], axis=0)
    d_aug = jnp.concatenate([d, jnp.zeros(ns, d.dtype)])
    # Warm-scale the slacked physical rows' multipliers: when a soft row is
    # ACTIVE its optimal multiplier sits at the L1 scale (lam ~ zl); started
    # from 1 the interior point spends the whole fixed budget climbing three
    # orders of magnitude and lands 10-80 N off (f64 soft-slack ladder).
    # zl/2 splits the difference between inactive (lam < zl) and active rows:
    # measured worst-tick first-stage GRF gap 5.6 N (10 forced-infeasible
    # ticks) vs 26-78 N from lam0 = 1 (tests/test_f64_ladder.py).
    has_slack = (jnp.asarray(S, C.dtype).sum(axis=1) > 0).astype(C.dtype)
    lam0 = jnp.concatenate([1.0 + (0.5 * zl - 1.0) * has_slack,
                            jnp.ones(ns, C.dtype)])
    sol = solver(H_aug, g_aug, C_aug, d_aug, iters=iters, mu_floor=1e-4,
                 lam0=lam0, w_cap=1e7)
    return QPSolution(sol.z[:n], sol.lam, sol.s, sol.gap, sol.primal_res)


def pdip_solve_mehrotra(Hm, g, C, d, iters: int = 8, reg: float = 1e-7,
                        z0=None, mu_floor: float = 1e-5, sl_min: float = 1e-6,
                        lam0=None, w_cap: float = 1e4):
    """Mehrotra predictor-corrector variant of :func:`pdip_solve`.

    One Cholesky factorization serves BOTH the affine predictor and the corrector
    solve, and the adaptive centering sigma = (mu_aff/mu)^3 reaches the same
    complementarity gap in roughly half the iterations — the sequential 144x144
    factorizations dominate the solve, so fewer iterations is the lever
    (HPIPM itself is a Mehrotra-style IPM)."""
    n = g.shape[0]
    m = d.shape[0]
    z = jnp.zeros(n) if z0 is None else z0
    s = jnp.maximum(d - _mm(C, z), 1.0)
    lam = jnp.ones(m) if lam0 is None else lam0  # see pdip_solve on lam0 scaling
    I = jnp.eye(n) * reg

    def max_step(v, dv):
        ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.minimum(1.0, 0.995 * jnp.min(ratio))

    def body(carry, _):
        z, lam, s = carry
        r_d = _mm(Hm, z) + g + _mm(C.T, lam)
        r_p = _mm(C, z) + s - d
        mu = _dot(lam, s) / m

        s_safe = jnp.maximum(s, sl_min)
        # w_cap + (stiff-regime) Jacobi equilibration: see pdip_solve.
        w = jnp.clip(lam / s_safe, 0.0, w_cap)
        K = Hm + _mm(C.T * w[None, :], C) + I
        if w_cap > 1e5:
            Dinv = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(K), 1e-12))
            L = jnp.linalg.cholesky(K * Dinv[:, None] * Dinv[None, :] + I)
        else:
            Dinv = None
            L = jnp.linalg.cholesky(K)

        def kkt_solve(r_c):
            rhs = -r_d - _mm(C.T, (lam * r_p - r_c) / s_safe)
            if Dinv is not None:
                dz = Dinv * jax.scipy.linalg.cho_solve((L, True), Dinv * rhs)
            else:
                dz = jax.scipy.linalg.cho_solve((L, True), rhs)
            ds = -r_p - _mm(C, dz)
            dlam = -(r_c + lam * ds) / s_safe
            return dz, ds, dlam

        # Predictor: pure Newton on complementarity (sigma = 0).
        dz_a, ds_a, dlam_a = kkt_solve(lam * s)
        a_aff = jnp.minimum(max_step(s, ds_a), max_step(lam, dlam_a))
        mu_aff = _dot(lam + a_aff * dlam_a, s + a_aff * ds_a) / m
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, mu_floor)) ** 3, 0.0, 1.0)

        # Corrector: centered + second-order term, same factorization.
        r_c = lam * s - sigma * jnp.maximum(mu, mu_floor) + dlam_a * ds_a
        dz, ds, dlam = kkt_solve(r_c)
        alpha = jnp.minimum(max_step(s, ds), max_step(lam, dlam))
        # Freeze once converged: further f32 Mehrotra steps at the mu floor drift
        # the iterate instead of polishing it.
        alpha = alpha * (mu > 2.0 * mu_floor)
        z = z + alpha * dz
        s = jnp.maximum(s + alpha * ds, sl_min)
        lam = jnp.maximum(lam + alpha * dlam, sl_min)
        return (z, lam, s), None

    (z, lam, s), _ = jax.lax.scan(body, (z, lam, s), None, length=iters)
    gap = _dot(lam, s) / m
    primal_res = jnp.max(jnp.maximum(_mm(C, z) - d, 0.0))
    return QPSolution(z, lam, s, gap, primal_res)
