"""GRF control parametrizations as precomputed linear bases.

The reference evaluates its zero-order / linear-spline / cubic-spline GRF
parametrizations per leg, per step, inside the rollout loop
(controllers/sampling/centroidal_nmpc_jax.py:181-268). All three parametrizations are
LINEAR in the parameters, so we precompute a basis tensor W with
``W[p, n, a] = d f_a(n) / d params[p]`` once at build time; the force trajectories of
every sample then come from a single matmul::

    forces[n_sample, leg, step, axis] = params[n_sample, leg, :] @ W[:, step, axis]

This replaces tens of thousands of scalar spline evaluations with one
(4N, P) x (P, 3H) GEMM — the batched formulation of the same math.

Layout quirks of the reference are reproduced exactly so that parameter vectors are
interchangeable in behavior:
* linear_spline (centroidal_nmpc_jax.py:181-201): per leg, (S+1) knots per axis,
  layout [x0..xS, y0..yS, z0..zS]; chunk index from linspace(0, H, S+1).
* cubic_spline (centroidal_nmpc_jax.py:204-257): Catmull-Rom-style with slopes
  phi = (p[i+2]-p[i]) / 2; the reference strides chunks by 10 (start_index = 10*index)
  while allocating 12 knots per chunk — we mirror that stride faithfully.
* zero_order (centroidal_nmpc_jax.py:259-268): layout [x0..x(H-1), y..., z...].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def num_params_per_leg(parametrization: str, horizon: int, num_splines: int) -> int:
    if parametrization == "linear_spline":
        return (num_splines + 1) * 3
    if parametrization == "cubic_spline":
        return 4 * 3 * num_splines
    if parametrization == "zero_order":
        return horizon * 3
    raise ValueError(f"unknown parametrization {parametrization!r}")


def _chunk_index(step: float, horizon: int, num_splines: int) -> int:
    """Reference chunk lookup (centroidal_nmpc_jax.py:187-189)."""
    boundaries = np.linspace(0, horizon, num_splines + 1)
    return int(np.max(np.where(step >= boundaries, np.arange(num_splines + 1), 0)))


def make_spline_basis(parametrization: str, horizon: int, num_splines: int) -> np.ndarray:
    """Build W of shape (P_leg, H, 3) with f(n)[axis] = params @ W[:, n, axis]."""
    P = num_params_per_leg(parametrization, horizon, num_splines)
    W = np.zeros((P, horizon, 3), dtype=np.float32)

    for n in range(horizon):
        if parametrization == "zero_order":
            for a in range(3):
                W[n + a * horizon, n, a] = 1.0
        elif parametrization == "linear_spline":
            S = num_splines
            idx = _chunk_index(n, horizon, S)
            q = n / (horizon / S) - idx
            shift = S + 1
            for a in range(3):
                W[idx + a * shift, n, a] += 1.0 - q
                W[idx + a * shift + 1, n, a] += q
        elif parametrization == "cubic_spline":
            S = num_splines
            idx = _chunk_index(n, horizon, S)
            q = n / (horizon / S) - idx
            a_b = 2 * q**3 - 3 * q**2 + 1
            b_b = q**3 - 2 * q**2 + q
            c_b = -2 * q**3 + 3 * q**2
            d_b = q**3 - q**2
            si = 10 * idx  # reference stride quirk (centroidal_nmpc_jax.py:219)
            for a in range(3):
                base = si + 4 * a
                # f = a*p[1] + b*phi + c*p[2] + d*phi_next,
                # phi = (p[2]-p[0])/2, phi_next = (p[3]-p[1])/2.
                W[base + 0, n, a] += -b_b / 2.0
                W[base + 1, n, a] += a_b - d_b / 2.0
                W[base + 2, n, a] += b_b / 2.0 + c_b
                W[base + 3, n, a] += d_b / 2.0
        else:
            raise ValueError(parametrization)
    return W


def make_step_major_basis(parametrization: str, horizon: int, num_splines: int) -> np.ndarray:
    """Block-diagonal all-leg basis with step-major output rows.

    Returns W_big of shape (H*12, 4*P_leg) such that
        raw = W_big @ params  with params (4*P_leg, N)
    yields raw rows ordered [step n][leg l][axis a] at row n*12 + l*3 + a. A free
    reshape to (H, 12, N) then hands each scan step a contiguous (12, N) block —
    the rollout's layout (samples on the minor axis, one row per force component)."""
    W = make_spline_basis(parametrization, horizon, num_splines)  # (P_leg, H, 3)
    P_leg = W.shape[0]
    big = np.zeros((horizon * 12, 4 * P_leg), dtype=np.float32)
    for n in range(horizon):
        for leg in range(4):
            for a in range(3):
                big[n * 12 + leg * 3 + a, leg * P_leg:(leg + 1) * P_leg] = W[:, n, a]
    return big


def spline_forces(W_big, params):
    """The sampling path's one GEMM: ``(H*12, P)`` step-major basis times ``(P, N)``
    parameters -> ``(H, 12, N)`` raw force rows (see make_step_major_basis).

    Full float32 precision: the GPU's default TF32 matmul would round every
    sample's forces to ~3 significant digits."""
    return jnp.matmul(W_big, params, precision=jax.lax.Precision.HIGHEST).reshape(
        -1, 12, params.shape[-1])


def make_shift_basis(parametrization: str, horizon: int, num_splines: int,
                     shift_time: float) -> np.ndarray:
    """Basis row evaluating the spline at fractional step ``shift_time`` (used by the
    warm-start shift, reference centroidal_nmpc_jax.py:513-561). Shape (P_leg, 3)."""
    P = num_params_per_leg(parametrization, horizon, num_splines)
    W = np.zeros((P, 3), dtype=np.float32)
    n = shift_time
    if parametrization == "zero_order":
        i = int(n)
        for a in range(3):
            W[i + a * horizon, a] = 1.0
    elif parametrization == "linear_spline":
        S = num_splines
        idx = _chunk_index(n, horizon, S)
        q = n / (horizon / S) - idx
        shift = S + 1
        for a in range(3):
            W[idx + a * shift, a] += 1.0 - q
            W[idx + a * shift + 1, a] += q
    else:
        S = num_splines
        idx = _chunk_index(n, horizon, S)
        q = n / (horizon / S) - idx
        a_b = 2 * q**3 - 3 * q**2 + 1
        b_b = q**3 - 2 * q**2 + q
        c_b = -2 * q**3 + 3 * q**2
        d_b = q**3 - q**2
        si = 10 * idx
        for a in range(3):
            base = si + 4 * a
            W[base + 0, a] += -b_b / 2.0
            W[base + 1, a] += a_b - d_b / 2.0
            W[base + 2, a] += b_b / 2.0 + c_b
            W[base + 3, a] += d_b / 2.0
    return W
