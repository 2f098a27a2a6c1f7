"""Parallel-in-time LQR (associative-scan Riccati) vs the sequential recursion —
the stage-parallel capability SURVEY 2.7/P5 flags as having no reference precedent."""
import jax
import jax.numpy as jnp
import numpy as np

from quadruped_pympc_tamols.controllers.gradient.parallel_riccati import (
    lqr_backward_associative,
    lqr_backward_sequential,
)


def _random_ltv(H, n, m, seed=0):
    rng = np.random.default_rng(seed)
    F = jnp.asarray(rng.normal(size=(H, n, n)) * 0.3 + np.eye(n), jnp.float32)
    c = jnp.asarray(rng.normal(size=(H, n)) * 0.1, jnp.float32)
    G = jnp.asarray(rng.normal(size=(H, n, m)), jnp.float32)
    Qs = []
    for _ in range(H):
        A = rng.normal(size=(n, n))
        Qs.append(A @ A.T * 0.1 + 0.5 * np.eye(n))
    Q = jnp.asarray(Qs, jnp.float32)
    q = jnp.asarray(rng.normal(size=(H, n)), jnp.float32)
    R = jnp.asarray(np.tile(np.eye(m), (H, 1, 1)), jnp.float32)
    A = rng.normal(size=(n, n))
    QN = jnp.asarray(A @ A.T * 0.1 + np.eye(n), jnp.float32)
    qN = jnp.asarray(rng.normal(size=n), jnp.float32)
    return F, c, G, Q, q, R, QN, qN


def test_associative_matches_sequential():
    for seed, (H, n, m) in enumerate(((16, 4, 2), (12, 12, 12), (64, 6, 3))):
        args = _random_ltv(H, n, m, seed)
        K1, k1, S1, s1 = lqr_backward_sequential(*args)
        K2, k2, S2, s2 = lqr_backward_associative(*args)
        np.testing.assert_allclose(np.asarray(S2), np.asarray(S1), atol=2e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(np.asarray(K2), np.asarray(K1), atol=2e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(np.asarray(k2), np.asarray(k1), atol=2e-3,
                                   rtol=1e-3)


def test_closed_loop_trajectories_identical():
    """Rolling the system forward under both gain sets yields the same trajectory
    and cost (the end-to-end property that matters)."""
    H, n, m = 24, 6, 3
    F, c, G, Q, q, R, QN, qN = _random_ltv(H, n, m, seed=7)
    x0 = jnp.asarray(np.random.default_rng(1).normal(size=n), jnp.float32)

    def rollout(K, kff):
        def body(x, inp):
            Fk, ck, Gk, Kk, kk = inp
            u = -Kk @ x + kk
            xn = Fk @ x + ck + Gk @ u
            return xn, (x, u)
        _, (xs, us) = jax.lax.scan(body, x0, (F, c, G, K, kff))
        return xs, us

    K1, k1, *_ = lqr_backward_sequential(F, c, G, Q, q, R, QN, qN)
    K2, k2, *_ = lqr_backward_associative(F, c, G, Q, q, R, QN, qN)
    xs1, us1 = rollout(K1, k1)
    xs2, us2 = rollout(K2, k2)
    np.testing.assert_allclose(np.asarray(xs2), np.asarray(xs1), atol=1e-3)
    np.testing.assert_allclose(np.asarray(us2), np.asarray(us1), atol=1e-3)


def _ddp_scene(cfg):
    H = cfg.mpc.horizon
    x0 = jnp.zeros(12).at[2].set(0.30).at[3].set(0.1)
    feet_traj = jnp.tile(jnp.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                                      [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                                     jnp.float32), (H, 1, 1))
    seq = np.ones((4, H), np.float32)
    seq[1, : H // 2] = 0.0
    seq[2, : H // 2] = 0.0
    Xref = jnp.tile(jnp.zeros(12).at[2].set(0.35), (H, 1))
    Uref = jnp.zeros((H, 12)).at[:, 2::3].set(cfg.robot.mass * 9.81 / 4)
    return x0, feet_traj, jnp.asarray(seq), Xref, Uref


def test_ddp_associative_backward_equals_sequential():
    """The production consumer (config mpc.gradient.riccati_backward): the DDP
    solve with the parallel-in-time backward matches the sequential backward on
    a trot problem — the two passes solve the same LQR."""
    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.controllers.gradient.ddp import make_ddp_solver

    outs = {}
    for mode in ("sequential", "associative"):
        cfg = make_config("aliengo", mpc_type="nominal",
                          **{"mpc.gradient.use_DDP": True,
                             "mpc.gradient.riccati_backward": mode})
        solve, _ = make_ddp_solver(cfg)
        args = _ddp_scene(cfg)
        outs[mode] = solve(*args, args[4])  # U_warm = Uref
    U_seq = np.asarray(outs["sequential"].U)
    U_assoc = np.asarray(outs["associative"].U)
    scale = max(1.0, np.abs(U_seq).max())
    np.testing.assert_allclose(U_assoc, U_seq, atol=2e-3 * scale,
                               err_msg="parallel-in-time backward diverged from "
                                       "the sequential Riccati inside DDP")
    np.testing.assert_allclose(float(outs["associative"].cost),
                               float(outs["sequential"].cost), rtol=1e-4)


def test_ddp_long_horizon_auto_uses_associative():
    """H=48 long-horizon DDP ('auto' selects the associative pass) solves to
    finite, cone-feasible forces."""
    from quadruped_pympc_tamols import make_config
    from quadruped_pympc_tamols.controllers.gradient.ddp import make_ddp_solver

    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"mpc.gradient.use_DDP": True, "mpc.horizon": 48,
                         "mpc.horizon_fine_grained": 2})
    assert cfg.mpc.gradient.riccati_backward == "auto"
    solve, _ = make_ddp_solver(cfg)
    args = _ddp_scene(cfg)
    out = solve(*args, args[4])
    U = np.asarray(out.U)
    assert U.shape == (48, 12)
    assert np.all(np.isfinite(U))
    f = U.reshape(48, 4, 3)
    assert np.all(f[:, :, 2] >= -1e-5)
    assert np.all(np.abs(f[:, :, 0]) <= cfg.mpc.mu * f[:, :, 2] + 1e-3)
