"""Golden-trace parity regression (BASELINE.md: GRF parity <= 1e-3 on trot).

acados/CasADi are not installable in this environment, so exact cross-solver
parity cannot be checked here; instead the solved GRFs/footholds/predicted states
for canonical scenarios are PINNED as committed fixtures. Any numeric drift in
qp.py / sqp.py / variants.py (a changed guard, a reordered reduction, a wrong
scaling) fails this test even while the robot still happens to walk.

Regenerate after an INTENTIONAL solver change with:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=. python tests/test_golden_traces.py regen
and justify the diff in the commit message. The XLA_FLAGS must match
tests/conftest.py: the fixed-iteration IPM runs near its convergence floor on the
harder scenarios (3-stance, push), where XLA codegen differences (e.g. the
device-count flag changing vectorization) shift GRFs by several newtons — the
fixture pins one exact codegen environment on purpose.
"""
import os

import numpy as np
import pytest

from quadruped_pympc_tamols import make_config

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_traces.npz")


def _feet():
    return dict(foot_FL=np.array([0.25, 0.15, 0.0]), foot_FR=np.array([0.25, -0.15, 0.0]),
                foot_RL=np.array([-0.25, 0.15, 0.0]), foot_RR=np.array([-0.25, -0.15, 0.0]))


def _state(pos=(0, 0, 0.32), vel=(0, 0, 0), rpy=(0, 0, 0), omega=(0, 0, 0), feet=None):
    s = dict(position=np.asarray(pos, float), linear_velocity=np.asarray(vel, float),
             orientation=np.asarray(rpy, float), angular_velocity=np.asarray(omega, float))
    s.update(feet or _feet())
    return s


def _ref(cfg, vel=(0, 0, 0), rpy=(0, 0, 0), feet=None):
    feet = feet or _feet()
    return dict(ref_position=np.array([0.0, 0.0, cfg.sim.ref_z]),
                ref_linear_velocity=np.asarray(vel, float),
                ref_orientation=np.asarray(rpy, float),
                ref_angular_velocity=np.zeros(3),
                ref_foot_FL=feet["foot_FL"][None], ref_foot_FR=feet["foot_FR"][None],
                ref_foot_RL=feet["foot_RL"][None], ref_foot_RR=feet["foot_RR"][None])


def _trot_seq(H):
    seq = np.ones((4, H))
    seq[1, : H // 2] = 0.0  # FR swings first half
    seq[2, : H // 2] = 0.0  # RL swings first half
    seq[0, H // 2:] = 0.0  # FL swings second half
    seq[3, H // 2:] = 0.0  # RR swings second half
    return seq


def _slope_feet():
    f = _feet()
    for leg, dz in (("foot_FL", 0.07), ("foot_FR", 0.07), ("foot_RL", -0.07),
                    ("foot_RR", -0.07)):
        f[leg] = f[leg] + np.array([0.0, 0.0, dz])
    return f


def _gradient_case(variant, state, ref, seq):
    from quadruped_pympc_tamols.controllers.gradient import (
        GradientMPC,
        VariantGradientMPC,
    )

    cfg = make_config("aliengo", mpc_type="nominal")
    mpc = GradientMPC(cfg) if variant == "nominal" else VariantGradientMPC(cfg, variant)
    if variant == "kinodynamic":
        import jax.numpy as jnp

        from quadruped_pympc_tamols.kinematics import LegKinematics
        from quadruped_pympc_tamols.utils.frames import euler_xyz_to_rot

        kin = LegKinematics(cfg.robot)
        feet = np.stack([state[f"foot_{leg}"] for leg in ("FL", "FR", "RL", "RR")])
        q0 = np.asarray(kin.ik_world(jnp.asarray(feet, jnp.float32),
                                     jnp.asarray(state["position"], jnp.float32),
                                     euler_xyz_to_rot(jnp.asarray(state["orientation"],
                                                                  jnp.float32))))
        for i, leg in enumerate(("FL", "FR", "RL", "RR")):
            state[f"joint_{leg}"] = q0[i]
    grfs, fh, pred, status, cost = mpc.compute_control(state, ref, seq)
    assert status == 0, f"{variant} solver failed"
    return {"grfs": grfs, "footholds": fh, "predicted": pred,
            "cost": np.float32(cost)}


def _sampling_case(state, ref, seq):
    import jax
    import jax.numpy as jnp

    from quadruped_pympc_tamols.controllers.sampling import SamplingMPC

    cfg = make_config("aliengo", mpc_type="sampling")
    mpc = SamplingMPC(cfg, num_samples=256, seed=0)
    out = mpc.compute_control(state, ref, jnp.asarray(seq, jnp.float32),
                              seq[:, 0].astype(np.float32), np.ones(4, np.float32))
    return {"grfs": np.asarray(out.grfs), "predicted": np.asarray(out.predicted_state),
            "cost": np.float32(out.best_cost)}


def _tamols_case():
    """Pin the TAMOLS scorer's outputs on a deterministic stepping-stone
    heightmap (golden traces cover the planner too)."""
    import jax
    import jax.numpy as jnp

    from quadruped_pympc_tamols.planner.heightmap import heightmap_from_fn
    from quadruped_pympc_tamols.planner.tamols import make_tamols_scorer

    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"sim.visual_foothold_adaptation": "tamols",
                         "tamols.support_margin": 0.015,
                         "tamols.foot_separation": 0.1})
    # Plum-blossom stone pattern on a flat deck (same geometry as the
    # stepping_stones scene field section, sim/mjcf.py).
    stones = np.array([(0.2 + 0.4 * ix, y)
                       for ix in range(3)
                       for y in ((-0.4, 0.0, 0.4) if ix % 2 == 0
                                 else (-0.2, 0.2, 0.6))])

    def terrain(x, y):
        # Vectorized over sample grids (heightmap_from_fn passes (R, C) arrays).
        d = jnp.hypot(x[..., None] - stones[:, 0], y[..., None] - stones[:, 1])
        return jnp.where(jnp.min(d, axis=-1) <= 0.15, 0.05, 0.0)

    feet = np.stack([_feet()[f"foot_{leg}"] for leg in ("FL", "FR", "RL", "RR")])
    seeds = feet + np.array([0.15, 0.0, 0.0])
    hms = jax.tree_util.tree_map(
        lambda *ls: jnp.stack(ls),
        *[heightmap_from_fn(terrain, seeds[leg, :2], 0.0, rows=13, cols=13)
          for leg in range(4)])
    hips = feet + np.array([0.0, 0.0, 0.3])
    adapt = make_tamols_scorer(cfg)
    res = adapt(hms, jnp.asarray(seeds, jnp.float32), jnp.asarray(hips, jnp.float32),
                jnp.asarray([0.2, 0.0, 0.32], jnp.float32),
                jnp.asarray([0.25, 0.0, 0.0], jnp.float32),
                jnp.zeros(4, jnp.float32), jnp.asarray(feet, jnp.float32),
                jnp.asarray(feet, jnp.float32))
    return {"footholds": np.asarray(res.footholds),
            "best_cost": np.asarray(res.best_cost),
            "feasible": np.asarray(res.feasible).astype(np.float32)}


def _scenarios():
    cfg = make_config("aliengo", mpc_type="nominal")
    H = cfg.mpc.horizon
    full = np.ones((4, H))
    trot = _trot_seq(H)
    three = np.ones((4, H))
    three[1, :] = 0.0
    cases = {}
    cases["stand_nominal"] = ("nominal", _state(pos=(0, 0, 0.29)), _ref(cfg), full)
    cases["trot_nominal"] = ("nominal", _state(vel=(0.2, 0, 0)),
                             _ref(cfg, vel=(0.3, 0, 0)), trot)
    cases["three_stance_nominal"] = ("nominal", _state(), _ref(cfg), three)
    cases["push_nominal"] = ("nominal", _state(vel=(0, 0.4, 0), rpy=(0.1, 0, 0)),
                             _ref(cfg), full)
    cases["slope_nominal"] = ("nominal", _state(rpy=(0, -0.15, 0), feet=_slope_feet()),
                              _ref(cfg, rpy=(0, -0.15, 0), feet=_slope_feet()), full)
    for variant in ("input_rates", "lyapunov", "collaborative", "kinodynamic"):
        cases[f"trot_{variant}"] = (variant, _state(vel=(0.2, 0, 0)),
                                    _ref(cfg, vel=(0.3, 0, 0)), trot)
    return cases


def compute_all():
    out = {}
    for name, (variant, state, ref, seq) in _scenarios().items():
        res = _gradient_case(variant, state, ref, seq)
        for k, v in res.items():
            out[f"{name}/{k}"] = np.asarray(v)
    cfg = make_config("aliengo")
    res = _sampling_case(_state(vel=(0.2, 0, 0)), _ref(cfg, vel=(0.3, 0, 0)),
                         _trot_seq(cfg.mpc.horizon))
    for k, v in res.items():
        out[f"trot_sampling/{k}"] = np.asarray(v)
    for k, v in _tamols_case().items():
        out[f"stones_tamols/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def golden():
    assert os.path.exists(FIXTURE), (
        "missing golden fixture — run: JAX_PLATFORMS=cpu python "
        "tests/test_golden_traces.py regen")
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def current():
    return compute_all()


@pytest.mark.parametrize("name", list(_scenarios().keys())
                         + ["trot_sampling", "stones_tamols"])
def test_golden_trace(golden, current, name):
    keys = [k for k in golden if k.startswith(name + "/")]
    assert keys, f"fixture has no entries for {name}"
    for k in keys:
        got = current[k]
        want = golden[k]
        scale = max(1.0, float(np.max(np.abs(want))))
        np.testing.assert_allclose(
            got, want, rtol=1e-3, atol=1e-3 * scale,
            err_msg=f"{k} drifted from the golden trace (solver numerics changed; "
                    f"regen deliberately if intended)")


if __name__ == "__main__":
    import sys

    if "regen" in sys.argv:
        os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
        np.savez(FIXTURE, **compute_all())
        print(f"wrote {FIXTURE} with {len(compute_all())} arrays")
    else:
        print("usage: JAX_PLATFORMS=cpu python tests/test_golden_traces.py regen")
