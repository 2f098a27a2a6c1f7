"""TAMOLS foothold planner: heightmap lookups, hard constraints, cost behavior on
synthetic terrains (flat, step edge, stepping stones)."""
import jax
import jax.numpy as jnp
import numpy as np

from quadruped_pympc_tamols import make_config, replace_config
from quadruped_pympc_tamols.planner import (
    GridHeightMap,
    heightmap_from_fn,
    lookup_nearest,
    make_tamols_scorer,
)


def flat(x, y):
    return jnp.zeros_like(x)


def step_edge(x, y):
    """10 cm step up at x > 0.3."""
    return jnp.where(x > 0.3, 0.10, 0.0)


def stones(x, y):
    """Stepping stones: raised 10 cm circles of radius 0.09 on a 0.4 m grid;
    gaps are 30 cm deep (like the reference's stepping-stones course,
    docs/STEPPING_STONES_TERRAIN.md:9-40)."""
    cx = jnp.round(x / 0.4) * 0.4
    cy = jnp.round(y / 0.4) * 0.4
    on = (x - cx) ** 2 + (y - cy) ** 2 <= 0.09**2
    return jnp.where(on, 0.0, -0.30)


def _make_hms(terrain, seeds, yaw=0.0, rows=13, cols=7):
    hms = [heightmap_from_fn(terrain, s[:2], yaw, rows=rows, cols=cols)
           for s in seeds]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *hms)


def _setup(terrain, seeds=None):
    cfg = make_config("aliengo")
    adapt = make_tamols_scorer(cfg, "tamols")
    if seeds is None:
        seeds = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                          [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]])
    hips = seeds + np.array([0.0, 0.0, cfg.robot.hip_height])
    feet = seeds.copy()
    hms = _make_hms(terrain, seeds)
    return cfg, adapt, hms, seeds, hips, feet


def test_lookup_nearest_grid():
    hm = heightmap_from_fn(step_edge, [0.3, 0.0], yaw=0.0, rows=13, cols=7)
    h_low = float(lookup_nearest(hm, jnp.asarray([0.2, 0.0])))
    h_high = float(lookup_nearest(hm, jnp.asarray([0.45, 0.0])))
    assert abs(h_low) < 1e-6 and abs(h_high - 0.10) < 1e-6
    # Out-of-grid clamps to border.
    far = float(lookup_nearest(hm, jnp.asarray([10.0, 10.0])))
    assert np.isfinite(far)


def test_flat_ground_keeps_near_seed():
    cfg, adapt, hms, seeds, hips, feet = _setup(flat)
    res = adapt(hms, seeds, hips, np.array([0.0, 0.0, 0.35]), np.array([0.2, 0.0, 0.0]),
                np.zeros(4), feet, feet)
    fh = np.asarray(res.footholds)
    assert np.all(np.asarray(res.feasible))
    # On flat ground the only pull is deviation/tracking: stays within a cell or two.
    assert np.all(np.linalg.norm(fh[:, :2] - seeds[:, :2], axis=1) < 0.1)
    np.testing.assert_allclose(fh[:, 2], 0.025, atol=1e-6)  # z + 0.02 + 0.005


def test_step_edge_avoided():
    """Seed sits right at a 10 cm step edge: the chosen foothold must move off the
    edge (edge cost) while flat terrain would keep it."""
    seeds = np.array([[0.30, 0.15, 0.0], [0.30, -0.15, 0.0],
                      [-0.20, 0.15, 0.0], [-0.20, -0.15, 0.0]])
    cfg, adapt, hms, seeds, hips, feet = _setup(step_edge, seeds)
    res = adapt(hms, seeds, hips, np.array([0.05, 0.0, 0.35]), np.array([0.0, 0.0, 0.0]),
                np.zeros(4), feet, feet)
    fh = np.asarray(res.footholds)
    # The front feet moved away from the x=0.3 edge by at least ~one cell.
    assert abs(fh[0, 0] - 0.30) > 0.039
    assert abs(fh[1, 0] - 0.30) > 0.039


def test_stepping_stones_lands_on_stones():
    seeds = np.array([[0.35, 0.15, 0.0], [0.35, -0.15, 0.0],
                      [-0.35, 0.15, 0.0], [-0.35, -0.15, 0.0]])
    cfg, adapt, hms, seeds, hips, feet = _setup(stones, seeds)
    # Hips above actual stone height so kinematics stay feasible.
    hips = seeds + np.array([0.0, 0.0, 0.35])
    res = adapt(hms, seeds, hips, np.array([0.0, 0.0, 0.35]), np.array([0.1, 0.0, 0.0]),
                np.zeros(4), feet, feet)
    fh = np.asarray(res.footholds)
    for leg in range(4):
        z = float(stones(jnp.asarray(fh[leg, 0]), jnp.asarray(fh[leg, 1])))
        assert z == 0.0, f"leg {leg} landed in a gap at {fh[leg]}"


def test_support_margin_rejects_rim_cells():
    """5 cm stones on a solid deck (the REFERENCE-SPEC course geometry): a 5 cm
    rise over the 8 cm central difference is slope 0.625, UNDER slope_threshold
    0.7 — the reference's edge cost is blind to it and happily lands on rims.
    With the support-margin mask on, every chosen foothold's local patch must be
    flat: the landing commits to a stone top or clean deck, never a rim."""
    def low_stones(x, y):
        cx = jnp.round(x / 0.4) * 0.4
        cy = jnp.round(y / 0.4) * 0.4
        on = (x - cx) ** 2 + (y - cy) ** 2 <= 0.15**2
        return jnp.where(on, 0.05, 0.0)

    # Seeds in the dead zone between stones, near rims.
    seeds = np.array([[0.21, 0.15, 0.05], [0.21, -0.15, 0.05],
                      [-0.21, 0.15, 0.05], [-0.21, -0.15, 0.05]])
    cfg = make_config("aliengo", **{"tamols.support_margin": 0.015,
                                    "tamols.heightmap_cols": 13})
    adapt = make_tamols_scorer(cfg, "tamols")
    hips = seeds + np.array([0.0, 0.0, 0.35])
    hms = _make_hms(low_stones, seeds)
    res = adapt(hms, seeds, hips, np.array([0.0, 0.0, 0.40]), np.array([0.1, 0.0, 0.0]),
                np.zeros(4), seeds.copy(), seeds.copy())
    fh = np.asarray(res.footholds)
    assert np.all(np.asarray(res.feasible)), "stone interiors are in reach and flat"
    delta = cfg.tamols.gradient_delta
    for leg in range(4):
        patch = np.array([
            float(low_stones(jnp.asarray(fh[leg, 0] + i * delta),
                             jnp.asarray(fh[leg, 1] + j * delta)))
            for i in (-1, 0, 1) for j in (-1, 0, 1)])
        assert patch.max() - patch.min() <= 0.03 + 1e-6, \
            f"leg {leg} landed on a rim at {fh[leg]}"


def test_support_margin_off_is_reference_parity():
    """Default (support_margin >= 1) leaves scoring bit-identical to before."""
    cfg, adapt, hms, seeds, hips, feet = _setup(flat)
    res = adapt(hms, seeds, hips, np.array([0.0, 0.0, 0.35]), np.zeros(3),
                np.zeros(4), feet, feet)
    assert np.all(np.asarray(res.feasible))


def test_kinematic_infeasible_falls_back_to_seed():
    """Hips absurdly far away -> nothing reachable -> fall back to height-snapped seed."""
    cfg, adapt, hms, seeds, hips, feet = _setup(flat)
    hips_far = seeds + np.array([5.0, 5.0, 5.0])
    res = adapt(hms, seeds, hips_far, np.array([0.0, 0.0, 0.35]), np.zeros(3),
                np.zeros(4), feet, feet)
    assert not np.any(np.asarray(res.feasible))
    np.testing.assert_allclose(np.asarray(res.footholds)[:, :2], seeds[:, :2], atol=1e-6)


def test_infeasible_fallback_foot_relands_on_current_foothold():
    """tamols.fallback='foot' (gap-lattice extension): with nothing feasible,
    the planner re-lands on the leg's CURRENT foothold (known solid ground)
    instead of the Raibert seed — measured on the chasm, a drift-squeezed seed
    fallback put a foot on a stone rim over a gap and the robot rolled."""
    cfg = make_config("aliengo", **{"tamols.fallback": "foot"})
    adapt = make_tamols_scorer(cfg, "tamols")
    seeds = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                      [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]])
    feet = seeds - np.array([0.12, 0.0, 0.0])  # feet trail the seeds
    hips = seeds + np.array([0.0, 0.0, cfg.robot.hip_height])
    hms = _make_hms(flat, seeds)
    res = adapt(hms, seeds, hips + np.array([5.0, 5.0, 5.0]),
                np.array([0.0, 0.0, 0.35]), np.zeros(3), np.zeros(4), feet, feet)
    assert not np.any(np.asarray(res.feasible))
    np.testing.assert_allclose(np.asarray(res.footholds)[:, :2], feet[:, :2],
                               atol=1e-6)


def test_stance_legs_skip_stability():
    cfg, adapt, hms, seeds, hips, feet = _setup(flat)
    r_swing = adapt(hms, seeds, hips, np.array([0.0, 0.0, 0.35]), np.array([0.5, 0.0, 0.0]),
                    np.zeros(4), feet, feet)
    r_stance = adapt(hms, seeds, hips, np.array([0.0, 0.0, 0.35]), np.array([0.5, 0.0, 0.0]),
                     np.ones(4), feet, feet)
    # Stability cost only applies to swing legs; costs must differ when CoM prediction
    # is far from the support line.
    assert np.all(np.asarray(r_stance.best_cost) <= np.asarray(r_swing.best_cost) + 1e-6)


def test_constraint_boxes():
    cfg, adapt, hms, seeds, hips, feet = _setup(flat)
    res = adapt(hms, seeds, hips, np.array([0.0, 0.0, 0.35]), np.zeros(3), np.zeros(4), feet, feet)
    lo = np.asarray(res.constraints_lo)
    hi = np.asarray(res.constraints_hi)
    np.testing.assert_allclose(hi[:, 0] - lo[:, 0], 2 * cfg.tamols.constraint_box_dx, atol=1e-6)
    np.testing.assert_allclose(hi[:, 1] - lo[:, 1], 2 * cfg.tamols.constraint_box_dy, atol=1e-6)


def test_progression_advances_on_lattice():
    """Lattice progression (tamols.min_advance — the chasm extension replacing
    round 3's regressing stay/hop anchors; no reference counterpart): on a
    0.4 m stone lattice over deep gaps, with the Raibert seed mid-gap and the
    foot on a stone center, the progression cost makes the scorer pick the
    NEXT column's stone (>= min_advance ahead of the current foot) instead of
    re-booking the current column — the greedy-rebooking deadlock measured on
    the chasm field."""
    cfg = make_config("aliengo")
    # The sensing window must REACH the next column's interior (13 rows at
    # 4 cm spans only +-0.24 m around the seed — the rim of a 0.4 m-pitch
    # lattice is visible but its stone centers are not).
    cfg = replace_config(cfg, **{"tamols.min_advance": 0.35,
                                 "tamols.weight_progression": 50.0,
                                 "tamols.heightmap_rows": 19,
                                 "tamols.search_radius_forward": 0.4,
                                 "tamols.search_radius_back": 0.15})
    adapt = make_tamols_scorer(cfg, "tamols")
    feet = np.array([[0.0, 0.4, 0.0], [0.0, 0.0, 0.0],
                     [-0.4, 0.4, 0.0], [-0.4, 0.0, 0.0]])  # on stone centers
    # Seeds just ahead of the current column — the measured deadlock geometry:
    # the deviation cost re-books the column the foot is on.
    seeds = feet + np.array([0.1, 0.0, 0.0])
    hips = seeds + np.array([0.0, 0.0, cfg.robot.hip_height])
    hms = _make_hms(stones, seeds, rows=19)
    res = adapt(hms, seeds, hips, np.array([-0.1, 0.2, 0.35]),
                np.array([0.15, 0.0, 0.0]), np.zeros(4), feet, feet)
    fh = np.asarray(res.footholds)
    assert np.all(np.asarray(res.feasible))
    # Every foothold advanced (roughly) one pitch from its current foot and
    # sits on a stone (z == 0 on stone tops, -0.30 in the gaps).
    adv = fh[:, 0] - feet[:, 0]
    assert np.all(adv > 0.3), f"progression did not advance a column: {adv}"
    assert np.all(fh[:, 2] > -0.05), f"foothold in a gap: {fh[:, 2]}"

    # Without progression the same scene re-books the CURRENT column for at
    # least one leg (the deadlock this cost exists to break).
    cfg0 = replace_config(cfg, **{"tamols.min_advance": 0.0})
    res0 = make_tamols_scorer(cfg0, "tamols")(
        hms, seeds, hips, np.array([-0.1, 0.2, 0.35]),
        np.array([0.15, 0.0, 0.0]), np.zeros(4), feet, feet)
    adv0 = np.asarray(res0.footholds)[:, 0] - feet[:, 0]
    assert np.any(adv0 < 0.3), "baseline already advances; progression untested"


def test_progression_gate_off_on_flat():
    """Progression engages only where the IN-RADIUS terrain spans the gate
    range (deep gaps): on flat ground the same config behaves like plain
    TAMOLS (footholds stay near the Raibert seed, free strides) — and the
    gate uses in-radius cells, not the whole sensing window."""
    cfg = make_config("aliengo")
    cfg = replace_config(cfg, **{"tamols.min_advance": 0.35,
                                 "tamols.weight_progression": 50.0})
    adapt = make_tamols_scorer(cfg, "tamols")
    seeds = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0],
                      [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]])
    hips = seeds + np.array([0.0, 0.0, cfg.robot.hip_height])
    feet = seeds - np.array([0.15, 0.0, 0.0])  # progression would pull forward
    hms = _make_hms(flat, seeds)
    res = adapt(hms, seeds, hips, np.array([0.0, 0.0, 0.35]),
                np.array([0.2, 0.0, 0.0]), np.zeros(4), feet, feet)
    fh = np.asarray(res.footholds)
    assert np.all(np.linalg.norm(fh[:, :2] - seeds[:, :2], axis=1) < 0.1)


def test_flight_time_reach_gate():
    """tamols.max_foot_speed (the flight-time reach model, round-4 chasm
    postmortem): a swinging leg with little swing time left cannot be sent to a
    far candidate — with a generous time budget the planner advances; with a
    tiny one every far cell is infeasible and the leg falls back to its own
    foothold (fallback='foot'), i.e. 'land on known ground now'."""
    cfg = make_config("aliengo", **{"tamols.max_foot_speed": 1.5,
                                    "tamols.fallback": "foot",
                                    "tamols.weight_reference_tracking": 10.0})
    adapt = make_tamols_scorer(cfg, "tamols")
    seeds = np.array([[0.45, 0.15, 0.0], [0.25, -0.15, 0.0],
                      [-0.25, 0.15, 0.0], [-0.25, -0.15, 0.0]])
    hips = seeds + np.array([0.0, 0.0, cfg.robot.hip_height])
    feet = seeds - np.array([0.2, 0.0, 0.0])  # FL's foot 0.2 m behind its seed
    hms = _make_hms(flat, seeds)
    contact = np.array([0.0, 1.0, 1.0, 1.0])  # FL swinging

    # Plenty of time: full freedom, target lands near the seed.
    t_full = np.full(4, 0.4)
    r1 = adapt(hms, seeds, hips, np.array([0.1, 0.0, 0.35]),
               np.array([0.2, 0.0, 0.0]), contact, feet, feet, t_full)
    assert bool(np.asarray(r1.feasible)[0])
    assert np.linalg.norm(np.asarray(r1.footholds)[0, :2] - seeds[0, :2]) < 0.1

    # 30 ms left: reach = 4.5 cm around the foot, the seed region (0.2 m away)
    # is unreachable -> candidates near the FOOT win (or fallback to the foot).
    t_tiny = np.array([0.03, 0.4, 0.4, 0.4])
    r2 = adapt(hms, seeds, hips, np.array([0.1, 0.0, 0.35]),
               np.array([0.2, 0.0, 0.0]), contact, feet, feet, t_tiny)
    fh2 = np.asarray(r2.footholds)[0]
    assert np.linalg.norm(fh2[:2] - feet[0, :2]) < 0.06, \
        f"gated leg sent {np.linalg.norm(fh2[:2] - feet[0, :2]):.3f} m away"
    # Stance legs are unaffected (full-period gate).
    assert bool(np.asarray(r2.feasible)[1])
