"""TAMOLS-inspired terrain-aware foothold adaptation — one fused kernel.

Re-design of the reference VisualFootholdAdaptation 'tamols' strategy
(helpers/visual_foothold_adaptation.py:153-714). The reference scores every heightmap
cell per leg with a pure-Python loop over ~7 cost terms (O(cells x costs) host work,
run once per swing apex). Here ALL candidates of ALL four legs are scored in a single
jitted program: hard-constraint masks + soft costs are broadcast over the (4, R*C)
candidate tensor, the argmin per leg picks the foothold, and box constraints for the
MPC fall out. Also supports the 'height' strategy (z-snap only,
visual_foothold_adaptation.py:104-108).

Cost terms (weights from config tamols_params, reference config.py:209-243):
  hard: kinematic reach at touch-down AND predicted lift-off (:375-395);
        leg-terrain collision along 5 sampled leg points (:397-420);
        optionally stability_hard (:227).
  soft: edge avoidance — central-difference gradient magnitude above
        slope_threshold (:422-466);
        roughness — plane-detrended height variance of a 3x3 patch (:468-521);
        deviation from seed ||c - seed||^2 (:341-345);
        nominal kinematics ||hip - (c + [0,0,h_des])||^2 (:523-553);
        reference-velocity tracking — penalize x-displacement opposing v_ref,x
        (:555-609);
        trot stability — distance of the predicted CoM (com + v*t_swing) to the
        diagonal-support segment beyond stability_margin (:611-714).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from .heightmap import GridHeightMap, lookup_nearest

_BIG = 1.0e10

# Trot diagonal partners: FL<->RR, FR<->RL (reference :640-645).
_DIAG = np.array([3, 2, 1, 0])

# Lateral side sign per leg (FL, FR, RL, RR): left legs live at +y in the
# yaw-aligned frame, right legs at -y (same convention as the Raibert
# generator's stance-width offsets, gait/foothold_reference.py).
_Y_OFFSET_SIGN = np.array([1.0, -1.0, 1.0, -1.0], dtype=np.float32)


class TamolsResult(NamedTuple):
    footholds: jnp.ndarray  # (4, 3) adapted footholds (world)
    constraints_lo: jnp.ndarray  # (4, 3) box lower vertex
    constraints_hi: jnp.ndarray  # (4, 3) box upper vertex
    best_cost: jnp.ndarray  # (4,)
    feasible: jnp.ndarray  # (4,) bool: any candidate passed the hard constraints


def _detrend_projection(delta: float) -> np.ndarray:
    """9x9 residual projector for the 3x3 plane fit: r = (I - A (A^T A)^-1 A^T) h.

    The patch geometry is FIXED (offsets i,j in {-1,0,1} * delta), so the least-squares
    plane fit of the reference (:503-515) reduces to one constant matrix."""
    pos = np.array([[i * delta, j * delta] for i in (-1, 0, 1) for j in (-1, 0, 1)])
    A = np.column_stack([pos[:, 0], pos[:, 1], np.ones(9)])
    P = np.eye(9) - A @ np.linalg.solve(A.T @ A, A.T)
    return P.astype(np.float32)


def make_tamols_scorer(cfg: Config, strategy: str | None = None):
    """Build the jitted foothold-adaptation function.

    Returns ``adapt(hms, seeds, hips, base_pos, base_vel, current_contact, feet)
    -> TamolsResult`` where ``hms`` is a leg-stacked GridHeightMap pytree
    (leaves have leading dim 4), seeds/hips/feet are (4, 3).
    """
    tp = cfg.tamols
    strategy = strategy or cfg.sim.visual_foothold_adaptation
    l_min, l_max = cfg.robot.l_min, cfg.robot.l_max
    Pproj = _detrend_projection(tp.gradient_delta)  # host numpy constant
    z_off = tp.sensor_z_offset  # +0.02 of FastHeightMap.get_height (:35)

    def _leg_adapt(hm: GridHeightMap, seed, hip, side, other_feet, base_pos, base_vel,
                   in_stance, diag_foot, own_foot, foot_now, t_remain):
        """Score all cells of one leg's heightmap. All lookups are on this leg's grid."""
        cand_xy = hm.cell_world_xy().reshape(-1, 2)  # (M, 2)
        # Candidate z: grid height + sensor offset + 0.005 (reference :192).
        cand_z = lookup_nearest(hm, cand_xy) + z_off + 0.005
        cand = jnp.concatenate([cand_xy, cand_z[:, None]], axis=1)  # (M, 3)

        if strategy == "height":
            h = lookup_nearest(hm, seed[:2]) + z_off
            fh = jnp.concatenate([seed[:2], h[None]])
            return (fh, fh - _BIG, fh + _BIG, jnp.asarray(0.0), jnp.asarray(True))

        # --- hard: candidate search radius around the seed (reference :245-259
        # builds its candidate grid within search_radius; heightmap cells beyond
        # it are excluded so a wide sensing window doesn't admit far-flung cells).
        # The radius is an ELLIPSE in the yaw-aligned frame when
        # search_radius_forward < search_radius: lateral snaps are safe (the hip
        # passes over them) but along-heading snaps land at the reach limit — a
        # touchdown moved ~0.25 m ahead of the Raibert seed saturates the leg's
        # IK mid-swing and the foot never descends (measured on the
        # stepping-stones course). Defaults keep the reference's isotropic disc.
        rel = cand_xy - seed[:2]
        c_r, s_r = jnp.cos(hm.yaw), jnp.sin(hm.yaw)
        dx_h = c_r * rel[:, 0] + s_r * rel[:, 1]
        dy_h = -s_r * rel[:, 0] + c_r * rel[:, 1]
        rx_f = min(tp.search_radius_forward, tp.search_radius)
        rx_b = min(tp.search_radius_back, tp.search_radius)
        rx = jnp.where(dx_h > 0, rx_f, rx_b)
        in_radius = (dx_h / rx) ** 2 + (dy_h / tp.search_radius) ** 2 <= 1.0

        # --- hard: kinematic reach at touch-down and predicted lift-off (:375-395).
        # config tamols.predict_hip_at_touchdown: the reach band evaluates at
        # the hip's PREDICTED touchdown position (forward walks otherwise
        # understate reach for forward candidates by v * t_swing).
        if tp.predict_hip_at_touchdown:
            hip_td = hip + base_vel * jnp.minimum(t_remain, 1.0)
        else:
            hip_td = hip
        d_td = jnp.linalg.norm(cand - hip_td, axis=1)
        hip_lo = hip_td + base_vel * 0.3  # stance_duration 0.3 s (:387-390)
        d_lo = jnp.linalg.norm(cand - hip_lo, axis=1)
        feas = in_radius & (d_td >= l_min) & (d_td <= l_max) & (d_lo >= l_min) & (d_lo <= l_max)

        # --- hard: flight-time reach (config tamols.max_foot_speed — round-4
        # chasm postmortem: the planner selected a 0.4 m hop with 0.2 s of
        # swing left and the executed foot landed ~20 cm short). A candidate
        # is reachable only if the remaining swing time covers its xy distance
        # from the foot's CURRENT position at the achievable mean foot speed;
        # an all-infeasible leg falls through to the fallback ("land on known
        # ground now, hop next swing with full time"). <= 0 disables.
        if tp.max_foot_speed > 0.0:
            d_fly = jnp.sqrt((cand_xy[:, 0] - foot_now[0]) ** 2
                             + (cand_xy[:, 1] - foot_now[1]) ** 2)
            feas = feas & (d_fly <= tp.max_foot_speed * t_remain)

        # --- hard: lateral lane (leg-crossing guard, beyond the reference). A
        # candidate across the body centerline (in the yaw-aligned frame) would
        # cross the stance legs — on sparse terrain the deviation-cost argmin
        # otherwise happily parks BOTH same-axle feet on one stone (stance-width
        # collapse) or splits them across lanes. Margin in meters; <=0 disables.
        if tp.lateral_margin > 0.0:
            c_y, s_y = jnp.cos(hm.yaw), jnp.sin(hm.yaw)
            rel_b = cand_xy - base_pos[:2]
            y_h = -s_y * rel_b[:, 0] + c_y * rel_b[:, 1]
            feas = feas & (side * y_h >= tp.lateral_margin)

        # --- hard: foot separation (collision with the other feet). Base sway
        # can otherwise double-book one stone for two legs — measured: RR landed
        # ON RL's foot mid-field. The reference scores legs independently and
        # has no such exclusion. <=0 disables.
        if tp.foot_separation > 0.0:
            d_feet = jnp.linalg.norm(
                cand_xy[:, None, :] - other_feet[None, :, :2], axis=-1)  # (M, 3)
            feas = feas & jnp.all(d_feet >= tp.foot_separation, axis=1)

        # --- hard: leg-terrain collision along the hip->foot segment (:397-420).
        alphas = jnp.linspace(0.2, 0.8, 5)
        p_leg = hip[None, None, :] * (1 - alphas)[:, None, None] + cand[None, :, :] * alphas[:, None, None]
        ground = lookup_nearest(hm, p_leg[..., :2])  # (5, M) raw grid z
        collide = jnp.any(p_leg[..., 2] < ground + 0.02, axis=0)
        feas = feas & ~collide

        # --- soft: edge avoidance (:422-466).
        delta = tp.gradient_delta
        hpx = lookup_nearest(hm, cand_xy + jnp.array([delta, 0.0])) + z_off
        hmx = lookup_nearest(hm, cand_xy + jnp.array([-delta, 0.0])) + z_off
        hpy = lookup_nearest(hm, cand_xy + jnp.array([0.0, delta])) + z_off
        hmy = lookup_nearest(hm, cand_xy + jnp.array([0.0, -delta])) + z_off
        grad = jnp.sqrt(((hpx - hmx) / (2 * delta)) ** 2 + ((hpy - hmy) / (2 * delta)) ** 2)
        edge = jnp.maximum(grad - tp.slope_threshold, 0.0) * tp.weight_edge_avoidance

        # --- soft: roughness = detrended variance of the 3x3 patch (:468-521).
        offs = jnp.asarray([[i * delta, j * delta] for i in (-1, 0, 1) for j in (-1, 0, 1)],
                           jnp.float32)  # (9, 2)
        patch = lookup_nearest(hm, cand_xy[:, None, :] + offs[None, :, :]) + z_off  # (M, 9)
        resid = patch @ Pproj.T
        rough = jnp.mean(resid * resid, axis=1) * tp.weight_roughness

        # --- hard: full-foot support (beyond the reference). A candidate whose
        # +-gradient_delta patch spans more than support_margin of height sits on
        # a ledge/rim: part of the foot would hang off (e.g. the rim of a
        # stepping stone, where the reference's edge term is blind — a 5 cm
        # stone over a 8 cm central difference is slope 0.625, UNDER the 0.7
        # slope_threshold). Rim cells both sides of the discontinuity are
        # rejected, so landings commit to the stone top or the clean deck.
        if tp.support_margin < 1.0:
            # Span of the plane-DETRENDED patch: zero on any smooth slope (a 15
            # deg ramp's raw +-delta span is ~0.030 and would trip the margin),
            # unchanged on a rim/ledge discontinuity.
            span = jnp.max(resid, axis=1) - jnp.min(resid, axis=1)
            feas = feas & (span <= tp.support_margin)

        # --- soft: rim proximity (paired with support_margin). The hard mask
        # only needs the +-delta patch flat, so the argmin (pulled by the
        # deviation cost) settles on the FIRST feasible cell past a rim; any
        # tracking error then lands the foot back on the ledge. Penalizing
        # height span over a wider ring (+-2*delta) pushes the choice toward
        # stone/pocket interiors, buying ~one cell of landing margin.
        support_soft = 0.0
        if tp.support_margin < 1.0 and tp.weight_support > 0.0:
            # Same 3x3 patch geometry at 2*delta (the plane projector is
            # invariant to uniform scaling of the patch positions), detrended so
            # smooth slopes cost nothing but nearby ledges do.
            ring = lookup_nearest(hm, cand_xy[:, None, :] + 2.0 * offs[None, :, :]) + z_off
            resid2 = ring @ Pproj.T
            span2 = jnp.max(resid2, axis=1) - jnp.min(resid2, axis=1)
            support_soft = jnp.maximum(span2 - tp.support_margin, 0.0) \
                * tp.weight_support

        # --- soft: deviation from seed (3D, reference :344).
        dev = jnp.sum((cand - seed) ** 2, axis=1) * tp.weight_deviation

        # --- soft: nominal kinematics (:523-553).
        diffn = hip - (cand + jnp.array([0.0, 0.0, tp.h_des]))
        nominal = jnp.sum(diffn * diffn, axis=1) * tp.weight_nominal_kinematic

        # --- soft: reference-velocity tracking (x only, :555-609).
        vx = base_vel[0]
        dx = cand[:, 0] - seed[0]
        vel_mag = jnp.linalg.norm(base_vel[:2])
        oppose = ((vx > 0) & (dx < 0)) | ((vx < 0) & (dx > 0))
        track = jnp.where(vel_mag < 0.01, 0.0, jnp.where(oppose, dx * dx, 0.0)) \
            * tp.weight_reference_tracking

        # --- soft: trot stability via diagonal-support segment (:611-714).
        com_pred = base_pos[:2] + base_vel[:2] * tp.estimated_swing_time
        p1 = cand[:, :2]
        p2 = diag_foot[:2]
        v = p2[None, :] - p1
        w = com_pred[None, :] - p1
        vv = jnp.sum(v * v, axis=1)
        t = jnp.clip(jnp.sum(w * v, axis=1) / jnp.maximum(vv, 1e-8), 0.0, 1.0)
        t = jnp.where(vv < 1e-8, 0.0, t)
        closest = p1 + t[:, None] * v
        dist = jnp.linalg.norm(com_pred[None, :] - closest, axis=1)
        stab_pen = jnp.maximum(dist - tp.stability_margin, 0.0) ** 2
        stab = jnp.where(in_stance == 1.0, 0.0, stab_pen) * tp.weight_stability
        if not tp.stability_soft:
            stab = stab * 0.0  # soft penalty disabled (hard gate may still apply)
        if tp.stability_hard:
            feas = feas & ((dist <= tp.stability_margin) | (in_stance == 1.0))

        # --- soft: lattice progression (config min_advance — replaces round
        # 3's stride_pitch bimodal anchors, whose discounted "stay" anchor
        # deadlocked field entry; see config.py rationale). Candidates that do
        # not advance at least min_advance along the heading FROM THE CURRENT
        # FOOT pay quadratically — "stay" is never discounted — saturated at
        # min_advance^2 so that when nothing ahead is feasible all near cells
        # tie and the baseline costs decide. Gated on the IN-RADIUS height
        # span (the whole-window gate engaged while the foot was
        # still on the flat deck).
        prog = 0.0
        if tp.min_advance > 0.0:
            # Per-LEG gate: progression engages only when the CURRENT FOOT's
            # own neighbourhood spans deep gaps — i.e. the foot stands ON the
            # lattice (or at the deck edge, one stride from column 1). Gating
            # on the seed's whole sensing radius engaged while the feet were
            # still mid-deck and drove 0.35 m deck strides (measured: y-drift
            # + roll at the deck edge, worse than baseline) — exactly the
            # "anchor from a foot still on the deck" failure the round-3
            # postmortem forbids.
            d_foot2 = (cand_xy[:, 0] - own_foot[0]) ** 2 \
                + (cand_xy[:, 1] - own_foot[1]) ** 2
            near_foot = d_foot2 < tp.progression_foot_radius ** 2
            z_hi = jnp.max(jnp.where(near_foot, cand_z, -_BIG))
            z_lo = jnp.min(jnp.where(near_foot, cand_z, _BIG))
            on_lattice = (z_hi - z_lo) > tp.progression_gate_range
            dx_own = c_r * (cand_xy[:, 0] - own_foot[0]) \
                + s_r * (cand_xy[:, 1] - own_foot[1])
            short = jnp.clip(tp.min_advance - dx_own, 0.0, tp.min_advance)
            prog = jnp.where(on_lattice,
                             short * short * tp.weight_progression, 0.0)

        cost = edge + rough + dev + nominal + track + stab + support_soft + prog
        cost = jnp.where(feas, cost, _BIG)

        best = jnp.argmin(cost)
        best_cost = cost[best]
        any_feas = best_cost < _BIG
        best_cand = cand[best]

        # Fallback when nothing is feasible: the height-snapped seed
        # (reference :223-228) or — config tamols.fallback='foot', for gap
        # lattices — the leg's CURRENT foothold, which is known solid ground
        # (the drift-squeezed seed can sit on a rim or over a gap).
        if tp.fallback == "foot":
            fb_xy = own_foot[:2]
        else:
            fb_xy = seed[:2]
        fb = jnp.concatenate([fb_xy, (lookup_nearest(hm, fb_xy) + z_off)[None]])
        fh = jnp.where(any_feas, best_cand, fb)

        box = jnp.array([tp.constraint_box_dx, tp.constraint_box_dy, 0.0])
        return (fh, fh - box, fh + box, best_cost, any_feas)

    def adapt(hms: GridHeightMap, seeds, hips, base_pos, base_vel, current_contact,
              feet, own_anchor, t_remain=None):
        """``feet`` are the CURRENT foot positions (reference parity — they
        feed the stability diagonal, the foot-separation exclusion, and the
        flight-time reach gate). ``own_anchor`` is each leg's foothold
        IDENTITY — the lift-off position for swinging legs — consumed only by
        the gap-lattice extensions (progression cost, 'foot' fallback), which
        mean "where the leg stands", not "where it floats". Anchoring the
        stability diagonal too was measured to break trot adaptation (the
        diagonal PARTNER swings simultaneously). ``t_remain`` (4,) is each
        leg's remaining swing time for the max_foot_speed gate (None = no
        gate)."""
        if t_remain is None:
            t_remain = jnp.full(4, 1e3, jnp.float32)
        diag_feet = feet[_DIAG]
        sides = jnp.asarray(_Y_OFFSET_SIGN)
        # Per-leg (3, 3) stack of the OTHER legs' current feet.
        others = jnp.stack(
            [feet[np.array([j for j in range(4) if j != i])] for i in range(4)])
        fh, lo, hi, cost, feas = jax.vmap(
            _leg_adapt, in_axes=(0, 0, 0, 0, 0, None, None, 0, 0, 0, 0, 0)
        )(hms, seeds, hips, sides, others, base_pos, base_vel, current_contact,
          diag_feet, own_anchor, feet, t_remain)
        return TamolsResult(fh, lo, hi, cost, feas)

    return jax.jit(adapt)


class TamolsPlanner:
    """Host wrapper mirroring VisualFootholdAdaptation's API surface
    (initialized flag, reset at full stance, get_footholds_adapted —
    visual_foothold_adaptation.py:59-72)."""

    def __init__(self, cfg: Config, strategy: str | None = None):
        self.cfg = cfg
        self.strategy = strategy or cfg.sim.visual_foothold_adaptation
        self.adapt_fn = make_tamols_scorer(cfg, self.strategy) if self.strategy != "blind" else None
        self.initialized = False
        self.footholds_adaptation = None
        self.footholds_constraints = None

    def reset(self):
        self.initialized = False

    def compute_adaptation(self, hms, seeds, hips, base_pos, base_vel,
                           current_contact, feet, own_anchor=None, t_remain=None):
        anchor = feet if own_anchor is None else own_anchor
        if t_remain is None:
            t_remain = np.full(4, 1e3)  # no flight-time gate
        res = self.adapt_fn(hms, jnp.asarray(seeds, jnp.float32), jnp.asarray(hips, jnp.float32),
                            jnp.asarray(base_pos, jnp.float32), jnp.asarray(base_vel, jnp.float32),
                            jnp.asarray(current_contact, jnp.float32),
                            jnp.asarray(feet, jnp.float32),
                            jnp.asarray(anchor, jnp.float32),
                            jnp.asarray(t_remain, jnp.float32))
        self.footholds_adaptation = np.asarray(res.footholds)
        self.footholds_constraints = (np.asarray(res.constraints_lo), np.asarray(res.constraints_hi))
        self.last_seeds = np.asarray(seeds)  # observability (loggers/tests)
        self.last_feasible = np.asarray(res.feasible)
        self.initialized = True
        return res

    def get_footholds_adapted(self, reference_footholds):
        if not self.initialized:
            return reference_footholds, None
        return self.footholds_adaptation, self.footholds_constraints
