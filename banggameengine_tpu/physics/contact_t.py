"""Transposed (component-form) contact pipeline for large worlds.

The general pipeline (:mod:`narrowphase` + :mod:`solver`) carries vectors as
``[..., 3]``-minor arrays.  This module is the same math written
**component-form with the body axis last** — every intermediate is
``[slots, N]`` with N the dense minor axis.

Scope: box-box + implicit ground plane (the 10k-body stress config), plus — when ``shape_type`` is passed — solid CAPSULES in the
same component form (capsule-box via 3 sampled spheres, capsule-capsule via
segment closest points, capsule-ground via the two end spheres), so the
flat many-world path no longer excludes capsule rigid bodies (round-4
verdict #3).  The math mirrors ``narrowphase.box_box_sat_mtv`` /
``pair_contacts`` / ``ground_contacts`` and
``solver.solve_contacts_unified`` exactly (same constants, same iteration
scheme), replacing Bullet's dispatcher + sequential impulse solver
(``PhysicsSystem.cpp:124-128``) at scale.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from banggameengine_tpu import math3d
from banggameengine_tpu.physics.solver import (
    BAUMGARTE,
    PENETRATION_SLOP,
    RESTITUTION_THRESHOLD,
    WARM_START_FACTOR,
)
from banggameengine_tpu.state import FEAT_STRIDE

Array = jax.Array

_LATERAL_MARGIN = 0.02   # == narrowphase._LATERAL_MARGIN
K_BB = 17                # 8 + 8 corners + SAT-center fallback
K_MIX = 7                # 3 cap-box + 3 box-cap + 1 cap-cap slots
K_GROUND = 8
_CAP_TS = (0.0, 0.5, 1.0)   # capsule sphere-sample params (narrowphase)

# the 8 corner sign combinations of a box (x, y, z in {-1, +1})
_SIGNS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
          for sz in (-1.0, 1.0)]


def _rot_comps(quat: Array):
    """quat [N,4] -> tuple of 9 arrays [N]: row-major R[i][j]."""
    r = math3d.quat_to_mat3(quat)
    return tuple(r[:, i, j] for i in range(3) for j in range(3))


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _sign_eps(x, eps=1e-5):
    return jnp.where(x > eps, 1.0, jnp.where(x < -eps, -1.0, 0.0))


def box_contacts_t(
    pos: Array,        # f32[N,3]
    quat: Array,       # f32[N,4]
    half: Array,       # f32[N,3] box half extents
    nb_idx: Array,     # i32[N,K] partner ids (-1 padded)
    nb_valid: Array,   # bool[N,K]
    ground_valid: Array,  # bool[N] row may contact the ground plane
    budget: int = 12,
    orig_id: Array | None = None,  # i32[N] original (unsorted) body ids
    shape_type: Array | None = None,  # i8[N] SHAPE_BOX/SHAPE_CAPSULE
):
    """Box-box SAT manifolds + ground contacts, compacted per body.

    Returns transposed contact arrays, everything [C, N] (C = budget):
    (cb partner ids with -1 = static/ground, point xyz, normal xyz from
    partner toward row body, depth, valid, overflow).  When ``orig_id``
    is given (the Morton-sort permutation's original ids), an extra
    ``c_feat`` [C, N] of persistent-cache feature ids is appended:
    ``(orig_partner + 1) * FEAT_STRIDE + candidate_slot`` for pair
    contacts, bare corner index for ground — identical to the dense
    path's scheme so the cache is path-portable.

    With ``shape_type`` (mixed scenes), ``half`` is (radius, half_height,
    0) for capsule rows and 7 extra candidate slots per pair carry the
    capsule cases (3 cap-box sphere samples, 3 box-cap, 1 cap-cap),
    mirroring ``narrowphase.pair_contacts`` slots 17..20; capsule ground
    contacts use the two end spheres (``narrowphase.ground_contacts``).
    """
    from banggameengine_tpu.state import SHAPE_CAPSULE

    n = pos.shape[0]
    k = nb_idx.shape[1]
    want_feat = orig_id is not None
    mixed = shape_type is not None

    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    hx, hy, hz = half[:, 0], half[:, 1], half[:, 2]
    a = _rot_comps(quat)   # a[3*i+j] = Ra[i][j], shape [N]

    idx_t = nb_idx.T                        # [K,N]
    ok_t = nb_valid.T
    safe = jnp.maximum(idx_t, 0)

    # partner components in ONE channel-major gather: take(..., axis=1) of
    # the [15, N] table with [K, N] indices lands [15, K, N] with every
    # attribute a contiguous [K, N] plane, instead of strided columns of a
    # row-major [K, N, 16] gather or one gather per array.  The barrier
    # pins the gather to run once.
    rows = [px, py, pz, hx, hy, hz] + list(a)
    if want_feat:
        rows.append(orig_id.astype(jnp.float32))
    if mixed:
        a_cap_n = shape_type == SHAPE_CAPSULE           # [N]
        rows.append(a_cap_n.astype(jnp.float32))
    packed_t = jnp.stack(rows)                          # [15(+1)(+1), N]
    g = jax.lax.optimization_barrier(
        jnp.take(packed_t, safe, axis=1))               # [., K, N]
    qbx, qby, qbz = g[0], g[1], g[2]
    gx, gy, gz = g[3], g[4], g[5]
    b = tuple(g[6 + i] for i in range(9))               # Rb comps, [K,N]
    partner_orig = g[15] if want_feat else None         # f32 [K,N]
    if mixed:
        b_cap = g[16 if want_feat else 15] > 0.5        # bool [K,N]
        a_cap = jnp.broadcast_to(a_cap_n[None, :], idx_t.shape)
        a_box_m = ~a_cap
        b_box_m = ~b_cap

    # ---- SAT: 15 axes, component form ---------------------------------
    # R = Ra^T Rb  (r[i][j] = sum_k Ra[k][i] Rb[k][j]), [K,N]
    r = [[a[0 + i] * b[0 + j] + a[3 + i] * b[3 + j] + a[6 + i] * b[6 + j]
          for j in range(3)] for i in range(3)]
    ar = [[jnp.abs(r[i][j]) for j in range(3)] for i in range(3)]

    twx, twy, twz = qbx - px, qby - py, qbz - pz       # t in world
    # t in a frame: ta_i = Ra col_i . t = sum_k Ra[k][i] t_k
    ta = [a[0 + i] * twx + a[3 + i] * twy + a[6 + i] * twz for i in range(3)]
    tb = [b[0 + i] * twx + b[3 + i] * twy + b[6 + i] * twz for i in range(3)]

    ha = [jnp.broadcast_to(c, idx_t.shape) for c in (hx, hy, hz)]
    hb = [gx, gy, gz]

    best_d = jnp.full(idx_t.shape, jnp.inf, jnp.float32)
    bnx = jnp.zeros(idx_t.shape, jnp.float32)
    bny = jnp.zeros(idx_t.shape, jnp.float32)
    bnz = jnp.zeros(idx_t.shape, jnp.float32)
    best_ax = jnp.zeros(idx_t.shape, jnp.int32)
    separated = jnp.zeros(idx_t.shape, bool)

    def consider(ov, axx, axy, axz, axis_ok, axis_id, best):
        best_d, bnx, bny, bnz, best_ax, separated = best
        separated = separated | (axis_ok & (ov < 0.0))
        take = axis_ok & (ov < best_d)
        best_d = jnp.where(take, ov, best_d)
        bnx = jnp.where(take, axx, bnx)
        bny = jnp.where(take, axy, bny)
        bnz = jnp.where(take, axz, bnz)
        best_ax = jnp.where(take, axis_id, best_ax)
        return best_d, bnx, bny, bnz, best_ax, separated

    best = (best_d, bnx, bny, bnz, best_ax, separated)
    ones = jnp.ones(idx_t.shape, bool)
    for i in range(3):      # A face axes (world = Ra column i)
        ov = (ha[i] + hb[0] * ar[i][0] + hb[1] * ar[i][1] + hb[2] * ar[i][2]
              - jnp.abs(ta[i]))
        best = consider(ov, a[0 + i][None] * jnp.ones_like(ov),
                        a[3 + i][None] * jnp.ones_like(ov),
                        a[6 + i][None] * jnp.ones_like(ov), ones, i, best)
    for j in range(3):      # B face axes (world = Rb column j)
        ov = (ha[0] * ar[0][j] + ha[1] * ar[1][j] + ha[2] * ar[2][j] + hb[j]
              - jnp.abs(tb[j]))
        best = consider(ov, b[0 + j], b[3 + j], b[6 + j], ones, 3 + j, best)
    for i in range(3):      # cross axes A_i x B_j
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            ln = jnp.sqrt(jnp.maximum(1.0 - r[i][j] ** 2, 0.0))
            axis_ok = ln > 1e-4
            inv_ln = 1.0 / jnp.maximum(ln, 1e-4)
            ra_ij = ha[i1] * ar[i2][j] + ha[i2] * ar[i1][j]
            rb_ij = hb[j1] * ar[i][j2] + hb[j2] * ar[i][j1]
            dist = jnp.abs(ta[i2] * r[i1][j] - ta[i1] * r[i2][j])
            ov = (ra_ij + rb_ij - dist) * inv_ln
            # axis = (Ra col i) x (Rb col j), then normalized by inv_ln
            cx, cy, cz = _cross(
                a[0 + i][None] * jnp.ones_like(ov), a[3 + i], a[6 + i],
                b[0 + j], b[3 + j], b[6 + j],
            )
            best = consider(ov, cx * inv_ln, cy * inv_ln, cz * inv_ln,
                            axis_ok, 6 + 3 * i + j, best)
    sat_d, bnx, bny, bnz, best_ax, separated = best

    # orient the normal from b toward a: axis . (-t) > 0
    sgn = jnp.sign(-(bnx * twx + bny * twy + bnz * twz))
    sgn = jnp.where(sgn == 0.0, 1.0, sgn)
    bnx, bny, bnz = bnx * sgn, bny * sgn, bnz * sgn
    overlap = ok_t & ~separated & jnp.isfinite(sat_d)
    if mixed:
        overlap = overlap & a_box_m & b_box_m
    sat_d = jnp.where(overlap, sat_d, 0.0)

    # ---- manifold candidates (17 slots per pair) ------------------------
    # support extents of each box along n
    proj_a = (ha[0] * jnp.abs(a[0][None] * bnx + a[3] * bny + a[6] * bnz)
              + ha[1] * jnp.abs(a[1][None] * bnx + a[4] * bny + a[7] * bnz)
              + ha[2] * jnp.abs(a[2][None] * bnx + a[5] * bny + a[8] * bnz))
    proj_b = (hb[0] * jnp.abs(b[0] * bnx + b[3] * bny + b[6] * bnz)
              + hb[1] * jnp.abs(b[1] * bnx + b[4] * bny + b[7] * bnz)
              + hb[2] * jnp.abs(b[2] * bnx + b[5] * bny + b[8] * bnz))
    plane_b = (bnx * qbx + bny * qby + bnz * qbz) + proj_b
    plane_a = (bnx * px + bny * py + bnz * pz) - proj_a

    # corners of a: [8][N] components (per body, shared across K)
    ca = []
    for sx, sy, sz in _SIGNS:
        ox, oy, oz = sx * hx, sy * hy, sz * hz
        ca.append((
            px + a[0] * ox + a[1] * oy + a[2] * oz,
            py + a[3] * ox + a[4] * oy + a[5] * oz,
            pz + a[6] * ox + a[7] * oy + a[8] * oz,
        ))
    # corners of b: [8][K,N]
    cbn = []
    for sx, sy, sz in _SIGNS:
        ox, oy, oz = sx * gx, sy * gy, sz * gz
        cbn.append((
            qbx + b[0] * ox + b[1] * oy + b[2] * oz,
            qby + b[3] * ox + b[4] * oy + b[5] * oz,
            qbz + b[6] * ox + b[7] * oy + b[8] * oz,
        ))

    slots_pt = []     # each: (x,y,z) [K,N]
    slots_depth = []
    slots_valid = []

    any_corner = jnp.zeros(idx_t.shape, bool)
    for cx, cy, cz in ca:      # a's corners against b's slab + volume
        d = plane_b - (bnx * cx + bny * cy + bnz * cz)
        # corner in b's frame
        dxw, dyw, dzw = cx - qbx, cy - qby, cz - qbz
        lb0 = b[0] * dxw + b[3] * dyw + b[6] * dzw
        lb1 = b[1] * dxw + b[4] * dyw + b[7] * dzw
        lb2 = b[2] * dxw + b[5] * dyw + b[8] * dzw
        inside = ((jnp.abs(lb0) <= hb[0] + _LATERAL_MARGIN)
                  & (jnp.abs(lb1) <= hb[1] + _LATERAL_MARGIN)
                  & (jnp.abs(lb2) <= hb[2] + _LATERAL_MARGIN))
        v = overlap & inside & (d <= sat_d + _LATERAL_MARGIN)
        slots_pt.append((jnp.broadcast_to(cx, idx_t.shape),
                         jnp.broadcast_to(cy, idx_t.shape),
                         jnp.broadcast_to(cz, idx_t.shape)))
        slots_depth.append(d)
        slots_valid.append(v)
        any_corner |= v
    for cx, cy, cz in cbn:     # b's corners against a's slab + volume
        d = (bnx * cx + bny * cy + bnz * cz) - plane_a
        dxw, dyw, dzw = cx - px, cy - py, cz - pz
        la0 = a[0] * dxw + a[3] * dyw + a[6] * dzw
        la1 = a[1] * dxw + a[4] * dyw + a[7] * dzw
        la2 = a[2] * dxw + a[5] * dyw + a[8] * dzw
        inside = ((jnp.abs(la0) <= ha[0] + _LATERAL_MARGIN)
                  & (jnp.abs(la1) <= ha[1] + _LATERAL_MARGIN)
                  & (jnp.abs(la2) <= ha[2] + _LATERAL_MARGIN))
        v = overlap & inside & (d <= sat_d + _LATERAL_MARGIN)
        slots_pt.append((cx, cy, cz))
        slots_depth.append(d)
        slots_valid.append(v)
        any_corner |= v

    # Slot 16 — the non-corner contact.  When the winning axis is a cross
    # axis A_i x B_j the touching features are edges: compute their actual
    # closest points (mirrors narrowphase.pair_contacts' edge-edge path);
    # face-axis winners with no corner keep the support-midpoint fallback.
    na0 = a[0][None] * bnx + a[3] * bny + a[6] * bnz   # Ra^T n comps
    na1 = a[1][None] * bnx + a[4] * bny + a[7] * bnz
    na2 = a[2][None] * bnx + a[5] * bny + a[8] * bnz
    sg_a = (_sign_eps(na0), _sign_eps(na1), _sign_eps(na2))
    sa0, sa1, sa2 = sg_a[0] * ha[0], sg_a[1] * ha[1], sg_a[2] * ha[2]
    supax = px - (a[0] * sa0 + a[1] * sa1 + a[2] * sa2)
    supay = py - (a[3] * sa0 + a[4] * sa1 + a[5] * sa2)
    supaz = pz - (a[6] * sa0 + a[7] * sa1 + a[8] * sa2)
    nb0 = b[0] * bnx + b[3] * bny + b[6] * bnz
    nb1 = b[1] * bnx + b[4] * bny + b[7] * bnz
    nb2 = b[2] * bnx + b[5] * bny + b[8] * bnz
    sg_b = (_sign_eps(nb0), _sign_eps(nb1), _sign_eps(nb2))
    sb0, sb1, sb2 = sg_b[0] * hb[0], sg_b[1] * hb[1], sg_b[2] * hb[2]
    supbx = qbx + (b[0] * sb0 + b[1] * sb1 + b[2] * sb2)
    supby = qby + (b[3] * sb0 + b[4] * sb1 + b[5] * sb2)
    supbz = qbz + (b[6] * sb0 + b[7] * sb1 + b[8] * sb2)

    is_edge = best_ax >= 6
    ei = jnp.clip((best_ax - 6) // 3, 0, 2)
    ej = jnp.clip((best_ax - 6) % 3, 0, 2)

    def pick(comps3, sel):
        return jnp.where(sel == 0, comps3[0],
                         jnp.where(sel == 1, comps3[1], comps3[2]))

    # edge directions: column ei of Ra, column ej of Rb (components;
    # the [N] Ra comps broadcast against the [K,N] selector)
    uax = pick((a[0][None], a[1][None], a[2][None]), ei)
    uay = pick((a[3][None], a[4][None], a[5][None]), ei)
    uaz = pick((a[6][None], a[7][None], a[8][None]), ei)
    ubx = pick((b[0], b[1], b[2]), ej)
    uby = pick((b[3], b[4], b[5]), ej)
    ubz = pick((b[6], b[7], b[8]), ej)
    # edge centers: support corners with the edge-axis component zeroed
    za = (jnp.where(ei == 0, 0.0, sa0), jnp.where(ei == 1, 0.0, sa1),
          jnp.where(ei == 2, 0.0, sa2))
    pacx = px - (a[0] * za[0] + a[1] * za[1] + a[2] * za[2])
    pacy = py - (a[3] * za[0] + a[4] * za[1] + a[5] * za[2])
    pacz = pz - (a[6] * za[0] + a[7] * za[1] + a[8] * za[2])
    zb = (jnp.where(ej == 0, 0.0, sb0), jnp.where(ej == 1, 0.0, sb1),
          jnp.where(ej == 2, 0.0, sb2))
    pbcx = qbx + (b[0] * zb[0] + b[1] * zb[1] + b[2] * zb[2])
    pbcy = qby + (b[3] * zb[0] + b[4] * zb[1] + b[5] * zb[2])
    pbcz = qbz + (b[6] * zb[0] + b[7] * zb[1] + b[8] * zb[2])
    wx_, wy_, wz_ = pacx - pbcx, pacy - pbcy, pacz - pbcz
    cc_ = _dot(uax, uay, uaz, ubx, uby, ubz)
    a1_ = _dot(uax, uay, uaz, wx_, wy_, wz_)
    b1_ = _dot(ubx, uby, ubz, wx_, wy_, wz_)
    den = jnp.maximum(1.0 - cc_ * cc_, 1e-8)
    t_b = (b1_ - cc_ * a1_) / den
    s_a = cc_ * t_b - a1_
    ha_i = pick((ha[0], ha[1], ha[2]), ei)
    hb_j = pick((hb[0], hb[1], hb[2]), ej)
    s_a = jnp.clip(s_a, -ha_i, ha_i)
    t_b = jnp.clip(t_b, -hb_j, hb_j)
    edge_x = 0.5 * (pacx + s_a * uax + pbcx + t_b * ubx)
    edge_y = 0.5 * (pacy + s_a * uay + pbcy + t_b * uby)
    edge_z = 0.5 * (pacz + s_a * uaz + pbcz + t_b * ubz)

    slots_pt.append((
        jnp.where(is_edge, edge_x, 0.5 * (supax + supbx)),
        jnp.where(is_edge, edge_y, 0.5 * (supay + supby)),
        jnp.where(is_edge, edge_z, 0.5 * (supaz + supbz)),
    ))
    slots_depth.append(sat_d)
    slots_valid.append(overlap & (is_edge | ~any_corner))

    # ---- mixed capsule slots (17..23), component form --------------------
    slots_n = None
    if mixed:
        # slots 0..16 share the SAT normal; mixed slots carry their own,
        # so stage 1 compacts normals alongside points instead of
        # broadcasting the pair normal
        slots_n = [(bnx, bny, bnz)] * K_BB
        # capsule core segments: local +Y column of R scaled by half_height
        # (= half[:,1]; radius = half[:,0]) — sh.capsule_segment in comps
        a_axx, a_axy, a_axz = a[1] * hy, a[4] * hy, a[7] * hy   # [N]
        b_axx, b_axy, b_axz = b[1] * gy, b[4] * gy, b[7] * gy   # [K,N]
        rad_a = hx                                              # [N]
        rad_b = gx                                              # [K,N]

        def sphere_vs_box_local(lb0, lb1, lb2, hb0, hb1, hb2):
            """Closest point on a local-frame box to local point lb
            (sh.closest_point_on_box in comps) -> (p0,p1,p2, n0,n1,n2,
            sdist)."""
            cl0 = jnp.clip(lb0, -hb0, hb0)
            cl1 = jnp.clip(lb1, -hb1, hb1)
            cl2 = jnp.clip(lb2, -hb2, hb2)
            d0, d1, d2 = lb0 - cl0, lb1 - cl1, lb2 - cl2
            dist = jnp.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
            outside = dist > 1e-9
            inv = 1.0 / jnp.maximum(dist, 1e-9)
            no0, no1, no2 = d0 * inv, d1 * inv, d2 * inv
            # inside: nearest face
            f0, f1, f2 = hb0 - jnp.abs(lb0), hb1 - jnp.abs(lb1), \
                hb2 - jnp.abs(lb2)
            min_clear = jnp.minimum(jnp.minimum(f0, f1), f2)
            # argmin tie-break: first axis wins (matches jnp.argmin)
            ax0 = (f0 <= f1) & (f0 <= f2)
            ax1 = ~ax0 & (f1 <= f2)
            ax2 = ~ax0 & ~ax1

            def sgn(x):
                s = jnp.sign(x)
                return jnp.where(s == 0.0, 1.0, s)

            ni0 = jnp.where(ax0, sgn(lb0), 0.0)
            ni1 = jnp.where(ax1, sgn(lb1), 0.0)
            ni2 = jnp.where(ax2, sgn(lb2), 0.0)
            pi0 = lb0 + ni0 * min_clear
            pi1 = lb1 + ni1 * min_clear
            pi2 = lb2 + ni2 * min_clear
            p0 = jnp.where(outside, cl0, pi0)
            p1 = jnp.where(outside, cl1, pi1)
            p2 = jnp.where(outside, cl2, pi2)
            n0 = jnp.where(outside, no0, ni0)
            n1 = jnp.where(outside, no1, ni1)
            n2 = jnp.where(outside, no2, ni2)
            sdist = jnp.where(outside, dist, -min_clear)
            return p0, p1, p2, n0, n1, n2, sdist

        # cap(a) vs box(b): 3 samples of a's segment against b, in b frame
        gate_ab = ok_t & a_cap & b_box_m
        for t_ in _CAP_TS:
            s_ = 2.0 * t_ - 1.0     # seg0 + (seg1-seg0)*t = pos + axis*s
            cx_ = px + a_axx * s_   # [N] -> broadcasts to [K,N]
            cy_ = py + a_axy * s_
            cz_ = pz + a_axz * s_
            dxw, dyw, dzw = cx_ - qbx, cy_ - qby, cz_ - qbz
            lb0 = b[0] * dxw + b[3] * dyw + b[6] * dzw
            lb1 = b[1] * dxw + b[4] * dyw + b[7] * dzw
            lb2 = b[2] * dxw + b[5] * dyw + b[8] * dzw
            p0, p1, p2, n0, n1, n2, sd = sphere_vs_box_local(
                lb0, lb1, lb2, hb[0], hb[1], hb[2])
            # back to world (normal out of box b = from b toward a)
            nwx = b[0] * n0 + b[1] * n1 + b[2] * n2
            nwy = b[3] * n0 + b[4] * n1 + b[5] * n2
            nwz = b[6] * n0 + b[7] * n1 + b[8] * n2
            pwx = qbx + b[0] * p0 + b[1] * p1 + b[2] * p2
            pwy = qby + b[3] * p0 + b[4] * p1 + b[5] * p2
            pwz = qbz + b[6] * p0 + b[7] * p1 + b[8] * p2
            d_ = rad_a[None, :] - sd
            slots_pt.append((pwx, pwy, pwz))
            slots_depth.append(d_)
            slots_valid.append(gate_ab)
            slots_n.append((nwx, nwy, nwz))
        # box(a) vs cap(b): 3 samples of b's segment against box a
        gate_ba = ok_t & a_box_m & b_cap
        for t_ in _CAP_TS:
            s_ = 2.0 * t_ - 1.0
            cx_ = qbx + b_axx * s_  # [K,N]
            cy_ = qby + b_axy * s_
            cz_ = qbz + b_axz * s_
            dxw, dyw, dzw = cx_ - px, cy_ - py, cz_ - pz
            la0 = a[0] * dxw + a[3] * dyw + a[6] * dzw
            la1 = a[1] * dxw + a[4] * dyw + a[7] * dzw
            la2 = a[2] * dxw + a[5] * dyw + a[8] * dzw
            p0, p1, p2, n0, n1, n2, sd = sphere_vs_box_local(
                la0, la1, la2, ha[0], ha[1], ha[2])
            # normal out of box a flipped: from b(cap) toward a(box)
            nwx = -(a[0] * n0 + a[1] * n1 + a[2] * n2)
            nwy = -(a[3] * n0 + a[4] * n1 + a[5] * n2)
            nwz = -(a[6] * n0 + a[7] * n1 + a[8] * n2)
            pwx = px + a[0] * p0 + a[1] * p1 + a[2] * p2
            pwy = py + a[3] * p0 + a[4] * p1 + a[5] * p2
            pwz = pz + a[6] * p0 + a[7] * p1 + a[8] * p2
            d_ = rad_b - sd
            slots_pt.append((pwx, pwy, pwz))
            slots_depth.append(d_)
            slots_valid.append(gate_ba)
            slots_n.append((nwx, nwy, nwz))
        # cap-cap: closest points between core segments (Ericson 5.1.9,
        # sh.closest_segment_segment in comps; segment = p0 -> p1 so
        # d = 2*axis, r = p1a - p1b with p1 = pos - axis)
        p1ax, p1ay, p1az = px - a_axx, py - a_axy, pz - a_axz
        p1bx, p1by, p1bz = qbx - b_axx, qby - b_axy, qbz - b_axz
        d1x, d1y, d1z = 2.0 * a_axx, 2.0 * a_axy, 2.0 * a_axz
        d2x, d2y, d2z = 2.0 * b_axx, 2.0 * b_axy, 2.0 * b_axz
        rx_, ry_, rz_ = p1ax - p1bx, p1ay - p1by, p1az - p1bz
        aa = d1x * d1x + d1y * d1y + d1z * d1z
        ee = d2x * d2x + d2y * d2y + d2z * d2z
        ff = d2x * rx_ + d2y * ry_ + d2z * rz_
        cc2 = d1x * rx_ + d1y * ry_ + d1z * rz_
        bb2 = d1x * d2x + d1y * d2y + d1z * d2z
        den2 = aa * ee - bb2 * bb2
        s2 = jnp.where(
            den2 > 1e-12,
            jnp.clip((bb2 * ff - cc2 * ee) / jnp.maximum(den2, 1e-12),
                     0.0, 1.0), 0.0)
        t2 = (bb2 * s2 + ff) / jnp.maximum(ee, 1e-12)
        t2c = jnp.clip(t2, 0.0, 1.0)
        s2 = jnp.clip((bb2 * t2c - cc2) / jnp.maximum(aa, 1e-12), 0.0, 1.0)
        c1x_ = p1ax + d1x * s2
        c1y_ = p1ay + d1y * s2
        c1z_ = p1az + d1z * s2
        c2x_ = p1bx + d2x * t2c
        c2y_ = p1by + d2y * t2c
        c2z_ = p1bz + d2z * t2c
        dlx, dly, dlz = c1x_ - c2x_, c1y_ - c2y_, c1z_ - c2z_
        segd = jnp.sqrt(dlx * dlx + dly * dly + dlz * dlz)
        has_dir = segd > 1e-9
        invd = 1.0 / jnp.maximum(segd, 1e-9)
        ccnx = jnp.where(has_dir, dlx * invd, 0.0)
        ccny = jnp.where(has_dir, dly * invd, 1.0)
        ccnz = jnp.where(has_dir, dlz * invd, 0.0)
        slots_pt.append((0.5 * (c1x_ + c2x_), 0.5 * (c1y_ + c2y_),
                         0.5 * (c1z_ + c2z_)))
        slots_depth.append(rad_a[None, :] + rad_b - segd)
        slots_valid.append(ok_t & a_cap & b_cap)
        slots_n.append((ccnx, ccny, ccnz))

    # ---- stage 1: cap each pair's manifold at 4 points -------------------
    # (Bullet's own persistent-manifold cap, btPersistentManifold
    # MANIFOLD_CACHE_SIZE=4).  Capping over the 17 candidate slots BEFORE
    # the global budget compaction shrinks stage 2 from [K*17+8, N] rows to
    # [K*4+4, N] — the compaction was the dominant cost of this function.
    cap = 4
    n_slots = len(slots_pt)                         # 17, or 24 mixed
    ptx3 = jnp.stack([s[0] for s in slots_pt])      # [n_slots,K,N]
    pty3 = jnp.stack([s[1] for s in slots_pt])
    ptz3 = jnp.stack([s[2] for s in slots_pt])
    dep3 = jnp.stack(slots_depth)
    val3 = jnp.stack(slots_valid) & (dep3 > 0.0)
    cnt3 = jnp.sum(val3.astype(jnp.int32), axis=0)  # [K,N]
    dest3 = jnp.cumsum(val3.astype(jnp.int32), axis=0) - 1
    dest3 = jnp.where(val3, dest3, -1)

    def cap_take(arr):
        return jnp.stack([
            jnp.sum(jnp.where(dest3 == c, arr, 0), axis=0)
            for c in range(cap)
        ])                                          # [cap,K,N]

    cval = (jax.lax.broadcasted_iota(jnp.int32, (cap, k, n), 0)
            < jnp.minimum(cnt3, cap)[None])
    pair_overflow = jnp.sum(jnp.maximum(cnt3 - cap, 0))

    m_pair = k * cap
    ptx = cap_take(ptx3).reshape(m_pair, n)
    pty = cap_take(pty3).reshape(m_pair, n)
    ptz = cap_take(ptz3).reshape(m_pair, n)
    dep = cap_take(dep3).reshape(m_pair, n)
    val = cval.reshape(m_pair, n)
    if mixed:
        # mixed slots carry per-slot normals: compact them like points
        nx3 = jnp.stack([sn[0] * jnp.ones_like(dep3[0]) for sn in slots_n])
        ny3 = jnp.stack([sn[1] * jnp.ones_like(dep3[0]) for sn in slots_n])
        nz3 = jnp.stack([sn[2] * jnp.ones_like(dep3[0]) for sn in slots_n])
        nxs = cap_take(nx3).reshape(m_pair, n)
        nys = cap_take(ny3).reshape(m_pair, n)
        nzs = cap_take(nz3).reshape(m_pair, n)
    else:
        # normals are per-pair constants (SAT axis): broadcast, don't
        # compact
        nxs = jnp.broadcast_to(bnx, (cap, k, n)).reshape(m_pair, n)
        nys = jnp.broadcast_to(bny, (cap, k, n)).reshape(m_pair, n)
        nzs = jnp.broadcast_to(bnz, (cap, k, n)).reshape(m_pair, n)
    prt = jnp.broadcast_to(idx_t, (cap, k, n)).reshape(m_pair, n)
    if want_feat:
        # preserved ORIGINAL candidate-slot ids (stable geometric features)
        slot3 = jax.lax.broadcasted_iota(
            jnp.int32, (n_slots, k, n), 0).astype(jnp.float32)
        cap_slot = cap_take(slot3).reshape(m_pair, n)
        feat = ((jnp.broadcast_to(partner_orig, (cap, k, n))
                 .reshape(m_pair, n) + 1.0) * float(FEAT_STRIDE) + cap_slot)

    # ground: 8 corners of each box against y=0 (normal +Y), same cap — a
    # resting box touches with at most 4 corners
    g_ptx3 = jnp.stack([c[0] for c in ca])          # [8,N]
    g_pty3 = jnp.stack([c[1] for c in ca])
    g_ptz3 = jnp.stack([c[2] for c in ca])
    g_dep3 = -g_pty3
    if mixed:
        # capsule rows use their two end spheres instead of box corners
        # (narrowphase.ground_contacts: slot 0 = pos - axis, 1 = pos + axis,
        # depth = radius - end_y, point = end with y -= radius)
        z6 = jnp.zeros((K_GROUND - 2, n), jnp.float32)
        e_x = jnp.concatenate([jnp.stack([px - a_axx, px + a_axx]), z6])
        e_y = jnp.concatenate([jnp.stack([py - a_axy, py + a_axy]), z6])
        e_z = jnp.concatenate([jnp.stack([pz - a_axz, pz + a_axz]), z6])
        two = jnp.arange(K_GROUND)[:, None] < 2
        cap_rows = a_cap_n[None, :]
        g_ptx3 = jnp.where(cap_rows, e_x, g_ptx3)
        g_pty3 = jnp.where(cap_rows, e_y - jnp.where(two, hx[None, :], 0.0),
                           g_pty3)
        g_ptz3 = jnp.where(cap_rows, e_z, g_ptz3)
        g_dep3 = jnp.where(cap_rows,
                           jnp.where(two, hx[None, :] - e_y, -1.0), g_dep3)
    g_val3 = ground_valid[None, :] & (g_dep3 > 0.0)
    g_cnt = jnp.sum(g_val3.astype(jnp.int32), axis=0)
    g_dest = jnp.cumsum(g_val3.astype(jnp.int32), axis=0) - 1
    g_dest = jnp.where(g_val3, g_dest, -1)

    def g_take(arr):
        return jnp.stack([
            jnp.sum(jnp.where(g_dest == c, arr, 0), axis=0)
            for c in range(cap)
        ])                                          # [cap,N]

    g_ptx = g_take(g_ptx3)
    g_pty = g_take(g_pty3)
    g_ptz = g_take(g_ptz3)
    g_dep = g_take(g_dep3)
    g_val = (jax.lax.broadcasted_iota(jnp.int32, (cap, n), 0)
             < jnp.minimum(g_cnt, cap)[None])
    ground_overflow = jnp.sum(jnp.maximum(g_cnt - cap, 0))

    ptx = jnp.concatenate([ptx, g_ptx])
    pty = jnp.concatenate([pty, g_pty])
    ptz = jnp.concatenate([ptz, g_ptz])
    nxs = jnp.concatenate([nxs, jnp.zeros((cap, n))])
    nys = jnp.concatenate([nys, jnp.ones((cap, n))])
    nzs = jnp.concatenate([nzs, jnp.zeros((cap, n))])
    dep = jnp.concatenate([dep, g_dep])
    val = jnp.concatenate([val, g_val])
    prt = jnp.concatenate([prt, jnp.full((cap, n), -1, jnp.int32)])
    if want_feat:
        g_slot3 = jax.lax.broadcasted_iota(
            jnp.int32, (K_GROUND, n), 0).astype(jnp.float32)
        g_feat = g_take(g_slot3)                     # bare corner index
        feat = jnp.concatenate([feat, g_feat])

    # ---- stage 2: compact to [budget, N] ---------------------------------
    dest = jnp.cumsum(val.astype(jnp.int32), axis=0) - 1
    dest = jnp.where(val, dest, -1)
    counts = jnp.sum(val.astype(jnp.int32), axis=0)

    def take(arr, fill):
        out = []
        for c in range(budget):
            sel = dest == c
            out.append(jnp.sum(jnp.where(sel, arr, 0), axis=0))
        res = jnp.stack(out)                        # [budget, N]
        got = jnp.arange(budget)[:, None] < counts[None, :]
        return jnp.where(got, res, fill)

    c_ptx = take(ptx, 0.0)
    c_pty = take(pty, 0.0)
    c_ptz = take(ptz, 0.0)
    c_nx = take(nxs, 0.0)
    c_ny = take(nys, 0.0)
    c_nz = take(nzs, 0.0)
    c_dep = take(dep, 0.0)
    c_prt = take(prt.astype(jnp.float32), -1.0).astype(jnp.int32)
    c_valid = jnp.arange(budget)[:, None] < jnp.minimum(counts, budget)[None, :]
    c_prt = jnp.where(c_valid, c_prt, -1)
    overflow = (jnp.sum(jnp.maximum(counts - budget, 0))
                + pair_overflow + ground_overflow)
    base = (c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
            overflow)
    if want_feat:
        c_feat = jnp.where(c_valid, take(feat, -1.0).astype(jnp.int32), -1)
        return base + (c_feat,)
    return base


def _inertia_world_comps(quat: Array, inv_inertia_body: Array):
    """Symmetric world-frame inverse inertia: 6 comps [N]
    (i00,i01,i02,i11,i12,i22); I = R diag(d) R^T."""
    a = _rot_comps(quat)
    d0, d1, d2 = (inv_inertia_body[:, 0], inv_inertia_body[:, 1],
                  inv_inertia_body[:, 2])

    def entry(i, j):
        return (a[3 * i + 0] * d0 * a[3 * j + 0]
                + a[3 * i + 1] * d1 * a[3 * j + 1]
                + a[3 * i + 2] * d2 * a[3 * j + 2])

    return (entry(0, 0), entry(0, 1), entry(0, 2),
            entry(1, 1), entry(1, 2), entry(2, 2))


def _sym_mul(i6, vx, vy, vz):
    """(symmetric 3x3 given by 6 comps) @ v, component-wise."""
    i00, i01, i02, i11, i12, i22 = i6
    return (i00 * vx + i01 * vy + i02 * vz,
            i01 * vx + i11 * vy + i12 * vz,
            i02 * vx + i12 * vy + i22 * vz)


@functools.partial(
    jax.jit, static_argnames=("iterations", "ground_friction",
                              "return_lambdas", "momentum", "block_size",
                              "block_shifts"))
def solve_contacts_t(
    vel: Array,        # f32[N,3]
    ang: Array,        # f32[N,3]
    pos: Array,        # f32[N,3]
    quat: Array,       # f32[N,4]
    inv_m: Array,      # f32[N]
    inv_inertia_body: Array,  # f32[N,3]
    c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
    friction, restitution,    # [N] material params (mu/e derived per pair)
    dt,
    iterations: int = 10,
    ground_friction: float = 0.5,
    warm=None,
    return_lambdas: bool = False,
    momentum: float = 0.0,
    block_size: "int | None" = None,
    block_shifts: "tuple | None" = None,
):
    """Transposed image of :func:`solver.solve_contacts_unified` (same
    mass-splitting Jacobi scheme, same constants); returns (vel, ang).

    ``warm`` = cached (ln, lt1, lt2) each [C, N] from feature-matched
    previous-step contacts; applied up-front and used to seed the
    accumulators (persistent-manifold warm starting).
    ``return_lambdas=True`` appends the accumulated (ln, lt1, lt2).

    ``block_size=B`` declares the scene block-diagonal: every partner id
    lives in the caller's own B-entity block (flat many-worlds), so the
    partner read is a ROLL: partner = n + shift with |shift| < B.  The
    per-iteration read becomes a select-accumulate over the static shift
    set (``block_shifts``, host-computed from the neighbor topology;
    defaults to all nonzero |d| < B) of rolled velocity planes — exactly
    one shift mask is true per (slot, body), so it is bit-identical to the
    gather."""
    n = pos.shape[0]
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    wx, wy, wz = ang[:, 0], ang[:, 1], ang[:, 2]
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]

    is_static = c_prt < 0
    safe = jnp.maximum(c_prt, 0)

    partner_read = None
    if block_size is not None and block_size > 0 and n % block_size == 0:
        bsz = int(block_size)
        ds = (tuple(int(d) for d in block_shifts) if block_shifts
              else tuple(d for d in range(-(bsz - 1), bsz) if d != 0))
        iota = jnp.arange(n, dtype=jnp.int32)
        # pair slots read partner = n + shift (block-diagonal guarantee);
        # static/ground slots get a sentinel no shift matches -> read 0.0
        # (same zeroing the one-hot form had; every consumer masks on
        # is_static or multiplies by masked terms)
        shift = jnp.where(is_static, jnp.int32(2 * bsz),
                          safe - iota[None, :])               # [C, N]
        masks = jax.lax.optimization_barrier(
            tuple(shift == d for d in ds))                    # each [C, N]

        def partner_read(packed_t):
            """[ch, N] -> [ch, C, N]: partner attributes as rolls + a
            select chain over the static shift set.  Exactly one mask is
            true per valid (slot, body) -> bit-identical to the gather;
            rolled wrap-around rows are never selected (shifts stay
            in-block).  All operands are dense [*, N] planes."""
            acc = jnp.zeros(packed_t.shape[:1] + shift.shape,
                            packed_t.dtype)
            for d, m in zip(ds, masks):
                rolled = jnp.roll(packed_t, -d, axis=-1)
                acc = jnp.where(m[None], rolled[:, None], acc)
            return acc

    # all iteration-invariant partner attributes in ONE channel-major
    # gather: take(..., axis=1) of a [12, N] table with [C, N] indices
    # lands [12, C, N] with each feature a contiguous [C, N] plane, not
    # strided columns of a row-major [C, N, 16] gather.  The barrier pins
    # the gather to run once instead of per consumer.
    ia = _inertia_world_comps(quat, inv_inertia_body)       # 6 x [N]
    setup_pack_t = jnp.stack(
        [px, py, pz, inv_m, friction, restitution, *ia])    # [12, N]
    if partner_read is not None:
        # static rows read 0.0 instead of body-0 attrs — benign: every
        # consumer either masks on is_static (c_mu, c_e, ib, im_b) or
        # multiplies by those masked terms (rb enters only via ib/im_b)
        gp = partner_read(setup_pack_t)
    else:
        gp = jax.lax.optimization_barrier(
            jnp.take(setup_pack_t, safe, axis=1))           # [12, C, N]

    rax = c_ptx - px[None]
    ray = c_pty - py[None]
    raz = c_ptz - pz[None]
    rbx = c_ptx - gp[0]
    rby = c_pty - gp[1]
    rbz = c_ptz - gp[2]

    c_mu = jnp.where(
        is_static,
        friction[None, :] * ground_friction,
        friction[None, :] * gp[4],
    )
    c_e = jnp.where(
        is_static, 0.0, restitution[None, :] * gp[5],
    )

    # orthonormal tangents (same branchless helper as the general solver)
    use_x = jnp.abs(c_nx) < 0.7
    hx = jnp.where(use_x, 1.0, 0.0)
    hy = jnp.where(use_x, 0.0, 1.0)
    t1x, t1y, t1z = _cross(c_nx, c_ny, c_nz, hx, hy, jnp.zeros_like(hx))
    t1n = jnp.maximum(jnp.sqrt(t1x**2 + t1y**2 + t1z**2), 1e-9)
    t1x, t1y, t1z = t1x / t1n, t1y / t1n, t1z / t1n
    t2x, t2y, t2z = _cross(c_nx, c_ny, c_nz, t1x, t1y, t1z)

    ia_c = tuple(c[None] for c in ia)                       # broadcast [1,N]
    ib = tuple(
        jnp.where(is_static, 0.0, gp[6 + i]) for i in range(6))
    im_a = inv_m[None]
    im_b = jnp.where(is_static, 0.0, gp[3])

    def k_along(dx, dy, dz):
        cxa, cya, cza = _cross(rax, ray, raz, dx, dy, dz)
        ixa, iya, iza = _sym_mul(ia_c, cxa, cya, cza)
        axx, axy, axz = _cross(ixa, iya, iza, rax, ray, raz)
        cxb, cyb, czb = _cross(rbx, rby, rbz, dx, dy, dz)
        ixb, iyb, izb = _sym_mul(ib, cxb, cyb, czb)
        bxx, bxy, bxz = _cross(ixb, iyb, izb, rbx, rby, rbz)
        kk = (im_a + im_b
              + _dot(dx, dy, dz, axx, axy, axz)
              + _dot(dx, dy, dz, bxx, bxy, bxz))
        return jnp.maximum(kk, 1e-9)

    kn = k_along(c_nx, c_ny, c_nz)
    kt1 = k_along(t1x, t1y, t1z)
    kt2 = k_along(t2x, t2y, t2z)

    def rel_vel(vx_, vy_, vz_, wx_, wy_, wz_, packed_t):
        """packed_t: [6, N] (vx..wz rows) — partner state arrives in ONE
        channel-major take landing each velocity component as a
        contiguous [C, N] plane."""
        cax, cay, caz = _cross(wx_[None] * jnp.ones_like(rax),
                               wy_[None] * jnp.ones_like(rax),
                               wz_[None] * jnp.ones_like(rax),
                               rax, ray, raz)
        vax = vx_[None] + cax
        vay = vy_[None] + cay
        vaz = vz_[None] + caz
        if partner_read is not None:
            g = partner_read(packed_t)                      # [6, C, N]
            gbx, gby, gbz, gwx, gwy, gwz = (
                g[0], g[1], g[2], g[3], g[4], g[5])
        else:
            g = jax.lax.optimization_barrier(
                jnp.take(packed_t, safe, axis=1))           # [6, C, N]
            gbx = jnp.where(is_static, 0.0, g[0])
            gby = jnp.where(is_static, 0.0, g[1])
            gbz = jnp.where(is_static, 0.0, g[2])
            gwx = jnp.where(is_static, 0.0, g[3])
            gwy = jnp.where(is_static, 0.0, g[4])
            gwz = jnp.where(is_static, 0.0, g[5])
        cbx, cby, cbz = _cross(gwx, gwy, gwz, rbx, rby, rbz)
        return (vax - gbx - cbx, vay - gby - cby, vaz - gbz - cbz)

    def pack(vx_, vy_, vz_, wx_, wy_, wz_):
        return jnp.stack([vx_, vy_, vz_, wx_, wy_, wz_])    # [6, N]

    rx, ry, rz = rel_vel(vx, vy, vz, wx, wy, wz, pack(vx, vy, vz, wx, wy, wz))
    vn0 = _dot(rx, ry, rz, c_nx, c_ny, c_nz)
    bounce = c_e * jnp.maximum(-vn0 - RESTITUTION_THRESHOLD, 0.0)
    baum = (BAUMGARTE / dt) * jnp.maximum(c_dep - PENETRATION_SLOP, 0.0)
    target = jnp.maximum(bounce, baum)

    cnt = jnp.sum(c_valid, axis=0).astype(jnp.float32)
    inv_split_m = inv_m / jnp.maximum(cnt, 1.0)
    inv_split = 1.0 / jnp.maximum(cnt, 1.0)

    zeros = jnp.zeros_like(c_dep)

    if warm is not None:
        # Bullet's 0.85 warm-starting factor (see solver.py): damped reuse
        # avoids freezing unstable equilibria
        ln0 = jnp.where(
            c_valid, jnp.maximum(warm[0], 0.0) * WARM_START_FACTOR, 0.0)
        lt10 = jnp.where(c_valid, warm[1] * WARM_START_FACTOR, 0.0)
        lt20 = jnp.where(c_valid, warm[2] * WARM_START_FACTOR, 0.0)
        impx0 = ln0 * c_nx + lt10 * t1x + lt20 * t2x
        impy0 = ln0 * c_ny + lt10 * t1y + lt20 * t2y
        impz0 = ln0 * c_nz + lt10 * t1z + lt20 * t2z
        vx = vx + jnp.sum(impx0, axis=0) * inv_split_m
        vy = vy + jnp.sum(impy0, axis=0) * inv_split_m
        vz = vz + jnp.sum(impz0, axis=0) * inv_split_m
        tqx0, tqy0, tqz0 = _cross(rax, ray, raz, impx0, impy0, impz0)
        iwx0, iwy0, iwz0 = _sym_mul(
            ia, jnp.sum(tqx0, axis=0), jnp.sum(tqy0, axis=0),
            jnp.sum(tqz0, axis=0))
        wx = wx + iwx0 * inv_split
        wy = wy + iwy0 * inv_split
        wz = wz + iwz0 * inv_split
    else:
        ln0 = lt10 = lt20 = zeros

    def body(_, carry):
        vx_, vy_, vz_, wx_, wy_, wz_, ln, lt1, lt2, pln, plt1, plt2 = carry
        rx, ry, rz = rel_vel(vx_, vy_, vz_, wx_, wy_, wz_,
                             pack(vx_, vy_, vz_, wx_, wy_, wz_))
        vn = _dot(rx, ry, rz, c_nx, c_ny, c_nz)
        ln_new = jnp.maximum(ln + (-(vn - target)) / kn, 0.0)
        if momentum:
            # heavy-ball extrapolation over the lambda iterates (see
            # solver.py): kills the tall-stack oscillation mode that plain
            # mass-splitting Jacobi leaves under-converged
            ln_new = jnp.maximum(ln_new + momentum * (ln_new - pln), 0.0)
        dln = jnp.where(c_valid, ln_new - ln, 0.0)
        pln = ln
        ln = jnp.where(c_valid, ln_new, ln)

        vt1 = _dot(rx, ry, rz, t1x, t1y, t1z)
        vt2 = _dot(rx, ry, rz, t2x, t2y, t2z)
        max_f = c_mu * ln
        lt1_new = lt1 - vt1 / kt1
        lt2_new = lt2 - vt2 / kt2
        if momentum:
            lt1_new = lt1_new + momentum * (lt1_new - plt1)
            lt2_new = lt2_new + momentum * (lt2_new - plt2)
        lt1_new = jnp.clip(lt1_new, -max_f, max_f)
        lt2_new = jnp.clip(lt2_new, -max_f, max_f)
        dlt1 = jnp.where(c_valid, lt1_new - lt1, 0.0)
        dlt2 = jnp.where(c_valid, lt2_new - lt2, 0.0)
        plt1, plt2 = lt1, lt2
        lt1 = jnp.where(c_valid, lt1_new, lt1)
        lt2 = jnp.where(c_valid, lt2_new, lt2)

        impx = dln * c_nx + dlt1 * t1x + dlt2 * t2x
        impy = dln * c_ny + dlt1 * t1y + dlt2 * t2y
        impz = dln * c_nz + dlt1 * t1z + dlt2 * t2z
        linx = jnp.sum(impx, axis=0)
        liny = jnp.sum(impy, axis=0)
        linz = jnp.sum(impz, axis=0)
        tqx, tqy, tqz = _cross(rax, ray, raz, impx, impy, impz)
        angx = jnp.sum(tqx, axis=0)
        angy = jnp.sum(tqy, axis=0)
        angz = jnp.sum(tqz, axis=0)
        vx_ = vx_ + linx * inv_split_m
        vy_ = vy_ + liny * inv_split_m
        vz_ = vz_ + linz * inv_split_m
        iwx, iwy, iwz = _sym_mul(ia, angx, angy, angz)
        wx_ = wx_ + iwx * inv_split
        wy_ = wy_ + iwy * inv_split
        wz_ = wz_ + iwz * inv_split
        return vx_, vy_, vz_, wx_, wy_, wz_, ln, lt1, lt2, pln, plt1, plt2

    carry = (vx, vy, vz, wx, wy, wz, ln0, lt10, lt20, ln0, lt10, lt20)
    carry = jax.lax.fori_loop(0, iterations, body, carry)
    vx, vy, vz, wx, wy, wz = carry[:6]
    out = (jnp.stack([vx, vy, vz], axis=1), jnp.stack([wx, wy, wz], axis=1))
    if return_lambdas:
        return out + ((carry[6], carry[7], carry[8]),)
    return out
