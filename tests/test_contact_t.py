"""Transposed (component-form) contact pipeline vs the general path.

The stress pipeline (Pallas broadphase + contact_t) must produce the same
physics as the general narrowphase/solver: same contact sets, matching
velocities after one solve (fp-reassociation tolerance), and matching
trajectories/resting behavior over a horizon.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from banggameengine_tpu.engine import make_step_fn
from banggameengine_tpu.physics import narrowphase as nf
from banggameengine_tpu.physics import solver as sv
from banggameengine_tpu.physics.broadphase import build_neighbor_lists_dense
from banggameengine_tpu.physics import contact_t
from banggameengine_tpu.physics.step import CONTACT_BUDGET, GROUND_FRICTION
from banggameengine_tpu.scene.synthetic import build_falling_boxes
from banggameengine_tpu.state import (
    BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER, InputFrame,
)


def _settled_boxes(n=24, steps=120, seed=7, spread=2.5):
    state, static = build_falling_boxes(n, seed=seed, spread=spread)
    fn = make_step_fn(static, donate=False)
    for _ in range(steps):
        state, _ = fn(state, InputFrame.zero())
    return state, static


def _masks(state, static):
    alive = state.alive
    solid = alive & ((state.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0)
    is_dyn = (static.body_type == BODY_DYNAMIC) & alive
    return solid, is_dyn


def _neighbor_lists(state, static, solid, is_dyn, k=8):
    layer_ok = (
        ((static.layer[:, None] & static.mask[None, :]) != 0)
        & ((static.layer[None, :] & static.mask[:, None]) != 0)
    )
    any_dyn = is_dyn[:, None] | is_dyn[None, :]
    pair_mask = solid[:, None] & solid[None, :] & layer_ok & any_dyn
    return build_neighbor_lists_dense(
        state.pos, state.quat, static.shape_type, static.shape_size,
        pair_mask, max_neighbors=k,
    )


def test_contacts_t_match_general_narrowphase():
    """Same neighbor lists -> same contact set (partner, depth) as the
    general pair_contacts + compact_contacts path."""
    state, static = _settled_boxes()
    solid, is_dyn = _masks(state, static)
    nl = _neighbor_lists(state, static, solid, is_dyn)
    pos, quat = state.pos, state.quat
    n = state.capacity

    ground_ok = is_dyn & solid
    (c_prt, _x, _y, _z, _nx, _ny, _nz, c_dep, c_valid, _ovf) = (
        contact_t.box_contacts_t(pos, quat, static.shape_size,
                                 nl.idx, nl.valid, ground_ok,
                                 budget=CONTACT_BUDGET))

    # general path
    safe_j = jnp.maximum(nl.idx, 0)
    pp, pn, pd, pg = nf.pair_contacts(
        pos[:, None], quat[:, None],
        static.shape_type[:, None], static.shape_size[:, None],
        pos[safe_j], quat[safe_j],
        static.shape_type[safe_j], static.shape_size[safe_j],
        enable_capsule=False,
    )
    pv = pg & (pd > 0.0) & nl.valid[..., None]
    partner = jnp.broadcast_to(nl.idx[:, :, None], pd.shape)
    gp, gn, gd, gv = nf.ground_contacts(pos, quat, static.shape_type,
                                        static.shape_size)
    gv = gv & (gd > 0.0) & ground_ok[:, None]
    m_pair = pd.shape[1] * pd.shape[2]
    all_b = jnp.concatenate([partner.reshape(n, m_pair),
                             jnp.full((n, nf.K_GROUND), -1, jnp.int32)], 1)
    all_d = jnp.concatenate([pd.reshape(n, m_pair), gd], 1)
    all_v = jnp.concatenate([pv.reshape(n, m_pair), gv], 1)

    # compare per-row contact multisets of (partner, depth)
    tp = np.asarray(c_prt).T
    td = np.asarray(c_dep).T
    tv = np.asarray(c_valid).T
    gb = np.asarray(all_b)
    gdep = np.asarray(all_d)
    gvv = np.asarray(all_v)
    for r in range(n):
        a = sorted(
            (int(p), round(float(d), 4))
            for p, d, v in zip(tp[r], td[r], tv[r]) if v
        )
        b = sorted(
            (int(p), round(float(d), 4))
            for p, d, v in zip(gb[r], gdep[r], gvv[r]) if v
        )
        assert a == b, f"row {r}: transposed {a} vs general {b}"


def test_solve_t_matches_general_solver():
    """One full contact solve: transposed pipeline velocities match the
    general path within fp-reassociation tolerance."""
    state, static = _settled_boxes()
    solid, is_dyn = _masks(state, static)
    nl = _neighbor_lists(state, static, solid, is_dyn)
    pos, quat = state.pos, state.quat
    n = state.capacity
    dt = jnp.float32(1 / 120)
    gravity = jnp.asarray([0.0, -9.81, 0.0]) * dt
    vel = jnp.where(is_dyn[:, None], state.lin_vel + gravity, state.lin_vel)
    ang = state.ang_vel

    ground_ok = is_dyn & solid
    (c_prt, cx, cy, cz, cnx, cny, cnz, c_dep, c_valid, _ovf) = (
        contact_t.box_contacts_t(pos, quat, static.shape_size,
                                 nl.idx, nl.valid, ground_ok,
                                 budget=CONTACT_BUDGET))
    v_t, w_t = contact_t.solve_contacts_t(
        vel, ang, pos, quat, static.inv_mass, static.inv_inertia_body,
        c_prt, cx, cy, cz, cnx, cny, cnz, c_dep, c_valid,
        static.friction, static.restitution, dt,
        iterations=10, ground_friction=GROUND_FRICTION,
    )

    # general path on the same neighbor lists
    safe_j = jnp.maximum(nl.idx, 0)
    pp, pn, pd, pg = nf.pair_contacts(
        pos[:, None], quat[:, None],
        static.shape_type[:, None], static.shape_size[:, None],
        pos[safe_j], quat[safe_j],
        static.shape_type[safe_j], static.shape_size[safe_j],
        enable_capsule=False,
    )
    pv = pg & (pd > 0.0) & nl.valid[..., None]
    partner = jnp.broadcast_to(nl.idx[:, :, None], pd.shape)
    gp, gn, gd, gv = nf.ground_contacts(pos, quat, static.shape_type,
                                        static.shape_size)
    gv = gv & (gd > 0.0) & ground_ok[:, None]
    m_pair = pd.shape[1] * pd.shape[2]
    all_b = jnp.concatenate([partner.reshape(n, m_pair),
                             jnp.full((n, nf.K_GROUND), -1, jnp.int32)], 1)
    all_pt = jnp.concatenate([pp.reshape(n, m_pair, 3), gp], 1)
    all_n = jnp.concatenate([pn.reshape(n, m_pair, 3), gn], 1)
    all_d = jnp.concatenate([pd.reshape(n, m_pair), gd], 1)
    all_v = jnp.concatenate([pv.reshape(n, m_pair), gv], 1)
    c_b, c_pt, c_n, c_d, c_val, _ = sv.compact_contacts(
        all_b, all_pt, all_n, all_d, all_v, CONTACT_BUDGET)
    safe_b = jnp.maximum(c_b, 0)
    s_side = c_b < 0
    mu = jnp.where(s_side, static.friction[:, None] * GROUND_FRICTION,
                   static.friction[:, None] * static.friction[safe_b])
    e = jnp.where(s_side, 0.0,
                  static.restitution[:, None] * static.restitution[safe_b])
    inv_i_w = sv.inv_inertia_world(quat, static.inv_inertia_body)
    v_g, w_g = sv.solve_contacts_unified(
        vel, ang, pos, static.inv_mass, inv_i_w,
        c_b, c_pt, c_n, c_d, c_val, mu, e, dt, iterations=10)

    np.testing.assert_allclose(np.asarray(v_t), np.asarray(v_g),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(w_t), np.asarray(w_g),
                               atol=5e-3, rtol=1e-3)


def test_pallas_step_trajectory_matches_grid():
    """Full engine steps: broadphase='sorted' tracks broadphase='grid'
    and produces sane resting piles."""
    state0, static = build_falling_boxes(32, seed=11, spread=3.0)
    fn_p = make_step_fn(static, donate=False, broadphase="sorted")
    fn_g = make_step_fn(static, donate=False, broadphase="grid",
                        grid_cell_size=2.5, grid_table_size=1024,
                        max_neighbors=8)
    sp = sg = state0
    for i in range(240):
        sp, _ = fn_p(sp, InputFrame.zero())
        sg, _ = fn_g(sg, InputFrame.zero())
    pp = np.asarray(sp.pos)[np.asarray(state0.alive)]
    pg = np.asarray(sg.pos)[np.asarray(state0.alive)]
    assert np.isfinite(pp).all()
    # everything on/above the ground plane
    assert (pp[:, 1] > 0.3).all()
    # tracks the grid path closely (exact equality is not expected: the
    # sorted-space path sums Jacobi impulses in a different neighbor
    # order -> fp drift, which 2 s of chaotic piling amplifies on a few
    # bodies).  Median must stay tight; a loose cap bounds the outliers.
    diff = np.abs(pp - pg)
    assert np.median(diff) < 0.01, np.median(diff)
    assert diff.max() < 0.6, diff.max()
    assert abs(pp[:, 1].mean() - pg[:, 1].mean()) < 0.05


def test_pallas_step_rejects_capsule_scenes():
    state, static = build_falling_boxes(4, with_character=False)
    # make body 0 a solid dynamic capsule
    static = dataclasses.replace(
        static, shape_type=static.shape_type.at[0].set(2))
    with pytest.raises(ValueError, match="box-only"):
        fn = make_step_fn(static, donate=False, broadphase="sorted")
        fn(state, InputFrame.zero())
