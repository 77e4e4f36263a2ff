"""Physics step orchestration: one fixed step of the whole pipeline.

The array image of ``PhysicsSystem::Update`` (``PhysicsSystem.cpp:1208-1328``)
minus the Ensure/prune scans (topology is baked at scene build).  Order per
step mirrors the reference:

1. character input -> kinematic character move + depenetrate (Bullet runs the
   character action inside ``stepSimulation``);
2. dynamic bodies: gravity, narrowphase contacts (dense all-pairs +
   ground plane), fixed-iteration Jacobi impulse solve, semi-implicit Euler
   integrate (``stepSimulation``, ``:848-875``);
3. trigger overlap diff -> Enter/Stay/Exit event arrays + oneShot
   deactivation (``ProcessTriggerEvents``, ``:1017-1074``).

The whole function is pure: ``(WorldState, InputFrame, StaticScene) ->
(WorldState, StepEvents)``; ``jax.vmap`` over WorldState/InputFrame gives
many-world stepping.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from banggameengine_tpu import math3d
from banggameengine_tpu.physics import character as chr_mod
from banggameengine_tpu.physics import narrowphase as nf
from banggameengine_tpu.physics import solver as sv
from banggameengine_tpu.physics import triggers as tg
from banggameengine_tpu.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    COMP_RIGID_BODY,
    FEAT_STRIDE,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    InputFrame,
    StaticScene,
    StepEvents,
    WorldState,
)

GROUND_FRICTION = 0.5  # implicit plane uses Bullet's default friction
SOLVER_ITERATIONS = 10
CONTACT_BUDGET = 12    # max solved contacts per body after compaction


def scene_census(static: StaticScene) -> dict:
    """Host-side census of a CONCRETE static scene.

    Returns the compile-time booleans that let ``physics_step`` skip dead
    pipeline stages (character sweep, capsule narrowphase, trigger overlap).
    Step factories call this once and thread the result through
    ``physics_kwargs``, so the StaticScene itself can stay a *traced*
    argument (a config hot reload then swaps it without recompiling).
    """
    import numpy as _np

    from banggameengine_tpu.state import SHAPE_CAPSULE as _CAP

    st_np = _np.asarray(static.shape_type)
    bt_np = _np.asarray(static.body_type)
    caps = (st_np == _CAP) & (bt_np > 0)
    ce_np = _np.asarray(static.char_entity)
    caps[ce_np[ce_np >= 0]] = False  # character ghosts never solve
    return dict(
        any_char=bool((ce_np >= 0).any()),
        enable_capsule=bool(caps.any()),
        any_trig=bool((_np.asarray(static.trig_entity) >= 0).any()),
    )


def physics_step(
    state: WorldState,
    inp: InputFrame,
    static: StaticScene,
    solver_iterations: int = SOLVER_ITERATIONS,
    broadphase: str = "dense",
    grid_cell_size: float = 2.5,
    grid_table_size: int = 4096,
    grid_cell_capacity: int = 8,
    max_neighbors: int = 16,
    trigger_mode: str = "aabb",
    any_char: bool | None = None,
    enable_capsule: bool | None = None,
    any_trig: bool | None = None,
    warm_start: bool = True,
    group: "Array | None" = None,
    static_neighbors: "tuple | None" = None,
    char_candidates: "Array | None" = None,
    solver_sor: float = 1.0,
    solver_momentum: float = 0.5,
    solver_block_size: "int | None" = None,
    solver_block_shifts: "tuple | None" = None,
) -> tuple[WorldState, StepEvents]:
    dt = static.fixed_dt
    n = state.capacity
    alive = state.alive
    has_collider = (state.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0
    is_dynamic = (static.body_type == BODY_DYNAMIC) & alive
    # kinematic bodies move by host-set velocity (the array image of
    # SyncKinematicBodiesToPhysics, PhysicsSystem.cpp:952-989: the reference
    # pushes Transform changes into Bullet each tick and Bullet derives the
    # body's velocity; here the host sets the velocity directly — see
    # physics/kinematic.py).  They receive no impulses (inv_mass 0) but
    # their velocity enters contact relative velocity, so they push and
    # carry dynamic bodies.
    is_kinematic = (static.body_type == BODY_KINEMATIC) & alive
    moving = is_dynamic | is_kinematic

    pos = state.pos
    quat = state.quat
    vel = state.lin_vel
    ang = state.ang_vel

    # ------------------------------------------------------------------
    # 1. characters (kinematic capsules, ghost semantics)
    # ------------------------------------------------------------------
    # Characters collide against everything except themselves; their capsule
    # center is the entity position (visual offset is a render-side concern,
    # PhysicsSystem.cpp:877-914).
    c_slots = static.num_char_slots
    char_ent = static.char_entity
    safe_ce = jnp.where(char_ent >= 0, char_ent, 0)

    # host-known census: a scene with no character slot in use skips the
    # whole character sweep (the 10k-stress scene pays a full capsule-vs-N
    # pass for one dead slot otherwise).  Factories pass the census in
    # (scene_census); a traced static with no census keeps the sweep.
    if any_char is None:
        try:
            import numpy as _np

            any_char = bool((_np.asarray(char_ent) >= 0).any())
        except jax.errors.TracerArrayConversionError:
            any_char = True

    obstacle_base = alive & has_collider

    def one_char(slot, view_pos, view_quat, view_st, view_sz, view_ok):
        ce = safe_ce[slot]

        def per_slot(v):
            # per-slot input vectors (flat many-world: slot w = world w)
            v = jnp.asarray(v)
            return v[slot] if v.ndim else v

        new_c, new_vy, new_g = chr_mod.step_character(
            pos[ce],
            state.char_vel_y[ce],
            state.char_on_ground[ce],
            static.char_radius[slot], static.char_half_height[slot],
            static.char_walk_speed[slot], static.char_jump_impulse[slot],
            per_slot(inp.move_forward), per_slot(inp.move_right),
            per_slot(inp.jump), per_slot(inp.sprint), per_slot(inp.cam_yaw),
            view_pos, view_quat, view_st, view_sz, view_ok,
            static.gravity, dt, static.step_height, static.max_slope_cos,
        )
        return new_c, new_vy, new_g

    if any_char:
        if char_candidates is not None:
            # static per-slot obstacle candidates (flat many-world: each
            # character only ever meets its own world's entities), run
            # through the PLANAR multi-character step: the vmapped
            # per-char form builds [C, 3, K, 3]-minor intermediates, the
            # planar form keeps every quantity a dense [K, C] plane
            cand = char_candidates                       # i32[C, K]
            ob_c = obstacle_base[cand] & (cand != safe_ce[:, None])
            if group is not None:
                ob_c = ob_c & (group[cand] == group[safe_ce][:, None])
            cand_t = cand.T                              # [K, C]
            # iteration-invariant candidate attributes in ONE
            # channel-major gather (cf. contact_t setup_pack_t)
            cpack = jnp.stack([
                pos[:, 0], pos[:, 1], pos[:, 2],
                quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3],
                static.shape_size[:, 0], static.shape_size[:, 1],
                static.shape_size[:, 2],
            ])                                           # [10, N]
            cg = jax.lax.optimization_barrier(
                jnp.take(cpack, cand_t, axis=1))         # [10, K, C]
            ctype = static.shape_type[cand_t]            # [K, C]
            ob_t = ob_c.T
            b_is_box = (ctype == SHAPE_BOX) & ob_t
            b_is_cap = (ctype == SHAPE_CAPSULE) & ob_t

            def per_vec(v):
                v = jnp.asarray(v)
                return (v if v.ndim else
                        jnp.broadcast_to(v, (c_slots,)))

            ccx, ccy, ccz = (pos[safe_ce, 0], pos[safe_ce, 1],
                             pos[safe_ce, 2])
            npx, npy, npz, new_vys, new_grounds = chr_mod.step_characters_t(
                ccx, ccy, ccz,
                state.char_vel_y[safe_ce], state.char_on_ground[safe_ce],
                static.char_radius, static.char_half_height,
                static.char_walk_speed, static.char_jump_impulse,
                per_vec(inp.move_forward), per_vec(inp.move_right),
                per_vec(inp.jump), per_vec(inp.sprint),
                per_vec(inp.cam_yaw),
                cg[0], cg[1], cg[2], cg[3], cg[4], cg[5], cg[6],
                b_is_box, b_is_cap, cg[7], cg[8], cg[9],
                static.gravity, dt, static.step_height,
                static.max_slope_cos,
            )
            new_centers = jnp.stack([npx, npy, npz], axis=1)
        else:
            def full_view(slot):
                ce = safe_ce[slot]
                obstacle = obstacle_base & (jnp.arange(n) != ce)
                if group is not None:
                    # block-diagonal multi-world scene: characters only
                    # collide with their own world's entities
                    obstacle = obstacle & (group == group[ce])
                return one_char(slot, pos, quat, static.shape_type,
                                static.shape_size, obstacle)

            new_centers, new_vys, new_grounds = jax.vmap(full_view)(
                jnp.arange(c_slots))
        char_valid = (char_ent >= 0) & alive[safe_ce]

        pos = pos.at[safe_ce].set(
            jnp.where(char_valid[:, None], new_centers, pos[safe_ce])
        )
        char_vel_y = state.char_vel_y.at[safe_ce].set(
            jnp.where(char_valid, new_vys, state.char_vel_y[safe_ce])
        )
        char_on_ground = state.char_on_ground.at[safe_ce].set(
            jnp.where(char_valid, new_grounds, state.char_on_ground[safe_ce])
        )
    else:
        char_vel_y = state.char_vel_y
        char_on_ground = state.char_on_ground

    # ------------------------------------------------------------------
    # 2. rigid-body dynamics
    # ------------------------------------------------------------------
    gravity_vec = jnp.asarray([0.0, 1.0, 0.0], jnp.float32) * static.gravity
    vel = jnp.where(is_dynamic[:, None], vel + gravity_vec * dt, vel)

    is_char = (state.comp_mask & COMP_CHARACTER) != 0
    # solid = participates in the contact solver (characters are ghosts:
    # they depenetrate themselves and exert no impulses)
    solid = alive & has_collider & ~is_char

    # host-known shape census: when no SOLID capsule exists (characters are
    # ghosts), the capsule narrowphase blocks are dead code — skip them.
    # Factories pass the census in; falls back to the general path when the
    # static scene is traced with no census (hot-reload path).
    if enable_capsule is None:
        try:
            import numpy as _np
            from banggameengine_tpu.state import SHAPE_CAPSULE as _CAP

            st_np = _np.asarray(static.shape_type)
            bt_np = _np.asarray(static.body_type)
            caps = (st_np == _CAP) & (bt_np > 0)
            ce_np = _np.asarray(static.char_entity)
            caps[ce_np[ce_np >= 0]] = False  # character ghosts never solve
            enable_capsule = bool(caps.any())
        except jax.errors.TracerArrayConversionError:
            enable_capsule = True

    # ---- broadphase -> fixed-capacity neighbor lists --------------------
    # (all paths prune pairs BEFORE the expensive manifold math; every
    # surviving pair appears mirrored in both bodies' rows for the
    # row-reduction solver)
    if broadphase == "sorted":
        # 10k-body stress path: Morton-sorted blocked all-pairs AABB
        # broadphase (a Pallas kernel on CUDA GPUs) + transposed
        # component-form narrowphase/solver
        # (box-only: the scene census guarantees no solid capsules)
        if enable_capsule:
            raise ValueError(
                "broadphase='sorted' is the box-only stress pipeline; this "
                "scene has solid capsules (or a traced StaticScene) — use "
                "broadphase='grid' or 'dense'"
            )
        from banggameengine_tpu.physics import contact_t
        from banggameengine_tpu.physics import shapes as sh_mod
        from banggameengine_tpu.physics.broadphase import morton_key_xz
        from banggameengine_tpu.physics.broadphase_triton import (
            neighbor_lists_sorted,
        )

        # The whole contact phase runs in Morton-sorted space, so partners
        # sit close together in memory.  One packed gather carries every
        # per-body attribute into sorted order; only vel/ang come back
        # (pos/quat are read-only here).
        order = jnp.argsort(morton_key_xz(pos))
        # inverse permutation: every sorted->original move below is a
        # GATHER x[inv_order] instead of a permutation scatter
        inv_order = jnp.argsort(order)
        mn, mx = sh_mod.shape_aabb(
            pos, quat, static.shape_type, static.shape_size)
        dyn_flag = jnp.where(solid, is_dynamic.astype(jnp.int32), -1)

        def bits(a):
            return jax.lax.bitcast_convert_type(
                a.astype(jnp.int32), jnp.float32)

        feat = jnp.concatenate(
            [mn, mx, pos, quat, vel, ang, static.shape_size,
             static.inv_mass[:, None], static.inv_inertia_body,
             static.friction[:, None], static.restitution[:, None],
             bits(dyn_flag)[:, None], bits(static.layer)[:, None],
             bits(static.mask)[:, None],
             jnp.zeros((n, 1), jnp.float32)], axis=1)       # [N, 32]
        sf = feat[order]

        def ints(a):
            return jax.lax.bitcast_convert_type(a, jnp.int32)

        pos_s, quat_s = sf[:, 6:9], sf[:, 9:13]
        vel_s, ang_s = sf[:, 13:16], sf[:, 16:19]
        half_s = sf[:, 19:22]
        inv_m_s, inertia_s = sf[:, 22], sf[:, 23:26]
        fric_s, rest_s = sf[:, 26], sf[:, 27]
        dyn_s = ints(sf[:, 28])

        with jax.named_scope("broadphase"):
            nl = neighbor_lists_sorted(
                sf[:, 0:3], sf[:, 3:6], dyn_s, ints(sf[:, 29]),
                ints(sf[:, 30]), max_neighbors=min(max_neighbors, 8),
            )
        ground_ok_s = (dyn_s > 0) & jnp.asarray(static.ground_enabled)
        if warm_start:
            (c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
             contact_overflow, c_feat) = contact_t.box_contacts_t(
                pos_s, quat_s, half_s, nl.idx, nl.valid, ground_ok_s,
                budget=CONTACT_BUDGET, orig_id=order,
            )
            # cache lives in ORIGINAL id space (stable across the per-step
            # Morton re-sort); gather to sorted space, match, scatter back
            cache_feat_s = state.contact_feat[order].T    # [CB, N]
            cache_imp_s = jnp.transpose(
                state.contact_imp[order], (1, 2, 0))      # [CB, 3, N]
            eq = (
                (c_feat[:, None, :] == cache_feat_s[None, :, :])
                & (c_feat >= 0)[:, None, :]
            ).astype(jnp.float32)                         # [C, CB, N]
            warm = tuple(
                jnp.einsum("cdn,dn->cn", eq, cache_imp_s[:, i, :])
                for i in range(3)
            )
            vel_s, ang_s, (ln, lt1, lt2) = contact_t.solve_contacts_t(
                vel_s, ang_s, pos_s, quat_s, inv_m_s, inertia_s,
                c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep,
                c_valid, fric_s, rest_s, dt,
                iterations=solver_iterations,
                ground_friction=GROUND_FRICTION,
                warm=warm, return_lambdas=True,
                momentum=solver_momentum,
            )
            imp_s = jnp.where(
                c_valid.T[..., None],
                jnp.stack([ln.T, lt1.T, lt2.T], axis=-1), 0.0)  # [N, C, 3]
            feat_s = jnp.where(c_valid, c_feat, -1).T           # [N, C]
            contact_cache = (feat_s[inv_order], imp_s[inv_order])
        else:
            (c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
             contact_overflow) = contact_t.box_contacts_t(
                pos_s, quat_s, half_s, nl.idx, nl.valid, ground_ok_s,
                budget=CONTACT_BUDGET,
            )
            vel_s, ang_s = contact_t.solve_contacts_t(
                vel_s, ang_s, pos_s, quat_s, inv_m_s, inertia_s,
                c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep,
                c_valid, fric_s, rest_s, dt,
                iterations=solver_iterations,
                ground_friction=GROUND_FRICTION,
                momentum=solver_momentum,
            )
            contact_cache = None
        out = jnp.concatenate([vel_s, ang_s], axis=1)[inv_order]
        vel, ang = out[:, 0:3], out[:, 3:6]
        return _finish_step(state, static, pos, quat, vel, ang,
                            char_vel_y, char_on_ground, is_dynamic, moving,
                            alive, has_collider, trigger_mode, dt, any_trig,
                            contact_cache=contact_cache,
                            contact_overflow=contact_overflow)
    if broadphase == "static":
        # Block-diagonal multi-world path (flat many-world lockstep): the
        # neighbor structure is KNOWN AT BUILD TIME (bodies only ever
        # collide within their own world block), so there is no broadphase
        # at all — the precomputed intra-world all-pairs lists feed the
        # transposed component-form contact pipeline directly, in original
        # id order (no Morton sort: world blocks are already contiguous).
        # Every [slots, N] intermediate keeps the flat body axis minor,
        # where the per-world dense path builds [W,B,C,3]-minor shapes.
        # Scenes with solid capsules pass shape_type through to the
        # mixed-shape slots.
        if static_neighbors is None:
            raise ValueError(
                "broadphase='static' requires static_neighbors=(idx, valid)")
        from banggameengine_tpu.physics import contact_t

        nb_idx, nb_valid = static_neighbors
        both = solid & alive
        if solver_block_shifts:
            # block-diagonal topology: partner = row + shift, so the two
            # [N, K] partner-validity gathers become a select chain over
            # rolled [N] planes with the static shift set (see
            # solve_contacts_t.partner_read)
            shift_nb = nb_idx - jnp.arange(n, dtype=jnp.int32)[:, None]
            pb = jnp.zeros(nb_idx.shape, bool)
            for d in solver_block_shifts:
                pb = jnp.where(shift_nb == d,
                               jnp.roll(both, -d)[:, None], pb)
            nb_ok = nb_valid & pb & both[:, None]
        else:
            nb_ok = nb_valid & both[nb_idx] & both[:, None]
        ground_ok = is_dynamic & solid & jnp.asarray(static.ground_enabled)
        half = static.shape_size
        stype = static.shape_type if enable_capsule else None
        if warm_start:
            (c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
             contact_overflow, c_feat) = contact_t.box_contacts_t(
                pos, quat, half, nb_idx, nb_ok, ground_ok,
                budget=CONTACT_BUDGET,
                orig_id=jnp.arange(n, dtype=jnp.int32),
                shape_type=stype,
            )
            cache_feat = state.contact_feat.T             # [CB, N]
            cache_imp = jnp.transpose(state.contact_imp, (1, 2, 0))
            eq = (
                (c_feat[:, None, :] == cache_feat[None, :, :])
                & (c_feat >= 0)[:, None, :]
            ).astype(jnp.float32)                         # [C, CB, N]
            warm = tuple(
                jnp.einsum("cdn,dn->cn", eq, cache_imp[:, i, :])
                for i in range(3)
            )
            vel, ang, (ln, lt1, lt2) = contact_t.solve_contacts_t(
                vel, ang, pos, quat, static.inv_mass,
                static.inv_inertia_body,
                c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep,
                c_valid, static.friction, static.restitution, dt,
                iterations=solver_iterations,
                ground_friction=GROUND_FRICTION,
                warm=warm, return_lambdas=True,
                momentum=solver_momentum,
                block_size=solver_block_size,
                block_shifts=solver_block_shifts,
            )
            imp = jnp.where(
                c_valid.T[..., None],
                jnp.stack([ln.T, lt1.T, lt2.T], axis=-1), 0.0)  # [N, C, 3]
            contact_cache = (
                jnp.where(c_valid, c_feat, -1).T,               # [N, C]
                imp,
            )
        else:
            (c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep, c_valid,
             contact_overflow) = contact_t.box_contacts_t(
                pos, quat, half, nb_idx, nb_ok, ground_ok,
                budget=CONTACT_BUDGET,
                shape_type=stype,
            )
            vel, ang = contact_t.solve_contacts_t(
                vel, ang, pos, quat, static.inv_mass,
                static.inv_inertia_body,
                c_prt, c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz, c_dep,
                c_valid, static.friction, static.restitution, dt,
                iterations=solver_iterations,
                ground_friction=GROUND_FRICTION,
                momentum=solver_momentum,
                block_size=solver_block_size,
                block_shifts=solver_block_shifts,
            )
            contact_cache = None
        return _finish_step(state, static, pos, quat, vel, ang,
                            char_vel_y, char_on_ground, is_dynamic, moving,
                            alive, has_collider, trigger_mode, dt, any_trig,
                            contact_cache=contact_cache,
                            contact_overflow=contact_overflow,
                            group=group)
    if broadphase == "dense":
        from banggameengine_tpu.physics.broadphase import (
            build_neighbor_lists_dense,
        )

        layer_ok = ((static.layer[:, None] & static.mask[None, :]) != 0) & (
            (static.layer[None, :] & static.mask[:, None]) != 0
        )
        any_dyn = is_dynamic[:, None] | is_dynamic[None, :]
        pair_mask = solid[:, None] & solid[None, :] & layer_ok & any_dyn
        nl = build_neighbor_lists_dense(
            pos, quat, static.shape_type, static.shape_size,
            pair_mask, max_neighbors=min(max_neighbors, 8),
        )
        safe_j = jnp.maximum(nl.idx, 0)
        pair_ok = nl.valid
    elif broadphase == "grid":
        # spatial hash + fixed-capacity neighbor lists (10k-body stress)
        from banggameengine_tpu.physics.broadphase import build_neighbor_lists

        nl = build_neighbor_lists(
            pos, quat, static.shape_type, static.shape_size,
            active=solid, cell_size=grid_cell_size,
            table_size=grid_table_size, cell_capacity=grid_cell_capacity,
            max_neighbors=max_neighbors,
        )
        safe_j = jnp.maximum(nl.idx, 0)
        layer_ok = ((static.layer[:, None] & static.mask[safe_j]) != 0) & (
            (static.layer[safe_j] & static.mask[:, None]) != 0
        )
        any_dyn = is_dynamic[:, None] | is_dynamic[safe_j]
        pair_ok = nl.valid & layer_ok & any_dyn & solid[:, None]
    else:
        raise ValueError(f"unknown broadphase '{broadphase}'")

    # ---- narrowphase on surviving pairs only ----------------------------
    p_point, p_normal, p_depth, p_gvalid = nf.pair_contacts(
        pos[:, None], quat[:, None],
        static.shape_type[:, None], static.shape_size[:, None],
        pos[safe_j], quat[safe_j],
        static.shape_type[safe_j], static.shape_size[safe_j],
        enable_capsule=enable_capsule,
    )
    p_valid = p_gvalid & (p_depth > 0.0) & pair_ok[..., None]
    partner = jnp.broadcast_to(nl.idx[:, :, None], p_depth.shape)

    g_point, g_normal, g_depth, g_gvalid = nf.ground_contacts(
        pos, quat, static.shape_type, static.shape_size
    )
    g_valid = (
        g_gvalid
        & (g_depth > 0.0)
        & (is_dynamic & solid)[:, None]
        & jnp.asarray(static.ground_enabled)
    )

    # ---- flatten + fold ground (partner -1) + compact to per-body budget
    m_pair = p_depth.shape[1] * p_depth.shape[2]
    all_b = jnp.concatenate(
        [partner.reshape(n, m_pair),
         jnp.full((n, nf.K_GROUND), -1, jnp.int32)], axis=1,
    )
    all_pt = jnp.concatenate([p_point.reshape(n, m_pair, 3), g_point], axis=1)
    all_n = jnp.concatenate([p_normal.reshape(n, m_pair, 3), g_normal], axis=1)
    all_d = jnp.concatenate([p_depth.reshape(n, m_pair), g_depth], axis=1)
    all_v = jnp.concatenate([p_valid.reshape(n, m_pair), g_valid], axis=1)

    # contact feature ids for the persistent cache: (partner+1)*FEAT_STRIDE
    # + narrowphase slot k for pair contacts (stable across steps because k
    # names a geometric feature — corner index / SAT-center / capsule
    # sample); bare slot id for ground contacts
    k_pair = p_depth.shape[2]
    pair_feat = (partner + 1) * FEAT_STRIDE + jnp.arange(k_pair)[None, None, :]
    all_f = jnp.concatenate(
        [pair_feat.reshape(n, m_pair),
         jnp.broadcast_to(jnp.arange(nf.K_GROUND)[None, :], (n, nf.K_GROUND))],
        axis=1,
    )

    # (the one-hot feature move is exact below 2^24, i.e. capacities < 262k)
    c_b, c_pt, c_n, c_d, c_valid, contact_overflow, c_f = sv.compact_contacts(
        all_b, all_pt, all_n, all_d, all_v, CONTACT_BUDGET, feat=all_f
    )
    safe_b = jnp.maximum(c_b, 0)
    static_side = c_b < 0
    c_mu = jnp.where(
        static_side,
        static.friction[:, None] * GROUND_FRICTION,
        static.friction[:, None] * static.friction[safe_b],
    )
    c_e = jnp.where(
        static_side, 0.0,
        static.restitution[:, None] * static.restitution[safe_b],
    )

    inv_i_w = sv.inv_inertia_world(quat, static.inv_inertia_body)

    if warm_start:
        # feature-match against the previous step's cache (the array image of
        # Bullet's persistent-manifold impulse cache): [C, C0] equality
        # one-hot contraction per body — tiny, dense, vmap-safe
        match = (
            (c_f[:, :, None] == state.contact_feat[:, None, :])
            & (c_f >= 0)[:, :, None]
        ).astype(jnp.float32)
        warm_imp = jnp.einsum("ncd,ndk->nck", match, state.contact_imp)
        warm = (warm_imp[..., 0], warm_imp[..., 1], warm_imp[..., 2])
        vel, ang, (ln, lt1, lt2) = sv.solve_contacts_unified(
            vel, ang, pos, static.inv_mass, inv_i_w,
            c_b, c_pt, c_n, c_d, c_valid, c_mu, c_e, dt,
            iterations=solver_iterations, warm=warm, return_lambdas=True,
            sor=solver_sor, momentum=solver_momentum,
        )
        contact_cache = (
            c_f,
            jnp.where(c_valid[..., None],
                      jnp.stack([ln, lt1, lt2], axis=-1), 0.0),
        )
    else:
        vel, ang = sv.solve_contacts_unified(
            vel, ang, pos, static.inv_mass, inv_i_w,
            c_b, c_pt, c_n, c_d, c_valid, c_mu, c_e, dt,
            iterations=solver_iterations,
            sor=solver_sor, momentum=solver_momentum,
        )
        contact_cache = None
    return _finish_step(state, static, pos, quat, vel, ang,
                        char_vel_y, char_on_ground, is_dynamic, moving,
                        alive, has_collider, trigger_mode, dt, any_trig,
                        contact_cache=contact_cache,
                        contact_overflow=contact_overflow)


def _finish_step(state, static, pos, quat, vel, ang, char_vel_y,
                 char_on_ground, is_dynamic, moving, alive, has_collider,
                 trigger_mode, dt,
                 any_trig=None,
                 contact_cache=None,
                 contact_overflow=None,
                 group=None) -> tuple[WorldState, StepEvents]:
    """Shared step tail: integrate, triggers, state assembly."""
    # semi-implicit Euler integrate dynamic AND kinematic bodies (kinematic
    # velocity is host-driven and persists across steps until changed)
    pos = jnp.where(moving[:, None], pos + vel * dt, pos)
    quat = jnp.where(
        moving[:, None], math3d.quat_integrate(quat, ang, dt), quat
    )
    vel = jnp.where(moving[:, None], vel, jnp.zeros_like(vel))
    ang = jnp.where(moving[:, None], ang, jnp.zeros_like(ang))

    # ------------------------------------------------------------------
    # 3. triggers
    # ------------------------------------------------------------------
    # 'aabb' matches the reference exactly (btPairCachingGhostObject reports
    # BROADPHASE pairs, PhysicsSystem.cpp:1028-1031); 'shape' is the exact
    # shape-overlap variant.  Host-known census: scenes with no trigger
    # slots in use skip the overlap sweep entirely.
    if any_trig is None:
        try:
            import numpy as _np

            any_trig = bool((_np.asarray(static.trig_entity) >= 0).any())
        except jax.errors.TracerArrayConversionError:
            any_trig = True
    if any_trig:
        overlap_fn = (
            tg.trigger_aabb_overlaps if trigger_mode == "aabb"
            else tg.trigger_overlaps
        )
        overlap = overlap_fn(
            static.trig_entity, static.trig_shape, static.trig_size,
            static.trig_layer, static.trig_mask, state.trigger_active,
            pos, quat, static.shape_type, static.shape_size,
            static.layer, static.mask, alive, has_collider,
        )
        if group is not None:
            # block-diagonal multi-world scene: a trigger only sees its
            # own world's entities
            safe_te = jnp.where(static.trig_entity >= 0,
                                static.trig_entity, 0)
            overlap = overlap & (group[safe_te][:, None] == group[None, :])
    else:
        overlap = jnp.zeros_like(state.trigger_overlap)
    enter, stay, exit_, new_overlap, new_active = tg.diff_events(
        state.trigger_overlap, overlap, static.trig_one_shot, state.trigger_active
    )

    cache_updates = {}
    if contact_cache is not None:
        cache_updates = dict(contact_feat=contact_cache[0],
                             contact_imp=contact_cache[1])
    new_state = dataclasses.replace(
        state,
        pos=pos,
        quat=quat,
        lin_vel=vel,
        ang_vel=ang,
        char_vel_y=char_vel_y,
        char_on_ground=char_on_ground,
        trigger_overlap=new_overlap,
        trigger_active=new_active,
        time=state.time + dt,
        step_idx=state.step_idx + 1,
        **cache_updates,
    )
    events = StepEvents(
        trigger_enter=enter, trigger_stay=stay, trigger_exit=exit_,
        contact_overflow=(jnp.int32(0) if contact_overflow is None
                          else contact_overflow.astype(jnp.int32)),
    )
    return new_state, events
