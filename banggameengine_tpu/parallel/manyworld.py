"""Many-world data parallelism: vmap over worlds, shard over the device mesh.

The reference is a single-threaded single-world loop
(``Application.cpp:78-148``); this engine's scaling axis is **worlds**
(SURVEY.md §2 "Parallelism & distributed communication"): ``jax.vmap`` turns
the engine step into a lockstep many-world simulator, and a 1-D
``jax.sharding.Mesh`` over the world axis distributes it across the
devices.  Worlds are embarrassingly parallel — the compiled step contains
**no cross-device collectives**; XLA only inserts them for the optional
metric reductions (``psum``-style means over the world axis).

This file is the framework's entire distributed-communication story.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from banggameengine_tpu.engine import engine_step
from banggameengine_tpu.state import InputFrame, StaticScene, WorldState

WORLD_AXIS = "world"


def make_world_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices, axis name 'world'."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (WORLD_AXIS,))


def replicate_state(state: WorldState, num_worlds: int) -> WorldState:
    """Stack one world into a [W, ...] batch."""
    return jax.tree.map(lambda x: jnp.stack([x] * num_worlds), state)


def replicate_input(inp: InputFrame, num_worlds: int) -> InputFrame:
    return jax.tree.map(lambda x: jnp.stack([x] * num_worlds), inp)


def shard_batched(tree, mesh: Mesh):
    """Place a [W, ...]-batched pytree with the leading axis sharded over the
    world mesh axis."""

    def put(x):
        spec = P(WORLD_AXIS, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)


def world_metrics(state: WorldState) -> dict:
    """Per-world scalar diagnostics, reduced across worlds by the caller.
    Computed inside the sharded step so the mean is an XLA collective over
    ICI (the engine-domain analog of a ``psum`` loss reduction)."""
    ke = 0.5 * jnp.sum(state.lin_vel**2, axis=(-2, -1))
    return {
        "mean_kinetic_energy": ke,
        "mean_height": jnp.sum(state.pos[..., 1] * state.alive, axis=-1)
        / jnp.maximum(jnp.sum(state.alive, axis=-1), 1),
    }


def make_sharded_many_world_step(
    static: StaticScene,
    mesh: Optional[Mesh] = None,
    num_steps: int = 1,
    solver_iterations: int = 10,
    with_metrics: bool = False,
    world_minor: bool = False,
    **physics_kwargs,
):
    """Build the jitted sharded lockstep-many-worlds step.

    Returns ``step(batched_state, batched_input) -> batched_state`` (or
    ``(state, metrics)`` with ``with_metrics``); state arrays must carry a
    leading world axis, which is sharded across the mesh.  ``num_steps > 1``
    folds a ``lax.scan`` inside the single dispatch (driver config #5:
    1k worlds stepped in lockstep).

    ``world_minor=True`` vmaps over the LAST axis instead of the first
    (JAX's batching rules canonicalize the batch dim back to axis 0 inside
    most primitives, so in_axes only moves the boundary transposes).  Kept
    for experiments; the dense-layout alternative is
    :func:`make_flat_many_world_step`.
    """
    mesh = mesh or make_world_mesh()

    from banggameengine_tpu.physics.step import scene_census

    kwargs = {**scene_census(static), **physics_kwargs}
    ax = -1 if world_minor else 0
    vstep = jax.vmap(
        lambda s, i, st: engine_step(s, i, st, solver_iterations,
                                     **kwargs)[0],
        in_axes=(ax, ax, None), out_axes=ax,
    )

    def run(bstate, binp, st):
        if world_minor:
            bstate = jax.tree.map(lambda a: jnp.moveaxis(a, 0, -1), bstate)
            binp = jax.tree.map(lambda a: jnp.moveaxis(a, 0, -1), binp)
        if num_steps == 1:
            out = vstep(bstate, binp, st)
        else:
            def body(carry, _):
                return vstep(carry, binp, st), None

            out, _ = jax.lax.scan(body, bstate, None, length=num_steps,
                                  unroll=2)
        if world_minor:
            out = jax.tree.map(lambda a: jnp.moveaxis(a, -1, 0), out)
        if with_metrics:
            m = world_metrics(out)
            metrics = {k: jnp.mean(v) for k, v in m.items()}
            return out, metrics
        return out

    # jit infers output shardings from the (already device_put) inputs;
    # donation keeps stepping in-place per shard.  The static scene is a
    # traced argument (replicated), not an embedded constant.
    jfn = jax.jit(run, donate_argnums=(0,))
    static = jax.device_put(static)
    step = lambda bstate, binp: jfn(bstate, binp, static)
    step.jitted, step.bound_static = jfn, static   # for AOT/trace tools
    return step


# ---------------------------------------------------------------------------
# Flat block-diagonal many-world: one big world, static neighbor structure
# ---------------------------------------------------------------------------

def _flat_static(static: StaticScene, num_worlds: int,
                 comp_mask_1w: np.ndarray):
    """Tile one world's StaticScene into a [W*B]-entity block-diagonal
    scene + the static intra-world neighbor lists and the per-entity world
    group ids.  Host-side (numpy): runs once per factory call.

    The per-world batched path (vmap over a leading world axis) leaves
    every contact tensor [W,B,C,3]-minor.  Flattened, the whole contact
    phase runs through the transposed component-form pipeline
    (:mod:`physics.contact_t`) with the W*B body axis minor.  Neighbors
    never cross world blocks, so no broadphase runs at all.
    """
    import dataclasses

    from banggameengine_tpu.state import (
        COMP_CHARACTER, COMP_COLLIDER, SHAPE_BOX,
    )

    w = num_worlds
    b = int(static.parent.shape[0])
    n = w * b

    def tile_ent(a):
        a = np.asarray(a)
        return np.tile(a, (w,) + (1,) * (a.ndim - 1))

    offs = (np.arange(w, dtype=np.int32) * b)

    def off_slots(ent):
        ent = np.asarray(ent)
        out = ent[None, :] + np.where(ent[None, :] >= 0, offs[:, None], 0)
        return out.reshape(-1).astype(np.int32)

    def tile_slots(a):
        a = np.asarray(a)
        return np.tile(a, (w,) + (1,) * (a.ndim - 1))

    # Parented hierarchies (round 5): parent ids and the level-ordered
    # propagation tile over flat worlds exactly like every per-entity
    # array — offset the ids by each world's block start.  level_nodes
    # [L, M] becomes [L, W*M] (each level holds every world's nodes; -1
    # padding stays -1).  Reference scenes using ``children``/``parent``
    # (SceneLoader.cpp:629-648) keep the fast path.
    ln = np.asarray(static.level_nodes)
    flat_ln = np.where(ln[None, :, :] >= 0,
                       ln[None, :, :] + offs[:, None, None], -1)
    flat_ln = np.transpose(flat_ln, (1, 0, 2)).reshape(
        ln.shape[0], w * ln.shape[1]).astype(np.int32)

    flat = dataclasses.replace(
        static,
        parent=jnp.asarray(off_slots(static.parent)),
        level_nodes=jnp.asarray(flat_ln),
        body_type=jnp.asarray(tile_ent(static.body_type)),
        shape_type=jnp.asarray(tile_ent(static.shape_type)),
        shape_size=jnp.asarray(tile_ent(static.shape_size)),
        inv_mass=jnp.asarray(tile_ent(static.inv_mass)),
        inv_inertia_body=jnp.asarray(tile_ent(static.inv_inertia_body)),
        friction=jnp.asarray(tile_ent(static.friction)),
        restitution=jnp.asarray(tile_ent(static.restitution)),
        layer=jnp.asarray(tile_ent(static.layer)),
        mask=jnp.asarray(tile_ent(static.mask)),
        trig_entity=jnp.asarray(off_slots(static.trig_entity)),
        trig_shape=jnp.asarray(tile_slots(static.trig_shape)),
        trig_size=jnp.asarray(tile_slots(static.trig_size)),
        trig_layer=jnp.asarray(tile_slots(static.trig_layer)),
        trig_mask=jnp.asarray(tile_slots(static.trig_mask)),
        trig_one_shot=jnp.asarray(tile_slots(static.trig_one_shot)),
        char_entity=jnp.asarray(off_slots(static.char_entity)),
        char_radius=jnp.asarray(tile_slots(static.char_radius)),
        char_half_height=jnp.asarray(tile_slots(static.char_half_height)),
        char_walk_speed=jnp.asarray(tile_slots(static.char_walk_speed)),
        char_jump_impulse=jnp.asarray(tile_slots(static.char_jump_impulse)),
    )

    # solid shapes of one world (the bodies the contact pipeline sees):
    # boxes AND capsules (round 4 — the transposed pipeline handles mixed
    # shapes); characters are ghosts and never reach the solver
    from banggameengine_tpu.state import SHAPE_CAPSULE

    ce = np.asarray(static.char_entity)
    is_char = np.zeros(b, bool)
    is_char[ce[ce >= 0]] = True
    st_np = np.asarray(static.shape_type)
    solid = (
        ((comp_mask_1w & COMP_COLLIDER) != 0)
        & ((st_np == SHAPE_BOX) | (st_np == SHAPE_CAPSULE))
        & ~is_char
    )
    sol = np.where(solid)[0]
    k = max(int(len(sol)) - 1, 1)
    loc_idx = np.zeros((b, k), np.int32)
    loc_val = np.zeros((b, k), bool)
    for i in sol:
        others = [j for j in sol if j != i]
        loc_idx[i, :len(others)] = others
        loc_val[i, :len(others)] = True
    nb_idx = (loc_idx[None] + offs[:, None, None]).reshape(n, k)
    nb_val = np.tile(loc_val, (w, 1))
    group = np.repeat(np.arange(w, dtype=np.int32), b)
    # char slot w's obstacle candidates = its own world's entity block
    char_cand = (offs[:, None] + np.arange(b, dtype=np.int32)[None, :])
    # the static set of partner offsets (partner_id - row_id) the block
    # topology can produce: every partner read in the solver and the
    # neighbor-validity masks become rolls over exactly this set
    # (solve_contacts_t block_shifts)
    rows = np.arange(b, dtype=np.int64)[:, None]
    shifts = tuple(sorted({int(d) for d in
                           (loc_idx[loc_val] - np.broadcast_to(
                               rows, loc_idx.shape)[loc_val])}))
    return (flat, jnp.asarray(nb_idx), jnp.asarray(nb_val),
            jnp.asarray(group), jnp.asarray(char_cand), shifts)


def make_flat_many_world_step(
    static: StaticScene,
    num_worlds: int,
    comp_mask_1w,
    num_steps: int = 1,
    solver_iterations: int = 10,
    mesh: Optional[Mesh] = None,
    **physics_kwargs,
):
    """Flat block-diagonal lockstep many-worlds step.

    Same interface as :func:`make_sharded_many_world_step` —
    ``step(batched_state [W,B,...], batched_input [W]) -> batched_state``
    — but internally the W worlds run as ONE flat world of W*B entities
    through the transposed contact pipeline with STATIC intra-world
    neighbor lists (``physics_step(broadphase="static")``).  Per-world
    semantics are preserved: characters read their own world's input row
    (slot w = world w), and characters/triggers are group-masked to their
    world block.  ``comp_mask_1w`` is one world's host-side component mask
    (used to find the solid boxes at build time).

    Multi-device (round 5): pass ``mesh`` to shard the WORLD axis.  Worlds
    are embarrassingly parallel, so each device flattens its LOCAL
    ``W/D`` worlds into one block-diagonal world and runs the identical
    single-device program under ``jax.shard_map`` — the compiled step
    contains **no collectives** and per-chip throughput equals the
    single-chip flat number at ``W/D`` worlds.  Requires
    ``num_worlds % n_devices == 0`` (raises ``ValueError`` otherwise).

    Solid capsules are supported (round 4), and parented hierarchies
    (round 5): parent ids / level_nodes tile over world blocks like every
    per-entity array, so reference scenes using ``children``/``parent``
    (SceneLoader.cpp:629-648) keep the fast path.  Remaining restriction:
    the neighbor topology is baked at build time, so runtime entity
    spawn/despawn (ecs.lifecycle) does not extend the contact graph inside
    this step — use the vmapped path for scenes that mutate their body set
    (dead bodies are still masked out correctly via ``alive``).
    """
    from banggameengine_tpu.physics.step import scene_census

    n_dev = 1 if mesh is None else int(np.prod(mesh.devices.shape))
    if n_dev > 1 and num_worlds % n_dev != 0:
        raise ValueError(
            f"flat many-world sharding needs num_worlds ({num_worlds}) "
            f"divisible by the mesh size ({n_dev})")
    w = num_worlds // n_dev              # worlds per device shard
    flat_static, nb_idx, nb_val, group, char_cand, shifts = _flat_static(
        static, w, np.asarray(comp_mask_1w))
    census = scene_census(static)
    kwargs = {**census, **physics_kwargs}
    kwargs.update(broadphase="static",
                  # per-world entity block: partners never cross worlds,
                  # so the solver swaps its per-iteration partner gather
                  # for lane rolls over the static shift set
                  solver_block_size=int(static.body_type.shape[0]),
                  solver_block_shifts=shifts)
    t1 = int(static.trig_entity.shape[0])   # trigger slots per world

    def vstep(fs, binp, st, nb, nv, grp, cc):
        s2, _ev = engine_step(fs, binp, st, solver_iterations,
                              static_neighbors=(nb, nv), group=grp,
                              char_candidates=cc, **kwargs)
        return s2

    def run(bstate, binp, st, nb, nv, grp, cc):
        from banggameengine_tpu.state import FEAT_STRIDE

        b = bstate.alive.shape[1]
        n = w * b
        di = jnp.arange(w)

        # Contact features encode partner ids: pair features are
        # (partner+1)*FEAT_STRIDE + slot (>= FEAT_STRIDE), ground features
        # are bare slot ids (< FEAT_STRIDE).  Flat partner = w*B + partner,
        # so the per-world <-> flat remap is a pure offset of
        # world*B*FEAT_STRIDE on pair features — the warm-start cache
        # SURVIVES dispatch boundaries instead of resetting (round-3
        # verdict #6: interactive single-step dispatch kept losing every
        # manifold at the flatten/unflatten seam).
        def feat_to_flat(feat_wb):            # [W,B,CB] per-world ids
            off = (jnp.arange(w, dtype=jnp.int32) * b
                   * FEAT_STRIDE)[:, None, None]
            return jnp.where(feat_wb >= FEAT_STRIDE, feat_wb + off, feat_wb)

        def feat_to_world(feat_flat):         # [W,B,CB] flat ids
            off = (jnp.arange(w, dtype=jnp.int32) * b
                   * FEAT_STRIDE)[:, None, None]
            return jnp.where(feat_flat >= FEAT_STRIDE, feat_flat - off,
                             feat_flat)

        def flatten(s):
            f = {}
            for name in ("alive", "comp_mask", "pos", "quat", "scale",
                         "world", "lin_vel", "ang_vel", "char_vel_y",
                         "char_on_ground", "contact_imp"):
                a = getattr(s, name)
                f[name] = a.reshape((n,) + a.shape[2:])
            cf = feat_to_flat(s.contact_feat)
            f["contact_feat"] = cf.reshape((n,) + cf.shape[2:])
            ov = jnp.zeros((w, t1, w, b), bool)
            ov = ov.at[di, :, di, :].set(s.trigger_overlap)
            f["trigger_overlap"] = ov.reshape(w * t1, n)
            f["trigger_active"] = s.trigger_active.reshape(w * t1)
            # lockstep: every world shares the clock
            f["time"] = s.time[0]
            f["step_idx"] = s.step_idx[0]
            return WorldState(**f)

        def unflatten(fs, template):
            f = {}
            for name in ("alive", "comp_mask", "pos", "quat", "scale",
                         "world", "lin_vel", "ang_vel", "char_vel_y",
                         "char_on_ground", "contact_imp"):
                a = getattr(fs, name)
                f[name] = a.reshape((w, b) + a.shape[1:])
            cf = fs.contact_feat.reshape((w, b) + fs.contact_feat.shape[1:])
            f["contact_feat"] = feat_to_world(cf)
            ov = fs.trigger_overlap.reshape(w, t1, w, b)
            f["trigger_overlap"] = ov[di, :, di, :].reshape(w, t1, b)
            f["trigger_active"] = fs.trigger_active.reshape(w, t1)
            f["time"] = jnp.broadcast_to(fs.time, (w,))
            f["step_idx"] = jnp.broadcast_to(fs.step_idx, (w,))
            return WorldState(**f)

        fs = flatten(bstate)
        if num_steps == 1:
            fs = vstep(fs, binp, st, nb, nv, grp, cc)
        else:
            def body(carry, _):
                return vstep(carry, binp, st, nb, nv, grp, cc), None

            fs, _ = jax.lax.scan(body, fs, None, length=num_steps,
                                 unroll=2)
        return unflatten(fs, bstate)

    if n_dev > 1:
        # One flat block-diagonal world of (W/D)*B entities per device;
        # statics replicated, state/input world-axis sharded.  check_vma
        # off: donation + replicated statics, no collectives to verify.
        fn = jax.shard_map(
            run, mesh=mesh,
            in_specs=(P(WORLD_AXIS), P(WORLD_AXIS), P(), P(), P(), P(),
                      P()),
            out_specs=P(WORLD_AXIS), check_vma=False,
        )
        put = lambda x: jax.device_put(x, NamedSharding(mesh, P()))
    else:
        fn = run
        put = jax.device_put
    jfn = jax.jit(fn, donate_argnums=(0,))
    st = jax.tree.map(put, flat_static)
    nb_idx = put(nb_idx)
    nb_val = put(nb_val)
    group = put(group)
    char_cand = put(char_cand)
    step = lambda bstate, binp: jfn(bstate, binp, st, nb_idx, nb_val,
                                    group, char_cand)
    step.jitted = jfn
    step.bound_static = (st, nb_idx, nb_val, group, char_cand)
    return step


def make_many_world_step(
    static: StaticScene,
    mesh: Mesh,
    comp_mask_1w,
    num_worlds: int,
    num_steps: int = 1,
    verbose: bool = True,
    **physics_kwargs,
):
    """Auto-routing many-world factory: ``(step, layout)``.

    Picks the flat block-diagonal layout (the W*B body axis minor, instead
    of the vmapped [W, B, ...] layout's per-world rows) on BOTH single- and
    multi-device meshes: on several devices, each runs its own W/D-world
    flat block under ``shard_map`` (no collectives).  Falls back to the
    vmapped layout LOUDLY and ONLY on the host-side build rejections the
    flat builder actually raises (``ValueError``: world count not divisible
    by the mesh, dynamic-topology scenes) — device-side compile failures of
    the default layout PROPAGATE so a regression never silently ships the
    slower path.
    """
    try:
        step = make_flat_many_world_step(
            static, num_worlds, comp_mask_1w, num_steps=num_steps,
            mesh=mesh, **physics_kwargs)
        layout = ("flat" if int(np.prod(mesh.devices.shape)) == 1
                  else "flat-sharded")
        return step, layout
    except ValueError as e:  # host-side build rejection (topology)
        if verbose:
            print(f"[manyworld] flat layout unavailable "
                  f"({type(e).__name__}: {e}); using vmapped")
    step = make_sharded_many_world_step(
        static, mesh, num_steps=num_steps, **physics_kwargs)
    return step, "vmapped"
