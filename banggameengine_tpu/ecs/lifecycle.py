"""Runtime entity lifecycle: spawn / despawn / reparent without recompile.

The reference Scene supports runtime CRUD — ``CreateEntity/DestroyEntity``
with id recycling (``Scene.cpp:21-83``), ``SetParent`` + hierarchy dirtying
(``Scene.cpp:354-393``), destroy detaching children into roots
(``Scene.cpp:67-76``).  The array build anticipated this with fixed-capacity
padded SoA arrays and an alive mask; this module is the host API over them.

Shape discipline: every mutation preserves array shapes — the alive mask and
component arrays are updated in place (`.at[i].set`), and the level table is
re-baked **into the existing [L, M] rectangle** whenever the new hierarchy
fits, so a step jitted with a *traced* StaticScene
(:func:`banggameengine_tpu.engine.make_hot_reloadable_step_fn`) keeps its
compiled executable.  Only when the hierarchy outgrows the rectangle does the
table grow (one recompile, logged).

Entity ids are recycled lowest-free-first like the reference free list.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import jax.numpy as jnp

from banggameengine_tpu import math3d
from banggameengine_tpu.ecs.transform import compute_levels
from banggameengine_tpu.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    BODY_STATIC,
    COMP_COLLIDER,
    COMP_RIGID_BODY,
    COMP_TRANSFORM,
    COMP_TRIGGER,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    StaticScene,
    WorldState,
)

log = logging.getLogger("Lifecycle")

_BODY_TYPE = {"static": BODY_STATIC, "dynamic": BODY_DYNAMIC,
              "kinematic": BODY_KINEMATIC}
_SHAPE = {"box": SHAPE_BOX, "capsule": SHAPE_CAPSULE}


def _box_inertia_inv(mass: float, half) -> np.ndarray:
    e = 2.0 * np.asarray(half, np.float64)
    i = mass / 12.0 * np.array(
        [e[1] ** 2 + e[2] ** 2, e[0] ** 2 + e[2] ** 2, e[0] ** 2 + e[1] ** 2]
    )
    return np.where(i > 0, 1.0 / np.maximum(i, 1e-12), 0.0).astype(np.float32)


def _rebake_levels(static: StaticScene, alive_np: np.ndarray) -> StaticScene:
    """Recompute the level-order schedule, preserving the [L, M] rectangle
    when the new hierarchy fits inside it (no recompile)."""
    table = compute_levels(np.asarray(static.parent), alive_np)
    old = np.asarray(static.level_nodes)
    lo, mo = old.shape
    ln, mn = table.shape
    if ln <= lo and mn <= mo:
        padded = np.full((lo, mo), -1, np.int32)
        padded[:ln, :mn] = table
        table = padded
    else:
        log.info(
            "[Lifecycle] hierarchy outgrew the level table (%dx%d -> %dx%d); "
            "next step will recompile", lo, mo, table.shape[0], table.shape[1],
        )
    return dataclasses.replace(static, level_nodes=jnp.asarray(table))


def free_slots(state: WorldState) -> np.ndarray:
    """Indices of dead (recyclable) entity slots, ascending."""
    return np.nonzero(~np.asarray(state.alive))[0]


def is_alive(state: WorldState, entity: int) -> bool:
    """Scene::IsAlive (Scene.cpp:43-47)."""
    e = int(entity)
    return 0 <= e < state.capacity and bool(np.asarray(state.alive)[e])


def spawn(
    built,
    state: WorldState,
    *,
    name: str | None = None,
    pos=(0.0, 0.0, 0.0),
    euler=None,
    quat=None,
    scale=(1.0, 1.0, 1.0),
    parent: int | str | None = None,
    collider: dict | None = None,
    rigid_body: dict | None = None,
    trigger: dict | None = None,
    velocity=(0.0, 0.0, 0.0),
) -> tuple[WorldState, int]:
    """Create an entity in the lowest free slot (Scene::CreateEntity with id
    recycling, Scene.cpp:21-41).  Mutates ``built.static`` (and the logical-id
    table) in place; returns the new WorldState and entity id.

    ``collider``: {"shape": "box"|"capsule", "size": (3,)}
    ``rigid_body``: {"type": "static"|"dynamic"|"kinematic", "mass", "friction",
        "restitution", "layer", "mask"}
    ``trigger``: {"shape", "size", "layer", "mask", "one_shot"} — needs a free
        trigger slot (slots are capacity-padded at build).

    Spawned entities are physics/trigger entities; the baked render soup is
    per-scene-load (a spawned entity renders via the debug overlay, not the
    mesh pass — same as the reference spawning an entity with no
    MeshRenderer).
    """
    static = built.static
    free = free_slots(state)
    if len(free) == 0:
        raise RuntimeError(
            f"scene capacity {state.capacity} exhausted; rebuild with a "
            "larger capacity to spawn more entities"
        )
    i = int(free[0])

    if isinstance(parent, str):
        parent = built.find_entity(parent)
        if parent < 0:
            log.warning("[Lifecycle] spawn parent '%s' not found", parent)
    p = -1 if parent is None else int(parent)

    comp = COMP_TRANSFORM
    q = (math3d.quat_from_euler_xyz(jnp.asarray(euler, jnp.float32))
         if euler is not None
         else jnp.asarray(quat if quat is not None else [0, 0, 0, 1],
                          jnp.float32))

    st_updates: dict = {
        "parent": static.parent.at[i].set(p),
        "body_type": static.body_type.at[i].set(0),
        "shape_type": static.shape_type.at[i].set(0),
        "shape_size": static.shape_size.at[i].set(jnp.zeros(3)),
        "inv_mass": static.inv_mass.at[i].set(0.0),
        "inv_inertia_body": static.inv_inertia_body.at[i].set(jnp.zeros(3)),
        "friction": static.friction.at[i].set(0.5),
        "restitution": static.restitution.at[i].set(0.0),
        "layer": static.layer.at[i].set(0),
        "mask": static.mask.at[i].set(0),
    }

    shape_t = SHAPE_BOX
    size = np.zeros(3, np.float32)
    if collider is not None:
        comp |= COMP_COLLIDER
        shape_t = _SHAPE.get(collider.get("shape", "box"), SHAPE_BOX)
        size = np.asarray(collider.get("size", (0.5, 0.5, 0.5)), np.float32).copy()
        if shape_t == SHAPE_BOX:
            size = np.maximum(size, 0.01)  # PhysicsSystem.cpp:692-701 clamps
        else:
            size[0] = max(size[0], 0.01)
            size[1] = max(size[1], 0.0)
            size[2] = 0.0
        st_updates["shape_type"] = static.shape_type.at[i].set(shape_t)
        st_updates["shape_size"] = static.shape_size.at[i].set(jnp.asarray(size))
        # collider without body: static collision-only (build_scene parity)
        st_updates["body_type"] = static.body_type.at[i].set(BODY_STATIC)
        st_updates["layer"] = static.layer.at[i].set(1)
        st_updates["mask"] = static.mask.at[i].set(0xFFFFFFFF)

    if rigid_body is not None:
        comp |= COMP_RIGID_BODY
        bt = _BODY_TYPE.get(rigid_body.get("type", "static"), BODY_STATIC)
        st_updates["body_type"] = static.body_type.at[i].set(bt)
        st_updates["friction"] = static.friction.at[i].set(
            float(rigid_body.get("friction", 0.5)))
        st_updates["restitution"] = static.restitution.at[i].set(
            float(rigid_body.get("restitution", 0.0)))
        st_updates["layer"] = static.layer.at[i].set(
            int(rigid_body.get("layer", 1)) or 1)
        st_updates["mask"] = static.mask.at[i].set(
            int(rigid_body.get("mask", 0xFFFFFFFF)))
        if bt == BODY_DYNAMIC:
            m = max(float(rigid_body.get("mass", 1.0)), 0.01)
            st_updates["inv_mass"] = static.inv_mass.at[i].set(1.0 / m)
            if shape_t == SHAPE_CAPSULE:
                half = np.array([size[0], size[1] + size[0], size[0]],
                                np.float32)
            else:
                half = size
            st_updates["inv_inertia_body"] = static.inv_inertia_body.at[i].set(
                jnp.asarray(_box_inertia_inv(m, half)))

    trig_slot = -1
    if trigger is not None:
        comp |= COMP_TRIGGER
        slots = np.asarray(static.trig_entity)
        empty = np.nonzero(slots < 0)[0]
        if len(empty) == 0:
            raise RuntimeError(
                "no free trigger slots; rebuild with max_trigger_slots > "
                f"{static.num_trigger_slots}"
            )
        trig_slot = int(empty[0])
        tshape = _SHAPE.get(trigger.get("shape", "box"), SHAPE_BOX)
        st_updates["trig_entity"] = static.trig_entity.at[trig_slot].set(i)
        st_updates["trig_shape"] = static.trig_shape.at[trig_slot].set(tshape)
        st_updates["trig_size"] = static.trig_size.at[trig_slot].set(
            jnp.asarray(trigger.get("size", (0.5, 0.5, 0.5)), jnp.float32))
        st_updates["trig_layer"] = static.trig_layer.at[trig_slot].set(
            int(trigger.get("layer", 4)))
        st_updates["trig_mask"] = static.trig_mask.at[trig_slot].set(
            int(trigger.get("mask", 0xFFFFFFFF)))
        st_updates["trig_one_shot"] = static.trig_one_shot.at[trig_slot].set(
            bool(trigger.get("one_shot", False)))

    new_static = dataclasses.replace(static, **st_updates)

    alive_np = np.asarray(state.alive).copy()
    alive_np[i] = True
    new_static = _rebake_levels(new_static, alive_np)
    built.static = new_static

    zero3 = jnp.zeros(3, jnp.float32)
    new_state = dataclasses.replace(
        state,
        alive=state.alive.at[i].set(True),
        comp_mask=state.comp_mask.at[i].set(np.uint32(comp)),
        pos=state.pos.at[i].set(jnp.asarray(pos, jnp.float32)),
        quat=state.quat.at[i].set(q),
        scale=state.scale.at[i].set(jnp.asarray(scale, jnp.float32)),
        lin_vel=state.lin_vel.at[i].set(jnp.asarray(velocity, jnp.float32)),
        ang_vel=state.ang_vel.at[i].set(zero3),
        char_vel_y=state.char_vel_y.at[i].set(0.0),
        char_on_ground=state.char_on_ground.at[i].set(False),
    )
    if trig_slot >= 0:
        new_state = dataclasses.replace(
            new_state,
            trigger_active=new_state.trigger_active.at[trig_slot].set(
                bool(trigger.get("active", True))),
            trigger_overlap=new_state.trigger_overlap.at[trig_slot].set(
                jnp.zeros_like(new_state.trigger_overlap[trig_slot])),
        )

    # logical-id registration (Scene.cpp:508-521 semantics; dupes overwrite)
    while len(built.entity_names) < state.capacity:
        built.entity_names.append("")
    if name:
        built.logical_ids[name] = i
        built.entity_names[i] = name
    else:
        built.entity_names[i] = f"__entity_{i}"
    built.counts["entities"] += 1
    return new_state, i


def despawn(built, state: WorldState, entity: int) -> WorldState:
    """Destroy an entity (Scene::DestroyEntity, Scene.cpp:43-83): the slot is
    recycled, children detach and become roots (Scene.cpp:67-76), the logical
    id is erased, any trigger slot is vacated."""
    i = int(entity)
    if not is_alive(state, i):
        return state
    static = built.static

    # children become roots
    parent_np = np.asarray(static.parent).copy()
    parent_np[parent_np == i] = -1
    parent_np[i] = -1

    st_updates = {"parent": jnp.asarray(parent_np),
                  "body_type": static.body_type.at[i].set(0),
                  "layer": static.layer.at[i].set(0),
                  "mask": static.mask.at[i].set(0)}

    # vacate trigger slots owned by this entity
    slots = np.asarray(static.trig_entity)
    owned = np.nonzero(slots == i)[0]
    trig_entity = static.trig_entity
    for s in owned:
        trig_entity = trig_entity.at[int(s)].set(-1)
    if len(owned):
        st_updates["trig_entity"] = trig_entity

    # vacate character slots (reference prunes dead characters,
    # PhysicsSystem.cpp:1271-1284)
    cslots = np.asarray(static.char_entity)
    cowned = np.nonzero(cslots == i)[0]
    char_entity = static.char_entity
    for s in cowned:
        char_entity = char_entity.at[int(s)].set(-1)
    if len(cowned):
        st_updates["char_entity"] = char_entity

    new_static = dataclasses.replace(static, **st_updates)
    alive_np = np.asarray(state.alive).copy()
    alive_np[i] = False
    new_static = _rebake_levels(new_static, alive_np)
    built.static = new_static

    # erase logical id (Scene.cpp:82)
    for k, v in list(built.logical_ids.items()):
        if v == i:
            del built.logical_ids[k]
    if i < len(built.entity_names):
        built.entity_names[i] = ""
    built.counts["entities"] -= 1

    zero3 = jnp.zeros(3, jnp.float32)
    new_state = dataclasses.replace(
        state,
        alive=state.alive.at[i].set(False),
        comp_mask=state.comp_mask.at[i].set(np.uint32(0)),
        lin_vel=state.lin_vel.at[i].set(zero3),
        ang_vel=state.ang_vel.at[i].set(zero3),
    )
    if len(owned):
        for s in owned:
            new_state = dataclasses.replace(
                new_state,
                trigger_overlap=new_state.trigger_overlap.at[int(s)].set(
                    jnp.zeros_like(new_state.trigger_overlap[int(s)])),
            )
    return new_state


def reparent(built, state: WorldState, entity: int,
             new_parent: int | str | None) -> None:
    """Scene::SetParent (Scene.cpp:354-393): local transform is kept, the
    world transform re-derives under the new parent on the next step."""
    i = int(entity)
    if isinstance(new_parent, str):
        new_parent = built.find_entity(new_parent)
    p = -1 if new_parent is None else int(new_parent)
    if p == i:
        log.warning("[Lifecycle] reparent to self ignored")
        return
    static = built.static
    # cycle guard: walking up from p must not reach i
    parent_np = np.asarray(static.parent).copy()
    j, guard = p, 0
    while j >= 0 and guard <= len(parent_np):
        if j == i:
            log.warning("[Lifecycle] reparent would create a cycle; ignored")
            return
        j = int(parent_np[j])
        guard += 1
    parent_np[i] = p
    new_static = dataclasses.replace(static, parent=jnp.asarray(parent_np))
    built.static = _rebake_levels(new_static, np.asarray(state.alive))
