"""Trigger volumes: overlap sets and Enter/Stay/Exit events.

Replaces the reference's ghost-object overlap machinery
(``PhysicsSystem.cpp:523-590`` trigger build, ``:1017-1074`` overlap diff +
EventBus publish + oneShot deactivation) with set arithmetic on dense boolean
masks — the callback-based EventBus becomes event arrays returned from the
step (SURVEY.md §7 "Events without callbacks").

Filter semantics mirror Bullet's group/mask test both ways:
``(trig_layer & other_mask) && (other_layer & trig_mask)``.
oneShot deactivation happens *inside* the step so it stays correct under
``vmap`` (each world deactivates its own triggers).
"""

from __future__ import annotations

import jax.numpy as jnp

from banggameengine_tpu.physics import narrowphase as nf
from banggameengine_tpu.physics import shapes as sh


def trigger_overlaps(
    # trigger slots
    trig_entity, trig_shape, trig_size, trig_layer, trig_mask,
    trigger_active,
    # entities
    pos, quat, shape_type, size, layer, mask, alive, has_collision,
):
    """Current overlap matrix bool[T, N]: trigger slot x entity.

    Overlap is true shape-overlap of the trigger volume against the entity's
    collision shape (box SAT / capsule distance via the narrowphase helpers).
    The trigger's own entity is excluded.
    """
    n = pos.shape[0]
    safe_te = jnp.where(trig_entity >= 0, trig_entity, 0)
    tpos = pos[safe_te]           # [T,3]
    tquat = quat[safe_te]
    ttype = trig_shape.astype(shape_type.dtype)

    # [T, N] boolean block only (never the (T+N)^2 matrix; no manifolds)
    overlap = nf.boolean_overlap_pairs(
        tpos[:, None], tquat[:, None], ttype[:, None], trig_size[:, None],
        pos[None, :], quat[None, :], shape_type[None, :], size[None, :],
    )

    layer_ok = ((trig_layer[:, None] & mask[None, :]) != 0) & (
        (layer[None, :] & trig_mask[:, None]) != 0
    )
    valid = (
        (trig_entity[:, None] >= 0)
        & trigger_active[:, None]
        & alive[None, :]
        & has_collision[None, :]
        & (trig_entity[:, None] != jnp.arange(n)[None, :])
        & layer_ok
    )
    return overlap & valid


def trigger_aabb_overlaps(
    trig_entity, trig_shape, trig_size, trig_layer, trig_mask, trigger_active,
    pos, quat, shape_type, size, layer, mask, alive, has_collision,
):
    """AABB-level overlap bool[T, N] — Bullet ghost-pair fidelity mode
    (btPairCachingGhostObject reports broadphase pairs)."""
    n = pos.shape[0]
    safe_te = jnp.where(trig_entity >= 0, trig_entity, 0)
    tmn, tmx = sh.shape_aabb(pos[safe_te], quat[safe_te],
                             trig_shape.astype(shape_type.dtype), trig_size)
    emn, emx = sh.shape_aabb(pos, quat, shape_type, size)
    # axis-at-a-time compares: three dense [T,N] compares instead of a
    # [T,N,3] intermediate with 3 on the minor dim
    overlap = jnp.ones((tmn.shape[0], n), bool)
    for j in range(3):
        overlap &= (tmn[:, j][:, None] <= emx[:, j][None, :]) \
            & (emn[:, j][None, :] <= tmx[:, j][:, None])
    layer_ok = ((trig_layer[:, None] & mask[None, :]) != 0) & (
        (layer[None, :] & trig_mask[:, None]) != 0
    )
    valid = (
        (trig_entity[:, None] >= 0)
        & trigger_active[:, None]
        & alive[None, :]
        & has_collision[None, :]
        & (trig_entity[:, None] != jnp.arange(n)[None, :])
        & layer_ok
    )
    return overlap & valid


def diff_events(prev_overlap, now_overlap, trig_one_shot, trigger_active):
    """Overlap diff -> (enter, stay, exit, new_overlap, new_active).

    Mirrors ``ProcessTriggerEvents`` (PhysicsSystem.cpp:1040-1072): Enter on
    appear, Stay on persist, Exit on disappear; a oneShot trigger deactivates
    after its first Enter (subsequent steps produce nothing).
    """
    enter = now_overlap & ~prev_overlap
    stay = now_overlap & prev_overlap
    exit_ = prev_overlap & ~now_overlap
    fired = jnp.any(enter, axis=1)
    new_active = trigger_active & ~(trig_one_shot & fired)
    return enter, stay, exit_, now_overlap, new_active
