"""Shape geometry helpers: AABBs, box corners, capsule segments.

Shared by broadphase, narrowphase, triggers, raycast and the character
controller.  Shape encoding follows :mod:`banggameengine_tpu.state`:
box ``size`` = half extents, capsule ``size`` = (radius, half_height, 0)
where half_height is half the *cylinder* section (Bullet capsule convention,
``PhysicsSystem.cpp:686-707``).  Collider sizes are world-space and ignore
entity scale, matching the reference (``EnsureCharacter`` comment block and
``CreateShape``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from banggameengine_tpu import math3d
from banggameengine_tpu.state import SHAPE_BOX, SHAPE_CAPSULE

Array = jax.Array

def box_corners(pos: Array, quat: Array, half: Array) -> Array:
    """World-space corners of an oriented box. [..., 8, 3].

    The 8 sign combinations (corner k flips axis a iff bit a of k) are built
    from the *traced* half extents rather than a module-level jnp table
    (a module-level jnp array would be captured into every executable as
    a device constant).
    """
    hx, hy, hz = half[..., 0], half[..., 1], half[..., 2]
    local = jnp.stack(
        [
            jnp.stack([-hx, -hy, -hz], -1), jnp.stack([hx, -hy, -hz], -1),
            jnp.stack([-hx, hy, -hz], -1), jnp.stack([hx, hy, -hz], -1),
            jnp.stack([-hx, -hy, hz], -1), jnp.stack([hx, -hy, hz], -1),
            jnp.stack([-hx, hy, hz], -1), jnp.stack([hx, hy, hz], -1),
        ],
        axis=-2,
    )
    return math3d.quat_rotate(quat[..., None, :], local) + pos[..., None, :]


def capsule_segment(pos: Array, quat: Array, half_height: Array) -> tuple[Array, Array]:
    """World-space endpoints of a capsule's core segment (Y axis in local
    frame, Bullet's default capsule orientation)."""
    up = jnp.zeros(pos.shape[:-1] + (3,), jnp.float32).at[..., 1].set(half_height)
    axis = math3d.quat_rotate(quat, up)
    return pos - axis, pos + axis


def shape_aabb(pos: Array, quat: Array, shape_type: Array, size: Array) -> tuple[Array, Array]:
    """Conservative world AABB for each shape. Returns (min, max) [..., 3].

    Box: rotate half extents through |R|; capsule: segment extent + radius.
    Unknown/none shapes get a zero-size AABB at pos.
    """
    r = math3d.quat_to_mat3(quat)
    box_ext = jnp.einsum("...ij,...j->...i", jnp.abs(r), size)
    a, b = capsule_segment(pos, quat, size[..., 1])
    cap_min = jnp.minimum(a, b) - size[..., 0:1]
    cap_max = jnp.maximum(a, b) + size[..., 0:1]

    is_box = (shape_type == SHAPE_BOX)[..., None]
    is_cap = (shape_type == SHAPE_CAPSULE)[..., None]
    mn = jnp.where(is_box, pos - box_ext, jnp.where(is_cap, cap_min, pos))
    mx = jnp.where(is_box, pos + box_ext, jnp.where(is_cap, cap_max, pos))
    return mn, mx


def aabb_overlap(mn_a, mx_a, mn_b, mx_b, margin: float = 0.0) -> Array:
    """Boolean AABB intersection test (broadcasts)."""
    return jnp.all((mn_a <= mx_b + margin) & (mn_b <= mx_a + margin), axis=-1)


def closest_point_on_box(q: Array, half: Array) -> tuple[Array, Array, Array]:
    """Closest point on a *local-frame* box to local point q.

    Returns (point, normal, signed_dist): for q outside, normal is the
    outward direction from the surface point toward q and signed_dist > 0;
    for q inside, the nearest face is used and signed_dist < 0 (= -face
    clearance).  Fully branchless.
    """
    clamped = jnp.clip(q, -half, half)
    delta = q - clamped
    dist = jnp.linalg.norm(delta, axis=-1)
    outside = dist > 1e-9
    n_out = delta / jnp.maximum(dist, 1e-9)[..., None]

    # inside: distance to each face, pick the minimum
    face_clear = half - jnp.abs(q)  # >= 0 when inside
    axis = jnp.argmin(face_clear, axis=-1)
    sign = jnp.sign(jnp.take_along_axis(q, axis[..., None], axis=-1))
    sign = jnp.where(sign == 0.0, 1.0, sign)
    n_in = (
        jax.nn.one_hot(axis, 3, dtype=q.dtype) * sign
    )
    min_clear = jnp.take_along_axis(face_clear, axis[..., None], axis=-1)[..., 0]
    # inside surface point: project q onto the chosen face
    p_in = q + n_in * min_clear[..., None]

    point = jnp.where(outside[..., None], clamped, p_in)
    normal = jnp.where(outside[..., None], n_out, n_in)
    sdist = jnp.where(outside, dist, -min_clear)
    return point, normal, sdist


def closest_segment_segment(p1, q1, p2, q2):
    """Closest points between segments [p1,q1] and [p2,q2] (branchless
    Ericson RTCD 5.1.9).  Returns (c1, c2)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = jnp.sum(d1 * d1, -1)
    e = jnp.sum(d2 * d2, -1)
    f = jnp.sum(d2 * r, -1)
    c = jnp.sum(d1 * r, -1)
    b = jnp.sum(d1 * d2, -1)
    denom = a * e - b * b
    s = jnp.where(denom > 1e-12, jnp.clip((b * f - c * e) / jnp.maximum(denom, 1e-12), 0.0, 1.0), 0.0)
    t = (b * s + f) / jnp.maximum(e, 1e-12)
    t_cl = jnp.clip(t, 0.0, 1.0)
    s = jnp.clip((b * t_cl - c) / jnp.maximum(a, 1e-12), 0.0, 1.0)
    c1 = p1 + d1 * s[..., None]
    c2 = p2 + d2 * t_cl[..., None]
    return c1, c2
