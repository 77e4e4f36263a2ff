"""Entity-level frustum culling.

The reference relies on bgfx/GPU clipping and submits every submesh
(``Renderer.cpp:601-730``); a software pipeline wants the cheap
entity-level reject first: transform each entity's
object-space AABB by its world matrix, test the 8 corners against the six
clip-space half-spaces of ``proj @ view``, and mask out every triangle of a
culled entity before triangle setup.
"""

from __future__ import annotations

import jax.numpy as jnp


def entity_frustum_mask(
    ent_aabb_min, ent_aabb_max, ent_has_mesh, world_mats, view, proj
):
    """bool[N]: entity potentially visible.

    Conservative: an entity is culled only if all 8 transformed AABB corners
    are outside the same frustum plane (clip-space tests x,y in [-w, w],
    z in [0, w], w > 0).
    """
    n = ent_aabb_min.shape[0]
    mn, mx = ent_aabb_min, ent_aabb_max
    # 8 corners [N,8,3], built from the traced min/max per axis rather than
    # a selector-table constant captured into the executable
    ax, ay, az = mn[:, 0], mn[:, 1], mn[:, 2]
    bx, by, bz = mx[:, 0], mx[:, 1], mx[:, 2]
    corners = jnp.stack(
        [
            jnp.stack([ax, ay, az], -1), jnp.stack([bx, ay, az], -1),
            jnp.stack([ax, by, az], -1), jnp.stack([bx, by, az], -1),
            jnp.stack([ax, ay, bz], -1), jnp.stack([bx, ay, bz], -1),
            jnp.stack([ax, by, bz], -1), jnp.stack([bx, by, bz], -1),
        ],
        axis=1,
    )
    w = world_mats
    wc = jnp.einsum("nij,nkj->nki", w[:, :3, :3], corners) + w[:, None, :3, 3]
    vp = jnp.matmul(proj, view, preferred_element_type=jnp.float32)
    wc4 = jnp.concatenate([wc, jnp.ones_like(wc[..., :1])], axis=-1)
    clip = jnp.einsum("ij,nkj->nki", vp, wc4)          # [N,8,4]

    x, y, z, cw = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    out_left = jnp.all(x < -cw, axis=1)
    out_right = jnp.all(x > cw, axis=1)
    out_bottom = jnp.all(y < -cw, axis=1)
    out_top = jnp.all(y > cw, axis=1)
    out_near = jnp.all(z < 0.0, axis=1)
    out_far = jnp.all(z > cw, axis=1)
    culled = out_left | out_right | out_bottom | out_top | out_near | out_far
    return ent_has_mesh & ~culled
