"""Transform-hierarchy propagation.

Replaces the reference's recursive dirty-flag walk
(``src/ecs/TransformSystem.cpp:10-46``: depth-first from roots, recompute
local iff dirty, world = parentWorld @ local) with a **level-ordered batched**
scheme that suits XLA:

- the host precomputes, at scene-build time, the entities grouped by depth
  (:func:`compute_levels`), padded to a rectangular ``int32[L, M]`` table;
- the device recomputes **all** local matrices in one batched SRT compose
  (no dirty flags — recompute-all avoids divergent control flow,
  SURVEY.md §7), then runs a short unrolled loop over depth levels,
  each level a gather + batched 4x4 matmul ``world[c] = world[parent[c]] @
  local[c]``.

The number of levels is static per compiled scene, so the loop unrolls into a
handful of fused gather+matmul ops.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from banggameengine_tpu import math3d


def compute_levels(parent: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """Host-side: group entity indices by hierarchy depth.

    Parameters
    ----------
    parent : int32[N], -1 for roots.  An entity whose parent is not alive is
        treated as a root (the reference treats entities whose parent lacks a
        Transform as roots, ``src/ecs/Scene.cpp:523-533``).
    alive : bool[N]

    Returns
    -------
    int32[L, M] table of entity ids per level, padded with -1.  L >= 1 even
    for an empty scene so the device loop shape is stable.
    """
    parent = np.asarray(parent, np.int32)
    alive = np.asarray(alive, bool)
    n = parent.shape[0]
    depth = np.full(n, -1, np.int64)
    for i in range(n):
        if not alive[i]:
            continue
        d, j, guard = 0, i, 0
        while parent[j] >= 0 and alive[parent[j]] and guard <= n:
            j = parent[j]
            d += 1
            guard += 1
        if guard > n:  # cycle: treat as root
            d = 0
        depth[i] = d
    max_depth = int(depth.max()) if (depth >= 0).any() else 0
    levels = []
    for d in range(max_depth + 1):
        ids = np.nonzero(depth == d)[0].astype(np.int32)
        levels.append(ids)
    width = max((len(l) for l in levels), default=1)
    width = max(width, 1)
    table = np.full((len(levels), width), -1, np.int32)
    for d, ids in enumerate(levels):
        table[d, : len(ids)] = ids
    return table


def update_world_matrices(pos, quat, scale, parent, level_nodes, alive):
    """Device-side: recompute all world matrices.

    world[i] = world[parent[i]] @ local[i]; roots use local directly.
    ``level_nodes`` int32[L, M] (-1 padded) from :func:`compute_levels`.
    Returns f32[N, 4, 4].
    """
    local = math3d.mat_from_srt(scale, quat, pos)
    world = local
    num_levels = level_nodes.shape[0]
    # Level 0 entries are roots: world == local already.  For each deeper
    # level, gather parent worlds and compose.  The scatter back is a masked
    # dense `where` on the padded id set, keeping everything static-shaped.
    for lvl in range(1, num_levels):
        ids = level_nodes[lvl]                      # int32[M], -1 padded
        valid = ids >= 0
        safe_ids = jnp.where(valid, ids, 0)
        p = parent[safe_ids]
        safe_p = jnp.where(p >= 0, p, 0)
        composed = math3d.mat_mul(world[safe_p], local[safe_ids])  # [M,4,4]
        world = world.at[safe_ids].set(
            jnp.where(valid[:, None, None], composed, world[safe_ids])
        )
    # Dead entities keep identity-ish local; callers mask by `alive`.
    del alive
    return world
