"""Broadphase collision pruning.

Replaces Bullet's DBVT broadphase (``btDbvtBroadphase`` at
``PhysicsSystem.cpp:124``) with three array-shaped strategies:

- **dense all-pairs** (:func:`build_neighbor_lists_dense`) for small worlds
  (N <= a few hundred) — O(N^2) but pure vector work with reduction-only
  accumulation, the right trade at demo scale;
- **blocked all-pairs over AABBs** (:func:`neighbor_lists_aabb`) for the
  10k-body stress world: rows are processed in fixed-size blocks, each
  block tests every column and keeps its first ``k`` partners; callers
  Morton-sort the bodies first (:func:`morton_key_xz`) so that the contact
  phase downstream reads neighbours close in memory;
- **uniform spatial hash grid + fixed-capacity neighbor lists** for large
  worlds: bodies are
  hashed by cell, a ``[table, cell_capacity]`` cell list is built with one
  sort + one scatter, and each body gathers candidates from its 27-cell
  neighborhood, AABB-filtered and compacted to a ``[N, max_neighbors]``
  list.  The solver then accumulates per-body impulses by **row reduction**
  (each unordered pair appears in both rows, mirrored), keeping scatters out
  of the iteration loop.

Capacity overflows (cell or neighbor list) are counted and returned so
callers can surface dropped-pair diagnostics instead of silently missing
collisions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from banggameengine_tpu.physics import shapes as sh

Array = jax.Array

# large primes for 3D spatial hashing
_P1, _P2, _P3 = 73856093, 19349663, 83492791

# rows per block of :func:`neighbor_lists_aabb`: at 10,000 bodies on an
# H100 one block was fastest (PERF.md, PR 1); larger worlds split into
# blocks so the [block, N] intermediates stay bounded
BLOCK_ROWS = 16384


class NeighborLists(NamedTuple):
    idx: Array        # i32[N, K] neighbor body ids, -1 padded
    valid: Array      # bool[N, K]
    cell_overflow: Array   # i32[] bodies dropped from full cells
    nbr_overflow: Array    # i32[] candidate pairs dropped from full rows


def _cell_coords(pos: Array, cell_size) -> Array:
    return jnp.floor(pos / cell_size).astype(jnp.int32)


def _hash_coords(c: Array, table_size: int) -> Array:
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return jnp.mod(h, table_size)


def build_neighbor_lists_dense(
    pos: Array,
    quat: Array,
    shape_type: Array,
    size: Array,
    pair_mask: Array,      # bool[N,N] extra validity (layers, dynamics, ...)
    max_neighbors: int = 8,
    aabb_margin: float = 0.04,
) -> NeighborLists:
    """All-pairs AABB broadphase compacted to fixed neighbor lists.

    For small worlds: the [N,N] boolean AABB matrix is cheap, and pruning
    partners *before* narrowphase keeps the expensive manifold math (and its
    [..., 3]-shaped temporaries) on ~K instead of N partners per body.
    """
    n = pos.shape[0]
    mn, mx = sh.shape_aabb(pos, quat, shape_type, size)
    ov = sh.aabb_overlap(mn[:, None], mx[:, None], mn[None, :], mx[None, :],
                         margin=aabb_margin)
    ov &= pair_mask
    ov &= ~jnp.eye(n, dtype=bool)

    # sort-free stable compaction (cumsum destinations + one-hot matmul)
    from banggameengine_tpu.physics.solver import compaction_matrix

    sel, valid, counts = compaction_matrix(ov, max_neighbors)
    ids_f = jnp.einsum(
        "nmc,m->nc", sel, jnp.arange(n, dtype=jnp.float32)
    )
    idx = jnp.where(valid, ids_f.astype(jnp.int32), -1)
    overflow = jnp.sum(jnp.maximum(counts - max_neighbors, 0)).astype(jnp.int32)
    return NeighborLists(idx=idx, valid=valid,
                         cell_overflow=jnp.int32(0), nbr_overflow=overflow)


def build_neighbor_lists(
    pos: Array,            # f32[N,3]
    quat: Array,
    shape_type: Array,
    size: Array,
    active: Array,         # bool[N] participate in broadphase
    cell_size: float,
    table_size: int = 4096,
    cell_capacity: int = 8,
    max_neighbors: int = 16,
    aabb_margin: float = 0.04,
) -> NeighborLists:
    """Build fixed-capacity symmetric neighbor lists.

    ``cell_size`` should be >= the largest dynamic body diameter so a body's
    collision partners always lie in the 27-cell neighborhood.
    """
    n = pos.shape[0]
    cells = _cell_coords(pos, cell_size)               # [N,3]
    hashes = jnp.where(active, _hash_coords(cells, table_size), table_size)

    # cell list: sort bodies by hash, rank within each run, scatter
    order = jnp.argsort(hashes)                        # stable
    sorted_h = hashes[order]
    same_prev = jnp.concatenate(
        [jnp.zeros(1, bool), sorted_h[1:] == sorted_h[:-1]]
    )
    # rank of each sorted element within its hash run
    seg_start = jnp.where(~same_prev, jnp.arange(n), 0)
    seg_start = jax.lax.associative_scan(jnp.maximum, seg_start)
    rank = jnp.arange(n) - seg_start

    table = jnp.full((table_size + 1, cell_capacity), -1, jnp.int32)
    ok = (rank < cell_capacity) & (sorted_h < table_size)
    scatter_h = jnp.where(ok, sorted_h, table_size)
    scatter_r = jnp.where(ok, rank, 0)
    table = table.at[scatter_h, scatter_r].set(
        jnp.where(ok, order.astype(jnp.int32), -1), mode="drop"
    )
    table = table.at[table_size].set(-1)               # dump row stays empty
    cell_overflow = jnp.sum(
        jnp.where(sorted_h < table_size, jnp.maximum(rank - cell_capacity + 1, 0) > 0, False)
    ).astype(jnp.int32)

    # candidate gathering from the 27-cell neighborhood
    offs = jnp.stack(
        jnp.meshgrid(
            jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(-1, 2),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(27, 3)
    nbr_cells = cells[:, None, :] + offs[None, :, :]    # [N,27,3]
    nbr_hash = _hash_coords(nbr_cells, table_size)      # [N,27]
    cand = table[nbr_hash]                              # [N,27,cap]

    safe_cand = jnp.maximum(cand, 0)
    cand_cells = cells[safe_cand]                       # [N,27,cap,3]
    # a candidate is genuine iff it sits exactly in the probed neighbor cell
    # (kills hash-collision ghosts AND duplicate appearances)
    cell_match = jnp.all(cand_cells == nbr_cells[:, :, None, :], axis=-1)
    cand_ok = (cand >= 0) & cell_match
    cand_ok &= cand != jnp.arange(n)[:, None, None]     # no self
    cand_ok &= active[safe_cand] & active[:, None, None]

    # AABB filter
    mn, mx = sh.shape_aabb(pos, quat, shape_type, size)
    overlap = sh.aabb_overlap(
        mn[:, None, None], mx[:, None, None],
        mn[safe_cand], mx[safe_cand], margin=aabb_margin,
    )
    cand_ok &= overlap

    # compact to max_neighbors (sort-free cumsum + one-hot contraction)
    from banggameengine_tpu.physics.solver import compaction_matrix

    flat_ok = cand_ok.reshape(n, -1)
    flat_id = cand.reshape(n, -1)
    selm, valid, counts = compaction_matrix(flat_ok, max_neighbors)
    idx_f = jnp.einsum("nmc,nm->nc", selm, flat_id.astype(jnp.float32))
    idx = jnp.where(valid, idx_f.astype(jnp.int32), -1)
    nbr_overflow = jnp.sum(jnp.maximum(counts - max_neighbors, 0)).astype(jnp.int32)

    return NeighborLists(idx=idx, valid=valid,
                         cell_overflow=cell_overflow,
                         nbr_overflow=nbr_overflow)


def morton_key_xz(pos: Array, cell: float = 0.25) -> Array:
    """Morton (z-order) key over the horizontal plane: interleaved quantized
    x/z.  Sorting bodies by this key puts spatial neighbours close together
    in memory (ground-plane worlds spread in x/z; y adds little).

    Axes clamp to 15 bits (~8 km at the default cell) so the interleaved
    key never reaches the int32 sign bit — ``spread(zi) << 1`` with a
    16-bit zi would flip the key negative and break the argsort's spatial
    ordering (perf-only: the result stays a valid permutation)."""
    mn = jnp.min(pos, axis=0)
    xi = jnp.clip(((pos[:, 0] - mn[0]) / cell).astype(jnp.int32), 0, 0x7FFF)
    zi = jnp.clip(((pos[:, 2] - mn[2]) / cell).astype(jnp.int32), 0, 0x7FFF)

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(xi) | (spread(zi) << 1)


def neighbor_lists_aabb(
    mn: Array,             # f32[N,3] AABB min (no margin applied yet)
    mx: Array,             # f32[N,3] AABB max
    dyn: Array,            # i32[N]: -1 not solid, 0 solid static, 1 dynamic
    layer_i: Array,        # i32[N]
    mask_i: Array,         # i32[N]
    max_neighbors: int = 8,
    aabb_margin: float = 0.04,
    block_rows: int = BLOCK_ROWS,
) -> NeighborLists:
    """All-pairs AABB broadphase over fixed-size row blocks.

    Pair filter: AABB overlap (+margin, inclusive) & both solid & layer/mask
    both ways & at least one dynamic & not self.  Each row keeps its first
    ``max_neighbors`` partners in ascending column order (-1 padded);
    ``nbr_overflow`` counts the partners dropped beyond that budget.
    Indices refer to the order of the inputs."""
    n = mn.shape[0]
    k = max_neighbors
    lo = mn - 0.5 * aabb_margin
    hi = mx + 0.5 * aabb_margin
    cols = jnp.arange(n, dtype=jnp.int32)

    def block(rows):
        r = jnp.minimum(rows, n - 1)
        ov = (rows < n)[:, None] & (rows[:, None] != cols[None, :])
        for a in range(3):
            ov &= (lo[r, a][:, None] <= hi[None, :, a])
            ov &= (lo[None, :, a] <= hi[r, a][:, None])
        dr = dyn[r][:, None]
        dc = dyn[None, :]
        ov &= (dr >= 0) & (dc >= 0) & ((dr > 0) | (dc > 0))
        ov &= ((layer_i[r][:, None] & mask_i[None, :]) != 0)
        ov &= ((layer_i[None, :] & mask_i[r][:, None]) != 0)
        # first k partners, smallest column first: k row-min passes
        found, prev = [], jnp.full((rows.shape[0], 1), -1, jnp.int32)
        for _ in range(k):
            prev = jnp.min(jnp.where(ov & (cols[None, :] > prev), cols, n),
                           axis=1, keepdims=True)
            found.append(prev)
        idx = jnp.concatenate(found, axis=1)
        return (jnp.where(idx < n, idx, -1),
                jnp.sum(ov, axis=1, dtype=jnp.int32))

    b = max(1, min(block_rows, n))
    n_blocks = -(-n // b)
    rows = jnp.arange(n_blocks * b, dtype=jnp.int32).reshape(n_blocks, b)
    idx, counts = jax.lax.map(block, rows)
    idx = idx.reshape(n_blocks * b, k)[:n]
    counts = counts.reshape(n_blocks * b)[:n]
    overflow = jnp.sum(jnp.maximum(counts - k, 0)).astype(jnp.int32)
    return NeighborLists(idx=idx, valid=idx >= 0,
                         cell_overflow=jnp.int32(0), nbr_overflow=overflow)
