"""Blocked all-pairs AABB broadphase as a Pallas kernel on the Triton route.

Same contract as :func:`broadphase.neighbor_lists_aabb` (which is its
reference): the same pair filter, each row's first ``k`` partners in
ascending column order (-1 padded), and per-row counts so overflow is still
reported.  Written for Hopper GPUs:

- one program per 64-row block; the loop over 64-column chunks runs inside
  the program, so rows keep their partial lists in registers;
- before testing a chunk, the program loads that chunk's union AABB and its
  own block's (computed once outside the kernel) and skips the chunk when
  they are disjoint.  With bodies Morton-sorted (the ``sorted`` route),
  nearly every chunk is skipped;
- inside a surviving chunk, partners are taken smallest column first, one
  per row per pass, until every row's chunk is drained or its list is full.

On an H100 at 10,000 Morton-sorted bodies it runs in a quarter of the plain
version's time and halves the stress step (PERF.md, PR 1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from banggameengine_tpu.physics.broadphase import (
    NeighborLists, neighbor_lists_aabb,
)

Array = jax.Array

BI = 64   # rows per program
BJ = 64   # columns per chunk (one union AABB per chunk)
_NONE = 1 << 30


def _kernel(blo_x, blo_y, blo_z, bhi_x, bhi_y, bhi_z,
            lo_x, lo_y, lo_z, hi_x, hi_y, hi_z, dyn, layer, mask,
            nb_ref, count_ref, *, n_chunks: int, k: int):
    i = pl.program_id(0)
    rows = pl.ds(i * BI, BI)
    r_lo = [lo_x[rows][:, None], lo_y[rows][:, None], lo_z[rows][:, None]]
    r_hi = [hi_x[rows][:, None], hi_y[rows][:, None], hi_z[rows][:, None]]
    r_dyn = dyn[rows][:, None]
    r_layer = layer[rows][:, None]
    r_mask = mask[rows][:, None]
    row_ids = i * BI + jnp.arange(BI, dtype=jnp.int32)[:, None]
    b_lo = (blo_x[i], blo_y[i], blo_z[i])
    b_hi = (bhi_x[i], bhi_y[i], bhi_z[i])
    slots = jnp.arange(k, dtype=jnp.int32)[None, :]

    def chunk(c, carry):
        hit = ((b_lo[0] <= bhi_x[c]) & (blo_x[c] <= b_hi[0])
               & (b_lo[1] <= bhi_y[c]) & (blo_y[c] <= b_hi[1])
               & (b_lo[2] <= bhi_z[c]) & (blo_z[c] <= b_hi[2]))

        def scan_chunk(carry):
            nb, filled, total = carry
            cols = pl.ds(c * BJ, BJ)
            c_dyn = dyn[cols][None, :]
            ov = ((r_lo[0] <= hi_x[cols][None, :])
                  & (lo_x[cols][None, :] <= r_hi[0])
                  & (r_lo[1] <= hi_y[cols][None, :])
                  & (lo_y[cols][None, :] <= r_hi[1])
                  & (r_lo[2] <= hi_z[cols][None, :])
                  & (lo_z[cols][None, :] <= r_hi[2]))
            ov &= (r_dyn >= 0) & (c_dyn >= 0) & ((r_dyn > 0) | (c_dyn > 0))
            ov &= (r_layer & mask[cols][None, :]) != 0
            ov &= (layer[cols][None, :] & r_mask) != 0
            col_ids = c * BJ + jnp.arange(BJ, dtype=jnp.int32)[None, :]
            ov &= row_ids != col_ids
            left = ov.astype(jnp.int32)
            total = total + jnp.sum(left, axis=1)
            left = jnp.where(filled < k, left, 0)

            def take(state):
                left, nb, filled = state
                first = jnp.min(jnp.where(left > 0, col_ids, _NONE), axis=1,
                                keepdims=True)
                got = first < _NONE
                nb = jnp.where(got & (slots == filled), first, nb)
                filled = filled + got.astype(jnp.int32)
                left = jnp.where((col_ids != first) & (filled < k), left, 0)
                return left, nb, filled

            _, nb, filled = jax.lax.while_loop(
                lambda s: jnp.max(s[0]) > 0, take, (left, nb, filled))
            return nb, filled, total

        return jax.lax.cond(hit, scan_chunk, lambda x: x, carry)

    nb, _filled, total = jax.lax.fori_loop(
        0, n_chunks, chunk,
        (jnp.full((BI, k), -1, jnp.int32), jnp.zeros((BI, 1), jnp.int32),
         jnp.zeros((BI,), jnp.int32)))
    nb_ref[...] = nb
    count_ref[...] = total


@functools.partial(
    jax.jit, static_argnames=("max_neighbors", "aabb_margin", "interpret"))
def neighbor_lists_aabb_triton(
    mn: Array,             # f32[N,3] AABB min (no margin applied yet)
    mx: Array,             # f32[N,3] AABB max
    dyn: Array,            # i32[N]: -1 not solid, 0 solid static, 1 dynamic
    layer_i: Array,        # i32[N]
    mask_i: Array,         # i32[N]
    max_neighbors: int = 8,
    aabb_margin: float = 0.04,
    interpret: bool = False,
) -> NeighborLists:
    """Kernel form of :func:`broadphase.neighbor_lists_aabb`."""
    n = mn.shape[0]
    k = max_neighbors
    pad = (-n) % BI
    npad = n + pad
    n_blocks = npad // BI

    def padded(a, fill):
        return jnp.concatenate([a, jnp.full((pad,), fill, a.dtype)])

    # padding rows: inverted infinite boxes that overlap nothing
    lo = [padded(mn[:, a] - 0.5 * aabb_margin, jnp.inf) for a in range(3)]
    hi = [padded(mx[:, a] + 0.5 * aabb_margin, -jnp.inf) for a in range(3)]
    cols = lo + hi + [padded(dyn.astype(jnp.int32), -1),
                      padded(layer_i.astype(jnp.int32), 0),
                      padded(mask_i.astype(jnp.int32), 0)]
    bounds = ([a.reshape(n_blocks, BI).min(axis=1) for a in lo]
              + [a.reshape(n_blocks, BI).max(axis=1) for a in hi])

    full = lambda m: pl.BlockSpec((m,), lambda i: (0,))
    nb, counts = pl.pallas_call(
        functools.partial(_kernel, n_chunks=n_blocks, k=k),
        grid=(n_blocks,),
        in_specs=[full(n_blocks)] * 6 + [full(npad)] * 9,
        out_specs=(pl.BlockSpec((BI, k), lambda i: (i, 0)),
                   pl.BlockSpec((BI,), lambda i: (i,))),
        out_shape=(jax.ShapeDtypeStruct((npad, k), jnp.int32),
                   jax.ShapeDtypeStruct((npad,), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="broadphase_aabb",
    )(*bounds, *cols)
    nb, counts = nb[:n], counts[:n]
    overflow = jnp.sum(jnp.maximum(counts - k, 0)).astype(jnp.int32)
    return NeighborLists(idx=nb, valid=nb >= 0,
                         cell_overflow=jnp.int32(0), nbr_overflow=overflow)


def neighbor_lists_sorted(mn: Array, mx: Array, dyn: Array, layer_i: Array,
                          mask_i: Array, max_neighbors: int = 8,
                          aabb_margin: float = 0.04) -> NeighborLists:
    """The ``sorted`` route's broadphase: this kernel where the program is
    lowered for a CUDA GPU, :func:`broadphase.neighbor_lists_aabb`
    elsewhere.  Both return the same lists."""
    kw = dict(max_neighbors=max_neighbors, aabb_margin=aabb_margin)
    return jax.lax.platform_dependent(
        mn, mx, dyn, layer_i, mask_i,
        cuda=functools.partial(neighbor_lists_aabb_triton, **kw),
        default=functools.partial(neighbor_lists_aabb, **kw))
