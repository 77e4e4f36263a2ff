"""Software tile rasterizer: vertex transform, binning, visibility buffer.

Replaces the reference's bgfx submission path (``Renderer.cpp:601-730``
per-submesh draws into a D3D11 device) with a software raster pipeline made
of dense array operations (SURVEY.md §7):

1. **vertex transform** — one batched matmul over all scene vertices
   (world gathered per vertex from the entity table);
2. **triangle setup + cull** — screen-space bbox, w>0, degenerate and
   off-screen rejection; rendering is two-sided (the reference's
   ``m_defaultState`` sets no cull flag, ``Renderer.h:128-131``), depth test
   LESS with clear depth 1.0 (``Renderer.cpp:161``);
3. **binning** — per-tile triangle lists (capacity K) built from a dense
   [tiles, tris] bbox-overlap mask with a stable argsort compaction — no
   scatter;
4. **visibility pass** — per tile, a ``lax.scan`` over triangle chunks
   evaluates edge functions over the whole pixel block at once (dense
   [chunk, th, tw] ops), z-tests, and keeps the winning triangle id +
   barycentrics per pixel ("visibility buffer");
5. shading happens once per pixel in :mod:`banggameengine_tpu.render.shading`
   (deferred), so the expensive material math never runs on occluded
   fragments.

Depth is NDC z in [0,1] interpolated linearly in screen space (matching
hardware rasterizers); attribute interpolation is perspective-correct via
1/w weighting at shade time.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

TILE_H = 32
TILE_W = 128
# shared bin for triangles spanning many tiles (the ground plane class);
# kept small — the light raster pass walks K_GLOBAL + light_capacity slots
# on EVERY tile, and scenes rarely have more than a handful of huge
# triangles (overflow is surfaced, and the runtime-gated heavy pass
# re-rasters dense tiles at full capacity)
K_GLOBAL = 16


class VisibilityBuffer(NamedTuple):
    """Planar (SoA) visibility buffer.

    Framebuffer-size tensors stay [H,W] planes rather than one array with a
    trailing minor dim of 2."""

    depth: Array    # f32[H,W], 1.0 = far/background
    tri_id: Array   # i32[H,W], -1 = background
    b1: Array       # f32[H,W] screen-space barycentric of vertex 1
    b2: Array       # f32[H,W] screen-space barycentric of vertex 2

    @property
    def bary(self) -> Array:
        """Interleaved f32[H,W,2] view (tests/debug; prefer b1/b2 planes)."""
        return jnp.stack([self.b1, self.b2], axis=-1)


class TiledVisibility(NamedTuple):
    """Tile-major visibility planes + per-tile triangle lists, the input
    the deferred shader's per-tile one-hot resolve wants (avoids the big
    global per-pixel attribute gather).  ``slot`` indexes each pixel's
    winning triangle within this tile's ``ids`` row (-1 = background).

    ``sub_raster`` is the per-SUB-triangle screen-space table the shader
    needs to RECOMPUTE barycentrics per pixel (slim raster carry): f32[12, S]
    rows = (sx0, sx1, sx2, sy0, sy1, sy2, cb01, cb11, cb21, cb02, cb12,
    cb22).  ``b1``/``b2`` are None in slim mode — the raster scan then
    carries only (depth, slot), 2 framebuffer planes instead of 5."""

    depth: Array    # f32[tiles, TH, TW]
    slot: Array     # i32[tiles, TH, TW] index into ids[tile], -1 = bg
    b1: Array | None       # f32[tiles, TH, TW] (None in slim mode)
    b2: Array | None       # f32[tiles, TH, TW] (None in slim mode)
    ids: Array      # i32[tiles, K] sub-triangle ids per tile (-1 padded)
    sub_raster: Array | None = None   # f32[12, S] (slim mode only)
    # heavy-pass bookkeeping: the tiles the heavy re-raster MAY have
    # overwritten, and which of them it actually did.  The deferred shade
    # uses these for a second, wider one-hot resolve over just those
    # tiles instead of a per-pixel row-gather fallback.
    heavy: Array | None = None        # i32[heavy_tiles] tile indices
    heavy_needs: Array | None = None  # bool[heavy_tiles]


def transform_vertices(v_pos, v_entity, world_mats, view, proj):
    """Object-space vertices -> (world_pos [V,3], clip [V,4]).

    One gather + one fused matmul chain ([V,4]x[4,4]).
    """
    w = world_mats[v_entity]                          # [V,4,4]
    wp = jnp.einsum("vij,vj->vi", w[:, :3, :3], v_pos) + w[:, :3, 3]
    vp = jnp.matmul(proj, view, preferred_element_type=jnp.float32)
    wp4 = jnp.concatenate([wp, jnp.ones_like(wp[:, :1])], axis=-1)
    clip = jnp.einsum("ij,vj->vi", vp, wp4)
    return wp, clip


def transform_normals(v_nrm, v_entity, normal_mats):
    nm = normal_mats[v_entity]                        # [V,3,3]
    n = jnp.einsum("vij,vj->vi", nm, v_nrm)
    return n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)


def clip_near_plane(clip_tri: Array, tri_valid: Array):
    """Clip triangles against the near plane (clip-space z >= 0).

    Each input triangle yields up to 2 sub-triangles.  Sub-triangle corners
    carry their barycentric coordinates **in the original triangle**, so the
    visibility buffer keeps referencing original triangle ids and original
    vertex attributes — clipping is invisible to the deferred shader.

    clip_tri: f32[T, 3, 4]; returns (sub_clip f32[T,2,3,4],
    sub_bary f32[T,2,3,3] rows = original-space barycentrics of each corner,
    sub_valid bool[T,2]).
    """
    # COMPONENT FORM internally: every intermediate below is a dense [T]
    # plane, and the [T,2,3,4] outputs are assembled exactly once at the
    # end.  Values are bit-identical to the [T,3,4] tensor form (same
    # selects, same lerp order).
    d_c = [clip_tri[:, i, 2] for i in range(3)]          # z_clip per corner
    inside = [dc >= 0.0 for dc in d_c]
    k = (inside[0].astype(jnp.int32) + inside[1].astype(jnp.int32)
         + inside[2].astype(jnp.int32))                  # [T] 0..3

    # rotate so that: k==1 -> the inside vertex is slot 0;
    #                 k==2 -> the outside vertex is slot 2
    # (argmax over a length-3 axis, written as selects on [T] planes)
    r1 = jnp.where(inside[0], 0, jnp.where(inside[1], 1, 2))
    r2f = jnp.where(~inside[0], 0, jnp.where(~inside[1], 1, 2))
    r2 = jnp.mod(r2f + 1, 3)
    r = jnp.where(k == 1, r1, jnp.where(k == 2, r2, 0)).astype(jnp.int32)

    def rot(comps, s):
        """comps[(s + r) % 3] as selects over [T] planes."""
        a, b, c = comps[s % 3], comps[(s + 1) % 3], comps[(s + 2) % 3]
        return jnp.where(r == 0, a, jnp.where(r == 1, b, c))

    # rotated corner components: v[s][j] (j = x,y,z,w), d[s], and the
    # original-corner one-hot columns b[s][col] = ((s + r) % 3 == col)
    v_cols = [[clip_tri[:, i, j] for i in range(3)] for j in range(4)]
    vs = [[rot(v_cols[j], s) for j in range(4)] for s in range(3)]
    ds = [rot(d_c, s) for s in range(3)]
    f32 = clip_tri.dtype
    bs = [[(jnp.mod(s + r, 3) == col).astype(f32) for col in range(3)]
          for s in range(3)]

    def safe_t(da, db):
        den = da - db
        return da / jnp.where(jnp.abs(den) > 1e-12, den, 1e-12)

    t01 = safe_t(ds[0], ds[1])
    t02 = safe_t(ds[0], ds[2])
    t12 = safe_t(ds[1], ds[2])

    def lerp(a, b, t):
        return a + (b - a) * t

    i01 = [lerp(vs[0][j], vs[1][j], t01) for j in range(4)]
    i02 = [lerp(vs[0][j], vs[2][j], t02) for j in range(4)]
    i12 = [lerp(vs[1][j], vs[2][j], t12) for j in range(4)]
    bi01 = [lerp(bs[0][c], bs[1][c], t01) for c in range(3)]
    bi02 = [lerp(bs[0][c], bs[2][c], t02) for c in range(3)]
    bi12 = [lerp(bs[1][c], bs[2][c], t12) for c in range(3)]

    k2 = k == 2
    k3 = k == 3

    def pick(full, clip2, clip1):
        # k3 -> untouched; k2 -> two-in case; else one-in case
        return jnp.where(k3, full, jnp.where(k2, clip2, clip1))

    # sub-triangle 1: k3 -> (v0,v1,v2); k2 -> (v0,v1,i12); k1 -> (v0,i01,i02)
    s1 = [
        vs[0],                                           # corner 0 unchanged
        [pick(vs[1][j], vs[1][j], i01[j]) for j in range(4)],
        [pick(vs[2][j], i12[j], i02[j]) for j in range(4)],
    ]
    s1b = [
        bs[0],
        [pick(bs[1][c], bs[1][c], bi01[c]) for c in range(3)],
        [pick(bs[2][c], bi12[c], bi02[c]) for c in range(3)],
    ]
    # sub-triangle 2: only k2 -> (v0, i12, i02)
    s2 = [vs[0], i12, i02]
    s2b = [bs[0], bi12, bi02]

    def asm(rows, width_):
        # rows[corner][component] of [T] -> [T, 3, width_]
        return jnp.stack(
            [jnp.stack(rows[c], axis=-1) for c in range(3)], axis=1)

    sub_clip = jnp.stack([asm(s1, 4), asm(s2, 4)], axis=1)   # [T,2,3,4]
    sub_bary = jnp.stack([asm(s1b, 3), asm(s2b, 3)], axis=1)
    s1_ok = tri_valid & (k >= 1)
    s2_ok = tri_valid & k2
    sub_valid = jnp.stack([s1_ok, s2_ok], axis=1)
    return sub_clip, sub_bary, sub_valid


def setup_triangles(sub_clip, sub_valid, width: int, height: int):
    """Near-clipped sub-triangles -> screen-space raster data.

    sub_clip: f32[S, 3, 4] (S = 2T flattened sub-triangles, all z >= 0 by
    construction); returns dict of per-sub-tri arrays.
    """
    # component form on dense [S] planes; the [S,3] outputs are
    # assembled once at the end
    ws = [sub_clip[:, i, 3] for i in range(3)]
    safe_w = [jnp.where(jnp.abs(w) > 1e-9, w, 1e-9) for w in ws]
    iw = [1.0 / sw for sw in safe_w]
    # true divisions (not mul-by-reciprocal): bit parity with the tensor
    # form this replaced, which the golden-image tests assert
    sx = [(sub_clip[:, i, 0] / safe_w[i] * 0.5 + 0.5) * width
          for i in range(3)]
    sy = [(1.0 - (sub_clip[:, i, 1] / safe_w[i] * 0.5 + 0.5)) * height
          for i in range(3)]
    z = [sub_clip[:, i, 2] / safe_w[i] for i in range(3)]

    in_front = (ws[0] > 1e-7) & (ws[1] > 1e-7) & (ws[2] > 1e-7)
    x0 = jnp.minimum(jnp.minimum(sx[0], sx[1]), sx[2])
    x1 = jnp.maximum(jnp.maximum(sx[0], sx[1]), sx[2])
    y0 = jnp.minimum(jnp.minimum(sy[0], sy[1]), sy[2])
    y1 = jnp.maximum(jnp.maximum(sy[0], sy[1]), sy[2])
    on_screen = (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)
    area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (
        sx[2] - sx[0])
    nondegenerate = jnp.abs(area) > 1e-9
    # far-plane handled per-pixel (depth <= 1 test in the tile kernel)
    valid = sub_valid & in_front & on_screen & nondegenerate

    return dict(
        sx=jnp.stack(sx, axis=1), sy=jnp.stack(sy, axis=1),
        z=jnp.stack(z, axis=1), inv_w=jnp.stack(iw, axis=1), area=area,
        # bbox as four dense [S] planes (the binner reads it
        # column-wise)
        bbox=(x0, y0, x1, y1), valid=valid,
    )


def bin_triangles(tri, width: int, height: int,
                  k_local: int = 256, k_global: int = K_GLOBAL,
                  span_x: int = 4, span_y: int = 4):
    """Scatter-based bbox-vs-tile binning (GPU-binner shape).

    Small triangles (tile span <= span_x x span_y) emit up to
    ``span_x*span_y`` (tile, tri) pairs; one global sort of the pair keys +
    a rank-in-run scatter builds per-tile lists — no per-tile row sorts.
    Triangles spanning more tiles (e.g. the ground plane) go to a shared
    ``global`` list prepended to every tile.

    Returns (ids i32[tiles, k_global+k_local] -1-padded, counts i32[tiles],
    local_counts i32[tiles], overflow i32, (tiles_y, tiles_x)).
    ``local_counts`` excludes the shared global list — the light/heavy
    raster split must compare it against the LOCAL slot capacity (the
    global slots are always fully walked by every tile).
    """
    tiles_x = (width + TILE_W - 1) // TILE_W
    tiles_y = (height + TILE_H - 1) // TILE_H
    n_tiles = tiles_x * tiles_y
    t = tri["valid"].shape[0]

    bx0, by0, bx1, by1 = tri["bbox"]
    tx0 = jnp.clip(jnp.floor(bx0 / TILE_W), 0, tiles_x - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor(by0 / TILE_H), 0, tiles_y - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor(bx1 / TILE_W), 0, tiles_x - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor(by1 / TILE_H), 0, tiles_y - 1).astype(jnp.int32)
    span_w = tx1 - tx0 + 1
    span_h = ty1 - ty0 + 1
    is_local = tri["valid"] & (span_w <= span_x) & (span_h <= span_y)
    is_global = tri["valid"] & ~is_local

    # global list (few, big triangles) via sort-free compaction
    from banggameengine_tpu.physics.solver import compaction_matrix

    gsel, gvalid, gcounts = compaction_matrix(is_global[None, :], k_global)
    gids_f = jnp.einsum("omc,m->oc", gsel, jnp.arange(t, dtype=jnp.float32))
    gids = jnp.where(gvalid, gids_f.astype(jnp.int32), -1)[0]     # [k_global]
    g_overflow = jnp.maximum(gcounts[0] - k_global, 0)

    # local pairs: tri x span slot -> tile id
    n_span = span_x * span_y
    slot = jnp.arange(n_span, dtype=jnp.int32)
    dx = slot % span_x
    dy = slot // span_x
    tile_of = (ty0[:, None] + dy[None, :]) * tiles_x + (tx0[:, None] + dx[None, :])
    pair_ok = (
        is_local[:, None] & (dx[None, :] < span_w[:, None])
        & (dy[None, :] < span_h[:, None])
    )
    # key packs (tile, tri) keeping ascending tri order within a tile
    stride = 1 << max(t - 1, 1).bit_length()
    key = jnp.where(pair_ok, tile_of * stride + jnp.arange(t)[:, None],
                    jnp.iinfo(jnp.int32).max)
    key = jnp.sort(key.reshape(-1))                                # ONE sort
    pk_tile = key // stride
    pk_tri = key % stride
    pk_ok = key != jnp.iinfo(jnp.int32).max

    # rank within each tile run
    m = key.shape[0]
    same_prev = jnp.concatenate(
        [jnp.zeros(1, bool), pk_tile[1:] == pk_tile[:-1]]
    )
    seg_start = jnp.where(~same_prev, jnp.arange(m), 0)
    seg_start = jax.lax.associative_scan(jnp.maximum, seg_start)
    rank = jnp.arange(m) - seg_start

    ids_local = jnp.full((n_tiles + 1, k_local), -1, jnp.int32)
    ok = pk_ok & (rank < k_local) & (pk_tile < n_tiles)
    sc_tile = jnp.where(ok, pk_tile, n_tiles)
    sc_rank = jnp.where(ok, rank, 0)
    ids_local = ids_local.at[sc_tile, sc_rank].set(
        jnp.where(ok, pk_tri.astype(jnp.int32), -1), mode="drop"
    )[:n_tiles]
    # per-tile counts via binary search on the SORTED tile keys (invalid
    # keys sit at the end as INT_MAX/stride > n_tiles): one log-time
    # query per tile instead of a scatter-add over every pair
    bounds = jnp.searchsorted(pk_tile, jnp.arange(n_tiles + 1),
                              side="left")
    local_counts = (bounds[1:] - bounds[:-1]).astype(jnp.int32)
    l_overflow = jnp.sum(jnp.maximum(local_counts - k_local, 0))

    ids = jnp.concatenate(
        [jnp.broadcast_to(gids[None, :], (n_tiles, k_global)), ids_local],
        axis=1,
    )
    counts = local_counts + jnp.minimum(gcounts[0], k_global)
    overflow = g_overflow + l_overflow
    return ids, counts, local_counts, overflow, (tiles_y, tiles_x)


def _raster_tile(tile_x0, tile_y0, g_x, g_y, g_z, g_oid, g_cb, g_ok,
                 chunk: int, slim: bool = False):
    """Visibility raster of one tile over PRE-GATHERED sub-triangle data.

    g_* are this tile's triangle arrays ([K,3] screen coords / depth,
    [K] original ids, [K,3,3] original-space corner barycentrics, [K]
    validity) — gathered once outside the pixel loop so the chunk scan is
    pure vector math (no gathers on the hot path).

    ``slim=True`` carries only (depth, slot) through the chunk scan — 2
    framebuffer planes instead of 5 — and skips the per-(triangle, pixel)
    barycentric mapping entirely; the deferred shader recomputes
    tid/b1/b2 for the single WINNING triangle per pixel from the resolved
    screen coords (bit-identical math, once per pixel instead of once per
    triangle-pixel pair).  Returns (zbuf, tid|None, b1|None, b2|None,
    slot).
    """
    k = g_ok.shape[0]
    px = tile_x0 + jnp.arange(TILE_W, dtype=jnp.float32)[None, :] + 0.5
    py = tile_y0 + jnp.arange(TILE_H, dtype=jnp.float32)[:, None] + 0.5

    n_chunks = k // chunk
    ch = lambda a: a.reshape((n_chunks, chunk) + a.shape[1:])

    def chunk_depth(x, y, zz, okc):
        """Per-chunk coverage + depth over the pixel block ([C,TH,TW])."""
        x0, x1, x2 = x[:, 0, None, None], x[:, 1, None, None], x[:, 2, None, None]
        y0, y1, y2 = y[:, 0, None, None], y[:, 1, None, None], y[:, 2, None, None]
        pxb = px[None]                                # [1,TH,TW]
        pyb = py[None]
        # edge functions (signed areas)
        e0 = (x1 - x0) * (pyb - y0) - (y1 - y0) * (pxb - x0)
        e1 = (x2 - x1) * (pyb - y1) - (y2 - y1) * (pxb - x1)
        e2 = (x0 - x2) * (pyb - y2) - (y0 - y2) * (pxb - x2)
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)  # [C,1,1]
        # two-sided coverage
        pos = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
        neg = (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
        cover = jnp.where(area > 0, pos, neg)
        inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-9, area, 1e-9)
        b1 = e2 * inv_area                            # weight of vertex 1
        b2 = e0 * inv_area                            # weight of vertex 2
        b0 = 1.0 - b1 - b2
        depth = (
            b0 * zz[:, 0, None, None]
            + b1 * zz[:, 1, None, None]
            + b2 * zz[:, 2, None, None]
        )
        ok = cover & okc[:, None, None] & (depth >= 0.0) & (depth <= 1.0)
        depth = jnp.where(ok, depth, jnp.inf)
        return depth, b1, b2, b0

    def chunk_body_slim(carry, data):
        zbuf, slotb = carry
        chunk_off, x, y, zz, okc = data               # [C,...]
        depth, _, _, _ = chunk_depth(x, y, zz, okc)
        best = jnp.argmin(depth, axis=0)              # [TH,TW]
        d_best = jnp.min(depth, axis=0)
        better = d_best < zbuf
        zbuf = jnp.where(better, d_best, zbuf)
        slotb = jnp.where(better, chunk_off + best, slotb)
        return (zbuf, slotb), None

    def chunk_body(carry, data):
        zbuf, tid, b1b, b2b, slotb = carry
        chunk_off, x, y, zz, oid, cb, okc = data      # [C,...]
        depth, b1, b2, b0 = chunk_depth(x, y, zz, okc)
        # map sub-space bary -> original-triangle bary (components 1, 2)
        ob1 = b0 * cb[:, None, None, 0, 1] + b1 * cb[:, None, None, 1, 1] \
            + b2 * cb[:, None, None, 2, 1]
        ob2 = b0 * cb[:, None, None, 0, 2] + b1 * cb[:, None, None, 1, 2] \
            + b2 * cb[:, None, None, 2, 2]
        # best in chunk via one-hot select (no gathers on the pixel grid)
        c = depth.shape[0]
        best = jnp.argmin(depth, axis=0)              # [TH,TW]
        onehot = best[None] == jnp.arange(c)[:, None, None]
        d_best = jnp.min(depth, axis=0)
        b1_best = jnp.sum(jnp.where(onehot, ob1, 0.0), axis=0)
        b2_best = jnp.sum(jnp.where(onehot, ob2, 0.0), axis=0)
        id_best = jnp.sum(
            jnp.where(onehot, oid[:, None, None], 0), axis=0
        ).astype(jnp.int32)
        better = d_best < zbuf
        zbuf = jnp.where(better, d_best, zbuf)
        tid = jnp.where(better, id_best, tid)
        b1b = jnp.where(better, b1_best, b1b)
        b2b = jnp.where(better, b2_best, b2b)
        slotb = jnp.where(better, chunk_off + best, slotb)
        return (zbuf, tid, b1b, b2b, slotb), None

    # unroll=2: the scan carries the [tiles,32,128] planes through device
    # memory every iteration; unrolling halves the round-trips by keeping
    # the carry live across the fused pair
    chunk_offs = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    if slim:
        init = (
            jnp.full((TILE_H, TILE_W), jnp.inf, jnp.float32),
            jnp.full((TILE_H, TILE_W), -1, jnp.int32),
        )
        data = (chunk_offs, ch(g_x), ch(g_y), ch(g_z), ch(g_ok))
        (zbuf, slotb), _ = jax.lax.scan(
            chunk_body_slim, init, data, unroll=2)
        tid = b1b = b2b = None
    else:
        init = (
            jnp.full((TILE_H, TILE_W), jnp.inf, jnp.float32),
            jnp.full((TILE_H, TILE_W), -1, jnp.int32),
            jnp.zeros((TILE_H, TILE_W), jnp.float32),
            jnp.zeros((TILE_H, TILE_W), jnp.float32),
            jnp.full((TILE_H, TILE_W), -1, jnp.int32),
        )
        data = (chunk_offs, ch(g_x), ch(g_y), ch(g_z), ch(g_oid), ch(g_cb),
                ch(g_ok))
        (zbuf, tid, b1b, b2b, slotb), _ = jax.lax.scan(
            chunk_body, init, data, unroll=2)
    zbuf = jnp.where(jnp.isfinite(zbuf), zbuf, 1.0)
    return zbuf, tid, b1b, b2b, slotb


def rasterize(clip, tri_valid, width: int, height: int,
              bin_capacity: int = 2048, chunk: int = 8,
              light_capacity: int = 48, heavy_tiles: int = 64,
              heavy_capacity: int = 256,
              return_tiled: bool = False,
              slim: bool = False,
              ):
    """Full visibility pass.  width/height are padded up to tile multiples
    internally; outputs are cropped back.  Returns (vis, bin_overflow), or
    (vis, overflow, tiled: TiledVisibility) with ``return_tiled=True`` (the
    deferred shader's per-tile one-hot resolve input).

    ``slim=True``: the tile scan carries just
    (depth, slot) — tri_id/b1/b2 come back None and the tiled shader
    recomputes them per pixel from ``tiled.sub_raster`` (bit-identical).
    Use for the depth-only and tiled-shade paths; the flat gather shade
    needs the full carry.

    **Light/heavy split**: triangle density per tile is highly skewed (a
    detailed mesh concentrates thousands of triangles in a few tiles while
    most tiles hold a handful).  All tiles raster their first
    ``light_capacity`` triangles; the ``heavy_tiles`` fullest tiles are
    re-rastered with the full ``bin_capacity`` and overwrite their light
    results.  This keeps per-frame work at
    ``tiles*light + heavy_tiles*bin_capacity`` triangle-tile evaluations
    instead of ``tiles*bin_capacity``."""
    pad_w = (-width) % TILE_W
    pad_h = (-height) % TILE_H
    rw, rh = width + pad_w, height + pad_h

    # near-plane clip: T triangles -> 2T sub-triangles with original-space
    # corner barycentrics
    t = clip.shape[0] // 3
    clip_tri = clip.reshape(t, 3, 4)
    sub_clip, sub_bary, sub_valid = clip_near_plane(clip_tri, tri_valid)
    s = 2 * t
    sub_clip = sub_clip.reshape(s, 3, 4)
    sub_bary = sub_bary.reshape(s, 3, 3)
    sub_valid = sub_valid.reshape(s)
    orig_id = jnp.repeat(jnp.arange(t, dtype=jnp.int32), 2)

    # screen mapping uses the TRUE resolution; the tile grid just extends
    # past the right/bottom edges into cropped padding
    tri = setup_triangles(sub_clip, sub_valid, width, height)
    k_local = min(bin_capacity, 2 * t)
    ids, counts, local_counts, overflow, (tiles_y, tiles_x) = bin_triangles(
        tri, rw, rh, k_local=k_local
    )
    n_tiles = ids.shape[0]

    tx = jnp.tile(jnp.arange(tiles_x, dtype=jnp.float32) * TILE_W, tiles_y)
    ty = jnp.repeat(jnp.arange(tiles_y, dtype=jnp.float32) * TILE_H, tiles_x)

    def pad_chunk(a, fill):
        pad_k = (-a.shape[1]) % chunk
        if pad_k:
            pad_shape = (a.shape[0], pad_k) + a.shape[2:]
            a = jnp.concatenate(
                [a, jnp.full(pad_shape, fill, a.dtype)], axis=1
            )
        return a

    def gathered(sel_ids):
        """Pre-gather per-tile triangle data once (no gathers in the pixel
        loop)."""
        safe = jnp.maximum(sel_ids, 0)
        return dict(
            x=pad_chunk(tri["sx"][safe], 0.0),
            y=pad_chunk(tri["sy"][safe], 0.0),
            z=pad_chunk(tri["z"][safe], 0.0),
            oid=pad_chunk(orig_id[safe], 0),
            cb=pad_chunk(sub_bary[safe], 0.0),
            ok=pad_chunk(sel_ids >= 0, False),
        )

    raster = jax.vmap(
        lambda d, x0, y0: _raster_tile(
            x0, y0, d["x"], d["y"], d["z"], d["oid"], d["cb"], d["ok"],
            chunk, slim=slim,
        ),
        in_axes=(0, 0, 0),
    )

    # light pass: every tile, global list (first K_GLOBAL slots of `ids`)
    # + first light_capacity locals
    kl = min(K_GLOBAL + light_capacity, ids.shape[1])
    zb, tid, b1, b2, slot = raster(gathered(ids[:, :kl]), tx, ty)

    # heavy pass: fullest tiles re-rastered at full capacity.  Behind a
    # lax.cond so frames where no tile exceeds the light capacity (most
    # frames — density is skewed only when a dense mesh fills few tiles)
    # skip the whole re-raster at RUNTIME, not just mask its writes.
    h = min(heavy_tiles, n_tiles)
    heavy_sel = heavy_needs = None
    if ids.shape[1] > kl and h > 0:
        # the light pass walks ALL global slots plus the first
        # ``kl - K_GLOBAL`` LOCAL slots, so a tile needs the heavy pass
        # exactly when its LOCAL count exceeds that local capacity — the
        # global count never displaces local slots (ids are concatenated,
        # not interleaved)
        light_local_cap = kl - K_GLOBAL
        heavy_sel = jax.lax.top_k(local_counts, h)[1]      # tile indices
        heavy_needs = local_counts[heavy_sel] > light_local_cap
        # the heavy pass re-rasters at ``heavy_capacity`` LOCAL slots, not
        # the full bin capacity: the demo's worst tiles hold ~170 locals
        # while the bin list is 2048 deep, and re-rastering the whole list
        # would cost 64*2048 triangle-tile evals per frame once a dense
        # mesh is in view.  Locals beyond the heavy capacity are dropped and
        # surface in the overflow counter like every other budget here.
        kh = min(K_GLOBAL + heavy_capacity, ids.shape[1])
        heavy_local_cap = kh - K_GLOBAL

        def heavy_branch(bufs):
            outs_h = raster(
                gathered(ids[heavy_sel][:, :kh]), tx[heavy_sel], ty[heavy_sel]
            )
            # only overwrite tiles that actually exceeded the light capacity
            needs = heavy_needs[:, None, None]
            return tuple(
                None if cur is None else cur.at[heavy_sel].set(
                    jnp.where(needs, hv, cur[heavy_sel]))
                for cur, hv in zip(bufs, outs_h)
            )

        zb, tid, b1, b2, slot = jax.lax.cond(
            jnp.any(local_counts > light_local_cap), heavy_branch,
            lambda bufs: bufs,
            (zb, tid, b1, b2, slot),
        )
        # light-capacity overflow not covered by the heavy pass (heavy
        # coverage itself is capped at heavy_local_cap)
        total_over = jnp.maximum(local_counts - light_local_cap, 0).sum()
        covered = jnp.maximum(
            jnp.minimum(local_counts[heavy_sel], heavy_local_cap)
            - light_local_cap, 0).sum()
        overflow = overflow + total_over - covered

    def untile(a):
        if a is None:
            return None
        a = a.reshape(tiles_y, tiles_x, TILE_H, TILE_W)
        a = jnp.transpose(a, (0, 2, 1, 3)).reshape(rh, rw)
        return a[:height, :width]

    vis = VisibilityBuffer(
        depth=untile(zb),
        tri_id=untile(tid),
        b1=untile(b1),
        b2=untile(b2),
    )
    if return_tiled:
        sub_raster = None
        if slim:
            sx, sy, cb = tri["sx"], tri["sy"], sub_bary
            sub_raster = jnp.stack([
                sx[:, 0], sx[:, 1], sx[:, 2],
                sy[:, 0], sy[:, 1], sy[:, 2],
                cb[:, 0, 1], cb[:, 1, 1], cb[:, 2, 1],
                cb[:, 0, 2], cb[:, 1, 2], cb[:, 2, 2],
            ])                                         # [12, S]
        tiled = TiledVisibility(depth=zb, slot=slot, b1=b1, b2=b2, ids=ids,
                                sub_raster=sub_raster,
                                heavy=heavy_sel, heavy_needs=heavy_needs)
        return vis, overflow, tiled
    return vis, overflow
