"""Deferred Blinn-Phong shading of the visibility buffer.

Reproduces the reference's fragment shader **exactly**
(``assets/shaders/fs_basic.sc:19-36``):

    N = normalize(worldNormal); L = normalize(-lightDir)
    V = normalize(cameraPos - worldPos); H = normalize(L + V)
    base = tex.rgb * vertexColor.rgb * baseTint.rgb
    lit  = ambient + lightColor * max(dot(N, L), 0)
    spec = pow(max(dot(N, H), 0), shininess) * specIntensity
    rgb  = base * lit + specColor * spec

with the renderer's global shininess/specIntensity forced over the material
copy (``Renderer.cpp:657-659``) and light direction from yaw/pitch
(``Renderer.cpp:514-522``: dir = (cy*cp, sp, sy*cp)).  Defaults: ambient 0.5,
lightColor white, shininess 32, specIntensity 0.35 (``Renderer.h:120-122``).

Because shading is deferred, each of the H*W pixels is shaded exactly once —
the per-pixel material math and texture gathers never run on occluded
fragments.

Two per-pixel attribute fetch strategies exist:

- :func:`shade_visibility` (flat): one channel-major ``take`` of the
  [C, T] triangle super-row table by the per-pixel triangle id — one
  row-gather per pixel.
- :func:`shade_visibility_tiled`: a per-tile one-hot resolve.  Each tile's visible triangles are the <= KL
  entries of its binned id list, so the fetch is ``onehot[px, KL] @
  table[KL, C]`` — dense matmuls instead of 2M row-gathers.  Exact: the
  one-hot has a single 1 per covered pixel, so the contraction selects
  whole f32 rows bit-identically.  The entire shade stays in tile-major
  component form ([tiles, px] planes); only the final u8 image untiles.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

Array = jax.Array

CLEAR_COLOR = (0x88 / 255.0, 0xAA / 255.0, 0xFF / 255.0)  # Renderer.cpp:161


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LightParams:
    """Directional light + global material overrides (host-tweakable, the
    arrow-key light controls at ``Application.cpp:161-245``)."""

    yaw: Array      # f32[]
    pitch: Array    # f32[]
    color: Array    # f32[3]
    ambient: Array  # f32[]
    shininess: Array       # f32[] global override
    spec_intensity: Array  # f32[] global override

    @staticmethod
    def default() -> "LightParams":
        return LightParams(
            yaw=jnp.float32(0.0),
            pitch=jnp.float32(0.0),
            color=jnp.ones(3, jnp.float32),
            ambient=jnp.float32(0.5),
            shininess=jnp.float32(32.0),
            spec_intensity=jnp.float32(0.35),
        )

    def direction(self) -> Array:
        cy, sy = jnp.cos(self.yaw), jnp.sin(self.yaw)
        cp, sp = jnp.cos(self.pitch), jnp.sin(self.pitch)
        return jnp.stack([cy * cp, sp, sy * cp])


def sample_texture_bilinear_quad(textures_quad: Array, tex_size: Array,
                                 tex_id: Array, uv: Array) -> Array:
    """Bilinear sampling with ONE gather per pixel.

    ``textures_quad`` u8[T,S,S,16] packs each texel's wrap-correct 2x2
    neighborhood (built at scene load), so the four bilinear taps arrive in
    a single row-gather; only the weights are computed here.
    """
    wh = tex_size[tex_id].astype(jnp.float32)
    w, h = wh[..., 0], wh[..., 1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0

    def wrap(i, n):
        return jnp.mod(i.astype(jnp.int32), jnp.maximum(n.astype(jnp.int32), 1))

    x0i = wrap(x0, w)
    y0i = wrap(y0, h)
    quad = textures_quad[tex_id, y0i, x0i].astype(jnp.float32) / 255.0
    c00, c01 = quad[..., 0:4], quad[..., 4:8]
    c10, c11 = quad[..., 8:12], quad[..., 12:16]
    top = c00 + (c01 - c00) * tx[..., None]
    bot = c10 + (c11 - c10) * tx[..., None]
    return top + (bot - top) * ty[..., None]


def sample_texture_bilinear(textures: Array, tex_size: Array, tex_id: Array,
                            uv: Array) -> Array:
    """Bilinear, wrap-repeat texture sampling.

    textures: u8[T, S, S, 4] (padded square atlas pages);
    tex_size: i32[T, 2] actual (w, h); tex_id: i32[...]; uv: f32[..., 2].
    Returns f32[..., 4] in [0, 1].
    """
    wh = tex_size[tex_id].astype(jnp.float32)          # [..., 2]
    w, h = wh[..., 0], wh[..., 1]
    # wrap repeat, texel centers at integer+0.5 (matching D3D point of view)
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0

    def wrap(i, n):
        return jnp.mod(i.astype(jnp.int32), jnp.maximum(n.astype(jnp.int32), 1))

    x0i, x1i = wrap(x0, w), wrap(x0 + 1, w)
    y0i, y1i = wrap(y0, h), wrap(y0 + 1, h)

    def fetch(yi, xi):
        return textures[tex_id, yi, xi].astype(jnp.float32) / 255.0

    c00 = fetch(y0i, x0i)
    c01 = fetch(y0i, x1i)
    c10 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)
    top = c00 + (c01 - c00) * tx[..., None]
    bot = c10 + (c11 - c10) * tx[..., None]
    return top + (bot - top) * ty[..., None]


def _pack_tri_rows(world_pos, world_nrm, v_uv, inv_w, tri_material,
                   mat_base_tint, mat_uv_scale, mat_spec_color, mat_tex,
                   tex_size, reconstruct_wp: bool):
    """Per-triangle channel-major super-row table [C, T] + layout indices.

    With ``reconstruct_wp`` (world position rebuilt from the depth plane —
    exact for planar triangles since NDC z is affine in screen space), C=28:
      0..17  corner attrs (3 corners x [nrm.xyz, u_tex, v_tex, inv_w])
      18..21 material base tint rgba   22..24 material spec color
      25     texture id                26..27 texture (w, h)
    Otherwise C=37 with per-corner world positions prepended.  uv is
    pre-scaled to TEXEL units per corner (bakes material uv scale AND
    texture size into the T-sized table).
    """
    mat_twh = tex_size[mat_tex].astype(jnp.float32)    # [M, 2]
    t = tri_material.shape[0]
    uv_texel = (
        v_uv.reshape(t, 3, 2)
        * (mat_uv_scale * mat_twh)[tri_material][:, None, :]
    ).reshape(t * 3, 2)                                # [V, 2] texel units

    if reconstruct_wp:
        packed = jnp.concatenate(
            [world_nrm, uv_texel, inv_w[:, None]], axis=-1
        )                                              # [V, 6]
        packed_tri = packed.reshape(-1, 18)            # [T, 18]
        layout = dict(span=6, uvo=3, m_tint=18, m_spec=22, m_tex0=25,
                      m_tw=26)
    else:
        packed = jnp.concatenate(
            [world_pos, world_nrm, uv_texel, inv_w[:, None]], axis=-1
        )                                              # [V, 9]
        packed_tri = packed.reshape(-1, 27)            # [T, 27]
        layout = dict(span=9, uvo=6, m_tint=27, m_spec=31, m_tex0=34,
                      m_tw=35)
    mat_packed = jnp.concatenate(
        [mat_base_tint, mat_spec_color,
         mat_tex[:, None].astype(jnp.float32), mat_twh], axis=-1,
    )                                                  # [M, 10]
    tri_row_t = jnp.concatenate(
        [packed_tri, mat_packed[tri_material]], axis=-1).T  # [C, T]
    return tri_row_t, layout


def _shade_core(get, b1, b2, pxc, pyc, ndc_z, background, layout,
                reconstruct_wp, width, height, view, proj,
                textures, textures_quad, textures_quad_t,
                camera_pos, light, wireframe):
    """Shared component-form shading math.

    ``get(c)`` returns per-pixel channel ``c`` of the triangle super-row in
    an arbitrary (but consistent) pixel shape; every other input matches
    that shape.  Returns (r, g, b, a) f32 channels in [0, 1]-ish (clamped
    by the caller's u8 conversion).
    """
    span, uvo = layout["span"], layout["uvo"]
    m_tint, m_spec = layout["m_tint"], layout["m_spec"]
    m_tex0, m_tw = layout["m_tex0"], layout["m_tw"]

    b0 = 1.0 - b1 - b2
    iw0, iw1, iw2 = get(span - 1), get(2 * span - 1), get(3 * span - 1)
    w0 = b0 * iw0
    w1 = b1 * iw1
    w2 = b2 * iw2
    persp_den = w0 + w1 + w2
    inv_den = 1.0 / jnp.where(jnp.abs(persp_den) > 1e-12, persp_den, 1e-12)

    def interp(c):
        """Perspective-correct interpolation of per-corner channel c."""
        return (get(c) * w0 + get(c + span) * w1 + get(c + 2 * span) * w2) \
            * inv_den

    if reconstruct_wp:
        # unproject (ndc_x, ndc_y, ndc_z, 1) through inv(proj @ view)
        m = jnp.linalg.inv(jnp.matmul(proj, view))
        ndc_x = pxc * (2.0 / width) - 1.0
        ndc_y = 1.0 - pyc * (2.0 / height)
        hx = m[0, 0] * ndc_x + m[0, 1] * ndc_y + m[0, 2] * ndc_z + m[0, 3]
        hy = m[1, 0] * ndc_x + m[1, 1] * ndc_y + m[1, 2] * ndc_z + m[1, 3]
        hz = m[2, 0] * ndc_x + m[2, 1] * ndc_y + m[2, 2] * ndc_z + m[2, 3]
        hw = m[3, 0] * ndc_x + m[3, 1] * ndc_y + m[3, 2] * ndc_z + m[3, 3]
        inv_hw = 1.0 / jnp.where(jnp.abs(hw) > 1e-12, hw, 1e-12)
        wpx, wpy, wpz = hx * inv_hw, hy * inv_hw, hz * inv_hw
        nx, ny, nz = interp(0), interp(1), interp(2)
    else:
        wpx, wpy, wpz = interp(0), interp(1), interp(2)
        nx, ny, nz = interp(3), interp(4), interp(5)
    u = interp(uvo)
    v = interp(uvo + 1)

    tint_r, tint_g, tint_b, tint_a = (get(m_tint), get(m_tint + 1),
                                      get(m_tint + 2), get(m_tint + 3))
    spec_r, spec_g, spec_b = get(m_spec), get(m_spec + 1), get(m_spec + 2)
    tex_id = get(m_tex0).astype(jnp.int32)
    tex_w, tex_h = get(m_tw), get(m_tw + 1)

    tex_r, tex_g, tex_b, tex_a = _sample_bilinear_planar(
        textures, textures_quad, textures_quad_t, tex_id, tex_w, tex_h, u, v)

    inv_nlen = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-18))
    nx, ny, nz = nx * inv_nlen, ny * inv_nlen, nz * inv_nlen

    light_dir = light.direction()
    ld = -light_dir
    ld = ld / jnp.maximum(jnp.linalg.norm(ld), 1e-9)
    lx, ly, lz = ld[0], ld[1], ld[2]

    vx = camera_pos[0] - wpx
    vy = camera_pos[1] - wpy
    vz = camera_pos[2] - wpz
    inv_vlen = jax.lax.rsqrt(jnp.maximum(vx * vx + vy * vy + vz * vz, 1e-18))
    vx, vy, vz = vx * inv_vlen, vy * inv_vlen, vz * inv_vlen

    hx, hy, hz = lx + vx, ly + vy, lz + vz
    inv_hlen = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz, 1e-18))
    hx, hy, hz = hx * inv_hlen, hy * inv_hlen, hz * inv_hlen

    diff = jnp.maximum(nx * lx + ny * ly + nz * lz, 0.0)
    ndoth = jnp.maximum(nx * hx + ny * hy + nz * hz, 0.0)
    # global overrides replace per-material shininess/intensity
    # (Renderer.cpp:657-659); per-material spec color is kept
    s = jnp.power(ndoth, light.shininess) * light.spec_intensity

    lit_r = light.ambient + light.color[0] * diff
    lit_g = light.ambient + light.color[1] * diff
    lit_b = light.ambient + light.color[2] * diff
    rgb_r = tex_r * tint_r * lit_r + spec_r * s       # vertex color is white
    rgb_g = tex_g * tint_g * lit_g + spec_g * s
    rgb_b = tex_b * tint_b * lit_b + spec_b * s
    alpha = tex_a * tint_a

    clear = CLEAR_COLOR
    if wireframe:
        min_bary = jnp.minimum(jnp.minimum(b0, b1), b2)
        on_edge = min_bary < 0.05
        rgb_r = jnp.where(on_edge, rgb_r, clear[0])
        rgb_g = jnp.where(on_edge, rgb_g, clear[1])
        rgb_b = jnp.where(on_edge, rgb_b, clear[2])
    rgb_r = jnp.where(background, clear[0], rgb_r)
    rgb_g = jnp.where(background, clear[1], rgb_g)
    rgb_b = jnp.where(background, clear[2], rgb_b)
    alpha = jnp.where(background, 1.0, alpha)
    return rgb_r, rgb_g, rgb_b, alpha


def _to_u8(x):
    return (jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)


def shade_visibility(
    vis_tri_id: Array,    # i32[H,W]
    vis_b1: Array,        # f32[H,W] barycentric of vertex 1
    vis_b2: Array,        # f32[H,W] barycentric of vertex 2
    # per-vertex attributes (V = 3*T)
    world_pos: Array,     # f32[V,3]
    world_nrm: Array,     # f32[V,3]
    v_uv: Array,          # f32[V,2]
    inv_w: Array,         # f32[V]
    tri_material: Array,  # i32[T]
    # material tables
    mat_base_tint: Array, mat_uv_scale: Array, mat_spec_params: Array,
    mat_spec_color: Array, mat_tex: Array,
    textures: Array, tex_size: Array,
    camera_pos: Array,    # f32[3]
    light: LightParams,
    wireframe: bool = False,
    textures_quad: Array | None = None,
    textures_quad_t: Array | None = None,
    vis_depth: Array | None = None,   # f32[H,W] NDC z (enables wp
    view: Array | None = None,        # reconstruction from depth — drops
    proj: Array | None = None,        # 9 interpolated channels)
) -> Array:
    """Shade every pixel of the visibility buffer.  Returns u8[H,W,4].

    The math runs in **component form**: every quantity is a flat f32[P]
    vector (P = H*W pixels).  The per-pixel fetch is exactly TWO
    channel-major ``take(..., axis=1)`` gathers — one [C, P] carrying all
    three corners' attributes AND the triangle's resolved material/texture
    parameters, and one [16, P] texel-quad for the bilinear taps.
    Channel-major matters: the gathers land channel-PLANAR, so every
    consumer reads a contiguous [P] row instead of a strided column of a
    [P, C] array.  An
    optimization barrier pins each gather to run once — XLA otherwise
    fuses gathers into every consumer kernel, re-gathering per use.

    ``wireframe=True`` keeps only pixels near triangle edges (barycentric
    proximity), the F1 wireframe toggle (``Renderer.cpp:766-783``
    BGFX_DEBUG_WIREFRAME equivalent)."""
    h, w = vis_tri_id.shape
    p = h * w
    tid = jnp.maximum(vis_tri_id, 0).reshape(p)

    reconstruct_wp = (vis_depth is not None and view is not None
                      and proj is not None)
    tri_row_t, layout = _pack_tri_rows(
        world_pos, world_nrm, v_uv, inv_w, tri_material,
        mat_base_tint, mat_uv_scale, mat_spec_color, mat_tex, tex_size,
        reconstruct_wp)

    # promise_in_bounds: tid is max(vis_id, 0) and raster ids are < T by
    # construction — the default clip mode adds a clamp+select per index
    a = jax.lax.optimization_barrier(
        tri_row_t.at[:, tid].get(
            mode="promise_in_bounds"))                 # [C, P] ONE gather

    # shade on [H, W] planes (the [C, P] -> [C, H, W] reshape is a free
    # bitcast)
    a3 = a.reshape(a.shape[0], h, w)

    pxc = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + 0.5
    pyc = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + 0.5
    ndc_z = vis_depth if reconstruct_wp else None
    background = vis_tri_id < 0

    rgb_r, rgb_g, rgb_b, alpha = _shade_core(
        lambda c: a3[c], vis_b1, vis_b2, pxc, pyc, ndc_z, background,
        layout, reconstruct_wp, w, h, view, proj,
        textures, textures_quad, textures_quad_t,
        camera_pos, light, wireframe)

    # single interleave at the very end: [4, H, W] -> [H, W, 4]
    out = jnp.stack([_to_u8(rgb_r), _to_u8(rgb_g), _to_u8(rgb_b),
                     _to_u8(alpha)])
    return jnp.transpose(out, (1, 2, 0))


def shade_visibility_tiled(
    tiled,                # raster.TiledVisibility
    width: int, height: int,
    # per-vertex attributes (V = 3*T)
    world_pos: Array, world_nrm: Array, v_uv: Array, inv_w: Array,
    tri_material: Array,
    # material tables
    mat_base_tint: Array, mat_uv_scale: Array, mat_spec_params: Array,
    mat_spec_color: Array, mat_tex: Array,
    textures: Array, tex_size: Array,
    camera_pos: Array, light: LightParams,
    view: Array, proj: Array,
    shade_slots: int = 64,
    heavy_shade_slots: int = 0,
    wireframe: bool = False,
    textures_quad: Array | None = None,
    textures_quad_t: Array | None = None,
) -> Array:
    """Tile-major deferred shade with a per-tile one-hot resolve.

    The per-pixel attribute fetch is ``onehot[px, KL] @ table[KL, C]`` per
    tile (KL = shade_slots covering the light raster list); the contraction
    emits channels PLANAR per tile ([tiles, C, px]), the whole shading math
    runs on [tiles, px] planes, and only the final u8 RGBA untiles — no
    framebuffer-sized f32 transposes anywhere.  Winning slots beyond KL
    (heavy-pass tiles) fall back to the row gather under a runtime-skipped
    ``lax.cond``.  Bit-exact vs :func:`shade_visibility` (the one-hot
    selects whole f32 rows).  Returns u8[H,W,4].

    With a SLIM visibility input (``tiled.b1 is None`` — the raster scan
    carried only depth+slot), the per-sub-triangle screen rows
    (``tiled.sub_raster``) join the resolve table and the barycentrics are
    recomputed here once per pixel with the exact op sequence the full
    raster carry used — bit-identical output, 3 fewer framebuffer planes
    through the raster scan."""
    from banggameengine_tpu.render.raster import TILE_H, TILE_W

    n_tiles, th, tw = tiled.slot.shape
    px_per_tile = th * tw
    tiles_x = -(-width // TILE_W)
    tiles_y = n_tiles // tiles_x
    rh, rw = tiles_y * th, tiles_x * tw

    tri_row_t, layout = _pack_tri_rows(
        world_pos, world_nrm, v_uv, inv_w, tri_material,
        mat_base_tint, mat_uv_scale, mat_spec_color, mat_tex, tex_size,
        reconstruct_wp=True)

    slim = tiled.b1 is None
    kl = min(shade_slots, tiled.ids.shape[1])
    ids_kl = tiled.ids[:, :kl]
    if slim:
        # per-SUB-triangle table: each original triangle's channels
        # repeated for its (up to) 2 near-clip subs, plus the 12
        # screen-space raster rows (corner coords + original-space corner
        # barycentrics) the per-pixel bary recomputation needs
        rb = tri_row_t.shape[0]                        # raster rows base
        sub_row_t = jnp.concatenate(
            [jnp.repeat(tri_row_t, 2, axis=1), tiled.sub_raster], axis=0)
        tables = sub_row_t.T[jnp.maximum(ids_kl, 0)]       # [tiles, KL, C+12]
    else:
        # sub-triangle id -> original triangle row (near-clip emits 2 subs)
        sub_row_t = None
        tables = tri_row_t.T[jnp.maximum(ids_kl, 0) // 2]  # [tiles, KL, C]

    slot_p = tiled.slot.reshape(n_tiles, px_per_tile)

    def onehot_resolve(tabs, slots, k):
        """[n, k, C] tables + [n, px] slots -> [n, C, px] via bf16
        one-hot contractions.

        The one-hot is built in bf16 (0/1 are exact; half the memory
        traffic of an f32 one-hot) and materialized ONCE behind a barrier:
        without it XLA fuses the compare into the contraction and re-reads
        it per channel.  Per-operand precision keeps the f32 payload rows
        EXACT (HIGHEST) while the already-bf16 one-hot side stays
        single-pass.

        Contractions WIDER than 128 slots are chunked into <=128-slot dots
        and summed.  The sum is exact — every pixel's slot lands in exactly
        one chunk, the rest contribute zeros."""
        parts = []
        for lo in range(0, k, 128):
            kc = min(128, k - lo)
            ohc = (slots[..., None]
                   == (lo + jnp.arange(kc))[None, None, :]).astype(
                       jnp.bfloat16)                   # [n, px, kc]
            ohc = jax.lax.optimization_barrier(ohc)
            parts.append(jax.lax.dot_general(
                jnp.swapaxes(tabs[:, lo:lo + kc, :], 1, 2), ohc,
                dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
                precision=(jax.lax.Precision.HIGHEST,
                           jax.lax.Precision.DEFAULT)))
        res = parts[0]
        for p in parts[1:]:
            res = res + p
        # barrier the dot itself so the channel split below stays a pure
        # relayout copy
        return jax.lax.optimization_barrier(res)

    # batch t, contract KL: [t, C, KL] x [t, px, KL] -> [t, C, px]
    resolved = onehot_resolve(tables, slot_p, kl)
    covered = kl
    if tiled.heavy is not None and heavy_shade_slots > kl:
        # heavy-pass tiles get a SECOND, wider resolve over their own id
        # lists (covering the heavy raster's slot space) instead of the
        # per-pixel row-gather fallback
        kh = min(heavy_shade_slots, tiled.ids.shape[1])
        hsel = tiled.heavy
        ids_h = tiled.ids[hsel][:, :kh]
        tab_h = (sub_row_t.T[jnp.maximum(ids_h, 0)] if slim
                 else tri_row_t.T[jnp.maximum(ids_h, 0) // 2])
        res_h = onehot_resolve(tab_h, slot_p[hsel], kh)
        res_h = jnp.where(tiled.heavy_needs[:, None, None], res_h,
                          resolved[hsel])
        resolved = resolved.at[hsel].set(res_h)
        covered = kh
    # split into per-channel [t, px] planes behind ONE barrier.  Do NOT
    # transpose to [C, t, px] and slice that: XLA may fold the transpose
    # into a layout relabel (barriers pin values, not layouts), and every
    # per-channel slice then re-reads the whole array.  Separate plane
    # buffers are layout-proof.
    n_chan = resolved.shape[1]
    planes = jax.lax.optimization_barrier(
        tuple(resolved[:, c, :] for c in range(n_chan)))
    # safety net for winners beyond the resolved slot space (only
    # reachable when the caller's shade/heavy widths understate the
    # raster's walk widths); runtime-skipped otherwise
    need_fb = slot_p >= covered

    def _fb_planes(planes_):
        sid = jnp.take_along_axis(tiled.ids, jnp.maximum(slot_p, 0), axis=1)
        if slim:
            rows = jnp.take(sub_row_t, jnp.where(need_fb, sid, 0),
                            axis=1)                    # [C+12, t, px]
        else:
            rows = jnp.take(tri_row_t, jnp.where(need_fb, sid // 2, 0),
                            axis=1)                    # [C, t, px]
        return tuple(jnp.where(need_fb, rows[c], p)
                     for c, p in enumerate(planes_))

    planes = jax.lax.cond(
        jnp.any(need_fb), _fb_planes, lambda p: p, planes)
    get = lambda c: planes[c]

    if slim:
        b1 = b2 = None
    else:
        b1 = tiled.b1.reshape(n_tiles, px_per_tile)
        b2 = tiled.b2.reshape(n_tiles, px_per_tile)
    ndc_z = tiled.depth.reshape(n_tiles, px_per_tile)
    return _shade_tiled_tail(
        get, slot_p, ndc_z, b1, b2, layout, rb if slim else 0,
        n_tiles, tiles_x, tiles_y, th, tw, width, height,
        textures, textures_quad, textures_quad_t,
        camera_pos, light, view, proj, wireframe)


def _shade_tiled_tail(get, slot_p, ndc_z, b1, b2, layout, rb,
                      n_tiles, tiles_x, tiles_y, th, tw, width, height,
                      textures, textures_quad, textures_quad_t,
                      camera_pos, light, view, proj, wireframe):
    """Shared tail of the tile-major deferred shade: pixel coordinates,
    slim barycentric recomputation, component-form shading math, u8
    untile.  ``b1``/``b2`` None => recompute from the raster rows at
    table offset ``rb`` (slim carry)."""
    px_per_tile = th * tw
    rh, rw = tiles_y * th, tiles_x * tw
    # tile-major pixel coordinates (+0.5 centers)
    tile_ids = jnp.arange(n_tiles, dtype=jnp.int32)
    ox = ((tile_ids % tiles_x) * tw).astype(jnp.float32)
    oy = ((tile_ids // tiles_x) * th).astype(jnp.float32)
    xi = (jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1)
          .reshape(px_per_tile).astype(jnp.float32))
    yi = (jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0)
          .reshape(px_per_tile).astype(jnp.float32))
    pxc = ox[:, None] + xi[None, :] + 0.5                  # [tiles, px]
    pyc = oy[:, None] + yi[None, :] + 0.5

    if b1 is None:
        # recompute the winning triangle's barycentrics ONCE per pixel,
        # replicating the raster scan's exact op sequence (raster.py
        # chunk_depth + the ob1/ob2 mapping) so the output is
        # bit-identical to the full-carry path
        sx0, sx1, sx2 = get(rb), get(rb + 1), get(rb + 2)
        sy0, sy1, sy2 = get(rb + 3), get(rb + 4), get(rb + 5)
        e0 = (sx1 - sx0) * (pyc - sy0) - (sy1 - sy0) * (pxc - sx0)
        e2 = (sx0 - sx2) * (pyc - sy2) - (sy0 - sy2) * (pxc - sx2)
        area = (sx1 - sx0) * (sy2 - sy0) - (sy1 - sy0) * (sx2 - sx0)
        inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-9, area, 1e-9)
        sb1 = e2 * inv_area
        sb2 = e0 * inv_area
        sb0 = 1.0 - sb1 - sb2
        b1 = sb0 * get(rb + 6) + sb1 * get(rb + 7) + sb2 * get(rb + 8)
        b2 = sb0 * get(rb + 9) + sb1 * get(rb + 10) + sb2 * get(rb + 11)
    background = slot_p < 0

    rgb_r, rgb_g, rgb_b, alpha = _shade_core(
        get, b1, b2, pxc, pyc, ndc_z, background,
        layout, True, width, height, view, proj,
        textures, textures_quad, textures_quad_t,
        camera_pos, light, wireframe)

    # final interleave + untile on u8 only
    out = jnp.stack([_to_u8(rgb_r), _to_u8(rgb_g), _to_u8(rgb_b),
                     _to_u8(alpha)], axis=-1)              # [tiles, px, 4]
    out = (out.reshape(tiles_y, tiles_x, th, tw, 4)
           .transpose(0, 2, 1, 3, 4).reshape(rh, rw, 4))
    return out[:height, :width]


def _sample_bilinear_planar(textures, textures_quad, textures_quad_t,
                            tex_id, tw, th, u, v):
    """Bilinear, wrap-repeat sampling in component form.

    tex_id i32[...], tw/th f32[...] (actual texture size, pre-resolved into
    the per-triangle row), u/v f32[...] in TEXEL units (uv scale and
    texture size are baked per corner at the T-sized table); returns four
    f32 channel planes in the input pixel shape.  With the channel-major
    quad pack ``textures_quad_t`` (u8[16, T*S*S], each texel's wrap-correct
    2x2 RGBA neighborhood, built at scene load) the four bilinear taps
    arrive in ONE channel-planar take; otherwise falls back to four row
    gathers.
    """
    fx = u - 0.5
    fy = v - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0

    def wrap(i, n):
        return jnp.mod(i.astype(jnp.int32), jnp.maximum(n.astype(jnp.int32), 1))

    if textures_quad_t is not None:
        s = textures.shape[1]
        x0i = wrap(x0, tw)
        y0i = wrap(y0, th)
        # barrier the INDEX itself: without it XLA fuses the whole
        # mod/mul-add chain into the gather's index computation
        flat = jax.lax.optimization_barrier(
            ((tex_id * s + y0i) * s + x0i).reshape(-1))
        # gather with a FLAT index vector (multi-dim index arrays lower to
        # a slower gather); reshape the planar result back
        # promise_in_bounds: flat < T*S*S by the wrap mods above
        q = jax.lax.optimization_barrier(
            textures_quad_t.at[:, flat].get(
                mode="promise_in_bounds")
        ).reshape((16,) + x0i.shape)                     # [16, ...] u8

        def channel(c):
            c00 = q[c].astype(jnp.float32)
            c01 = q[c + 4].astype(jnp.float32)
            c10 = q[c + 8].astype(jnp.float32)
            c11 = q[c + 12].astype(jnp.float32)
            top = c00 + (c01 - c00) * tx
            bot = c10 + (c11 - c10) * tx
            return (top + (bot - top) * ty) * (1.0 / 255.0)

        return channel(0), channel(1), channel(2), channel(3)

    if textures_quad is not None:
        t, s = textures_quad.shape[0], textures_quad.shape[1]
        x0i = wrap(x0, tw)
        y0i = wrap(y0, th)
        flat = (tex_id * s + y0i) * s + x0i
        quad = textures_quad.reshape(t * s * s, 16)[flat]     # [..., 16]
        q = quad.astype(jnp.float32) * (1.0 / 255.0)

        def channel(c):
            top = q[..., c] + (q[..., c + 4] - q[..., c]) * tx
            bot = q[..., c + 8] + (q[..., c + 12] - q[..., c + 8]) * tx
            return top + (bot - top) * ty

        return channel(0), channel(1), channel(2), channel(3)

    t, s = textures.shape[0], textures.shape[1]
    tex_flat = textures.reshape(t * s * s, 4)
    x0i, x1i = wrap(x0, tw), wrap(x0 + 1.0, tw)
    y0i, y1i = wrap(y0, th), wrap(y0 + 1.0, th)

    def fetch(yi, xi):
        return tex_flat[(tex_id * s + yi) * s + xi].astype(jnp.float32) \
            * (1.0 / 255.0)                                    # [..., 4]

    c00 = fetch(y0i, x0i)
    c01 = fetch(y0i, x1i)
    c10 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)

    def channel(c):
        top = c00[..., c] + (c01[..., c] - c00[..., c]) * tx
        bot = c10[..., c] + (c11[..., c] - c10[..., c]) * tx
        return top + (bot - top) * ty

    return channel(0), channel(1), channel(2), channel(3)
