"""XLA tile raster against a plain NumPy edge-function rasteriser.

The reference loops over triangles in float64: near-plane clip (clip-space
z >= 0, Sutherland-Hodgman), perspective divide, the same screen mapping,
two-sided edge-function coverage at pixel centres, screen-linear depth in
[0, 1] and a LESS depth test.  Pixel centres within float32 rounding of an
edge, or of an equal-depth crossing, may resolve either way in the float32
raster, so up to 0.1% of pixels may name another triangle; everywhere else
the triangle id is equal and the depth agrees to 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from banggameengine_tpu import math3d
from banggameengine_tpu.render import raster as rz


def _clip_polygon(poly):
    """Clip a list of clip-space vertices against z >= 0."""
    out = []
    for i in range(len(poly)):
        a, b = poly[i], poly[(i + 1) % len(poly)]
        a_in, b_in = a[2] >= 0.0, b[2] >= 0.0
        if a_in:
            out.append(a)
        if a_in != b_in:
            t = a[2] / (a[2] - b[2])
            out.append(a + (b - a) * t)
    return out


def raster_reference(clip, width, height, keep=None):
    """-> (tri_id i32[H,W] (-1 = background), depth f64[H,W]); ``keep``
    optionally limits the triangles drawn."""
    clip = np.asarray(clip, np.float64).reshape(-1, 3, 4)
    px = np.arange(width)[None, :] + 0.5
    py = np.arange(height)[:, None] + 0.5
    tri_id = np.full((height, width), -1, np.int32)
    zbuf = np.full((height, width), np.inf)
    for t, tri in enumerate(clip):
        if keep is not None and t not in keep:
            continue
        poly = _clip_polygon(list(tri))
        for k in range(1, len(poly) - 1):
            v = np.stack([poly[0], poly[k], poly[k + 1]])
            w = v[:, 3]
            if (w <= 1e-7).any():
                continue
            sx = (v[:, 0] / w * 0.5 + 0.5) * width
            sy = (1.0 - (v[:, 1] / w * 0.5 + 0.5)) * height
            z = v[:, 2] / w
            area = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (
                sx[2] - sx[0])
            if abs(area) <= 1e-9:
                continue
            e0 = (sx[1] - sx[0]) * (py - sy[0]) - (sy[1] - sy[0]) * (px - sx[0])
            e1 = (sx[2] - sx[1]) * (py - sy[1]) - (sy[2] - sy[1]) * (px - sx[1])
            e2 = (sx[0] - sx[2]) * (py - sy[2]) - (sy[0] - sy[2]) * (px - sx[2])
            if area > 0:
                cover = (e0 >= 0) & (e1 >= 0) & (e2 >= 0)
            else:
                cover = (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
            b1, b2 = e2 / area, e0 / area
            d = (1.0 - b1 - b2) * z[0] + b1 * z[1] + b2 * z[2]
            win = cover & (d >= 0.0) & (d <= 1.0) & (d < zbuf)
            zbuf = np.where(win, d, zbuf)
            tri_id = np.where(win, t, tri_id)
    depth = np.where(np.isfinite(zbuf), zbuf, 1.0)
    return tri_id, depth


def _random_scene(t, seed):
    rng = np.random.default_rng(seed)
    view = math3d.mtx_look_at(
        jnp.asarray([0.0, 1.5, -6.0]), jnp.asarray([0.0, 0.5, 0.0])
    )
    proj = math3d.mtx_proj(60.0, 320 / 180, 0.1, 100.0)
    verts = rng.uniform(-3, 3, (t * 3, 3)).astype(np.float32)
    return verts, view, proj


def _near_clip_scene():
    # triangles crossing the camera plane (ground-quad shape)
    view = math3d.mtx_look_at(jnp.asarray([0.0, 1.0, 0.0]),
                              jnp.asarray([0.0, 1.0, 1.0]))
    proj = math3d.mtx_proj(60.0, 16 / 9, 0.1, 100.0)
    verts = np.array(
        [[-50, 0, -50], [50, 0, -50], [0, 0, 50],
         [-5, 0.5, 2], [5, 0.5, 2], [0, 0.5, 8]], np.float32)
    return verts, view, proj


@pytest.mark.parametrize("scene,width,height,overflows", [
    (lambda: _random_scene(50, 0), 320, 180, False),
    # 200 large random triangles overflow the shared list of tile-spanning
    # triangles (K_GLOBAL slots): the raster drops the excess and counts
    # it, so the reference draws only the triangles that were binned
    (lambda: _random_scene(200, 1), 320, 180, True),
    (lambda: _random_scene(7, 2), 320, 180, False),
    (_near_clip_scene, 256, 128, False),
], ids=["random50", "random200", "random7", "near_clip"])
def test_xla_raster_matches_numpy_reference(scene, width, height, overflows):
    verts, view, proj = scene()
    vp = np.asarray(math3d.mat_mul(proj, view))
    v4 = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], 1)
    clip = (vp @ v4.T).T.astype(np.float32)
    t = len(verts) // 3
    vis, overflow, tiled = rz.rasterize(
        jnp.asarray(clip), jnp.ones(t, bool), width, height,
        return_tiled=True)
    ids = np.asarray(tiled.ids)
    keep = set((ids[ids >= 0] // 2).tolist())   # sub-triangle -> triangle
    assert (int(overflow) > 0) == overflows
    ref_id, ref_depth = raster_reference(clip, width, height, keep)
    tid = np.asarray(vis.tri_id)
    assert (ref_id >= 0).any()
    same = tid == ref_id
    assert (~same).mean() <= 1e-3, f"{(~same).mean():.4%} pixels differ"
    np.testing.assert_allclose(np.asarray(vis.depth)[same], ref_depth[same],
                               atol=1e-5)
