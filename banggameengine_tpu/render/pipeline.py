"""Full frame render pipeline: cull -> transform -> raster -> shade.

The array image of one ``Renderer::BeginFrame``/``EndFrame`` pair
(``Renderer.cpp:495-736``): instead of submitting per-submesh draw calls to a
graphics driver, the whole frame is one jitted function producing a
``uint8[H, W, 4]`` framebuffer in device memory (fetched to host only for
display).
Debug-line and HUD overlays composite on top (:mod:`debugdraw`, :mod:`hud`).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from banggameengine_tpu import math3d
from banggameengine_tpu.render import raster as rz
from banggameengine_tpu.render.cull import entity_frustum_mask
from banggameengine_tpu.render.shading import (
    LightParams, shade_visibility, shade_visibility_tiled,
)

Array = jax.Array


def render_frame(
    render_scene,          # scene.build.RenderScene
    world_mats: Array,     # f32[N,4,4] entity world matrices
    view: Array,           # f32[4,4]
    proj: Array,           # f32[4,4]
    camera_pos: Array,     # f32[3]
    light: Optional[LightParams] = None,
    width: int = 1280,
    height: int = 720,
    bin_capacity: int = 512,
    depth_only: bool = False,
    return_depth: bool = False,
    wireframe: bool = False,
    shade_mode: str = "gather",
):
    """Render one shaded frame (or depth buffer).

    Returns ``uint8[H, W, 4]`` (shaded), ``f32[H, W]`` NDC depth
    (``depth_only=True``), or ``(frame, depth)`` (``return_depth=True`` —
    used by the debug-line overlay pass).

    ``shade_mode`` picks the per-pixel attribute fetch: ``"gather"`` (one
    row gather per pixel, :func:`shade_visibility`; the faster on an H100
    at 1920x1080, see PERF.md) or ``"tiled"`` (per-tile one-hot resolve,
    :func:`shade_visibility_tiled`).  Both give the same image to within
    1 u8 LSB.
    """
    rs = render_scene
    if light is None:
        light = LightParams.default()

    if wireframe and not depth_only:
        # F1 wireframe: TRUE line primitives over the clear color (the
        # reference's BGFX_DEBUG_WIREFRAME replaces fill with line raster,
        # Renderer.cpp:766-783; like bgfx's debug mode there is no
        # hidden-line removal).  Mesh edges are deduplicated at scene
        # build; the depth-tested line pass draws near-to-far.
        from banggameengine_tpu.render.lines import draw_lines
        from banggameengine_tpu.render.shading import CLEAR_COLOR

        clear = jnp.asarray(
            [int(c * 255) for c in CLEAR_COLOR] + [255], jnp.uint8)
        frame = jnp.broadcast_to(clear, (height, width, 4))
        wm = world_mats[rs.edge_entity]                    # [E,4,4]
        pts = jnp.einsum(
            "eij,ekj->eki", wm[:, :3, :3], rs.edge_pos) + wm[:, None, :3, 3]
        colors = jnp.ones((rs.edge_pos.shape[0], 4), jnp.float32)
        frame = draw_lines(
            frame, jnp.ones((height, width), jnp.float32),
            pts, colors, rs.edge_valid, view, proj,
        )
        if return_depth:
            return frame, jnp.ones((height, width), jnp.float32)
        return frame

    # entity-level frustum cull -> triangle mask
    vis_ent = entity_frustum_mask(
        rs.ent_aabb_min, rs.ent_aabb_max, rs.ent_has_mesh,
        world_mats, view, proj,
    )
    tri_entity = rs.v_entity[::3]
    tri_valid = rs.tri_valid & vis_ent[tri_entity]

    # vertex transform (one fused matmul chain over all vertices)
    world_pos, clip = rz.transform_vertices(
        rs.v_pos, rs.v_entity, world_mats, view, proj
    )

    tiled = None
    if depth_only:
        # slim carry: the depth pass needs neither tri ids nor barycentrics
        vis, _overflow = rz.rasterize(
            clip, tri_valid, width, height, bin_capacity=bin_capacity,
            slim=True,
        )
        return vis.depth
    if shade_mode != "tiled":
        vis, _overflow = rz.rasterize(
            clip, tri_valid, width, height, bin_capacity=bin_capacity,
        )
    else:
        # slim carry (depth+slot only); the tiled shade recomputes
        # tid/b1/b2 for the winning triangle per pixel (bit-identical)
        vis, _overflow, tiled = rz.rasterize(
            clip, tri_valid, width, height, bin_capacity=bin_capacity,
            return_tiled=True, slim=True,
        )

    normal_mats = math3d.normal_matrix(world_mats)
    world_nrm = rz.transform_normals(rs.v_nrm, rs.v_entity, normal_mats)
    inv_w = 1.0 / jnp.where(jnp.abs(clip[:, 3]) > 1e-9, clip[:, 3], 1e-9)

    if tiled is not None:
        frame = shade_visibility_tiled(
            tiled, width, height,
            world_pos, world_nrm, rs.v_uv, inv_w,
            rs.tri_material,
            rs.mat_base_tint, rs.mat_uv_scale, rs.mat_spec_params,
            rs.mat_spec_color, rs.mat_tex,
            rs.textures, rs.tex_size,
            camera_pos, light, view, proj,
            # both resolves keep the light-list width for all tiles and
            # run a SECOND, wider resolve over just the heavy-pass tiles
            # (widths must match the raster walk: light = K_GLOBAL +
            # light_capacity, heavy = K_GLOBAL + heavy_capacity rasterize
            # defaults)
            shade_slots=rz.K_GLOBAL + 48,
            heavy_shade_slots=rz.K_GLOBAL + 256,
            wireframe=wireframe,
            textures_quad=getattr(rs, "textures_quad", None),
            textures_quad_t=getattr(rs, "textures_quad_t", None),
        )
        if return_depth:
            return frame, vis.depth
        return frame

    # materialize the visibility planes ONCE before deferred shading —
    # their untile transposes would otherwise be re-fused (recomputed)
    # into every shading consumer
    vis_tri_id, vis_b1, vis_b2, vis_depth = jax.lax.optimization_barrier(
        (vis.tri_id, vis.b1, vis.b2, vis.depth))

    frame = shade_visibility(
        vis_tri_id, vis_b1, vis_b2,
        world_pos, world_nrm, rs.v_uv, inv_w,
        rs.tri_material,
        rs.mat_base_tint, rs.mat_uv_scale, rs.mat_spec_params,
        rs.mat_spec_color, rs.mat_tex,
        rs.textures, rs.tex_size,
        camera_pos, light,
        wireframe=wireframe,
        textures_quad=getattr(rs, "textures_quad", None),
        textures_quad_t=getattr(rs, "textures_quad_t", None),
        vis_depth=vis_depth, view=view, proj=proj,
    )
    if return_depth:
        return frame, vis.depth
    return frame


def make_render_fn(render_scene, width: int, height: int,
                   bin_capacity: int = 512, depth_only: bool = False,
                   return_depth: bool = False, wireframe: bool = False):
    """Jitted frame renderer bound to the (static) render scene.

    The scene arrays enter the executable as traced arguments rather than
    captured constants, so the executable does not embed them."""
    fn = functools.partial(
        render_frame,
        width=width, height=height,
        bin_capacity=bin_capacity, depth_only=depth_only,
        return_depth=return_depth, wireframe=wireframe,
    )
    jfn = jax.jit(fn)
    rs = jax.device_put(render_scene)

    def call(world_mats, view, proj, camera_pos, light=None):
        return jfn(rs, world_mats, view, proj, camera_pos, light)

    return call


def make_interp_render_fn(render_scene, width: int, height: int,
                          bin_capacity: int = 512,
                          return_depth: bool = False,
                          wireframe: bool = False):
    """Jitted renderer of Bullet-style interpolated motion states.

    Takes the last TWO fixed-step states plus the accumulator remainder
    ``alpha`` and renders the blended world (``engine.interpolated_world``)
    in the SAME dispatch — the blend is a few hundred FLOPs, far below
    one dispatch's overhead as its own program.  Matches the reference
    rendering Bullet's interpolated transforms
    (``PhysicsSystem.cpp:848-875``).
    """
    from banggameengine_tpu.engine import interpolated_world

    def f(rs, prev_state, state, alpha, static, view, proj, cam_pos, light):
        world = interpolated_world(prev_state, state, alpha, static)
        return render_frame(rs, world, view, proj, cam_pos, light,
                            width=width, height=height,
                            bin_capacity=bin_capacity,
                            return_depth=return_depth, wireframe=wireframe)

    jfn = jax.jit(f)
    rs = jax.device_put(render_scene)

    def call(prev_state, state, alpha, static, view, proj, cam_pos,
             light=None):
        return jfn(rs, prev_state, state, jnp.float32(alpha), static,
                   view, proj, cam_pos, light)

    return call


def make_frame_fn(built, width: int, height: int,
                  solver_iterations: int = 10, bin_capacity: int = 2048,
                  pipelined: bool = False, substeps: int = 1,
                  merged: bool = False, merged_barrier: bool = False,
                  donate: bool = True,
                  **physics_kwargs):
    """The interactive tick: engine step(s) + shaded frame, one host call.

    By default, two queued device dispatches (step with donated WorldState,
    and the renderer) with NO host synchronization in between;
    ``merged=True`` builds the single-executable variant for A/B
    measurement.

    ``substeps`` runs that many fixed steps per frame (the reference's
    fixed-step accumulator draining up to 4 substeps per display frame,
    ``Application.cpp:97-101`` / ``stepSimulation(dt, 4, fixedStep)``);
    events then gain a leading [substeps] axis.

    ``pipelined=True`` renders the CURRENT state's world while the step
    computes the next one (one tick of visual latency, the classic
    hardware-engine frame pipeline); the default ``False`` renders the
    post-step world.

    Returns ``call(state, inp, view, proj, cam_pos, light=None)
    -> (new_state, u8[H,W,4], StepEvents)``.  Unlike round 2, the trigger
    events are returned (not discarded): the fused interactive tick has
    full gameplay-event parity with the reference's per-step
    ``ProcessTriggerEvents`` (``PhysicsSystem.cpp:1017-1074``) — feed them
    to :func:`banggameengine_tpu.app.events.dispatch_step_events`.
    """
    from banggameengine_tpu.engine import engine_step
    from banggameengine_tpu.physics.step import scene_census

    kwargs = {**scene_census(built.static), **physics_kwargs}

    def step(state, inp, st):
        if substeps == 1:
            return engine_step(state, inp, st, solver_iterations, **kwargs)

        def body(carry, _):
            s, ev = engine_step(carry, inp, st, solver_iterations, **kwargs)
            return s, ev

        return jax.lax.scan(body, state, None, length=substeps)

    def render(rs, world, view, proj, cam_pos, light):
        return render_frame(rs, world, view, proj, cam_pos, light,
                            width=width, height=height,
                            bin_capacity=bin_capacity)

    # the static scene enters the executables as a traced argument, so a
    # config hot reload (same shapes) swaps it without recompiling:
    # call.update_static(new_static)
    bound = {"st": jax.device_put(built.static)}
    rs = jax.device_put(built.render)

    if merged or merged_barrier:
        def tick(state, inp, st_, rs_, view, proj, cam_pos, light):
            s2, ev = step(state, inp, st_)
            world = s2.world
            if merged_barrier:
                # pin the phase boundary: stops XLA scheduling render ops
                # interleaved with (and spilling across) the step phase
                world = jax.lax.optimization_barrier(world)
            img = render(rs_, world, view, proj, cam_pos, light)
            return s2, img, ev

        jtick = jax.jit(tick, donate_argnums=(0,) if donate else ())

        def call(state, inp, view, proj, cam_pos, light=None):
            return jtick(state, inp, bound["st"], rs, view, proj, cam_pos,
                         light)
    else:
        # donate=False exists only for A/B experiments; donation stays
        # the default
        jstep = jax.jit(step, donate_argnums=(0,) if donate else ())
        jrender = jax.jit(render)

        if pipelined:
            def call(state, inp, view, proj, cam_pos, light=None):
                img = jrender(rs, state.world, view, proj, cam_pos, light)
                s2, ev = jstep(state, inp, bound["st"])
                return s2, img, ev
        else:
            def call(state, inp, view, proj, cam_pos, light=None):
                s2, ev = jstep(state, inp, bound["st"])
                img = jrender(rs, s2.world, view, proj, cam_pos, light)
                return s2, img, ev

    def update_static(new_static):
        bound["st"] = jax.device_put(new_static)

    call.update_static = update_static
    return call
