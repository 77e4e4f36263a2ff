"""Scene build: SceneDesc + assets -> device SoA (StaticScene/WorldState/RenderScene).

This is the array image of the reference's scene instantiation path
(``SceneLoader.cpp:652-745`` building a fresh ``Scene`` +
``PhysicsSystem::Ensure*`` mirroring entities into Bullet,
``PhysicsSystem.cpp:1222-1319``): all per-entity maps become fixed-capacity
padded arrays built once on the host, so the jitted step never sees dynamic
topology.

Inertia tensors follow Bullet's formulas (``btBoxShape::calculateLocalInertia``:
I = m/12 * (e_j^2 + e_k^2) with full extents; capsule approximated as Bullet
does via its enclosing box) so trajectories stay comparable.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import jax
import jax.numpy as jnp

from banggameengine_tpu import math3d
from banggameengine_tpu.ecs.transform import compute_levels, update_world_matrices
from banggameengine_tpu.physics.config import PhysicsConfig
from banggameengine_tpu.scene.obj_loader import MeshData
from banggameengine_tpu.scene.resources import ResourceManager
from banggameengine_tpu.scene.schema import MaterialDesc, SceneDesc
from banggameengine_tpu.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    BODY_STATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
    COMP_MESH_RENDERER,
    COMP_RIGID_BODY,
    COMP_TRANSFORM,
    COMP_TRIGGER,
    LAYER_CHARACTER,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    StaticScene,
    WorldState,
    make_world_state,
)

log = logging.getLogger("SceneBuild")

_BODY_TYPE_MAP = {"static": BODY_STATIC, "dynamic": BODY_DYNAMIC, "kinematic": BODY_KINEMATIC}
_SHAPE_MAP = {"box": SHAPE_BOX, "capsule": SHAPE_CAPSULE}


def _pytree_dataclass(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
@dataclasses.dataclass
class RenderScene:
    """Device-side draw soup: per-instance expanded triangle soup plus
    material/texture tables.  Material resolution (override -> entity material
    -> mesh MTL material -> default, ``Renderer.cpp:668-697``) is baked here
    at build time into ``tri_material``."""

    v_pos: jax.Array       # f32[V,3] object-space positions
    v_nrm: jax.Array       # f32[V,3]
    v_uv: jax.Array        # f32[V,2]
    v_entity: jax.Array    # i32[V] owning entity (world matrix source)
    tri_material: jax.Array  # i32[V/3]
    tri_valid: jax.Array   # bool[V/3] (padding mask)
    # material table
    mat_base_tint: jax.Array   # f32[M,4]
    mat_uv_scale: jax.Array    # f32[M,2]
    mat_spec_params: jax.Array  # f32[M,2] (shininess, intensity)
    mat_spec_color: jax.Array  # f32[M,3]
    mat_tex: jax.Array         # i32[M] texture id
    # texture array (padded to common square size)
    textures: jax.Array        # u8[T,S,S,4]
    tex_size: jax.Array        # i32[T,2] (w,h) actual
    # bilinear neighborhood pack: [T,S,S,16] = RGBA of texels
    # (y,x),(y,x+1),(y+1,x),(y+1,x+1) with per-texture wrap — ONE gather
    # fetches all 4 bilinear taps
    textures_quad: jax.Array   # u8[T,S,S,16]
    # the same texel-quad data pre-transposed to channel-major [16, T*S*S]:
    # the deferred shader gathers per-pixel taps with take(..., axis=1) so
    # the result lands channel-planar ([16, P] rows) without a 2M-row
    # transpose or [P, 16] intermediates
    textures_quad_t: jax.Array  # u8[16, T*S*S]

    # per-entity object-space AABB over its vertices (for culling)
    ent_aabb_min: jax.Array  # f32[N,3]
    ent_aabb_max: jax.Array  # f32[N,3]
    ent_has_mesh: jax.Array  # bool[N]

    # deduplicated mesh edges for the F1 wireframe line pass (the
    # reference renders true line primitives, Renderer.cpp:766-783 +
    # BGFX_STATE_PT_LINES; shared triangle edges emitted once)
    edge_pos: jax.Array     # f32[E,2,3] object-space endpoints
    edge_entity: jax.Array  # i32[E]
    edge_valid: jax.Array   # bool[E]

    @property
    def num_triangles(self) -> int:
        return self.tri_material.shape[0]


@dataclasses.dataclass
class BuiltScene:
    """Everything produced by one scene load (host container, not a pytree)."""

    static: StaticScene
    initial_state: WorldState
    render: RenderScene
    logical_ids: dict[str, int]
    entity_names: list[str]
    config: PhysicsConfig
    counts: dict[str, int]

    def find_entity(self, logical_id: str) -> int:
        """-1 if absent (Scene::FindEntityByLogicalId, Scene.cpp:508-521)."""
        return self.logical_ids.get(logical_id, -1)

    # --- runtime entity CRUD (Scene.cpp:21-83, :354-393) ---------------
    def spawn(self, state, **kwargs):
        """Create an entity at runtime; see :func:`ecs.lifecycle.spawn`.
        Returns (new_state, entity_id); updates self.static in place."""
        from banggameengine_tpu.ecs.lifecycle import spawn as _spawn

        return _spawn(self, state, **kwargs)

    def despawn(self, state, entity: int):
        """Destroy an entity at runtime; returns the new WorldState."""
        from banggameengine_tpu.ecs.lifecycle import despawn as _despawn

        return _despawn(self, state, entity)

    def reparent(self, state, entity: int, new_parent) -> None:
        """Re-attach an entity under a new parent (local transform kept)."""
        from banggameengine_tpu.ecs.lifecycle import reparent as _reparent

        _reparent(self, state, entity, new_parent)


def _box_inertia_inv(mass: float, half: np.ndarray) -> np.ndarray:
    e = 2.0 * half
    i = mass / 12.0 * np.array(
        [e[1] ** 2 + e[2] ** 2, e[0] ** 2 + e[2] ** 2, e[0] ** 2 + e[1] ** 2],
        np.float64,
    )
    return np.where(i > 0, 1.0 / np.maximum(i, 1e-12), 0.0).astype(np.float32)


def _capsule_inertia_inv(mass: float, radius: float, half_height: float) -> np.ndarray:
    # Bullet approximates capsule inertia by its bounding box; keep that
    # behavior for trajectory comparability.
    half = np.array([radius, half_height + radius, radius], np.float64)
    return _box_inertia_inv(mass, half)


def build_scene(
    desc: SceneDesc,
    resources: ResourceManager,
    config: PhysicsConfig | None = None,
    capacity: int | None = None,
    auto_character_id: str = "cj",
    max_trigger_slots: int | None = None,
    level_headroom: int = 2,
) -> BuiltScene:
    """Instantiate a parsed scene into device arrays.

    ``auto_character_id``: the reference auto-attaches a PhysicsCharacter to
    the entity with logical id "cj" on scene load
    (``PhysicsSystem.cpp:198-211``); pass None to disable.
    """
    cfg = (config or PhysicsConfig()).sanitized()
    ents = desc.entities
    n_real = len(ents)
    n = capacity or max(8, int(np.ceil(n_real / 8.0)) * 8)
    if n < n_real:
        raise ValueError(f"capacity {n} < {n_real} entities")

    logical_ids: dict[str, int] = {}
    names: list[str] = []
    for i, e in enumerate(ents):
        logical_ids[e.logical_id] = i
        names.append(e.name)

    # --- transforms / hierarchy ---
    alive = np.zeros(n, bool)
    comp_mask = np.zeros(n, np.uint32)
    pos = np.zeros((n, 3), np.float32)
    euler = np.zeros((n, 3), np.float32)
    scale = np.ones((n, 3), np.float32)
    parent = np.full(n, -1, np.int32)

    # --- physics ---
    body_type = np.zeros(n, np.int8)
    shape_type = np.zeros(n, np.int8)
    shape_size = np.zeros((n, 3), np.float32)
    inv_mass = np.zeros(n, np.float32)
    inv_inertia = np.zeros((n, 3), np.float32)
    friction = np.full(n, 0.5, np.float32)
    restitution = np.zeros(n, np.float32)
    layer = np.zeros(n, np.uint32)
    mask = np.zeros(n, np.uint32)

    triggers: list[int] = []
    characters: list[int] = []

    for i, e in enumerate(ents):
        alive[i] = True
        comp_mask[i] |= COMP_TRANSFORM
        pos[i] = e.transform.position
        euler[i] = e.transform.rotation_euler
        scale[i] = e.transform.scale
        if e.parent is not None:
            parent[i] = logical_ids.get(e.parent, -1)
            if parent[i] < 0:
                log.warning("entity '%s' parent '%s' not found", e.logical_id, e.parent)

        if e.collider is not None:
            comp_mask[i] |= COMP_COLLIDER
            st = _SHAPE_MAP.get(e.collider.shape, SHAPE_BOX)
            shape_type[i] = st
            # clamp tiny sizes like CreateShape (PhysicsSystem.cpp:692-701)
            sz = np.asarray(e.collider.size, np.float32).copy()
            if st == SHAPE_BOX:
                sz = np.maximum(sz, 0.01)
            else:
                sz[0] = max(sz[0], 0.01)
                sz[1] = max(sz[1], 0.0)
                sz[2] = 0.0
            shape_size[i] = sz

        if e.rigid_body is not None:
            comp_mask[i] |= COMP_RIGID_BODY
            bt = _BODY_TYPE_MAP.get(e.rigid_body.type, BODY_STATIC)
            body_type[i] = bt
            friction[i] = e.rigid_body.friction
            restitution[i] = e.rigid_body.restitution
            layer[i] = e.rigid_body.layer or 1
            mask[i] = e.rigid_body.mask
            if bt == BODY_DYNAMIC:
                m = max(e.rigid_body.mass, 0.01)  # PhysicsSystem.cpp:428
                inv_mass[i] = 1.0 / m
                if shape_type[i] == SHAPE_BOX:
                    inv_inertia[i] = _box_inertia_inv(m, shape_size[i])
                elif shape_type[i] == SHAPE_CAPSULE:
                    inv_inertia[i] = _capsule_inertia_inv(
                        m, shape_size[i][0], shape_size[i][1]
                    )
        elif e.collider is not None:
            # collider without body: static collision-only (Bullet would need a
            # body; the reference warns, we treat as static)
            body_type[i] = BODY_STATIC
            layer[i] = 1
            mask[i] = 0xFFFFFFFF

        if e.trigger is not None:
            comp_mask[i] |= COMP_TRIGGER
            triggers.append(i)

        if e.mesh_renderer is not None:
            comp_mask[i] |= COMP_MESH_RENDERER

        if e.character:
            characters.append(i)

    # auto character (PhysicsSystem.cpp:198-211)
    if auto_character_id and auto_character_id in logical_ids:
        ci = logical_ids[auto_character_id]
        if ci not in characters:
            characters.append(ci)
    for ci in characters:
        comp_mask[ci] |= COMP_CHARACTER

    # --- trigger slots ---
    t_slots = max_trigger_slots or max(1, len(triggers))
    trig_entity = np.full(t_slots, -1, np.int32)
    trig_shape = np.zeros(t_slots, np.int8)
    trig_size = np.zeros((t_slots, 3), np.float32)
    trig_layer = np.zeros(t_slots, np.uint32)
    trig_mask = np.zeros(t_slots, np.uint32)
    trig_one_shot = np.zeros(t_slots, bool)
    trig_active0 = np.ones(t_slots, bool)
    for s, ei in enumerate(triggers[:t_slots]):
        tr = ents[ei].trigger
        trig_entity[s] = ei
        trig_shape[s] = _SHAPE_MAP.get(tr.shape, SHAPE_BOX)
        trig_size[s] = tr.size
        trig_layer[s] = tr.layer
        trig_mask[s] = tr.mask
        trig_one_shot[s] = tr.one_shot
        trig_active0[s] = tr.active

    # --- character slots ---
    c_slots = max(1, len(characters))
    char_entity = np.full(c_slots, -1, np.int32)
    for s, ei in enumerate(characters):
        char_entity[s] = ei
    char_radius = np.full(c_slots, cfg.capsule_radius, np.float32)
    char_half_height = np.full(c_slots, cfg.capsule_height * 0.5, np.float32)
    char_walk = np.full(c_slots, cfg.walk_speed, np.float32)
    char_jump = np.full(c_slots, cfg.jump_impulse, np.float32)

    # characters collide on the character layer (PhysicsSystem.cpp:36-38,
    # addCollisionObject(ghost, kDefaultCharacterLayer, 0xffffffff))
    for ei in characters:
        layer[ei] = LAYER_CHARACTER
        mask[ei] = 0xFFFFFFFF
        shape_type[ei] = SHAPE_CAPSULE
        shape_size[ei] = (cfg.capsule_radius, cfg.capsule_height * 0.5, 0.0)
        body_type[ei] = BODY_KINEMATIC

    # Pad the level schedule for runtime lifecycle (ecs/lifecycle.py): width
    # to full capacity (spawns can add roots) and depth by `level_headroom`
    # (reparenting can deepen chains) — CRUD inside this rectangle never
    # changes array shapes, so the traced-static step never recompiles.
    tight = compute_levels(parent, alive)
    level_nodes = np.full(
        (tight.shape[0] + max(level_headroom, 0), n), -1, np.int32
    )
    level_nodes[: tight.shape[0], : tight.shape[1]] = tight

    static = StaticScene(
        parent=jnp.asarray(parent),
        level_nodes=jnp.asarray(level_nodes),
        body_type=jnp.asarray(body_type),
        shape_type=jnp.asarray(shape_type),
        shape_size=jnp.asarray(shape_size),
        inv_mass=jnp.asarray(inv_mass),
        inv_inertia_body=jnp.asarray(inv_inertia),
        friction=jnp.asarray(friction),
        restitution=jnp.asarray(restitution),
        layer=jnp.asarray(layer),
        mask=jnp.asarray(mask),
        trig_entity=jnp.asarray(trig_entity),
        trig_shape=jnp.asarray(trig_shape),
        trig_size=jnp.asarray(trig_size),
        trig_layer=jnp.asarray(trig_layer),
        trig_mask=jnp.asarray(trig_mask),
        trig_one_shot=jnp.asarray(trig_one_shot),
        char_entity=jnp.asarray(char_entity),
        char_radius=jnp.asarray(char_radius),
        char_half_height=jnp.asarray(char_half_height),
        char_walk_speed=jnp.asarray(char_walk),
        char_jump_impulse=jnp.asarray(char_jump),
        gravity=jnp.float32(cfg.gravity),
        fixed_dt=jnp.float32(cfg.fixed_step),
        step_height=jnp.float32(cfg.step_height),
        max_slope_cos=jnp.float32(np.cos(np.deg2rad(cfg.max_slope_deg))),
        ground_enabled=jnp.asarray(True),
    )

    state = make_world_state(n, t_slots)
    quat = math3d.quat_from_euler_xyz(jnp.asarray(euler))
    state = dataclasses.replace(
        state,
        alive=jnp.asarray(alive),
        comp_mask=jnp.asarray(comp_mask),
        pos=jnp.asarray(pos),
        quat=quat,
        scale=jnp.asarray(scale),
        trigger_active=jnp.asarray(trig_active0),
    )
    world = update_world_matrices(
        state.pos, state.quat, state.scale, static.parent,
        static.level_nodes, state.alive,
    )
    state = dataclasses.replace(state, world=world)

    render = _build_render_scene(desc, resources, logical_ids, n)

    counts = {
        "entities": n_real,
        "transforms": n_real,
        "mesh_renderers": int(sum(1 for e in ents if e.mesh_renderer)),
        "colliders": int(sum(1 for e in ents if e.collider)),
        "rigid_bodies": int(sum(1 for e in ents if e.rigid_body)),
        "triggers": len(triggers),
        "characters": len(characters),
    }
    log.info(
        "[SceneLoader] scene built: %d entities, %d mesh renderers, "
        "%d colliders, %d triggers, %d characters",
        counts["entities"], counts["mesh_renderers"], counts["colliders"],
        counts["triggers"], counts["characters"],
    )
    return BuiltScene(
        static=static,
        initial_state=state,
        render=render,
        logical_ids=logical_ids,
        entity_names=names,
        config=cfg,
        counts=counts,
    )


def _build_render_scene(
    desc: SceneDesc,
    resources: ResourceManager,
    logical_ids: dict[str, int],
    capacity: int,
) -> RenderScene:
    """Expand every (entity, submesh) into a per-instance triangle soup with
    baked material ids, mirroring the renderer's per-submesh material
    resolution (override -> entity material -> mesh MTL -> default,
    ``Renderer.cpp:668-697``)."""
    # material table: named scene materials + per-MTL materials + default
    mat_list: list[MaterialDesc] = []
    mat_index: dict[str, int] = {}
    tex_list: list[np.ndarray] = []
    tex_index: dict[str, int] = {}

    def add_texture(name_or_none: str | None) -> int:
        if name_or_none is None:
            key = "__white"
            arr = resources.get_white_texture()
        else:
            key = name_or_none
            path = desc.textures.get(name_or_none)
            if path is None:
                # treat as a direct path (MTL map_Kd absolute path)
                arr = (
                    resources.load_texture(name_or_none)
                    if name_or_none
                    else resources.get_checker_texture()
                )
            else:
                arr = resources.load_texture(path)
        if key in tex_index:
            return tex_index[key]
        tex_index[key] = len(tex_list)
        tex_list.append(arr)
        return tex_index[key]

    def add_material(m: MaterialDesc, tex_key: str | None) -> int:
        key = m.name
        if key in mat_index:
            return mat_index[key]
        mat_index[key] = len(mat_list)
        mat_list.append(m)
        add_texture(tex_key)
        return mat_index[key]

    # default material first (id 0): checker-free white
    default_mat = resources.get_default_material()
    add_material(default_mat, None)
    for name, m in desc.materials.items():
        resources.load_material(m)
        add_material(m, m.albedo_tex)

    # load meshes
    meshes: dict[str, MeshData] = {}
    for name, md in desc.meshes.items():
        mesh = resources.load_mesh(md.obj, md.mtl)
        if mesh is not None:
            meshes[name] = mesh

    # per-MTL materials become entries too (mesh-material fallback)
    mtl_mat_ids: dict[tuple[str, int], int] = {}
    for mesh_name, mesh in meshes.items():
        for mi, mm in enumerate(mesh.materials):
            mat = MaterialDesc(name=f"__mtl_{mesh_name}_{mi}_{mm.name}")
            mat.base_tint = np.asarray([*mm.kd, 1.0], np.float32)
            tex_key = None
            if mm.map_kd:
                tex_key = mm.map_kd  # absolute path; add_texture handles it
            mtl_mat_ids[(mesh_name, mi)] = add_material(mat, tex_key)

    # expand entity instances
    vp, vn, vuv, vent, trimat = [], [], [], [], []
    ent_aabb_min = np.full((capacity, 3), np.inf, np.float32)
    ent_aabb_max = np.full((capacity, 3), -np.inf, np.float32)
    ent_has_mesh = np.zeros(capacity, bool)

    for e in desc.entities:
        mr = e.mesh_renderer
        if mr is None:
            continue
        mesh = meshes.get(mr.mesh)
        if mesh is None:
            log.warning("entity '%s' references missing mesh '%s'", e.logical_id, mr.mesh)
            continue
        ei = logical_ids[e.logical_id]
        ent_has_mesh[ei] = True
        ent_aabb_min[ei] = mesh.positions.min(axis=0)
        ent_aabb_max[ei] = mesh.positions.max(axis=0)
        ent_mat_id = mat_index.get(mr.material) if mr.material else None
        for si, sm in enumerate(mesh.submeshes):
            # material resolution order (Renderer.cpp:668-697)
            if si in mr.material_overrides and mr.material_overrides[si] in mat_index:
                mid = mat_index[mr.material_overrides[si]]
            elif ent_mat_id is not None:
                mid = ent_mat_id
            elif (mr.mesh, sm.material_index) in mtl_mat_ids:
                mid = mtl_mat_ids[(mr.mesh, sm.material_index)]
            else:
                mid = 0
            sl = slice(sm.start_index, sm.start_index + sm.index_count)
            vp.append(mesh.positions[sl])
            vn.append(mesh.normals[sl])
            vuv.append(mesh.uvs[sl])
            vent.append(np.full(sm.index_count, ei, np.int32))
            trimat.append(np.full(sm.index_count // 3, mid, np.int32))

    if vp:
        v_pos = np.concatenate(vp)
        v_nrm = np.concatenate(vn)
        v_uv = np.concatenate(vuv)
        v_entity = np.concatenate(vent)
        tri_material = np.concatenate(trimat)
    else:
        v_pos = np.zeros((3, 3), np.float32)
        v_nrm = np.tile(np.array([[0, 1, 0]], np.float32), (3, 1))
        v_uv = np.zeros((3, 2), np.float32)
        v_entity = np.zeros(3, np.int32)
        tri_material = np.zeros(1, np.int32)

    # deduplicated mesh edges (per entity instance; corners are unshared in
    # the vertex soup, so dedupe by quantized endpoint positions)
    n_tri_real = len(tri_material)
    edge_map: dict = {}
    for t in range(n_tri_real):
        ent = int(v_entity[3 * t])
        for i, j in ((0, 1), (1, 2), (2, 0)):
            a = v_pos[3 * t + i]
            b = v_pos[3 * t + j]
            ka = tuple(np.round(a, 4))
            kb = tuple(np.round(b, 4))
            key = (ent, min(ka, kb), max(ka, kb))
            if key not in edge_map:
                edge_map[key] = (a, b, ent)
    if edge_map:
        edge_pos = np.stack(
            [np.stack([a, b]) for a, b, _ in edge_map.values()]
        ).astype(np.float32)
        edge_entity = np.asarray(
            [e for _, _, e in edge_map.values()], np.int32)
    else:
        edge_pos = np.zeros((1, 2, 3), np.float32)
        edge_entity = np.zeros(1, np.int32)
    edge_valid = np.ones(len(edge_entity), bool) if edge_map else np.zeros(1, bool)

    # pad triangle count to a multiple of 128
    n_tri = len(tri_material)
    pad_tri = (-n_tri) % 128
    tri_valid = np.ones(n_tri, bool)
    if pad_tri:
        v_pos = np.concatenate([v_pos, np.zeros((pad_tri * 3, 3), np.float32)])
        v_nrm = np.concatenate([v_nrm, np.tile(np.array([[0, 1, 0]], np.float32), (pad_tri * 3, 1))])
        v_uv = np.concatenate([v_uv, np.zeros((pad_tri * 3, 2), np.float32)])
        v_entity = np.concatenate([v_entity, np.zeros(pad_tri * 3, np.int32)])
        tri_material = np.concatenate([tri_material, np.zeros(pad_tri, np.int32)])
        tri_valid = np.concatenate([tri_valid, np.zeros(pad_tri, bool)])

    # texture array: pad to common square pow2 size
    max_dim = max((max(t.shape[0], t.shape[1]) for t in tex_list), default=1)
    s = 1
    while s < max_dim:
        s *= 2
    tex_arr = np.zeros((len(tex_list), s, s, 4), np.uint8)
    tex_quad = np.zeros((len(tex_list), s, s, 16), np.uint8)
    tex_size = np.zeros((len(tex_list), 2), np.int32)
    for i, t in enumerate(tex_list):
        h, w = t.shape[0], t.shape[1]
        tex_arr[i, :h, :w] = t
        tex_size[i] = (w, h)
        xp = (np.arange(w) + 1) % w
        yp = (np.arange(h) + 1) % h
        tex_quad[i, :h, :w, 0:4] = t
        tex_quad[i, :h, :w, 4:8] = t[:, xp]
        tex_quad[i, :h, :w, 8:12] = t[yp][:, :]
        tex_quad[i, :h, :w, 12:16] = t[yp][:, xp]

    m_count = len(mat_list)
    mat_base_tint = np.stack([m.base_tint for m in mat_list]) if m_count else np.ones((1, 4), np.float32)
    mat_uv_scale = np.stack([m.uv_scale for m in mat_list]) if m_count else np.ones((1, 2), np.float32)
    mat_spec = np.stack(
        [np.asarray([m.shininess, m.spec_intensity], np.float32) for m in mat_list]
    )
    mat_spec_color = np.stack([m.spec_color for m in mat_list])
    mat_tex = np.zeros(m_count, np.int32)
    for name, idx in mat_index.items():
        m = mat_list[idx]
        if m.albedo_tex and m.albedo_tex in tex_index:
            mat_tex[idx] = tex_index[m.albedo_tex]
        elif m.name.startswith("__mtl_"):
            # MTL materials registered their texture under the map_kd path key
            pass
    # fix MTL texture ids (registered by path)
    for (mesh_name, mi), mid in mtl_mat_ids.items():
        mm = meshes[mesh_name].materials[mi]
        if mm.map_kd and mm.map_kd in tex_index:
            mat_tex[mid] = tex_index[mm.map_kd]
        else:
            mat_tex[mid] = tex_index["__white"]
    # named materials without texture -> white
    for name, m in desc.materials.items():
        if m.albedo_tex is None and name in mat_index:
            mat_tex[mat_index[name]] = tex_index["__white"]

    ent_aabb_min = np.where(ent_has_mesh[:, None], ent_aabb_min, 0.0).astype(np.float32)
    ent_aabb_max = np.where(ent_has_mesh[:, None], ent_aabb_max, 0.0).astype(np.float32)

    return RenderScene(
        v_pos=jnp.asarray(v_pos),
        v_nrm=jnp.asarray(v_nrm),
        v_uv=jnp.asarray(v_uv),
        v_entity=jnp.asarray(v_entity),
        tri_material=jnp.asarray(tri_material),
        tri_valid=jnp.asarray(tri_valid),
        mat_base_tint=jnp.asarray(mat_base_tint),
        mat_uv_scale=jnp.asarray(mat_uv_scale),
        mat_spec_params=jnp.asarray(mat_spec),
        mat_spec_color=jnp.asarray(mat_spec_color),
        mat_tex=jnp.asarray(mat_tex),
        textures=jnp.asarray(tex_arr),
        tex_size=jnp.asarray(tex_size),
        textures_quad=jnp.asarray(tex_quad),
        textures_quad_t=jnp.asarray(
            np.ascontiguousarray(tex_quad.reshape(-1, 16).T)),
        ent_aabb_min=jnp.asarray(ent_aabb_min),
        ent_aabb_max=jnp.asarray(ent_aabb_max),
        ent_has_mesh=jnp.asarray(ent_has_mesh),
        edge_pos=jnp.asarray(edge_pos),
        edge_entity=jnp.asarray(edge_entity),
        edge_valid=jnp.asarray(edge_valid),
    )
