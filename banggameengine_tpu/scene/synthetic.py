"""Procedural scenes (no asset files needed).

- falling-boxes stress worlds (:func:`build_falling_boxes`);
- a demo-shaped world as arrays (:func:`build_demo_like`: ground box +
  capsule character + trigger);
- the same demo scene as an asset tree in the reference's layout
  (:func:`write_demo_assets`: ``scenes/demo.json``, ``config/physics.json``,
  OBJ/MTL meshes and one PNG texture), which loads through
  ``parse_scene_json``/``build_scene``/``ResourceManager`` and
  ``Application(assets_root=...)`` like the reference's own assets.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import jax.numpy as jnp

from banggameengine_tpu import math3d
from banggameengine_tpu.ecs.transform import compute_levels
from banggameengine_tpu.physics.config import PhysicsConfig
from banggameengine_tpu.state import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    BODY_STATIC,
    COMP_CHARACTER,
    COMP_COLLIDER,
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


def _box_inertia_inv(mass, half):
    e = 2.0 * np.asarray(half, np.float64)
    i = mass / 12.0 * np.array(
        [e[1] ** 2 + e[2] ** 2, e[0] ** 2 + e[2] ** 2, e[0] ** 2 + e[1] ** 2]
    )
    return (1.0 / np.maximum(i, 1e-12)).astype(np.float32)


def build_falling_boxes(
    num_bodies: int,
    seed: int = 0,
    spread: float | None = None,
    config: PhysicsConfig | None = None,
    with_character: bool = False,
    with_trigger: bool = False,
) -> tuple[WorldState, StaticScene]:
    """A world of ``num_bodies`` dynamic unit boxes raining onto the ground
    plane.  Deterministic for a given seed."""
    cfg = (config or PhysicsConfig()).sanitized()
    rng = np.random.default_rng(seed)
    extra = (1 if with_character else 0) + (1 if with_trigger else 0)
    n = max(8, int(np.ceil((num_bodies + extra) / 8.0)) * 8)

    alive = np.zeros(n, bool)
    comp = np.zeros(n, np.uint32)
    pos = np.zeros((n, 3), np.float32)
    euler = np.zeros((n, 3), np.float32)
    body_type = np.zeros(n, np.int8)
    shape_type = np.zeros(n, np.int8)
    size = np.zeros((n, 3), np.float32)
    inv_mass = np.zeros(n, np.float32)
    inv_inertia = np.zeros((n, 3), np.float32)
    friction = np.full(n, 0.5, np.float32)
    restitution = np.zeros(n, np.float32)
    layer = np.zeros(n, np.uint32)
    mask = np.zeros(n, np.uint32)

    if spread is None:
        # spacing so resting boxes roughly tile the ground one layer deep
        spread = max(4.0, 1.2 * np.sqrt(num_bodies))

    half = np.array([0.5, 0.5, 0.5], np.float32)
    for i in range(num_bodies):
        alive[i] = True
        comp[i] = COMP_TRANSFORM | COMP_COLLIDER | COMP_RIGID_BODY
        pos[i] = (
            rng.uniform(-spread, spread),
            rng.uniform(2.0, 2.0 + 0.5 * num_bodies),
            rng.uniform(-spread, spread),
        )
        euler[i] = rng.uniform(-np.pi, np.pi, 3)
        body_type[i] = BODY_DYNAMIC
        shape_type[i] = SHAPE_BOX
        size[i] = half
        inv_mass[i] = 1.0
        inv_inertia[i] = _box_inertia_inv(1.0, half)
        layer[i] = 1
        mask[i] = 0xFFFFFFFF

    cursor = num_bodies
    characters = []
    if with_character:
        ci = cursor
        cursor += 1
        alive[ci] = True
        comp[ci] = COMP_TRANSFORM | COMP_COLLIDER | COMP_CHARACTER
        pos[ci] = (0.0, 7.0, -5.0)
        shape_type[ci] = SHAPE_CAPSULE
        size[ci] = (cfg.capsule_radius, cfg.capsule_height * 0.5, 0.0)
        body_type[ci] = BODY_KINEMATIC
        layer[ci] = LAYER_CHARACTER
        mask[ci] = 0xFFFFFFFF
        characters.append(ci)

    triggers = []
    if with_trigger:
        ti = cursor
        cursor += 1
        alive[ti] = True
        comp[ti] = COMP_TRANSFORM | COMP_TRIGGER
        pos[ti] = (5.0, 1.0, 5.0)
        triggers.append(ti)

    t_slots = max(1, len(triggers))
    trig_entity = np.full(t_slots, -1, np.int32)
    trig_shape = np.full(t_slots, SHAPE_BOX, np.int8)
    trig_size = np.tile(np.asarray([1.5, 1.5, 1.5], np.float32), (t_slots, 1))
    trig_layer = np.full(t_slots, 4, np.uint32)
    trig_mask = np.full(t_slots, 0xFFFFFFFF, np.uint32)
    trig_one_shot = np.zeros(t_slots, bool)
    for s, ei in enumerate(triggers):
        trig_entity[s] = ei

    c_slots = max(1, len(characters))
    char_entity = np.full(c_slots, -1, np.int32)
    for s, ei in enumerate(characters):
        char_entity[s] = ei

    parent = np.full(n, -1, np.int32)
    static = StaticScene(
        parent=jnp.asarray(parent),
        level_nodes=jnp.asarray(compute_levels(parent, alive)),
        body_type=jnp.asarray(body_type),
        shape_type=jnp.asarray(shape_type),
        shape_size=jnp.asarray(size),
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
        char_radius=jnp.full(c_slots, cfg.capsule_radius, jnp.float32),
        char_half_height=jnp.full(c_slots, cfg.capsule_height * 0.5, jnp.float32),
        char_walk_speed=jnp.full(c_slots, cfg.walk_speed, jnp.float32),
        char_jump_impulse=jnp.full(c_slots, cfg.jump_impulse, jnp.float32),
        gravity=jnp.float32(cfg.gravity),
        fixed_dt=jnp.float32(cfg.fixed_step),
        step_height=jnp.float32(cfg.step_height),
        max_slope_cos=jnp.float32(np.cos(np.deg2rad(cfg.max_slope_deg))),
        ground_enabled=jnp.asarray(True),
    )

    state = make_world_state(n, t_slots)
    state = dataclasses.replace(
        state,
        alive=jnp.asarray(alive),
        comp_mask=jnp.asarray(comp),
        pos=jnp.asarray(pos),
        quat=math3d.quat_from_euler_xyz(jnp.asarray(euler)),
    )
    return state, static


def build_demo_like(config: PhysicsConfig | None = None):
    """The demo scene's physics as arrays: ground box, capsule character,
    checkpoint trigger (same poses as assets/scenes/demo.json and
    :func:`write_demo_assets`)."""
    state, static = build_falling_boxes(
        0, config=config, with_character=True, with_trigger=True
    )
    # add the static ground box (demo.json 'ground': half (50,1,50) at y=-0.01)
    gi = 2  # character at 0, trigger at 1, ground at 2
    state = dataclasses.replace(
        state,
        alive=state.alive.at[gi].set(True),
        comp_mask=state.comp_mask.at[gi].set(
            COMP_TRANSFORM | COMP_COLLIDER | COMP_RIGID_BODY
        ),
        pos=state.pos.at[gi].set(jnp.asarray([0.0, -0.01, 0.0])),
    )
    static = dataclasses.replace(
        static,
        body_type=static.body_type.at[gi].set(BODY_STATIC),
        shape_type=static.shape_type.at[gi].set(SHAPE_BOX),
        shape_size=static.shape_size.at[gi].set(jnp.asarray([50.0, 1.0, 50.0])),
        friction=static.friction.at[gi].set(1.0),
        layer=static.layer.at[gi].set(1),
        mask=static.mask.at[gi].set(0xFFFFFFFF),
    )
    return state, static


# The demo scene's poses (the reference's assets/scenes/demo.json): CJ
# spawns at (0, 7, -5); the static ground box has half extents (50, 1, 50)
# at y=-0.01 (top face at y=0.99); the checkpoint trigger is a 1.5
# half-extent box at (5, 1, 5) on the trigger layer.
CJ_SPAWN = (0.0, 7.0, -5.0)
GROUND_POS = (0.0, -0.01, 0.0)
GROUND_HALF = (50.0, 1.0, 50.0)
CHECKPOINT_POS = (5.0, 1.0, 5.0)
CHECKPOINT_HALF = (1.5, 1.5, 1.5)
# the reference's CJ mesh has 2,332 triangles; the generated one has more,
# so the dense-tile (heavy) raster pass runs as it does on the real model
CJ_MIN_TRIANGLES = 2332

# CJ body parts: (group, centre, radii, segments, rings).  The mesh origin is
# the character's feet (the render transform sits at the capsule's bottom,
# engine.visual_positions); the capsule is 2.6 + 2 * 0.65 = 3.9 tall.
_CJ_PARTS = (
    ("head", (0.0, 3.42, 0.0), (0.42, 0.48, 0.42), 32, 16),
    ("legs", (-0.28, 0.95, 0.0), (0.24, 0.8, 0.24), 16, 10),
    ("legs", (0.28, 0.95, 0.0), (0.24, 0.8, 0.24), 16, 10),
    ("shoes", (-0.28, 0.14, 0.1), (0.24, 0.14, 0.38), 12, 6),
    ("shoes", (0.28, 0.14, 0.1), (0.24, 0.14, 0.38), 12, 6),
    ("torso", (0.0, 2.3, 0.0), (0.62, 0.72, 0.38), 32, 16),
)
_CJ_COLORS = {
    "head": (0.87, 0.68, 0.52), "legs": (0.15, 0.22, 0.45),
    "shoes": (0.1, 0.1, 0.1), "torso": (0.85, 0.85, 0.82),
}


def _ellipsoid(center, radii, segments, rings):
    """-> (positions f64[V,3], normals f64[V,3], uvs f64[V,2], faces
    i64[F,3]) of a UV ellipsoid, pole rows closed by triangle fans."""
    c, r = np.asarray(center, np.float64), np.asarray(radii, np.float64)
    theta = np.linspace(0.0, np.pi, rings + 1)          # pole to pole
    phi = np.linspace(0.0, 2.0 * np.pi, segments + 1)
    th, ph = np.meshgrid(theta, phi, indexing="ij")     # [R+1, S+1]
    unit = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                     np.sin(th) * np.sin(ph)], axis=-1)
    pos = (c + unit * r).reshape(-1, 3)
    nrm = unit / r
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).reshape(-1, 3)
    uv = np.stack([ph / (2 * np.pi), th / np.pi], axis=-1).reshape(-1, 2)
    faces = []
    w = segments + 1
    for i in range(rings):
        for j in range(segments):
            a, b = i * w + j, i * w + j + 1
            c0, d = (i + 1) * w + j, (i + 1) * w + j + 1
            if i > 0:
                faces.append((a, c0, b))
            if i < rings - 1:
                faces.append((b, c0, d))
    return pos, nrm, uv, np.asarray(faces, np.int64)


def _cj_obj() -> tuple[str, int]:
    """-> (OBJ text, triangle count) of the procedural character mesh."""
    lines = ["# procedural CJ stand-in", "mtllib demo.mtl"]
    base = 0
    n_tri = 0
    for group, center, radii, seg, rings in _CJ_PARTS:
        pos, nrm, uv, faces = _ellipsoid(center, radii, seg, rings)
        lines.append(f"g {group}")
        lines.append(f"usemtl {group}")
        lines += [f"v {x:.5f} {y:.5f} {z:.5f}" for x, y, z in pos]
        lines += [f"vt {u:.5f} {v:.5f}" for u, v in uv]
        lines += [f"vn {x:.5f} {y:.5f} {z:.5f}" for x, y, z in nrm]
        for f in faces + base + 1:
            lines.append("f " + " ".join(f"{k}/{k}/{k}" for k in f))
        base += len(pos)
        n_tri += len(faces)
    return "\n".join(lines) + "\n", n_tri


def _ground_texture(seed: int, size: int = 64) -> np.ndarray:
    """Grass-and-paving checker with per-texel noise: u8[size, size, 4]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size]
    tile = ((x // 8 + y // 8) % 2).astype(np.float64)[..., None]
    light = np.asarray([0.42, 0.62, 0.30])
    dark = np.asarray([0.55, 0.55, 0.50])
    rgb = tile * light + (1.0 - tile) * dark
    rgb = rgb * rng.uniform(0.85, 1.15, (size, size, 1))
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def _write_atomic(path: str, data: bytes) -> None:
    # concurrent writers (test workers) produce identical bytes; the rename
    # keeps every reader from seeing a half-written file
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def write_demo_assets(root: str, seed: int = 0) -> str:
    """Write the demo scene as an asset tree under ``root`` and return it.

    Same entities and poses as :func:`build_demo_like` (ids 0 ``cj``, 1
    ``checkpoint``, 2 ``ground``), with a textured ground-plane mesh and a
    procedural character mesh of at least ``CJ_MIN_TRIANGLES`` triangles.
    ``seed`` draws the ground texture's noise."""
    from banggameengine_tpu.scene.textures import encode_png

    for sub in ("scenes", "config", "models", "textures"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    cj_text, _ = _cj_obj()
    _write_atomic(os.path.join(root, "models", "demo.obj"), cj_text.encode())
    mtl = []
    for name, kd in _CJ_COLORS.items():
        mtl += [f"newmtl {name}", "Kd {:.3f} {:.3f} {:.3f}".format(*kd), ""]
    _write_atomic(os.path.join(root, "models", "demo.mtl"),
                  "\n".join(mtl).encode())
    # ground plane on the box's top face (local y = +1: world 0.99)
    hx, hy, hz = GROUND_HALF
    plane = "\n".join([
        "# ground plane", f"v {-hx} {hy} {-hz}", f"v {hx} {hy} {-hz}",
        f"v {hx} {hy} {hz}", f"v {-hx} {hy} {hz}",
        "vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1", "vn 0 1 0",
        "f 1/1/1 4/4/1 3/3/1 2/2/1", ""])
    _write_atomic(os.path.join(root, "models", "plane.obj"), plane.encode())
    _write_atomic(os.path.join(root, "textures", "ground.png"),
                  encode_png(_ground_texture(seed), filter_type=4))

    scene = {
        "resources": {
            "textures": {"ground": "textures/ground.png"},
            "materials": {
                "ground": {"albedoTex": "ground", "uv": [25, 25]},
            },
            "meshes": {
                "cj": {"obj": "models/demo.obj", "mtl": "models/demo.mtl"},
                "plane": "models/plane.obj",
            },
        },
        "entities": [
            {"id": "cj", "name": "CJ",
             "transform": {"position": list(CJ_SPAWN)},
             "meshRenderer": {"mesh": "cj"}},
            {"id": "checkpoint", "name": "Checkpoint",
             "transform": {"position": list(CHECKPOINT_POS)},
             "trigger": {"shape": "box", "size": list(CHECKPOINT_HALF),
                         "layer": 4}},
            {"id": "ground", "name": "Ground",
             "transform": {"position": list(GROUND_POS)},
             "meshRenderer": {"mesh": "plane", "material": "ground"},
             "collider": {"shape": "box", "size": list(GROUND_HALF)},
             "rigidBody": {"type": "Static", "friction": 1.0}},
        ],
    }
    _write_atomic(os.path.join(root, "scenes", "demo.json"),
                  json.dumps(scene, indent=1).encode())
    cfg = PhysicsConfig()
    physics = {
        "gravity": cfg.gravity, "fixedStep": cfg.fixed_step,
        "stepHeight": cfg.step_height, "maxSlopeDeg": cfg.max_slope_deg,
        "capsule": {"height": cfg.capsule_height,
                    "radius": cfg.capsule_radius},
        "walkSpeed": cfg.walk_speed, "jumpImpulse": cfg.jump_impulse,
    }
    _write_atomic(os.path.join(root, "config", "physics.json"),
                  json.dumps(physics, indent=1).encode())
    return root


def demo_assets_dir(seed: int = 0) -> str:
    """The generated demo asset tree under the checkout's ``build/``
    directory (written on every call; the files are deterministic)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return write_demo_assets(
        os.path.join(repo, "build", f"demo_assets_seed{seed}"), seed)


def load_demo_built(seed: int = 0, root: str | None = None):
    """Build the demo scene under the asset root ``root`` (default: the one
    generated from ``seed``): -> scene.build.BuiltScene."""
    from banggameengine_tpu.physics.config import load_physics_config
    from banggameengine_tpu.scene import (
        ResourceManager, build_scene, parse_scene_json,
    )

    root = root or demo_assets_dir(seed)
    return build_scene(
        parse_scene_json(os.path.join(root, "scenes", "demo.json")),
        ResourceManager(assets_root=root),
        load_physics_config(os.path.join(root, "config", "physics.json")),
    )
