"""Core state pytrees: WorldState, StaticScene, InputFrame, StepEvents.

Array-native replacement for the reference's pointer-graph ECS
(``src/ecs/Scene.h:24-108``: per-entity ``unordered_map`` component stores and
a ``bitset<32>`` mask).  Here the whole world is one fixed-capacity
structure-of-arrays pytree resident in HBM; ``jax.vmap`` over the leading axis
of :class:`WorldState` gives many independent worlds stepped in lockstep, and
the (non-vmapped) :class:`StaticScene` carries topology shared by all worlds.

Component bits mirror ``src/ecs/Scene.cpp:11-16``:
Transform=0, MeshRenderer=1, PhysicsCharacter=2, Collider=3, RigidBody=4,
Trigger=5.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

Array = jax.Array

# Component mask bits (== reference Scene.cpp:11-16)
COMP_TRANSFORM = 1 << 0
COMP_MESH_RENDERER = 1 << 1
COMP_CHARACTER = 1 << 2
COMP_COLLIDER = 1 << 3
COMP_RIGID_BODY = 1 << 4
COMP_TRIGGER = 1 << 5

# Body types (== reference PhysicsComponents.h:22-26 enum order)
BODY_NONE = 0
BODY_STATIC = 1
BODY_DYNAMIC = 2
BODY_KINEMATIC = 3

# Shape types (== reference PhysicsComponents.h:8-11: Box, Capsule)
SHAPE_NONE = 0
SHAPE_BOX = 1
SHAPE_CAPSULE = 2

# Collision layers (== reference PhysicsSystem.cpp:36-38)
LAYER_WORLD = 1 << 0
LAYER_CHARACTER = 1 << 1
LAYER_TRIGGER = 1 << 2


def _pytree_dataclass(cls):
    """Register a dataclass as a JAX pytree, all fields are children."""
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
@dataclasses.dataclass
class WorldState:
    """Per-world mutable simulation state. Leading batch axis => many worlds.

    Replaces: Transform components (``src/ecs/Transform.h:12-26``), the
    Bullet-side body/character/trigger runtime state
    (``src/physics/PhysicsSystem.h:97-175``), and trigger overlap sets
    (``PhysicsSystem.cpp:1017-1074``).
    """

    # --- entity/transform (capacity N) ---
    alive: Array          # bool[N]
    comp_mask: Array      # uint32[N] component bits
    pos: Array            # f32[N,3] local position
    quat: Array           # f32[N,4] local rotation [x,y,z,w]
    scale: Array          # f32[N,3] local scale
    world: Array          # f32[N,4,4] world matrices (refreshed each step)

    # --- rigid-body dynamics ---
    lin_vel: Array        # f32[N,3]
    ang_vel: Array        # f32[N,3]

    # --- character controller (slots over entities; mask = COMP_CHARACTER) ---
    char_vel_y: Array     # f32[N] vertical velocity of kinematic characters
    char_on_ground: Array  # bool[N]

    # --- triggers (T slots; StaticScene.trig_entity maps slot -> entity) ---
    trigger_overlap: Array  # bool[T, N] current overlap set per trigger slot
    trigger_active: Array   # bool[T] (oneShot deactivation,
    #                                  PhysicsSystem.cpp:1062-1072)

    # --- persistent contact cache (warm starting) ---
    # The array image of Bullet's persistent manifolds (the default collision
    # configuration keeps face-clipped manifolds + accumulated impulses
    # across steps, PhysicsSystem.cpp:124-128): per solved contact slot, a
    # feature id ((partner+1)*FEAT_STRIDE + narrowphase slot; ground slots
    # are bare slot ids; -1 = empty) and the accumulated (normal, t1, t2)
    # impulses.  Next step's solver warm-starts from feature-matched rows.
    contact_feat: Array   # i32[N, CB]
    contact_imp: Array    # f32[N, CB, 3] (lambda_n, lambda_t1, lambda_t2)

    # --- bookkeeping ---
    time: Array           # f32[] simulation time
    step_idx: Array       # int32[] step counter

    @property
    def capacity(self) -> int:
        return self.alive.shape[-1]


@_pytree_dataclass
@dataclasses.dataclass
class StaticScene:
    """Per-scene topology/parameters shared by every vmapped world.

    Host-built once per scene load (the SoA image of ``SceneLoader.cpp`` +
    ``PhysicsSystem::Ensure*``), then closed over (or passed untraced) by the
    jitted step.  All arrays are device constants; no Python objects.
    """

    # hierarchy: parent[N] (-1 = root), level-ordered schedule
    parent: Array         # int32[N]
    level_nodes: Array    # int32[L, M] entity ids per depth level, -1 padded

    # physics bodies
    body_type: Array      # int8[N] BODY_*
    shape_type: Array     # int8[N] SHAPE_*
    shape_size: Array     # f32[N,3] box half-extents | capsule (radius, half_height, 0)
    inv_mass: Array       # f32[N] (0 for static/kinematic)
    inv_inertia_body: Array  # f32[N,3] diag body-frame inverse inertia
    friction: Array       # f32[N]
    restitution: Array    # f32[N]
    layer: Array          # uint32[N]
    mask: Array           # uint32[N]

    # triggers (slots)
    trig_entity: Array    # int32[T] entity id per trigger slot (-1 empty)
    trig_shape: Array     # int8[T]
    trig_size: Array      # f32[T,3]
    trig_layer: Array     # uint32[T]
    trig_mask: Array      # uint32[T]
    trig_one_shot: Array  # bool[T]

    # characters (slots)
    char_entity: Array    # int32[C] entity id per character slot (-1 empty)
    char_radius: Array    # f32[C]
    char_half_height: Array  # f32[C] cylinder half-height (excl. caps)
    char_walk_speed: Array   # f32[C]
    char_jump_impulse: Array  # f32[C]

    # global physics config (assets/config/physics.json)
    gravity: Array        # f32[] (signed Y accel, e.g. -9.81)
    fixed_dt: Array       # f32[]
    step_height: Array    # f32[]
    max_slope_cos: Array  # f32[] cos(maxSlopeDeg)

    # implicit static ground plane at y=0 (PhysicsSystem.cpp:149-166)
    ground_enabled: Array  # bool[]

    @property
    def capacity(self) -> int:
        return self.parent.shape[-1]

    @property
    def num_trigger_slots(self) -> int:
        return self.trig_entity.shape[-1]

    @property
    def num_char_slots(self) -> int:
        return self.char_entity.shape[-1]


@_pytree_dataclass
@dataclasses.dataclass
class InputFrame:
    """One tick of player/camera input, the device-side image of the
    InputSystem axes/actions consumed by physics
    (``PhysicsSystem.cpp:790-846``: MoveForward/MoveRight axes, Jump, Sprint,
    camera yaw for camera-relative walk)."""

    move_forward: Array  # f32[] in [-1, 1]
    move_right: Array    # f32[] in [-1, 1]
    jump: Array          # bool[]
    sprint: Array        # bool[]
    cam_yaw: Array       # f32[] camera yaw (radians) for walk direction

    @staticmethod
    def zero() -> "InputFrame":
        return InputFrame(
            move_forward=jnp.float32(0.0),
            move_right=jnp.float32(0.0),
            jump=jnp.asarray(False),
            sprint=jnp.asarray(False),
            cam_yaw=jnp.float32(0.0),
        )


@_pytree_dataclass
@dataclasses.dataclass
class StepEvents:
    """Events produced by one step, returned as dense arrays instead of the
    reference's synchronous EventBus callbacks (``src/core/EventBus.h:20-33``,
    trigger diff at ``PhysicsSystem.cpp:1017-1074``).  Host code converts these
    to an event list / bus dispatch."""

    trigger_enter: Array  # bool[T, N]
    trigger_stay: Array   # bool[T, N]
    trigger_exit: Array   # bool[T, N]
    # total contact-slot candidates dropped by the per-body budget this
    # step (the hard-cap diagnostics the F9 stats surface; 0 = budgets
    # sufficient)
    contact_overflow: Array = dataclasses.field(
        default_factory=lambda: jnp.int32(0))


CONTACT_CACHE_SLOTS = 12   # == physics.step.CONTACT_BUDGET
FEAT_STRIDE = 64           # feature id stride per partner (> narrowphase K)


def make_world_state(capacity: int, num_trigger_slots: int,
                     contact_slots: int = CONTACT_CACHE_SLOTS) -> WorldState:
    """Fresh empty world with the given entity/trigger capacities."""
    n, t = capacity, num_trigger_slots
    return WorldState(
        alive=jnp.zeros((n,), bool),
        comp_mask=jnp.zeros((n,), jnp.uint32),
        pos=jnp.zeros((n, 3), jnp.float32),
        quat=jnp.tile(jnp.asarray([0, 0, 0, 1], jnp.float32), (n, 1)),
        scale=jnp.ones((n, 3), jnp.float32),
        world=jnp.tile(jnp.eye(4, dtype=jnp.float32), (n, 1, 1)),
        lin_vel=jnp.zeros((n, 3), jnp.float32),
        ang_vel=jnp.zeros((n, 3), jnp.float32),
        char_vel_y=jnp.zeros((n,), jnp.float32),
        char_on_ground=jnp.zeros((n,), bool),
        trigger_overlap=jnp.zeros((t, n), bool),
        trigger_active=jnp.ones((t,), bool),
        contact_feat=jnp.full((n, contact_slots), -1, jnp.int32),
        contact_imp=jnp.zeros((n, contact_slots, 3), jnp.float32),
        time=jnp.float32(0.0),
        step_idx=jnp.int32(0),
    )


def tree_replace(obj: Any, **updates: Any) -> Any:
    """dataclasses.replace that works for our registered pytree dataclasses."""
    return dataclasses.replace(obj, **updates)
