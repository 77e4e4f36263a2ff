"""Engine step: the jittable heart of the framework.

``step = transform propagation + physics + trigger events`` — the device-side
image of one ``Application::Update(fixedDt)`` tick (``Application.cpp:153-297``
minus host-side hotkeys/HUD).  ``make_step_fn`` binds a StaticScene (passed
per call as a traced argument — never captured) and returns a pure
``(WorldState, InputFrame) -> (WorldState, StepEvents)`` that composes with
``jax.jit``, ``jax.vmap`` (many worlds) and ``shard_map`` (device meshes).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from banggameengine_tpu import math3d
from banggameengine_tpu.ecs.transform import update_world_matrices
from banggameengine_tpu.physics.step import physics_step
from banggameengine_tpu.state import InputFrame, StaticScene, StepEvents, WorldState
from banggameengine_tpu.state import tree_replace


def visual_positions(state: WorldState, static: StaticScene) -> jax.Array:
    """Transform positions as the reference scene sees them.

    Characters' capsule *centers* live in ``state.pos``; the reference writes
    back ``center + visualOffsetY`` with offset = -(capsuleHeight + 2r)/2
    (``PhysicsSystem.cpp:735-740``, ``:877-914``), i.e. the Transform (and
    hence render + orbit target) sits at the capsule's feet.
    """
    offset = static.char_half_height + static.char_radius  # [C]
    ce = static.char_entity
    safe = jnp.where(ce >= 0, ce, 0)
    pos = state.pos
    shifted = pos[safe].at[..., 1].add(-offset)
    return pos.at[safe].set(jnp.where((ce >= 0)[:, None], shifted, pos[safe]))


def engine_step(
    state: WorldState,
    inp: InputFrame,
    static: StaticScene,
    solver_iterations: int = 10,
    **physics_kwargs,
) -> tuple[WorldState, StepEvents]:
    """One fixed simulation step: physics then world-matrix refresh.

    (The reference re-runs TransformSystem after physics write-back at
    ``Application.cpp:284``; we fold both into the same jitted graph.)
    ``physics_kwargs`` forward to :func:`physics_step` (broadphase mode,
    grid parameters).
    """
    state, events = physics_step(state, inp, static, solver_iterations,
                                 **physics_kwargs)
    world = update_world_matrices(
        visual_positions(state, static), state.quat, state.scale,
        static.parent, static.level_nodes, state.alive,
    )
    state = tree_replace(state, world=world)
    return state, events


def interpolated_world(prev_state: WorldState, state: WorldState, alpha,
                       static: StaticScene) -> jax.Array:
    """World matrices at a fractional time between two fixed steps.

    The reference renders Bullet's interpolated motion states
    (``stepSimulation(dt, 4, fixedStep)`` keeps transforms interpolated by
    the accumulator remainder, ``PhysicsSystem.cpp:848-875``), so display
    frames between 120 Hz sim ticks are smooth at any display rate.  This
    is the array image: lerp positions / nlerp rotations between the two
    step states (``alpha`` = accumulator remainder / fixed_dt in [0, 1))
    and rebuild the world matrices, character visual offsets included.
    """
    alpha = jnp.float32(alpha)
    pos = prev_state.pos + (state.pos - prev_state.pos) * alpha
    quat = math3d.quat_nlerp(prev_state.quat, state.quat, alpha)
    interp = tree_replace(state, pos=pos, quat=quat)
    return update_world_matrices(
        visual_positions(interp, static), quat, state.scale,
        static.parent, static.level_nodes, state.alive,
    )


def make_step_fn(
    static: StaticScene,
    solver_iterations: int = 10,
    donate: bool = True,
    **physics_kwargs,
) -> Callable[[WorldState, InputFrame], tuple[WorldState, StepEvents]]:
    """Build a jitted single-world step bound to the static scene.

    ``donate=True`` donates the WorldState buffers so stepping is in-place in
    device memory (no per-step reallocation).

    The static scene is passed to the executable as a *traced argument*,
    not captured as a constant.  The host-side scene census (dead-stage
    skipping) still runs here, where the scene is concrete.
    """
    from banggameengine_tpu.physics.step import scene_census

    fn = functools.partial(
        engine_step, solver_iterations=solver_iterations,
        **{**scene_census(static), **physics_kwargs},
    )
    jfn = jax.jit(fn, donate_argnums=(0,) if donate else ())
    static = jax.device_put(static)
    return lambda state, inp: jfn(state, inp, static)


def make_hot_reloadable_step_fn(
    solver_iterations: int = 10,
) -> Callable[[WorldState, InputFrame, StaticScene], tuple[WorldState, StepEvents]]:
    """Jitted step with the StaticScene as a *traced* argument.

    Config hot reload (the reference's mtime-polled ``physics.json`` reload,
    ``PhysicsSystem.cpp:216-324``) then just passes a rebuilt StaticScene of
    identical shapes — no recompilation.
    """
    fn = functools.partial(engine_step, solver_iterations=solver_iterations)
    return jax.jit(lambda s, i, st: fn(s, i, st))


def make_multi_step_fn(
    static: StaticScene,
    num_steps: int,
    solver_iterations: int = 10,
    **physics_kwargs,
) -> Callable[[WorldState, InputFrame], tuple[WorldState, StepEvents]]:
    """Jitted ``lax.scan`` over ``num_steps`` fixed steps with constant input.

    Used by benchmarks and headless batch simulation: one dispatch for N
    ticks keeps the device fed.  Returns the final state only; callers that
    need per-step events should use :func:`make_step_fn_with_events`.
    """

    from banggameengine_tpu.physics.step import scene_census

    kwargs = {**scene_census(static), **physics_kwargs}

    def run(state: WorldState, inp: InputFrame, st: StaticScene):
        def body(carry, _):
            s, _ev = engine_step(carry, inp, st, solver_iterations, **kwargs)
            return s, None

        final, _ = jax.lax.scan(body, state, None, length=num_steps)
        return final

    jfn = jax.jit(run, donate_argnums=(0,))
    static = jax.device_put(static)
    step = lambda state, inp: jfn(state, inp, static)
    step.jitted, step.bound_static = jfn, static   # for AOT/trace tools
    return step


def make_step_fn_with_events(
    static: StaticScene,
    num_steps: int,
    solver_iterations: int = 10,
    **physics_kwargs,
):
    """Like :func:`make_multi_step_fn` but stacks per-step events
    (``StepEvents`` arrays gain a leading [num_steps] axis)."""

    from banggameengine_tpu.physics.step import scene_census

    kwargs = {**scene_census(static), **physics_kwargs}

    def run(state: WorldState, inp: InputFrame, st: StaticScene):
        def body(carry, _):
            s, ev = engine_step(carry, inp, st, solver_iterations, **kwargs)
            return s, ev

        final, events = jax.lax.scan(body, state, None, length=num_steps)
        return final, events

    jfn = jax.jit(run, donate_argnums=(0,))
    static = jax.device_put(static)
    step = lambda state, inp: jfn(state, inp, static)
    step.jitted, step.bound_static = jfn, static   # for AOT/trace tools
    return step
