"""Debug/validation mode: NaN & divergence guards for the jitted step.

The reference relies on single-threaded mutation plus manual HUD checks
(dirty-count invariant at ``Application.cpp:283-292``); the array build's
functional step can't race, so the sanitizer budget goes to **numeric**
safety instead (SURVEY.md §5): ``checkify``-instrumented stepping that
reports NaN/Inf state corruption and runaway velocities with the failing
step index, plus a cheap post-step assertion helper for host loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from banggameengine_tpu.engine import engine_step

VELOCITY_LIMIT = 1e4  # anything faster is runaway integration


def make_checked_step_fn(static, solver_iterations: int = 10, **physics_kwargs):
    """Jitted step that also returns a checkify Error.

    Usage::

        step = make_checked_step_fn(static)
        err, (state, events) = step(state, inp)
        err.throw()   # raises with a message when the state went bad
    """

    from banggameengine_tpu.physics.step import scene_census

    physics_kwargs = {**scene_census(static), **physics_kwargs}

    def checked(state, inp, st):
        new_state, events = engine_step(
            state, inp, st, solver_iterations, **physics_kwargs
        )
        checkify.check(
            jnp.all(jnp.isfinite(new_state.pos)),
            "non-finite position at step {i}", i=new_state.step_idx,
        )
        checkify.check(
            jnp.all(jnp.isfinite(new_state.quat)),
            "non-finite quaternion at step {i}", i=new_state.step_idx,
        )
        checkify.check(
            jnp.all(jnp.isfinite(new_state.lin_vel))
            & jnp.all(jnp.abs(new_state.lin_vel) < VELOCITY_LIMIT),
            "runaway/non-finite velocity at step {i}", i=new_state.step_idx,
        )
        return new_state, events

    jfn = jax.jit(checkify.checkify(checked))
    static = jax.device_put(static)
    return lambda state, inp: jfn(state, inp, static)


def assert_state_healthy(state) -> None:
    """Host-side spot check (cheap; pulls 3 scalars)."""
    import numpy as np

    if not bool(jnp.all(jnp.isfinite(state.pos))):
        bad = np.argwhere(~np.isfinite(np.asarray(state.pos)))
        raise FloatingPointError(f"non-finite positions at entities {bad[:5]}")
    if not bool(jnp.all(jnp.isfinite(state.lin_vel))):
        raise FloatingPointError("non-finite velocities")
