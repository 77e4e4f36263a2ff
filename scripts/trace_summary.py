"""Trace one program on the device and list its HLO ops by device time.

Prints per-dispatch device milliseconds per HLO instruction (with the
``jax.named_scope`` path the instruction came from), sorted by total time,
and the share of the ``broadphase`` scope where there is one.

Usage:
  python scripts/trace_summary.py stress|manyworld|frame_tiled|frame_gather
                                  [outdir]
"""

from __future__ import annotations

import functools
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summarize(compiled, args, outdir, reps=3):
    import jax

    from banggameengine_tpu.utils.profiling import (
        device_op_seconds, hlo_op_scopes, scope_seconds,
    )

    jax.block_until_ready(compiled(*args()))        # warm
    inputs = [args() for _ in range(reps)]
    jax.block_until_ready(inputs)
    with jax.profiler.trace(outdir):
        for a in inputs:
            jax.block_until_ready(compiled(*a))
    ops = device_op_seconds(outdir)
    text = compiled.as_text()
    scopes = hlo_op_scopes(text)
    total = sum(ops.values())
    print(f"{'ms/dispatch':>12}  op  [scope]")
    for name, sec in sorted(ops.items(), key=lambda kv: -kv[1])[:40]:
        print(f"{sec * 1e3 / reps:12.4f}  {name}  [{scopes.get(name, '')[-80:]}]")
    print(f"{total * 1e3 / reps:12.4f}  device total per dispatch")
    bp = scope_seconds(ops, text, "broadphase")
    if bp:
        print(f"broadphase share: {bp / total:.4f}")


def build_stress():
    import jax.numpy as jnp
    import jax

    from banggameengine_tpu.engine import make_multi_step_fn
    from banggameengine_tpu.scene.synthetic import build_falling_boxes
    from banggameengine_tpu.state import InputFrame

    state, static = build_falling_boxes(10000)
    step = make_multi_step_fn(static, 50, broadphase="sorted",
                              max_neighbors=8)
    inp = InputFrame.zero()
    compiled = step.jitted.lower(state, inp, step.bound_static).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    return compiled, lambda: (jax.tree.map(jnp.array, state), inp,
                              step.bound_static)


def build_manyworld():
    import jax
    import jax.numpy as jnp

    from banggameengine_tpu.parallel.manyworld import (
        make_flat_many_world_step, replicate_input, replicate_state,
    )
    from banggameengine_tpu.scene.synthetic import build_falling_boxes
    from banggameengine_tpu.state import InputFrame

    state, static = build_falling_boxes(
        8, with_character=True, with_trigger=True)
    bstate = replicate_state(state, 1000)
    binp = replicate_input(InputFrame.zero(), 1000)
    step = make_flat_many_world_step(static, 1000, state.comp_mask,
                                     num_steps=50)
    fn = jax.jit(lambda s, i: step(s, i))
    compiled = fn.lower(bstate, binp).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    return compiled, lambda: (jax.tree.map(jnp.array, bstate), binp)


def build_frame(shade_mode):
    import jax

    from bench import demo_camera, settled_demo
    from banggameengine_tpu.render.pipeline import render_frame
    from banggameengine_tpu.scene.synthetic import load_demo_built

    built = load_demo_built()
    fn = jax.jit(functools.partial(
        render_frame, width=1920, height=1080, bin_capacity=2048,
        shade_mode=shade_mode))
    args = (jax.device_put(built.render), settled_demo(built).world,
            *demo_camera(1920, 1080))
    compiled = fn.lower(*args).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    return compiled, lambda: args


BUILDERS = {
    "stress": build_stress,
    "manyworld": build_manyworld,
    "frame_tiled": lambda: build_frame("tiled"),
    "frame_gather": lambda: build_frame("gather"),
}

if __name__ == "__main__":
    name = sys.argv[1]
    outdir = (sys.argv[2] if len(sys.argv) > 2
              else tempfile.mkdtemp(prefix=f"trace_{name}_"))
    compiled, args = BUILDERS[name]()
    summarize(compiled, args, outdir)
