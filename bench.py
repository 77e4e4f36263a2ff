"""Benchmark harness: prints ONE JSON line with every config's rate.

Configs:
  manyworld — 1k lockstep worlds x (8 boxes + character + trigger),
              world-steps/sec/device (flat block-diagonal layout, sharded
              over the world axis on multi-device meshes)
  demo      — single demo-scene world, headless steps/sec
  stress    — single world of 10k falling boxes, steps/sec
  cull      — frustum cull + vertex transform + depth-only 1080p raster,
              frames/sec
  frame     — engine step + shaded 1080p frame, frames/sec
  tick      — interactive tick (4 substeps + shaded 720p frame), ticks/sec

The demo, cull, frame and tick configs run the demo scene generated from a
seed (``scene.synthetic.write_demo_assets``).  Every value is the median of
several timed windows (``utils.profiling.measure_trials*``) with its
min/max spread.  The run needs a GPU: without one, or when any config
fails, it exits non-zero.

Usage: python bench.py [config] [--steps N] [--worlds W] [--bodies B]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def _median_rate(fn, args, work_per_call, calls=5, trials=3):
    """Median work/sec over ``trials`` timed windows + a spread dict."""
    from banggameengine_tpu.utils.profiling import measure_trials_chained

    times, _ = measure_trials_chained(fn, *args, calls=calls, warmup=2,
                                      trials=trials)
    rates = sorted(work_per_call / t for t in times)
    return statistics.median(rates), {
        "min": rates[0], "max": rates[-1], "trials": len(rates),
    }


def bench_manyworld(num_worlds=1000, bodies_per_world=8, steps_per_dispatch=50,
                    layout=None, trials=5):
    import jax

    from banggameengine_tpu.parallel import (
        make_sharded_many_world_step, make_world_mesh,
        replicate_input, replicate_state,
    )
    from banggameengine_tpu.parallel.manyworld import (
        make_flat_many_world_step, shard_batched,
    )
    from banggameengine_tpu.scene.synthetic import build_falling_boxes
    from banggameengine_tpu.state import InputFrame
    from banggameengine_tpu.utils.profiling import measure_trials_chained

    # 8 dynamic boxes + character + trigger = 10 collision objects/world
    state, static = build_falling_boxes(
        bodies_per_world, with_character=True, with_trigger=True
    )
    mesh = make_world_mesh()
    bstate = shard_batched(replicate_state(state, num_worlds), mesh)
    binp = shard_batched(replicate_input(InputFrame.zero(), num_worlds), mesh)

    def measure(step, bstate_):
        times, _ = measure_trials_chained(step, bstate_, binp,
                                          calls=5, warmup=2, trials=trials)
        rates = sorted(num_worlds * steps_per_dispatch / t for t in times)
        return statistics.median(rates), rates

    # Default layout: flat block-diagonal, sharded over the world axis on
    # multi-device meshes (each device runs its local W/D worlds as one
    # flat block).  Falls back to the vmapped path ONLY on the host-side
    # build rejections the builder raises (ValueError); a compile failure
    # of the default layout propagates and fails the bench.
    if layout is None:
        layout = os.environ.get("BANG_MW_LAYOUT", "flat")
    n_dev = len(jax.devices())
    best, rates, used_layout = 0.0, [], "vmapped"
    if layout in ("flat", "both"):
        try:
            flat = make_flat_many_world_step(
                static, num_worlds, state.comp_mask,
                num_steps=steps_per_dispatch,
                mesh=mesh if n_dev > 1 else None,
            )
        except ValueError as e:  # host-side topology rejection only
            used_layout = f"vmapped-fallback({type(e).__name__})"
            print(f"[bench] flat layout unavailable ({e}); "
                  "falling back to vmapped", file=sys.stderr)
        else:
            best, rates = measure(flat, bstate)
            used_layout = "flat" if n_dev == 1 else "flat-sharded"
            bstate = shard_batched(
                replicate_state(state, num_worlds), mesh)
    if layout != "flat" or best == 0.0:
        step = make_sharded_many_world_step(
            static, mesh, num_steps=steps_per_dispatch
        )
        vm, vm_rates = measure(step, bstate)
        if vm > best:
            best, rates = vm, vm_rates
            if used_layout in ("flat", "flat-sharded"):
                used_layout = "vmapped(beat flat)"
    return {
        "metric": f"world-steps/sec/device ({num_worlds} worlds x "
        f"[{bodies_per_world} boxes + character + trigger], "
        f"lockstep x{steps_per_dispatch})",
        "value": best / n_dev,
        "unit": "world-steps/sec/device",
        "layout": used_layout,
        "spread": {"min": rates[0] / n_dev, "max": rates[-1] / n_dev,
                   "trials": len(rates)},
    }


def bench_demo(steps_per_dispatch=100):
    from banggameengine_tpu.engine import make_multi_step_fn
    from banggameengine_tpu.state import InputFrame
    from __graft_entry__ import _load_demo_scene

    state, static, scene = _load_demo_scene()
    print(f"[bench] demo scene: {scene}", file=sys.stderr)
    run = make_multi_step_fn(static, steps_per_dispatch)
    value, spread = _median_rate(run, (state, InputFrame.zero()),
                                 steps_per_dispatch, calls=5)
    return {
        "metric": "demo-scene headless steps/sec (single world)",
        "value": value,
        "unit": "steps/sec",
        "scene": scene,
        "spread": spread,
    }


def bench_stress(num_bodies=10000, steps_per_dispatch=50):
    """10k falling rigid bodies: Morton-sorted blocked all-pairs broadphase
    + transposed component-form contact pipeline, no rendering."""
    from banggameengine_tpu.engine import make_multi_step_fn
    from banggameengine_tpu.scene.synthetic import build_falling_boxes
    from banggameengine_tpu.state import InputFrame

    state, static = build_falling_boxes(num_bodies)
    run = make_multi_step_fn(
        static, steps_per_dispatch, broadphase="sorted", max_neighbors=8,
    )
    value, spread = _median_rate(run, (state, InputFrame.zero()),
                                 steps_per_dispatch, calls=4)
    return {
        "metric": f"physics stress steps/sec ({num_bodies} falling boxes)",
        "value": value,
        "unit": "steps/sec",
        "spread": spread,
    }


def demo_camera(width, height):
    """The benchmark camera: behind CJ's landing spot, looking at it."""
    import jax.numpy as jnp

    from banggameengine_tpu.render.camera import Camera

    cam = Camera()
    cam.position[:] = (0.0, 4.0, -10.5)
    cam.set_yaw_pitch(3.14159 / 2, -0.12)
    return (jnp.asarray(cam.view_matrix()),
            jnp.asarray(cam.proj_matrix(width / height)),
            jnp.asarray(cam.position))


def settled_demo(built, steps=480):
    """The demo world after ``steps`` fixed steps (CJ has landed, so the
    dense character mesh is in view and the heavy raster pass runs)."""
    import jax
    import jax.numpy as jnp

    from banggameengine_tpu.engine import make_multi_step_fn
    from banggameengine_tpu.state import InputFrame

    return make_multi_step_fn(built.static, steps)(
        jax.tree.map(jnp.array, built.initial_state), InputFrame.zero())


def bench_cull(width=1920, height=1080):
    from banggameengine_tpu.render.pipeline import make_render_fn
    from banggameengine_tpu.scene.synthetic import load_demo_built
    from banggameengine_tpu.utils.profiling import measure_trials

    built = load_demo_built()
    rfn = make_render_fn(built.render, width, height,
                         bin_capacity=2048, depth_only=True)
    args = (settled_demo(built).world,) + demo_camera(width, height)
    times = measure_trials(rfn, *args, calls=10, warmup=2, trials=3)
    rates = sorted(1.0 / t for t in times)
    return {
        "metric": f"cull+depth raster frames/sec ({width}x{height})",
        "value": statistics.median(rates),
        "unit": "frames/sec",
        "spread": {"min": rates[0], "max": rates[-1], "trials": len(rates)},
    }


def _bench_frame_fn(width, height, substeps):
    import jax

    from banggameengine_tpu.render.pipeline import make_frame_fn
    from banggameengine_tpu.scene.synthetic import load_demo_built
    from banggameengine_tpu.state import InputFrame

    built = load_demo_built()
    ffn = make_frame_fn(built, width, height, substeps=substeps)
    state = jax.device_put(built.initial_state)
    return _median_rate(ffn, (state, InputFrame.zero())
                        + demo_camera(width, height), 1.0, calls=10)


def bench_frame(width=1920, height=1080):
    """Engine step + shaded 1080p frame per call (make_frame_fn)."""
    value, spread = _bench_frame_fn(width, height, 1)
    return {
        "metric": f"full frame loop frames/sec (sim+shaded {width}x{height})",
        "value": value,
        "unit": "frames/sec",
        "spread": spread,
    }


def bench_tick(width=1280, height=720, substeps=4):
    """Interactive tick at the reference's default window: 4 fixed
    substeps (120 Hz sim inside a 30 Hz display frame,
    Application.cpp:97-101) + one shaded frame."""
    value, spread = _bench_frame_fn(width, height, substeps)
    return {
        "metric": f"interactive ticks/sec ({substeps} substeps + "
        f"shaded {width}x{height} frame)",
        "value": value,
        "unit": "ticks/sec",
        "spread": spread,
    }


CONFIGS = {
    "manyworld": bench_manyworld,
    "demo": bench_demo,
    "stress": bench_stress,
    "cull": bench_cull,
    "frame": bench_frame,
    "tick": bench_tick,
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default="all",
                   choices=list(CONFIGS) + ["all"])
    p.add_argument("--worlds", type=int, default=1000)
    p.add_argument("--bodies", type=int, default=8)
    p.add_argument("--steps", type=int, default=None)
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] no GPU found (JAX platform '{dev.platform}'); "
              "the benchmark runs only on a GPU", file=sys.stderr)
        return 2
    from banggameengine_tpu.utils.profiling import gpu_name_and_power_limit

    print(f"[bench] {gpu_name_and_power_limit()}", file=sys.stderr)

    names = list(CONFIGS) if args.config == "all" else [args.config]
    results, failed = {}, []
    for name in names:
        kwargs = {}
        if name == "manyworld":
            kwargs = {"num_worlds": args.worlds,
                      "bodies_per_world": args.bodies}
        if name in ("manyworld", "demo", "stress") and args.steps:
            kwargs["steps_per_dispatch"] = args.steps
        try:
            results[name] = CONFIGS[name](**kwargs)
        except Exception as e:  # recorded, and fails the run below
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            failed.append(name)
            print(f"[bench] config {name} failed: {e}", file=sys.stderr)
    print(json.dumps({
        "configs": results,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
