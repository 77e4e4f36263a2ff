#!/usr/bin/env python
"""Smoke check: the engine's main paths on one GPU, each against a reference.

    python chip_smoke.py               # one card: five phases
    python chip_smoke.py --four-cards  # only the paths that span 4 cards

One process drives the card; the CPU references run in the same process on
``jax.devices("cpu")``.  Phases (sizes as in ``bench.py``):

1. demo world: ``build_demo_like`` + ``make_step_fn``, 480 steps; CJ rests
   on the ground box and the positions match the CPU run;
2. many-world: 1,000 worlds x (8 boxes + character + trigger) through the
   flat layout; at 64 worlds flat matches vmapped and the CPU;
3. stress: 10,000 falling boxes on the ``sorted`` route; the step-0
   neighbour lists equal a NumPy brute force, one step matches the CPU,
   and a trace gives the broadphase's share of device time;
4. render: the generated demo scene through ``Application(fused_tick=True)``
   at 1280x720, and ``make_render_fn`` at 1920x1080 (shaded and depth-only)
   against the CPU; times the tiled and gather shade;
5. the GPU-marked tests (``tests_gpu``), in this process.

Every phase runs; any failure exits non-zero without the result line.
Times printed here are smoke readings (one process, few windows), not
benchmark numbers.  The last line of a passing run is the JSON object
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def peak_bytes(dev) -> str:
    stats = dev.memory_stats() or {}
    return str(stats.get("peak_bytes_in_use", "n/a"))


def timed(fn, *args):
    """-> (output, seconds) with the device work finished."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def fresh(tree):
    """Copy of a pytree of arrays (donating step functions consume their
    input)."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.array, tree)


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# --------------------------------------------------------------------------
# phase 1: demo world
# --------------------------------------------------------------------------

# CJ's capsule centre at rest: ground-box top 0.99 + half height 1.3 +
# radius 0.65 (the reference's landing height)
CJ_REST_Y = 2.94


def _demo_run(device, steps):
    import jax

    from banggameengine_tpu.engine import make_step_fn
    from banggameengine_tpu.scene.synthetic import build_demo_like
    from banggameengine_tpu.state import InputFrame

    with jax.default_device(device):
        state, static = build_demo_like()
        fn = make_step_fn(static, donate=False)
        inp = InputFrame.zero()
        state, first = timed(lambda s: fn(s, inp)[0], state)
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            state, _ev = fn(state, inp)
        jax.block_until_ready(state)
        per_step = (time.perf_counter() - t0) / max(steps - 1, 1)
    return state, first, per_step


def phase_demo(dev, ref, steps=480):
    state, first, per_step = _demo_run(dev, steps)
    ref_state, _, _ = _demo_run(ref, steps)
    cj = 0  # build_demo_like: character 0, trigger 1, ground 2
    y = float(state.pos[cj, 1])
    diff = max_abs(state.pos, ref_state.pos)
    log("demo", f"{steps} steps: first_call_s={first:.2f} "
        f"per_step_ms={per_step * 1e3:.4f} (smoke reading) "
        f"peak_bytes_in_use={peak_bytes(dev)} cj_y={y:.4f} "
        f"on_ground={bool(state.char_on_ground[cj])} "
        f"max|pos - cpu|={diff:.3g}")
    assert abs(y - CJ_REST_Y) <= 0.05, f"CJ rests at y={y}"
    assert bool(state.char_on_ground[cj]), "CJ not on the ground"
    # the character controller's sweeps and depenetration run the same
    # float32 math on both backends; only summation order and FMA
    # contraction differ, which moves the rest height by well under 1 mm
    assert diff <= 1e-3, f"demo positions differ from the CPU by {diff}"


# --------------------------------------------------------------------------
# phase 2: many-world
# --------------------------------------------------------------------------

def _manyworld_pair(device, worlds, steps, precision=None, vmapped=True):
    """(flat, vmapped or None) final states of ``worlds`` lockstep
    worlds."""
    import contextlib

    import jax

    from banggameengine_tpu.parallel.manyworld import (
        make_flat_many_world_step, make_sharded_many_world_step,
        make_world_mesh, replicate_input, replicate_state,
    )
    from banggameengine_tpu.scene.synthetic import build_falling_boxes
    from banggameengine_tpu.state import InputFrame

    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with jax.default_device(device), ctx:
        state, static = build_falling_boxes(
            8, with_character=True, with_trigger=True)
        bs = replicate_state(state, worlds)
        bi = replicate_input(InputFrame.zero(), worlds)
        flat = make_flat_many_world_step(static, worlds, state.comp_mask,
                                         num_steps=steps)
        out = flat(fresh(bs), bi)
        if not vmapped:
            return out, None
        vm = make_sharded_many_world_step(
            static, make_world_mesh([device]), num_steps=steps)
        return out, vm(fresh(bs), bi)


def phase_manyworld(dev, ref, worlds=1000, compare_worlds=64, steps=50):
    import jax

    from banggameengine_tpu.parallel.manyworld import (
        make_flat_many_world_step, replicate_input, replicate_state,
    )
    from banggameengine_tpu.scene.synthetic import build_falling_boxes
    from banggameengine_tpu.state import InputFrame

    with jax.default_device(dev):
        state, static = build_falling_boxes(
            8, with_character=True, with_trigger=True)
        bs = replicate_state(state, worlds)
        bi = replicate_input(InputFrame.zero(), worlds)
        flat = make_flat_many_world_step(static, worlds, state.comp_mask,
                                         num_steps=steps)
        out, first = timed(flat, fresh(bs), bi)
        out, per_dispatch = timed(flat, out, bi)
    finite = all(bool(np.isfinite(np.asarray(x)).all())
                 for x in (out.pos, out.quat, out.lin_vel, out.ang_vel,
                           out.world))
    log("manyworld", f"{worlds} worlds x {steps} steps/dispatch: "
        f"first_call_s={first:.2f} "
        f"per_step_ms={per_dispatch / steps * 1e3:.4f} (smoke reading, "
        f"{worlds * steps / per_dispatch:.0f} world-steps/s) "
        f"peak_bytes_in_use={peak_bytes(dev)} finite={finite}")
    assert finite, "non-finite many-world state"

    f_hi, v_hi = _manyworld_pair(dev, compare_worlds, steps)
    f_lo, v_lo = _manyworld_pair(dev, compare_worlds, steps, "default")
    f_cpu, _ = _manyworld_pair(ref, compare_worlds, steps, vmapped=False)
    d_hi = max_abs(f_hi.pos, v_hi.pos)
    d_lo = max_abs(f_lo.pos, v_lo.pos)
    d_cpu = max_abs(f_hi.pos, f_cpu.pos)
    log("manyworld", f"W={compare_worlds}: max|flat - vmapped| pos "
        f"highest={d_hi:.3g} default={d_lo:.3g}; "
        f"max|gpu - cpu| pos={d_cpu:.3g}")
    # 2e-4: the flat-vs-vmapped tolerance of tests/test_flat_manyworld.py
    # (same math, different contraction shapes and summation order)
    assert d_hi <= 2e-4, f"flat vs vmapped differ by {d_hi}"
    assert np.array_equal(np.asarray(f_hi.char_on_ground),
                          np.asarray(v_hi.char_on_ground))
    # the same tolerance across backends: 50 steps of a few colliding
    # boxes amplify float32 rounding differences but stay well below it
    assert d_cpu <= 2e-4, f"flat GPU vs CPU differ by {d_cpu}"


# --------------------------------------------------------------------------
# phase 3: stress
# --------------------------------------------------------------------------

def brute_force_neighbors(mn, mx, dyn, layer, mask, k, margin=0.04):
    """NumPy reference of ``broadphase.neighbor_lists_aabb``: -> (idx
    i32[N, k] first k partners in ascending order, -1 padded; counts)."""
    mn = np.asarray(mn, np.float64) - 0.5 * margin
    mx = np.asarray(mx, np.float64) + 0.5 * margin
    dyn, layer, mask = (np.asarray(a) for a in (dyn, layer, mask))
    n = len(mn)
    idx = np.full((n, k), -1, np.int64)
    counts = np.zeros(n, np.int64)
    cols = np.arange(n)
    for lo in range(0, n, 1024):
        r = np.arange(lo, min(lo + 1024, n))
        ov = np.ones((len(r), n), bool)
        for a in range(3):
            ov &= (mn[r, None, a] <= mx[None, :, a])
            ov &= (mn[None, :, a] <= mx[r, None, a])
        ov &= (dyn[r, None] >= 0) & (dyn[None, :] >= 0)
        ov &= (dyn[r, None] > 0) | (dyn[None, :] > 0)
        ov &= (layer[r, None] & mask[None, :]) != 0
        ov &= (layer[None, :] & mask[r, None]) != 0
        ov &= r[:, None] != cols[None, :]
        counts[r] = ov.sum(1)
        first = np.sort(np.where(ov, cols[None, :], n), axis=1)[:, :k]
        idx[r, :first.shape[1]] = np.where(first < n, first, -1)
    return idx, counts


def _stress_inputs(state, static):
    """The broadphase inputs the ``sorted`` route builds (original order)."""
    import jax
    import jax.numpy as jnp

    from banggameengine_tpu.physics import shapes as sh
    from banggameengine_tpu.state import BODY_DYNAMIC

    mn, mx = sh.shape_aabb(state.pos, state.quat, static.shape_type,
                           static.shape_size)
    dyn = jnp.where(state.alive,
                    (static.body_type == BODY_DYNAMIC).astype(jnp.int32), -1)
    as_i32 = functools.partial(jax.lax.bitcast_convert_type,
                               new_dtype=jnp.int32)
    return mn, mx, dyn, as_i32(static.layer), as_i32(static.mask)


def broadphase_share(step, state, inp, trace_dir):
    """Trace one dispatch of ``step`` (a make_step_fn_with_events fn) ->
    (broadphase device s, total device s, top ops)."""
    import jax

    from banggameengine_tpu.utils.profiling import (
        device_op_seconds, hlo_op_scopes, scope_seconds,
    )

    # command buffers replay whole kernel sequences as one graph; off here
    # so that every kernel in the trace names its HLO instruction
    compiled = step.jitted.lower(state, inp, step.bound_static).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    jax.block_until_ready(compiled(fresh(state), inp, step.bound_static))
    arg = fresh(state)
    jax.block_until_ready(arg)
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(compiled(arg, inp, step.bound_static))
    ops = device_op_seconds(trace_dir)
    text = compiled.as_text()
    scopes = hlo_op_scopes(text)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    top = [(name, sec, scopes.get(name, "")) for name, sec in top]
    return scope_seconds(ops, text, "broadphase"), sum(ops.values()), top


def phase_stress(dev, ref, bodies=10000, steps=50, trace_dir=None):
    import jax

    from banggameengine_tpu.engine import make_step_fn, make_step_fn_with_events
    from banggameengine_tpu.physics.broadphase_triton import (
        neighbor_lists_sorted,
    )
    from banggameengine_tpu.scene.synthetic import build_falling_boxes
    from banggameengine_tpu.state import InputFrame

    route = dict(broadphase="sorted", max_neighbors=8)
    inp = InputFrame.zero()
    with jax.default_device(dev):
        state, static = build_falling_boxes(bodies)
        args = _stress_inputs(state, static)
        # the route's broadphase: the Pallas kernel on a CUDA GPU
        nl = jax.jit(neighbor_lists_sorted)(*args)
        ref_idx, ref_counts = brute_force_neighbors(*args, k=8)
        same = np.array_equal(np.asarray(nl.idx), ref_idx)
        ref_over = int(np.maximum(ref_counts - 8, 0).sum())
        log("stress", f"step-0 neighbour lists == NumPy brute force: {same} "
            f"({int((ref_idx >= 0).sum())} pair slots, overflow "
            f"{int(nl.nbr_overflow)} vs {ref_over})")
        assert same and int(nl.nbr_overflow) == ref_over

        one = make_step_fn(static, donate=False, **route)
        s1, _ = one(state, inp)
        run = make_step_fn_with_events(static, steps, **route)
        (s_end, ev), first = timed(run, fresh(state), inp)
        (s_end, ev), per_dispatch = timed(run, s_end, inp)
        overflow = int(np.asarray(ev.contact_overflow).sum())
        finite = bool(np.isfinite(np.asarray(s_end.pos)).all())
        log("stress", f"{bodies} bodies x {steps} steps/dispatch: "
            f"first_call_s={first:.2f} "
            f"per_step_ms={per_dispatch / steps * 1e3:.4f} (smoke reading) "
            f"peak_bytes_in_use={peak_bytes(dev)} "
            f"contact_overflow_total={overflow} finite={finite}")
        assert finite, "non-finite stress state"

        bp, total, top = broadphase_share(
            run, s_end, inp, trace_dir or tempfile.mkdtemp(prefix="trace_"))
        log("stress", f"traced dispatch: device_s={total:.6f} "
            f"broadphase_s={bp:.6f} broadphase_share={bp / total:.4f}")
        for name, sec, scope in top:
            log("stress", f"  {sec * 1e3:9.3f} ms  {name}  {scope[-90:]}")
        assert bp > 0.0, "no broadphase op found in the trace"

    with jax.default_device(ref):
        state_c, static_c = build_falling_boxes(bodies)
        s1_c, _ = make_step_fn(static_c, donate=False, **route)(state_c, inp)
    d_pos = max_abs(s1.pos, s1_c.pos)
    d_vel = max_abs(s1.lin_vel, s1_c.lin_vel)
    log("stress", f"one step vs CPU: max|pos|={d_pos:.3g} "
        f"max|vel|={d_vel:.3g}")
    # positions: a few float32 ulps at heights up to ~5,000 m (boxes spawn
    # up to 0.5 m per body high), from FMA contraction that differs between
    # backends.  Velocities: the few boxes that spawn interpenetrating get
    # contact impulses summed over 10 Jacobi iterations in another order
    # on each backend; 1 mm/s is far below a contact impulse's size
    np.testing.assert_allclose(np.asarray(s1.pos), np.asarray(s1_c.pos),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s1.lin_vel),
                               np.asarray(s1_c.lin_vel), rtol=1e-6, atol=1e-3)


# --------------------------------------------------------------------------
# phase 4: render
# --------------------------------------------------------------------------

SKY = (0x88, 0xAA, 0xFF)


def _settled_frames(device, width, height, settle):
    """Frames of the generated demo scene after ``settle`` steps, rendered
    on ``device``: (shaded u8[H,W,4], the same with every texture white,
    depth f32[H,W], first-call seconds of shaded and depth, render fns and
    their arguments)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bench import demo_camera, settled_demo
    from banggameengine_tpu.render.pipeline import make_render_fn
    from banggameengine_tpu.scene.synthetic import load_demo_built

    with jax.default_device(device):
        built = load_demo_built()
        args = (settled_demo(built, settle).world,) + demo_camera(width,
                                                                  height)
        rfn = make_render_fn(built.render, width, height, bin_capacity=2048)
        dfn = make_render_fn(built.render, width, height, bin_capacity=2048,
                             depth_only=True)
        img, first = timed(rfn, *args)
        depth, first_d = timed(dfn, *args)
        rs = built.render
        white = dataclasses.replace(rs, **{
            name: jnp.full_like(getattr(rs, name), 255)
            for name in ("textures", "textures_quad", "textures_quad_t")})
        img_white = make_render_fn(white, width, height,
                                   bin_capacity=2048)(*args)
    return (np.asarray(img), np.asarray(img_white), np.asarray(depth),
            first, first_d, built, args, rfn, dfn)


def phase_render(dev, ref, app_size=(1280, 720), frame_size=(1920, 1080),
                 settle=480, app_frames=4):
    import jax

    from banggameengine_tpu.app.application import Application
    from banggameengine_tpu.render.pipeline import render_frame
    from banggameengine_tpu.scene.synthetic import demo_assets_dir
    from banggameengine_tpu.utils.profiling import measure_trials

    # the interactive path: 4 substeps + a shaded frame per call
    aw, ah = app_size
    with jax.default_device(dev):
        app = Application(assets_root=demo_assets_dir(0), width=aw,
                          height=ah, fused_tick=True)
        fixed = app.config.fixed_step
        t0 = time.perf_counter()
        app.frame(real_dt=4.5 * fixed)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(app_frames):
            app.frame(real_dt=4.5 * fixed)
        per_tick = (time.perf_counter() - t0) / app_frames
    img = app.last_frame_image
    log("render", f"Application fused tick {aw}x{ah}: first_call_s={first:.2f}"
        f" per_tick_ms={per_tick * 1e3:.3f} (smoke reading, 4 substeps + "
        f"frame) peak_bytes_in_use={peak_bytes(dev)} "
        f"steps={int(app.state.step_idx)} corner={tuple(img[0, 0, :3])}")
    assert img.shape == (ah, aw, 4) and tuple(img[0, 0, :3]) == SKY
    assert int(app.state.step_idx) == 4 * (app_frames + 1)
    assert bool(np.isfinite(np.asarray(app.state.pos)).all())

    w, h = frame_size
    img, img_white, depth, first, first_d, built, args, rfn, dfn = (
        _settled_frames(dev, w, h, settle))
    t_shade = measure_trials(rfn, *args, calls=5, warmup=1, trials=3)
    t_depth = measure_trials(dfn, *args, calls=5, warmup=1, trials=3)
    log("render", f"{w}x{h}: shaded first_call_s={first:.2f} "
        f"frame_ms={np.median(t_shade) * 1e3:.3f}; depth-only "
        f"first_call_s={first_d:.2f} frame_ms={np.median(t_depth) * 1e3:.3f}"
        f" (smoke readings) peak_bytes_in_use={peak_bytes(dev)}")
    with jax.default_device(dev):
        modes = {}
        for mode in ("tiled", "gather"):
            fn = jax.jit(functools.partial(
                render_frame, width=w, height=h, bin_capacity=2048,
                shade_mode=mode))
            rs = jax.device_put(built.render)
            modes[mode] = measure_trials(fn, rs, *args, calls=5, warmup=1,
                                         trials=3)
    log("render", "shade at %dx%d: tiled %s ms, gather %s ms (median of 3 "
        "windows of 5 frames; smoke readings)" % (
            w, h, "/".join(f"{t * 1e3:.3f}" for t in modes["tiled"]),
            "/".join(f"{t * 1e3:.3f}" for t in modes["gather"])))

    img_c, white_c, depth_c, *_ = _settled_frames(ref, w, h, settle)

    def compare(a, b):
        delta = np.abs(a.astype(int) - b.astype(int))
        return float((delta.max(-1) == 0).mean()), int(delta.max())

    equal, d_max = compare(img, img_c)
    equal_w, d_max_w = compare(img_white, white_c)
    depth_ok = float((np.abs(depth - depth_c) <= 1e-5).mean())
    log("render", f"vs CPU: textured equal_pixels={equal:.6f} "
        f"max|du8|={d_max}; white-textured equal_pixels={equal_w:.6f} "
        f"max|du8|={d_max_w}; depth within 1e-5: {depth_ok:.6f} "
        f"corner={tuple(img[0, 0, :3])}")
    assert tuple(img[0, 0, :3]) == SKY, "corner pixel is not the sky"
    assert depth_ok >= 0.999, f"depth differs on {1 - depth_ok:.4%} pixels"
    # Geometry and lighting: identical float32 math on both backends except
    # for transcendental implementations (pow, rsqrt) and FMA contraction,
    # so with every texture white at most 2 u8 steps of shading differ,
    # and only pixels within rounding of a triangle edge may differ more.
    assert equal_w >= 0.999, f"only {equal_w:.4%} of pixels equal (white)"
    assert d_max_w <= 2 or equal_w >= 0.9999, f"max u8 difference {d_max_w}"
    # Texturing: the ground texture is minified without mipmaps towards
    # the horizon (one pixel spans many texels), so a last-bit difference
    # in the interpolated texture coordinate selects a neighbouring texel
    # and those pixels differ by the texture's own contrast.
    assert equal >= 0.95, f"only {equal:.4%} of pixels equal (textured)"


# --------------------------------------------------------------------------
# phase 5: GPU-marked tests
# --------------------------------------------------------------------------

def phase_gpu_tests():
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    rc = pytest.main([os.path.join(REPO, "tests_gpu"), "-q", "-m", "gpu",
                      "-p", "no:cacheprovider"], plugins=[Count()])
    log("gpu-tests", f"pytest rc={int(rc)} passed={Count.passed}")
    assert int(rc) == 0 and Count.passed > 0, "GPU tests failed"


# --------------------------------------------------------------------------
# --four-cards: the paths that span several cards
# --------------------------------------------------------------------------

def _spans(tree, n) -> bool:
    import jax

    return all(len(x.sharding.device_set) == n for x in jax.tree.leaves(tree))


def phase_four_cards(devices, worlds=1000, steps=50, bodies=4096):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from banggameengine_tpu.engine import engine_step
    from banggameengine_tpu.parallel.manyworld import (
        make_flat_many_world_step, make_world_mesh, replicate_input,
        replicate_state, shard_batched,
    )
    from banggameengine_tpu.parallel.sharded_world import (
        make_entity_axis_mesh, make_fully_sharded_step, shard_world,
    )
    from banggameengine_tpu.parallel.spatial import (
        AXIS, make_entity_sharded_contact_phase,
    )
    from banggameengine_tpu.scene.synthetic import build_falling_boxes
    from banggameengine_tpu.state import (
        BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER, InputFrame,
    )

    n = len(devices)
    one = devices[0]
    inp = InputFrame.zero()

    # flat many-world sharded over the world axis vs one card
    state, static = build_falling_boxes(
        8, with_character=True, with_trigger=True)
    bs = replicate_state(state, worlds)
    bi = replicate_input(inp, worlds)
    mesh = make_world_mesh(devices)
    sharded = make_flat_many_world_step(static, worlds, state.comp_mask,
                                        num_steps=steps, mesh=mesh)
    out, first = timed(sharded, shard_batched(fresh(bs), mesh),
                       shard_batched(bi, mesh))
    out, per = timed(sharded, out, shard_batched(bi, mesh))
    out = sharded(shard_batched(fresh(bs), mesh), shard_batched(bi, mesh))
    with jax.default_device(one):
        single = make_flat_many_world_step(static, worlds, state.comp_mask,
                                           num_steps=steps)
        out1 = single(jax.device_put(fresh(bs), one), jax.device_put(bi, one))
    d = max_abs(out.pos, out1.pos)
    log("four-cards", f"flat-sharded {worlds} worlds x {steps} steps over "
        f"{n} devices: first_call_s={first:.2f} per_step_ms="
        f"{per / steps * 1e3:.4f} (smoke reading) max|pos - one card|={d:.3g}"
        f" spans={_spans(out, n)}")
    assert _spans(out, n), "flat-sharded output not on every device"
    # the per-device program is the same block-diagonal math as one card
    assert d <= 1e-5, f"flat-sharded differs from one card by {d}"

    # one world, state row-sharded over the entity axis vs the unsharded step
    # ~0.3 boxes per square unit of ground: contacts without a solid pile
    fstate, fstatic = build_falling_boxes(bodies, seed=2, spread=60.0)
    # host copies: placing an array on a mesh may reuse its buffer, which
    # the donating sharded step then consumes
    fstate, fstatic = jax.tree.map(np.asarray, (fstate, fstatic))
    fmesh = make_entity_axis_mesh(n)
    sstate, sstatic = shard_world(fstate, fstatic, fmesh)
    sstep = make_fully_sharded_step(fstatic, fmesh, max_neighbors=8)
    with jax.default_device(one):
        ref_step = jax.jit(lambda s, st: engine_step(
            s, inp, st, broadphase="dense", max_neighbors=8,
            any_char=False, enable_capsule=False, any_trig=False)[0])
        rstate = jax.device_put(fstate, one)
        rstatic = jax.device_put(fstatic, one)
        t0 = time.perf_counter()
        for _ in range(25):
            sstate, _ev = sstep(sstate, inp, sstatic)
        jax.block_until_ready(sstate)
        t_sh = time.perf_counter() - t0
        for _ in range(25):
            rstate = ref_step(rstate, rstatic)
    d = max_abs(sstate.pos, rstate.pos)
    log("four-cards", f"fully sharded world ({fstate.capacity} bodies / {n} "
        f"devices, 25 steps, {t_sh:.2f} s incl. compile): "
        f"max|pos - unsharded|={d:.3g} spans={_spans(sstate.pos, n)}")
    assert _spans(sstate.pos, n), "sharded world not on every device"
    # the tolerance of tests/test_sharded_world.py: same per-row math,
    # float reassociation across the gathers
    assert d <= 2e-4, f"fully sharded step differs by {d}"

    # the entity-sharded contact phase vs the same phase on one device
    alive = fstate.alive
    solid = alive & ((fstate.comp_mask & (COMP_COLLIDER | COMP_CHARACTER))
                     != 0)
    is_dyn = (fstatic.body_type == BODY_DYNAMIC) & alive
    near = jnp.asarray(fstate.pos).at[:, 1].set(
        jnp.where(alive, 0.45 + 0.1 * (jnp.arange(fstate.capacity) % 3),
                  fstate.pos[:, 1]))
    vel = jnp.asarray(fstate.lin_vel).at[:, 1].set(
        jnp.where(alive, -1.0, 0.0))
    phase_args = (near, fstate.quat, vel, fstate.ang_vel, is_dyn, solid,
                  jnp.float32(1 / 120))
    jstatic = jax.tree.map(jnp.asarray, fstatic)
    emesh = Mesh(np.asarray(devices), (AXIS,))
    v_sh, w_sh = jax.jit(make_entity_sharded_contact_phase(jstatic, emesh))(
        *phase_args)
    mesh1 = Mesh(np.asarray([one]), (AXIS,))
    v_1, w_1 = jax.jit(make_entity_sharded_contact_phase(jstatic, mesh1))(
        *jax.device_put(phase_args, one))
    d = max(max_abs(v_sh, v_1), max_abs(w_sh, w_1))
    log("four-cards", f"entity-sharded contact phase ({fstate.capacity} "
        f"bodies / {n} shards): max|v,w - one device|={d:.3g} "
        f"spans={_spans((v_sh, w_sh), n)}")
    assert _spans((v_sh, w_sh), n), "contact phase not on every device"
    # the tolerance of tests/test_spatial_sharding.py
    assert d <= 1e-4, f"sharded contact phase differs by {d}"


# --------------------------------------------------------------------------

def run_phases(phases) -> list[str]:
    """Run every ``(name, fn)``; -> names of the phases that failed."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(name, f"FAILED after {time.perf_counter() - t0:.1f} s")
        else:
            log(name, f"passed in {time.perf_counter() - t0:.1f} s")
    return failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the paths that span 4 cards")
    args = p.parse_args(argv)

    sys.path.insert(0, REPO)
    from banggameengine_tpu.utils.profiling import gpu_name_and_power_limit

    print(gpu_name_and_power_limit(), flush=True)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU found: JAX's first device is on '{dev.platform}'",
              file=sys.stderr)
        return 1
    devices = jax.devices()
    print(f"jax {jax.__version__}: {len(devices)} x {dev.device_kind}",
          flush=True)

    if args.four_cards:
        if len(devices) < 4:
            print(f"--four-cards needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 1
        phases = [("four-cards",
                   lambda: phase_four_cards(devices[:4]))]
        count = 4
    else:
        cpu = jax.devices("cpu")[0]
        trace_dir = os.path.join(REPO, "build", "trace_stress")
        phases = [
            ("demo", lambda: phase_demo(dev, cpu)),
            ("manyworld", lambda: phase_manyworld(dev, cpu)),
            ("stress", lambda: phase_stress(dev, cpu, trace_dir=trace_dir)),
            ("render", lambda: phase_render(dev, cpu)),
            ("gpu-tests", phase_gpu_tests),
        ]
        count = 1
    failed = run_phases(phases)
    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
