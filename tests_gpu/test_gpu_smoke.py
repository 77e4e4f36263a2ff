"""GPU smoke tests: small shapes, compiled for the card."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def test_flat_manyworld_matches_vmapped(gpu):
    """Flat block-diagonal many-world == vmapped path (4 worlds, 10 steps)."""
    from banggameengine_tpu.parallel.manyworld import (
        make_flat_many_world_step, make_sharded_many_world_step,
        make_world_mesh, replicate_input, replicate_state,
    )
    from banggameengine_tpu.scene.synthetic import build_falling_boxes
    from banggameengine_tpu.state import InputFrame

    state, static = build_falling_boxes(
        8, with_character=True, with_trigger=True)
    w = 4
    bs = replicate_state(state, w)
    bi = replicate_input(InputFrame.zero(), w)
    s_v = make_sharded_many_world_step(static, make_world_mesh([gpu]),
                                       num_steps=10)
    s_f = make_flat_many_world_step(static, w, state.comp_mask, num_steps=10)
    o1 = s_v(jax.tree.map(jnp.array, bs), bi)
    o2 = s_f(jax.tree.map(jnp.array, bs), bi)
    # the tolerance of tests/test_flat_manyworld.py
    np.testing.assert_allclose(np.asarray(o1.pos), np.asarray(o2.pos),
                               atol=2e-4)
    np.testing.assert_array_equal(np.asarray(o1.trigger_overlap),
                                  np.asarray(o2.trigger_overlap))


def test_fused_tick_on_generated_scene(gpu, tmp_path):
    """One interactive tick (step + small shaded frame) on the generated
    demo scene."""
    import math

    from banggameengine_tpu.physics.config import load_physics_config
    from banggameengine_tpu.render.camera import Camera
    from banggameengine_tpu.render.pipeline import make_frame_fn
    from banggameengine_tpu.scene import (
        ResourceManager, build_scene, parse_scene_json,
    )
    from banggameengine_tpu.scene.synthetic import write_demo_assets
    from banggameengine_tpu.state import InputFrame

    root = write_demo_assets(str(tmp_path))
    built = build_scene(
        parse_scene_json(f"{root}/scenes/demo.json"),
        ResourceManager(assets_root=root),
        load_physics_config(f"{root}/config/physics.json"),
    )
    cam = Camera()
    cam.position[:] = (0.0, 4.0, -10.5)
    cam.set_yaw_pitch(math.pi / 2, -0.12)
    ffn = make_frame_fn(built, 160, 90, bin_capacity=256)
    s = jax.tree.map(jnp.array, built.initial_state)
    s, img, _ev = ffn(s, InputFrame.zero(), jnp.asarray(cam.view_matrix()),
                      jnp.asarray(cam.proj_matrix(160 / 90)),
                      jnp.asarray(cam.position))
    img = np.asarray(img)
    assert img.shape == (90, 160, 4)
    assert tuple(img[0, 0, :3]) == (0x88, 0xAA, 0xFF)  # sky clear
    assert float(s.time) > 0.0


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_sorted_broadphase_matches_brute_force(gpu, route):
    """The blocked AABB broadphase compiled for the card (plain XLA, and the
    stress route's Pallas kernel) == NumPy brute force on a dense pile of
    2,000 boxes (neighbour caps saturate)."""
    import chip_smoke
    from banggameengine_tpu.physics.broadphase import neighbor_lists_aabb
    from banggameengine_tpu.physics.broadphase_triton import (
        neighbor_lists_sorted,
    )
    from banggameengine_tpu.scene.synthetic import build_falling_boxes

    state, static = build_falling_boxes(2000, seed=3, spread=10.0)
    # squash the column of boxes into a pile a few boxes deep
    state = dataclasses.replace(state, pos=state.pos.at[:, 1].multiply(0.01))
    args = chip_smoke._stress_inputs(state, static)
    fn = neighbor_lists_aabb if route == "plain" else neighbor_lists_sorted
    nl = jax.jit(fn)(*args)
    idx, counts = chip_smoke.brute_force_neighbors(*args, k=8)
    np.testing.assert_array_equal(np.asarray(nl.idx), idx)
    assert int(nl.nbr_overflow) == int(np.maximum(counts - 8, 0).sum())
    assert int(nl.nbr_overflow) > 0
