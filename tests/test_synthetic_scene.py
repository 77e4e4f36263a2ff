"""The demo scene generated from a seed: asset layout, loading through the
reference's entry points, and rendering without Pillow."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from banggameengine_tpu.physics.config import load_physics_config
from banggameengine_tpu.scene import (
    ResourceManager, build_scene, parse_scene_json,
)
from banggameengine_tpu.scene.synthetic import (
    CJ_MIN_TRIANGLES, build_demo_like, write_demo_assets,
)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_demo_assets(str(tmp_path_factory.mktemp("assets")), seed=3)


def _build(root):
    return build_scene(
        parse_scene_json(os.path.join(root, "scenes", "demo.json")),
        ResourceManager(assets_root=root),
        load_physics_config(os.path.join(root, "config", "physics.json")),
    )


def test_layout_and_determinism(assets, tmp_path):
    for rel in ("scenes/demo.json", "config/physics.json", "models/demo.obj",
                "models/demo.mtl", "models/plane.obj", "textures/ground.png"):
        assert os.path.isfile(os.path.join(assets, rel)), rel
    again = write_demo_assets(str(tmp_path), seed=3)
    other = write_demo_assets(str(tmp_path / "other"), seed=4)
    png = lambda root: open(os.path.join(root, "textures", "ground.png"),
                            "rb").read()
    assert png(assets) == png(again) != png(other)
    with open(os.path.join(assets, "scenes", "demo.json")) as f:
        ids = [e["id"] for e in json.load(f)["entities"]]
    assert ids == ["cj", "checkpoint", "ground"]


def test_scene_matches_build_demo_like(assets):
    built = _build(assets)
    state, static = build_demo_like()
    np.testing.assert_allclose(np.asarray(built.initial_state.pos)[:3],
                               np.asarray(state.pos)[:3])
    for field in ("shape_type", "shape_size", "body_type", "friction",
                  "layer", "trig_size", "trig_layer", "char_entity"):
        np.testing.assert_array_equal(
            np.asarray(getattr(built.static, field))[:3],
            np.asarray(getattr(static, field))[:3], err_msg=field)
    cj = built.find_entity("cj")
    n_cj = int(np.sum(np.asarray(built.render.v_entity)[::3][
        np.asarray(built.render.tri_valid)] == cj))
    assert n_cj >= CJ_MIN_TRIANGLES


def test_renders_without_pillow(tmp_path, monkeypatch):
    """The PNG texture decodes with the standard library alone."""
    from banggameengine_tpu.render.camera import Camera
    from banggameengine_tpu.render.pipeline import render_frame

    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    root = write_demo_assets(str(tmp_path), seed=0)
    built = _build(root)
    assert built.render.textures.shape[0] >= 2      # white + ground texture
    cam = Camera()
    cam.position[:] = (0.0, 4.0, -10.5)
    cam.set_yaw_pitch(np.pi / 2, -0.12)
    img = np.asarray(render_frame(
        built.render, built.initial_state.world,
        jnp.asarray(cam.view_matrix()), jnp.asarray(cam.proj_matrix(2.0)),
        jnp.asarray(cam.position), width=128, height=64))
    assert img.shape == (64, 128, 4)
    assert tuple(img[0, 0, :3]) == (0x88, 0xAA, 0xFF)     # sky
    ground = img[-1, :, :3].astype(int)
    assert (np.abs(ground - [0x88, 0xAA, 0xFF]).sum(-1) > 30).all()
    # the ground texture (two tile colours with noise) shows through
    assert len(np.unique(ground.reshape(-1, 3), axis=0)) > 4


def test_application_loads_generated_assets(assets):
    from banggameengine_tpu.app.application import Application

    app = Application(assets_root=assets, width=96, height=64)
    assert app.built.find_entity("cj") == 0
    assert app.built.counts["triggers"] == 1
    app.frame(real_dt=2 * app.config.fixed_step)
    assert int(app.state.step_idx) == 2
