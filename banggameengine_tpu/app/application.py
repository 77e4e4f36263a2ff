"""Application shell: the host game loop around the jitted engine.

Re-design of ``src/core/Application.{h,cpp}`` and ``src/main.cpp``: owns one
of every subsystem, runs the fixed-timestep accumulator loop
(``Application.cpp:97-101``), services hotkeys, hot-reloads the three JSON
configs, dispatches trigger events from the device step to the EventBus, and
keeps the 0.5-second status HUD (``:104-123``).

Headless-first: ``run(max_frames)`` drives scripted/offline simulation;
``render_current_frame()`` produces the framebuffer for display or capture.
Hotkeys arrive through the InputSystem actions so a scripted source can
drive them deterministically (F-keys map to the reference bindings:
F1 wireframe, F3 physics overlay, F5 scene reload, F9 stats, V vsync).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import jax.numpy as jnp

from banggameengine_tpu.app.events import EventBus, TriggerEvent, dispatch_step_events
from banggameengine_tpu.app.input import InputSystem, ScriptedInputSource
from banggameengine_tpu.app.orbit import CameraOrbitController
from banggameengine_tpu.app.timing import Time
from banggameengine_tpu.engine import make_hot_reloadable_step_fn
from banggameengine_tpu.physics import raycast as rc
from banggameengine_tpu.physics.config import PhysicsConfig, load_physics_config
from banggameengine_tpu.render.camera import Camera
from banggameengine_tpu.render.pipeline import make_render_fn
from banggameengine_tpu.render.shading import LightParams
from banggameengine_tpu.scene import ResourceManager, build_scene, parse_scene_json
from banggameengine_tpu.state import COMP_CHARACTER, COMP_COLLIDER, InputFrame

log = logging.getLogger("App")


class Application:
    def __init__(
        self,
        assets_root: str | None = None,
        scene_path: str = "scenes/demo.json",
        width: int = 1280,
        height: int = 720,
        input_source=None,
        fused_tick: bool = False,
    ):
        self.width = width
        self.height = height
        # fused_tick=True drains the accumulator through make_frame_fn
        # (substeps + shaded frame in queued device dispatches, trigger
        # events carried back) — the production interactive path; the
        # default keeps separate step/render dispatches (overlay/HUD
        # flexibility, per-substep orbit updates)
        self.fused_tick = fused_tick
        self._frame_fns: dict = {}
        self.last_frame_image: np.ndarray | None = None
        self.resources = ResourceManager(assets_root)
        root = self.resources.get_assets_root()
        self.scene_path = os.path.join(root, scene_path)
        self.physics_config_path = os.path.join(root, "config/physics.json")
        self.camera_config_path = os.path.join(root, "config/camera.json")
        self.bindings_path = os.path.join(root, "input/bindings.json")

        self.time = Time()
        self.bus = EventBus()
        self.input = InputSystem(input_source or ScriptedInputSource())
        self.input.load_bindings(self.bindings_path)

        self.camera = Camera()
        self.orbit = CameraOrbitController(self.camera, self.input)
        self.orbit.load_config(self.camera_config_path)

        self.config = load_physics_config(self.physics_config_path)
        self.built = None
        self.state = None
        self._step = make_hot_reloadable_step_fn()
        self._render = None
        self.light = LightParams.default()

        # toggles (Application.cpp hotkeys)
        self.wireframe = False
        self.physics_overlay = False
        self.vsync = True

        self._accumulator = 0.0
        self._status_timer = 0.0
        self.frame_count = 0
        self.last_status = ""
        self.last_ray_hit = None
        self._trigger_log: list[TriggerEvent] = []

        self.bus.subscribe(TriggerEvent, self._on_trigger_event)
        self.reload_scene("initial")

        # publish the global facade (Physics::SetActiveSystem,
        # PhysicsAPI.cpp:8-16)
        from banggameengine_tpu.physics import api as physics_api

        physics_api.set_active_system(self)

    # ------------------------------------------------------------------
    # scene / config management
    # ------------------------------------------------------------------
    def reload_scene(self, tag: str) -> bool:
        """Parse + build the scene; on failure keep the current one
        (SceneLoader.cpp:688-742 atomic swap)."""
        try:
            desc = parse_scene_json(self.scene_path)
            built = build_scene(desc, self.resources, self.config)
        except Exception as e:
            log.warning("[App] scene reload failed (%s); keeping current", e)
            return False
        self.built = built
        self.state = built.initial_state
        self._render = None  # lazily rebuilt (render scene changed)
        self._frame_fns = {}  # fused ticks capture the old built's arrays
        self.orbit.on_scene_reloaded()
        log.info(
            "[App] scene %s: %d entities, %d renderers, %d colliders",
            tag, built.counts["entities"], built.counts["mesh_renderers"],
            built.counts["colliders"],
        )
        self.resources.print_stats()
        return True

    def reload_physics_config_if_needed(self) -> bool:
        try:
            m = os.path.getmtime(self.physics_config_path)
        except OSError:
            return False
        if m <= self.config.mtime:
            return False
        self.config = load_physics_config(self.physics_config_path, self.config)
        # rebuild static scene with same shapes -> no recompile
        try:
            desc = parse_scene_json(self.scene_path)
            rebuilt = build_scene(desc, self.resources, self.config,
                                  capacity=self.built.static.capacity)
            self.built.static = rebuilt.static
            for fn in self._frame_fns.values():
                fn.update_static(rebuilt.static)  # no recompile (same shapes)
            log.info("[Physics] config hot-reloaded")
            return True
        except Exception as e:
            log.warning("[Physics] config reload failed: %s", e)
            return False

    # ------------------------------------------------------------------
    # loop
    # ------------------------------------------------------------------
    def run(self, max_frames: int | None = None) -> None:
        """Fixed-timestep accumulator loop (Application.cpp:75-151)."""
        while max_frames is None or self.frame_count < max_frames:
            self.frame()

    def frame(self, real_dt: float | None = None) -> None:
        dt = self.time.tick() if real_dt is None else real_dt
        dt = min(dt, 0.25)  # avoid spiral of death after pauses

        self.input.reload_if_changed()
        self.input.update()
        self.orbit.reload_config_if_needed()
        self.reload_physics_config_if_needed()
        self._handle_hotkeys()
        self._handle_light_keys(dt)

        fixed = self.config.fixed_step
        self._accumulator += dt
        if self.fused_tick:
            # drain up to 4 substeps through the fused interactive tick
            # (stepSimulation(dt, maxSubsteps=4, fixedStep) semantics,
            # PhysicsSystem.cpp:848-875)
            n = min(int(self._accumulator / fixed), 4)
            if n > 0:
                self._fused_frame(n, fixed)
                self._accumulator -= n * fixed
        else:
            while self._accumulator >= fixed:
                self.update(fixed)
                self._accumulator -= fixed

        self._status_timer += dt
        if self._status_timer >= 0.5:
            self._status_timer = 0.0
            self.last_status = self.status_line()
            log.info(self.last_status)
        self.frame_count += 1

    def _fused_frame(self, substeps: int, fixed_dt: float) -> None:
        """Drain ``substeps`` fixed steps + render one shaded frame via the
        event-carrying fused tick (one make_frame_fn call, two queued
        device dispatches), then dispatch the per-substep trigger events.
        """
        from banggameengine_tpu.render.pipeline import make_frame_fn

        target = self.built.find_entity(self.orbit.target_id)
        self.orbit.update(substeps * fixed_dt, self.state.world, target)

        key = (substeps,)
        if key not in self._frame_fns:
            self._frame_fns[key] = make_frame_fn(
                self.built, self.width, self.height, substeps=substeps)
        inp = InputFrame(
            move_forward=jnp.float32(self.input.get_axis("MoveForward")),
            move_right=jnp.float32(self.input.get_axis("MoveRight")),
            jump=jnp.asarray(self.input.action_pressed("Jump")),
            sprint=jnp.asarray(self.input.action_held("Sprint")),
            cam_yaw=jnp.float32(self.camera.yaw),
        )
        view = jnp.asarray(self.camera.view_matrix())
        proj = jnp.asarray(self.camera.proj_matrix(self.width / self.height))
        self.state, img, events = self._frame_fns[key](
            self.state, inp, view, proj, jnp.asarray(self.camera.position),
            self.light,
        )
        self.last_frame_image = np.asarray(img)
        te = self.built.static.trig_entity
        if substeps == 1:
            dispatch_step_events(self.bus, events, te)
        else:
            import jax

            for i in range(substeps):
                dispatch_step_events(
                    self.bus, jax.tree.map(lambda a: a[i], events), te)

    def update(self, fixed_dt: float) -> None:
        """One fixed step: orbit -> device step -> events -> HUD raycast."""
        target = self.built.find_entity(self.orbit.target_id)
        self.orbit.update(fixed_dt, self.state.world, target)

        inp = InputFrame(
            move_forward=jnp.float32(self.input.get_axis("MoveForward")),
            move_right=jnp.float32(self.input.get_axis("MoveRight")),
            # pressed-edge, not held: the reference jumps via action edge and
            # Bullet's canJump latch; edge avoids continuous hopping
            jump=jnp.asarray(self.input.action_pressed("Jump")),
            sprint=jnp.asarray(self.input.action_held("Sprint")),
            cam_yaw=jnp.float32(self.camera.yaw),
        )
        self._prev_state = self.state  # motion-state interpolation source
        self.state, events = self._step(self.state, inp, self.built.static)
        self._last_events = events  # F9 reads contact_overflow lazily
        dispatch_step_events(self.bus, events, self.built.static.trig_entity)

        # per-frame downward raycast HUD line (Application.cpp:258-277)
        s = self.built.static
        hit = rc.raycast_closest(
            jnp.asarray(self.camera.position),
            jnp.asarray([0.0, -1.0, 0.0], jnp.float32),
            jnp.float32(200.0), jnp.uint32(1),
            self.state.pos, self.state.quat, s.shape_type, s.shape_size,
            s.layer, self.state.alive,
            (self.state.comp_mask & (COMP_COLLIDER | COMP_CHARACTER)) != 0,
        )
        self.last_ray_hit = hit

    def _handle_light_keys(self, dt: float) -> None:
        """Continuous light controls (Application.cpp:218-245): arrows
        rotate the light, Z/X ambient, C/V spec intensity, B/N shininess,
        R resets to defaults."""
        import dataclasses
        import math

        keys = {k.upper() for k in self.input.source.keys_down()}
        rot = math.radians(90.0) * dt
        lp = self.light
        upd = {}
        if "LEFT" in keys:
            upd["yaw"] = lp.yaw - rot
        if "RIGHT" in keys:
            upd["yaw"] = lp.yaw + rot
        if "UP" in keys:
            upd["pitch"] = lp.pitch - rot * 0.5
        if "DOWN" in keys:
            upd["pitch"] = lp.pitch + rot * 0.5
        if "Z" in keys:
            upd["ambient"] = jnp.clip(lp.ambient - 0.8 * dt, 0.0, 1.0)
        if "X" in keys:
            upd["ambient"] = jnp.clip(lp.ambient + 0.8 * dt, 0.0, 1.0)
        if "C" in keys:
            upd["spec_intensity"] = jnp.clip(lp.spec_intensity - 1.2 * dt, 0.0, 4.0)
        if "V" in keys:
            upd["spec_intensity"] = jnp.clip(lp.spec_intensity + 1.2 * dt, 0.0, 4.0)
        if "B" in keys:
            upd["shininess"] = jnp.clip(lp.shininess - 128.0 * dt, 1.0, 1024.0)
        if "N" in keys:
            upd["shininess"] = jnp.clip(lp.shininess + 128.0 * dt, 1.0, 1024.0)
        if "R" in keys and not getattr(self, "_light_r_latch", False):
            self.light = LightParams.default()
            self._light_r_latch = True
            return
        self._light_r_latch = "R" in keys
        if upd:
            self.light = dataclasses.replace(lp, **{
                k: jnp.float32(v) for k, v in upd.items()
            })

    def _handle_hotkeys(self) -> None:
        src_keys = {k.upper() for k in self.input.source.keys_down()}
        # edge-latch F-keys through simple held tracking in the input system
        # by defining pseudo-actions when bindings lack them
        for key, attr in (("F1", "wireframe"), ("F3", "physics_overlay"),
                          ("V", "vsync")):
            action = f"__{key}"
            if action not in self.input._actions:
                from banggameengine_tpu.app.input import AxisBinding

                self.input._actions[action] = [AxisBinding("key", key)]
                from banggameengine_tpu.app.input import ActionState

                self.input._action_states[action] = ActionState()
        if self.input.action_pressed("__F1"):
            self.wireframe = not self.wireframe
        if self.input.action_pressed("__F3"):
            self.physics_overlay = not self.physics_overlay
        if self.input.action_pressed("__V"):
            self.vsync = not self.vsync
        if "F5" in src_keys and not getattr(self, "_f5_latch", False):
            self.reload_scene("reloaded")
        self._f5_latch = "F5" in src_keys
        if "F9" in src_keys and not getattr(self, "_f9_latch", False):
            log.info(self.physics_stats())
            log.info(self.resources.print_stats())
        self._f9_latch = "F9" in src_keys

    # ------------------------------------------------------------------
    # events / reporting
    # ------------------------------------------------------------------
    def _on_trigger_event(self, ev: TriggerEvent) -> None:
        """Console messages for trigger events (Application.cpp:365-381).

        The bus carries Enter/Stay/Exit like the reference's; the app — like
        the reference app — only reacts to Enter/Exit (Stay fires every tick
        while overlapping).
        """
        from banggameengine_tpu.app.events import TriggerPhase

        if ev.phase is TriggerPhase.STAY:
            return
        self._trigger_log.append(ev)
        name = self.entity_label(ev.trigger_entity)
        other = self.entity_label(ev.other_entity)
        log.info("[Trigger] %s: %s <- %s", ev.phase.value, name, other)

    def entity_label(self, entity: int) -> str:
        """Application::GetEntityLabel (Application.cpp:383-399)."""
        if self.built and 0 <= entity < len(self.built.entity_names):
            return f"{self.built.entity_names[entity]}#{entity}"
        return f"entity#{entity}"

    def status_line(self) -> str:
        c = self.built.counts
        ray = ""
        if self.last_ray_hit is not None and int(self.last_ray_hit.entity) != rc.NO_HIT:
            ray = (f" ray={self.entity_label(int(self.last_ray_hit.entity))}"
                   f"@{float(self.last_ray_hit.distance):.2f}")
        return (
            f"[App] fps={self.time.fps:.1f} frame={self.frame_count} "
            f"t={float(self.state.time):.2f}s entities={c['entities']} "
            f"renderers={c['mesh_renderers']}{ray} {self.orbit.hud_line()}"
        )

    def physics_stats(self) -> str:
        """F9 stats (PhysicsSystem.cpp:1330-1341)."""
        c = self.built.counts
        ovf = ""
        ev = getattr(self, "_last_events", None)
        if ev is not None and hasattr(ev, "contact_overflow"):
            import numpy as _np

            n = int(_np.asarray(ev.contact_overflow).sum())
            ovf = f" contactOverflow={n}"
        return (
            f"[Physics] bodies={c['rigid_bodies']} colliders={c['colliders']} "
            f"characters={c['characters']} triggers={c['triggers']} "
            f"fixedStep={self.config.fixed_step:.6f} "
            f"steps={int(self.state.step_idx)}{ovf}"
        )

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    def render_current_frame(self, hud: bool = False) -> np.ndarray:
        """uint8[H,W,4] frame of the current state.

        When ``physics_overlay`` is on (F3), collision-shape wireframes are
        composited with depth test (the reference's debug-line pass,
        ``Application.cpp:359-360``); ``hud=True`` adds the debug-text HUD.
        """
        if self._render is None:
            self._render = {}
        view = self.camera.view_matrix()
        proj = self.camera.proj_matrix(self.width / self.height)
        # render Bullet-style interpolated motion states: the accumulator
        # remainder blends the last two fixed steps so display frames
        # between 120 Hz sim ticks are smooth (PhysicsSystem.cpp:848-875).
        # The blend runs INSIDE the render dispatch (make_interp_render_fn)
        # — a separate interpolation executable would add a dependent
        # program pair per frame.
        prev = getattr(self, "_prev_state", None)
        interp = prev is not None and self.config.fixed_step > 0
        key = (bool(self.wireframe), interp)
        if key not in self._render:
            from banggameengine_tpu.render.pipeline import (
                make_interp_render_fn,
            )

            factory = make_interp_render_fn if interp else make_render_fn
            self._render[key] = factory(
                self.built.render, self.width, self.height,
                bin_capacity=2048, return_depth=True, wireframe=key[0],
            )
        if interp:
            alpha = min(max(self._accumulator / self.config.fixed_step,
                            0.0), 1.0)
            frame, depth = self._render[key](
                prev, self.state, alpha, self.built.static, view, proj,
                jnp.asarray(self.camera.position), self.light,
            )
        else:
            frame, depth = self._render[key](
                self.state.world, view, proj,
                jnp.asarray(self.camera.position), self.light,
            )
        if self.physics_overlay:
            from banggameengine_tpu.physics.debugdraw import collision_shape_lines
            from banggameengine_tpu.render.lines import draw_lines

            pts, cols, valid = collision_shape_lines(self.state, self.built.static)
            frame = draw_lines(frame, depth, pts, cols, valid, view, proj)
        out = np.asarray(frame)
        if hud:
            from banggameengine_tpu.app.hud import compose_hud, standard_hud_lines

            out = compose_hud(out, standard_hud_lines(self))
        return out
