"""On-screen debug-text HUD (host-side compositing).

Replaces bgfx's debug-text console (``bgfx::dbgTextPrintf`` HUD at
``Renderer.cpp:540-561``: 10 lines — title, backend, FPS, camera, controls,
light params, input axes/actions, orbit state, raycast result).  The frame
already lives host-side for display, so text compositing happens here with
PIL; colors approximate the reference's 4-bit console palette.
"""

from __future__ import annotations

import numpy as np

# bgfx 4-bit console palette (index -> RGB), as used by dbgTextPrintf colors
PALETTE = {
    0x0A: (85, 255, 85),    # green
    0x0B: (85, 255, 255),   # cyan
    0x0C: (255, 85, 85),    # red
    0x0E: (255, 255, 85),   # yellow
    0x0F: (255, 255, 255),  # white
}


def compose_hud(frame: np.ndarray, lines: list[tuple[int, str]]) -> np.ndarray:
    """Draw HUD text lines onto a uint8[H,W,4] frame.

    ``lines``: list of (bgfx color attribute, text).  Returns a new array.
    """
    try:
        from PIL import Image, ImageDraw
    except ImportError as e:
        raise ImportError("the HUD text overlay needs Pillow") from e

    img = Image.fromarray(frame)
    draw = ImageDraw.Draw(img)
    y = 2
    for attr, text in lines:
        color = PALETTE.get(attr & 0x0F, (255, 255, 255))
        # soft shadow for readability on bright backgrounds
        draw.text((5, y + 1), text, fill=(0, 0, 0))
        draw.text((4, y), text, fill=color)
        y += 12
    return np.asarray(img)


def standard_hud_lines(app) -> list[tuple[int, str]]:
    """The reference's 10-line HUD (Renderer.cpp:540-561), adapted."""
    cam = app.camera.position
    ray = "none"
    if app.last_ray_hit is not None:
        import banggameengine_tpu.physics.raycast as rc

        e = int(app.last_ray_hit.entity)
        if e != rc.NO_HIT:
            ray = f"{app.entity_label(e)} d={float(app.last_ray_hit.distance):.2f}"
    import jax

    return [
        (0x0F, "BangGameEngine-JAX"),
        (0x0A, f"Renderer: jax-{jax.default_backend()}-raster"),
        (0x0B, f"FPS: {app.time.fps:.1f}"),
        (0x0E, f"Camera: ({cam[0]:.1f}, {cam[1]:.1f}, {cam[2]:.1f})"),
        (0x0C, f"Controls: WASD/Mouse, F1=Wireframe({'on' if app.wireframe else 'off'}), "
               f"V=VSync({'on' if app.vsync else 'off'})"),
        (0x0F, f"F3=PhysicsDebug({'on' if app.physics_overlay else 'off'}), "
               "F5=ReloadScene, F9=Stats"),
        (0x0E, f"Axes: F={app.input.get_axis('MoveForward'):+.2f} "
               f"R={app.input.get_axis('MoveRight'):+.2f} "
               f"Jump={'Y' if app.input.action_held('Jump') else 'n'} "
               f"Sprint={'Y' if app.input.action_held('Sprint') else 'n'}"),
        (0x0B, app.orbit.hud_line()),
        (0x0A, f"Raycast down: {ray}"),
        (0x0F, f"Sim t={float(app.state.time):.2f}s steps={int(app.state.step_idx)}"),
    ]
