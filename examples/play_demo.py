#!/usr/bin/env python
"""Run the SandboxCity demo headless and record frames.

Equivalent of launching the reference executable: loads
``assets/scenes/demo.json``, runs the fixed-step loop with a scripted input
track (fall, walk to the checkpoint, jump), logs the HUD/status lines and
trigger events, and writes PNG frames.

    python examples/play_demo.py --seconds 8 --record /tmp/demo_frames
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--assets", default=os.environ.get("BANG_ASSETS_DIR"),
                   help="asset root (default: the demo scene generated "
                        "from seed 0 under build/)")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--record", default=None, help="PNG output directory")
    p.add_argument("--overlay", action="store_true", help="physics debug overlay")
    p.add_argument("--platform", default=None, help="cpu|gpu (default: auto)")
    p.add_argument("--fused", action=__import__("argparse").BooleanOptionalAction,
                   default=True,
                   help="drive the fused interactive tick (substeps + frame "
                        "in queued dispatches; events carried back) — the "
                        "default production path; --no-fused keeps separate "
                        "step/render dispatches (overlay, HUD raycast, "
                        "interpolated render states)")
    args = p.parse_args()

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import numpy as np

    from banggameengine_tpu.app import Application
    from banggameengine_tpu.app.window import HeadlessWindow

    if args.assets is None:
        from banggameengine_tpu.scene.synthetic import demo_assets_dir

        args.assets = demo_assets_dir(0)
    window = HeadlessWindow(args.width, args.height, record_dir=args.record)
    # the debug overlay renders through the separate step/render path
    fused = args.fused and not args.overlay
    app = Application(assets_root=args.assets, width=args.width,
                      height=args.height, fused_tick=fused)
    app.physics_overlay = args.overlay

    cj = app.built.find_entity("cj")
    total = int(args.seconds * args.fps)
    for i in range(total):
        t = i / args.fps
        src = app.input.source
        # scripted track: idle 2 s (fall+land), then walk toward the
        # checkpoint, sprint after 5 s, jump at 6 s
        if t < 2.0:
            src.release("W", "LEFT_SHIFT", "SPACE")
        elif t < 5.0:
            src.press("W")
            d = np.array([5.0, 5.0]) - np.asarray(app.state.pos[cj, [0, 2]])
            app.camera.set_yaw_pitch(float(np.arctan2(d[1], d[0])),
                                     app.camera.pitch)
        elif t < 6.0:
            src.press("LEFT_SHIFT")
        else:
            src.press("SPACE") if (i % args.fps) == 0 else src.release("SPACE")

        app.frame(real_dt=1.0 / args.fps)
        if args.fused:
            if args.record and app.last_frame_image is not None:
                window.present(app.last_frame_image)
        elif args.record or args.overlay:
            window.present(app.render_current_frame(hud=True))

    print(app.status_line())
    print(app.physics_stats())
    print(f"trigger events: {[(e.phase.value, app.entity_label(e.other_entity)) for e in app._trigger_log]}")
    if args.record:
        print(f"frames written to {args.record}")


if __name__ == "__main__":
    main()
