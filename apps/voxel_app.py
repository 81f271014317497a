#!/usr/bin/env python
"""VoxelApp — the interactive 3D engine demo.

Equivalent of the reference's ``VoxelApp/main.cu``: generate a 1024^3 fBm
terrain world, build the factor-32 brickmap, then run a fly-camera render
loop with WASD+QE movement (LShift-style boost via 'b'), presenting frames
through the native frame sink and reporting an EMA "Avg FPS" like the
reference's window title (``main.cu:170-194``).  Voxel place/break edits
are wired to the crosshair ray ('f' breaks, 'g' places) — the capability
the reference's atomic bit design enables but never binds to input.

Headless-friendly: with no tty it runs a scripted deterministic fly-through
(--frames N) and exits.  View the live frame with any PPM viewer on
``frames/latest.ppm``.
"""

from __future__ import annotations

import argparse
import os
import sys

import jax

if os.environ.get("VOX_CPU") == "1":  # explicit opt-in: run on the CPU
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxelengine_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

from voxelengine_tpu import Environment, RenderConfig, VoxelRaytracer3D
from voxelengine_tpu.config import DebugView, Projection
from voxelengine_tpu.render.camera import get_directions_np
from voxelengine_tpu.io.checkpoint import WORLD_CACHE, generate_or_load
from voxelengine_tpu.core.brickmap import (
    build_brickmap_terrain,
    build_brickmap_terrain_compact,
)
from voxelengine_tpu.ops.traverse import trace_rays
from voxelengine_tpu.render.frame import make_framebuffer, render_frame, to_bgra8
from voxelengine_tpu.runtime.display import Renderer
from voxelengine_tpu.runtime.input import best_input
from voxelengine_tpu.utils.profiling import FrameTimer, timed


def build_world(size, factor, octaves, cache_dir=WORLD_CACHE):
    X, Y, Z = size

    def gen():
        return build_brickmap_terrain(size, factor, octaves=octaves)

    key = f"terrain_{X}x{Y}x{Z}_f{factor}_o{octaves}"
    return generate_or_load(cache_dir, key, gen)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=3, default=[1024, 1024, 1024])
    ap.add_argument("--factor", type=int, default=32)  # main.cu:21
    ap.add_argument("--width", type=int, default=1280)  # main.cu:15
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--octaves", type=int, default=32)
    ap.add_argument("--frames", type=int, default=None,
                    help="frame cap (default: 240 scripted/headless, "
                         "unlimited interactive)")
    ap.add_argument("--debug-view", action="store_true")
    ap.add_argument("--outdir", default="frames")
    ap.add_argument("--record", action="store_true", help="save numbered frames")
    ap.add_argument("--png", action="store_true",
                    help="write PNGs instead of PPMs (native encoder)")
    ap.add_argument("--dense", action="store_true",
                    help="dense-grid world traversed by the single-level DDA")
    ap.add_argument("--ortho", action="store_true",
                    help="orthographic projection (the reference's #define ORTHO); scroll zooms")
    ap.add_argument("--bench-world", choices=["full", "huge"],
                    help="fly the flagship bench world (full = 8k x 512 x 8k;"
                         " huge = 16k x 512 x 16k), built once into the "
                         "repository's .world_cache")
    ap.add_argument("--speed", type=float, default=None,
                    help="fly speed in voxels/keypress (default 2; bench worlds 16)")
    ap.add_argument("--shadows", action="store_true",
                    help="shadow rays toward the light (working version of "
                         "the reference's disabled scaffolding, "
                         "Renderer.cu:102); secondary rays ride the same "
                         "traversal path as the primaries")
    ap.add_argument("--ao", type=int, default=0, metavar="N",
                    help="N hemisphere AO samples/pixel (Renderer.cu:120-165,"
                         " reference ships samples=0)")
    ap.add_argument("--reflections", action="store_true",
                    help="one-bounce mirror reflections (extension beyond "
                         "the reference; reflected rays ride the same "
                         "traversal as the primaries)")
    ap.add_argument("--present-every", type=int, default=1,
                    help="read back + present every Nth frame (the render "
                    "loop stays device-side between presents)")
    args = ap.parse_args()

    bench_dims = None
    if args.bench_world:
        # the flagship bench worlds, flyable: the reference's defining
        # experience (a live fly-camera over its demonstrated 8k terrain,
        # main.cu:170-194) at bench frame rates, from the shared world
        # cache.
        bench_dims = {"full": (8192, 512, 8192),
                      "huge": (16384, 512, 16384)}[args.bench_world]
        key = (f"terrain_{bench_dims[0]}x{bench_dims[1]}x{bench_dims[2]}"
               f"_f32_o32_v1")
        with timed("Voxel generation + buffer generation time") as _t:
            bm = generate_or_load(WORLD_CACHE, key, lambda: (
                build_brickmap_terrain_compact(bench_dims, 32)))
            _t.sync = bm
        rt = VoxelRaytracer3D()
        rt.upload_world(bm)
        grid = None
    elif args.dense:
        from voxelengine_tpu.worldgen.terrain import generate_world

        with timed("Voxel generation time") as _t:
            grid = generate_world(tuple(args.size), octaves=args.octaves)
            _t.sync = grid
        rt = None
    else:
        with timed("Voxel generation + buffer generation time") as _t:  # main.cu:26,32
            bm = build_world(tuple(args.size), args.factor, args.octaves)
            _t.sync = bm
        rt = VoxelRaytracer3D()
        rt.upload_world(bm)

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        debug_view=DebugView.DEBUG if args.debug_view else DebugView.SHADED,
        checkerboard=True,
        projection=Projection.ORTHOGRAPHIC if args.ortho else Projection.PERSPECTIVE,
        tile_order=not args.dense,
        shadow_rays=args.shadows and not args.dense,
        ao_samples=0 if args.dense else args.ao,
        reflections=args.reflections and not args.dense,
    )
    if args.dense and (args.shadows or args.ao or args.reflections):
        # shade_traced skips secondaries without a brickmap — say so
        # instead of silently rendering unshadowed
        print("--shadows/--ao/--reflections ignored: the dense-grid path has"
              " no secondary trace (use the brickmap path)", file=sys.stderr)
    env = Environment.default()  # main.cu:58-63

    renderer = Renderer("voxelengine_tpu")
    mode = (4 | 8 if args.png else 1 | 2) if args.record else (8 if args.png else 2)
    renderer.init(args.width, args.height, 1.0, outdir=args.outdir, mode=mode)

    if bench_dims:
        # on the bench hill, looking across the valley (bench.py camera)
        cam_pos = np.array(
            [bench_dims[0] / 2, 380.0, bench_dims[2] / 2], np.float32
        )
        euler = np.array([-0.25, 0.75, 0.0], np.float32)
    else:
        cam_pos = np.array([256.0, 256.0, 256.0], np.float32)  # main.cu:52
        euler = np.array([0.3, 0.8, 0.0], np.float32)
    fly_speed = args.speed if args.speed is not None else (
        16.0 if bench_dims else 2.0
    )
    fb = make_framebuffer(cfg)
    timer = FrameTimer()
    interactive = sys.stdin.isatty()
    # interactive sessions run until 'quit' unless --frames is given;
    # headless/scripted runs default to a 240-frame fly-through
    nframes = args.frames if args.frames is not None else (
        None if interactive else 240
    )
    src = best_input(
        scripted=None if interactive else
        [["w"] if i % 3 else ["w", "right"] for i in range(nframes)]
    )

    frame = 0
    running = True
    boost = 1.0  # 'b' toggles the reference's LShift x10 speed (main.cu:110-144)

    MOUSE_SENS = 0.004  # rad/px, the reference's drag sensitivity (main.cu:155-156)

    ortho_zoom = np.asarray(cfg.ortho_size, np.float32)  # mutable, traced

    def on_frame(data):
        nonlocal fb, cam_pos, euler, frame, running, boost
        speed = fly_speed * boost
        for ev in src.poll():
            # one camera-basis implementation for rendering AND movement
            # (get_directions already applies the reference's fwd/up
            # negation, Renderer.cu:32-41 — its fwd IS the look direction)
            fwd, _, right = get_directions_np(euler)
            if ev.key == "quit":
                running = False
            elif ev.key == "w":
                cam_pos += fwd * speed
            elif ev.key == "s":
                cam_pos -= fwd * speed
            elif ev.key == "a":
                cam_pos -= right * speed
            elif ev.key == "d":
                cam_pos += right * speed
            elif ev.key == "q":
                cam_pos[1] -= speed
            elif ev.key == "e":
                cam_pos[1] += speed
            elif ev.key == "left":
                euler[1] += 0.04
            elif ev.key == "right":
                euler[1] -= 0.04
            elif ev.key == "up":
                euler[0] -= 0.04
            elif ev.key == "down":
                euler[0] += 0.04
            elif ev.key.startswith("drag:"):
                # mouse-look analog: 'drag:dx,dy' in pixels at the
                # reference's 0.004 rad/px sensitivity (main.cu:149-161)
                dx, dy = (float(v) for v in ev.key[5:].split(","))
                euler[1] -= dx * MOUSE_SENS
                euler[0] -= dy * MOUSE_SENS
            elif ev.key == "b":
                # the reference's LShift x10 speed boost, as a toggle
                # (main.cu:110-144; no key-up events on a tty)
                boost = 10.0 if boost == 1.0 else 1.0
            elif ev.key.startswith("scroll:"):
                # scroll wheel = ortho window zoom +-10 (main.cu:94-107);
                # ortho_zoom is a TRACED render_frame argument, so zooming
                # never recompiles (cfg is a static jit arg)
                dz = float(ev.key[7:])
                ortho_zoom[:] = np.maximum(ortho_zoom - dz * 10.0, 1.0)
            elif ev.key in ("f", "g") and rt is not None and (
                # edits need dense-slot brickmaps (apply_edits* contract);
                # the compact bench worlds can't be edited in place —
                # ignore the key instead of asserting inside the render loop
                rt.world.dense_slots
            ):
                # crosshair voxel break/place
                fwd2, _, _ = get_directions_np(euler)
                res = trace_rays(
                    rt.world, jnp.asarray(cam_pos)[None],
                    jnp.asarray(fwd2)[None], cfg.max_steps
                )
                if bool(res.hit[0]):
                    p = np.asarray(res.position[0])
                    n = np.asarray(res.normal[0])
                    # trace normal points INTO the hit voxel: +0.5n lands in
                    # the hit voxel (break), -0.5n in the face-adjacent air
                    # voxel (place)
                    tgt = p + 0.5 * n if ev.key == "f" else p - 0.5 * n
                    v = np.clip(tgt.astype(int), 0, np.array(rt.world.world_dims) - 1)
                    rt.edit_voxels(
                        jnp.asarray([v[0]]), jnp.asarray([v[1]]), jnp.asarray([v[2]]),
                        ev.key == "g",
                    )

        osz = jnp.asarray(ortho_zoom) if args.ortho else None
        if args.dense:
            from voxelengine_tpu.render.frame import render_frame_dense

            fb = render_frame_dense(
                grid, fb, jnp.asarray(cam_pos), jnp.asarray(euler), env,
                jnp.int32(frame), cfg, ortho_size=osz,
            )
        else:
            fb = render_frame(
                rt.world, fb, jnp.asarray(cam_pos), jnp.asarray(euler), env,
                jnp.int32(frame), cfg, rt.fused_table, ortho_size=osz,
            )
        if frame % args.present_every == 0:
            data.pixels[...] = np.asarray(to_bgra8(fb))
        else:
            # stale staging buffer: skip the sink submit too (no readback
            # AND no re-encode of unchanged bytes)
            data.present = False
        frame += 1
        ema = timer.tick()
        if frame % 10 == 0:
            print(f"[{frame}] Avg FPS: {timer.fps:.1f} ({ema:.2f} ms)")

    renderer.add_render_event_callback(on_frame)
    try:
        while running and (nframes is None or frame < nframes):
            renderer.render()
    finally:
        try:
            renderer.close()
        finally:
            if hasattr(src, "close"):
                src.close()  # restore the tty even if the sink close raises
    print(f"presented {renderer.frames_presented} frames")


if __name__ == "__main__":
    main()
