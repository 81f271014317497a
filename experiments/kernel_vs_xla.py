#!/usr/bin/env python
"""Time the per-block traversal kernel against the XLA traversals on a GPU.

Traversal level: the same rays through ``trace_brickmap`` (one
``while_loop`` over the whole batch), ``trace_brickmap_staged`` (the same
with straggler compaction) and ``trace_brickmap_kernel``, on the primary
rays of a frame and on a batch of random rays.  Checks the kernel's hits,
positions, normals and step counts against ``trace_brickmap`` on the same
card, and prints one JSON line per measurement to stdout.

    python experiments/kernel_vs_xla.py --world small   # 1024^3, 1280x720
    python experiments/kernel_vs_xla.py --world full    # 8192x512x8192, 1080p

End to end (``--e2e``): median ``render_frame`` time of the world's frame
through each traversal (the engine's GPU entry rerouted for the XLA
variants), with and without pixel-block ray order, after warm-up.

Needs a GPU (it exits non-zero without one).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def median_ms(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), [round(t, 3) for t in ts]


def compare(ref, out):
    hr, ho = np.asarray(ref.hit), np.asarray(out.hit)
    both = hr & ho
    pr, po = np.asarray(ref.position)[both], np.asarray(out.position)[both]
    nr, no = np.asarray(ref.normal)[both], np.asarray(out.normal)[both]
    return dict(
        rays=int(hr.size),
        hit_diffs=int((hr != ho).sum()),
        steps_diffs=int((np.asarray(ref.steps) != np.asarray(out.steps)).sum()),
        pos_diffs=int((pr != po).any(axis=1).sum()),
        pos_max_abs=float(np.abs(pr - po).max()) if pr.size else 0.0,
        normal_diffs=int((nr != no).any(axis=1).sum()),
    )


def end_to_end(bm, w, h, origin, euler, reps):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from voxelengine_tpu.config import Environment, RenderConfig
    from voxelengine_tpu.ops import traverse
    from voxelengine_tpu.ops.trace import trace_brickmap_staged
    from voxelengine_tpu.render.frame import make_framebuffer, render_frame

    env = Environment.default()
    o = jnp.asarray(origin, jnp.float32)
    e = jnp.asarray(euler, jnp.float32)
    kernel = traverse.TRAVERSALS["gpu"]
    routes = {
        "kernel": kernel,
        "xla_plain": traverse.TRAVERSALS["cpu"],
        "xla_staged": (
            lambda bm, o, d, ms, fused: trace_brickmap_staged(bm, o, d, ms),
            traverse.TRAVERSALS["cpu"][1],
        ),
    }
    for name, fns in routes.items():
        traverse.TRAVERSALS["gpu"] = fns
        jax.clear_caches()
        for tile_order in ((False, True) if name == "kernel" else (True,)):
            for shading in ("primary", "full"):
                cfg = RenderConfig(width=w, height=h, checkerboard=True,
                                   tile_order=tile_order)
                if shading == "full":
                    cfg = dataclasses.replace(cfg, shadow_rays=True,
                                              ao_samples=4, reflections=True)

                def frame():
                    return render_frame(bm, make_framebuffer(cfg), o, e, env,
                                        jnp.int32(1), cfg)

                t0 = time.perf_counter()
                jax.block_until_ready(frame())
                first = time.perf_counter() - t0
                t, ts = median_ms(frame, reps if shading == "primary" else 3)
                emit(phase="frame", traversal=name, tile_order=tile_order,
                     shading=shading, first_s=first, median_ms=t, ms=ts)
    traverse.TRAVERSALS["gpu"] = kernel
    jax.clear_caches()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", choices=["small", "full"], default="small")
    ap.add_argument("--rays", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--blocks", default="32,64,128")
    ap.add_argument("--e2e", action="store_true",
                    help="also time render_frame through each traversal")
    ap.add_argument("--trace-level", type=int, default=1,
                    help="0 skips the traversal-level timings")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        log("no GPU found")
        sys.exit(2)
    from voxelengine_tpu.config import RenderConfig
    from voxelengine_tpu.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu.ops import trace_kernel as K
    from voxelengine_tpu.ops.trace import trace_brickmap, trace_brickmap_staged
    from voxelengine_tpu.render.frame import primary_rays

    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    emit(platform=dev.platform, kind=dev.device_kind, count=len(jax.devices()),
         nvidia_smi=smi)

    dims, w, h = {
        "small": ((1024, 1024, 1024), 1280, 720),
        "full": ((8192, 512, 8192), 1920, 1080),
    }[args.world]
    t0 = time.perf_counter()
    bm = build_brickmap_terrain_compact(dims, 32)
    jax.block_until_ready(bm)
    emit(phase="world_build", world=dims, seconds=time.perf_counter() - t0,
         brick_bytes=int(bm.bricks.nbytes))

    if args.world == "small":
        origin, euler = (256.0, 256.0, 256.0), (0.3, 0.8, 0.0)
    else:
        origin, euler = (dims[0] / 2, 380.0, dims[2] / 2), (-0.25, 0.75, 0.0)
    sets = {}
    for tile_order in (False, True):
        cfg = RenderConfig(width=w, height=h, checkerboard=True,
                           tile_order=tile_order)
        o, d, *_ = primary_rays(cfg, jnp.asarray(origin, jnp.float32),
                                jnp.asarray(euler, jnp.float32), jnp.int32(1))
        sets[f"primary_tile{int(tile_order)}"] = (o, d)
    r = np.random.default_rng(0)
    W = np.asarray(bm.world_dims, np.float32)
    ro = (r.random((args.rays, 3)) * W).astype(np.float32)
    ro[:, 1] = r.uniform(0, W[1], args.rays)
    rt = (r.random((args.rays, 3)) * W).astype(np.float32)
    sets["random"] = (jnp.asarray(ro), jnp.asarray(rt - ro))

    ms = 2048
    block0 = (K.BLOCK, K.NUM_WARPS)
    for name, (o, d) in (sets.items() if args.trace_level else ()):
        ref = trace_brickmap(bm, o, d, ms)
        steps = np.asarray(ref.steps)
        emit(phase="rays", set=name, n=int(steps.size),
             hit_rate=float(np.asarray(ref.hit).mean()),
             steps_mean=float(steps.mean()),
             steps_p99=float(np.percentile(steps, 99)),
             steps_max=int(steps.max()))
        t, ts = median_ms(lambda: trace_brickmap(bm, o, d, ms), args.reps)
        emit(phase="time", set=name, traversal="xla_plain", median_ms=t, ms=ts)
        t, ts = median_ms(lambda: trace_brickmap_staged(bm, o, d, ms), args.reps)
        emit(phase="time", set=name, traversal="xla_staged", median_ms=t, ms=ts)
        for blk in [int(b) for b in args.blocks.split(",")]:
            K.BLOCK, K.NUM_WARPS = blk, max(1, blk // 32)
            K.advance_kernel.clear_cache()
            K.trace_brickmap_kernel.clear_cache()
            try:
                out = K.trace_brickmap_kernel(bm, o, d, ms)
                emit(phase="parity", set=name, block=blk, **compare(ref, out))
                t, ts = median_ms(
                    lambda: K.trace_brickmap_kernel(bm, o, d, ms), args.reps
                )
                emit(phase="time", set=name, traversal=f"kernel_b{blk}",
                     median_ms=t, ms=ts)
            except Exception as e:  # report and go on to the next variant
                emit(phase="error", set=name, block=blk,
                     error=f"{type(e).__name__}: {str(e)[:2000]}")
    if args.e2e:
        K.BLOCK, K.NUM_WARPS = block0
        K.advance_kernel.clear_cache()
        K.trace_brickmap_kernel.clear_cache()
        end_to_end(bm, w, h, origin, euler, args.reps)
    stats = dev.memory_stats() or {}
    emit(phase="memory", peak_bytes=stats.get("peak_bytes_in_use"))


if __name__ == "__main__":
    main()
