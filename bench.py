#!/usr/bin/env python
"""Benchmark harness: primary-ray throughput of full frames on one GPU.

Renders the 8192 x 512 x 8192 flagship world (factor 32, the reference's
own terrain rule bit-for-bit) at 1080p with checkerboarding through
``render_frame``, whose traversal is the platform's
(:func:`voxelengine_tpu.ops.traverse.trace_rays`: the per-block kernel on a
GPU).  Every run verifies that the traversal's hits equal the plain
full-budget XLA traversal's on a full frame of rays, and fails before
printing a result if they do not.

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "Mrays/s", "device": {...}, ...}
Diagnostics, including the device and ``nvidia-smi``'s name and power
limit, go to stderr.

Env knobs:
  BENCH_WORLD=small    1024^3 world (the reference's demo world; with
                       BENCH_W=1280 BENCH_H=720 its demo config, main.cu:15-23)
  BENCH_WORLD=huge     16384 x 512 x 16384 (2x the reference's demo world)
  BENCH_FRAMES=N       timed frames per batch (default 8)
  BENCH_W/BENCH_H      render resolution (default 1920x1080)
  BENCH_SHADOWS=1      shadow rays (working version of the reference's
                       disabled scaffolding, Renderer.cu:102)
  BENCH_AO=N           N hemisphere AO samples/pixel (Renderer.cu:120-165,
                       reference ships with samples=0)
  BENCH_REFLECT=1      one-bounce mirror reflections (extension beyond the
                       reference).  The shading knobs change the metric name
                       so the row is never confused with the primary-ray
                       headline
  BENCH_ALLOW_CPU=1    rehearse on the CPU: runs every step, checks
                       exactness, and prints no device metric
  BENCH_PROFILE=dir    capture a jax.profiler trace of the timed batch
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def require_gpu() -> bool:
    """Exit non-zero unless JAX's default backend is a GPU.  Returns True
    for a CPU rehearsal (``BENCH_ALLOW_CPU=1``), which reports no device
    metric."""
    import jax

    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if os.environ.get("BENCH_ALLOW_CPU") == "1":
        log(f"rehearsal on {backend}: no device metric is reported")
        return True
    log(f"FATAL: no GPU (JAX backend is {backend!r}); "
        "set BENCH_ALLOW_CPU=1 for a CPU rehearsal")
    sys.exit(3)


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def nvidia_smi() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from voxelengine_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    rehearsal = require_gpu()

    import jax
    import jax.numpy as jnp

    from voxelengine_tpu.config import Environment, RenderConfig
    from voxelengine_tpu.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu.io.checkpoint import WORLD_CACHE, generate_or_load
    from voxelengine_tpu.ops.trace import trace_brickmap
    from voxelengine_tpu.ops.traverse import trace_rays
    from voxelengine_tpu.render.frame import (
        make_framebuffer,
        primary_rays,
        render_frame,
    )

    device = device_info()
    log(f"device: {device}; nvidia-smi: {nvidia_smi()}")
    world = os.environ.get("BENCH_WORLD", "full")
    dims = {"small": (1024, 1024, 1024),
            "full": (8192, 512, 8192),
            "huge": (16384, 512, 16384)}[world]
    frames = int(os.environ.get("BENCH_FRAMES", "8"))

    t0 = time.perf_counter()
    # disk-cached world: the cache key pins dims/factor/octaves; worldgen is
    # deterministic and bit-exact (verified against the golden C++
    # generator in tests)
    key = f"terrain_{dims[0]}x{dims[1]}x{dims[2]}_f32_o32_v1"
    if os.environ.get("BENCH_WORLD_CACHE", "1") == "1":
        bm = generate_or_load(WORLD_CACHE, key,
                              lambda: build_brickmap_terrain_compact(dims, 32))
    else:
        bm = build_brickmap_terrain_compact(dims, 32)
    bm.meta.block_until_ready()
    log(f"world {dims} compact build/load: {time.perf_counter()-t0:.1f}s; "
        f"bricks {bm.bricks.shape} ({bm.bricks.nbytes/1e9:.2f} GB on device)")

    cfg = RenderConfig(
        width=int(os.environ.get("BENCH_W", "1920")),
        height=int(os.environ.get("BENCH_H", "1080")),
        checkerboard=True,
        tile_order=True,
        shadow_rays=os.environ.get("BENCH_SHADOWS", "0") == "1",
        ao_samples=int(os.environ.get("BENCH_AO", "0")),
        reflections=os.environ.get("BENCH_REFLECT", "0") == "1",
    )
    env = Environment.default()
    # camera on a terrain hill looking across the valley
    origin = jnp.asarray((dims[0] / 2, 380.0, dims[2] / 2), jnp.float32)
    euler = jnp.asarray((-0.25, 0.75, 0.0), jnp.float32)
    rays_per_frame = cfg.width * cfg.height // 2  # checkerboard half-field

    fb = make_framebuffer(cfg)
    t0 = time.perf_counter()
    fb = render_frame(bm, fb, origin, euler, env, jnp.int32(0), cfg)
    fb.block_until_ready()
    log(f"first frame (compile+run): {time.perf_counter()-t0:.1f}s")

    # chained frame loop: frame k+1 consumes frame k's framebuffer, so all
    # frames must execute; a single final read-back per batch measures
    # sustained throughput, like a real render loop.  Every frame is
    # distinct (monotonic frame number + a ~1e-5 rad/frame camera drift,
    # like a fly-camera loop).
    def batch(first, count):
        t0 = time.perf_counter()
        for i in range(first, first + count):
            e = euler + jnp.float32(1e-5) * i
            batch.fb = render_frame(
                bm, batch.fb, origin, e, env, jnp.int32(i), cfg
            )
        # a checksum read-back ends the batch: the value has to exist
        batch.checksum = float(jnp.sum(batch.fb))
        return (time.perf_counter() - t0) * 1000.0 / count

    batch.fb = fb
    warm = min(3, frames)
    warm_ms = batch(1, warm)
    if not rehearsal:  # a CPU time is not a device time: keep it unsaid
        log(f"warmup batch ({warm}): {warm_ms:.1f} ms/frame")
    prof_dir = os.environ.get("BENCH_PROFILE", "")
    if prof_dir:  # capture a device trace of the timed batch
        with jax.profiler.trace(prof_dir):
            frame_ms = batch(warm + 1, frames)
        times = [frame_ms]
        log(f"profiler trace written to {prof_dir}")
    else:
        # best-of-N batches; each batch alone is a valid measurement
        n_batches = int(os.environ.get("BENCH_BATCHES", "3"))
        times = []
        first = warm + 1
        for b in range(n_batches):
            times.append(batch(first, frames))
            first += frames
        frame_ms = min(times)
        if not rehearsal:
            log("batches: " + " ".join(f"{t:.1f}" for t in times)
                + " ms/frame")
    log(f"frame checksum {batch.checksum:.1f}")
    mrays = rays_per_frame / frame_ms / 1000.0

    # exactness gate: the frame's traversal must reproduce the plain
    # full-budget XLA traversal's hits on a full frame of rays
    o, d, *_ = primary_rays(cfg, origin, euler, jnp.int32(1))
    got = trace_rays(bm, o, d, cfg.max_steps)
    ref = trace_brickmap(bm, o, d, cfg.max_steps)
    diffs = int((np.asarray(ref.hit) != np.asarray(got.hit)).sum())
    steps = np.asarray(got.steps)
    log(f"hit-rate {np.asarray(ref.hit).mean():.3f}  "
        f"traversal-vs-plain-XLA hit diffs {diffs}/{steps.size}  "
        f"steps mean {steps.mean():.1f} p99 {np.percentile(steps,99):.0f}")
    if diffs > steps.size // 10000:
        # a fast-but-wrong traversal is not a benchmark result: fail the
        # run BEFORE the JSON line is printed
        log(f"FATAL: hit diffs above 0.01% tolerance ({diffs}/{steps.size})")
        sys.exit(4)
    if rehearsal:
        print(json.dumps({"rehearsal": device["platform"], "exact": True,
                          "hit_diffs": diffs, "rays": int(steps.size)}))
        return
    log(f"frame: {frame_ms:.1f} ms  ({1000/frame_ms:.2f} FPS)")
    shading = ""
    if cfg.shadow_rays:
        shading += "_shadows"
    if cfg.ao_samples:
        shading += f"_ao{cfg.ao_samples}"
    if cfg.reflections:
        shading += "_refl"
    metric = (f"primary_mrays_per_s_{cfg.height}p_checkerboard_"
              + {"small": "1k", "full": "8k", "huge": "16k"}[world]
              + "_world" + shading)
    print(json.dumps({
        "metric": metric,
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "device": device,
        "n_batches": len(times),
        "batch_ms": [round(t, 1) for t in times],
    }))


if __name__ == "__main__":
    main()
