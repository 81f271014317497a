#!/usr/bin/env python
"""Smoke test of the engine on one NVIDIA GPU, through its normal entry points.

    python chip_smoke.py           # one card: phases 1-6 below
    python chip_smoke.py --multi   # four cards of one host: the mesh phases

One process, one card.  Each phase prints one JSON line; no phase's failure
is caught, so any failed check ends the run with a non-zero exit code and
without the result line.  The line before the last is ``nvidia-smi``'s
``name, power.limit`` of the card; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero before any phase.

Phases (the reference demo deployment is ``main.cu:15-23``: a 1024^3 world,
factor 32, 32-octave terrain with seed 0x71889283, 1280x720 checkerboard):

1. device: platform, device kind, count, nvidia-smi;
2. demo: the world built on the card and uploaded with
   ``VoxelRaytracer3D.upload_world``; 8 chained ``render_frame`` frames;
   frame 1's primary rays through the platform's traversal against a
   full-budget ``trace_brickmap`` (the gate below); finite framebuffer;
3. full shading: shadows, AO(4) and reflections, 2 frames, finite;
4. batch query: 10^6 random rays through ``VoxelRaytracer3D.raytrace``
   against ``trace_brickmap`` (the gate), and 256 of them against the
   scalar oracle ``oracle/reference.py``;
5. edit: ``edit_voxels`` (place and break) on a dense-slot demo world,
   re-trace, compared with a rebuild from the edited dense grid;
6. kernel against XLA: phases 2-4 timed through the GPU kernel and through
   the plain and staged XLA traversals, medians after warm-up.

``--multi`` runs only: ``render_frame_sharded`` and ``render_frame_cyclic``
over a flat 4-card mesh, pixel-equal to one-card ``render_frame``;
``raytrace_sharded`` with its ``psum``, and ``trace_brickmap_zsharded``,
each against the one-card trace (``cross_program_gate``); each shard's
device printed.

The gate (kernel against the XLA traversal on the same card): hit
differences on at most 0.01% of rays (the bench's gate); where hits agree,
equal step counts and normals, and positions within
``ops.trace_kernel.position_tolerance`` (about one float32 ulp of the
chunk coordinates, scaled to voxels), because XLA and Triton contract
``start + t * d`` into fused multiply-adds differently.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from voxelengine_tpu import Environment, RenderConfig, VoxelRaytracer3D  # noqa: E402
from voxelengine_tpu.core.brickmap import (  # noqa: E402
    build_brickmap,
    build_brickmap_terrain,
    build_brickmap_terrain_compact,
)
from voxelengine_tpu.core.layout import sample_index  # noqa: E402
from voxelengine_tpu.ops import traverse  # noqa: E402
from voxelengine_tpu.ops.trace import trace_brickmap, trace_brickmap_staged  # noqa: E402
from voxelengine_tpu.ops.trace_kernel import position_tolerance  # noqa: E402
from voxelengine_tpu.oracle import reference as oracle  # noqa: E402
from voxelengine_tpu.render.frame import (  # noqa: E402
    make_framebuffer,
    primary_rays,
    render_frame,
)
from voxelengine_tpu.utils.cache import enable_compilation_cache  # noqa: E402
from voxelengine_tpu.worldgen.terrain import generate_world  # noqa: E402

DEMO_DIMS = (1024, 1024, 1024)  # main.cu:17-21
FACTOR = 32
DEMO_CFG = RenderConfig(width=1280, height=720, checkerboard=True)
CAMERA = ((256.0, 256.0, 256.0), (0.3, 0.8, 0.0))  # main.cu:52 pose
BATCH = 1_000_000


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def median_ms(fn, reps, warm=2):
    for _ in range(warm):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        ts.append(timed(fn)[1] * 1e3)
    return float(np.median(ts))


def gate(bm, ref_hit, ref_pos, ref_nrm, ref_steps, hit, pos, nrm, steps):
    """The kernel-against-XLA gate (module doc).  Returns the hit diffs and
    the largest position difference."""
    hr, ho = np.asarray(ref_hit), np.asarray(hit)
    diffs = int((hr != ho).sum())
    assert diffs <= hr.size // 10000, f"hit diffs {diffs}/{hr.size}"
    both = hr & ho
    assert np.array_equal(np.asarray(ref_steps)[both], np.asarray(steps)[both])
    assert np.array_equal(np.asarray(ref_nrm)[both], np.asarray(nrm)[both])
    pr, po = np.asarray(ref_pos)[both], np.asarray(pos)[both]
    dev = np.abs(pr - po)
    assert (dev <= position_tolerance(bm, pr)).all(), f"positions {dev.max()}"
    return dict(hit_diffs=diffs, pos_max_abs_diff=float(dev.max(initial=0.0)))


def gate_trace(bm, ref, out):
    return gate(bm, ref.hit, ref.position, ref.normal, ref.steps,
                out.hit, out.position, out.normal, out.steps)


def cross_program_gate(ref, out):
    """The gate for a trace run inside a program partitioned over several
    cards, against the one-card trace: hits differ on at most 0.01% of
    rays (the bench's gate).  XLA compiles each program as a whole and may
    fuse the ray set-up (the direction's normalisation) differently, which
    moves a direction by a few ulps: that can move a ray's path across a
    cell edge, so step counts may differ on up to 1% of rays, and moves a
    hit by up to the path length times that error, so positions of rays
    that agree on hit and steps are held to the oracle-parity tolerance
    of 2e-3 voxel (tests/test_oracle_parity.py)."""
    hr, ho = np.asarray(ref.hit), np.asarray(out.hit)
    sr, so = np.asarray(ref.steps), np.asarray(out.steps)
    n = hr.size
    hit_diffs, steps_diffs = int((hr != ho).sum()), int((sr != so).sum())
    assert hit_diffs <= n // 10000, f"hit diffs {hit_diffs}/{n}"
    assert steps_diffs <= n // 100, f"steps diffs {steps_diffs}/{n}"
    same = hr & ho & (sr == so)
    pr = np.asarray(ref.position)[same]
    dev = np.abs(pr - np.asarray(out.position)[same])
    assert (dev <= 2e-3).all(), f"positions {dev.max()}"
    return dict(hit_diffs=hit_diffs, steps_diffs=steps_diffs,
                pos_max_abs_diff=float(dev.max(initial=0.0)))


def camera():
    o, e = CAMERA
    return jnp.asarray(o, jnp.float32), jnp.asarray(e, jnp.float32)


def batch_rays(world_dims, n, seed=0):
    """Incoherent query rays: origins and targets uniform in the world."""
    r = np.random.default_rng(seed)
    w = np.asarray(world_dims, np.float32)
    o = (r.random((n, 3)) * w).astype(np.float32)
    d = (r.random((n, 3)) * w).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d.astype(np.float32))


def oracle_callbacks(bm):
    """Scalar-oracle callbacks read from the brickmap's own arrays."""
    meta = np.asarray(bm.meta)
    slots = np.asarray(bm.brick_idx)
    bricks = np.asarray(bm.bricks)
    gx, gy, gz = bm.grid_dims
    f = bm.factor

    def chunk(cx, cy, cz):
        return int(sample_index(int(cx), int(cy), int(cz), gx, gy,
                                bm.coarse_layout))

    def coarse(cx, cy, cz):
        return bool((meta[chunk(cx, cy, cz)] >> 30) & 1)

    def brick(cx, cy, cz, lx, ly, lz):
        slot = slots[chunk(cx, cy, cz)]
        if slot < 0:
            return False
        bit = int(sample_index(int(lx), int(ly), int(lz), f, f, bm.brick_layout))
        return bool((int(bricks[slot, bit >> 5]) >> (bit & 31)) & 1)

    def bounds(cx, cy, cz):
        m = int(meta[chunk(cx, cy, cz)])
        if not (m >> 30) & 1:
            return np.zeros(3, np.float32), np.full(3, -1, np.float32)
        lo = [(m >> s) & 31 for s in (0, 5, 10)]
        hi = [(m >> s) & 31 for s in (15, 20, 25)]
        return np.asarray(lo, np.float32), np.asarray(hi, np.float32)

    return coarse, (gx, gy, gz), brick, bounds


class route:
    """Run the engine's GPU entries through another traversal for a while
    (phase 6 only): ``with route("xla"): ...``."""

    CHOICES = {
        "kernel": traverse.TRAVERSALS["gpu"],
        "xla": traverse.TRAVERSALS["cpu"],
        "xla_staged": (
            lambda bm, o, d, ms, fused: trace_brickmap_staged(
                bm, o, d, ms, fused=fused
            ),
            traverse.TRAVERSALS["cpu"][1],
        ),
    }

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        traverse.TRAVERSALS["gpu"] = self.CHOICES[self.name]
        jax.clear_caches()

    def __exit__(self, *exc):
        traverse.TRAVERSALS["gpu"] = self.CHOICES["kernel"]
        jax.clear_caches()


def phase_demo(env):
    bm, s = timed(lambda: build_brickmap_terrain_compact(DEMO_DIMS, FACTOR))
    rt = VoxelRaytracer3D()
    rt.upload_world(bm)
    origin, euler = camera()
    fb = make_framebuffer(DEMO_CFG)
    fb, first = timed(lambda: render_frame(
        rt.world, fb, origin, euler, env, jnp.int32(0), DEMO_CFG, rt.fused_table
    ))
    for i in range(1, 8):
        fb = render_frame(rt.world, fb, origin, euler, env, jnp.int32(i),
                          DEMO_CFG, rt.fused_table)
    fb = np.asarray(fb)
    assert fb.shape == (DEMO_CFG.height, DEMO_CFG.width, 3)
    assert np.isfinite(fb).all()
    o, d, *_ = primary_rays(DEMO_CFG, origin, euler, jnp.int32(1))
    out = traverse.trace_rays(rt.world, o, d, DEMO_CFG.max_steps)
    ref = trace_brickmap(rt.world, o, d, DEMO_CFG.max_steps)
    g = gate_trace(rt.world, ref, out)
    say("demo", world=DEMO_DIMS, build_s=s, first_frame_s=first, frames=8,
        rays=int(o.shape[0]), hit_rate=float(np.asarray(ref.hit).mean()),
        bricks_bytes=int(bm.bricks.nbytes), **g)
    return rt


def phase_full_shading(rt, env):
    cfg = dataclasses.replace(DEMO_CFG, shadow_rays=True, ao_samples=4,
                              reflections=True)
    origin, euler = camera()
    fb = make_framebuffer(cfg)
    fb, first = timed(lambda: render_frame(
        rt.world, fb, origin, euler, env, jnp.int32(0), cfg, rt.fused_table
    ))
    fb = render_frame(rt.world, fb, origin, euler, env, jnp.int32(1), cfg,
                      rt.fused_table)
    fb = np.asarray(fb)
    assert np.isfinite(fb).all() and (fb.sum(-1) > 0).any()
    say("full_shading", frames=2, first_frame_s=first, traces_per_pixel=7)
    return cfg


def phase_batch(rt):
    o, d = batch_rays(rt.world.world_dims, BATCH)
    res = rt.raytrace(o, d)
    ref = trace_brickmap(rt.world, o, d)
    g = gate(rt.world, ref.hit, ref.position, ref.normal, ref.steps,
             res.valid, res.hit_point, res.normal, res.steps)

    # scalar oracle on 256 rays, with the parity tolerance of the card lane
    # (tests/test_gpu_smoke.py): hit mismatches at most 1% (rays the
    # reference's repeat-cell guard kills may differ, PARITY.md); where
    # hits agree, positions within 2e-3 and equal normals
    coarse, dims, brick, bounds = oracle_callbacks(rt.world)
    hit = np.asarray(res.valid)
    pos = np.asarray(res.hit_point)
    nrm = np.asarray(res.normal)
    on, dn = np.asarray(o), np.asarray(d)
    mism = guarded = 0
    for i in range(256):
        orc = oracle.raytrace_brickmap(coarse, dims, brick, bounds, FACTOR,
                                       on[i], dn[i])
        guarded += orc.guard_tripped
        if orc.hit != bool(hit[i]):
            mism += 1
        elif orc.hit:
            assert np.allclose(pos[i], orc.position, atol=2e-3), i
            assert np.array_equal(nrm[i], orc.normal), i
    assert mism <= 256 // 100, f"oracle hit mismatches {mism}/256"
    say("batch_query", rays=BATCH, query_ms=rt.last_kernel_ms,
        hit_rate=float(hit.mean()), **g, oracle_rays=256,
        oracle_hit_mismatches=mism, oracle_guard_tripped=int(guarded))
    return o, d


def phase_edit():
    grid = generate_world(DEMO_DIMS)
    rt = VoxelRaytracer3D()
    rt.upload_voxel_buffer(grid, FACTOR)
    assert rt.world.dense_slots
    origin, euler = camera()
    o, d, *_ = primary_rays(DEMO_CFG, origin, euler, jnp.int32(1))
    before = traverse.trace_rays(rt.world, o, d)
    hit = np.asarray(before.hit)
    p = np.asarray(before.position)[hit][:: max(1, hit.sum() // 256)][:256]
    n = np.asarray(before.normal)[hit][:: max(1, hit.sum() // 256)][:256]
    brk = np.floor(p[:128] + 0.5 * n[:128]).astype(np.int32)  # hit voxels
    plc = np.floor(p[128:] - 0.5 * n[128:]).astype(np.int32)  # air before them
    vox = np.clip(np.concatenate([brk, plc]), 0, np.asarray(DEMO_DIMS) - 1)
    val = np.arange(vox.shape[0]) >= brk.shape[0]
    x, y, z = (jnp.asarray(vox[:, k]) for k in range(3))
    rt.edit_voxels(x, y, z, jnp.asarray(val))
    after = traverse.trace_rays(rt.world, o, d)

    rebuilt = build_brickmap(grid.set_bits(x, y, z, jnp.asarray(val)), FACTOR)
    assert np.array_equal(np.asarray(rt.world.meta), np.asarray(rebuilt.meta))
    assert np.array_equal(np.asarray(rt.world.bricks), np.asarray(rebuilt.bricks))
    g = gate_trace(rebuilt, trace_brickmap(rebuilt, o, d), after)
    changed = int((np.asarray(after.steps) != np.asarray(before.steps)).sum())
    assert changed > 0, "the edits changed no ray"
    say("edit", edits=int(vox.shape[0]), rays_changed=changed, **g)


def phase_kernel_vs_xla(rt, cfg_full, batch, env):
    origin, euler = camera()
    o, d, *_ = primary_rays(DEMO_CFG, origin, euler, jnp.int32(1))
    bo, bd = batch
    row, kernel = {}, {}
    for name in ("kernel", "xla", "xla_staged"):
        with route(name):

            def frame(cfg=DEMO_CFG):
                return render_frame(rt.world, make_framebuffer(cfg), origin,
                                    euler, env, jnp.int32(1), cfg,
                                    rt.fused_table)

            prim = traverse.trace_rays(rt.world, o, d)
            bq = rt.raytrace(bo, bd)
            if name == "kernel":
                kernel = dict(prim=prim, batch=bq, frame=np.asarray(frame()))
            else:
                gate_trace(rt.world, prim, kernel["prim"])
                gate(rt.world, bq.valid, bq.hit_point, bq.normal, bq.steps,
                     kernel["batch"].valid, kernel["batch"].hit_point,
                     kernel["batch"].normal, kernel["batch"].steps)
            fb = np.asarray(frame())
            row[name] = dict(
                demo_frame_ms=median_ms(frame, 10),
                full_shading_frame_ms=median_ms(lambda: frame(cfg_full), 3, 1),
                batch_query_ms=median_ms(lambda: rt.raytrace(bo, bd).valid, 5),
                frame_max_abs_diff_vs_kernel=float(
                    np.abs(fb - kernel["frame"]).max()
                ),
            )
    say("kernel_vs_xla", **row)


def main_single():
    env = Environment.default()
    rt = phase_demo(env)
    cfg_full = phase_full_shading(rt, env)
    batch = phase_batch(rt)
    phase_edit()
    phase_kernel_vs_xla(rt, cfg_full, batch, env)


def main_multi():
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from voxelengine_tpu.parallel.distributed import trace_brickmap_zsharded
    from voxelengine_tpu.parallel.sharded import (
        cyclic_to_image,
        make_framebuffer_cyclic,
        make_mesh,
        raytrace_sharded,
        render_frame_cyclic,
        render_frame_sharded,
        replicate_world,
    )

    devices = jax.devices()[:4]
    assert len(devices) == 4, f"--multi needs 4 GPUs, found {len(jax.devices())}"
    env = Environment.default()
    # dense slots + LINEAR coarse order, so the same world also z-shards
    bm, s = timed(lambda: build_brickmap_terrain(DEMO_DIMS, FACTOR))
    mesh = make_mesh(devices)
    bmr = replicate_world(mesh, bm)
    origin, euler = camera()
    cfg = DEMO_CFG

    def shard_devices(a):
        devs = [str(sh.device) for sh in a.addressable_shards]
        assert len(set(devs)) == 4, devs
        return devs

    ref = make_framebuffer(cfg)
    fs = jax.device_put(make_framebuffer(cfg), NamedSharding(mesh, P("rows")))
    fc = make_framebuffer_cyclic(cfg, mesh)
    for i in range(2):  # both checkerboard parities
        ref = render_frame(bm, ref, origin, euler, env, jnp.int32(i), cfg)
        fs = render_frame_sharded(bmr, fs, origin, euler, env, jnp.int32(i),
                                  cfg, mesh)
        fc = render_frame_cyclic(bmr, fc, origin, euler, env, jnp.int32(i),
                                 cfg, mesh)
        r = np.asarray(ref)
        assert np.array_equal(np.asarray(fs), r), f"row-sharded frame {i}"
        assert np.array_equal(cyclic_to_image(fc, cfg), r), f"cyclic frame {i}"

    # chained frames, as a render loop runs them: each call consumes the
    # previous framebuffer (donated)
    chain = {"one": ref, "cyc": fc}

    def one():
        chain["one"] = render_frame(bm, chain["one"], origin, euler, env,
                                    jnp.int32(1), cfg)
        return chain["one"]

    def cyc():
        chain["cyc"] = render_frame_cyclic(bmr, chain["cyc"], origin, euler,
                                           env, jnp.int32(1), cfg, mesh)
        return chain["cyc"]

    say("frames", world=DEMO_DIMS, build_s=s, pixel_equal=True,
        sharded_devices=shard_devices(fs), cyclic_devices=shard_devices(fc),
        one_card_frame_ms=median_ms(one, 20),
        cyclic_4card_frame_ms=median_ms(cyc, 20))

    o, d = batch_rays(bm.world_dims, BATCH)
    out, mean_steps = raytrace_sharded(bmr, o, d, mesh)
    own = float(np.asarray(out.steps, np.float64).mean())
    assert abs(float(mean_steps) - own) <= 1e-5 * own, "psum mean"
    g = cross_program_gate(traverse.trace_rays(bm, o, d), out)
    say("raytrace_sharded", rays=BATCH, devices=shard_devices(out.hit),
        psum_mean_steps=float(mean_steps), **g)

    zmesh = Mesh(np.asarray(devices), ("shards",))
    po, pd, *_ = primary_rays(cfg, origin, euler, jnp.int32(1))
    zout = trace_brickmap_zsharded(bm, po, pd, zmesh)
    g = cross_program_gate(trace_brickmap(bm, po, pd), zout)
    say("zsharded", rays=int(po.shape[0]), slabs=4, **g)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card mesh phases only")
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's backend is {jax.default_backend()!r}",
              file=sys.stderr)
        sys.exit(2)
    enable_compilation_cache()
    dev = jax.devices()[0]
    smi = nvidia_smi()
    say("device", platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()), nvidia_smi=smi)
    if args.multi:
        main_multi()
    else:
        main_single()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.multi else len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
