"""Distributed z-slab world sharding tests (8-device CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from voxelengine_tpu.core.bitgrid import BitGrid
from voxelengine_tpu.core.brickmap import build_brickmap
from voxelengine_tpu.core.layout import Layout
from voxelengine_tpu.ops.trace import trace_brickmap
from voxelengine_tpu.parallel.distributed import shard_world_z, trace_brickmap_zsharded


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return Mesh(np.asarray(jax.devices()), ("shards",))


def _world_and_rays(rng, n=1024):
    dense = rng.random((64, 64, 64)) < 0.01
    dense[:, :5, :] = rng.random((64, 5, 64)) < 0.5
    bm = build_brickmap(BitGrid.from_dense(dense), 8, coarse_layout=Layout.LINEAR)
    origins = (rng.random((n, 3)) * 120 - 30).astype(np.float32)
    t = (rng.random((n, 3)) * 64).astype(np.float32)
    d = t - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return bm, jnp.asarray(origins), jnp.asarray(d.astype(np.float32))


def test_shard_world_z_slices(rng):
    bm, _, _ = _world_and_rays(rng)
    meta, bricks, slab_gz = shard_world_z(bm, 8)
    assert meta.shape == (8, 64 * 64 * 8 // 8 // 8 // 8)  # (gx*gy*slab_gz)=8*8*1
    assert slab_gz == 1
    assert np.array_equal(np.asarray(meta).reshape(-1), np.asarray(bm.meta))


def test_zsharded_trace_matches_single_device(rng, mesh):
    bm, o, d = _world_and_rays(rng)
    a = trace_brickmap(bm, o, d)
    b = trace_brickmap_zsharded(bm, o, d, mesh)
    assert np.array_equal(np.asarray(a.hit), np.asarray(b.hit))
    assert np.array_equal(np.asarray(a.steps), np.asarray(b.steps))
    hits = np.asarray(a.hit)
    assert np.allclose(
        np.asarray(a.position)[hits], np.asarray(b.position)[hits], atol=1e-5
    )
    assert np.array_equal(np.asarray(a.normal)[hits], np.asarray(b.normal)[hits])


def test_zsharded_axis_aligned_migrators(rng, mesh):
    """Rays marching straight through every slab (maximum migrations)."""
    bm, _, _ = _world_and_rays(rng)
    n = 256
    xs = (rng.random(n) * 60 + 2).astype(np.float32)
    ys = (rng.random(n) * 20 + 2).astype(np.float32)
    o = np.stack([xs, ys, np.full(n, 63.5, np.float32)], -1)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    a = trace_brickmap(bm, jnp.asarray(o), jnp.asarray(d))
    b = trace_brickmap_zsharded(bm, jnp.asarray(o), jnp.asarray(d), mesh)
    assert np.array_equal(np.asarray(a.hit), np.asarray(b.hit))
    hits = np.asarray(a.hit)
    assert np.allclose(
        np.asarray(a.position)[hits], np.asarray(b.position)[hits], atol=1e-5
    )


def test_zsharded_render_matches_single_device(rng, mesh):
    """render_frame over a z-sharded world == plain render_frame."""
    from voxelengine_tpu.config import Environment, RenderConfig
    from voxelengine_tpu.parallel.distributed import render_frame_zsharded
    from voxelengine_tpu.render.frame import make_framebuffer, render_frame

    bm, _, _ = _world_and_rays(rng)
    cfg = RenderConfig(width=128, height=64, checkerboard=True)
    env = Environment.default()
    origin = jnp.asarray([96.0, 80.0, 96.0], jnp.float32)
    euler = jnp.asarray([-0.6, 0.7, 0.0], jnp.float32)
    fa, fb = make_framebuffer(cfg), make_framebuffer(cfg)  # both donated
    for i in range(2):  # both checkerboard parities
        fa = render_frame(bm, fa, origin, euler, env, jnp.int32(i), cfg)
        fb = render_frame_zsharded(
            bm, fb, origin, euler, env, jnp.int32(i), cfg, mesh
        )
    assert np.allclose(np.asarray(fa), np.asarray(fb), atol=1e-6)


# --- the migration path with the GPU traversal kernel (interpret mode) ---


def _assert_same(ref, out):
    hr, ho = np.asarray(ref.hit), np.asarray(out.hit)
    assert hr.any() and (hr == ho).all(), (
        f"hit mismatch at {np.flatnonzero(hr != ho)[:8]}"
    )
    assert np.array_equal(np.asarray(ref.steps), np.asarray(out.steps))
    m = hr
    assert np.array_equal(np.asarray(ref.position)[m], np.asarray(out.position)[m])
    assert np.array_equal(np.asarray(ref.normal)[m], np.asarray(out.normal)[m])


def test_zsharded_hbm_single_slab_geometry_exact(rng, mesh, kernel_traversal):
    """All geometry in one z-slab: the per-slab kernel walks (pausing and
    resuming rays at slab borders) equal the single-device kernel on
    EVERY field, steps included."""
    from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel

    dense = np.zeros((64, 64, 64), bool)  # [z, y, x]
    dense[16:24, :, :] = rng.random((8, 64, 64)) < 0.1  # one z-slab only
    bm = build_brickmap(BitGrid.from_dense(dense), 8, coarse_layout=Layout.LINEAR)
    n = 1024
    origins = (rng.random((n, 3)) * 120 - 30).astype(np.float32)
    t = (rng.random((n, 3)) * 64).astype(np.float32)
    d = (t - origins)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    origins, d = jnp.asarray(origins), jnp.asarray(d.astype(np.float32))

    ref = trace_brickmap_kernel(bm, origins, d, 512, interpret=True)
    out = trace_brickmap_zsharded(bm, origins, d, mesh, 512)
    _assert_same(ref, out)
    assert kernel_traversal.calls > 0


def test_zsharded_hbm_random_world_hits_exact(rng, mesh, kernel_traversal):
    """Random multi-slab world (geometry in every slab, so rays migrate
    mid-walk): hits, positions, normals and steps equal the single-device
    kernel exactly."""
    from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel

    bm, origins, d = _world_and_rays(rng)
    ref = trace_brickmap_kernel(bm, origins, d, 512, interpret=True)
    out = trace_brickmap_zsharded(bm, origins, d, mesh, 512)
    _assert_same(ref, out)


def test_zsharded_hbm_slab_boundary_corner_graze(mesh, kernel_traversal):
    """Exact lattice-corner crossing ON a slab boundary.  A diagonal ray
    through corner (32,32,32) grazes one voxel just below the boundary
    (owned by slab 3) and enters one just above (slab 4).  The DDA's tie
    semantics *tunnel* through the corner: the grazed below-boundary voxel
    is never entered (identically in the kernel, the XLA traversal and the
    scalar oracle), and the migrated walk must reproduce the single-device
    hit bit-for-bit.  Pinned for both ray directions (the migration
    direction flips with the z sign)."""
    from voxelengine_tpu.oracle.reference import (
        make_brickmap_callbacks,
        raytrace_brickmap,
    )
    from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel

    def world(vox):
        dense = np.zeros((64, 64, 64), bool)  # [z, y, x]
        for (x, y, z) in vox:
            dense[z, y, x] = True
        return dense, build_brickmap(
            BitGrid.from_dense(dense), 8, coarse_layout=Layout.LINEAR
        )

    cases = [
        # +diagonal: grazes (32,32,31) in slab 3, enters (32,32,32) in slab 4
        ([23.5, 23.5, 23.5], [1.0, 1.0, 1.0], (32, 32, 31), (32, 32, 32)),
        # -diagonal: grazes (31,31,32) in slab 4, enters (31,31,31) in slab 3
        ([40.5, 40.5, 40.5], [-1.0, -1.0, -1.0], (31, 31, 32), (31, 31, 31)),
    ]
    for o, d, grazed, entered in cases:
        o = jnp.asarray([o], jnp.float32)
        d = jnp.asarray([d], jnp.float32)

        # premise: grazed-only misses, entered-only hits the corner, on
        # the kernel, the XLA traversal and the scalar oracle
        for vox, want_hit in [([grazed], False), ([entered], True)]:
            dense, bm1 = world(vox)
            one = trace_brickmap_kernel(bm1, o, d, 512, interpret=True)
            assert bool(np.asarray(one.hit)[0]) is want_hit
            xla = trace_brickmap(bm1, o, d, 512)
            assert np.array_equal(np.asarray(one.hit), np.asarray(xla.hit))
            co, dims, bo, cb = make_brickmap_callbacks(dense, 8)
            orc = raytrace_brickmap(
                co, dims, bo, cb, 8,
                np.asarray(o[0], np.float32), np.asarray(d[0], np.float32), 512,
            )
            assert orc.hit is want_hit
            if want_hit:
                assert np.array_equal(
                    np.asarray(one.position)[0], np.asarray(orc.position)
                )
        assert np.array_equal(np.asarray(one.position), [[32.0, 32.0, 32.0]])

        # migrated walk == single-device kernel on the full world
        _, bm = world([grazed, entered])
        ref = trace_brickmap_kernel(bm, o, d, 512, interpret=True)
        out = trace_brickmap_zsharded(bm, o, d, mesh, 512)
        _assert_same(ref, out)


def test_zsharded_render_hbm_matches_single(rng, mesh, kernel_traversal):
    """render_frame_zsharded with the kernel traversal produces the same
    frame as the single-device render."""
    from voxelengine_tpu.config import Environment, RenderConfig
    from voxelengine_tpu.parallel.distributed import render_frame_zsharded
    from voxelengine_tpu.render.frame import make_framebuffer, render_frame

    bm, _, _ = _world_and_rays(rng)
    cfg = RenderConfig(width=64, height=32, checkerboard=True)
    env = Environment.default()
    origin = jnp.asarray([32.0, 48.0, 32.0], jnp.float32)
    euler = jnp.asarray([-0.6, 0.4, 0.0], jnp.float32)

    ref = render_frame(bm, make_framebuffer(cfg), origin, euler, env,
                       jnp.int32(0), cfg)
    out = render_frame_zsharded(bm, make_framebuffer(cfg), origin, euler, env,
                                jnp.int32(0), cfg, mesh)
    assert np.array_equal(np.asarray(ref), np.asarray(out))


def test_zsharded_render_secondary_shading(rng, mesh):
    """Shadow + AO rays route through the sharded tracer (they are just
    more ray batches).  The migration path carries exact global step
    budgets, so the shaded frame matches single-device to float
    tolerance."""
    from voxelengine_tpu.config import Environment, RenderConfig
    from voxelengine_tpu.parallel.distributed import render_frame_zsharded
    from voxelengine_tpu.render.frame import make_framebuffer, render_frame

    bm, _, _ = _world_and_rays(rng)
    cfg = RenderConfig(
        width=32, height=16, checkerboard=False,
        shadow_rays=True, ao_samples=2,
    )
    env = Environment.default()
    origin = jnp.asarray([32.0, 48.0, 32.0], jnp.float32)
    euler = jnp.asarray([-0.6, 0.4, 0.0], jnp.float32)

    ref = render_frame(bm, make_framebuffer(cfg), origin, euler, env,
                       jnp.int32(0), cfg)
    out = render_frame_zsharded(bm, make_framebuffer(cfg), origin, euler,
                                env, jnp.int32(0), cfg, mesh)
    assert np.allclose(np.asarray(ref), np.asarray(out), atol=1e-6)


def test_zsharded_render_reflections_only(rng, mesh):
    """Reflections with shadows/AO OFF must still route a secondary tracer
    (round-4 advisor finding: needs_secondary omitted cfg.reflections, so
    the reflected bounce was silently skipped).  Guard: the zsharded frame
    must match the single-device reflective render, and must NOT match a
    reflections-off render (i.e. the bounce actually happened)."""
    from voxelengine_tpu.config import Environment, RenderConfig
    from voxelengine_tpu.parallel.distributed import render_frame_zsharded
    from voxelengine_tpu.render.frame import make_framebuffer, render_frame
    import dataclasses

    bm, _, _ = _world_and_rays(rng)
    cfg = RenderConfig(width=32, height=16, checkerboard=False,
                       reflections=True)
    env = Environment.default()
    origin = jnp.asarray([32.0, 48.0, 32.0], jnp.float32)
    euler = jnp.asarray([-0.6, 0.4, 0.0], jnp.float32)

    ref = render_frame(bm, make_framebuffer(cfg), origin, euler, env,
                       jnp.int32(0), cfg)
    out = render_frame_zsharded(bm, make_framebuffer(cfg), origin, euler,
                                env, jnp.int32(0), cfg, mesh)
    assert np.allclose(np.asarray(ref), np.asarray(out), atol=1e-6)

    cfg_off = dataclasses.replace(cfg, reflections=False)
    flat = render_frame(bm, make_framebuffer(cfg_off), origin, euler, env,
                        jnp.int32(0), cfg_off)
    assert not np.allclose(np.asarray(flat), np.asarray(out), atol=1e-6)
