"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from voxelengine_tpu.config import Environment, RenderConfig
from voxelengine_tpu.ops.trace import trace_brickmap
from voxelengine_tpu.parallel.sharded import (
    make_mesh,
    raytrace_sharded,
    render_frame_sharded,
    replicate_world,
)
from voxelengine_tpu.render.frame import make_framebuffer, render_frame


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return make_mesh()


def test_sharded_render_matches_single(small_world, mesh):
    _, _, bm = small_world
    env = Environment.default()
    cfg = RenderConfig(width=64, height=32, checkerboard=True)
    origin = jnp.asarray([16.0, 20.0, 16.0])
    euler = jnp.asarray([0.9, 0.3, 0.0])

    bmr = replicate_world(mesh, bm)
    fb = jax.device_put(make_framebuffer(cfg), NamedSharding(mesh, P("rows")))
    ref = make_framebuffer(cfg)
    # both checkerboard parities: even frames write y = 2y' + 2 across
    # device-block boundaries (the one-row halo covers them)
    for i in range(2):
        fb = render_frame_sharded(bmr, fb, origin, euler, env, jnp.int32(i), cfg, mesh)
        ref = render_frame(bm, ref, origin, euler, env, jnp.int32(i), cfg)
        assert np.array_equal(np.asarray(fb), np.asarray(ref)), f"frame {i}"
    # really sharded: 8 addressable shards
    assert len(fb.addressable_shards) == 8


def test_sharded_render_hbm_kernel_matches_single(
    small_world, mesh, kernel_traversal
):
    """The GPU traversal kernel (interpret mode) under the 8-device mesh:
    sharded render == single-device render, both tracing through
    trace_brickmap_kernel, with tile-ordered rays."""
    _, _, bm = small_world
    env = Environment.default()
    cfg = RenderConfig(width=64, height=32, checkerboard=True, tile_order=True)
    origin = jnp.asarray([16.0, 20.0, 16.0])
    euler = jnp.asarray([0.9, 0.3, 0.0])
    bmr = replicate_world(mesh, bm)
    fb = jax.device_put(make_framebuffer(cfg), NamedSharding(mesh, P("rows")))
    ref = make_framebuffer(cfg)
    for i in range(2):  # both checkerboard parities (halo row crossing)
        fb = render_frame_sharded(
            bmr, fb, origin, euler, env, jnp.int32(i), cfg, mesh
        )
        ref = render_frame(bm, ref, origin, euler, env, jnp.int32(i), cfg)
        assert np.array_equal(np.asarray(fb), np.asarray(ref)), f"frame {i}"
    assert len(fb.addressable_shards) == 8
    assert kernel_traversal.calls > 0


def test_sharded_rays_match_and_psum(small_world, ray_batch, mesh):
    _, _, bm = small_world
    origins, rays = ray_batch
    n = (origins.shape[0] // 8) * 8
    origins, rays = origins[:n], rays[:n]
    bmr = replicate_world(mesh, bm)
    out, avg = raytrace_sharded(bmr, origins, rays, mesh)
    ref = trace_brickmap(bm, jnp.asarray(origins), jnp.asarray(rays))
    assert np.array_equal(np.asarray(out.hit), np.asarray(ref.hit))
    assert np.allclose(np.asarray(out.position), np.asarray(ref.position), atol=1e-5)
    assert np.isclose(float(avg), float(np.asarray(ref.steps).mean()), atol=1e-5)


def test_uneven_checkerboard_rows(small_world, mesh):
    """Height not divisible by mesh -> assertion guides the user."""
    _, _, bm = small_world
    cfg = RenderConfig(width=16, height=12, checkerboard=True)
    env = Environment.default()
    bmr = replicate_world(mesh, bm)
    fb = make_framebuffer(cfg)
    with pytest.raises(AssertionError):
        render_frame_sharded(
            bmr, fb, jnp.zeros(3), jnp.zeros(3), env, jnp.int32(0), cfg, mesh
        )


def test_sharded_render_secondary_shading_matches_single(small_world, mesh):
    """Row sharding with shadow rays + AO: each device traces its own
    secondary rays against the replicated world, so the shaded frame is
    identical to the single-device render."""
    _, _, bm = small_world
    env = Environment.default()
    cfg = RenderConfig(
        width=32, height=16, checkerboard=False,
        shadow_rays=True, ao_samples=2,
    )
    origin = jnp.asarray([16.0, 20.0, 16.0])
    euler = jnp.asarray([0.9, 0.3, 0.0])

    bmr = replicate_world(mesh, bm)
    fb = jax.device_put(make_framebuffer(cfg), NamedSharding(mesh, P("rows")))
    fb = render_frame_sharded(bmr, fb, origin, euler, env, jnp.int32(0), cfg, mesh)
    ref = render_frame(bm, make_framebuffer(cfg), origin, euler, env, jnp.int32(0), cfg)
    assert np.allclose(np.asarray(fb), np.asarray(ref), atol=1e-6)


def test_sharded_rays_through_flagship_kernel(
    small_world, ray_batch, mesh, kernel_traversal
):
    """raytrace_sharded with the GPU traversal kernel (interpret mode):
    each device traces its ray shard through the kernel; results equal
    the single-device kernel."""
    from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel

    _, _, bm = small_world
    origins, rays = ray_batch
    n = (len(origins) // 8) * 8
    o, r = jnp.asarray(origins[:n]), jnp.asarray(rays[:n])

    ref = trace_brickmap_kernel(bm, o, r, 512, interpret=True)

    bmr = replicate_world(mesh, bm)
    out, mean_steps = raytrace_sharded(bmr, o, r, mesh, max_steps=512)
    assert kernel_traversal.calls > 0
    assert np.array_equal(np.asarray(out.hit), np.asarray(ref.hit))
    m = np.asarray(ref.hit)
    assert np.array_equal(np.asarray(out.position)[m], np.asarray(ref.position)[m])
    assert np.array_equal(np.asarray(out.steps), np.asarray(ref.steps))
    assert float(mean_steps) > 0


def test_cyclic_render_matches_single(small_world, mesh):
    """Block-cyclic sharding (block j -> device j % N): the reassembled
    framebuffer equals the single-device render on both checkerboard
    parities (per-block halo rows cover every even-frame +2 crossing,
    including block-top rows whose predecessor block lives on ANOTHER
    device — the case contiguous row sharding never hits)."""
    from voxelengine_tpu.parallel.sharded import (
        cyclic_to_image,
        make_framebuffer_cyclic,
        render_frame_cyclic,
    )

    _, _, bm = small_world
    env = Environment.default()
    # 256x128 checkerboard -> 32x32 blocks, 8x2 grid = 16 blocks over 8 devs
    cfg = RenderConfig(width=256, height=128, checkerboard=True)
    origin = jnp.asarray([16.0, 20.0, 16.0])
    euler = jnp.asarray([0.9, 0.3, 0.0])

    bmr = replicate_world(mesh, bm)
    fb = make_framebuffer_cyclic(cfg, mesh)
    ref = make_framebuffer(cfg)
    for i in range(2):
        fb = render_frame_cyclic(bmr, fb, origin, euler, env, jnp.int32(i), cfg, mesh)
        ref = render_frame(bm, ref, origin, euler, env, jnp.int32(i), cfg)
        assert np.array_equal(cyclic_to_image(fb, cfg), np.asarray(ref)), f"frame {i}"
    assert len(fb.addressable_shards) == 8


def test_cyclic_render_plain_writes(small_world, mesh):
    """Non-checkerboard cyclic render: straight masked writes, no halo."""
    from voxelengine_tpu.parallel.sharded import (
        cyclic_to_image,
        make_framebuffer_cyclic,
        render_frame_cyclic,
    )

    _, _, bm = small_world
    env = Environment.default()
    cfg = RenderConfig(width=256, height=64, checkerboard=False)
    origin = jnp.asarray([16.0, 20.0, 16.0])
    euler = jnp.asarray([0.9, 0.3, 0.0])
    bmr = replicate_world(mesh, bm)
    fb = make_framebuffer_cyclic(cfg, mesh)
    fb = render_frame_cyclic(bmr, fb, origin, euler, env, jnp.int32(0), cfg, mesh)
    ref = render_frame(bm, make_framebuffer(cfg), origin, euler, env,
                       jnp.int32(0), cfg)
    assert np.array_equal(cyclic_to_image(fb, cfg), np.asarray(ref))


def test_cyclic_render_hbm_kernel_matches_single(small_world, kernel_traversal):
    """Block-cyclic sharding through the GPU traversal kernel (interpret
    mode), 4-device mesh."""
    from voxelengine_tpu.parallel.sharded import (
        cyclic_to_image,
        make_framebuffer_cyclic,
        render_frame_cyclic,
    )

    mesh4 = make_mesh(jax.devices()[:4])
    _, _, bm = small_world
    env = Environment.default()
    # 128x64 checkerboard -> 32x32 blocks, 4x1 grid = 4 blocks over 4 devs
    cfg = RenderConfig(width=128, height=64, checkerboard=True)
    origin = jnp.asarray([16.0, 20.0, 16.0])
    euler = jnp.asarray([0.9, 0.3, 0.0])
    bmr = replicate_world(mesh4, bm)
    fb = make_framebuffer_cyclic(cfg, mesh4)
    ref = make_framebuffer(cfg)
    for i in range(2):
        fb = render_frame_cyclic(bmr, fb, origin, euler, env, jnp.int32(i),
                                 cfg, mesh4)
        ref = render_frame(bm, ref, origin, euler, env, jnp.int32(i), cfg)
        assert np.array_equal(cyclic_to_image(fb, cfg), np.asarray(ref)), f"frame {i}"
    assert kernel_traversal.calls > 0
