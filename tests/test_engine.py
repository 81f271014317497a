"""Engine facade / batch ray API tests (C8: VolumeRaytracer.cu:574-618)."""

import numpy as np
import jax.numpy as jnp

from voxelengine_tpu import VoxelRaytracer3D
from voxelengine_tpu.core.bitgrid import BitGrid


def test_batch_api_fields(small_world, ray_batch):
    dense, grid, _ = small_world
    origins, rays = ray_batch
    rt = VoxelRaytracer3D()
    rt.upload_voxel_buffer(grid, 8)
    res = rt.raytrace(origins, rays)
    valid = np.asarray(res.valid)
    hp = np.asarray(res.hit_point)
    assert valid.any() and not valid.all()
    # miss sentinel (VolumeRaytracer.cu:112)
    assert np.isinf(hp[~valid]).all()
    assert np.isfinite(hp[valid]).all()
    # distance consistent with hit point
    d = np.linalg.norm(origins[valid] - hp[valid], axis=1)
    assert np.allclose(d, np.asarray(res.distance)[valid], atol=1e-3)
    # voxel index = linear x-fastest index of the HIT VOXEL (deliberate fix
    # of the reference's float-MAC post-pass, VolumeRaytracer.cu:611-612):
    # the hit point sits on the entry face, nudged into the cell along the
    # entry normal, floor per component, exact int MAC
    X, Y, _ = rt.world.world_dims
    p = hp[valid]
    nrm = np.asarray(res.normal)[valid]
    pi = np.floor(p + 0.5 * nrm).astype(np.int64)
    vi = pi[:, 2] * X * Y + pi[:, 1] * X + pi[:, 0]
    assert np.array_equal(vi, np.asarray(res.voxel_index)[valid].astype(np.int64))
    # and every index names a voxel that is actually solid in the input
    zi, yi, xi = pi[:, 2], pi[:, 1], pi[:, 0]
    assert dense[zi, yi, xi].all()
    assert rt.last_kernel_ms > 0


def test_engine_edit_roundtrip():
    # dedicated solid-floor world (y-floor in [z, y, x] order)
    dense = np.zeros((32, 32, 32), bool)
    dense[:, 0:6, :] = True
    grid = BitGrid.from_dense(dense)
    rt = VoxelRaytracer3D()
    rt.upload_voxel_buffer(grid, 8)
    # carve a voxel out of the floor and verify a straight-down ray passes deeper
    o = np.array([[10.5, 30.0, 10.5]], np.float32)
    d = np.array([[0.0, -1.0, 0.0]], np.float32)
    before = rt.raytrace(o, d)
    y0 = float(before.hit_point[0, 1])
    assert bool(before.valid[0])
    hit_vox = np.floor(np.asarray(before.hit_point[0] - np.array([0, 1e-4, 0]))).astype(int)
    rt.edit_voxels(
        jnp.asarray([hit_vox[0]]), jnp.asarray([hit_vox[1]]), jnp.asarray([hit_vox[2]]), False
    )
    after = rt.raytrace(o, d)
    assert (not bool(after.valid[0])) or float(after.hit_point[0, 1]) < y0


def test_factor_accessors(small_world):
    _, grid, _ = small_world
    rt = VoxelRaytracer3D()
    rt.set_factor(8)
    assert rt.get_factor() == 8
    rt.upload_voxel_buffer(grid)
    assert rt.world.factor == 8


def test_scanned_interactive_loop_matches_unrolled():
    """K (edit -> retrace) rounds composed under ``lax.scan`` inside one
    jit are bit-equal to the same functional ops unrolled on the host —
    the sustained on-device interactive-loop pattern (the reference's
    edit-capable atomic BitRef design, ``VolumeRaytracer.cu:19-36``,
    replayed as a compiler-friendly sequential scan).  Fresh worlds per
    phase because
    ``apply_edits_fused`` donates its brickmap argument."""
    import jax

    from voxelengine_tpu.core.brickmap import apply_edits_fused, build_brickmap
    from voxelengine_tpu.ops.trace import make_fused_table
    from voxelengine_tpu.ops.traverse import trace_rays

    r = np.random.default_rng(99)
    dense = r.random((32, 32, 32)) < 0.05
    r2 = np.random.default_rng(77)
    origins = (r2.random((64, 3)) * 48 - 8).astype(np.float32)
    targets = (r2.random((64, 3)) * 32).astype(np.float32)
    rays = targets - origins
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    oj, dj = jnp.asarray(origins), jnp.asarray(rays.astype(np.float32))

    def fresh():
        bm = build_brickmap(BitGrid.from_dense(dense), 8)
        return bm, make_fused_table(bm)

    K = 3

    def edit_args(k):
        return (jnp.arange(4) + 8 + k, jnp.full((4,), 20),
                jnp.full((4,), 12) + k, True)

    @jax.jit
    def interact(bm, fused, oj, dj):
        def step(carry, k):
            bm, fused, acc = carry
            bm, fused = apply_edits_fused(bm, fused, *edit_args(k))
            res = trace_rays(bm, oj, dj, fused=fused)
            return (bm, fused, acc + jnp.sum(res.steps)), None

        (_, _, acc), _ = jax.lax.scan(
            step, (bm, fused, jnp.int32(0)), jnp.arange(K, dtype=jnp.int32)
        )
        return acc

    bm, fused = fresh()
    got = int(interact(bm, fused, oj, dj))

    bm, fused = fresh()
    want = 0
    for k in range(K):
        bm, fused = apply_edits_fused(bm, fused, *edit_args(k))
        want += int(jnp.sum(trace_rays(bm, oj, dj, fused=fused).steps))
    assert want > 0 and got == want
