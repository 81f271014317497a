"""Card lane: the traversal kernel COMPILED for a real GPU.

Interpret-mode parity (the rest of the suite) does not prove that Triton
compiles the kernel, nor that its float arithmetic matches XLA's on the
card — this lane does, asserting compiled results equal the XLA traversal
and the scalar oracle on small scenes.  It skips without a GPU; run it on
a machine with one:

    VOX_GPU_TESTS=1 python -m pytest tests/test_gpu_smoke.py -q
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from voxelengine_tpu.core.bitgrid import BitGrid
from voxelengine_tpu.core.brickmap import build_brickmap
from voxelengine_tpu.core.layout import Layout

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _card():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (VOX_GPU_TESTS=1 on a machine with one)")


def _scene(rng, n=64):
    dense = rng.random((n, n, n)) < 0.02
    dense[:, 0:4, :] = rng.random((n, 4, n)) < 0.5
    return dense


def _rays(rng, k, n):
    origins = (rng.random((k, 3)) * n * 2 - n / 2).astype(np.float32)
    targets = (rng.random((k, 3)) * n).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(origins), jnp.asarray(d.astype(np.float32))


def assert_matches_xla(bm, ref, out):
    """Kernel vs XLA traversal on the card: hits, steps and normals equal;
    positions within ``position_tolerance`` (XLA and Triton contract
    ``start + t * d`` into fused multiply-adds differently)."""
    from voxelengine_tpu.ops.trace_kernel import position_tolerance

    hr, ho = np.asarray(ref.hit), np.asarray(out.hit)
    assert (hr == ho).all()
    assert np.array_equal(np.asarray(ref.steps), np.asarray(out.steps))
    pr, po = np.asarray(ref.position)[hr], np.asarray(out.position)[hr]
    assert (np.abs(pr - po) <= position_tolerance(bm, pr)).all()
    assert np.array_equal(np.asarray(ref.normal)[hr], np.asarray(out.normal)[hr])


@pytest.mark.parametrize(
    "coarse,brick",
    [(Layout.LINEAR, Layout.TILED_LINEAR),
     (Layout.TILED_MORTON, Layout.TILED_LINEAR),
     (Layout.LINEAR, Layout.TILED_MORTON)],
)
def test_kernel_compiled_matches_xla(rng, coarse, brick):
    from voxelengine_tpu.ops.trace import trace_brickmap
    from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel

    bm = build_brickmap(
        BitGrid.from_dense(_scene(rng)), 8, coarse_layout=coarse,
        brick_layout=brick,
    )
    o, d = _rays(rng, 2000, 64)  # not a multiple of the block
    assert_matches_xla(bm, trace_brickmap(bm, o, d, 256),
                       trace_brickmap_kernel(bm, o, d, 256))


def test_kernel_compiled_compact_terrain(rng):
    """Compact indirection (brick_idx gather) on the terrain builder's
    world, compiled."""
    from voxelengine_tpu.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu.ops.trace import trace_brickmap
    from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel

    bm = build_brickmap_terrain_compact((256, 128, 256), 32, octaves=4)
    o, d = _rays(rng, 4096, 256)
    assert_matches_xla(bm, trace_brickmap(bm, o, d, 1024),
                       trace_brickmap_kernel(bm, o, d, 1024))


def test_two_level_oracle_parity_compiled(rng):
    """The dispatcher's traversal on the card against the scalar
    reference-semantics oracle (VolumeRaytracer.cu:354-525), with the
    tolerances of the CPU lane's test_two_level_parity: rays the oracle's
    repeat-cell guard kills may differ (reference quirk, PARITY.md), so hit
    mismatches are bounded at 1%; positions within 2e-3."""
    from voxelengine_tpu.oracle import reference as R
    from voxelengine_tpu.ops.traverse import trace_rays

    dense = _scene(rng)
    bm = build_brickmap(BitGrid.from_dense(dense), 8)
    o, d = _rays(rng, 1024, 64)
    out = trace_rays(bm, o, d, 2048)
    hit = np.asarray(out.hit)
    pos = np.asarray(out.position)
    nrm = np.asarray(out.normal)
    on, dn = np.asarray(o), np.asarray(d)
    coarse, cdims, brick, cbounds = R.make_brickmap_callbacks(dense, 8)
    hit_mism = 0
    for i in range(on.shape[0]):
        res = R.raytrace_brickmap(coarse, cdims, brick, cbounds, 8,
                                  on[i], dn[i])
        if bool(hit[i]) != res.hit:
            hit_mism += 1
            continue
        if res.hit:
            assert np.allclose(pos[i], res.position, atol=2e-3), i
            assert np.allclose(nrm[i], res.normal, atol=0), i
    assert hit_mism <= on.shape[0] // 100, hit_mism


def test_full_shading_golden_compiled(rng, monkeypatch):
    """A full-shading frame (shadow rays + 4-sample AO + one-bounce
    reflections, Renderer.cu:89-177 semantics) rendered through the card's
    traversal equals the same frame rendered with the XLA traversal, to
    the shading's float tolerance."""
    from voxelengine_tpu.config import Environment, RenderConfig
    from voxelengine_tpu.ops import traverse
    from voxelengine_tpu.render.frame import make_framebuffer, render_frame

    bm = build_brickmap(BitGrid.from_dense(_scene(rng)), 8)
    env = Environment.default()
    origin = jnp.asarray([32.0, 40.0, 56.0], jnp.float32)
    euler = jnp.asarray([-0.7, 0.2, 0.0], jnp.float32)
    cfg = RenderConfig(width=64, height=32, checkerboard=False,
                       crosshair=False, shadow_rays=True, ao_samples=4,
                       reflections=True)
    f_kernel = np.asarray(render_frame(
        bm, make_framebuffer(cfg), origin, euler, env, jnp.int32(0), cfg))
    monkeypatch.setitem(traverse.TRAVERSALS, "gpu", traverse.TRAVERSALS["cpu"])
    jax.clear_caches()
    f_xla = np.asarray(render_frame(
        bm, make_framebuffer(cfg), origin, euler, env, jnp.int32(0), cfg))
    jax.clear_caches()
    assert np.isfinite(f_kernel).all()
    assert (f_kernel.sum(-1) > 0).any()
    np.testing.assert_allclose(f_kernel, f_xla, atol=1e-5)


def test_edit_retrace_compiled(rng):
    """The interactive edit surface on the card: O(edits) in-place voxel
    writes, then the edited world traced by the compiled kernel and
    matched against the XLA traversal of the same edited world (the
    place/break + re-render loop of VoxelApp, main.cu:64-80 semantics)."""
    from voxelengine_tpu.core.brickmap import apply_edits
    from voxelengine_tpu.ops.trace import trace_brickmap
    from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel

    bm = build_brickmap(BitGrid.from_dense(_scene(rng)), 8)
    k = 40
    xs = rng.integers(0, 64, k)
    ys = rng.integers(0, 64, k)
    zs = rng.integers(0, 64, k)
    vals = rng.random(k) < 0.7
    bm2 = apply_edits(jax.tree.map(jnp.copy, bm), xs, ys, zs, vals)
    o, d = _rays(rng, 1024, 64)
    assert_matches_xla(bm2, trace_brickmap(bm2, o, d, 2048),
                       trace_brickmap_kernel(bm2, o, d, 2048))


def test_zsharded_slab_mode_compiled(rng):
    """The kernel's z-slab mode (rays pause at slab borders with their
    state intact) compiled, on a one-card mesh: equal to the plain
    kernel trace."""
    from jax.sharding import Mesh

    from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel
    from voxelengine_tpu.parallel.distributed import trace_brickmap_zsharded

    bm = build_brickmap(
        BitGrid.from_dense(_scene(rng)), 8, coarse_layout=Layout.LINEAR
    )
    o, d = _rays(rng, 1024, 64)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("shards",))
    ref = trace_brickmap_kernel(bm, o, d, 512)
    out = trace_brickmap_zsharded(bm, o, d, mesh, 512)
    for f in ("hit", "steps", "position", "normal"):
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              np.asarray(getattr(out, f))), f
