"""The GPU traversal kernel's wrapper and the traversal dispatcher.

The kernel itself runs here in Pallas interpret mode; its compiled form is
checked on a card by tests/test_gpu_smoke.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voxelengine_tpu.core.bitgrid import BitGrid
from voxelengine_tpu.core.brickmap import build_brickmap
from voxelengine_tpu.core.layout import Layout
from voxelengine_tpu.ops import trace, trace_kernel, traverse
from voxelengine_tpu.ops.trace_kernel import (
    BLOCK,
    NUM_WARPS,
    advance_kernel,
    trace_brickmap_kernel,
)


@pytest.fixture(scope="module")
def world():
    r = np.random.default_rng(11)
    dense = r.random((32, 32, 32)) < 0.03
    dense[:, 0:3, :] = r.random((32, 3, 32)) < 0.5
    return build_brickmap(BitGrid.from_dense(dense), 8, coarse_layout=Layout.LINEAR)


def _rays(n, seed=3):
    r = np.random.default_rng(seed)
    o = (r.random((n, 3)) * 64 - 16).astype(np.float32)
    d = (r.random((n, 3)) * 32).astype(np.float32) - o
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n", [1, BLOCK - 1, BLOCK, BLOCK + 1, 3 * BLOCK + 5])
def test_kernel_pads_rays_to_the_block(world, n):
    """Any ray count: the wrapper pads to a whole number of blocks with
    inactive lanes and returns exactly n results of the XLA shapes and
    dtypes, equal to the XLA traversal."""
    o, d = _rays(n)
    out = trace_brickmap_kernel(world, o, d, 128, interpret=True)
    ref = trace.trace_brickmap(world, o, d, 128)
    for field in ("hit", "position", "normal", "steps"):
        a, b = getattr(ref, field), getattr(out, field)
        assert a.shape == b.shape and a.dtype == b.dtype, field
        assert np.array_equal(np.asarray(a), np.asarray(b)), field


def test_block_is_whole_warps():
    assert BLOCK % 32 == 0 and BLOCK & (BLOCK - 1) == 0
    assert NUM_WARPS == BLOCK // 32


def test_state_split_merge_roundtrip(world):
    """Component split / merge of the traversal state is lossless, dtypes
    included (bool fields travel as int32)."""
    o, d = _rays(7)
    st = trace._init_state(world, o, d)
    inv = 1.0 / jnp.where(st.d == 0.0, 1e-7, st.d)
    back = trace_kernel._merge(st, trace_kernel._split(st, inv))
    for a, b in zip(st, back):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


def test_inactive_rays_pass_through(world):
    """Rays that start inactive leave the kernel untouched (the padded
    lanes rely on this)."""
    o, d = _rays(40)
    st = trace._init_state(world, o, d)
    st = st._replace(active=jnp.zeros_like(st.active))
    out = advance_kernel(world, st, 128, 264, interpret=True)
    for a, b in zip(st, out):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_advance_kernel_slab_mode_matches_xla(world):
    """z-slab mode: rays pause at the slab's borders with their state
    intact, exactly like the XLA loop's slab mode."""
    from voxelengine_tpu.parallel.distributed import _slab_bm, shard_world_z

    o, d = _rays(100)
    meta, bricks, slab_gz = shard_world_z(world, 2)
    spec = world.grid_dims + (world.factor, world.coarse_layout, world.brick_layout)
    bm1 = _slab_bm(spec, meta[1], bricks[1], slab_gz)
    st = trace._init_state(bm1, o, d, full_gz=world.grid_dims[2])
    z0 = jnp.int32(slab_gz)
    gz = world.grid_dims[2]
    ref = trace._run_loop(bm1, st, 128, 264, slab=(z0, gz))
    out = advance_kernel(bm1, st, 128, 264, z0=z0, full_gz=gz, interpret=True)
    for name, a, b in zip(st._fields, ref, out):
        if name != "it":
            assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_kernel_is_the_gpu_choice(world, monkeypatch):
    """On "gpu" the dispatcher runs the kernel (compiled, never interpret
    mode); the platform is passed explicitly, as jax.default_backend()
    would report it."""
    seen = {}

    def fake_kernel(bm, o, d, ms, interpret=False):
        seen["args"] = (ms, interpret)
        return "kernel"

    monkeypatch.setattr(trace_kernel, "trace_brickmap_kernel", fake_kernel)
    o, d = _rays(4)
    assert traverse.trace_rays(world, o, d, 64, platform="gpu") == "kernel"
    assert seen["args"] == (64, False)


def test_xla_is_the_cpu_choice(world):
    o, d = _rays(50)
    out = traverse.trace_rays(world, o, d, 128, platform="cpu")
    ref = trace.trace_brickmap(world, o, d, 128)
    assert np.array_equal(np.asarray(out.steps), np.asarray(ref.steps))
    assert traverse.select_traversal("cpu") == traverse.TRAVERSALS["cpu"]
    assert traverse.select_traversal() == traverse.TRAVERSALS[jax.default_backend()]


def test_unknown_platform_is_an_error(world):
    o, d = _rays(4)
    with pytest.raises(ValueError, match="no brickmap traversal"):
        traverse.trace_rays(world, o, d, 64, platform="metal")


def test_compiled_kernel_has_no_cpu_fallback(world):
    """Without interpret mode the kernel only compiles for a GPU: asking
    for it on the CPU is an error, not a silent fallback."""
    o, d = _rays(8)
    with pytest.raises(Exception):
        jax.block_until_ready(trace_brickmap_kernel(world, o, d, 64))


def test_kernel_lowers_for_cuda(world):
    """The kernel lowers through the Triton route for CUDA (jax.export
    runs the Pallas-to-Triton lowering without a card)."""
    from jax import export

    o, d = _rays(100)
    exp = export.export(
        jax.jit(lambda bm, o, d: trace_brickmap_kernel(bm, o, d, 64)),
        platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton"
        )],
    )(world, o, d)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()
