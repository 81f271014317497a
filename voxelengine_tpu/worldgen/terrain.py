"""Procedural terrain generation.

JAX equivalent of ``VoxelWorldBuilder.{cu,cuh}``: the per-voxel CUDA
kernel (one thread per voxel, 8x8x8 blocks, ``VoxelWorldBuilder.cuh:22-26``)
becomes a vectorized jnp evaluation over voxel coordinate grids, generated in
z-slabs so worlds far larger than device memory stream through the device.

The terrain rule is the reference's exactly (``VoxelWorldBuilder.cu:17-34``):
``t = repeaterPerlin(pos * 0.005, 1.0, seed, octaves, 2.0, 0.5) * 1000``,
clamped at 0, and a voxel is solid iff ``y <= t``.  With the default
``seed=0x71889283`` and ``octaves=32`` the generated world is bit-identical
to the reference's (note ``repeater_perlin`` ignores the seed — a preserved
reference quirk, see :mod:`voxelengine_tpu.ops.noise`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from voxelengine_tpu.core.bitgrid import BitGrid, layout_order_bits, pack_bits
from voxelengine_tpu.core.layout import Layout
from voxelengine_tpu.ops.noise import repeater_perlin

DEFAULT_SEED = 0x71889283  # VoxelWorldBuilder.cu:6
DEFAULT_SCALE = 0.005  # VoxelWorldBuilder.cu:10
DEFAULT_OCTAVES = 32  # VoxelWorldBuilder.cu:6


def terrain_density(x, y, z, seed: int = DEFAULT_SEED, octaves: int = DEFAULT_OCTAVES):
    """Height threshold ``t`` at voxel coords (arrays broadcast together).

    ``t = max(repeaterPerlin((x,y,z)*0.005, ...) * 1000, 0)``
    (``VoxelWorldBuilder.cu:17-24``).
    """
    scale = jnp.float32(DEFAULT_SCALE)
    pos = jnp.stack(
        jnp.broadcast_arrays(
            x.astype(jnp.float32) * scale,
            y.astype(jnp.float32) * scale,
            z.astype(jnp.float32) * scale,
        ),
        axis=-1,
    )
    t = repeater_perlin(pos, 1.0, seed, octaves, 2.0, 0.5) * 1000.0
    return jnp.maximum(t, 0.0)


def solid_at(x, y, z, seed: int = DEFAULT_SEED, octaves: int = DEFAULT_OCTAVES):
    """Occupancy at voxel coords: solid iff ``y <= t``
    (``VoxelWorldBuilder.cu:27-34``)."""
    t = terrain_density(x, y, z, seed, octaves)
    return ~(y.astype(jnp.float32) > t)


@functools.partial(jax.jit, static_argnames=("dims", "octaves", "seed"))
def _gen_slab(z0, dims: Tuple[int, int, int], seed: int, octaves: int):
    """Generate one z-slab of dense occupancy, shape [slab_z, Y, X] bool."""
    xdim, ydim, slab_z = dims
    z = z0 + jnp.arange(slab_z)[:, None, None]
    y = jnp.arange(ydim)[None, :, None]
    x = jnp.arange(xdim)[None, None, :]
    return solid_at(x, y, z, seed, octaves)


def generate_world(
    dims: Tuple[int, int, int],
    seed: int = DEFAULT_SEED,
    octaves: int = DEFAULT_OCTAVES,
    layout: Layout = Layout.TILED_LINEAR,
    slab_z: int = 64,
) -> BitGrid:
    """Generate a full dense world as a packed :class:`BitGrid`.

    Equivalent of ``CreateVoxels`` (``VoxelWorldBuilder.cuh:12-32``), but the
    result stays on device as packed words; z-slabs bound peak memory.
    """
    xdim, ydim, zdim = dims
    slab_z = min(slab_z, zdim)
    assert zdim % slab_z == 0, "zdim must be divisible by slab_z"
    # Pack each slab to words as it is generated and concatenate the WORDS
    # (32x smaller than bools), never materializing the dense world: every
    # layout's bit order is z-tile-outermost (LINEAR: z rows; tiled: tz tile
    # rows), so a slab whose height is tile-aligned packs to a contiguous,
    # word-aligned range of the full stream — byte-identical to the
    # single-shot from_dense.
    slab_bits = xdim * ydim * slab_z
    tile_ok = slab_z % 8 == 0 if layout is not Layout.LINEAR else True
    if slab_z == zdim or slab_bits % 32 != 0 or not tile_ok:
        dense = jnp.concatenate(
            [_gen_slab(z0, (xdim, ydim, slab_z), seed, octaves)
             for z0 in range(0, zdim, slab_z)], axis=0,
        )
        return BitGrid.from_dense(dense, layout)
    word_rows = []
    for z0 in range(0, zdim, slab_z):
        slab = _gen_slab(z0, (xdim, ydim, slab_z), seed, octaves)
        word_rows.append(pack_bits(layout_order_bits(slab, layout)))
    return BitGrid(jnp.concatenate(word_rows), (xdim, ydim, zdim), layout)
