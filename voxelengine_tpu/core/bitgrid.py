"""Bit-packed voxel occupancy storage.

JAX equivalent of the reference's ``BitArray``/``BitRef``/``VoxelBuffer``
(``VolumeRaytracer.cuh:204-233``, ``VolumeRaytracer.cu:15-93``): one bit per
voxel packed into ``uint32`` words, with the bit index given by a
:class:`~voxelengine_tpu.core.layout.Layout` swizzle.

Instead of a pointer + per-bit atomic RMW object, a :class:`BitGrid` is an
immutable pytree of one flat ``uint32`` device array plus static metadata.
"Writes" are functional masked word updates (XLA fuses them; donation makes
them in-place), which is both the idiomatic JAX design and what the
reference's atomics were emulating (32 voxels share a word,
``VolumeRaytracer.cu:19-36``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from voxelengine_tpu.core.layout import Layout, sample_index


def words_for_bits(num_bits: int) -> int:
    """Number of uint32 words backing ``num_bits`` (``VolumeRaytracer.cu:44``)."""
    return (num_bits + 31) // 32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BitGrid:
    """A 3D voxel occupancy grid: packed bits + dimensions + layout.

    Equivalent of ``VoxelBuffer3D`` (``VolumeRaytracer.cuh:227-233``), with the
    backing ``BitArray`` inlined as ``words``.

    Attributes:
      words: flat ``uint32[ceil(X*Y*Z/32)]`` array; bit ``i`` of the grid (in
        ``layout`` order) is ``(words[i // 32] >> (i % 32)) & 1``.
      dims: static ``(X, Y, Z)`` dimensions.
      layout: static sample-index layout.
    """

    words: jax.Array
    dims: Tuple[int, int, int] = dataclasses.field(metadata=dict(static=True))
    layout: Layout = dataclasses.field(metadata=dict(static=True))

    @property
    def num_bits(self) -> int:
        x, y, z = self.dims
        return x * y * z

    # -- constructors ------------------------------------------------------

    @staticmethod
    def zeros(dims: Tuple[int, int, int], layout: Layout = Layout.TILED_LINEAR) -> "BitGrid":
        n = dims[0] * dims[1] * dims[2]
        return BitGrid(jnp.zeros((words_for_bits(n),), jnp.uint32), tuple(dims), layout)

    @staticmethod
    def from_dense(dense, layout: Layout = Layout.TILED_LINEAR) -> "BitGrid":
        """Pack a dense bool array indexed ``[z, y, x]`` into a BitGrid.

        The ``[z, y, x]`` axis order matches the reference's loop nesting
        (z-outermost, e.g. ``VolumeRaytracer.cuh:434-436``).
        """
        dense = jnp.asarray(dense)
        zdim, ydim, xdim = dense.shape
        dims = (xdim, ydim, zdim)
        bits = layout_order_bits(dense, layout)
        pad = words_for_bits(bits.shape[0]) * 32 - bits.shape[0]
        if pad:
            bits = jnp.concatenate([bits, jnp.zeros((pad,), jnp.bool_)])
        return BitGrid(pack_bits(bits), dims, layout)

    # -- accessors ---------------------------------------------------------

    def to_dense(self) -> jax.Array:
        """Unpack to a dense bool array indexed ``[z, y, x]``."""
        xdim, ydim, zdim = self.dims
        bits = unpack_bits(self.words)[: xdim * ydim * zdim]
        return layout_order_bits_inverse(bits, (xdim, ydim, zdim), self.layout)

    def get_bits(self, x, y, z):
        """Vectorized occupancy read at integer voxel coords.

        Out-of-range reads return ``False``, matching ``BitArray::operator[]``
        (``VolumeRaytracer.cu:61-68``) and the DDA's reliance on it.
        """
        xdim, ydim, zdim = self.dims
        in_range = (
            (x >= 0) & (x < xdim) & (y >= 0) & (y < ydim) & (z >= 0) & (z < zdim)
        )
        xs = jnp.clip(x, 0, xdim - 1)
        ys = jnp.clip(y, 0, ydim - 1)
        zs = jnp.clip(z, 0, zdim - 1)
        idx = sample_index(xs, ys, zs, xdim, ydim, self.layout)
        word = self.words[idx >> 5]
        bit = (word >> (idx & 31).astype(jnp.uint32)) & 1
        return (bit == 1) & in_range

    def set_bits(self, x, y, z, value) -> "BitGrid":
        """Functional write: returns a new grid with bits at (x, y, z) set to
        ``value`` (broadcastable bool).  Equivalent of ``BitRef::operator=``
        (``VolumeRaytracer.cu:19-36``); XLA's scatter handles the
        32-voxels-per-word aliasing the reference needed atomics for.
        """
        xdim, ydim, zdim = self.dims
        x = jnp.asarray(x)
        value = jnp.broadcast_to(jnp.asarray(value, jnp.bool_), x.shape)
        idx = sample_index(x, y, z, xdim, ydim, self.layout)
        bits = unpack_bits(self.words)
        bits = bits.at[idx.reshape(-1)].set(value.reshape(-1))
        return dataclasses.replace(self, words=pack_bits(bits))

    def count(self) -> jax.Array:
        """Population count over the whole grid (number of solid voxels)."""
        return jnp.sum(popcount32(self.words).astype(jnp.int32))


def _morton_perm(n: int) -> np.ndarray:
    """Static permutation: Morton index within an 8^3 tile -> linear
    (z, y, x) offset within the tile."""
    m = np.arange(512)

    def compact(x):
        x = x & 0x00249249
        x = (x ^ (x >> 2)) & 0x000C30C3
        x = (x ^ (x >> 4)) & 0x00000F00F
        x = (x ^ (x >> 8)) & 0x0000000FF
        return x

    lx, ly, lz = compact(m), compact(m >> 1), compact(m >> 2)
    return (lz * 64 + ly * 8 + lx).astype(np.int32)


def layout_order_bits(dense: jax.Array, layout: Layout) -> jax.Array:
    """Flatten a dense [Z, Y, X] bool array into layout bit order using pure
    reshape/transpose (no scatter).  Tiled modes require dims divisible by 8, like the reference."""
    zdim, ydim, xdim = dense.shape
    if layout is Layout.LINEAR:
        return dense.reshape(-1)
    tz, ty, tx = zdim // 8, ydim // 8, xdim // 8
    t = dense.reshape(tz, 8, ty, 8, tx, 8).transpose(0, 2, 4, 1, 3, 5)
    if layout is Layout.TILED_LINEAR:
        # tiles ordered (tz, ty, tx) x-fastest; within-tile (lz, ly, lx)
        return t.reshape(-1)
    # TILED_MORTON: permute within-tile bits into Morton order
    flat = t.reshape(tz * ty * tx, 512)
    return flat[:, jnp.asarray(_morton_perm(512))].reshape(-1)


def layout_order_bits_inverse(bits: jax.Array, dims, layout: Layout) -> jax.Array:
    """Inverse of :func:`layout_order_bits`: flat layout-order bits ->
    dense [Z, Y, X]."""
    xdim, ydim, zdim = dims
    if layout is Layout.LINEAR:
        return bits.reshape(zdim, ydim, xdim)
    tz, ty, tx = zdim // 8, ydim // 8, xdim // 8
    if layout is Layout.TILED_MORTON:
        inv = np.empty(512, np.int32)
        inv[_morton_perm(512)] = np.arange(512)
        bits = bits.reshape(tz * ty * tx, 512)[:, jnp.asarray(inv)].reshape(-1)
    t = bits.reshape(tz, ty, tx, 8, 8, 8)
    return t.transpose(0, 3, 1, 4, 2, 5).reshape(zdim, ydim, xdim)


def pack_bits(bits: jax.Array) -> jax.Array:
    """Pack a flat bool array (length a multiple of 32) into uint32 words,
    bit ``i`` -> word ``i // 32`` bit ``i % 32`` (LSB-first, matching
    ``VolumeRaytracer.cu:61-73``)."""
    b = bits.reshape(-1, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def unpack_bits(words: jax.Array) -> jax.Array:
    """Inverse of :func:`pack_bits`: uint32 words -> flat bool array."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return (((words[:, None] >> shifts) & 1) == 1).reshape(-1)


def popcount32(words: jax.Array) -> jax.Array:
    """Per-word population count (SWAR, uint32)."""
    v = words.astype(jnp.uint32)
    v = v - ((v >> 1) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> 2) & jnp.uint32(0x33333333))
    v = (v + (v >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (v * jnp.uint32(0x01010101)) >> 24


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`pack_bits` for host-side/oracle use."""
    b = bits.reshape(-1, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return np.bitwise_or.reduce(b << shifts, axis=-1).astype(np.uint32)
