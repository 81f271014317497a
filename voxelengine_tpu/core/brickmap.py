"""Two-level brickmap acceleration structure.

Redesign of the reference's brickmap
(``GenerateLowresVoxelBuffer``, ``VolumeRaytracer.cuh:379-516``): instead of a
coarse ``BitArray`` plus 32k individually-``cudaMalloc``'d per-chunk
``VoxelBuffer3D`` objects and a separate ``Bounds3Df`` array
(``VolumeRaytracer.cu:552-565``), the whole structure is three flat device
arrays sized statically:

* ``meta``  — ``int32[num_chunks]``: per-chunk occupancy flag *and* tight
  AABB packed into one word (six 5-bit fields + flag bit), so one gather per
  coarse DDA step fetches everything the traversal needs.  Replaces the
  coarse ``BitArray`` (``VolumeRaytracer.cuh:504-514``) + tight bounds array
  (``VolumeRaytracer.cuh:427-467``).
* ``brick_idx`` — ``int32[num_chunks]``: chunk -> brick-slot indirection.
  In ``dense`` mode it is the identity (every chunk owns a slot; edits never
  allocate — fully jittable).  In ``compact`` mode only occupied chunks own
  slots (memory ~ surface area; read-only scenes).
* ``bricks`` — ``uint32[num_bricks, factor^3/32]``: bit-packed per-chunk
  occupancy in :mod:`~voxelengine_tpu.core.layout` order, the analog of each
  chunk's fine ``VoxelBuffer3D`` grid (``VolumeRaytracer.cuh:421-425``).

The build itself is pure XLA reshape+reduction over dense z-slabs — the
replacement for the reference's ``std::thread`` fan-out
(``VolumeRaytracer.cuh:479-502``) — and streams, so worlds far larger than
device memory (8k x 512 x 8k) build without ever materializing the dense
grid.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from voxelengine_tpu.core.bitgrid import (
    BitGrid,
    layout_order_bits,
    pack_bits,
    words_for_bits,
)
from voxelengine_tpu.core.layout import Layout, sample_index

# meta word layout (factor <= 32 so 5 bits per bound field):
#   [4:0]=min_x [9:5]=min_y [14:10]=min_z [19:15]=max_x [24:20]=max_y
#   [29:25]=max_z [30]=occupied
META_OCC_BIT = 30


def choose_layout(dims: Tuple[int, int, int], want: Layout) -> Layout:
    """Fall back to LINEAR when dims aren't tileable by 8 (the reference
    simply requires divisibility; we degrade gracefully for small tests)."""
    if want is Layout.LINEAR:
        return want
    if all(d % 8 == 0 for d in dims):
        return want
    return Layout.LINEAR


def _full_brick_words(factor: int) -> np.ndarray:
    """The canonical all-full brick word pattern (``uint32[wpb]``): all ones,
    with the tail bits beyond ``factor^3`` masked off for tiny bricks.  The
    single definition of which words an all-full brick dedupes to — the
    compact builders and :func:`compact_brickmap` must agree on it."""
    wpb = words_for_bits(factor**3)
    if factor**3 % 32 != 0:
        return np.asarray(pack_bits(jnp.arange(wpb * 32) < factor**3), np.uint32)
    return np.full((wpb,), 0xFFFFFFFF, np.uint32)


def pack_meta(occ, bmin, bmax):
    """Pack occupancy + tight bounds into the int32 meta word.

    ``bmin``/``bmax`` are int arrays [..., 3] in chunk-local voxels.
    """
    m = (
        bmin[..., 0]
        | (bmin[..., 1] << 5)
        | (bmin[..., 2] << 10)
        | (bmax[..., 0] << 15)
        | (bmax[..., 1] << 20)
        | (bmax[..., 2] << 25)
        | (occ.astype(jnp.int32) << META_OCC_BIT)
    )
    return m.astype(jnp.int32)


def unpack_meta(meta):
    """Inverse of :func:`pack_meta` -> (occ bool, bmin [...,3], bmax [...,3])."""
    occ = ((meta >> META_OCC_BIT) & 1) == 1
    bmin = jnp.stack([meta & 31, (meta >> 5) & 31, (meta >> 10) & 31], axis=-1)
    bmax = jnp.stack([(meta >> 15) & 31, (meta >> 20) & 31, (meta >> 25) & 31], axis=-1)
    return occ, bmin, bmax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BrickMap:
    """Two-level brickmap world state (flat device arrays; see module doc)."""

    meta: jax.Array  # int32[num_chunks]
    brick_idx: jax.Array  # int32[num_chunks]
    bricks: jax.Array  # uint32[num_bricks, factor^3 // 32]
    grid_dims: Tuple[int, int, int] = dataclasses.field(metadata=dict(static=True))
    factor: int = dataclasses.field(metadata=dict(static=True))
    coarse_layout: Layout = dataclasses.field(metadata=dict(static=True))
    brick_layout: Layout = dataclasses.field(metadata=dict(static=True))
    dense_slots: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def world_dims(self) -> Tuple[int, int, int]:
        gx, gy, gz = self.grid_dims
        return (gx * self.factor, gy * self.factor, gz * self.factor)

    @property
    def num_chunks(self) -> int:
        gx, gy, gz = self.grid_dims
        return gx * gy * gz

    @property
    def words_per_brick(self) -> int:
        # ceil, not floor: factors whose cube is not a multiple of 32
        # (5, 6, 7, ...) need the partial tail word
        return words_for_bits(self.factor**3)

    # -- queries (used by tests / host tools; the traversal inlines these) --

    def chunk_index(self, cx, cy, cz):
        gx, gy, gz = self.grid_dims
        return sample_index(cx, cy, cz, gx, gy, self.coarse_layout)

    def voxel_bit(self, x, y, z):
        """Occupancy of a single world voxel (vectorized).  Out-of-range
        coordinates return False (mirrors ``BitGrid.get_bits``; without
        the mask, negative / clamped indices alias real chunks)."""
        f = self.factor
        X, Y, Z = self.world_dims
        x, y, z = jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)
        in_range = (
            (x >= 0) & (x < X) & (y >= 0) & (y < Y) & (z >= 0) & (z < Z)
        )
        x = jnp.clip(x, 0, X - 1)
        y = jnp.clip(y, 0, Y - 1)
        z = jnp.clip(z, 0, Z - 1)
        cx, cy, cz = x // f, y // f, z // f
        lx, ly, lz = x % f, y % f, z % f
        ci = self.chunk_index(cx, cy, cz)
        occ, _, _ = unpack_meta(self.meta[ci])
        slot = self.brick_idx[ci]
        bit = sample_index(lx, ly, lz, f, f, self.brick_layout)
        word = self.bricks[jnp.maximum(slot, 0), bit >> 5]
        val = ((word >> (bit & 31).astype(jnp.uint32)) & 1) == 1
        return val & occ & (slot >= 0) & in_range

    def to_dense(self) -> jax.Array:
        """Unpack the whole world to bool [Z, Y, X] (small worlds/tests)."""
        X, Y, Z = self.world_dims
        x, y, z = jnp.meshgrid(jnp.arange(X), jnp.arange(Y), jnp.arange(Z), indexing="ij")
        return self.voxel_bit(x, y, z).transpose(2, 1, 0)


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("factor", "chunks_y", "chunks_x", "brick_layout")
)
def _slab_to_chunks(slab, factor: int, chunks_y: int, chunks_x: int, brick_layout: Layout):
    """Reduce one dense z-slab [factor, Y, X] (bool, z-major) into per-chunk
    (occupancy, bounds, packed brick words) for the chunk row it covers.

    Pure XLA reshapes+reductions — the replacement for the reference's
    per-chunk triple loop + host threads (``VolumeRaytracer.cuh:434-502``).
    Returns (occ [cy*cx], bmin [cy*cx, 3], bmax [cy*cx, 3],
    words [cy*cx, factor^3//32]) with chunks in (cy, cx) row-major order.
    """
    f = factor
    # [f(z), cy, f(y), cx, f(x)] -> chunk-major [cy, cx, f(z), f(y), f(x)]
    c = slab.reshape(f, chunks_y, f, chunks_x, f).transpose(1, 3, 0, 2, 4)
    occ = jnp.any(c, axis=(2, 3, 4))

    def axis_bounds(axis):  # axis: 2=z,3=y,4=x within c
        red = tuple(a for a in (2, 3, 4) if a != axis)
        any_line = jnp.any(c, axis=red)  # [cy, cx, f]
        lo = jnp.argmax(any_line, axis=-1)
        hi = f - 1 - jnp.argmax(any_line[..., ::-1], axis=-1)
        return lo.astype(jnp.int32), hi.astype(jnp.int32)

    zlo, zhi = axis_bounds(2)
    ylo, yhi = axis_bounds(3)
    xlo, xhi = axis_bounds(4)
    # empty chunks: min=0, max=-1 like the reference's sentinel
    # (VolumeRaytracer.cuh:454-463) — but bounds are only read when occ=1.
    bmin = jnp.stack([xlo, ylo, zlo], axis=-1) * occ[..., None]
    bmax = jnp.where(occ[..., None], jnp.stack([xhi, yhi, zhi], axis=-1), -1)

    # brick bit packing in brick_layout order via reshape/transpose
    # (scatter-free)
    cc = c.reshape(chunks_y * chunks_x, f, f, f)  # [chunk, z, y, x]
    flat = jax.vmap(lambda blk: layout_order_bits(blk, brick_layout))(cc)
    nbits = words_for_bits(f**3) * 32
    if flat.shape[1] < nbits:
        flat = jnp.concatenate(
            [flat, jnp.zeros((flat.shape[0], nbits - flat.shape[1]), jnp.bool_)], axis=1
        )
    words = jax.vmap(pack_bits)(flat)
    return (
        occ.reshape(-1),
        bmin.reshape(-1, 3),
        bmax.reshape(-1, 3),
        words,
    )


def build_brickmap_terrain(
    world_dims: Tuple[int, int, int],
    factor: int,
    seed: int = 0x71889283,
    octaves: int = 32,
    brick_layout: Layout = Layout.TILED_LINEAR,
) -> BrickMap:
    """Fully device-side terrain world build: fuses worldgen + brickmap
    reduction per chunk-slab under one jit and never round-trips dense
    voxels through the host (the host<->device link is far slower than
    device memory).  Produces a ``dense_slots`` brickmap with
    LINEAR coarse layout (build order == layout order, so no permutation
    pass is needed).

    Equivalent of ``CreateVoxels`` + ``GenerateLowresVoxelBuffer``
    (``VoxelWorldBuilder.cuh:12-32``, ``VolumeRaytracer.cuh:379``) in one
    streaming pass.
    """
    from voxelengine_tpu.worldgen.terrain import solid_at  # cycle-free import

    X, Y, Z = world_dims
    f = factor
    assert X % f == 0 and Y % f == 0 and Z % f == 0 and f <= 32
    gx, gy, gz = X // f, Y // f, Z // f
    brick_layout = choose_layout((f, f, f), brick_layout)

    @functools.partial(jax.jit, static_argnames=())
    def do_slab(z0):
        z = z0 + jnp.arange(f)[:, None, None]
        y = jnp.arange(Y)[None, :, None]
        x = jnp.arange(X)[None, None, :]
        slab = solid_at(x, y, z, seed, octaves)
        return _slab_to_chunks(slab, f, gy, gx, brick_layout)

    occs, bmins, bmaxs, words = [], [], [], []
    for cz in range(gz):
        occ, bmn, bmx, w = do_slab(jnp.int32(cz * f))
        occs.append(occ)
        bmins.append(bmn)
        bmaxs.append(bmx)
        words.append(w)
    occ = jnp.concatenate(occs)
    bmn = jnp.maximum(jnp.concatenate(bmins), 0)
    bmx = jnp.maximum(jnp.concatenate(bmaxs), 0)
    meta = pack_meta(occ, bmn, bmx)
    bricks = jnp.concatenate(words)
    return BrickMap(
        meta=meta,
        brick_idx=jnp.arange(gx * gy * gz, dtype=jnp.int32),
        bricks=bricks,
        grid_dims=(gx, gy, gz),
        factor=f,
        coarse_layout=Layout.LINEAR,
        brick_layout=brick_layout,
        dense_slots=True,
    )


def build_brickmap_terrain_compact(
    world_dims: Tuple[int, int, int],
    factor: int,
    seed: int = 0x71889283,
    octaves: int = 32,
    brick_layout: Layout = Layout.TILED_LINEAR,
    bucket: int = 512,
    host_stage: Optional[bool] = None,
) -> BrickMap:
    """Device-side terrain build that goes *directly* to compact indirection,
    never materializing the O(volume) dense brick table.

    :func:`build_brickmap_terrain` keeps one brick per chunk — 4.3 GB for the
    8k x 512 x 8k world, with a ~2x transient at the final concatenation.
    Terrain worlds are uniform almost everywhere: only
    chunks crossing the surface need their own brick.  This builder reduces
    each worldgen slab on device, keeps only the non-uniform occupied chunks
    (all-full chunks share canonical slot 0, like
    :func:`compact_brickmap`), and streams them out slab by slab, so peak
    memory is O(surface) + one 16 MB slab.

    ``bucket``: kept-chunk counts are padded up to a multiple of this so the
    per-slab gather compiles for only a handful of shapes.

    ``host_stage``: pull each slab's kept bricks to the host and upload the
    assembled table once, instead of accumulating slab parts on device and
    concatenating there (which peaks at 2x the brick table, ~15 GB for the
    16k x 512 x 16k world's ~7.5 GB table).  Default:
    auto-on for worlds whose chunk plane exceeds 200k chunks (16k-class;
    the 8k world keeps the all-device path).  Costs one-time d2h bandwidth
    on a build that is disk-cached anyway.

    Matches the reference's world exactly (same worldgen + reduction as the
    dense path; covered by tests against :func:`build_brickmap_terrain`).
    """
    from voxelengine_tpu.worldgen.terrain import solid_at  # cycle-free import

    X, Y, Z = world_dims
    f = factor
    assert X % f == 0 and Y % f == 0 and Z % f == 0 and f <= 32
    gx, gy, gz = X // f, Y // f, Z // f
    brick_layout = choose_layout((f, f, f), brick_layout)
    wpb = words_for_bits(f**3)
    full_words = _full_brick_words(f)
    full_dev = jnp.asarray(full_words)

    @jax.jit
    def do_slab(z0):
        z = z0 + jnp.arange(f)[:, None, None]
        y = jnp.arange(Y)[None, :, None]
        x = jnp.arange(X)[None, None, :]
        slab = solid_at(x, y, z, seed, octaves)
        occ, bmn, bmx, words = _slab_to_chunks(slab, f, gy, gx, brick_layout)
        is_full = jnp.all(words == full_dev[None, :], axis=1)
        keep = occ & ~is_full
        # stable argsort floats kept chunks to the front in chunk order
        order = jnp.argsort(~keep)
        return occ, keep, bmn, bmx, words, order

    @functools.partial(jax.jit, static_argnames=("k",))
    def take_rows(words, order, k: int):
        return jnp.take(words, order[:k], axis=0)

    if host_stage is None:
        host_stage = gx * gz >= 200_000
    per_slab = gy * gx
    occ_parts, bmin_parts, bmax_parts = [], [], []
    slot_parts, brick_parts = [], []
    next_slot = 1  # slot 0 = shared all-full brick
    for cz in range(gz):
        occ, keep, bmn, bmx, words, order = do_slab(jnp.int32(cz * f))
        keep_h = np.asarray(keep)
        occ_h = np.asarray(occ)
        cnt = int(keep_h.sum())
        if cnt:
            k = min(per_slab, -(-cnt // bucket) * bucket)
            part = take_rows(words, order, k)[:cnt]
            brick_parts.append(np.asarray(part) if host_stage else part)
        slots = np.full((per_slab,), -1, np.int32)
        slots[occ_h & ~keep_h] = 0
        slots[keep_h] = next_slot + np.arange(cnt, dtype=np.int32)
        next_slot += cnt
        slot_parts.append(slots)
        occ_parts.append(occ_h)
        bmin_parts.append(np.asarray(bmn))
        bmax_parts.append(np.asarray(bmx))

    occ = jnp.asarray(np.concatenate(occ_parts))
    bmn = jnp.asarray(np.maximum(np.concatenate(bmin_parts), 0))
    bmx = jnp.asarray(np.maximum(np.concatenate(bmax_parts), 0))
    meta = pack_meta(occ, bmn, bmx)
    if host_stage:
        bricks = jnp.asarray(
            np.concatenate([full_words[None, :]] + brick_parts, axis=0)
        )
    else:
        bricks = jnp.concatenate([full_dev[None, :]] + brick_parts, axis=0)
    return BrickMap(
        meta=meta,
        brick_idx=jnp.asarray(np.concatenate(slot_parts)),
        bricks=bricks,
        grid_dims=(gx, gy, gz),
        factor=f,
        coarse_layout=Layout.LINEAR,
        brick_layout=brick_layout,
        dense_slots=False,
    )


def compact_brickmap(bm: BrickMap, dedupe_uniform: bool = True) -> BrickMap:
    """Convert a ``dense_slots`` brickmap to compact indirection on device.

    Keeps one shared all-full brick (slot 0) and one brick per non-uniform
    occupied chunk.  For terrain worlds this shrinks the brick table from
    O(volume) to O(surface area) — e.g. 1024^3/f32: 134 MB -> a few MB —
    which also moves traversal gathers onto much smaller tables.  Only the
    keep-mask (num_chunks bits) round-trips to the host (for the static
    output shape); brick words never leave the device.
    """
    assert bm.dense_slots, "compact_brickmap expects a dense_slots brickmap"
    wpb = bm.words_per_brick
    occ = ((bm.meta >> META_OCC_BIT) & 1) == 1
    full_words = _full_brick_words(bm.factor)
    is_full = jnp.all(bm.bricks == jnp.asarray(full_words)[None, :], axis=1)
    keep = np.asarray(occ & (~is_full if dedupe_uniform else True))
    occ_h = np.asarray(occ)

    kept_idx = np.nonzero(keep)[0].astype(np.int32)
    slots = np.full(bm.num_chunks, -1, np.int32)
    base = 1 if dedupe_uniform else 0
    slots[kept_idx] = base + np.arange(kept_idx.shape[0], dtype=np.int32)
    if dedupe_uniform:
        slots[occ_h & ~keep] = 0

    kept = jnp.take(bm.bricks, jnp.asarray(kept_idx), axis=0)
    if dedupe_uniform:
        bricks = jnp.concatenate([jnp.asarray(full_words)[None, :], kept])
    else:
        bricks = kept if kept.shape[0] else jnp.zeros((1, wpb), jnp.uint32)
    return dataclasses.replace(
        bm, brick_idx=jnp.asarray(slots), bricks=bricks, dense_slots=False
    )


def build_brickmap_from_fn(
    slab_fn: Callable[[int], np.ndarray],
    world_dims: Tuple[int, int, int],
    factor: int,
    coarse_layout: Layout = Layout.TILED_LINEAR,
    brick_layout: Layout = Layout.TILED_LINEAR,
    dense_slots: bool = False,
    dedupe_uniform: bool = True,
) -> BrickMap:
    """Build a :class:`BrickMap` by streaming dense z-slabs.

    ``slab_fn(z0)`` must return the dense occupancy slab
    ``bool[factor, Y, X]`` for world rows ``z0 .. z0+factor``.  Slabs stream
    through the device one chunk-row at a time, so arbitrarily large worlds
    build in O(slab) memory.

    dense_slots: every chunk owns a brick slot (identity indirection) —
      required for jittable in-place edits.
    dedupe_uniform: in compact mode, all-full and all-empty bricks share
      canonical slots (slot 0 = all-full), shrinking memory by the solid
      interior volume.  (All-empty occupied chunks cannot occur.)
    """
    X, Y, Z = world_dims
    f = factor
    assert X % f == 0 and Y % f == 0 and Z % f == 0, "world dims must be chunk-aligned"
    assert f <= 32, "meta packing supports factor <= 32"
    gx, gy, gz = X // f, Y // f, Z // f
    coarse_layout = choose_layout((gx, gy, gz), coarse_layout)
    brick_layout = choose_layout((f, f, f), brick_layout)
    wpb = words_for_bits(f**3)

    occ_parts, bmin_parts, bmax_parts = [], [], []
    brick_rows = []  # per-slab compacted brick words (host)
    slot_parts = []
    next_slot = 1 if (dedupe_uniform and not dense_slots) else 0
    full_words = _full_brick_words(f)

    for cz in range(gz):
        slab = np.asarray(slab_fn(cz * f))
        occ, bmin, bmax, words = _slab_to_chunks(
            jnp.asarray(slab), f, gy, gx, brick_layout
        )
        occ = np.asarray(occ)
        words = np.asarray(words)
        occ_parts.append(occ)
        bmin_parts.append(np.asarray(bmin))
        bmax_parts.append(np.asarray(bmax))
        if dense_slots:
            brick_rows.append(words)
        else:
            slots = np.full(occ.shape, -1, np.int32)
            keep = occ.copy()
            if dedupe_uniform:
                is_full = (words == full_words[None, :]).all(axis=1)
                slots[occ & is_full] = 0
                keep = occ & ~is_full
            kept_words = words[keep]
            slots[keep] = next_slot + np.arange(kept_words.shape[0], dtype=np.int32)
            next_slot += kept_words.shape[0]
            brick_rows.append(kept_words)
            slot_parts.append(slots)

    occ = np.concatenate(occ_parts)
    bmin = np.concatenate(bmin_parts)
    bmax = np.concatenate(bmax_parts)
    num_chunks = gx * gy * gz

    # scatter from build (cy,cx,cz row-major) order into coarse layout order
    cx_, cy_, cz_ = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz), indexing="ij")
    # build order: cz outer, then (cy, cx) row-major within slab
    build_order = (cz_ * (gx * gy) + cy_ * gx + cx_).reshape(-1)
    lay_order = np.asarray(
        sample_index(cx_, cy_, cz_, gx, gy, coarse_layout)
    ).reshape(-1)
    perm = np.empty(num_chunks, np.int64)
    perm[lay_order] = build_order

    meta = np.asarray(
        pack_meta(
            jnp.asarray(occ[perm]),
            jnp.asarray(np.maximum(bmin[perm], 0).astype(np.int32)),
            jnp.asarray(np.maximum(bmax[perm], 0).astype(np.int32)),
        )
    )

    if dense_slots:
        bricks = np.concatenate(brick_rows, axis=0)[perm]
        brick_idx = np.arange(num_chunks, dtype=np.int32)
    else:
        slots = np.concatenate(slot_parts)[perm]
        if dedupe_uniform:
            bricks = np.concatenate([full_words[None, :]] + brick_rows, axis=0)
        else:
            bricks = (
                np.concatenate(brick_rows, axis=0)
                if brick_rows and sum(r.shape[0] for r in brick_rows)
                else np.zeros((1, wpb), np.uint32)
            )
        if bricks.shape[0] == 0:
            bricks = np.zeros((1, wpb), np.uint32)
        brick_idx = slots.astype(np.int32)

    return BrickMap(
        meta=jnp.asarray(meta),
        brick_idx=jnp.asarray(brick_idx),
        bricks=jnp.asarray(bricks),
        grid_dims=(gx, gy, gz),
        factor=f,
        coarse_layout=coarse_layout,
        brick_layout=brick_layout,
        dense_slots=dense_slots,
    )


def build_brickmap(
    grid: BitGrid,
    factor: int,
    dense_slots: bool = True,
    dedupe_uniform: bool = False,
    coarse_layout: Layout = Layout.TILED_LINEAR,
    brick_layout: Layout = Layout.TILED_LINEAR,
) -> BrickMap:
    """Build a brickmap from an in-memory dense :class:`BitGrid`.

    Convenience equivalent of ``GenerateLowresVoxelBuffer(buffer, factor)``
    (``VolumeRaytracer.cuh:379``); defaults to editable ``dense_slots`` mode
    like the reference demo's always-allocated chunks.
    """
    dense = np.asarray(grid.to_dense())  # [Z, Y, X]

    def slab_fn(z0):
        return dense[z0 : z0 + factor]

    return build_brickmap_from_fn(
        slab_fn,
        grid.dims,
        factor,
        coarse_layout=coarse_layout,
        brick_layout=brick_layout,
        dense_slots=dense_slots,
        dedupe_uniform=dedupe_uniform,
    )


# ---------------------------------------------------------------------------
# edits (voxel place/break)
# ---------------------------------------------------------------------------


def _edit_coords(bm: BrickMap, x, y, z):
    """Shared edit addressing: chunk ids, packed bit, word column, bit mask."""
    f = bm.factor
    ci = bm.chunk_index(x // f, y // f, z // f)
    bit = sample_index(x % f, y % f, z % f, f, f, bm.brick_layout)
    word_col = bit >> 5
    mask = (jnp.uint32(1) << (bit & 31).astype(jnp.uint32)).astype(jnp.uint32)
    return ci, word_col, mask


def _apply_edits_impl(bm: BrickMap, x, y, z, value) -> BrickMap:
    assert bm.dense_slots, "edits require dense_slots brickmaps"
    f = bm.factor
    value = jnp.broadcast_to(jnp.asarray(value, jnp.bool_), x.shape)

    ci, word_col, mask = _edit_coords(bm, x, y, z)

    # sequential word read-modify-write so edits landing in the same uint32
    # word (adjacent voxels) compose correctly — the role of the reference's
    # atomicOr/atomicAnd (VolumeRaytracer.cu:21-26); K is small per frame.
    def body(i, w):
        cur = w[ci[i], word_col[i]]
        nxt = jnp.where(value[i], cur | mask[i], cur & ~mask[i])
        return w.at[ci[i], word_col[i]].set(nxt)

    words = jax.lax.fori_loop(0, x.shape[0], body, bm.bricks)

    # refresh meta for touched chunks: gather brick, recompute bounds
    uci = ci  # recompute per edit; duplicates are idempotent
    bw = words[uci]  # [K, wpb]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((bw[:, :, None] >> shifts) & 1).astype(jnp.bool_).reshape(bw.shape[0], -1)
    lx = jnp.arange(f)[None, None, :]
    ly = jnp.arange(f)[None, :, None]
    lz = jnp.arange(f)[:, None, None]
    bidx = sample_index(lx, ly, lz, f, f, bm.brick_layout)  # [f,f,f] z,y,x
    vol = bits[:, bidx.reshape(-1)].reshape(-1, f, f, f)  # [K, z, y, x]
    occ = jnp.any(vol, axis=(1, 2, 3))

    def bounds(axis):
        red = tuple(a for a in (1, 2, 3) if a != axis)
        line = jnp.any(vol, axis=red)
        lo = jnp.argmax(line, axis=-1).astype(jnp.int32)
        hi = (f - 1 - jnp.argmax(line[:, ::-1], axis=-1)).astype(jnp.int32)
        return lo, hi

    zlo, zhi = bounds(1)
    ylo, yhi = bounds(2)
    xlo, xhi = bounds(3)
    bmin = jnp.stack([xlo, ylo, zlo], axis=-1) * occ[:, None]
    bmax = jnp.stack([xhi, yhi, zhi], axis=-1) * occ[:, None]
    meta = bm.meta.at[uci].set(pack_meta(occ, bmin, bmax))
    return dataclasses.replace(bm, meta=meta, bricks=words)


@functools.partial(jax.jit, donate_argnums=(0,))
def apply_edits(bm: BrickMap, x, y, z, value) -> BrickMap:
    """Set a batch of world voxels to ``value`` and incrementally refresh the
    coarse occupancy + tight bounds of the touched chunks.

    Requires ``dense_slots`` mode (static shapes; no allocation).  This is
    the capability the reference's atomic ``BitRef`` writes enable but never
    wire to input (``VolumeRaytracer.cu:19-36``).  Buffer donation makes the
    update in-place on device.
    """
    x = jnp.atleast_1d(jnp.asarray(x))
    y = jnp.atleast_1d(jnp.asarray(y))
    z = jnp.atleast_1d(jnp.asarray(z))
    return _apply_edits_impl(bm, x, y, z, value)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def apply_edits_fused(bm: BrickMap, fused, x, y, z, value):
    """:func:`apply_edits` plus an O(edits) in-place refresh of the fused
    ``[meta | bricks]`` lookup table (:func:`voxelengine_tpu.ops.trace.
    make_fused_table`) — K word writes instead of re-concatenating the
    multi-GB table (round-1 edit latency was O(world) for exactly that
    reason; the reference's analog is a few atomic word writes,
    ``VolumeRaytracer.cu:19-36``).  Returns ``(bm, fused)``.
    """
    x = jnp.atleast_1d(jnp.asarray(x))
    y = jnp.atleast_1d(jnp.asarray(y))
    z = jnp.atleast_1d(jnp.asarray(z))
    bm2 = _apply_edits_impl(bm, x, y, z, value)
    return bm2, _update_fused_words_impl(bm2, fused, x, y, z)


def _update_fused_words_impl(bm2: BrickMap, fused, x, y, z):
    ci, word_col, _ = _edit_coords(bm2, x, y, z)
    wpb = bm2.words_per_brick
    fused = fused.at[ci].set(bm2.meta[ci])
    new_words = jax.lax.bitcast_convert_type(
        bm2.bricks[ci, word_col], jnp.int32
    )
    return fused.at[bm2.num_chunks + ci * wpb + word_col].set(new_words)
