"""Multi-device scale-out via ``shard_map`` over a ``jax.sharding.Mesh``.

The reference engine is strictly single-GPU (no NCCL/MPI anywhere — see
SURVEY.md P1-P6); its "communication backend" is cudaMemcpy + kernel
launches.  The scale-out here is embarrassingly parallel pixel-space
sharding: each device traces its own pixel shard against a *replicated*
brickmap, so the frame path never touches the interconnect; only
diagnostics (step histograms) use a ``psum``.

Two shard layouts (both exact vs the single-device render):

- :func:`render_frame_sharded` — contiguous pre-remap row bands, device
  *i* owns rows ``[i*rows/n, (i+1)*rows/n)``; the framebuffer shards as a
  plain ``P('rows')`` raster image.
- :func:`render_frame_cyclic` — pixel blocks dealt round-robin (block
  ``j`` -> device ``j % N``), which evens out the row bands' sky-vs-terrain
  load skew.  The framebuffer lives block-cyclic on device;
  :func:`cyclic_to_image` reassembles host-side at present time.

A ray-batch variant (``raytrace_sharded``) shards the flat ray axis for the
batch query API.  Both paths also run unmodified on a 1-device mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from voxelengine_tpu.config import Environment, RenderConfig
from voxelengine_tpu.core.brickmap import BrickMap
from voxelengine_tpu.ops.trace import TraceOut
from voxelengine_tpu.ops.traverse import trace_rays
from voxelengine_tpu.render import camera as cam
from voxelengine_tpu.render.frame import block_geometry, shade_pixels
from voxelengine_tpu.config import Projection

F32 = jnp.float32


def make_mesh(devices=None, axis: str = "rows") -> Mesh:
    """A 1D device mesh over the pixel-row axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _rays_for_pixels(cfg: RenderConfig, origin, euler, frame_number,
                     px, py_r, osz):
    """Primary rays for an arbitrary set of (px, pre-remap py) pixels —
    the per-shard core of :func:`...render.frame.primary_rays` (same
    checkerboard remap, projection, and camera math)."""
    W, H = cfg.width, cfg.height
    py = (
        py_r * 2
        + jnp.where(px % 2 == 0, 1, 0)
        + jnp.where(frame_number % 2 == 0, 1, 0)
    ) if cfg.checkerboard else py_r
    u = px.astype(F32) / F32(W)
    v = py.astype(F32) / F32(H)
    fwd, up, right = cam.get_directions(euler)
    o = jnp.asarray(origin, F32)
    if cfg.projection is Projection.PERSPECTIVE:
        dirs = cam.ray_direction(fwd, up, right, W, H, u, v, cfg.fov_degrees)
        origins = jnp.broadcast_to(o, dirs.shape)
    else:
        dirs = jnp.broadcast_to(fwd, (px.shape[0], 3))
        origins = cam.ray_origin_ortho(fwd, up, right, W, H, u, v, o, osz)
    return origins, dirs, py


def replicate_world(mesh: Mesh, bm: BrickMap) -> BrickMap:
    """Replicate the brickmap arrays across the mesh."""
    rep = NamedSharding(mesh, P())
    return jax.device_put(bm, rep)


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh"), donate_argnums=(1,)
)
def render_frame_sharded(
    bm: BrickMap,
    framebuffer: jax.Array,
    origin,
    euler,
    env: Environment,
    frame_number,
    cfg: RenderConfig,
    mesh: Mesh,
    ortho_size=None,
) -> jax.Array:
    """Row-sharded frame render: ``render_frame`` semantics, N devices.

    The framebuffer should be sharded ``P('rows')``; the world replicated
    (see :func:`replicate_world`).  Returns the sharded framebuffer.

    Each device renders its own contiguous block of pre-remap rows with
    the SAME machinery as the single-device path — tile-order ray
    blocking, the platform's traversal, and the scatter-free pair-select
    composite (:func:`...render.frame.composite_frame`).
    The checkerboard remap ``y = 2y' + (x even) + (frame even)`` commutes
    with row blocks; the only seam is the even-frame ``+2`` crossing,
    covered by one halo ray row per device (zero communication).
    """
    from voxelengine_tpu.render.frame import _block_side

    W, H = cfg.width, cfg.height
    n = mesh.devices.size
    cb = cfg.checkerboard
    rows_total = H // 2 if cb else H
    assert H % n == 0 and rows_total % n == 0, "height must divide the mesh"
    assert not (cb and H % 2), "checkerboard sharding needs even height"
    rows_local = rows_total // n
    bw, bh = _block_side(W), _block_side(rows_local)
    blocked = cfg.tile_order and bw * bh > 1

    # ortho window as a TRACED value (matches render.frame.primary_rays:
    # interactive zoom must not recompile the sharded path either)
    osz = jnp.asarray(
        cfg.ortho_size if ortho_size is None else ortho_size, F32
    )

    def rays_for_rows(origin, euler, frame_number, px, py_r, osz):
        return _rays_for_pixels(cfg, origin, euler, frame_number, px, py_r, osz)

    def unblock_local(a):
        rest = a.shape[1:]
        if blocked:
            a = a.reshape(rows_local // bh, W // bw, bh, bw, *rest)
            a = a.transpose(0, 2, 1, 3, *range(4, 4 + len(rest)))
        return a.reshape(rows_local, W, *rest)

    def tile(bm, fb_block, origin, euler, env, frame_number, osz):
        dev = jax.lax.axis_index("rows")
        row0 = dev * rows_local
        xg, yg = jnp.meshgrid(jnp.arange(W), jnp.arange(rows_local), indexing="xy")
        if blocked:
            def blk(a):
                return (
                    a.reshape(rows_local // bh, bh, W // bw, bw)
                    .transpose(0, 2, 1, 3).reshape(-1)
                )
            px, py_rl = blk(xg), blk(yg)
        else:
            px, py_rl = xg.reshape(-1), yg.reshape(-1)
        py_r = py_rl + row0
        if cb:
            # halo strip: the device's first fb row pair receives the even-
            # frame +2 writes of the PREVIOUS device's last pre-remap row;
            # recompute that row locally (1/rows_local extra rays, no comm)
            px = jnp.concatenate([px, jnp.arange(W)])
            py_r = jnp.concatenate([py_r, jnp.full((W,), row0 - 1)])
        origins, dirs, py = rays_for_rows(
            origin, euler, frame_number, px, py_r, osz
        )
        color, write = shade_pixels(
            bm, origins, dirs, px, py, py_r, origin, env, frame_number, cfg
        )
        if not cb:
            h = unblock_local(color)
            w = unblock_local(write)
            return jnp.where(w[..., None], h, fb_block)
        n_main = rows_local * W
        h_main = unblock_local(color[:n_main])
        w_main = unblock_local(write[:n_main])
        halo_ok = py_r[n_main:] >= 0  # device 0 has no global row -1
        # shared pair-select composite (render.frame): the halo row stands
        # in for the cross-device predecessor row
        from voxelengine_tpu.render.frame import checkerboard_pair_select

        h_prev = jnp.concatenate([color[n_main:][None], h_main[:-1]], axis=0)
        w_prev = jnp.concatenate(
            [(write[n_main:] & halo_ok)[None], w_main[:-1]], axis=0
        )
        return checkerboard_pair_select(
            fb_block, h_main, w_main, h_prev, w_prev, frame_number
        )

    fb = jax.shard_map(
        tile,
        mesh=mesh,
        in_specs=(P(), P("rows"), P(), P(), P(), P(), P()),
        out_specs=P("rows"),
        check_vma=False,
    )(bm, framebuffer, jnp.asarray(origin, F32), jnp.asarray(euler, F32),
      env, jnp.asarray(frame_number, jnp.int32), osz)
    return fb


def make_framebuffer_cyclic(cfg: RenderConfig, mesh: Mesh) -> jax.Array:
    """Zeroed block-cyclic framebuffer, sharded over the mesh.

    Layout ``[N, nb/N, bhf, bw, 3]`` (device-major): entry ``[i, k]`` is
    the framebuffer pixels of global pixel block ``j = k*N + i`` (blocks
    in the tile-order grid of :func:`...render.frame.block_geometry`;
    ``bhf`` = the block's FINAL framebuffer rows — ``2*bh`` under
    checkerboarding).  Use :func:`cyclic_to_image` at present time.
    """
    bw, bh, nb = block_geometry(cfg)
    n = mesh.devices.size
    assert nb % n == 0, f"{nb} pixel blocks must divide the {n}-device mesh"
    bhf = 2 * bh if cfg.checkerboard else bh
    fb = jnp.zeros((n, nb // n, bhf, bw, 3), F32)
    return jax.device_put(fb, NamedSharding(mesh, P("rows")))


def cyclic_to_image(fb, cfg: RenderConfig) -> np.ndarray:
    """Host-side reassembly of a block-cyclic framebuffer into a
    ``[H, W, 3]`` image (numpy; at display time this is per-block memcpy
    off the device path — the N-chip frame itself never gathers)."""
    a = np.asarray(fb)
    n, nbl, bhf, bw, _ = a.shape
    nbx = cfg.width // bw
    # [N, nb/N] -> global block order j = k*N + i
    flat = a.reshape(n * nbl, bhf, bw, 3)
    j = (np.arange(nbl)[None, :] * n + np.arange(n)[:, None]).reshape(-1)
    inv = np.empty(n * nbl, np.int64)
    inv[j] = np.arange(n * nbl)
    blocks = flat[inv]  # [nb] in global (brow, bcol) raster order
    nby = (n * nbl) // nbx
    img = blocks.reshape(nby, nbx, bhf, bw, 3).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(cfg.height, cfg.width, 3))


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh"), donate_argnums=(1,)
)
def render_frame_cyclic(
    bm: BrickMap,
    framebuffer: jax.Array,
    origin,
    euler,
    env: Environment,
    frame_number,
    cfg: RenderConfig,
    mesh: Mesh,
    ortho_size=None,
) -> jax.Array:
    """Block-cyclic sharded frame render: ``render_frame`` semantics over
    N devices with the pixel blocks dealt round-robin (block ``j`` ->
    device ``j % N``).

    Contiguous row shards concentrate sky on some devices and horizon
    terrain on others; dealing blocks round-robin spreads both over every
    device.  Every device still traces coherent 32x30-pixel tiles; only
    the *assignment* of tiles to devices changes.

    The frame stays zero-communication: the checkerboard's even-frame
    ``+2`` remap needs each block's predecessor pre-remap row, recomputed
    locally as one halo ray row per block (``bw/(bw*bh)`` ≈ 3% extra
    rays).  The framebuffer is held in the block-cyclic layout of
    :func:`make_framebuffer_cyclic`; reassembly to a raster image is
    host-side (:func:`cyclic_to_image`).
    """
    W, H = cfg.width, cfg.height
    n = mesh.devices.size
    cb = cfg.checkerboard
    assert not (cb and H % 2), "checkerboard cyclic sharding needs even height"
    bw, bh, nb = block_geometry(cfg)
    assert nb % n == 0, f"{nb} pixel blocks must divide the {n}-device mesh"
    nb_local = nb // n
    nbx = W // bw
    osz = jnp.asarray(
        cfg.ortho_size if ortho_size is None else ortho_size, F32
    )

    def tile(bm, fb_block, origin, euler, env, frame_number, osz):
        dev = jax.lax.axis_index("rows")
        fb_block = fb_block.reshape(fb_block.shape[1:])  # drop the shard axis
        j = dev + n * jnp.arange(nb_local)  # owned global block ids
        brow, bcol = j // nbx, j % nbx
        yy, xx = jnp.meshgrid(jnp.arange(bh), jnp.arange(bw), indexing="ij")
        px = (bcol[:, None, None] * bw + xx[None]).reshape(-1)
        py_r = (brow[:, None, None] * bh + yy[None]).reshape(-1)
        if cb:
            # halo: each block's predecessor pre-remap row (the even-frame
            # +2 source for the block's top framebuffer row pair)
            px = jnp.concatenate(
                [px, (bcol[:, None] * bw + jnp.arange(bw)[None]).reshape(-1)]
            )
            py_r = jnp.concatenate(
                [py_r, jnp.repeat(brow * bh - 1, bw)]
            )
        origins, dirs, py = _rays_for_pixels(
            cfg, origin, euler, frame_number, px, py_r, osz
        )
        color, write = shade_pixels(
            bm, origins, dirs, px, py, py_r, origin, env, frame_number, cfg
        )
        n_main = nb_local * bh * bw
        h = color[:n_main].reshape(nb_local, bh, bw, 3)
        w = write[:n_main].reshape(nb_local, bh, bw)
        if not cb:
            out = jnp.where(w[..., None], h, fb_block)
            return out[None]  # restore the shard axis
        halo_ok = (py_r[n_main:] >= 0).reshape(nb_local, bw)
        h_prev = jnp.concatenate(
            [color[n_main:].reshape(nb_local, 1, bw, 3), h[:, :-1]], axis=1
        )
        w_prev = jnp.concatenate(
            [(write[n_main:].reshape(nb_local, bw) & halo_ok)[:, None],
             w[:, :-1]], axis=1,
        )
        from voxelengine_tpu.render.frame import checkerboard_pair_select

        out = checkerboard_pair_select(
            fb_block.reshape(nb_local * bh * 2, bw, 3),
            h.reshape(-1, bw, 3), w.reshape(-1, bw),
            h_prev.reshape(-1, bw, 3), w_prev.reshape(-1, bw),
            frame_number,
        )
        return out.reshape(1, nb_local, 2 * bh, bw, 3)

    return jax.shard_map(
        tile,
        mesh=mesh,
        in_specs=(P(), P("rows"), P(), P(), P(), P(), P()),
        out_specs=P("rows"),
        check_vma=False,
    )(bm, framebuffer, jnp.asarray(origin, F32), jnp.asarray(euler, F32),
      env, jnp.asarray(frame_number, jnp.int32), osz)


@functools.partial(jax.jit, static_argnames=("max_steps", "mesh"))
def raytrace_sharded(
    bm: BrickMap,
    origins,
    rays,
    mesh: Mesh,
    max_steps: int = 2048,
) -> Tuple[TraceOut, jax.Array]:
    """Batch ray query sharded over the flat ray axis.  Also returns the
    mesh-wide mean DDA step count (a ``psum`` diagnostic, the sharded analog
    of the 2D prototype's average-steps metric, ``DDATestCpp.cpp:618-625``).
    Each device traces its shard with the platform's traversal."""

    def shard(bm, o, r):
        out = trace_rays(bm, o, r, max_steps)
        # f32 accumulator: an i32 sum wraps at frame-scale batches
        # (2M rays x ~1000+ steps exceeds 2^31)
        tot = jax.lax.psum(jnp.sum(out.steps.astype(F32)), "rows")
        cnt = jax.lax.psum(out.steps.shape[0], "rows")
        return out, tot / cnt

    return jax.shard_map(
        shard,
        mesh=mesh,
        in_specs=(P(), P("rows"), P("rows")),
        out_specs=(P("rows"), P()),
        check_vma=False,
    )(bm, jnp.asarray(origins, F32), jnp.asarray(rays, F32))
