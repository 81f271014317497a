"""Distributed-memory world sharding: z-slab partitioned brickmaps.

Beyond the reference's single-GPU design (and beyond the replicated-world
pixel sharding in :mod:`voxelengine_tpu.parallel.sharded`): the brickmap is
partitioned into coarse-z slabs, one per device, so worlds larger than a
single device's memory can be traced.  Rays *migrate* between devices:

1. every device holds a full-size ray-state buffer but *owns* only the
   rays whose current coarse cell lies in its slab (ownership is exclusive
   and total: it starts from the entry cell and moves atomically);
2. each round, a device advances only its own rays against its local slab
   (the traversal pauses rays at slab boundaries with state intact —
   ``ops.trace._run_loop(slab=...)``);
3. paused rays are handed to the adjacent slab **point-to-point**: two
   neighbor ``ppermute``s (one +z, one -z) carry the state and a migration
   mask — single-hop transfers, no all-reduce on the round path;
4. after all rounds, one final masked ``psum`` assembles the results from
   each ray's last owner.

A ray's slab sequence is monotonic in z (fixed direction sign), so it
enters each slab at most once and ``n_devices`` rounds suffice.  Each
round's per-slab walk is the platform's traversal loop
(:func:`voxelengine_tpu.ops.traverse.advance`).  Collectives ride the mesh;
the world never does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from voxelengine_tpu.config import MAX_STEPS
from voxelengine_tpu.core.brickmap import BrickMap
from voxelengine_tpu.ops.trace import TraceOut, _finalize, _init_state
from voxelengine_tpu.ops.traverse import advance

F32 = jnp.float32
I32 = jnp.int32


def shard_world_z(bm: BrickMap, n: int):
    """Split a dense-slot brickmap into ``n`` coarse-z slabs.

    Returns ``(meta_stack [n, cpslab], bricks_stack [n, bpslab, wpb],
    slab_gz)``.  Requires LINEAR coarse layout (z-slabs are contiguous chunk
    ranges) and ``grid_dims[2] % n == 0``.
    """
    from voxelengine_tpu.core.layout import Layout

    assert bm.dense_slots, "z-sharding requires dense-slot brickmaps"
    assert bm.coarse_layout is Layout.LINEAR, "z-sharding requires LINEAR coarse layout"
    gx, gy, gz = bm.grid_dims
    assert gz % n == 0, f"gz={gz} must divide across {n} devices"
    slab_gz = gz // n
    per = gx * gy * slab_gz
    meta_stack = bm.meta.reshape(n, per)
    bricks_stack = bm.bricks.reshape(n, per, bm.words_per_brick)
    return meta_stack, bricks_stack, slab_gz


def _slab_bm(spec, meta, bricks, slab_gz: int) -> BrickMap:
    gx, gy, gz, factor, coarse_layout, brick_layout = spec
    return BrickMap(
        meta=meta,
        brick_idx=jnp.arange(gx * gy * slab_gz, dtype=I32),
        bricks=bricks,
        grid_dims=(gx, gy, slab_gz),
        factor=factor,
        coarse_layout=coarse_layout,
        brick_layout=brick_layout,
        dense_slots=True,
    )


@functools.partial(jax.jit, static_argnames=("spec", "max_steps", "mesh"))
def _trace_zsharded(
    spec,
    meta_stack,
    bricks_stack,
    origins,
    rays,
    mesh: Mesh,
    max_steps: int,
) -> TraceOut:
    n_dev = mesh.devices.size
    gx, gy, gz = spec[0], spec[1], spec[2]
    slab_gz = gz // n_dev

    up = [(i, i + 1) for i in range(n_dev - 1)]
    down = [(i + 1, i) for i in range(n_dev - 1)]

    def shard(meta, bricks, origins, rays):
        my = jax.lax.axis_index("shards")
        bm_local = _slab_bm(spec, meta[0], bricks[0], slab_gz)
        st = _init_state(bm_local, origins, rays, full_gz=gz)
        # exclusive, total ownership: the slab of the ray's entry cell
        owned = jnp.clip(st.ccell[:, 2] // slab_gz, 0, n_dev - 1) == my

        def pperm(x, perm):
            # collective-permute wants arithmetic dtypes; round-trip bools
            if x.dtype == jnp.bool_:
                return jax.lax.ppermute(x.astype(I32), "shards", perm) > 0
            return jax.lax.ppermute(x, "shards", perm)

        for _ in range(n_dev):
            mine = st.active & owned
            st_out = advance(
                bm_local, st._replace(active=mine), max_steps,
                2 * max_steps + 8, z0=my * slab_gz, full_gz=gz,
            )
            # paused rays (state intact, still in-grid, outside my slab);
            # non-mine lanes pass through _run_loop untouched
            paused = (
                mine
                & ~st_out.active
                & ~st_out.hit
                & (st_out.steps < max_steps)
                & jnp.all(st_out.ccell >= 0, axis=-1)
                & (st_out.ccell[:, 0] < gx)
                & (st_out.ccell[:, 1] < gy)
                & (st_out.ccell[:, 2] < gz)
                & ~st_out.in_fine
            )
            new_owner = jnp.clip(st_out.ccell[:, 2] // slab_gz, 0, n_dev - 1)
            go_up = paused & (new_owner > my)
            go_down = paused & (new_owner < my)
            # migrating rays travel re-armed so the receiver resumes them
            st = st_out._replace(active=st_out.active | paused, it=jnp.int32(0))

            # point-to-point handoff: single-hop neighbor ppermutes of the
            # state + migration masks (devices outside a perm receive zeros)
            from_dn_mask = pperm(go_up, up)  # arriving from my-1
            from_up_mask = pperm(go_down, down)  # arriving from my+1
            st_from_dn = jax.tree.map(lambda x: pperm(x, up), st)
            st_from_up = jax.tree.map(lambda x: pperm(x, down), st)

            def overlay(cur, a, b):
                if cur.ndim >= 1 and cur.shape[0] == mine.shape[0]:
                    ma = from_dn_mask.reshape((-1,) + (1,) * (cur.ndim - 1))
                    mb = from_up_mask.reshape((-1,) + (1,) * (cur.ndim - 1))
                    return jnp.where(ma, a, jnp.where(mb, b, cur))
                return cur
            st = jax.tree.map(overlay, st, st_from_dn, st_from_up)
            owned = (owned & ~go_up & ~go_down) | from_dn_mask | from_up_mask

        # final assembly: each ray's result lives on its last owner
        out = _finalize(st, spec[3])

        def gather(x):
            m = owned.reshape((-1,) + (1,) * (x.ndim - 1))
            if x.dtype == jnp.bool_:
                return jax.lax.psum(jnp.where(m, x, False).astype(I32), "shards") > 0
            return jax.lax.psum(jnp.where(m, x, jnp.zeros_like(x)), "shards")

        return jax.tree.map(gather, out)

    return jax.shard_map(
        shard,
        mesh=mesh,
        in_specs=(P("shards"), P("shards"), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(meta_stack, bricks_stack, jnp.asarray(origins, F32), jnp.asarray(rays, F32))


def trace_brickmap_zsharded(
    bm: BrickMap, origins, rays, mesh: Mesh, max_steps: int = MAX_STEPS
) -> TraceOut:
    """Trace rays through a z-slab-sharded world (see module doc).

    ``mesh`` must have a single axis named ``"shards"``.
    """
    n = mesh.devices.size
    meta_stack, bricks_stack, slab_gz = shard_world_z(bm, n)
    spec = bm.grid_dims + (bm.factor, bm.coarse_layout, bm.brick_layout)
    return _trace_zsharded(
        spec, meta_stack, bricks_stack, origins, rays, mesh, max_steps
    )


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"), donate_argnums=(1,))
def render_frame_zsharded(
    bm: BrickMap,
    framebuffer: jax.Array,
    origin,
    euler,
    env,
    frame_number,
    cfg,
    mesh: Mesh,
) -> jax.Array:
    """``render_frame`` over a z-slab-sharded world: the distributed-memory
    frame entry (the world is partitioned across the mesh; only ray state
    crosses the interconnect).  Exact :func:`voxelengine_tpu.render.frame.render_frame`
    semantics including secondary-trace shading: shadow and AO rays are
    just more ray batches, routed through the same sharded tracer as the
    primaries (each secondary pass is one more replicated walk / migration
    round set — still no world data on the wire).
    """
    from voxelengine_tpu.render.frame import (
        composite_frame,
        primary_rays,
        shade_traced,
    )

    def trace(o, d, ms):
        return trace_brickmap_zsharded(bm, o, d, mesh, ms)

    origins, dirs, px, py, py_r = primary_rays(cfg, origin, euler, frame_number)
    out = trace(origins, dirs, cfg.max_steps)
    needs_secondary = cfg.shadow_rays or cfg.ao_samples > 0 or cfg.reflections
    color, write = shade_traced(
        None, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg,
        secondary=trace if needs_secondary else None,
    )
    return composite_frame(framebuffer, color, write, cfg, frame_number)

