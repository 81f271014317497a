"""Vectorized two-level brickmap ray traversal — the engine's core.

Redesign of the reference's device ``Raytrace`` + nested
``DDARayTraversal`` (``VolumeRaytracer.cu:176-525``) as a batched XLA
program.  Instead of the
reference's *restart* structure (each fine-level miss re-launches the coarse
DDA from the exit point, with ``nextafterf`` nudging and a repeat-cell guard
to escape infinite loops, ``VolumeRaytracer.cu:438-489,402-407``), the
traversal here is a single **flattened state machine**:

* every ray carries both its coarse DDA state (cell, tMax) and, while inside
  an occupied chunk, a fine DDA state;
* entering a chunk ("descend") initializes the fine state at the chunk's
  tight-AABB entry point (``VolumeRaytracer.cu:256-272``) without touching
  the coarse state;
* leaving a chunk ("ascend") simply *resumes* the saved coarse DDA with one
  normal step — no restart, no epsilon nudging, no repeat-cell hazard.

One ``lax.while_loop`` iteration advances every active ray by one DDA event
(coarse step, descend, fine step, or ascend) under lane predication: the
reference's per-thread divergent loop becomes masked vector updates over
the whole batch, so the batch runs as long as its slowest ray.  On a GPU
the engine runs the same state machine per block of rays instead
(:mod:`voxelengine_tpu.ops.trace_kernel`); this module is its reference and
the CPU traversal.  All comparisons reproduce the
reference's exact tie-breaking (x < y <= z priority,
``VolumeRaytracer.cu:293-313``) and max-edge padding hack
(``VolumeRaytracer.cu:216-232``), so results are pixel-comparable with the
scalar oracle in :mod:`voxelengine_tpu.oracle.reference`.

Memory behavior: each iteration performs one 4-byte gather per ray from the
packed ``meta`` array (occupancy + tight AABB in one int32) or one from the
brick words — the minimum possible traffic for an incoherent traversal;
there is no per-chunk pointer chase (the reference does one dereference
into 32k separately-allocated bricks, ``VolumeRaytracer.cu:552-565``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from voxelengine_tpu.config import FLT_EPS_DDA, MAX_STEPS
from voxelengine_tpu.core.bitgrid import BitGrid
from voxelengine_tpu.core.brickmap import BrickMap, unpack_meta
from voxelengine_tpu.core.layout import sample_index
from voxelengine_tpu.ops.aabb import ray_aabb

F32 = jnp.float32
I32 = jnp.int32


class TraceOut(NamedTuple):
    """Per-ray trace results (struct-of-arrays form of the reference's
    ``DDARayResults``/``RayTraceResults``, ``VolumeRaytracer.cuh:179-275``)."""

    hit: jax.Array  # bool[N]
    position: jax.Array  # f32[N,3], world voxel coords
    normal: jax.Array  # f32[N,3], step-sign convention (renderer negates)
    steps: jax.Array  # i32[N]


def _normalize(v):
    return v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))


def _axis_pick3(tx, ty, tz):
    """Advance-axis choice with the reference's exact tie-breaking
    (``VolumeRaytracer.cu:293-313``): x if strictly smallest, else y if
    ``ty <= tx && ty < tz``, else z.  Component form shared by every
    traversal (the GPU kernel imports it) — the tie-break is
    load-bearing for cross-path parity, so it is defined exactly once."""
    ax = (tx < ty) & (tx < tz)
    ay = (~ax) & (ty <= tx) & (ty < tz)
    az = ~(ax | ay)
    return ax, ay, az


def _axis_pick(tmax):
    """:func:`_axis_pick3` over a stacked tensor; one-hot bool [..., 3]."""
    ax, ay, az = _axis_pick3(tmax[..., 0], tmax[..., 1], tmax[..., 2])
    return jnp.stack([ax, ay, az], axis=-1)


def _advance(cell, tmax, tdelta, step_sign, start, d):
    """One Amanatides-Woo step.  Returns (axis_onehot, t_cross, isect,
    new_cell, new_tmax, step_normal)."""
    axis = _axis_pick(tmax)
    t_cross = jnp.sum(jnp.where(axis, tmax, 0.0), axis=-1)
    # intersect point: boundary coordinate on the stepped axis, ray point on
    # the others (VolumeRaytracer.cu:293-321)
    boundary = (cell + (step_sign > 0)).astype(F32)
    linear = start + t_cross[..., None] * d
    isect = jnp.where(axis, boundary, linear)
    new_cell = cell + jnp.where(axis, step_sign, 0)
    new_tmax = tmax + jnp.where(axis, tdelta, 0.0)
    step_normal = jnp.where(axis, step_sign.astype(F32), 0.0)
    return axis, t_cross, isect, new_cell, new_tmax, step_normal


def _init_tmax(cell, start, d, step_sign):
    """tMax initialization (``VolumeRaytracer.cu:203-205``)."""
    return jnp.where(
        d != 0.0,
        ((cell + (step_sign > 0)).astype(F32) - start) / d,
        jnp.inf,
    )


def _edge_pad(cell, dims, d):
    """Max-edge padding: if any coordinate sits exactly on a maximal face,
    extend the in-range test by one on every axis with a negative direction
    (``VolumeRaytracer.cu:216-232``)."""
    on_edge = jnp.any(cell == dims, axis=-1, keepdims=True)
    return (on_edge & (d < 0.0)).astype(I32)


class _State(NamedTuple):
    it: jax.Array
    active: jax.Array
    in_fine: jax.Array
    hit: jax.Array
    imm: jax.Array  # current chunk entered *at the ray start itself*
    hit_imm: jax.Array  # hit occurred at the ray start (degenerate case)
    steps: jax.Array
    ccell: jax.Array
    ctmax: jax.Array
    centry_t: jax.Array
    fcell: jax.Array
    ftmax: jax.Array
    fstart: jax.Array
    fpos: jax.Array
    fpad: jax.Array
    fsteps: jax.Array
    cnorm: jax.Array
    fnorm: jax.Array
    pos_out: jax.Array
    norm_out: jax.Array
    # per-ray constants (carried in the state so staged compaction can
    # permute everything with one tree-mapped take)
    start_c: jax.Array
    d: jax.Array
    tdelta: jax.Array
    step_sign: jax.Array
    cpad: jax.Array
    start_normal: jax.Array


def _init_state(bm: BrickMap, origins, rays, full_gz=None) -> _State:
    """Ray setup: normalization, world-AABB entry clip, DDA init
    (``VolumeRaytracer.cu:354-381,195-232``).  ``full_gz`` overrides the
    grid's z extent when ``bm`` is a z-slab of a larger world."""
    f = bm.factor
    gx, gy, gz = bm.grid_dims
    if full_gz is not None:
        gz = full_gz
    gdims = jnp.asarray([gx, gy, gz], I32)

    origins = jnp.asarray(origins, F32)
    d = _normalize(jnp.asarray(rays, F32))
    n = origins.shape[0]

    start_c = origins / F32(f)
    inside = jnp.all((start_c >= 0.0) & (start_c < gdims.astype(F32)), axis=-1)
    eps = jnp.float32(FLT_EPS_DDA)
    whit, _, wpt, wnrm = ray_aabb(
        start_c, d, jnp.full((3,), eps), gdims.astype(F32) - eps
    )
    start_c = jnp.where(inside[:, None], start_c, jnp.where(whit[:, None], wpt, start_c))
    start_normal = jnp.where(inside[:, None], 0.0, wnrm)

    step_sign = jnp.where(d > 0.0, 1, -1).astype(I32)
    tdelta = jnp.where(d != 0.0, jnp.abs(1.0 / d), jnp.inf)
    ccell = start_c.astype(I32)  # trunc toward zero, like (int)x
    ctmax = _init_tmax(ccell, start_c, d, step_sign)
    cpad = _edge_pad(ccell, gdims, d)

    zeros3 = jnp.zeros((n, 3), F32)
    return _State(
        it=jnp.int32(0),
        active=inside | whit,
        in_fine=jnp.zeros((n,), bool),
        hit=jnp.zeros((n,), bool),
        imm=jnp.zeros((n,), bool),
        hit_imm=jnp.zeros((n,), bool),
        steps=jnp.zeros((n,), I32),
        ccell=ccell,
        ctmax=ctmax,
        centry_t=jnp.zeros((n,), F32),
        fcell=jnp.zeros((n, 3), I32),
        ftmax=zeros3,
        fstart=zeros3,
        fpos=zeros3,
        fpad=jnp.zeros((n, 3), I32),
        fsteps=jnp.zeros((n,), I32),
        cnorm=zeros3,
        fnorm=zeros3,
        pos_out=zeros3,
        norm_out=zeros3,
        start_c=start_c,
        d=d,
        tdelta=tdelta,
        step_sign=step_sign,
        cpad=cpad,
        start_normal=start_normal,
    )


def make_fused_table(bm: BrickMap) -> jax.Array:
    """One flat int32 lookup table [meta | brick words] so each traversal
    iteration issues a single gather.  Build OUTSIDE jit and pass in as an
    argument — a concat built inside the traced function may be fused into
    the loop body and re-materialized every iteration."""
    return jax.jit(
        lambda m, b: jnp.concatenate(
            [m, jax.lax.bitcast_convert_type(b.reshape(-1), jnp.int32)]
        )
    )(bm.meta, bm.bricks)


def _run_loop(
    bm: BrickMap, st: _State, max_steps: int, iter_limit: int, fused=None,
    slab=None,
) -> _State:
    """Advance every active ray by up to ``iter_limit`` DDA events.

    ``slab=(z0, full_gz)``: distributed z-sharding hook.  ``bm`` holds only
    the coarse-z slab ``[z0, z0 + bm.grid_dims[2])`` of a full grid whose z
    extent is ``full_gz`` (static int; ``z0`` may be traced).  Rays whose
    coarse cell leaves the slab while still inside the full grid are
    *paused* (deactivated with state intact) so the neighboring device can
    resume them; rays leaving the full grid miss as usual.
    """
    st = st._replace(it=jnp.int32(0))

    def cond(st: _State):
        return (st.it < iter_limit) & jnp.any(st.active)

    return jax.lax.while_loop(
        cond, lambda st: _step(bm, st, max_steps, fused, slab), st
    )


def _step(
    bm: BrickMap, st: _State, max_steps: int, fused=None, slab=None
) -> _State:
    """One DDA event (coarse step, descend, fine step, or ascend) for every
    active ray: the body of :func:`_run_loop`."""
    f = bm.factor
    gx, gy, gz = bm.grid_dims
    full_gz = gz if slab is None else slab[1]
    gdims = jnp.asarray([gx, gy, full_gz], I32)  # FULL grid for range tests
    fdims = jnp.asarray([f, f, f], I32)
    wpb = bm.words_per_brick
    num_chunks = bm.num_chunks
    bricks_flat = bm.bricks.reshape(-1)  # view, no copy

    coarse_phase = st.active & ~st.in_fine
    fine_phase = st.active & st.in_fine

    # residency pause (distributed z-sharding): check BEFORE touching
    # local tables, so the paused state is exactly resumable elsewhere
    if slab is not None:
        z0 = slab[0]
        resident = (st.ccell[:, 2] >= z0) & (st.ccell[:, 2] < z0 + gz)
        pause = coarse_phase & ~resident
        coarse_phase = coarse_phase & resident
    else:
        z0 = 0
        pause = jnp.zeros_like(st.active)

    # ---------------- shared single gather ----------------
    in_range_c = jnp.all(
        (st.ccell >= 0) & (st.ccell < gdims + st.cpad), axis=-1
    )
    cl = jnp.clip(st.ccell, 0, gdims - 1)
    zloc = jnp.clip(cl[:, 2] - z0, 0, gz - 1)
    ci = sample_index(cl[:, 0], cl[:, 1], zloc, gx, gy, bm.coarse_layout)
    ci_safe = jnp.where(st.active, ci, 0)

    cl_f = jnp.clip(st.fcell, 0, f - 1)
    bit = sample_index(cl_f[:, 0], cl_f[:, 1], cl_f[:, 2], f, f, bm.brick_layout)
    if bm.dense_slots:
        slot = ci_safe  # identity indirection: no gather needed
    else:
        slot = jnp.maximum(bm.brick_idx[ci_safe], 0)
    if fused is not None:
        # single gather serves both levels (argument-backed table)
        fine_addr = num_chunks + slot * wpb + (bit >> 5)
        fetched = fused[jnp.where(fine_phase, fine_addr, ci_safe)]
        meta = fetched
    else:
        meta = bm.meta[ci_safe]
    occ_c, bmn, bmx = unpack_meta(meta)
    box_min = cl.astype(F32) + bmn.astype(F32) / F32(f)
    box_max = cl.astype(F32) + (bmx.astype(F32) + 1.0) / F32(f)
    bhit, btmin, bpos, bnrm = ray_aabb(st.start_c, st.d, box_min, box_max)

    occupied = in_range_c & occ_c & bhit
    descend = coarse_phase & occupied
    coarse_miss = coarse_phase & ~in_range_c
    coarse_adv = coarse_phase & in_range_c & ~occupied

    # descend: initialize fine DDA at the tight-box entry (or the
    # current position when already inside the box).  A descend from the
    # ray's own start position (no coarse advances, inside the box) is
    # the reference's degenerate case (VolumeRaytracer.cu:518-522).
    imm_new = (st.steps == 0) & (btmin <= 0.0)
    entry_c = jnp.where(
        (btmin > 0.0)[:, None], bpos, st.start_c + st.d * st.centry_t[:, None]
    )
    fstart_new = (entry_c - cl.astype(F32)) * F32(f)
    fcell_new = fstart_new.astype(I32)
    ftmax_new = _init_tmax(fcell_new, fstart_new, st.d, st.step_sign)
    fpad_new = _edge_pad(fcell_new, fdims, st.d)

    # ---------------- fine level ----------------
    in_range_f = jnp.all((st.fcell >= 0) & (st.fcell < fdims + st.fpad), axis=-1)
    if fused is not None:
        word = jax.lax.bitcast_convert_type(fetched, jnp.uint32)
    else:
        word = bricks_flat[jnp.where(fine_phase, slot * wpb + (bit >> 5), 0)]
    occ_f = ((word >> (bit & 31).astype(jnp.uint32)) & 1) == 1

    fine_hit = fine_phase & in_range_f & occ_f
    fine_try = fine_phase & in_range_f & ~occ_f

    axis_f, tcross_f, isect_f, fcell_adv, ftmax_adv, fnorm_adv = _advance(
        st.fcell, st.ftmax, st.tdelta, st.step_sign, st.fstart, st.d
    )
    oob_f = jnp.any((isect_f < 0.0) | (isect_f > F32(f)), axis=-1)
    fine_step = fine_try & ~oob_f
    ascend = (fine_phase & ~in_range_f) | (fine_try & oob_f)

    # ---------------- apply: coarse advance (coarse_adv | ascend) -----
    do_cadv = coarse_adv | ascend
    _, tcross_c, _, ccell_adv, ctmax_adv, _ = _advance(
        st.ccell, st.ctmax, st.tdelta, st.step_sign, st.start_c, st.d
    )

    new_ccell = jnp.where(do_cadv[:, None], ccell_adv, st.ccell)
    new_ctmax = jnp.where(do_cadv[:, None], ctmax_adv, st.ctmax)
    new_centry = jnp.where(do_cadv, tcross_c, st.centry_t)

    new_in_fine = (st.in_fine | descend) & ~ascend & ~fine_hit
    new_fcell = jnp.where(
        descend[:, None], fcell_new, jnp.where(fine_step[:, None], fcell_adv, st.fcell)
    )
    new_ftmax = jnp.where(
        descend[:, None], ftmax_new, jnp.where(fine_step[:, None], ftmax_adv, st.ftmax)
    )
    new_fstart = jnp.where(descend[:, None], fstart_new, st.fstart)
    new_fpos = jnp.where(
        descend[:, None], fstart_new, jnp.where(fine_step[:, None], isect_f, st.fpos)
    )
    new_fpad = jnp.where(descend[:, None], fpad_new, st.fpad)
    new_fsteps = jnp.where(
        descend, 0, st.fsteps + jnp.where(fine_step, 1, 0)
    )
    new_cnorm = jnp.where(descend[:, None], bnrm, st.cnorm)
    new_fnorm = jnp.where(fine_step[:, None], fnorm_adv, st.fnorm)

    new_steps = st.steps + jnp.where(do_cadv | fine_step, 1, 0)

    # hit bookkeeping: position = fine intersection + chunk offset
    # (VolumeRaytracer.cu:427-429); normal per VolumeRaytracer.cu:495-503.
    # The offset is the clipped chunk the fine walk was seeded in: a ray
    # whose world entry rounds onto a max face sits in the padded cell
    # gdims, but its fine walk runs in chunk gdims - 1.
    hit_pos = st.fpos + (cl * f).astype(F32)
    hit_nrm = jnp.where((st.fsteps == 0)[:, None], st.cnorm, st.fnorm)
    new_pos_out = jnp.where(fine_hit[:, None], hit_pos, st.pos_out)
    new_norm_out = jnp.where(fine_hit[:, None], hit_nrm, st.norm_out)
    new_hit = st.hit | fine_hit
    new_imm = jnp.where(descend, imm_new, st.imm)
    new_hit_imm = st.hit_imm | (fine_hit & (st.fsteps == 0) & st.imm)

    budget_dead = new_steps >= max_steps
    new_active = st.active & ~fine_hit & ~coarse_miss & ~budget_dead & ~pause

    return _State(
        it=st.it + 1,
        active=new_active,
        in_fine=new_in_fine,
        hit=new_hit,
        imm=new_imm,
        hit_imm=new_hit_imm,
        steps=new_steps,
        ccell=new_ccell,
        ctmax=new_ctmax,
        centry_t=new_centry,
        fcell=new_fcell,
        ftmax=new_ftmax,
        fstart=new_fstart,
        fpos=new_fpos,
        fpad=new_fpad,
        fsteps=new_fsteps,
        cnorm=new_cnorm,
        fnorm=new_fnorm,
        pos_out=new_pos_out,
        norm_out=new_norm_out,
        start_c=st.start_c,
        d=st.d,
        tdelta=st.tdelta,
        step_sign=st.step_sign,
        cpad=st.cpad,
        start_normal=st.start_normal,
    )


def _finalize(st: _State, factor: int) -> TraceOut:
    # degenerate hit at the ray start: clipped entry point + world-AABB
    # entry normal (VolumeRaytracer.cu:518-522)
    pos = jnp.where(st.hit_imm[:, None], st.start_c * F32(factor), st.pos_out)
    nrm = jnp.where(st.hit_imm[:, None], st.start_normal, st.norm_out)
    return TraceOut(hit=st.hit, position=pos, normal=nrm, steps=st.steps)


@functools.partial(jax.jit, static_argnames=("max_steps",))
def trace_brickmap(
    bm: BrickMap, origins, rays, max_steps: int = MAX_STEPS, fused=None
) -> TraceOut:
    """Trace a batch of rays through a two-level brickmap.

    ``origins``/``rays`` are ``f32[N, 3]`` in world voxel units; rays need
    not be normalized (normalized internally, ``VolumeRaytracer.cu:367``).
    ``fused`` (optional): prebuilt :func:`make_fused_table` for
    single-gather iterations.
    """
    st = _init_state(bm, origins, rays)
    st = _run_loop(bm, st, max_steps, 2 * max_steps + 8, fused)
    return _finalize(st, bm.factor)


@functools.partial(
    jax.jit, static_argnames=("max_steps", "stage_iters", "tail_frac", "schedule")
)
def trace_brickmap_staged(
    bm: BrickMap,
    origins,
    rays,
    max_steps: int = MAX_STEPS,
    stage_iters: int = 192,
    tail_frac: int = 16,
    fused=None,
    schedule=None,
) -> TraceOut:
    """Traversal with multi-stage straggler compaction.

    A lockstep batch pays ``max-over-rays`` iterations on every lane; ray
    path lengths are heavy-tailed (p50 ~ 40 events, p99 ~ 4x, stragglers to
    the step budget), so most lane-iterations are waste.  This variant runs
    fixed-length stages; between stages the still-active rays are compacted
    (argsort on the active mask -> one tree-mapped take of the state) into
    a smaller buffer, so finished rays stop costing lane-iterations.

    ``schedule``: static tuple of ``(iters, frac)``: stage k runs ``iters``
    events on a buffer of ``n // frac`` rays.  The last stage should use
    ``iters >= 2 * max_steps``.  Default: ``((stage_iters, 1),
    (stage_iters * 2, tail_frac), (2 * max_steps + 8, tail_frac * 8))``.

    Never truncates: if a stage's survivors exceed the next buffer
    (possible when the schedule is scene-blind), the overflow rays are
    finished by a full-width rescue pass guarded by ``lax.cond`` — it
    costs nothing unless triggered, so results always equal
    :func:`trace_brickmap` at the same ``max_steps`` budget (the
    reference's only cap, ``VolumeRaytracer.cuh:235``).
    """
    n = jnp.asarray(origins).shape[0]
    if schedule is None:
        schedule = (
            (stage_iters, 1),
            (stage_iters * 2, tail_frac),
            (2 * max_steps + 8, tail_frac * 8),
        )

    st = _init_state(bm, origins, rays)
    st = _run_loop(bm, st, max_steps, schedule[0][0], fused)
    outs = _finalize(st, bm.factor)
    st_full = st  # full-width resume state, kept current for the rescue

    idx = None  # current buffer position -> original ray index
    for iters, frac in schedule[1:]:
        buf_n = max(128, n // frac)
        order = jnp.argsort(~st.active)[:buf_n]
        sel = jnp.take(st.active, order)  # rays actually resuming
        st = jax.tree.map(
            lambda a: jnp.take(a, order, axis=0) if a.ndim >= 1 else a, st
        )
        idx = order if idx is None else jnp.take(idx, order)
        st = _run_loop(bm, st, max_steps, iters, fused)
        out_k = _finalize(st, bm.factor)

        def merge(full, tail):
            keep = jnp.take(full, idx, axis=0)
            t = jnp.where(sel.reshape((-1,) + (1,) * (tail.ndim - 1)), tail, keep)
            return full.at[idx].set(t)

        outs = TraceOut(
            hit=merge(outs.hit, out_k.hit),
            position=merge(outs.position, out_k.position),
            normal=merge(outs.normal, out_k.normal),
            steps=merge(outs.steps, out_k.steps),
        )
        st_full = jax.tree.map(
            lambda full, tail: merge(full, tail) if full.ndim >= 1 else tail,
            st_full, st,
        )

    # overflow rescue: a ray still active at full width was dropped by a
    # compaction buffer.  The cond's true branch (a full-width resume to
    # the complete budget) runs only when that happens, so the scene-blind
    # default schedule can never silently truncate stragglers.
    return jax.lax.cond(
        jnp.any(st_full.active),
        lambda: _finalize(
            _run_loop(bm, st_full, max_steps, 2 * max_steps + 8, fused),
            bm.factor,
        ),
        lambda: outs,
    )


@functools.partial(jax.jit, static_argnames=("max_steps", "take_initial_step"))
def trace_grid(
    grid: BitGrid, origins, rays, max_steps: int = MAX_STEPS,
    take_initial_step: bool = False,
) -> TraceOut:
    """Single-level DDA trace through a dense bit grid (the reference's
    plain ``DDARayTraversal`` without per-voxel bounds,
    ``VolumeRaytracer.cu:176-352``) with the same world-AABB entry clip as
    the two-level path.  Serves dense scenes (e.g. 64^3 depth renders) and
    oracle parity tests.
    """
    X, Y, Z = grid.dims
    gdims = jnp.asarray([X, Y, Z], I32)

    origins = jnp.asarray(origins, F32)
    d = _normalize(jnp.asarray(rays, F32))
    n = origins.shape[0]

    start = origins
    inside = jnp.all((start >= 0.0) & (start < gdims.astype(F32)), axis=-1)
    eps = jnp.float32(FLT_EPS_DDA)
    whit, _, wpt, wnrm = ray_aabb(start, d, jnp.full((3,), eps), gdims.astype(F32) - eps)
    start = jnp.where(inside[:, None], start, jnp.where(whit[:, None], wpt, start))
    start_normal = jnp.where(inside[:, None], 0.0, wnrm)

    step_sign = jnp.where(d > 0.0, 1, -1).astype(I32)
    tdelta = jnp.where(d != 0.0, jnp.abs(1.0 / d), jnp.inf)
    cell = start.astype(I32)
    tmax = _init_tmax(cell, start, d, step_sign)
    pad = _edge_pad(cell, gdims, d)

    def cond(s):
        it, active = s[0], s[1]
        return (it < max_steps + 1) & jnp.any(active)

    def body(s):
        (it, active, hit, steps, cell, tmax, pos, nrm, first) = s
        in_range = jnp.all((cell >= 0) & (cell < gdims + pad), axis=-1)
        cl = jnp.clip(cell, 0, gdims - 1)
        skip = first & jnp.full((n,), take_initial_step)
        occ = grid.get_bits(cl[:, 0], cl[:, 1], cl[:, 2]) & in_range & ~skip
        this_hit = active & occ
        this_miss = active & ~in_range & ~skip

        _, tcross, isect, cell_adv, tmax_adv, step_nrm = _advance(
            cell, tmax, tdelta, step_sign, start, d
        )
        adv = active & ~this_hit & ~this_miss
        new_cell = jnp.where(adv[:, None], cell_adv, cell)
        new_tmax = jnp.where(adv[:, None], tmax_adv, tmax)
        new_pos = jnp.where(adv[:, None], isect, pos)
        new_nrm = jnp.where(adv[:, None], step_nrm, nrm)
        new_steps = steps + jnp.where(adv, 1, 0)
        budget_dead = new_steps >= max_steps
        new_active = active & adv & ~budget_dead
        return (
            it + 1,
            new_active,
            hit | this_hit,
            new_steps,
            new_cell,
            new_tmax,
            new_pos,
            new_nrm,
            jnp.zeros((), bool),
        )

    init = (
        jnp.int32(0),
        inside | whit,
        jnp.zeros((n,), bool),
        jnp.zeros((n,), I32),
        cell,
        tmax,
        start,
        jnp.zeros((n, 3), F32),
        jnp.ones((), bool),
    )
    it, active, hit, steps, cell, tmax, pos, nrm, _ = jax.lax.while_loop(cond, body, init)

    zero_step = hit & (steps == 0)
    pos = jnp.where(zero_step[:, None], start, pos)
    nrm = jnp.where(zero_step[:, None], start_normal, nrm)
    return TraceOut(hit=hit, position=pos, normal=nrm, steps=steps)
