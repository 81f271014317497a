"""Per-block brickmap traversal kernel for NVIDIA GPUs (Pallas, Triton route).

The reference runs one CUDA thread per ray: each thread walks its own
two-level DDA and leaves its loop the moment its ray hits, misses or runs
out of budget (``Raytrace``, ``VolumeRaytracer.cu:354-525``).  The XLA
traversal in :mod:`voxelengine_tpu.ops.trace` instead advances the whole ray
batch in one ``lax.while_loop``, so the slowest ray of the batch sets the
iteration count for every ray, and every iteration is its own set of device
launches.

This kernel restores the reference's shape.  One program owns ``BLOCK`` rays
(one warp), keeps their whole DDA state in registers, and loops while any of
its rays is active; a block retires as soon as its own slowest ray does.
Occupancy words, brick slots and brick words are gathered straight from the
brickmap's flat arrays in global memory, with masked loads so a lane only
touches memory in the phase that needs it; the GPU's L1/L2 are the only
cache, as in the reference.

The state machine is the one of :func:`voxelengine_tpu.ops.trace._run_loop`,
written per component (Triton tensors must have power-of-two sizes, so an
``[N, 3]`` vector becomes three ``[BLOCK]`` vectors).  Ray set-up and
finalisation are the XLA path's own functions, so only the loop differs.
Results equal the XLA traversal's: same hits, positions, normals and step
counts (``tests/test_trace_kernel.py``; on the card, ``chip_smoke.py``).

Positions can differ from XLA's in the last bits: the two compilers
contract ``start + t * d`` into fused multiply-adds differently, and the
difference in the chunk-space entry point of a brick is carried, scaled by
the brick factor, into the fine walk.  :func:`position_tolerance` bounds
that; hits, normals and step counts are equal.

Float division inside the loop uses ``div.rn.f32`` (IEEE round-to-nearest,
what XLA emits) through inline PTX, because Triton lowers ``/`` to the
approximate ``div.full.f32``.  ``interpret=True`` runs the kernel through
the Pallas interpreter (CPU tests); there the division is XLA's own.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from voxelengine_tpu.config import MAX_STEPS
from voxelengine_tpu.core.brickmap import META_OCC_BIT, BrickMap
from voxelengine_tpu.core.layout import sample_index
from voxelengine_tpu.ops.aabb import FLT_EPS
from voxelengine_tpu.ops.trace import (
    TraceOut,
    _axis_pick3,
    _finalize,
    _init_state,
    _State,
)

F32 = jnp.float32
I32 = jnp.int32

#: rays per program: one warp, so a block's loop condition is a warp vote
BLOCK = 32
NUM_WARPS = BLOCK // 32

# _State fields as the kernel sees them: (name, components, dtype).  Bool
# fields travel as int32.  LOOP fields are carried and written back;
# CONST fields are per-ray constants, read only.
_LOOP = (
    ("active", 1, I32), ("in_fine", 1, I32), ("hit", 1, I32),
    ("imm", 1, I32), ("hit_imm", 1, I32), ("steps", 1, I32),
    ("ccell", 3, I32), ("ctmax", 3, F32), ("centry_t", 1, F32),
    ("fcell", 3, I32), ("ftmax", 3, F32), ("fstart", 3, F32),
    ("fpos", 3, F32), ("fpad", 3, I32), ("fsteps", 1, I32),
    ("cnorm", 3, F32), ("fnorm", 3, F32), ("pos_out", 3, F32),
    ("norm_out", 3, F32),
)
_CONST = (
    ("start_c", 3, F32), ("d", 3, F32), ("tdelta", 3, F32),
    ("step_sign", 3, I32), ("cpad", 3, I32), ("inv", 3, F32),
)


def _flat_names(fields):
    return [(n, k, dt) for n, c, dt in fields for k in range(c)]


_LOOP_FLAT = _flat_names(_LOOP)
_CONST_FLAT = _flat_names(_CONST)


def _split(st: _State, inv) -> dict:
    """_State ([N] and [N, 3] arrays) -> {(name, k): [N] array}."""
    src = st._asdict()
    src["inv"] = inv
    out = {}
    for name, k, dt in _LOOP_FLAT + _CONST_FLAT:
        a = src[name]
        out[(name, k)] = (a[:, k] if a.ndim == 2 else a).astype(dt)
    return out


def _merge(st: _State, comps: dict) -> _State:
    """Inverse of :func:`_split` for the LOOP fields."""
    upd = {}
    for name, c, _ in _LOOP:
        ref = getattr(st, name)
        if c == 3:
            a = jnp.stack([comps[(name, k)] for k in range(3)], axis=-1)
        else:
            a = comps[(name, 0)]
        upd[name] = a.astype(ref.dtype)
    return st._replace(**upd)


def position_tolerance(bm: BrickMap, position):
    """How far a kernel hit position may lie from the XLA traversal's on a
    GPU: one float32 ulp of the largest chunk coordinate, scaled to voxels
    by the brick factor (the entry point's rounding, carried into the fine
    walk), plus one ulp of the position itself."""
    chunk_ulp = np.spacing(np.float32(max(bm.grid_dims)))
    return bm.factor * chunk_ulp + np.spacing(np.abs(np.asarray(position)))


def _div_rn(a, b):
    """IEEE round-to-nearest float32 division (what XLA emits for ``/``)."""
    b = jnp.broadcast_to(jnp.asarray(b, F32), a.shape)
    return plt.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;",
        args=[a, b],
        constraints="=r,r,r",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, F32)],
    )[0]


def _kernel(meta_ref, idx_ref, bricks_ref, z0_ref, *refs, grid_dims, full_gz,
            factor, coarse_layout, brick_layout, dense_slots, wpb, max_steps,
            iter_limit, slab, interpret):
    n_loop, n_const = len(_LOOP_FLAT), len(_CONST_FLAT)
    loop_in = refs[:n_loop]
    const_in = refs[n_loop:n_loop + n_const]
    loop_out = refs[n_loop + n_const:]
    div = (lambda a, b: a / b) if interpret else _div_rn

    c = {key[:2]: r[...] for key, r in zip(_CONST_FLAT, const_in)}
    sx, sy, sz = c[("start_c", 0)], c[("start_c", 1)], c[("start_c", 2)]
    dx, dy, dz = c[("d", 0)], c[("d", 1)], c[("d", 2)]
    tdx, tdy, tdz = c[("tdelta", 0)], c[("tdelta", 1)], c[("tdelta", 2)]
    stx, sty, stz = c[("step_sign", 0)], c[("step_sign", 1)], c[("step_sign", 2)]
    cpx, cpy, cpz = c[("cpad", 0)], c[("cpad", 1)], c[("cpad", 2)]
    ivx, ivy, ivz = c[("inv", 0)], c[("inv", 1)], c[("inv", 2)]

    f = factor
    ff = F32(f)
    gx, gy, gz = grid_dims
    z0 = z0_ref[0] if slab else 0

    def advance(cell, tmax, start):
        # _advance of ops/trace.py, per component
        (cx, cy, cz), (tx, ty, tz), (ox, oy, oz) = cell, tmax, start
        ax, ay, az = _axis_pick3(tx, ty, tz)
        t_cross = (jnp.where(ax, tx, 0.0) + jnp.where(ay, ty, 0.0)) + jnp.where(
            az, tz, 0.0
        )

        def comp(a, ci, ti, si, oi, di, tdi):
            boundary = (ci + (si > 0).astype(I32)).astype(F32)
            isect = jnp.where(a, boundary, oi + t_cross * di)
            return (
                isect,
                ci + jnp.where(a, si, 0),
                ti + jnp.where(a, tdi, 0.0),
                jnp.where(a, si.astype(F32), 0.0),
            )

        rx = comp(ax, cx, tx, stx, ox, dx, tdx)
        ry = comp(ay, cy, ty, sty, oy, dy, tdy)
        rz = comp(az, cz, tz, stz, oz, dz, tdz)
        return (t_cross,) + tuple(zip(rx, ry, rz))

    def body(carry):
        it, s = carry
        active = s["active"] != 0
        in_fine = s["in_fine"] != 0
        coarse_phase = active & ~in_fine
        fine_phase = active & in_fine
        ccx, ccy, ccz = s["ccell"]
        if slab:
            resident = (ccz >= z0) & (ccz < z0 + gz)
            pause = coarse_phase & ~resident
            coarse_phase = coarse_phase & resident
        else:
            pause = jnp.zeros_like(active)

        in_range_c = (
            (ccx >= 0) & (ccx < gx + cpx)
            & (ccy >= 0) & (ccy < gy + cpy)
            & (ccz >= 0) & (ccz < full_gz + cpz)
        )
        clx = jnp.clip(ccx, 0, gx - 1)
        cly = jnp.clip(ccy, 0, gy - 1)
        clz = jnp.clip(ccz, 0, full_gz - 1)
        zloc = jnp.clip(clz - z0, 0, gz - 1)
        ci = sample_index(clx, cly, zloc, gx, gy, coarse_layout)
        ci_safe = jnp.where(active, ci, 0)

        fcx, fcy, fcz = s["fcell"]
        bit = sample_index(
            jnp.clip(fcx, 0, f - 1), jnp.clip(fcy, 0, f - 1),
            jnp.clip(fcz, 0, f - 1), f, f, brick_layout,
        )
        if dense_slots:
            slot = ci_safe
        else:
            slot = jnp.maximum(
                plt.load(idx_ref.at[ci_safe], mask=fine_phase, other=0), 0
            )
        meta = plt.load(meta_ref.at[ci_safe], mask=coarse_phase, other=0)
        word = plt.load(
            bricks_ref.at[jnp.where(fine_phase, slot * wpb + (bit >> 5), 0)],
            mask=fine_phase, other=0,
        )

        # coarse level: tight-box test of the current chunk
        occ_c = ((meta >> META_OCC_BIT) & 1) == 1
        clf = (clx.astype(F32), cly.astype(F32), clz.astype(F32))
        bmin = tuple(
            clf[k] + div(((meta >> (5 * k)) & 31).astype(F32), ff) for k in range(3)
        )
        bmax = tuple(
            clf[k] + div(((meta >> (15 + 5 * k)) & 31).astype(F32) + 1.0, ff)
            for k in range(3)
        )
        start = (sx, sy, sz)
        inv = (ivx, ivy, ivz)
        t1, t2 = [], []
        for k in range(3):
            lo = (bmin[k] - start[k]) * inv[k]
            hi = (bmax[k] - start[k]) * inv[k]
            t1.append(jnp.minimum(lo, hi))
            t2.append(jnp.maximum(lo, hi))
        btmin = jnp.maximum(jnp.maximum(t1[0], t1[1]), t1[2])
        btmax = jnp.minimum(jnp.minimum(t2[0], t2[1]), t2[2])
        bhit = btmax >= jnp.maximum(btmin, 0.0)
        d = (dx, dy, dz)
        bpos = tuple(start[k] + btmin * d[k] for k in range(3))
        is_x = btmin == t1[0]
        is_y = (~is_x) & (btmin == t1[1])
        sgn = tuple(jnp.where(inv[k] < 0.0, -1.0, 1.0) for k in range(3))
        bnrm = (
            jnp.where(is_x, sgn[0], 0.0),
            jnp.where(is_y, sgn[1], 0.0),
            jnp.where(is_x | is_y, 0.0, sgn[2]),
        )

        occupied = in_range_c & occ_c & bhit
        descend = coarse_phase & occupied
        coarse_miss = coarse_phase & ~in_range_c
        coarse_adv = coarse_phase & in_range_c & ~occupied

        imm_new = (s["steps"] == 0) & (btmin <= 0.0)
        centry = s["centry_t"]
        inside_box = btmin > 0.0
        steps_sign = (stx, sty, stz)
        fstart_new, fcell_new, ftmax_new = [], [], []
        for k in range(3):
            entry = jnp.where(inside_box, bpos[k], start[k] + d[k] * centry)
            fs = (entry - clf[k]) * ff
            fc = fs.astype(I32)
            fstart_new.append(fs)
            fcell_new.append(fc)
            ftmax_new.append(jnp.where(
                d[k] != 0.0,
                div((fc + (steps_sign[k] > 0).astype(I32)).astype(F32) - fs, d[k]),
                jnp.inf,
            ))
        on_edge = (
            (fcell_new[0] == f) | (fcell_new[1] == f) | (fcell_new[2] == f)
        )
        fpad_new = [(on_edge & (d[k] < 0.0)).astype(I32) for k in range(3)]

        # fine level
        fpx, fpy, fpz = s["fpad"]
        in_range_f = (
            (fcx >= 0) & (fcx < f + fpx)
            & (fcy >= 0) & (fcy < f + fpy)
            & (fcz >= 0) & (fcz < f + fpz)
        )
        occ_f = (jax.lax.shift_right_logical(word, bit & 31) & 1) == 1
        fine_hit = fine_phase & in_range_f & occ_f
        fine_try = fine_phase & in_range_f & ~occ_f
        _, isect_f, fcell_adv, ftmax_adv, fnorm_adv = advance(
            s["fcell"], s["ftmax"], s["fstart"]
        )
        oob_f = (
            (isect_f[0] < 0.0) | (isect_f[0] > ff)
            | (isect_f[1] < 0.0) | (isect_f[1] > ff)
            | (isect_f[2] < 0.0) | (isect_f[2] > ff)
        )
        fine_step = fine_try & ~oob_f
        ascend = (fine_phase & ~in_range_f) | (fine_try & oob_f)

        do_cadv = coarse_adv | ascend
        tcross_c, _, ccell_adv, ctmax_adv, _ = advance(
            s["ccell"], s["ctmax"], start
        )

        def sel3(m, a, b):
            return tuple(jnp.where(m, a[k], b[k]) for k in range(3))

        n = {}
        n["ccell"] = sel3(do_cadv, ccell_adv, s["ccell"])
        n["ctmax"] = sel3(do_cadv, ctmax_adv, s["ctmax"])
        n["centry_t"] = jnp.where(do_cadv, tcross_c, centry)
        n["in_fine"] = ((in_fine | descend) & ~ascend & ~fine_hit).astype(I32)
        n["fcell"] = sel3(descend, fcell_new, sel3(fine_step, fcell_adv, s["fcell"]))
        n["ftmax"] = sel3(descend, ftmax_new, sel3(fine_step, ftmax_adv, s["ftmax"]))
        n["fstart"] = sel3(descend, fstart_new, s["fstart"])
        n["fpos"] = sel3(descend, fstart_new, sel3(fine_step, isect_f, s["fpos"]))
        n["fpad"] = sel3(descend, fpad_new, s["fpad"])
        fsteps = s["fsteps"]
        n["fsteps"] = jnp.where(descend, 0, fsteps + jnp.where(fine_step, 1, 0))
        n["cnorm"] = sel3(descend, bnrm, s["cnorm"])
        n["fnorm"] = sel3(fine_step, fnorm_adv, s["fnorm"])
        steps = s["steps"] + jnp.where(do_cadv | fine_step, 1, 0)
        n["steps"] = steps

        cl = (clx, cly, clz)
        hit_pos = tuple(s["fpos"][k] + (cl[k] * f).astype(F32) for k in range(3))
        hit_nrm = sel3(fsteps == 0, s["cnorm"], s["fnorm"])
        n["pos_out"] = sel3(fine_hit, hit_pos, s["pos_out"])
        n["norm_out"] = sel3(fine_hit, hit_nrm, s["norm_out"])
        n["hit"] = ((s["hit"] != 0) | fine_hit).astype(I32)
        n["imm"] = jnp.where(descend, imm_new, s["imm"] != 0).astype(I32)
        n["hit_imm"] = (
            (s["hit_imm"] != 0) | (fine_hit & (fsteps == 0) & (s["imm"] != 0))
        ).astype(I32)
        budget_dead = steps >= max_steps
        n["active"] = (
            active & ~fine_hit & ~coarse_miss & ~budget_dead & ~pause
        ).astype(I32)
        return it + 1, n

    def cond(carry):
        it, s = carry
        return (it < iter_limit) & (jnp.max(s["active"]) > 0)

    s0 = {}
    for (name, k, _), r in zip(_LOOP_FLAT, loop_in):
        s0.setdefault(name, []).append(r[...])
    s0 = {k: (tuple(v) if len(v) == 3 else v[0]) for k, v in s0.items()}
    _, s = jax.lax.while_loop(cond, body, (jnp.int32(0), s0))
    for (name, k, dt), r in zip(_LOOP_FLAT, loop_out):
        v = s[name]
        r[...] = (v[k] if isinstance(v, tuple) else v).astype(dt)


@functools.partial(
    jax.jit,
    static_argnames=("max_steps", "iter_limit", "full_gz", "interpret"),
)
def advance_kernel(
    bm: BrickMap, st: _State, max_steps: int, iter_limit: int,
    z0=None, full_gz=None, interpret: bool = False,
) -> _State:
    """Run the traversal loop on ``st`` (an :func:`ops.trace._init_state`
    state) until every ray is done or ``iter_limit`` events have passed —
    the kernel counterpart of :func:`ops.trace._run_loop`, including its
    z-slab mode (``z0`` traced slab start, ``full_gz`` static full grid
    extent; rays leaving the slab pause with their state intact)."""
    n = st.active.shape[0]
    npad = -(-n // BLOCK) * BLOCK
    inv = 1.0 / jnp.where(st.d == 0.0, F32(FLT_EPS), st.d)
    comps = _split(st, inv)

    def pad(a):
        return jnp.pad(a, (0, npad - n))  # padded lanes: active == 0

    loop_in = [pad(comps[(nm, k)]) for nm, k, _ in _LOOP_FLAT]
    const_in = [pad(comps[(nm, k)]) for nm, k, _ in _CONST_FLAT]
    slab = z0 is not None
    z0_arr = jnp.asarray(0 if z0 is None else z0, I32).reshape(1)
    gx, gy, gz = bm.grid_dims
    kernel = functools.partial(
        _kernel,
        grid_dims=(gx, gy, gz),
        full_gz=gz if full_gz is None else full_gz,
        factor=bm.factor,
        coarse_layout=bm.coarse_layout,
        brick_layout=bm.brick_layout,
        dense_slots=bm.dense_slots,
        wpb=bm.words_per_brick,
        max_steps=max_steps,
        iter_limit=iter_limit,
        slab=slab,
        interpret=interpret,
    )
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    table_spec = pl.BlockSpec(memory_space=pl.ANY)
    bricks = jax.lax.bitcast_convert_type(bm.bricks.reshape(-1), I32)
    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((npad,), dt) for _, _, dt in _LOOP_FLAT],
        grid=(npad // BLOCK,),
        in_specs=[table_spec] * 4 + [ray_spec] * (len(loop_in) + len(const_in)),
        out_specs=[ray_spec] * len(_LOOP_FLAT),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="brickmap_traversal",
    )(bm.meta, bm.brick_idx, bricks, z0_arr, *loop_in, *const_in)
    out = {(nm, k): o[:n] for (nm, k, _), o in zip(_LOOP_FLAT, outs)}
    return _merge(st, out)


@functools.partial(jax.jit, static_argnames=("max_steps", "interpret"))
def trace_brickmap_kernel(
    bm: BrickMap, origins, rays, max_steps: int = MAX_STEPS,
    interpret: bool = False,
) -> TraceOut:
    """:func:`ops.trace.trace_brickmap` through the per-block kernel: same
    arguments (``rays`` need not be normalised), same results."""
    st = _init_state(bm, origins, rays)
    st = advance_kernel(bm, st, max_steps, 2 * max_steps + 8, interpret=interpret)
    return _finalize(st, bm.factor)
