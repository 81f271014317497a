"""Single-ray crossing-trace diagnostic.

Role-equivalent of the reference's ``RECORD_INTERSECTED_POINTS`` build
(``DDATestCpp/DDATestCpp.cpp:15-25,129-131``): dump every DDA event of ONE
selected ray — phase, coarse/fine cell, crossing times, step counts — so a
single disagreeing ray can be debugged event by event instead of from
aggregate counts.

The dump runs the traversal's own step function
(:func:`voxelengine_tpu.ops.trace._step`, the body of the XLA loop, which
the GPU kernel reproduces per block) under ``lax.scan`` on a one-ray state
and keeps every iteration's state.  So the dumped event sequence is the
traversal's event sequence, and its final record equals what
:func:`voxelengine_tpu.ops.traverse.trace_rays` returns for that ray.

Typical use: two traversals (or a traversal and the scalar oracle) disagree
on ray i -> ``dump = trace_ray_crossings(bm, origins[i], rays[i])`` ->
``print(format_crossings(dump))`` and compare against the oracle (whose
``record=`` hook logs the same per-level cell/point sequence).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from voxelengine_tpu.config import MAX_STEPS
from voxelengine_tpu.core.brickmap import BrickMap
from voxelengine_tpu.ops.trace import _finalize, _init_state, _step

F32 = jnp.float32


def trace_ray_crossings(
    bm: BrickMap,
    origin,
    ray,
    max_steps: int = MAX_STEPS,
    max_iters: Optional[int] = None,
):
    """Trace ONE ray through the traversal's event loop, dumping every
    iteration.

    Returns a dict of numpy arrays (one row per executed iteration, trimmed
    at ray retirement): ``phase`` (tuple of event names per iteration, from
    ``cadv`` coarse advance, ``desc`` descend into a chunk, ``fstep`` fine
    step, ``asc`` ascend out of a chunk, ``hit``, ``miss``, ``budget``),
    ``coarse_cell``/``fine_cell`` [T,3], ``in_fine`` [T],
    ``t_coarse``/``t_fine`` [T,3] (next-crossing candidates per axis),
    ``point`` [T,3] (fine-level crossing position, chunk-local x factor),
    ``steps``/``fsteps`` [T], plus the final result under ``hit``,
    ``hit_immediate``, ``position``, ``normal`` and ``steps_total``.
    """
    st0 = _init_state(
        bm,
        jnp.asarray(origin, F32).reshape(1, 3),
        jnp.asarray(ray, F32).reshape(1, 3),
    )
    if max_iters is None:
        max_iters = 2 * max_steps + 8  # trace_brickmap's own iteration cap

    def step(st, _):
        new = _step(bm, st, max_steps)
        return new, new

    final, ys = jax.jit(
        lambda st: jax.lax.scan(step, st, None, length=max_iters)
    )(st0)
    ys = jax.tree.map(lambda a: np.asarray(a)[:, 0] if a.ndim > 1 else a, ys)
    prev_active = np.concatenate([np.asarray(st0.active), ys.active[:-1]])
    prev_fine = np.concatenate([np.asarray(st0.in_fine), ys.in_fine[:-1]])
    prev_steps = np.concatenate([np.asarray(st0.steps), ys.steps[:-1]])
    prev_hit = np.concatenate([np.asarray(st0.hit), ys.hit[:-1]])

    # iterations executed, INCLUDING the retiring one (the row where the
    # ray goes inactive carries the hit/miss event itself)
    ran = int(prev_active.sum())
    phase = []
    for k in range(ran):
        stepped = ys.steps[k] > prev_steps[k]
        ev = []
        if not prev_fine[k]:
            if ys.in_fine[k]:
                ev.append("desc")
            elif stepped:
                ev.append("cadv")
        elif ys.in_fine[k]:
            if stepped:
                ev.append("fstep")
        elif stepped:
            ev.append("asc")
        if ys.hit[k] and not prev_hit[k]:
            ev.append("hit")
        elif not ys.active[k]:
            ev.append("budget" if ys.steps[k] >= max_steps else "miss")
        phase.append(tuple(ev))

    out = jax.tree.map(np.asarray, _finalize(final, bm.factor))
    return dict(
        iterations=ran,
        phase=phase,
        coarse_cell=ys.ccell[:ran],
        fine_cell=ys.fcell[:ran],
        in_fine=ys.in_fine[:ran],
        t_coarse=ys.ctmax[:ran],
        t_fine=ys.ftmax[:ran],
        point=ys.fpos[:ran],
        steps=ys.steps[:ran],
        fsteps=ys.fsteps[:ran],
        hit=bool(out.hit[0]),
        hit_immediate=bool(np.asarray(final.hit_imm)[0]),
        position=out.position[0],
        normal=out.normal[0],
        steps_total=int(out.steps[0]),
    )


def format_crossings(dump, limit: int = 200) -> str:
    """Human-readable event log of a :func:`trace_ray_crossings` dump."""
    lines = [
        f"# {dump['iterations']} iterations, hit={dump['hit']}"
        f" steps={dump['steps_total']} pos={dump['position']}"
    ]
    for i in range(min(dump["iterations"], limit)):
        ph = "+".join(dump["phase"][i]) or "-"
        cc = dump["coarse_cell"][i]
        if dump["in_fine"][i]:
            fc = dump["fine_cell"][i]
            lines.append(
                f"{i:5d} {ph:12s} chunk=({cc[0]},{cc[1]},{cc[2]})"
                f" cell=({fc[0]},{fc[1]},{fc[2]}) t={dump['t_fine'][i]}"
                f" steps={dump['steps'][i]}"
            )
        else:
            lines.append(
                f"{i:5d} {ph:12s} chunk=({cc[0]},{cc[1]},{cc[2]})"
                f" t={dump['t_coarse'][i]} steps={dump['steps'][i]}"
            )
    if dump["iterations"] > limit:
        lines.append(f"... {dump['iterations'] - limit} more")
    return "\n".join(lines)
