"""The one place that chooses how rays traverse a brickmap.

Every trace in the engine (primary and secondary rays of a frame, batch
queries, sharded frames and queries, z-slab worlds) goes through
:func:`trace_rays` or :func:`advance`.  The choice follows the platform the
computation is traced for, never a user option:

* ``"gpu"``: the per-block kernel of :mod:`voxelengine_tpu.ops.trace_kernel`
  (one warp of rays per program, each block retiring on its own).  A kernel
  that fails to compile is an error; nothing falls back.
* ``"cpu"``: the XLA state machine of :mod:`voxelengine_tpu.ops.trace`,
  which is also the reference the kernel is checked against.
"""

from __future__ import annotations

import jax

from voxelengine_tpu.config import MAX_STEPS
from voxelengine_tpu.core.brickmap import BrickMap
from voxelengine_tpu.ops import trace, trace_kernel


def _trace_xla(bm, origins, rays, max_steps, fused):
    return trace.trace_brickmap(bm, origins, rays, max_steps, fused=fused)


def _trace_kernel(bm, origins, rays, max_steps, fused):
    return trace_kernel.trace_brickmap_kernel(bm, origins, rays, max_steps)


def _advance_xla(bm, st, max_steps, iter_limit, z0, full_gz):
    slab = None if z0 is None else (z0, full_gz)
    return trace._run_loop(bm, st, max_steps, iter_limit, slab=slab)


def _advance_kernel(bm, st, max_steps, iter_limit, z0, full_gz):
    return trace_kernel.advance_kernel(
        bm, st, max_steps, iter_limit, z0=z0, full_gz=full_gz
    )


#: platform -> (batch traversal, loop advance)
TRAVERSALS = {
    "cpu": (_trace_xla, _advance_xla),
    "gpu": (_trace_kernel, _advance_kernel),
}


def select_traversal(platform=None):
    """``(trace, advance)`` for ``platform`` (a ``jax.default_backend()``
    name; ``None`` = the default backend)."""
    platform = jax.default_backend() if platform is None else platform
    if platform not in TRAVERSALS:
        raise ValueError(f"no brickmap traversal for platform {platform!r}")
    return TRAVERSALS[platform]


def trace_rays(
    bm: BrickMap, origins, rays, max_steps: int = MAX_STEPS, fused=None,
    platform=None,
) -> trace.TraceOut:
    """Trace ``f32[N, 3]`` rays through ``bm`` with the platform's traversal
    (see the module doc).  ``fused``: optional
    :func:`ops.trace.make_fused_table`, used by the XLA traversal only."""
    trace_fn, _ = select_traversal(platform)
    return trace_fn(bm, origins, rays, max_steps, fused)


def advance(
    bm: BrickMap, st, max_steps: int, iter_limit: int, z0=None, full_gz=None,
    platform=None,
):
    """Advance an :func:`ops.trace._init_state` state by up to
    ``iter_limit`` DDA events with the platform's traversal loop.  ``z0`` /
    ``full_gz``: z-slab mode (``bm`` holds coarse z ``[z0, z0 + gz)`` of a
    grid ``full_gz`` deep; rays leaving the slab pause with state intact)."""
    _, advance_fn = select_traversal(platform)
    return advance_fn(bm, st, max_steps, iter_limit, z0, full_gz)
