"""Traversal semantics, checked on every brickmap traversal the engine has.

Each scenario (edge pads, grazing and axis-aligned rays, origins outside
the world or inside solid voxels, step-budget truncation, re-trace after an
edit, 1-voxel bricks, layouts, compact worlds) runs through the plain XLA
traversal, the staged XLA traversal and the GPU kernel (interpret mode).
Every traversal must report hits that lie on the ray and inside a solid
voxel, never exceed the step budget, and — for the staged traversal and the
kernel — equal the plain traversal on every field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voxelengine_tpu.core.bitgrid import BitGrid
from voxelengine_tpu.core.brickmap import apply_edits, build_brickmap
from voxelengine_tpu.core.layout import Layout
from voxelengine_tpu.ops.trace import trace_brickmap, trace_brickmap_staged
from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel

F32 = np.float32


def _random_dense(r, dims=(64, 64, 64), fill=0.02):
    dense = r.random((dims[2], dims[1], dims[0])) < fill  # [z, y, x]
    dense[:, 0:4, :] = r.random((dims[2], 4, dims[0])) < 0.5
    return dense


def _rays_at(r, n, world, spread=2.0):
    w = np.asarray(world, F32)
    origins = (r.random((n, 3)) * w * spread - w * (spread - 1) / 2).astype(F32)
    targets = (r.random((n, 3)) * w).astype(F32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(F32)


def _build(dense, factor=8, **kw):
    return build_brickmap(BitGrid.from_dense(dense), factor, **kw)


def scenario_random_world(r):
    dense = _random_dense(r)
    return dense, _build(dense), *_rays_at(r, 256, (64, 64, 64)), 256


def scenario_edge_pads(r):
    """Origins exactly on the world's max faces and on chunk boundaries,
    pointing back in: the max-edge padding (VolumeRaytracer.cu:216-232)."""
    dense = _random_dense(r, fill=0.05)
    n = 128
    o = (r.integers(0, 9, (n, 3)) * 8).astype(F32)  # chunk-lattice points
    face = r.integers(0, 3, n)
    o[np.arange(n), face] = 64.0  # on a max face
    d = -np.abs(r.normal(size=(n, 3))).astype(F32) - 0.05
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dense, _build(dense), o, d.astype(F32), 256


def scenario_axis_aligned_and_grazing(r):
    """Rays along +-x/y/z exactly (zero direction components) and rays
    grazing a plane with tiny components."""
    dense = _random_dense(r, fill=0.03)
    n = 192
    o = (r.random((n, 3)) * 64).astype(F32)
    axes = np.eye(3, dtype=F32)
    d = np.concatenate([axes, -axes])[r.integers(0, 6, n)]
    graze = r.random(n) < 0.5
    d[graze] += (r.normal(size=(graze.sum(), 3)) * 1e-4).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dense, _build(dense), o, d.astype(F32), 256


def scenario_outside_origins(r):
    """Origins far outside the world on every side, some aimed past it."""
    dense = _random_dense(r)
    o, d = _rays_at(r, 256, (64, 64, 64), spread=6.0)
    miss = r.random(256) < 0.3
    d[miss] = -d[miss]  # aimed away: never enters the world
    return dense, _build(dense), o, d, 256


def scenario_budget_truncation(r):
    """Long grazing walks over a floor-only world with a tiny budget:
    rays die of the budget, with steps == max_steps and no hit."""
    dense = np.zeros((64, 64, 64), bool)
    dense[:, 0:4, :] = r.random((64, 4, 64)) < 0.5
    n = 128
    o = np.tile(np.asarray([[1.0, 30.0, 1.0]], F32), (n, 1))
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    d = np.stack([np.cos(ang), np.full(n, -0.01), np.sin(ang)], 1).astype(F32)
    return dense, _build(dense), o, d, 6


def scenario_retrace_after_edit(r):
    """Place and break voxels in place, then trace the edited world."""
    dense = _random_dense(r, fill=0.01)
    bm = _build(dense)
    k = 60
    xs, ys, zs = (r.integers(0, 64, k) for _ in range(3))
    vals = r.random(k) < 0.6
    bm = apply_edits(jax.tree.map(jnp.copy, bm), xs, ys, zs, vals)
    dense = dense.copy()
    dense[zs, ys, xs] = vals
    return dense, bm, *_rays_at(r, 256, (64, 64, 64)), 256


def scenario_one_voxel_bricks(r):
    """factor 1: every chunk is one voxel, every brick one bit."""
    dense = _random_dense(r, dims=(16, 16, 16), fill=0.08)
    return dense, _build(dense, 1), *_rays_at(r, 192, (16, 16, 16)), 256


def scenario_morton_layouts(r):
    """TILED_MORTON coarse and brick orders (VolumeRaytracer.cuh:41-106)."""
    dense = _random_dense(r)
    bm = _build(dense, coarse_layout=Layout.TILED_MORTON,
                brick_layout=Layout.TILED_MORTON)
    return dense, bm, *_rays_at(r, 192, (64, 64, 64)), 256


def scenario_compact_terrain(r):
    """Compact indirection (shared all-full brick, brick_idx gather) from
    the terrain builder."""
    from voxelengine_tpu.core.brickmap import build_brickmap_terrain_compact

    bm = build_brickmap_terrain_compact((128, 64, 128), 32, octaves=3)
    dense = np.asarray(bm.to_dense())
    return dense, bm, *_rays_at(r, 256, (128, 64, 128), spread=1.5), 512


def scenario_inside_solid(r):
    """Origins inside solid voxels and on the world's min corner: the
    degenerate zero-step hit (VolumeRaytracer.cu:518-522)."""
    dense = _random_dense(r, fill=0.3)
    zi, yi, xi = np.nonzero(dense)
    pick = r.integers(0, zi.size, 96)
    o = np.stack([xi[pick], yi[pick], zi[pick]], 1).astype(F32) + 0.5
    o[:8] = 0.0
    d = r.normal(size=(96, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dense, _build(dense), o, d.astype(F32), 256


SCENARIOS = {
    f.__name__[len("scenario_"):]: f
    for f in [
        scenario_random_world, scenario_edge_pads,
        scenario_axis_aligned_and_grazing, scenario_outside_origins,
        scenario_budget_truncation, scenario_retrace_after_edit,
        scenario_one_voxel_bricks, scenario_morton_layouts,
        scenario_compact_terrain, scenario_inside_solid,
    ]
}

TRAVERSALS = {
    "xla": lambda bm, o, d, ms: trace_brickmap(bm, o, d, ms),
    "xla_staged": lambda bm, o, d, ms: trace_brickmap_staged(
        bm, o, d, ms, stage_iters=16, tail_frac=4
    ),
    "kernel": lambda bm, o, d, ms: trace_brickmap_kernel(
        bm, o, d, ms, interpret=True
    ),
}


@pytest.mark.parametrize("traversal", list(TRAVERSALS))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_traversal_semantics(scenario, traversal):
    r = np.random.default_rng(sorted(SCENARIOS).index(scenario))
    dense, bm, o, d, max_steps = SCENARIOS[scenario](r)
    o, d = jnp.asarray(o), jnp.asarray(d)
    out = TRAVERSALS[traversal](bm, o, d, max_steps)

    hit = np.asarray(out.hit)
    pos = np.asarray(out.position)
    nrm = np.asarray(out.normal)
    steps = np.asarray(out.steps)
    assert hit.shape == steps.shape == (o.shape[0],)
    assert (steps >= 0).all() and (steps <= max_steps).all()

    # a hit lies on solid geometry: the hit point sits on a face (or edge,
    # or corner) of the hit voxel, so one of the voxels touching it is
    # solid
    Z, Y, X = dense.shape
    touching = np.zeros(hit.sum(), bool)
    for delta in np.stack(np.meshgrid(*[[-0.25, 0.25]] * 3), -1).reshape(-1, 3):
        v = np.floor(pos[hit] + delta).astype(np.int64)
        v = np.clip(v, 0, [X - 1, Y - 1, Z - 1])
        touching |= dense[v[:, 2], v[:, 1], v[:, 0]]
    assert touching.all()
    # ... and lies on the ray (origin + t * d, t >= 0), unless the ray
    # started outside the world and was clipped onto its box first
    dn = np.asarray(d) / np.linalg.norm(np.asarray(d), axis=1, keepdims=True)
    rel = pos[hit] - np.asarray(o)[hit]
    off = rel - (rel * dn[hit]).sum(1, keepdims=True) * dn[hit]
    assert (np.abs(off) < 1e-2 * (1 + np.abs(rel))).all()

    if traversal != "xla":
        ref = trace_brickmap(bm, o, d, max_steps)
        assert np.array_equal(np.asarray(ref.hit), hit)
        assert np.array_equal(np.asarray(ref.steps), steps)
        assert np.array_equal(np.asarray(ref.position)[hit], pos[hit])
        assert np.array_equal(np.asarray(ref.normal)[hit], nrm[hit])

    if scenario == "budget_truncation":
        assert (steps[~hit] == max_steps).any()
