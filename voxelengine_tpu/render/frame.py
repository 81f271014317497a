"""Frame rendering: primary rays -> traversal -> shading -> framebuffer.

Equivalent of the reference's ``screenDispatch`` kernel + ``RenderScreen``
host wrapper (``Renderer.cu:179-328``): the kernel's per-thread work becomes
one jitted pipeline over a flat pixel batch (camera -> trace -> shade), the
trace going through the platform's traversal
(:func:`voxelengine_tpu.ops.traverse.trace_rays`), and the per-frame write
into a persistent framebuffer implements the checkerboard/interlace trick
(``Renderer.cu:186-194,311-313``) as an index remap + masked select.

Faithfully reproduced details:
* checkerboard row remap ``y = 2*y' + (x even) + (frame even)`` with
  out-of-range rows dropped;
* DEBUG_VIEW quadrants: normals / hit-pos mod 128 / untouched / distance,
  plus the bottom-left step-count heatmap overlay (``Renderer.cu:215-243,
  270-275``) and its exact write masks (the bottom-left quadrant row at
  ``y == H/2`` keeps stale framebuffer content, like the reference);
* sky = raw ray direction channel-clamped at store (``Renderer.cu:254-258``);
* the crosshair write uses the pre-remap row index, so — exactly like the
  reference — it never fires while checkerboarding (``Renderer.cu:260-268``);
* normals are negated before display/shading (``Renderer.cu:212``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from voxelengine_tpu.config import (
    FLT_EPS_DDA,
    DebugView,
    Environment,
    Projection,
    RenderConfig,
)
from voxelengine_tpu.core.brickmap import BrickMap
from voxelengine_tpu.ops.noise import random_float
from voxelengine_tpu.ops.trace import TraceOut, trace_grid
from voxelengine_tpu.ops.traverse import trace_rays
from voxelengine_tpu.render import camera as cam
from voxelengine_tpu.render.shading import calculate_color, reflect, tonemap

F32 = jnp.float32


def make_framebuffer(cfg: RenderConfig) -> jax.Array:
    """Persistent RGB float framebuffer (the SDL streaming texture analog,
    ``SDLRenderer.cpp:19-31``)."""
    return jnp.zeros((cfg.height, cfg.width, 3), F32)


def _block_side(n):
    # largest divisor of n that is <= 32 (1080p checkerboard: 540 -> 30)
    for b in range(32, 0, -1):
        if n % b == 0:
            return b
    return 1


def block_geometry(cfg: RenderConfig):
    """(block_w, block_h, num_blocks) of the tile-order pixel blocking."""
    rows = cfg.height // 2 if cfg.checkerboard else cfg.height
    bw, bh = _block_side(cfg.width), _block_side(rows)
    return bw, bh, (cfg.width // bw) * (rows // bh)


def _unblock(a, cfg: RenderConfig):
    """Invert the tile_order ray layout back to a [rows, W, ...] image.

    Pure reshape/transpose — never a scatter.
    """
    W = cfg.width
    rows = cfg.height // 2 if cfg.checkerboard else cfg.height
    rest = a.shape[1:]
    bw, bh = _block_side(W), _block_side(rows)
    if cfg.tile_order and bw * bh > 1:
        a = a.reshape(rows // bh, W // bw, bh, bw, *rest)
        a = a.transpose(0, 2, 1, 3, *range(4, 4 + len(rest)))
    return a.reshape(rows, W, *rest)


def composite_frame(framebuffer, color, write, cfg: RenderConfig, frame_number):
    """Write a frame's shaded pixel stream into the persistent framebuffer.

    Implements the checkerboard row interleave ``y = 2*y' + (x even) +
    (frame even)`` (``Renderer.cu:186-196``) — including the dropped
    overflow row — entirely with static layout ops and masked selects.
    """
    H, W = cfg.height, cfg.width
    h = _unblock(color, cfg)  # [rows, W, 3]
    w = _unblock(write, cfg)  # [rows, W] bool
    if not cfg.checkerboard:
        return jnp.where(w[..., None], h, framebuffer)
    if H % 2:  # odd-height checkerboard: rare; keep the scatter form
        py_r = jnp.arange(H // 2)[:, None]
        px = jnp.arange(W)[None, :]
        py = py_r * 2 + jnp.where(px % 2 == 0, 1, 0) + jnp.where(
            frame_number % 2 == 0, 1, 0
        )
        py_w = jnp.where(w & (py < H), py, H)
        return framebuffer.at[py_w, jnp.broadcast_to(px, py.shape)].set(
            h, mode="drop"
        )
    # checkerboard: rows' target y = 2*y' + off, off = (x even)+(frame even)
    # the off == 2 case shifts even columns down one row pair; the global
    # top's missing source is an all-zero/never-write row
    h_prev = jnp.concatenate([jnp.zeros_like(h[:1]), h[:-1]], axis=0)
    w_prev = jnp.concatenate([jnp.zeros_like(w[:1]), w[:-1]], axis=0)
    return checkerboard_pair_select(
        framebuffer, h, w, h_prev, w_prev, frame_number
    )


def checkerboard_pair_select(framebuffer, h, w, h_prev, w_prev, frame_number):
    """Scatter-free checkerboard composite of a pre-remap row image into
    the framebuffer's row pairs (``y = 2*y' + (x even) + (frame even)``,
    ``Renderer.cu:186-196``, including the dropped overflow row).

    ``h_prev``/``w_prev`` supply each row's PREDECESSOR pre-remap row
    (the even-frame ``+2`` source): the single-device path shifts ``h``
    down one row; the row-sharded path substitutes its cross-device halo
    row — one implementation serves both (they are asserted equal by
    ``test_sharded_render_hbm_kernel_matches_single``).
    """
    rows, W = w.shape
    ce = (jnp.arange(W) % 2 == 0)[None, :]  # column parity
    q = frame_number % 2 == 0
    src0 = jnp.where(q, h_prev, h)  # even target rows
    m0 = jnp.where(q, ce & w_prev, (~ce) & w)
    m1 = w & jnp.where(q, ~ce, ce)  # odd target rows take h
    pairs = framebuffer.reshape(rows, 2, W, 3)
    p0 = jnp.where(m0[..., None], src0, pairs[:, 0])
    p1 = jnp.where(m1[..., None], h, pairs[:, 1])
    return jnp.stack([p0, p1], axis=1).reshape(2 * rows, W, 3)


def primary_rays(cfg: RenderConfig, origin, euler, frame_number, ortho_size=None):
    """Build the frame's primary rays.

    Returns (origins [N,3], dirs [N,3], px [N], py [N]) where (px, py) are
    final framebuffer coordinates (checkerboard-remapped; py may equal H for
    dropped rows, ``Renderer.cu:186-196``).  ``ortho_size`` (optional [2]
    array) overrides ``cfg.ortho_size`` as a TRACED value so interactive
    zoom (``SetOrthoWindowSize``, ``main.cu:94-107``) never recompiles.
    """
    W, H = cfg.width, cfg.height
    rows = H // 2 if cfg.checkerboard else H
    xg, yg = jnp.meshgrid(jnp.arange(W), jnp.arange(rows), indexing="xy")
    bw, bh = _block_side(W), _block_side(rows)
    if cfg.tile_order and bw * bh > 1:
        # order rays as ~32x32 pixel blocks, so the rays of one traversal
        # block are screen neighbours; px/py travel with the rays
        def blocked(a):
            return (
                a.reshape(rows // bh, bh, W // bw, bw)
                .transpose(0, 2, 1, 3)
                .reshape(-1)
            )
        px = blocked(xg)
        py_r = blocked(yg)
    else:
        px = xg.reshape(-1)
        py_r = yg.reshape(-1)
    if cfg.checkerboard:
        py = py_r * 2 + jnp.where(px % 2 == 0, 1, 0) + jnp.where(frame_number % 2 == 0, 1, 0)
    else:
        py = py_r

    u = px.astype(F32) / F32(W)
    v = py.astype(F32) / F32(H)
    fwd, up, right = cam.get_directions(euler)
    origin = jnp.asarray(origin, F32)
    if cfg.projection is Projection.PERSPECTIVE:
        dirs = cam.ray_direction(fwd, up, right, W, H, u, v, cfg.fov_degrees)
        origins = jnp.broadcast_to(origin, dirs.shape)
    else:
        dirs = jnp.broadcast_to(fwd, (px.shape[0], 3))
        osz = cfg.ortho_size if ortho_size is None else ortho_size
        origins = cam.ray_origin_ortho(fwd, up, right, W, H, u, v, origin, osz)
    return origins, dirs, px, py, py_r


def _ambient_occlusion(
    bm: BrickMap, position, normal, px, py, frame_number, cfg: RenderConfig,
    fused=None, secondary=None,
):
    """Hemisphere-sampled AO (working version of the reference's disabled
    scaffolding, ``Renderer.cu:120-165``): short 8-step occlusion rays with
    distance falloff, seeded per pixel/frame via the noise hash.
    ``secondary``: optional ``(origins, dirs, max_steps) -> TraceOut``
    override for the occlusion traces (distributed-world renders)."""
    W = cfg.width
    seed = (py * W + px).astype(jnp.int32)
    occ = jnp.zeros(position.shape[0], F32)
    for i in range(cfg.ao_samples):
        # distinct multipliers for the sample and frame terms: a shared
        # 1000 would alias frame n sample i with frame n+1 sample i-1,
        # re-tracing ao_samples-1 identical directions every frame
        si = seed + jnp.int32(i * 1000) + (frame_number + 1) * 7919
        sd = jnp.stack(
            [
                random_float(si.astype(jnp.uint32)) * 2.0 - 1.0,
                random_float((si * 10).astype(jnp.uint32)) * 2.0 - 1.0,
                random_float((si * 100).astype(jnp.uint32)) * 2.0 - 1.0,
            ],
            axis=-1,
        )
        sd = sd / jnp.linalg.norm(sd, axis=-1, keepdims=True)
        below = jnp.sum(sd * normal, axis=-1) < 0.0
        sd = jnp.where(below[:, None], reflect(sd, normal), sd)
        res = (
            secondary(position + normal * 0.01, sd, 8)
            if secondary is not None
            else trace_rays(bm, position + normal * 0.01, sd, 8, fused)
        )
        dist = jnp.linalg.norm(res.position - position, axis=-1)
        falloff = 1.0 - jnp.minimum(1.0 / jnp.maximum(dist * 10.0, 1e-6), 1.0)
        occ = occ + jnp.where(res.hit, falloff, 1.0)
    return occ / F32(cfg.ao_samples)


def shade_pixels(
    bm: BrickMap,
    origins,
    dirs,
    px,
    py,
    py_r,
    origin,
    env: Environment,
    frame_number,
    cfg: RenderConfig,
    fused=None,
):
    """Trace + shade a flat pixel batch; returns ``(color [N,3], write [N])``.

    The per-pixel body of ``screenDispatch`` (``Renderer.cu:179-276``),
    shared by the single-device and sharded render paths.  Every ray runs
    to its hit or the full step budget.
    """
    out = trace_rays(bm, origins, dirs, cfg.max_steps, fused)
    return shade_traced(
        bm, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg,
        fused=fused,
    )


def shade_traced(
    bm,
    out: TraceOut,
    origins,
    dirs,
    px,
    py,
    py_r,
    origin,
    env: Environment,
    frame_number,
    cfg: RenderConfig,
    fused=None,
    secondary=None,
):
    """Shading/compositing stage of ``screenDispatch`` given trace results;
    ``bm``/``fused`` are only needed for the optional shadow/AO/reflection
    secondary traces.
    ``secondary``: optional ``(origins, dirs, max_steps) -> TraceOut``
    trace override — distributed-world renders route shadow/AO rays through
    their own sharded tracer instead of a local brickmap."""
    W, H = cfg.width, cfg.height
    normal = -out.normal  # Renderer.cu:212
    steps = out.steps

    cam_pos = jnp.asarray(origin, F32)
    shadow_hit = None
    if cfg.shadow_rays and (bm is not None or secondary is not None):
        L = env.light_direction
        sdirs = jnp.broadcast_to(L, normal.shape)
        sres = (
            secondary(out.position + L * 0.01, sdirs, cfg.max_steps)
            if secondary is not None
            else trace_rays(
                bm, out.position + L * 0.01, sdirs, cfg.max_steps, fused
            )
        )
        shadow_hit = sres.hit & out.hit
        steps = steps + jnp.where(out.hit, sres.steps, 0)

    dist = jnp.linalg.norm(out.position - origins, axis=-1)

    if cfg.debug_view is DebugView.SHADED:
        color = calculate_color(cam_pos, normal, out.position, env, shadow_hit)
        if cfg.reflections and (bm is not None or secondary is not None):
            # one-bounce mirror reflection (extension beyond the reference;
            # see RenderConfig.reflections): trace the reflected ray through
            # the same path as the primaries, shade its hit with the same
            # model (reflected sky = raw ray direction, like the primary
            # miss rule Renderer.cu:254-258), lerp by reflectivity.  Miss
            # pixels trace from the inf sentinel like the AO/shadow rays
            # and are discarded by the sky overwrite below.
            rdir = reflect(dirs, normal)
            ro = out.position + normal * 0.01
            rres = (
                secondary(ro, rdir, cfg.max_steps)
                if secondary is not None
                else trace_rays(bm, ro, rdir, cfg.max_steps, fused)
            )
            rcol = calculate_color(ro, -rres.normal, rres.position, env, None)
            rcol = jnp.where(rres.hit[:, None], rcol, rdir)
            color = color + (rcol - color) * F32(cfg.reflectivity)
        if cfg.ao_samples > 0 and (bm is not None or secondary is not None):
            l_dot = jnp.maximum(jnp.sum(normal * env.light_direction, axis=-1), 0.0)
            ao = _ambient_occlusion(
                bm, out.position, normal, px, py, frame_number, cfg, fused,
                secondary,
            )
            color = jnp.where((l_dot == 0.0)[:, None], color * ao[:, None], color)
        color = tonemap(color)
        write = jnp.ones_like(out.hit)
    elif cfg.debug_view is DebugView.DEBUG:
        hp = out.position / F32(cfg.debug_pos_mod)
        hp = jnp.mod(hp, F32(1.0) + F32(FLT_EPS_DDA))
        left = px < (W >> 1)
        top = py < (H >> 1)
        color = jnp.where(
            top[:, None],
            jnp.where(left[:, None], normal, hp),
            jnp.stack([dist * 0.01, jnp.zeros_like(dist), jnp.zeros_like(dist)], -1),
        )
        # bottom-left quadrant: no write on hit (Renderer.cu:233-235)
        write = ~(left & ~top)
    elif cfg.debug_view is DebugView.NORMALS:
        color = normal
        write = jnp.ones_like(out.hit)
    elif cfg.debug_view is DebugView.DEPTH:
        color = jnp.stack([dist * 0.01, jnp.zeros_like(dist), jnp.zeros_like(dist)], -1)
        write = jnp.ones_like(out.hit)
    else:  # STEPS
        color = jnp.stack(
            [steps.astype(F32) / 256.0, jnp.zeros_like(dist), jnp.zeros_like(dist)], -1
        )
        write = jnp.ones_like(out.hit)

    # miss -> sky = raw ray direction (Renderer.cu:254-258)
    color = jnp.where(out.hit[:, None], color, dirs)
    write = write | ~out.hit

    # crosshair: uses the PRE-remap row, so it only fires without
    # checkerboarding — reference behavior (Renderer.cu:260-268)
    if cfg.crosshair:
        cross = (px == (W >> 1)) & (py_r == (H >> 1))
        color = jnp.where(cross[:, None], 10.0, color)
        write = write | cross

    if cfg.debug_view is DebugView.DEBUG:
        # bottom-left step heatmap overlay (Renderer.cu:270-275)
        bl = (px < (W >> 1)) & (py > (H >> 1))
        color = jnp.where(
            bl[:, None],
            jnp.stack([steps.astype(F32) / 256.0, jnp.zeros_like(dist), jnp.zeros_like(dist)], -1),
            color,
        )
        write = write | bl

    color = jnp.clip(color, 0.0, 1.0)  # setPixelColor clamp (Renderer.cu:79-81)
    return color, write


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def render_frame(
    bm: BrickMap,
    framebuffer: jax.Array,
    origin,
    euler,
    env: Environment,
    frame_number,
    cfg: RenderConfig,
    fused=None,
    ortho_size=None,
) -> jax.Array:
    """Render one frame into the persistent framebuffer (RGB f32 in [0,1]).

    The full fused path of ``RenderScreen`` -> ``screenDispatch``
    (``Renderer.cu:305-328,179-276``).  ``frame_number`` is a traced scalar
    so checkerboard parity doesn't recompile.  ``ortho_size`` (optional
    [2] array) zooms the ortho
    window as a traced value — no recompile per scroll tick.
    """
    origins, dirs, px, py, py_r = primary_rays(
        cfg, origin, euler, frame_number, ortho_size
    )
    color, write = shade_pixels(
        bm, origins, dirs, px, py, py_r, origin, env, frame_number, cfg, fused
    )
    return composite_frame(framebuffer, color, write, cfg, frame_number)


def to_bgra8(fb: jax.Array) -> jax.Array:
    """RGB f32 [0,1] -> packed BGRA8888 bytes (``Renderer.cuh:29-31``,
    ``SDLRenderer.h:8-11`` byte order) for the display sink."""
    u8 = (jnp.clip(fb, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    a = jnp.full(fb.shape[:-1] + (1,), 255, jnp.uint8)
    return jnp.concatenate([u8[..., 2:3], u8[..., 1:2], u8[..., 0:1], a], axis=-1)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def render_frame_dense(
    grid,
    framebuffer: jax.Array,
    origin,
    euler,
    env: Environment,
    frame_number,
    cfg: RenderConfig,
    ortho_size=None,
) -> jax.Array:
    """``render_frame`` over a dense :class:`BitGrid` world, traversed by the
    single-level DDA :func:`voxelengine_tpu.ops.trace.trace_grid`.
    Shadow/AO secondary rays are not supported on this path."""
    origins, dirs, px, py, py_r = primary_rays(
        cfg, origin, euler, frame_number, ortho_size=ortho_size
    )
    out = trace_grid(grid, origins, dirs, cfg.max_steps)
    color, write = shade_traced(
        None, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg
    )
    return composite_frame(framebuffer, color, write, cfg, frame_number)
