"""Procedural noise library — JAX/VPU equivalent of the reference's
``cuda_noise`` header (``VoxelRT/cuda_noise.cuh``, 870 LoC).

Every function is vectorized over position arrays (shape-polymorphic jnp) and
reproduces the reference's *bit-level* semantics so the generated worlds are
identical across backends:

* integer hashing is uint32 with wraparound (``cuda_noise.cuh:44-54``);
* float→uint/int conversions follow CUDA's saturating ``cvt.rzi`` semantics
  (negative→0 / INT_MIN, overflow→UINT_MAX / INT_MAX, trunc toward zero);
* float math is fp32 in the reference's exact operation order.

Only ``repeater_perlin`` + ``random_float`` are on the engine's hot worldgen
path (``VoxelWorldBuilder.cu:6``); the rest of the surface (simplex, worley,
spots, value noises, turbulence, generic repeaters) is provided for full
library parity.

Reference quirks preserved on purpose (do not "fix" without updating tests):
  * ``repeater_perlin`` ignores its ``seed`` argument — octave seeds are
    ``(i + 38) * 27389482`` (``cuda_noise.cuh:615-629``).
  * ``grad`` has duplicate/asymmetric entries for hash 0xC..0xF
    (``cuda_noise.cuh:173-195``).
  * ``clamp`` ignores its min/max arguments and clamps to [0, 1]
    (``cuda_noise.cuh:72-80``).
  * ``repeater_perlin_abs`` reuses the same seed for every octave
    (``cuda_noise.cuh:653-669``).
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

EPSILON = 1e-9  # cuda_noise.cuh:39


def _wrap_i32(v: int) -> int:
    """Python int -> wrapped int32 value (C overflow semantics)."""
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v

_U32_MAX_F = jnp.float32(4294967295.0)
_I32_MAX_F = jnp.float32(2147483520.0)  # largest f32 below 2^31
_I32_MIN_F = jnp.float32(-2147483648.0)


class Basis(enum.Enum):
    """``basisFunction`` (``cuda_noise.cuh:10-21``)."""

    CHECKER = 0
    DISCRETE = 1
    LINEARVALUE = 2
    FADEDVALUE = 3
    CUBICVALUE = 4
    SIMPLEX = 5
    PERLIN = 6
    WORLEY = 7
    SPOTS = 8


class Shape(enum.Enum):
    """``profileShape`` (``cuda_noise.cuh:23-28``)."""

    STEP = 0
    LINEAR = 1
    QUADRATIC = 2


# ---------------------------------------------------------------------------
# conversion helpers (CUDA cvt.rzi semantics)
# ---------------------------------------------------------------------------


def f32_to_u32_sat(x):
    """float32 -> uint32 like CUDA ``(unsigned int)f``: truncate toward zero,
    saturate negatives to 0 and overflow to UINT_MAX, NaN -> 0.

    The overflow branch is explicit: ``float32(2^32 - 1)`` rounds UP to 2^32,
    so clipping to it still leaves an out-of-range value whose uint32
    conversion is backend-defined — the select pins every backend to the
    CUDA saturate."""
    x = jnp.asarray(x, jnp.float32)
    x = jnp.where(jnp.isnan(x), 0.0, x)
    hi = x >= jnp.float32(4294967296.0)  # 2^32: exact in f32
    x = jnp.clip(x, 0.0, jnp.float32(4294967040.0))  # largest f32 below 2^32
    return jnp.where(hi, jnp.uint32(0xFFFFFFFF), x.astype(jnp.uint32))


def f32_to_i32_sat(x):
    """float32 -> int32 like CUDA ``(int)f``: truncate toward zero with
    saturation (positive overflow -> INT_MAX exactly, as ``cvt.rzi.s32.f32``
    saturates — not the largest-representable-f32 2147483520)."""
    x = jnp.asarray(x, jnp.float32)
    x = jnp.where(jnp.isnan(x), 0.0, x)
    hi = x >= jnp.float32(2147483648.0)  # 2^31: exact in f32
    x = jnp.clip(x, _I32_MIN_F, _I32_MAX_F)
    return jnp.where(hi, jnp.int32(2147483647), x.astype(jnp.int32))


def _f32(x):
    return jnp.asarray(x, jnp.float32)


def saturate(x):
    """CUDA ``__saturatef``: clamp to [0, 1]."""
    return jnp.clip(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# hashing / random utilities (cuda_noise.cuh:44-122)
# ---------------------------------------------------------------------------


def hash_u32(seed):
    """6-round avalanche integer hash (``cuda_noise.cuh:44-54``)."""
    s = jnp.asarray(seed).astype(jnp.uint32)
    s = (s + jnp.uint32(0x7ED55D16)) + (s << 12)
    s = (s ^ jnp.uint32(0xC761C23C)) ^ (s >> 19)
    s = (s + jnp.uint32(0x165667B1)) + (s << 5)
    s = (s + jnp.uint32(0xD3A2646C)) ^ (s << 9)
    s = (s + jnp.uint32(0xFD7046C5)) + (s << 3)
    s = (s ^ jnp.uint32(0xB55A4F09)) ^ (s >> 16)
    return s


def random_float(seed):
    """Random float in [0, 1] (``cuda_noise.cuh:65-71``).  ``seed`` is a
    uint32 (or float already converted by the caller via saturation)."""
    noise = hash_u32(seed)
    return noise.astype(jnp.float32) / _U32_MAX_F


def random_int_range(vmin: int, vmax: int, seed):
    """Random int in [min, max] (``cuda_noise.cuh:57-63``).  NB the reference
    converts the uint hash to *signed* int before the C-style ``%``, so
    negative results are possible; preserved here via ``lax.rem``."""
    base = hash_u32(seed).astype(jnp.int32)
    return jax.lax.rem(base, jnp.int32(1 + vmax - vmin)) + jnp.int32(vmin)


def random_grid(x, y, z, seed=0.0):
    """Random float in [-1, 1] for an integer grid coordinate
    (``cuda_noise.cuh:109-112``)."""
    s = (
        _f32(x) * 1723.0 + _f32(y) * 93241.0 + _f32(z) * 149812.0 + 3824.0 + _f32(seed)
    )
    return map_to_signed(random_float(f32_to_u32_sat(s)))


def random_int_grid(x, y, z, seed=0.0):
    """Random uint32 for a grid coordinate (``cuda_noise.cuh:115-118``).
    Arguments are floats, exactly like the reference signature."""
    s = _f32(x) * 1723.0 + _f32(y) * 93241.0 + _f32(z) * 149812.0 + 3824.0 + _f32(seed)
    return hash_u32(f32_to_u32_sat(s))


def vector_noise(x, y, z):
    """Random 3-vector from grid position (``cuda_noise.cuh:121-127``)."""
    vx = random_float(f32_to_u32_sat(_f32(x) * 8231.0 + _f32(y) * 34612.0 + _f32(z) * 11836.0 + 19283.0)) * 2.0 - 1.0
    vy = random_float(f32_to_u32_sat(_f32(x) * 1171.0 + _f32(y) * 9234.0 + _f32(z) * 992903.0 + 1466.0)) * 2.0 - 1.0
    vz = jnp.zeros_like(vx)
    return jnp.stack([vx, vy, vz], axis=-1)


def map_to_signed(x):
    """[0,1] -> [-1,1] (``cuda_noise.cuh:83-86``)."""
    return x * 2.0 - 1.0


def map_to_unsigned(x):
    """[-1,1] -> [0,1] (``cuda_noise.cuh:89-92``)."""
    return x * 0.5 + 0.5


def clamp(val, vmin=None, vmax=None):
    """Reference ``clamp`` — ignores min/max and clamps to [0, 1]
    (``cuda_noise.cuh:72-80``, preserved quirk)."""
    return jnp.clip(val, 0.0, 1.0)


# ---------------------------------------------------------------------------
# interpolation helpers (cuda_noise.cuh:160-204)
# ---------------------------------------------------------------------------


def lerp(a, b, ratio):
    """``a*(1-r) + b*r`` in the reference's exact form (``cuda_noise.cuh:161-164``)."""
    return a * (1.0 - ratio) + b * ratio


def cubic(p0, p1, p2, p3, x):
    """4-point 1D cubic interpolation (``cuda_noise.cuh:167-170``)."""
    return p1 + 0.5 * x * (
        p2 - p0 + x * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3 + x * (3.0 * (p1 - p2) + p3 - p0))
    )


def fade(t):
    """Perlin's 6t^5-15t^4+10t^3 fade (``cuda_noise.cuh:197-200``)."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


# grad() switch table (cuda_noise.cuh:173-195).  Entries 0xC-0xF are the
# reference's quirky duplicates: C:(x+y) D:(-y+z) E:(y-x) F:(-y-z) — i.e.
# they alias entries 0, 9, 1 and 11.  Implemented as pure elementwise
# arithmetic (sign bits + axis-pair select) rather than a table gather, so
# it fuses into the surrounding noise evaluation.
def grad(h, x, y, z):
    """Gradient dot product keyed by ``h & 0xF`` (``cuda_noise.cuh:173-195``)."""
    i = (jnp.asarray(h).astype(jnp.uint32) & 0xF).astype(jnp.int32)
    # remap the quirky duplicate entries onto their 0..11 aliases
    i = jnp.where(i == 12, 0, jnp.where(i == 13, 9, jnp.where(i == 14, 1, jnp.where(i == 15, 11, i))))
    b0 = (i & 1).astype(jnp.float32)
    b1 = ((i >> 1) & 1).astype(jnp.float32)
    g = i >> 2  # 0: (x,y)  1: (x,z)  2: (y,z)
    first = jnp.where(g == 2, y, x)
    second = jnp.where(g == 0, y, z)
    return (1.0 - 2.0 * b0) * first + (1.0 - 2.0 * b1) * second


# gradMap constant table for simplex noise (cuda_noise.cu:4-7): declared
# [16][3] with only 12 initializers; rows 12-15 are zero.
_GRAD_MAP = jnp.asarray(
    [
        [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
        [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
    ],
    jnp.float32,
)


# ---------------------------------------------------------------------------
# basis noises
# ---------------------------------------------------------------------------


def perlin_noise(pos, scale, seed):
    """Trilinear-faded 8-corner gradient noise (``cuda_noise.cuh:565-613``).

    ``pos`` is ``[..., 3]`` float32; ``scale`` scalar; ``seed`` int32/uint32
    scalar (converted to float32 exactly like the reference's
    ``float fseed = (float)seed``).
    """
    pos = _f32(pos)
    fseed = jnp.asarray(seed, jnp.int32).astype(jnp.float32)
    p = pos * _f32(scale)
    ix = jnp.floor(p[..., 0])
    iy = jnp.floor(p[..., 1])
    iz = jnp.floor(p[..., 2])
    x = p[..., 0] - ix
    y = p[..., 1] - iy
    z = p[..., 2] - iz
    u, v, w = fade(x), fade(y), fade(z)

    def corner(ox, oy, oz):
        h = random_int_grid(ix + ox, iy + oy, iz + oz, fseed)
        return grad(h, x - ox, y - oy, z - oz)

    i000 = corner(0.0, 0.0, 0.0)
    i100 = corner(1.0, 0.0, 0.0)
    i010 = corner(0.0, 1.0, 0.0)
    i110 = corner(1.0, 1.0, 0.0)
    i001 = corner(0.0, 0.0, 1.0)
    i101 = corner(1.0, 0.0, 1.0)
    i011 = corner(0.0, 1.0, 1.0)
    i111 = corner(1.0, 1.0, 1.0)

    x00 = lerp(i000, i100, u)
    x10 = lerp(i010, i110, u)
    x01 = lerp(i001, i101, u)
    x11 = lerp(i011, i111, u)
    y0 = lerp(x00, x10, v)
    y1 = lerp(x01, x11, v)
    return lerp(y0, y1, w)


def simplex_noise(pos, scale, seed):
    """3D simplex noise (``cuda_noise.cuh:225-317``)."""
    pos = _f32(pos)
    seed = jnp.asarray(seed, jnp.int32)
    xin = pos[..., 0] * _f32(scale)
    yin = pos[..., 1] * _f32(scale)
    zin = pos[..., 2] * _f32(scale)
    F3 = jnp.float32(1.0 / 3.0)
    G3 = jnp.float32(1.0 / 6.0)

    s = (xin + yin + zin) * F3
    i = jnp.floor(xin + s).astype(jnp.int32)
    j = jnp.floor(yin + s).astype(jnp.int32)
    k = jnp.floor(zin + s).astype(jnp.int32)
    t = (i + j + k).astype(jnp.float32) * G3
    x0 = xin - (i.astype(jnp.float32) - t)
    y0 = yin - (j.astype(jnp.float32) - t)
    z0 = zin - (k.astype(jnp.float32) - t)

    # Simplex corner selection (cuda_noise.cuh:253-266):
    #   x0>=y0: y0>=z0 -> (1,0,0),(1,1,0); x0>=z0 -> (1,0,0),(1,0,1); else (0,0,1),(1,0,1)
    #   x0< y0: y0<z0 -> (0,0,1),(0,1,1); x0<z0 -> (0,1,0),(0,1,1); else (0,1,0),(1,1,0)
    xy = x0 >= y0
    yz = y0 >= z0
    xz = x0 >= z0
    c1 = xy & yz
    c2 = xy & ~yz & xz
    c3 = xy & ~yz & ~xz
    c4 = ~xy & ~yz
    c5 = ~xy & yz & ~xz
    c6 = ~xy & yz & xz
    i1 = jnp.where(c1 | c2, 1, 0)
    j1 = jnp.where(c5 | c6, 1, 0)
    k1 = jnp.where(c3 | c4, 1, 0)
    i2 = jnp.where(c1 | c2 | c3 | c6, 1, 0)
    j2 = jnp.where(c1 | c4 | c5 | c6, 1, 0)
    k2 = jnp.where(c2 | c3 | c4 | c5, 1, 0)

    x1 = x0 - i1.astype(jnp.float32) + G3
    y1 = y0 - j1.astype(jnp.float32) + G3
    z1 = z0 - k1.astype(jnp.float32) + G3
    x2 = x0 - i2.astype(jnp.float32) + 2.0 * G3
    y2 = y0 - j2.astype(jnp.float32) + 2.0 * G3
    z2 = z0 - k2.astype(jnp.float32) + 2.0 * G3
    x3 = x0 - 1.0 + 3.0 * G3
    y3 = y0 - 1.0 + 3.0 * G3
    z3 = z0 - 1.0 + 3.0 * G3

    def perm12(p):
        return (hash_u32(p.astype(jnp.uint32)) % 12).astype(jnp.int32)

    gi0 = perm12(seed + i * 607495 + j * 359609 + k * 654846)
    gi1 = perm12(seed + (i + i1) * 607495 + (j + j1) * 359609 + (k + k1) * 654846)
    gi2 = perm12(seed + (i + i2) * 607495 + (j + j2) * 359609 + (k + k2) * 654846)
    gi3 = perm12(seed + (i + 1) * 607495 + (j + 1) * 359609 + (k + 1) * 654846)

    def contrib(gi, x, y, z):
        t = 0.6 - x * x - y * y - z * z
        g = _GRAD_MAP[gi]
        val = g[..., 0] * x + g[..., 1] * y + g[..., 2] * z
        t2 = t * t
        return jnp.where(t < 0.0, 0.0, t2 * t2 * val)

    n0 = contrib(gi0, x0, y0, z0)
    n1 = contrib(gi1, x1, y1, z1)
    n2 = contrib(gi2, x2, y2, z2)
    n3 = contrib(gi3, x3, y3, z3)
    return 32.0 * (n0 + n1 + n2 + n3)


def checker(pos, scale, seed):
    """Checker pattern (``cuda_noise.cuh:319-330``)."""
    pos = _f32(pos)
    ix = f32_to_i32_sat(pos[..., 0] * _f32(scale))
    iy = f32_to_i32_sat(pos[..., 1] * _f32(scale))
    iz = f32_to_i32_sat(pos[..., 2] * _f32(scale))
    return jnp.where(jax.lax.rem(ix + iy + iz, jnp.int32(2)) == 0, 1.0, -1.0).astype(
        jnp.float32
    )


def discrete_noise(pos, scale, seed):
    """Nearest-neighbor value noise (``cuda_noise.cuh:467-474``)."""
    pos = _f32(pos)
    ix = f32_to_i32_sat(pos[..., 0] * _f32(scale))
    iy = f32_to_i32_sat(pos[..., 1] * _f32(scale))
    iz = f32_to_i32_sat(pos[..., 2] * _f32(scale))
    return random_grid(ix, iy, iz, jnp.asarray(seed, jnp.int32))


def _value_corners(ix, iy, iz, fseed):
    a000 = random_grid(ix, iy, iz, fseed)
    a100 = random_grid(ix + 1, iy, iz, fseed)
    a010 = random_grid(ix, iy + 1, iz, fseed)
    a110 = random_grid(ix + 1, iy + 1, iz, fseed)
    a001 = random_grid(ix, iy, iz + 1, fseed)
    a101 = random_grid(ix + 1, iy, iz + 1, fseed)
    a011 = random_grid(ix, iy + 1, iz + 1, fseed)
    a111 = random_grid(ix + 1, iy + 1, iz + 1, fseed)
    return a000, a100, a010, a110, a001, a101, a011, a111


def linear_value(pos, scale, seed):
    """Trilinear value noise (``cuda_noise.cuh:477-507``).  NB the reference
    ignores ``scale`` here (quirk preserved)."""
    pos = _f32(pos)
    fseed = jnp.asarray(seed, jnp.int32).astype(jnp.float32)
    ix = f32_to_i32_sat(pos[..., 0]).astype(jnp.float32)
    iy = f32_to_i32_sat(pos[..., 1]).astype(jnp.float32)
    iz = f32_to_i32_sat(pos[..., 2]).astype(jnp.float32)
    u = pos[..., 0] - ix
    v = pos[..., 1] - iy
    w = pos[..., 2] - iz
    a000, a100, a010, a110, a001, a101, a011, a111 = _value_corners(ix, iy, iz, fseed)
    x00 = lerp(a000, a100, u)
    x10 = lerp(a010, a110, u)
    x01 = lerp(a001, a101, u)
    x11 = lerp(a011, a111, u)
    y0 = lerp(x00, x10, v)
    y1 = lerp(x01, x11, v)
    return lerp(y0, y1, w)


def faded_value(pos, scale, seed):
    """Faded value noise (``cuda_noise.cuh:510-541``)."""
    pos = _f32(pos)
    fseed = jnp.asarray(seed, jnp.int32).astype(jnp.float32)
    ix = f32_to_i32_sat(pos[..., 0] * _f32(scale)).astype(jnp.float32)
    iy = f32_to_i32_sat(pos[..., 1] * _f32(scale)).astype(jnp.float32)
    iz = f32_to_i32_sat(pos[..., 2] * _f32(scale)).astype(jnp.float32)
    u = fade(pos[..., 0] - ix)
    v = fade(pos[..., 1] - iy)
    w = fade(pos[..., 2] - iz)
    a000, a100, a010, a110, a001, a101, a011, a111 = _value_corners(ix, iy, iz, fseed)
    x00 = lerp(a000, a100, u)
    x10 = lerp(a010, a110, u)
    x01 = lerp(a001, a101, u)
    x11 = lerp(a011, a111, u)
    y0 = lerp(x00, x10, v)
    y1 = lerp(x01, x11, v)
    return lerp(y0, y1, w) / 2.0 * 1.0


def tricubic(x, y, z, u, v, w):
    """Tricubic interpolation of grid randoms (``cuda_noise.cuh:434-464``)."""
    def row(yy, zz):
        return cubic(
            random_grid(x - 1, yy, zz), random_grid(x, yy, zz),
            random_grid(x + 1, yy, zz), random_grid(x + 2, yy, zz), u,
        )

    ys = []
    for dz in (-1, 0, 1, 2):
        xs = [row(y + dy, z + dz) for dy in (-1, 0, 1, 2)]
        ys.append(cubic(xs[0], xs[1], xs[2], xs[3], v))
    return cubic(ys[0], ys[1], ys[2], ys[3], w)


def cubic_value(pos, scale, seed):
    """Tricubic value noise (``cuda_noise.cuh:544-563``)."""
    pos = _f32(pos) * _f32(scale)
    ix = f32_to_i32_sat(pos[..., 0])
    iy = f32_to_i32_sat(pos[..., 1])
    iz = f32_to_i32_sat(pos[..., 2])
    u = pos[..., 0] - ix.astype(jnp.float32)
    v = pos[..., 1] - iy.astype(jnp.float32)
    w = pos[..., 2] - iz.astype(jnp.float32)
    return tricubic(ix, iy, iz, u, v, w)


def _cell_decompose(pos, scale, seed):
    """Shared cell decomposition for worley/spots: integer cell + in-cell
    fractional coordinates + the seed as f32 (the feature-point scans
    themselves live in the callers)."""
    pos = _f32(pos)
    seed = jnp.asarray(seed, jnp.int32).astype(jnp.float32)
    ix = f32_to_i32_sat(pos[..., 0] * _f32(scale))
    iy = f32_to_i32_sat(pos[..., 1] * _f32(scale))
    iz = f32_to_i32_sat(pos[..., 2] * _f32(scale))
    u = pos[..., 0] - ix.astype(jnp.float32)
    v = pos[..., 1] - iy.astype(jnp.float32)
    w = pos[..., 2] - iz.astype(jnp.float32)
    return ix, iy, iz, u, v, w, seed


def worley_noise(pos, scale, seed, size, min_num: int, max_num: int, jitter):
    """Worley cellular noise (``cuda_noise.cuh:390-431``)."""
    if size < EPSILON:
        return jnp.zeros(jnp.asarray(pos).shape[:-1], jnp.float32)
    ix, iy, iz, u, v, w, fseed = _cell_decompose(pos, scale, seed)
    jitter = _f32(jitter)
    min_dist = jnp.full(u.shape, 1000000.0, jnp.float32)
    for x in (-1, 0, 1):
        for y in (-1, 0, 1):
            for z in (-1, 0, 1):
                fx = (ix + x).astype(jnp.float32)
                fy = (iy + y).astype(jnp.float32)
                fz = (iz + z).astype(jnp.float32)
                num = random_int_range(
                    min_num, max_num,
                    f32_to_i32_sat(fseed + fx * 823746.0 + fy * 12306.0 + fz * 67262.0),
                )
                for i in range(max_num):
                    du = u - x - (random_float(f32_to_u32_sat(fseed + fx * 23784.0 + fy * 9183.0 + fz * 23874.0 * i + 27432.0)) * jitter - jitter / 2.0)
                    dv = v - y - (random_float(f32_to_u32_sat(fseed + fx * 12743.0 + fy * 45191.0 + fz * 144421.0 * i + 76671.0)) * jitter - jitter / 2.0)
                    dw = w - z - (random_float(f32_to_u32_sat(fseed + fx * 82734.0 + fy * 900213.0 + fz * 443241.0 * i + 199823.0)) * jitter - jitter / 2.0)
                    d2 = du * du + dv * dv + dw * dw
                    min_dist = jnp.where((i < num) & (d2 < min_dist), d2, min_dist)
    return saturate(min_dist) * 2.0 - 1.0


def spots(pos, scale, seed, size, min_num: int, max_num: int, jitter, shape: Shape):
    """Random spots (``cuda_noise.cuh:332-388``)."""
    if size < EPSILON:
        return jnp.zeros(jnp.asarray(pos).shape[:-1], jnp.float32)
    ix, iy, iz, u, v, w, fseed = _cell_decompose(pos, scale, seed)
    jitter = _f32(jitter)
    size = _f32(size)
    val = jnp.full(u.shape, -1.0, jnp.float32)
    for x in (-1, 0, 1):
        for y in (-1, 0, 1):
            for z in (-1, 0, 1):
                fx = (ix + x).astype(jnp.float32)
                fy = (iy + y).astype(jnp.float32)
                fz = (iz + z).astype(jnp.float32)
                num = random_int_range(
                    min_num, max_num,
                    f32_to_i32_sat(fseed + fx * 823746.0 + fy * 12306.0 + fz * 823452.0 + 3234874.0),
                )
                for i in range(max_num):
                    du = u - x - (random_float(f32_to_u32_sat(fseed + fx * 23784.0 + fy * 9183.0 + fz * 23874.0 * i + 27432.0)) * jitter - jitter / 2.0)
                    dv = v - y - (random_float(f32_to_u32_sat(fseed + fx * 12743.0 + fy * 45191.0 + fz * 144421.0 * i + 76671.0)) * jitter - jitter / 2.0)
                    dw = w - z - (random_float(f32_to_u32_sat(fseed + fx * 82734.0 + fy * 900213.0 + fz * 443241.0 * i + 199823.0)) * jitter - jitter / 2.0)
                    d2 = du * du + dv * dv + dw * dw
                    if shape is Shape.STEP:
                        cand = jnp.where(d2 < size, 1.0, -1.0)
                    elif shape is Shape.LINEAR:
                        dabs = jnp.abs(du) + jnp.abs(dv) + jnp.abs(dw)
                        cand = 1.0 - clamp(dabs) / size
                    else:  # QUADRATIC
                        cand = 1.0 - clamp(d2) / size
                    val = jnp.where(i < num, jnp.maximum(val, cand), val)
    return val


# ---------------------------------------------------------------------------
# fBm repeaters (cuda_noise.cuh:615-797)
# ---------------------------------------------------------------------------


def repeater_perlin(pos, scale, seed, n: int, lacunarity, decay):
    """Perlin fBm (``cuda_noise.cuh:615-629``).  The engine's worldgen calls
    this with scale pre-applied and n=32 (``VoxelWorldBuilder.cu:6``).

    NB: the ``seed`` argument is unused — octave i uses seed
    ``(i + 38) * 27389482`` (reference quirk preserved).
    """
    pos = _f32(pos)

    def octave(carry, i):
        acc, scale, amp = carry
        seed = (i + 38) * jnp.int32(27389482)
        acc = acc + perlin_noise(pos * scale, 1.0, seed) * amp
        return (acc, scale * _f32(lacunarity), amp * _f32(decay)), None

    init = (jnp.zeros(pos.shape[:-1], jnp.float32), jnp.float32(scale), jnp.float32(1.0))
    (acc, _, _), _ = jax.lax.scan(octave, init, jnp.arange(n, dtype=jnp.int32))
    return acc


def repeater_perlin_bounded(pos, scale, seed, n: int, lacunarity, decay, threshold):
    """Bounded Perlin fBm (``cuda_noise.cuh:631-651``)."""
    pos = _f32(pos)
    seed = jnp.asarray(seed, jnp.int32)
    acc = jnp.ones(pos.shape[:-1], jnp.float32)
    dead = jnp.zeros(pos.shape[:-1], jnp.bool_)
    amp = jnp.float32(1.0)
    scale = jnp.float32(scale)
    for i in range(n):
        # _wrap_i32: (i+38)*27389482 exceeds INT32_MAX from i=41 (n >= 42)
        p = perlin_noise(pos * scale, 1.0, seed ^ jnp.int32(_wrap_i32((i + 38) * 27389482)))
        nxt = acc * (1.0 - saturate(0.5 + 0.5 * p) * amp)
        acc = jnp.where(dead, acc, nxt)
        dead = dead | (acc < threshold)
        scale = scale * _f32(lacunarity)
        amp = amp * _f32(decay)
    return jnp.where(dead, 0.0, acc)


def repeater_perlin_abs(pos, scale, seed, n: int, lacunarity, decay):
    """Absolute-value Perlin fBm (``cuda_noise.cuh:653-669``).  Same seed per
    octave (reference quirk)."""
    pos = _f32(pos)
    acc = jnp.zeros(pos.shape[:-1], jnp.float32)
    amp = jnp.float32(1.0)
    scale = jnp.float32(scale)
    for _ in range(n):
        acc = acc + jnp.abs(perlin_noise(pos * scale, 1.0, seed)) * amp
        scale = scale * _f32(lacunarity)
        amp = amp * _f32(decay)
    return map_to_signed(acc)


def repeater_simplex(pos, scale, seed, n: int, lacunarity, decay):
    """Simplex fBm (``cuda_noise.cuh:671-687``)."""
    pos = _f32(pos)
    seed = jnp.asarray(seed, jnp.int32)
    acc = jnp.zeros(pos.shape[:-1], jnp.float32)
    amp = jnp.float32(1.0)
    scale = jnp.float32(scale)
    for i in range(n):
        acc = acc + simplex_noise(pos, scale, seed) * amp * 0.35
        scale = scale * _f32(lacunarity)
        amp = amp * _f32(decay)
        seed = seed ^ jnp.int32(_wrap_i32((i + 672381) * 200394))
    return acc


def repeater_simplex_abs(pos, scale, seed, n: int, lacunarity, decay):
    """Absolute simplex fBm (``cuda_noise.cuh:689-705``)."""
    pos = _f32(pos)
    seed = jnp.asarray(seed, jnp.int32)
    acc = jnp.zeros(pos.shape[:-1], jnp.float32)
    amp = jnp.float32(1.0)
    scale = jnp.float32(scale)
    for i in range(n):
        acc = acc + jnp.abs(simplex_noise(pos, scale, seed)) * amp * 0.35
        scale = scale * _f32(lacunarity)
        amp = amp * _f32(decay)
        seed = seed ^ jnp.int32(_wrap_i32((i + 198273) * 928374))
    return map_to_signed(acc)


def repeater_simplex_bounded(pos, scale, seed, n: int, lacunarity, decay, threshold):
    """Bounded simplex fBm (``cuda_noise.cuh:707-727``)."""
    pos = _f32(pos)
    seed = jnp.asarray(seed, jnp.int32)
    acc = jnp.ones(pos.shape[:-1], jnp.float32)
    dead = jnp.zeros(pos.shape[:-1], jnp.bool_)
    amp = jnp.float32(1.0)
    scale = jnp.float32(scale)
    offs = jnp.asarray([32240.7922, 835622.882, 824.371968], jnp.float32)
    for i in range(n):
        sp = pos * scale + offs
        val = saturate(simplex_noise(sp, 1.0, seed) * 0.3 + 0.5) * amp
        nxt = acc - val
        acc = jnp.where(dead, acc, nxt)
        dead = dead | (acc < threshold)
        scale = scale * _f32(lacunarity)
        amp = amp * _f32(decay)
    return jnp.where(dead, 0.0, acc)


_BASIS_OFFSETS = {
    Basis.CHECKER: (53872.1923, 58334.4081, 9358.34667),
    Basis.DISCRETE: (7852.53114, 319739.059, 451336.504),
    Basis.LINEARVALUE: (940.748139, 10196.4500, 25650.9789),
    Basis.FADEDVALUE: (7683.26428, 2417.78195, 93889.4897),
    Basis.CUBICVALUE: (6546.80178, 14459.4682, 11616.5811),
    Basis.PERLIN: (1764.66931, 2593.55017, 4813.24412),
    Basis.SIMPLEX: (7442.93020, 8341.06698, 66848.7870),
    Basis.WORLEY: (7619.01285, 57209.0681, 1167.91397),
    Basis.SPOTS: (33836.4116, 2242.51045, 6720.07486),
}


def _basis_eval(basis: Basis, pos, scale, seed):
    if basis is Basis.CHECKER:
        return checker(pos, scale, seed)
    if basis is Basis.DISCRETE:
        return discrete_noise(pos, scale, seed)
    if basis is Basis.LINEARVALUE:
        return linear_value(pos, scale, seed)
    if basis is Basis.FADEDVALUE:
        return faded_value(pos, scale, seed)
    if basis is Basis.CUBICVALUE:
        return cubic_value(pos, scale, seed)
    if basis is Basis.PERLIN:
        return perlin_noise(pos, scale, seed)
    if basis is Basis.SIMPLEX:
        return simplex_noise(pos, scale, seed)
    if basis is Basis.WORLEY:
        return worley_noise(pos, scale, seed, 0.1, 4, 4, 1.0)
    if basis is Basis.SPOTS:
        return spots(pos, scale, seed, 0.1, 0, 4, 1.0, Shape.LINEAR)
    raise ValueError(basis)


def repeater(pos, scale, seed, n: int, lacunarity, decay, basis: Basis):
    """Generic fBm repeater (``cuda_noise.cuh:729-775``)."""
    pos = _f32(pos)
    acc = jnp.zeros(pos.shape[:-1], jnp.float32)
    amp = jnp.float32(1.0)
    scale = jnp.float32(scale)
    offs = jnp.asarray(_BASIS_OFFSETS[basis], jnp.float32)
    for _ in range(n):
        acc = acc + _basis_eval(basis, pos * scale + offs, 1.0, seed) * amp
        scale = scale * _f32(lacunarity)
        amp = amp * _f32(decay)
    return acc


def fractal_simplex(pos, scale, seed, du, n: int, lacunarity, decay):
    """Fractal simplex: stops when feature size < one pixel
    (``cuda_noise.cuh:777-797``).  ``scale``/``du`` must be python floats so
    the octave cutoff is static."""
    pos = _f32(pos)
    seed = jnp.asarray(seed, jnp.int32)
    acc = jnp.zeros(pos.shape[:-1], jnp.float32)
    amp = 1.0
    rdu = 1.0 / du
    offs = jnp.asarray([617.437379, 196410.219, 321280.627], jnp.float32)
    s = float(scale)
    for i in range(n):
        acc = acc + simplex_noise(pos * s + offs, 1.0, seed * jnp.int32(i + 1)) * amp
        s *= lacunarity
        amp *= decay
        if s > rdu:
            break
    return acc


_TURB_SEEDS = {
    Basis.CHECKER: (0x34FF8885, 0x2D03CBA3, 0x5A76FB1B),
    Basis.LINEARVALUE: (0x5527FDB8, 0x42AF1A2E, 0x1482EE8C),
    Basis.FADEDVALUE: (0x295590FC, 0x30731854, 0x73D2CA4C),
    Basis.CUBICVALUE: (0x663A1F09, 0x429BF56B, 0x37FA6FE9),
    Basis.PERLIN: (0x74827384, 0x10938478, 0x62723883),
    Basis.SIMPLEX: (0x47829472, 0x58273829, 0x10294647),
    Basis.WORLEY: (0x1D96F515, 0x4DF308F0, 0x2B79442A),
}


def turbulence(pos, scale_in, scale_out, seed, strength, in_basis: Basis, out_basis: Basis):
    """Two-pass turbulence (``cuda_noise.cuh:799-860``).  Like the reference,
    each component offset sees the previously-offset ``pos``."""
    pos = _f32(pos)
    seed = jnp.asarray(seed, jnp.int32)
    seeds = _TURB_SEEDS.get(in_basis)
    if seeds is not None:  # reference in-switch default: no offset
        sx, sy, sz = seeds

        def offset_basis(p, s):
            if in_basis is Basis.WORLEY:
                return worley_noise(p, scale_in, s, 1.0, 4, 4, 1.0)
            return _basis_eval(in_basis, p, scale_in, s)

        px = pos[..., 0] + offset_basis(pos, seed ^ jnp.int32(sx)) * strength
        pos = jnp.stack([px, pos[..., 1], pos[..., 2]], axis=-1)
        py = pos[..., 1] + offset_basis(pos, seed ^ jnp.int32(sy)) * strength
        pos = jnp.stack([pos[..., 0], py, pos[..., 2]], axis=-1)
        pz = pos[..., 2] + offset_basis(pos, seed ^ jnp.int32(sz)) * strength
        pos = jnp.stack([pos[..., 0], pos[..., 1], pz], axis=-1)

    # out pass (cuda_noise.cuh:842-859) — note SIMPLEX/WORLEY use scaleIn
    # in the reference (quirk preserved), and DISCRETE/SPOTS fall past the
    # switch to `return 0.0f`
    if out_basis is Basis.SIMPLEX:
        return simplex_noise(pos, scale_in, seed)
    if out_basis is Basis.WORLEY:
        return worley_noise(pos, scale_in, seed, 1.0, 4, 4, 1.0)
    if out_basis in (Basis.DISCRETE, Basis.SPOTS):
        return jnp.zeros(pos.shape[:-1], jnp.float32)
    return _basis_eval(out_basis, pos, scale_out, seed)


def repeater_turbulence(pos, scale_in, scale_out, seed, strength, n: int, basis_in: Basis, basis_out: Basis):
    """Repeater-based turbulence (``cuda_noise.cuh:862-869``)."""
    pos = _f32(pos)
    seed = jnp.asarray(seed, jnp.int32)
    px = pos[..., 0] + repeater(pos, scale_in, seed ^ jnp.int32(0x41728394), n, 2.0, 0.5, basis_in) * strength
    pos = jnp.stack([px, pos[..., 1], pos[..., 2]], axis=-1)
    py = pos[..., 1] + repeater(pos, scale_in, seed ^ jnp.int32(0x72837263), n, 2.0, 0.5, basis_in) * strength
    pos = jnp.stack([pos[..., 0], py, pos[..., 2]], axis=-1)
    pz = pos[..., 2] + repeater(pos, scale_in, seed ^ jnp.int32(0x26837363), n, 2.0, 0.5, basis_in) * strength
    pos = jnp.stack([pos[..., 0], pos[..., 1], pz], axis=-1)
    return repeater(pos, scale_out, seed ^ jnp.int32(0x3F821DAB), n, 2.0, 0.5, basis_out)
