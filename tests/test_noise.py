"""Noise library tests (C13: cuda_noise.cuh).

Golden values in ``native/golden_noise.json`` come from an independent C++
implementation of the same documented semantics (``native/noise_golden.cpp``)
compiled with the system toolchain; the JAX port must match bit-exactly on
the integer path and to 0 ulp on fp32 where the op order is pinned.
"""

import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from voxelengine_tpu.ops import noise as N

NATIVE = os.path.join(os.path.dirname(__file__), "..", "native")


@pytest.fixture(scope="module")
def golden():
    path = os.path.join(NATIVE, "golden_noise.json")
    if not os.path.exists(path):
        subprocess.run(["make", "-s", "noise_golden"], cwd=NATIVE, check=True)
        with open(path, "w") as f:
            subprocess.run([os.path.join(NATIVE, "noise_golden")], stdout=f, check=True)
    return json.load(open(path))


HSEEDS = np.array([0, 1, 42, 0x71889283, 0xFFFFFFFF, 123456789], np.uint32)
COORDS = np.array(
    [[0.1, 0.2, 0.3], [1.5, 2.5, 3.5], [10, 20, 30], [0.005, 0, 0], [100.7, 3.3, 77.77]],
    np.float32,
)


def test_hash_bit_exact(golden):
    got = np.asarray(N.hash_u32(HSEEDS))
    assert np.array_equal(got, np.array(golden["hash"], np.uint32))


def test_random_float(golden):
    got = np.asarray(N.random_float(HSEEDS))
    assert np.array_equal(got, np.array(golden["random_float"], np.float32))


def test_perlin_bit_exact(golden):
    got = np.asarray(N.perlin_noise(jnp.asarray(COORDS), 1.0, 1040580316))
    assert np.array_equal(got, np.array(golden["perlin"], np.float32))


def test_repeater_perlin_bit_exact(golden):
    got = np.asarray(N.repeater_perlin(jnp.asarray(COORDS), 1.0, 0x71889283, 32, 2.0, 0.5))
    # XLA's CPU backend contracts one FMA in the scanned octave body, so
    # allow ~1 ulp against the golden C++ values
    assert np.allclose(got, np.array(golden["repeater_perlin"], np.float32), rtol=3e-6, atol=3e-7)


def test_repeater_perlin_ignores_seed():
    """Preserved reference quirk: octave seeds don't involve the seed arg
    (cuda_noise.cuh:615-629)."""
    a = np.asarray(N.repeater_perlin(jnp.asarray(COORDS), 1.0, 1, 4, 2.0, 0.5))
    b = np.asarray(N.repeater_perlin(jnp.asarray(COORDS), 1.0, 999, 4, 2.0, 0.5))
    assert np.array_equal(a, b)


def test_terrain_bit_exact(golden):
    from voxelengine_tpu.worldgen.terrain import terrain_density

    z, y, x = np.meshgrid(np.arange(4) * 37, np.arange(4) * 37, np.arange(4) * 37, indexing="ij")
    t = np.asarray(terrain_density(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    # see test_repeater_perlin_bit_exact: ~1 ulp CPU FMA slack
    assert np.allclose(t.reshape(-1), np.array(golden["terrain_t"], np.float32), rtol=3e-6, atol=1e-4)


def test_conversion_saturation():
    vals = jnp.asarray([-5.0, 0.0, 1.9, 4.5e9, np.nan, 2147483000.0], jnp.float32)
    u = np.asarray(N.f32_to_u32_sat(vals))
    assert u[0] == 0 and u[1] == 0 and u[2] == 1 and u[3] == 0xFFFFFFFF and u[4] == 0
    i = np.asarray(N.f32_to_i32_sat(vals))
    # positive overflow saturates to INT_MAX exactly (cvt.rzi.s32.f32), not
    # to the largest f32 below 2^31
    assert i[0] == -5 and i[2] == 1 and i[3] == 2147483647 and i[4] == 0
    assert i[5] == 2147483008  # f32 rounds 2147483000 up; below 2^31, no sat
    # u32 overflow branch: float32(2^32-1) rounds to 2^32, must still pin
    big = np.asarray(N.f32_to_u32_sat(jnp.float32(4294967040.0)))
    assert big == 4294967040


def test_other_basis_noises_run_and_bounded():
    pos = jnp.asarray(COORDS)
    for fn in (
        lambda: N.simplex_noise(pos, 1.3, 7),
        lambda: N.checker(pos, 2.0, 0),
        lambda: N.discrete_noise(pos, 1.0, 3),
        lambda: N.linear_value(pos, 1.0, 3),
        lambda: N.faded_value(pos, 1.0, 3),
        lambda: N.cubic_value(pos, 1.0, 3),
        lambda: N.worley_noise(pos, 1.0, 3, 0.5, 2, 4, 1.0),
        lambda: N.spots(pos, 1.0, 3, 0.1, 0, 4, 1.0, N.Shape.LINEAR),
        lambda: N.repeater_perlin_abs(pos, 1.0, 3, 4, 2.0, 0.5),
        lambda: N.repeater_simplex(pos, 1.0, 3, 4, 2.0, 0.5),
        lambda: N.repeater_simplex_abs(pos, 1.0, 3, 4, 2.0, 0.5),
        lambda: N.repeater_perlin_bounded(pos, 1.0, 3, 4, 2.0, 0.5, 0.1),
        lambda: N.repeater_simplex_bounded(pos, 1.0, 3, 4, 2.0, 0.5, 0.1),
        lambda: N.repeater(pos, 1.0, 3, 3, 2.0, 0.5, N.Basis.PERLIN),
        lambda: N.fractal_simplex(pos, 1.0, 3, 0.01, 5, 2.0, 0.5),
        lambda: N.turbulence(pos, 1.0, 1.0, 3, 0.3, N.Basis.PERLIN, N.Basis.SIMPLEX),
        lambda: N.repeater_turbulence(pos, 1.0, 1.0, 3, 0.3, 2, N.Basis.PERLIN, N.Basis.PERLIN),
    ):
        v = np.asarray(fn())
        assert v.shape == (5,)
        assert np.isfinite(v).all()
        assert (np.abs(v) < 100).all()


def test_grad_quirk_table():
    """grad() entries 0xC-0xF reproduce the reference's duplicates
    (cuda_noise.cuh:186-191): C==x+y, D==-y+z, E==y-x, F==-y-z."""
    x, y, z = 2.0, 3.0, 5.0
    vals = np.asarray(N.grad(jnp.arange(16, dtype=jnp.uint32), x, y, z))
    assert vals[0xC] == x + y
    assert vals[0xD] == -y + z
    assert vals[0xE] == y - x
    assert vals[0xF] == -y - z


def test_turbulence_unhandled_bases_match_reference_switch():
    """DISCRETE/SPOTS are absent from the reference turbulence switches
    (cuda_noise.cuh:799-860): in-basis applies no offset, out-basis returns
    0.0 — the port must not crash or invent behavior."""
    pos = jnp.asarray(COORDS)
    # in_basis unhandled -> no offset -> equals out pass on raw pos
    got = N.turbulence(pos, 1.0, 2.0, 7, 0.5, N.Basis.DISCRETE, N.Basis.PERLIN)
    want = N.perlin_noise(pos, 2.0, 7)
    assert np.allclose(np.asarray(got), np.asarray(want))
    # out_basis unhandled -> 0.0
    got0 = N.turbulence(pos, 1.0, 2.0, 7, 0.5, N.Basis.PERLIN, N.Basis.SPOTS)
    assert (np.asarray(got0) == 0.0).all()


def test_repeater_perlin_bounded_high_octaves_wraps():
    """(i+38)*27389482 exceeds INT32_MAX from i=41: the per-octave seed must
    wrap like C int arithmetic instead of raising on the int32 conversion."""
    pos = jnp.asarray(COORDS)
    out = np.asarray(N.repeater_perlin_bounded(pos, 1.0, 3, 44, 2.0, 0.5, 0.1))
    assert np.isfinite(out).all()
