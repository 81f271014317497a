"""World checkpoint save/load tests."""

import numpy as np

from voxelengine_tpu.io.checkpoint import generate_or_load, load_world, save_world


def test_roundtrip(tmp_path, small_world):
    _, _, bm = small_world
    p = str(tmp_path / "w.npz")
    save_world(p, bm)
    bm2 = load_world(p)
    assert bm2.grid_dims == bm.grid_dims
    assert bm2.factor == bm.factor
    assert bm2.coarse_layout == bm.coarse_layout
    assert bm2.dense_slots == bm.dense_slots
    assert np.array_equal(np.asarray(bm2.meta), np.asarray(bm.meta))
    assert np.array_equal(np.asarray(bm2.brick_idx), np.asarray(bm.brick_idx))
    assert np.array_equal(np.asarray(bm2.bricks), np.asarray(bm.bricks))


def test_generate_or_load_caches(tmp_path, small_world):
    _, _, bm = small_world
    calls = []

    def gen():
        calls.append(1)
        return bm

    a = generate_or_load(str(tmp_path), "k", gen)
    b = generate_or_load(str(tmp_path), "k", gen)
    assert len(calls) == 1
    assert np.array_equal(np.asarray(a.meta), np.asarray(b.meta))


def test_orbax_roundtrip(tmp_path, small_world):
    """orbax backend round-trips a world identically to the npz path."""
    import pytest

    pytest.importorskip("orbax.checkpoint")
    from voxelengine_tpu.io.checkpoint import load_world_orbax, save_world_orbax

    _, _, bm = small_world
    save_world_orbax(str(tmp_path / "ckpt"), bm)
    bm2 = load_world_orbax(str(tmp_path / "ckpt"))
    assert np.array_equal(np.asarray(bm.meta), np.asarray(bm2.meta))
    assert np.array_equal(np.asarray(bm.bricks), np.asarray(bm2.bricks))
    assert np.array_equal(np.asarray(bm.brick_idx), np.asarray(bm2.brick_idx))
    assert bm2.grid_dims == bm.grid_dims and bm2.factor == bm.factor
    assert bm2.coarse_layout is bm.coarse_layout
    assert bm2.brick_layout is bm.brick_layout and bm2.dense_slots == bm.dense_slots


def test_generate_or_load_recovers_from_corrupt_cache(tmp_path, small_world):
    """A truncated .npz (kill mid-save) or a deleted .bricks.npy sidecar
    must trigger a rebuild, not a permanent load error."""
    import os

    from voxelengine_tpu.io.checkpoint import generate_or_load

    _, _, bm = small_world
    calls = []

    def gen():
        calls.append(1)
        return bm

    d = str(tmp_path)
    bm1 = generate_or_load(d, "w", gen)
    assert len(calls) == 1
    # corrupt the npz: existence alone must no longer be trusted
    with open(os.path.join(d, "w.npz"), "wb") as f:
        f.write(b"not a zip")
    bm2 = generate_or_load(d, "w", gen)
    assert len(calls) == 2
    assert np.array_equal(np.asarray(bm2.meta), np.asarray(bm1.meta))
    # delete the sidecar but keep the (now valid) npz
    os.remove(os.path.join(d, "w.npz.bricks.npy"))
    bm3 = generate_or_load(d, "w", gen)
    assert len(calls) == 3
    assert np.array_equal(np.asarray(bm3.bricks), np.asarray(bm1.bricks))


def test_world_cache_is_at_repo_root(tmp_path, monkeypatch):
    """The bench and apps cache worlds at <repo>/.world_cache whatever the
    working directory is."""
    import os

    from voxelengine_tpu.io import checkpoint

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(tmp_path)
    assert checkpoint.WORLD_CACHE == os.path.join(repo, ".world_cache")
    assert os.path.isabs(checkpoint.WORLD_CACHE)
