"""World checkpointing: save/load packed brickmap worlds.

The reference has no persistence — the 3D world is regenerated from a
hard-coded seed every run (``VoxelWorldBuilder.cu:6``), and the 2D prototype
loads a text fixture (``DDATestCpp.cpp:302-314``).  Determinism-as-checkpoint
works, but a 32-octave fBm over 8k x 512 x 8k is a long build, so the engine
adds explicit save/load of the three flat arrays (npz with metadata).
``generate_or_load`` is the cached-worldgen entry the bench and apps use;
:data:`WORLD_CACHE` is its directory, fixed at the repository root.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np

from voxelengine_tpu.core.brickmap import BrickMap
from voxelengine_tpu.core.layout import Layout

FORMAT_VERSION = 1

#: where the bench and the apps cache built worlds: ``<repo>/.world_cache``,
#: whatever the working directory
WORLD_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".world_cache",
)


def _world_paths(path: str):
    """Canonical (npz, bricks sidecar) paths for a world checkpoint —
    callers may pass the base name or the .npz name interchangeably."""
    npz = path if path.endswith(".npz") else path + ".npz"
    return npz, npz + ".bricks.npy"


def save_world(path: str, bm: BrickMap) -> None:
    """Serialize a brickmap world: small tables compressed in the .npz,
    the multi-GB brick words raw in a ``.bricks.npy`` sidecar —
    zlib-decompressing ~2 GB costs >10 s of the warm start, while a raw
    .npy mmap-loads in the host->device transfer time."""
    path, sidecar = _world_paths(path)
    # atomic writes (tmp + os.replace), sidecar FIRST and npz LAST: a kill
    # mid-save must never leave an .npz that load_world will trust forever
    # (the .npz is the cache-validity marker checked by generate_or_load)
    np.save(sidecar + ".tmp.npy", np.asarray(bm.bricks))
    os.replace(sidecar + ".tmp.npy", sidecar)
    np.savez_compressed(
        path + ".tmp.npz",
        version=FORMAT_VERSION,
        meta=np.asarray(bm.meta),
        brick_idx=np.asarray(bm.brick_idx),
        grid_dims=np.asarray(bm.grid_dims),
        factor=bm.factor,
        coarse_layout=bm.coarse_layout.value,
        brick_layout=bm.brick_layout.value,
        dense_slots=bm.dense_slots,
    )
    os.replace(path + ".tmp.npz", path)


def load_world(path: str) -> BrickMap:
    """Load a brickmap world saved by :func:`save_world` onto device.
    Accepts both the split raw-bricks form and the round-2 all-in-npz."""
    path, sidecar = _world_paths(path)
    z = np.load(path)
    assert int(z["version"]) == FORMAT_VERSION, "unknown world format"
    if "bricks" in z.files:
        bricks = z["bricks"]
    else:
        bricks = np.load(sidecar, mmap_mode="r")
    return BrickMap(
        meta=jnp.asarray(z["meta"]),
        brick_idx=jnp.asarray(z["brick_idx"]),
        bricks=jnp.asarray(bricks),
        grid_dims=tuple(int(v) for v in z["grid_dims"]),
        factor=int(z["factor"]),
        coarse_layout=Layout(int(z["coarse_layout"])),
        brick_layout=Layout(int(z["brick_layout"])),
        dense_slots=bool(z["dense_slots"]),
    )


def generate_or_load(
    cache_dir: str,
    key: str,
    generate_fn,
) -> BrickMap:
    """Load ``{cache_dir}/{key}.npz`` if present, else build via
    ``generate_fn()`` and save it."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        try:
            return load_world(path)
        except Exception as e:  # truncated npz / deleted sidecar: rebuild
            print(
                f"world cache {path} unreadable ({type(e).__name__}: {e}); "
                "rebuilding",
                file=sys.stderr,
                flush=True,
            )
    bm = generate_fn()
    save_world(path, bm)
    return bm


def _bm_meta(bm: BrickMap) -> dict:
    return dict(
        version=FORMAT_VERSION,
        grid_dims=list(bm.grid_dims),
        factor=bm.factor,
        coarse_layout=bm.coarse_layout.value,
        brick_layout=bm.brick_layout.value,
        dense_slots=bm.dense_slots,
    )


def save_world_orbax(path: str, bm: BrickMap) -> None:
    """Serialize a world through orbax-checkpoint (the idiomatic JAX
    checkpoint stack: async-capable, atomic, sharding-aware — the right
    backend once worlds are sharded across a mesh).  ``path`` becomes a
    checkpoint directory."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    state = dict(
        meta=bm.meta, brick_idx=bm.brick_idx, bricks=bm.bricks,
        _meta=_bm_meta(bm),
    )
    ckptr.save(os.path.abspath(path), state, force=True)
    ckptr.wait_until_finished()


def load_world_orbax(path: str) -> BrickMap:
    """Load a world saved by :func:`save_world_orbax`."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    state = ckptr.restore(os.path.abspath(path))
    m = state["_meta"]
    assert int(m["version"]) == FORMAT_VERSION, "unknown world format"
    return BrickMap(
        meta=jnp.asarray(state["meta"]),
        brick_idx=jnp.asarray(state["brick_idx"]),
        bricks=jnp.asarray(state["bricks"]),
        grid_dims=tuple(int(v) for v in m["grid_dims"]),
        factor=int(m["factor"]),
        coarse_layout=Layout(int(m["coarse_layout"])),
        brick_layout=Layout(int(m["brick_layout"])),
        dense_slots=bool(m["dense_slots"]),
    )
