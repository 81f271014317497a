"""Render a full-resolution demo frame from a cached world to a PNG.

Usage: python experiments/render_demo.py [full|huge] [out.png]

Composites BOTH checkerboard fields (frames 0 and 1) into a complete
1080p image — what the reference's interlaced presentation shows after
two frames (`Renderer.cu:186-194`).  The world is built on first use into
the repository's world cache and loaded from there afterwards.

Env knobs (mirroring bench.py): DEMO_SHADOWS=1 adds shadow rays,
DEMO_AO=N adds N hemisphere AO samples — the working version of the
reference's disabled scaffolding (`Renderer.cu:102,120-165`) — and
DEMO_REFLECT=1 adds one-bounce mirror reflections; the default output
name gains a `_shadows_aoN_refl` suffix.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxelengine_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

from voxelengine_tpu.config import Environment, RenderConfig
from voxelengine_tpu.core.brickmap import build_brickmap_terrain_compact
from voxelengine_tpu.io.checkpoint import WORLD_CACHE, generate_or_load
from voxelengine_tpu.render.frame import make_framebuffer, render_frame


def main():
    world = sys.argv[1] if len(sys.argv) > 1 else "full"
    dims = {"full": (8192, 512, 8192), "huge": (16384, 512, 16384)}[world]
    shadows = os.environ.get("DEMO_SHADOWS", "0") == "1"
    ao = int(os.environ.get("DEMO_AO", "0"))
    refl = os.environ.get("DEMO_REFLECT", "0") == "1"
    suffix = (("_shadows" if shadows else "") + (f"_ao{ao}" if ao else "")
              + ("_refl" if refl else ""))
    out = sys.argv[2] if len(sys.argv) > 2 else (
        f"docs/demo_{'16k' if world == 'huge' else '8k'}_terrain_1080p"
        f"{suffix}.png")
    print(f"devices: {jax.devices()}", flush=True)

    key = f"terrain_{dims[0]}x{dims[1]}x{dims[2]}_f32_o32_v1"
    t0 = time.perf_counter()
    bm = generate_or_load(WORLD_CACHE, key,
                          lambda: build_brickmap_terrain_compact(dims, 32))
    bm.bricks.block_until_ready()
    print(f"world: {time.perf_counter()-t0:.1f}s", flush=True)

    cfg = RenderConfig(width=1920, height=1080, checkerboard=True,
                       tile_order=True, shadow_rays=shadows, ao_samples=ao,
                       reflections=refl)
    env = Environment.default()
    origin = jnp.asarray([dims[0] / 2, 380.0, dims[2] / 2], jnp.float32)
    euler = jnp.asarray([-0.25, 0.75, 0.0], jnp.float32)

    fb = make_framebuffer(cfg)
    t0 = time.perf_counter()
    for i in range(2):  # both checkerboard fields -> complete image
        fb = render_frame(bm, fb, origin, euler, env, jnp.int32(i), cfg)
    fb.block_until_ready()
    print(f"two fields: {time.perf_counter()-t0:.1f}s", flush=True)

    from voxelengine_tpu.runtime.display import _encode_png

    rgb = np.asarray((jnp.clip(fb, 0.0, 1.0) * 255.0).astype(jnp.uint8))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        f.write(_encode_png(rgb))
    print(f"wrote {out} ({os.path.getsize(out)/1e6:.2f} MB)", flush=True)


if __name__ == "__main__":
    main()
