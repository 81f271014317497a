"""Full-resolution (1920x1080) byte-exactness of the block-cyclic
sharded render on the virtual 8-device CPU mesh.

Multi-device 1080p frames render through
``parallel.sharded.render_frame_cyclic``.  The CPU-mesh exactness tests
(`tests/test_parallel.py`) cover the same code path at reduced
resolutions (<=256x128) to keep the suite fast; this script closes the
remaining scale axis by running the EXACT production block geometry —
1920x540 pre-remap rows -> 32x30 blocks, 60x18 grid = 1080 blocks dealt
round-robin over 8 devices — and byte-comparing the reassembled
framebuffer against the single-device ``render_frame`` on both
checkerboard parities (even frames exercise the +2 cross-device halo
rows, `render/frame.py` checkerboard remap per Renderer.cu:189-213).

World: 512^3 terrain via the reference worldgen rule
(`worldgen/terrain.py`, VoxelGenerator.cu semantics; octave count
reduced for CPU build speed — exactness is octave-independent).

Run:  python experiments/verify_cyclic_1080p.py   (self-forces the
8-device CPU mesh; ~5-15 min on a many-core host)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    from voxelengine_tpu.config import Environment, RenderConfig
    from voxelengine_tpu.core.brickmap import build_brickmap_terrain
    from voxelengine_tpu.parallel.sharded import (
        cyclic_to_image,
        make_framebuffer_cyclic,
        make_mesh,
        render_frame_cyclic,
        replicate_world,
    )
    from voxelengine_tpu.render.frame import (
        block_geometry,
        make_framebuffer,
        render_frame,
    )

    assert len(jax.devices()) == 8, jax.devices()
    mesh = make_mesh()

    t0 = time.perf_counter()
    bm = build_brickmap_terrain((512, 512, 512), 32, octaves=8)
    jax.block_until_ready(bm.bricks)
    print(f"world 512^3 built in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)

    cfg = RenderConfig(width=1920, height=1080, checkerboard=True)
    bw, bh, nb = block_geometry(cfg)
    assert (bw, bh, nb) == (32, 30, 1080), (bw, bh, nb)
    print(f"block geometry: {bw}x{bh}, {nb} blocks over 8 devices "
          f"({nb // 8} each)", file=sys.stderr)

    env = Environment.default()
    origin = jnp.asarray([256.0, 300.0, 256.0], jnp.float32)
    euler = jnp.asarray([-0.5, 0.75, 0.0], jnp.float32)

    bmr = replicate_world(mesh, bm)
    fb = make_framebuffer_cyclic(cfg, mesh)
    ref = make_framebuffer(cfg)

    ok = True
    for i in range(2):
        t0 = time.perf_counter()
        ref = render_frame(bm, ref, origin, euler, env, jnp.int32(i), cfg)
        jax.block_until_ready(ref)
        t_ref = time.perf_counter() - t0

        t0 = time.perf_counter()
        fb = render_frame_cyclic(bmr, fb, origin, euler, env, jnp.int32(i),
                                 cfg, mesh)
        jax.block_until_ready(fb)
        t_cyc = time.perf_counter() - t0

        img = cyclic_to_image(fb, cfg)
        same = np.array_equal(img, np.asarray(ref))
        nz = float((np.asarray(ref).sum(-1) > 0).mean())
        print(f"frame {i}: single {t_ref:.1f} s, cyclic {t_cyc:.1f} s, "
              f"nonzero {nz:.3f}, byte-equal: {same}", file=sys.stderr)
        ok &= same

    assert len(fb.addressable_shards) == 8
    print({"check": "cyclic_1080p_byte_exact", "ok": bool(ok),
           "blocks": nb, "devices": 8})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
