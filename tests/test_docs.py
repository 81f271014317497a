"""Docs symbol audit: every framework symbol named in docs/MIGRATION.md,
ARCHITECTURE.md and README.md must exist with the documented shape.

Round-4 VERDICT found doc drift (the meta-word packing description in
MIGRATION.md §1 described an obsolete 10+10+10-bit layout); this test
pins the documented API surface to the code so future drift fails CI
instead of waiting for a reviewer.  The list below is curated from the
docs' backticked symbols (module, attribute) — update it when docs gain
or lose symbol references.
"""

import importlib

import pytest

# (module, [attributes]) — every dotted symbol the docs name.
DOCUMENTED = [
    ("voxelengine_tpu.core.bitgrid",
     ["BitGrid"]),
    ("voxelengine_tpu.core.layout",
     ["Layout", "sample_index", "position_from_sample_index"]),
    ("voxelengine_tpu.core.brickmap",
     ["BrickMap", "pack_meta", "unpack_meta", "build_brickmap",
      "build_brickmap_terrain", "build_brickmap_terrain_compact",
      "compact_brickmap", "apply_edits", "META_OCC_BIT"]),
    ("voxelengine_tpu.ops.aabb", ["ray_aabb"]),
    ("voxelengine_tpu.ops.trace",
     ["trace_grid", "trace_brickmap", "trace_brickmap_staged"]),
    ("voxelengine_tpu.ops.trace_kernel",
     ["trace_brickmap_kernel", "advance_kernel", "BLOCK"]),
    ("voxelengine_tpu.ops.traverse",
     ["trace_rays", "advance", "select_traversal"]),
    ("voxelengine_tpu.ops.dda2d", ["grid2d_from_dense"]),
    ("voxelengine_tpu.ops.crossing_trace",
     ["trace_ray_crossings", "format_crossings"]),
    ("voxelengine_tpu.ops.noise",
     ["Basis", "Shape", "repeater_perlin", "perlin_noise", "random_float"]),
    ("voxelengine_tpu.worldgen.terrain",
     ["terrain_density", "solid_at", "generate_world"]),
    ("voxelengine_tpu.engine.raytracer",
     ["VoxelRaytracer3D", "RayTraceResults"]),
    ("voxelengine_tpu.render.camera", ["get_directions", "get_directions_np"]),
    ("voxelengine_tpu.render.frame",
     ["render_frame", "make_framebuffer", "composite_frame", "primary_rays",
      "shade_traced", "to_bgra8", "render_frame_dense"]),
    ("voxelengine_tpu.render.shading", ["calculate_color", "tonemap", "reflect"]),
    ("voxelengine_tpu.render.graphics", ["Graphics"]),
    ("voxelengine_tpu.runtime.display", ["Renderer", "CallbackData"]),
    ("voxelengine_tpu.runtime.input", ["TtyInput", "ScriptedInput"]),
    ("voxelengine_tpu.io.checkpoint",
     ["generate_or_load", "save_world", "load_world", "WORLD_CACHE"]),
    ("voxelengine_tpu.parallel.sharded",
     ["render_frame_sharded", "render_frame_cyclic", "cyclic_to_image",
      "raytrace_sharded"]),
    ("voxelengine_tpu.parallel.distributed",
     ["shard_world_z", "trace_brickmap_zsharded", "render_frame_zsharded"]),
    ("voxelengine_tpu.utils.profiling", ["timed", "FrameTimer", "TraceStats"]),
    ("voxelengine_tpu.config",
     ["MAX_STEPS", "DebugView", "Projection", "Environment", "RenderConfig"]),
]


@pytest.mark.parametrize("module,attrs", DOCUMENTED,
                         ids=[m for m, _ in DOCUMENTED])
def test_documented_symbols_exist(module, attrs):
    mod = importlib.import_module(module)
    missing = [a for a in attrs if not hasattr(mod, a)]
    assert not missing, f"{module} lacks documented symbols: {missing}"


def test_documented_config_fields():
    """RenderConfig/Environment fields named in MIGRATION.md §3 and the
    README knob tables."""
    import dataclasses
    from voxelengine_tpu.config import Environment, RenderConfig

    cfg_fields = {f.name for f in dataclasses.fields(RenderConfig)}
    for name in ["width", "height", "checkerboard", "debug_view",
                 "projection", "shadow_rays", "ao_samples", "reflections",
                 "reflectivity", "crosshair", "max_steps", "fov_degrees",
                 "tile_order"]:
        assert name in cfg_fields, name
    env_fields = {f.name for f in dataclasses.fields(Environment)}
    assert {"light_direction", "light_color", "ambient_color"} <= env_fields


def test_documented_meta_word_layout():
    """MIGRATION.md §1: six 5-bit bound fields + occupancy at bit 30."""
    import jax.numpy as jnp
    import numpy as np
    from voxelengine_tpu.core.brickmap import (
        META_OCC_BIT, pack_meta, unpack_meta,
    )

    assert META_OCC_BIT == 30
    bmin = jnp.asarray([[3, 7, 31]])
    bmax = jnp.asarray([[31, 9, 4]])
    occ = jnp.asarray([True])
    m = pack_meta(occ, bmin, bmax)
    o2, mn2, mx2 = unpack_meta(m)
    assert bool(o2[0])
    assert np.array_equal(np.asarray(mn2), np.asarray(bmin))
    assert np.array_equal(np.asarray(mx2), np.asarray(bmax))


def test_documented_facade_surface():
    """MIGRATION.md §2-§4 facade methods exist with the documented names."""
    from voxelengine_tpu.engine.raytracer import VoxelRaytracer3D
    from voxelengine_tpu.render.graphics import Graphics
    from voxelengine_tpu.runtime.display import Renderer

    for name in ["upload_world", "upload_voxel_buffer",
                 "set_factor", "get_factor", "raytrace", "edit_voxels"]:
        assert hasattr(VoxelRaytracer3D, name), name
    for name in ["set_environment", "set_fov", "set_ortho_window_size",
                 "render_screen", "framebuffer_bgra8"]:
        assert hasattr(Graphics, name), name
    for name in ["init", "add_render_event_callback", "render", "close"]:
        assert hasattr(Renderer, name), name
