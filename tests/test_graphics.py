"""Graphics facade tests (API parity with GPUDDA::Graphics)."""

import jax.numpy as jnp
import numpy as np

from voxelengine_tpu import VoxelRaytracer3D
from voxelengine_tpu.config import DebugView, Projection
from voxelengine_tpu.core.bitgrid import BitGrid
from voxelengine_tpu.render.graphics import Graphics, get_directions


def test_graphics_facade(small_world):
    _, grid, _ = small_world
    rt = VoxelRaytracer3D()
    rt.upload_voxel_buffer(grid, 8)

    g = Graphics(width=48, height=32, checkerboard=False)
    g.set_environment([1.0, 1.0, 1.0], [2.0, 2.0, 2.0], [0.5, 0.5, 0.5])
    g.set_fov(75.0)
    assert g.config.fov_degrees == 75.0
    g.set_ortho_window_size((5.0, 5.0))
    g.set_debug_view(DebugView.SHADED)

    fb1 = g.render_screen(rt, [16.0, 20.0, 16.0], [-0.8, 0.4, 0.0])
    fb2 = g.render_screen(rt, [16.0, 20.0, 16.0], [-0.8, 0.4, 0.0])
    assert fb1.shape == (32, 48, 3)
    assert np.isfinite(np.asarray(fb2)).all()
    assert g.framebuffer_bgra8().shape == (32, 48, 4)

    g.set_projection(Projection.ORTHOGRAPHIC)
    fb3 = g.render_screen(rt, [16.0, 20.0, 16.0], [-0.8, 0.4, 0.0])
    assert np.isfinite(np.asarray(fb3)).all()


def test_get_directions_reexport():
    import jax.numpy as jnp

    fwd, up, right = get_directions(jnp.zeros(3))
    assert np.allclose(np.asarray(fwd), [0, 0, -1], atol=1e-6)


def test_graphics_ortho_zoom_is_traced(small_world):
    """set_ortho_window_size must not bake into the static cfg (per-zoom
    recompile); it rides the traced ortho_size argument and changes output."""
    _, grid, _ = small_world
    rt = VoxelRaytracer3D()
    rt.upload_voxel_buffer(grid, 8)
    g = Graphics(width=32, height=16, checkerboard=False)
    g.set_projection(Projection.ORTHOGRAPHIC)
    base_cfg = g.config
    fb1 = np.asarray(g.render_screen(rt, [16.0, 40.0, 16.0], [-1.2, 0.0, 0.0]))
    g.set_ortho_window_size((3.0, 3.0))
    fb2 = np.asarray(g.render_screen(rt, [16.0, 40.0, 16.0], [-1.2, 0.0, 0.0]))
    assert g.config is base_cfg  # static cfg untouched -> no recompile
    assert not np.array_equal(fb1, fb2)  # zoom actually applied


def test_graphics_facade_uses_line_table(small_world, kernel_traversal):
    """render_screen must trace through the platform's traversal (here the
    GPU kernel, interpret mode) like render_frame does (regression: the
    facade once silently bypassed the flagship traversal)."""
    from voxelengine_tpu.render.frame import make_framebuffer, render_frame

    _, grid, _ = small_world
    rt = VoxelRaytracer3D()
    rt.upload_voxel_buffer(grid, 8)
    g = Graphics(width=16, height=8, checkerboard=False)
    fb = np.asarray(g.render_screen(rt, [16.0, 20.0, 16.0], [-0.8, 0.4, 0.0]))
    assert kernel_traversal.calls > 0

    ref = render_frame(
        rt.world, make_framebuffer(g.config),
        jnp.asarray([16.0, 20.0, 16.0]), jnp.asarray([-0.8, 0.4, 0.0]),
        g.environment, jnp.int32(0), g.config,
    )
    assert np.array_equal(fb, np.asarray(ref))
