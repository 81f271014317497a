"""Stateful Graphics facade — API parity with ``GPUDDA::Graphics``.

The reference exposes a small mutable-global surface (``Renderer.cuh:39-55``):
``SetEnvironment`` / ``SetFOV`` / ``SetOrthoWindowSize`` setters feeding
``__device__`` symbols, plus ``RenderScreen`` and ``GetDirections``.  This
engine is functional (state travels through
:class:`~voxelengine_tpu.config.RenderConfig` / ``Environment`` values), but
this facade mirrors the reference call-shape for drop-in familiarity:

    g = Graphics(width=1280, height=720)
    g.set_environment(light_direction, light_color, ambient_color)
    g.set_fov(90.0)
    fb = g.render_screen(raytracer, origin, euler)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from voxelengine_tpu.config import DebugView, Environment, Projection, RenderConfig
from voxelengine_tpu.engine.raytracer import VoxelRaytracer3D
from voxelengine_tpu.render.camera import get_directions  # re-export (Renderer.cu:27)
from voxelengine_tpu.render.frame import make_framebuffer, render_frame, to_bgra8

__all__ = ["Graphics", "get_directions"]


class Graphics:
    """Mutable render-state holder + per-frame dispatch (``Renderer.cu:278-328``)."""

    def __init__(self, width: int = 1280, height: int = 720, **cfg_kwargs):
        self._cfg = RenderConfig(width=width, height=height, **cfg_kwargs)
        self._env = Environment.default()
        self._fb = make_framebuffer(self._cfg)
        self._frame = 0
        self._ortho = None  # traced override; cfg.ortho_size stays static

    # -- setters (Renderer.cu:278-303) --------------------------------------

    def set_environment(self, light_direction, light_color, ambient_color) -> None:
        d = jnp.asarray(light_direction, jnp.float32)
        self._env = Environment(
            light_direction=d / jnp.linalg.norm(d),
            light_color=jnp.asarray(light_color, jnp.float32),
            ambient_color=jnp.asarray(ambient_color, jnp.float32),
        )

    def set_fov(self, fov_degrees: float) -> None:
        self._cfg = dataclasses.replace(self._cfg, fov_degrees=float(fov_degrees))

    def set_ortho_window_size(self, size: Tuple[float, float]) -> None:
        # traced render_frame argument, NOT a cfg replace: cfg is a static
        # jit arg, so baking the size in would recompile the whole frame
        # pipeline on every zoom tick (the scroll-wheel path)
        self._ortho = jnp.asarray([float(size[0]), float(size[1])], jnp.float32)

    def set_projection(self, projection: Projection) -> None:
        self._cfg = dataclasses.replace(self._cfg, projection=projection)

    def set_debug_view(self, view: DebugView) -> None:
        self._cfg = dataclasses.replace(self._cfg, debug_view=view)

    @property
    def config(self) -> RenderConfig:
        return self._cfg

    @property
    def environment(self) -> Environment:
        return self._env

    # -- per-frame dispatch (Renderer.cu:305-328) ---------------------------

    def render_screen(self, rt: VoxelRaytracer3D, origin, euler) -> jax.Array:
        """Render one frame into the persistent framebuffer and return it
        (RGB f32).  Increments the frame counter like ``hFrameInfo.FrameNumber++``
        (``Renderer.cu:322``)."""
        self._fb = render_frame(
            rt.world, self._fb, jnp.asarray(origin, jnp.float32),
            jnp.asarray(euler, jnp.float32), self._env,
            jnp.int32(self._frame), self._cfg, rt.fused_table,
            ortho_size=self._ortho,
        )
        self._frame += 1
        return self._fb

    def framebuffer_bgra8(self):
        """Packed BGRA bytes of the current framebuffer (display sink format)."""
        return to_bgra8(self._fb)
