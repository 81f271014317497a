"""Runtime configuration for the engine.

The reference scatters its knobs across compile-time ``#define``s
(``SAMPLE_MODE_*`` ``VolumeRaytracer.cuh:17-18``, ``DEBUG_VIEW``/``ORTHO``
``Renderer.cuh:12-13``, ``ENABLE_CHECKERBOARD_RENDER`` ``Renderer.cu:5``,
``MAX_STEPS`` ``VolumeRaytracer.cuh:235``) plus a few runtime setters
(``SetEnvironment``/``SetFOV``/``SetOrthoWindowSize`` ``Renderer.cu:278-303``,
``SetFactor`` ``VolumeRaytracer.cuh:349``).  Here they are all runtime
dataclass fields; the static ones become jit-static arguments.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import jax
import jax.numpy as jnp

FLT_EPS_DDA = 1e-6  # VolumeRaytracer.cuh:20
MAX_STEPS = 2048  # VolumeRaytracer.cuh:235


class DebugView(enum.Enum):
    """Render modes.  ``DEBUG`` reproduces the reference's ``DEBUG_VIEW``
    quadrant diagnostic (``Renderer.cu:215-243,270-275``); ``SHADED`` is the
    production path (``Renderer.cu:244-252``)."""

    SHADED = 0
    DEBUG = 1
    NORMALS = 2
    DEPTH = 3
    STEPS = 4


class Projection(enum.Enum):
    PERSPECTIVE = 0  # Renderer.cu:44-59
    ORTHOGRAPHIC = 1  # Renderer.cu:61-70 (the reference's #define ORTHO)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Environment:
    """Lighting environment (``Renderer.cuh:33-37``)."""

    light_direction: jax.Array  # normalized, world space
    light_color: jax.Array
    ambient_color: jax.Array

    @staticmethod
    def default() -> "Environment":
        """The VoxelApp demo environment (``main.cu:58-63``)."""
        d = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)
        return Environment(
            light_direction=d / jnp.linalg.norm(d),
            light_color=jnp.asarray([2.0, 2.0, 2.0], jnp.float32),
            ambient_color=jnp.asarray([0.5, 0.5, 0.5], jnp.float32),
        )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static per-renderer configuration (jit-static)."""

    width: int = 1280  # main.cu:15
    height: int = 720  # main.cu:16
    fov_degrees: float = 90.0  # main.cu:64
    projection: Projection = Projection.PERSPECTIVE
    ortho_size: Tuple[float, float] = (10.0, 10.0)  # main.cu:65
    checkerboard: bool = True  # Renderer.cu:5
    debug_view: DebugView = DebugView.SHADED
    max_steps: int = MAX_STEPS
    # Optional shading features.  The reference has both code paths present
    # but disabled (shadow trace commented out Renderer.cu:102; AO samples=0
    # Renderer.cu:123); they default off for parity but are implemented.
    shadow_rays: bool = False
    ao_samples: int = 0
    # One-bounce mirror reflections (an extension beyond the reference —
    # its ToDo list wishes for indirect lighting, README.md:14-24, but
    # neither engine ships any): the reflected ray rides the same
    # traversal path as the primaries (incl. sharded/distributed renders
    # via shade_traced's ``secondary`` hook), its hit is shaded with the
    # same Blinn-ish model, and the result lerps into the surface color
    # by ``reflectivity`` before tonemapping.  Off by default for parity.
    reflections: bool = False
    reflectivity: float = 0.35
    crosshair: bool = True  # Renderer.cu:260-268
    debug_pos_mod: float = 128.0  # Renderer.cu:217-222
    # order primary rays as ~32x32-pixel blocks (render.frame.primary_rays)
    # instead of raster rows, so a traversal block's rays are screen
    # neighbours (faster on the GPU: PERF.md); results are identical
    tile_order: bool = True
