"""Camera model.

Equivalent of the reference's camera math (``Renderer.cu:27-70``): Euler
pitch/yaw to a (forward, up, right) basis with the reference's sign
conventions (forward and up negated, ``Renderer.cu:39-41``), a perspective
pinhole ray generator (``Renderer.cu:44-59`` — including the reference's
3.1415 pi constant), and an orthographic variant (``Renderer.cu:61-70``).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

REF_PI = 3.1415  # Renderer.cu:50 uses this literal, not M_PI


def get_directions(euler_angles) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Euler angles (pitch, yaw, roll) -> (forward, up, right) basis
    (``Renderer.cu:27-42``)."""
    e = jnp.asarray(euler_angles, jnp.float32)
    pitch, yaw = e[..., 0], e[..., 1]
    fwd = jnp.stack(
        [
            jnp.cos(pitch) * jnp.sin(yaw),
            -jnp.sin(pitch),
            jnp.cos(pitch) * jnp.cos(yaw),
        ],
        axis=-1,
    )
    right = jnp.stack([jnp.cos(yaw), jnp.zeros_like(yaw), -jnp.sin(yaw)], axis=-1)
    up = jnp.cross(fwd, right)
    return -fwd, -up, right


def get_directions_np(euler_angles):
    """Host-numpy twin of :func:`get_directions` (same formulas, f32).

    Interactive input handling needs the camera basis every event; a
    device call costs a full host<->device round trip per keypress.
    Matches the jnp version to
    ~1 ULP (numpy vs XLA transcendentals; asserted in tests) — it feeds
    movement and crosshair input only, never the render rays."""
    import numpy as np

    e = np.asarray(euler_angles, np.float32)
    pitch, yaw = e[..., 0], e[..., 1]
    fwd = np.stack(
        [
            np.cos(pitch) * np.sin(yaw),
            -np.sin(pitch),
            np.cos(pitch) * np.cos(yaw),
        ],
        axis=-1,
    ).astype(np.float32)
    right = np.stack(
        [np.cos(yaw), np.zeros_like(yaw), -np.sin(yaw)], axis=-1
    ).astype(np.float32)
    up = np.cross(fwd, right).astype(np.float32)
    return -fwd, -up, right


def ray_direction(fwd, up, right, width: int, height: int, u, v, fov_degrees):
    """Perspective primary-ray direction for uv in [0,1]^2
    (``Renderer.cu:44-59``).  ``u``/``v`` broadcast; returns [..., 3]."""
    aspect = jnp.float32(width) / jnp.float32(height)
    ux = u * 2.0 - 1.0
    vy = v * 2.0 - 1.0
    fov = jnp.asarray(fov_degrees, jnp.float32) * jnp.float32(REF_PI) / 180.0
    scale_x = jnp.tan(fov / 2.0) * aspect
    scale_y = jnp.tan(fov / 2.0)
    d = (
        fwd
        + ux[..., None] * scale_x * right
        + vy[..., None] * scale_y * up
    )
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def ray_origin_ortho(fwd, up, right, width: int, height: int, u, v, origin, ortho_size):
    """Orthographic ray origin offset; direction is ``fwd``
    (``Renderer.cu:61-70``)."""
    ratio = jnp.float32(width) / jnp.float32(height)
    sx, sy = jnp.float32(ortho_size[0]), jnp.float32(ortho_size[1])
    o = (
        jnp.asarray(origin, jnp.float32)
        + right * ((u * 2.0 - 1.0) * sx * ratio)[..., None]
        + up * ((v * 2.0 - 1.0) * sy)[..., None]
    )
    return o
