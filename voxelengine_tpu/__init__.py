"""voxelengine_tpu — a realtime voxel raytracing framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the CUDA/SDL2
reference engine JoshuaLim007/VoxelEngine: two-level brickmap acceleration
structure (coarse indirection grid + bit-packed occupancy bricks with
per-brick tight AABBs), Amanatides-Woo DDA ray traversal, procedural
Perlin-fBm terrain generation, fused hit shading, checkerboard rendering,
debug views, a batch ray-query API and an interactive fly-camera app.

World state is a handful of flat device arrays (no pointer graphs); the
traversal is one DDA state machine, run per block of rays by a GPU kernel
and as a mask-predicated batch program by XLA elsewhere; the brickmap build
is pure XLA reductions (no host threads); and scale-out is pixel-space
sharding via ``shard_map`` over a ``jax.sharding.Mesh``.
"""

from voxelengine_tpu.config import Environment, RenderConfig
from voxelengine_tpu.core.bitgrid import BitGrid
from voxelengine_tpu.core.brickmap import BrickMap, build_brickmap
from voxelengine_tpu.engine.raytracer import RayTraceResults, VoxelRaytracer3D

__version__ = "0.1.0"

__all__ = [
    "BitGrid",
    "BrickMap",
    "build_brickmap",
    "Environment",
    "RenderConfig",
    "RayTraceResults",
    "VoxelRaytracer3D",
    "__version__",
]
