"""raytracevs_tpu_torch: the PyTorch + CUDA port of raytracevs_tpu.

It renders scenes of analytic primitives (spheres, planes, OBBs) and
triangle meshes with the default frame: path tracing through the render
megakernel, photon-mapped caustics when a scene turns them on, the
REBLUR-style denoiser, composite and tone map. On a CUDA device (the
Engine's default) the frame runs through hand-written Hopper kernels
(csrc/); on the CPU through their plain PyTorch versions. The host BVH builder
(csrc/host/) is compiled by g++ at first use. It imports PyTorch and numpy,
never JAX.
"""
from .io.mesh_cache import CachedMesh, MeshCacheService
from .ops.bvh import BLASCache
from .runtime.engine import Engine
from .scene.data import (
    BoxData, CameraData, LightData, LightType, MaterialData, MeshObjectData,
    PlaneData, RenderSettings, SceneData, SphereData,
)
from .scene.flatten import FlatScene, RenderConfig, flatten_scene, make_config, to_device
from .scene.sanitize import sanitize_scene

__version__ = "0.1.0"
