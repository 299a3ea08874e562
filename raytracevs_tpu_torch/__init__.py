"""raytracevs_tpu_torch: the PyTorch + CUDA port of raytracevs_tpu.

It renders analytic scenes (spheres, planes, OBBs) with the default frame:
path tracing through the render megakernel, the REBLUR-style denoiser,
composite and tone map. On a CUDA device the frame runs through four
hand-written Hopper kernels (csrc/); on the CPU through their plain PyTorch
versions. It imports PyTorch and numpy, never JAX.
"""
from .runtime.engine import Engine
from .scene.data import (
    BoxData, CameraData, LightData, LightType, MaterialData, MeshObjectData,
    PlaneData, RenderSettings, SceneData, SphereData,
)
from .scene.flatten import FlatScene, RenderConfig, flatten_scene, make_config, to_device
from .scene.sanitize import sanitize_scene

__version__ = "0.1.0"
