"""Evaluated scene data records.

Python equivalents of the reference's managed data structs
(src/RayTraceVS.WPF/Models/Data/MaterialTypes.cs:10-34,
src/RayTraceVS.Interop/SceneData.h:31-212). These are the values that flow
out of node evaluation and into :mod:`raytracevs_tpu_torch.scene.flatten`, which
turns them into padded numpy tables (and, through ``to_device``, tensors).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np

from .transform import Transform


def _v3(x=0.0, y=0.0, z=0.0):
    return np.array([x, y, z], dtype=np.float64)


def _v4(x=0.0, y=0.0, z=0.0, w=0.0):
    return np.array([x, y, z, w], dtype=np.float64)


class LightType(enum.IntEnum):
    """Light kinds (Common.hlsli:16-18, Scene/Light.h:9-46)."""

    AMBIENT = 0
    POINT = 1
    DIRECTIONAL = 2


@dataclass
class MaterialData:
    """PBR/BSDF material (MaterialTypes.cs:10-34)."""

    base_color: np.ndarray = field(default_factory=lambda: _v4(0.8, 0.8, 0.8, 1.0))
    metallic: float = 0.0
    roughness: float = 0.5
    transmission: float = 0.0
    ior: float = 1.5
    emission: np.ndarray = field(default_factory=lambda: _v4())
    specular: float = 0.5
    absorption: np.ndarray = field(default_factory=lambda: _v3())

    @staticmethod
    def default() -> "MaterialData":
        return MaterialData()


@dataclass
class LightData:
    type: LightType = LightType.POINT
    position: np.ndarray = field(default_factory=_v3)
    direction: np.ndarray = field(default_factory=_v3)
    color: np.ndarray = field(default_factory=lambda: _v4(1, 1, 1, 1))
    intensity: float = 1.0
    attenuation: float = 0.0
    radius: float = 0.0
    soft_shadow_samples: float = 1.0


@dataclass
class CameraData:
    position: np.ndarray = field(default_factory=lambda: _v3(0, 2, -5))
    look_at: np.ndarray = field(default_factory=lambda: _v3(0, 1, 0))
    up: np.ndarray = field(default_factory=lambda: _v3(0, 1, 0))
    field_of_view: float = 60.0
    near: float = 0.1
    far: float = 1000.0
    aperture_size: float = 0.0
    focus_distance: float = 5.0


@dataclass
class SphereData:
    position: np.ndarray = field(default_factory=_v3)
    radius: float = 1.0
    material: MaterialData = field(default_factory=MaterialData)


@dataclass
class PlaneData:
    position: np.ndarray = field(default_factory=_v3)
    normal: np.ndarray = field(default_factory=lambda: _v3(0, 1, 0))
    material: MaterialData = field(default_factory=MaterialData)


@dataclass
class BoxData:
    center: np.ndarray = field(default_factory=_v3)
    size: np.ndarray = field(default_factory=lambda: _v3(0.5, 0.5, 0.5))  # half-extents
    axis_x: np.ndarray = field(default_factory=lambda: _v3(1, 0, 0))
    axis_y: np.ndarray = field(default_factory=lambda: _v3(0, 1, 0))
    axis_z: np.ndarray = field(default_factory=lambda: _v3(0, 0, 1))
    material: MaterialData = field(default_factory=MaterialData)


@dataclass
class MeshObjectData:
    """An FBX mesh instance (SceneData.h MeshInstanceData analog)."""

    mesh_name: str = ""
    transform: Transform = field(default_factory=Transform.identity)
    material: MaterialData = field(default_factory=MaterialData)


@dataclass
class RenderSettings:
    """Scene-carried render settings (SceneNode.cs:20-272, Scene/Scene.h:67-90)."""

    samples_per_pixel: int = 2
    max_bounces: int = 6
    trace_recursion_depth: int = 2
    exposure: float = 1.0
    tone_map_operator: int = 2
    denoiser_stabilization: float = 1.0
    shadow_strength: float = 1.0
    shadow_absorption_scale: float = 4.0
    enable_denoiser: bool = True
    gamma: float = 1.0
    light_attenuation_constant: float = 1.0
    light_attenuation_linear: float = 0.0
    light_attenuation_quadratic: float = 0.01
    max_shadow_lights: int = 2
    nrd_bypass_distance: float = 8.0
    nrd_bypass_blend_range: float = 2.0
    photon_debug_mode: int = 0
    photon_debug_scale: float = 1.0
    composite_debug_mode: int = 0
    # Caustics are present but disabled by default in the reference
    # (DXRPipeline.h:487 causticsEnabled = false)
    enable_caustics: bool = False


@dataclass
class SceneData:
    """Evaluated scene (SceneNode.cs Evaluate:467-516)."""

    camera: CameraData = field(default_factory=CameraData)
    objects: List[Any] = field(default_factory=list)  # Sphere/Plane/Box/MeshObjectData
    lights: List[LightData] = field(default_factory=list)
    settings: RenderSettings = field(default_factory=RenderSettings)

    @property
    def spheres(self) -> List[SphereData]:
        return [o for o in self.objects if isinstance(o, SphereData)]

    @property
    def planes(self) -> List[PlaneData]:
        return [o for o in self.objects if isinstance(o, PlaneData)]

    @property
    def boxes(self) -> List[BoxData]:
        return [o for o in self.objects if isinstance(o, BoxData)]

    @property
    def mesh_instances(self) -> List[MeshObjectData]:
        return [o for o in self.objects if isinstance(o, MeshObjectData)]
