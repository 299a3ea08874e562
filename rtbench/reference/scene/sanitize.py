"""Input-domain sanitization at the engine boundary.

Replicates the NaN/Inf/range guards the reference applies when marshalling a
scene into the native engine (src/RayTraceVS.Interop/EngineWrapper.cpp:34-62
ClampFinite/SanitizeFinite; per-object rules at :140-235): positions clamped
to ±10000, base color to [0,1], metallic/roughness/transmission/specular to
[0,1], IOR to [1,4], absorption to [0,100], emission NaN->0, radius>0 else
0.01. Non-finite values fall back to per-field defaults rather than the
clamp bound.
"""
from __future__ import annotations

import math

import numpy as np

from .data import BoxData, CameraData, LightData, MaterialData, MeshObjectData, PlaneData, SceneData, SphereData


def _clamp_finite(value: float, lo: float, hi: float, fallback: float) -> float:
    v = float(value)
    if not math.isfinite(v):
        return fallback
    return min(hi, max(lo, v))


def _sanitize_finite(value: float, fallback: float) -> float:
    v = float(value)
    return v if math.isfinite(v) else fallback


def _vec_clamp(v, lo, hi, fallback) -> np.ndarray:
    return np.array([_clamp_finite(x, lo, hi, fallback) for x in np.asarray(v).ravel()])


def _vec_finite(v, fallback=0.0) -> np.ndarray:
    return np.array([_sanitize_finite(x, fallback) for x in np.asarray(v).ravel()])


def sanitize_material(m: MaterialData) -> MaterialData:
    color = np.asarray(m.base_color, dtype=np.float64).ravel()
    if color.size < 4:
        color = np.concatenate([color, np.ones(4 - color.size)])
    return MaterialData(
        base_color=np.array(
            [
                _clamp_finite(color[0], 0.0, 1.0, 0.8),
                _clamp_finite(color[1], 0.0, 1.0, 0.8),
                _clamp_finite(color[2], 0.0, 1.0, 0.8),
                _clamp_finite(color[3], 0.0, 1.0, 1.0),
            ]
        ),
        metallic=_clamp_finite(m.metallic, 0.0, 1.0, 0.0),
        roughness=_clamp_finite(m.roughness, 0.0, 1.0, 0.5),
        transmission=_clamp_finite(m.transmission, 0.0, 1.0, 0.0),
        ior=_clamp_finite(m.ior, 1.0, 4.0, 1.5),
        emission=_vec_finite(np.asarray(m.emission).ravel()[:4] if np.asarray(m.emission).size >= 4
                             else np.concatenate([np.asarray(m.emission).ravel(), [0.0]])),
        specular=_clamp_finite(m.specular, 0.0, 1.0, 0.5),
        absorption=_vec_clamp(m.absorption, 0.0, 100.0, 0.0),
    )


def _pos(v) -> np.ndarray:
    return _vec_clamp(v, -10000.0, 10000.0, 0.0)


def sanitize_scene(scene: SceneData) -> SceneData:
    out = SceneData(camera=sanitize_camera(scene.camera), settings=scene.settings)
    for obj in scene.objects:
        if isinstance(obj, SphereData):
            radius = obj.radius
            if not math.isfinite(float(radius)) or radius <= 0.0:
                radius = 0.01
            out.objects.append(
                SphereData(position=_pos(obj.position), radius=float(radius),
                           material=sanitize_material(obj.material))
            )
        elif isinstance(obj, PlaneData):
            n = _vec_finite(obj.normal)
            length = float(np.linalg.norm(n))
            n = n / length if length > 1e-6 else np.array([0.0, 1.0, 0.0])
            out.objects.append(
                PlaneData(position=_pos(obj.position), normal=n,
                          material=sanitize_material(obj.material))
            )
        elif isinstance(obj, BoxData):
            size = _vec_clamp(obj.size, 0.0001, 10000.0, 0.5)
            out.objects.append(
                BoxData(center=_pos(obj.center), size=size,
                        axis_x=_vec_finite(obj.axis_x), axis_y=_vec_finite(obj.axis_y),
                        axis_z=_vec_finite(obj.axis_z),
                        material=sanitize_material(obj.material))
            )
        elif isinstance(obj, MeshObjectData):
            out.objects.append(
                MeshObjectData(mesh_name=obj.mesh_name, transform=obj.transform,
                               material=sanitize_material(obj.material))
            )
    for light in scene.lights:
        out.lights.append(
            LightData(
                type=light.type,
                position=_pos(light.position),
                direction=_vec_finite(light.direction),
                color=_vec_clamp(light.color, 0.0, 1.0, 1.0),
                intensity=_clamp_finite(light.intensity, 0.0, 1000.0, 1.0),
                attenuation=_sanitize_finite(light.attenuation, 0.0),
                radius=_clamp_finite(light.radius, 0.0, 1000.0, 0.0),
                soft_shadow_samples=_clamp_finite(light.soft_shadow_samples, 1.0, 16.0, 1.0),
            )
        )
    return out


def sanitize_camera(cam: CameraData) -> CameraData:
    return CameraData(
        position=_pos(cam.position),
        look_at=_pos(cam.look_at),
        up=_vec_finite(cam.up, 0.0) if np.any(np.isfinite(np.asarray(cam.up, dtype=np.float64)))
        else np.array([0.0, 1.0, 0.0]),
        field_of_view=_clamp_finite(cam.field_of_view, 1.0, 179.0, 60.0),
        near=_clamp_finite(cam.near, 1e-4, 1e6, 0.1),
        far=_clamp_finite(cam.far, 1e-3, 1e7, 1000.0),
        aperture_size=_clamp_finite(cam.aperture_size, 0.0, 100.0, 0.0),
        focus_distance=_clamp_finite(cam.focus_distance, 0.01, 1e6, 5.0),
    )
