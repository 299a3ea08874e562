"""The 22 built-in node types.

Behavioral re-implementations of src/RayTraceVS.WPF/Models/Nodes/*.cs with
the same socket names, default values, clamping rules and polymorphic math
semantics, so `.rtvs` files evaluate to identical scenes.

Copied from raytracevs_tpu/scene/nodes.py (numpy only).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from .data import (
    BoxData,
    CameraData,
    LightData,
    LightType,
    MaterialData,
    MeshObjectData,
    PlaneData,
    RenderSettings,
    SceneData,
    SphereData,
)
from .graph import Node, SocketType
from .transform import Transform, obb_axes_from_quat, rotate_vector

_MESH_RESOLVER = None


def set_mesh_resolver(resolver) -> None:
    """Install a callable(name) -> mesh-or-None used by FBXMeshNode.

    Plays the role of App.MeshCacheService (FBXMeshNode.cs:116).
    """
    global _MESH_RESOLVER
    _MESH_RESOLVER = resolver


def _as_float(v, default=0.0) -> float:
    if isinstance(v, (int, float, np.floating, np.integer)):
        return float(v)
    if isinstance(v, np.ndarray) and v.size >= 1:
        return float(v.flat[0])  # Vector3 -> X component (AddNode.cs:34)
    return default


def _as_vec(v, n, default):
    if isinstance(v, np.ndarray):
        out = np.zeros(n)
        k = min(n, v.size)
        out[:k] = np.asarray(v, dtype=np.float64).ravel()[:k]
        if n == 4 and v.size < 4:
            out[3] = 1.0
        return out
    if isinstance(v, (int, float, np.floating, np.integer)):
        return np.full(n, float(v))
    return np.asarray(default, dtype=np.float64).copy()


def _is_vec3(v) -> bool:
    return isinstance(v, np.ndarray) and v.shape == (3,)


# ---------------------------------------------------------------------------
# Math nodes
# ---------------------------------------------------------------------------
class FloatNode(Node):
    type_name = "FloatNode"
    category = "Math"

    def __init__(self, value: float = 0.0):
        super().__init__("Float")
        self.value = float(value)
        self.add_input("Value", SocketType.FLOAT)
        self.add_output("Value", SocketType.FLOAT)

    def evaluate(self, input_values):
        v = self.get_input_value("Value", input_values)
        if v is not None:
            self.value = _as_float(v, self.value)
        return float(self.value)


class Vector3Node(Node):
    type_name = "Vector3Node"
    category = "Math"

    def __init__(self, x=0.0, y=0.0, z=0.0):
        super().__init__("Vector3")
        self.x, self.y, self.z = float(x), float(y), float(z)
        for n in ("X", "Y", "Z"):
            self.add_input(n, SocketType.FLOAT)
        self.add_output("Vector", SocketType.VECTOR3)

    def evaluate(self, input_values):
        for attr, name in (("x", "X"), ("y", "Y"), ("z", "Z")):
            v = self.get_input_value(name, input_values)
            if v is not None:
                setattr(self, attr, _as_float(v, getattr(self, attr)))
        return np.array([self.x, self.y, self.z])


class Vector4Node(Node):
    type_name = "Vector4Node"
    category = "Math"

    def __init__(self, x=0.0, y=0.0, z=0.0, w=0.0):
        super().__init__("Vector4")
        self.x, self.y, self.z, self.w = float(x), float(y), float(z), float(w)
        for n in ("X", "Y", "Z", "W"):
            self.add_input(n, SocketType.FLOAT)
        self.add_output("Vector", SocketType.COLOR)

    def evaluate(self, input_values):
        for attr, name in (("x", "X"), ("y", "Y"), ("z", "Z"), ("w", "W")):
            v = self.get_input_value(name, input_values)
            if v is not None:
                setattr(self, attr, _as_float(v, getattr(self, attr)))
        return np.array([self.x, self.y, self.z, self.w])


class ColorNode(Node):
    """RGBA color; channel inputs are clamped to [0,1] (ColorNode.cs:141-160)."""

    type_name = "ColorNode"
    category = "Math"

    def __init__(self, r=1.0, g=1.0, b=1.0, a=1.0):
        super().__init__("Color")
        self.r, self.g, self.b, self.a = float(r), float(g), float(b), float(a)
        for n in ("R", "G", "B", "A"):
            self.add_input(n, SocketType.FLOAT)
        self.add_output("Color", SocketType.COLOR)

    def evaluate(self, input_values):
        for attr, name in (("r", "R"), ("g", "G"), ("b", "B"), ("a", "A")):
            v = self.get_input_value(name, input_values)
            if v is not None:
                setattr(self, attr, min(1.0, max(0.0, _as_float(v))))
        return np.array([self.r, self.g, self.b, self.a])


class _BinaryMathNode(Node):
    category = "Math"

    def __init__(self, title):
        super().__init__(title)
        self.add_input("A", SocketType.FLOAT)
        self.add_input("B", SocketType.FLOAT)
        self.add_output("Result", SocketType.FLOAT)


class AddNode(_BinaryMathNode):
    type_name = "AddNode"

    def __init__(self):
        super().__init__("Add")

    def evaluate(self, input_values):
        a = self.get_input_value("A", input_values)
        b = self.get_input_value("B", input_values)
        if _is_vec3(a) and _is_vec3(b):
            return a + b
        return _as_float(a, 0.0) + _as_float(b, 0.0)


class SubNode(_BinaryMathNode):
    type_name = "SubNode"

    def __init__(self):
        super().__init__("Sub")

    def evaluate(self, input_values):
        a = self.get_input_value("A", input_values)
        b = self.get_input_value("B", input_values)
        if _is_vec3(a) and _is_vec3(b):
            return a - b
        return _as_float(a, 0.0) - _as_float(b, 0.0)


class MulNode(_BinaryMathNode):
    type_name = "MulNode"

    def __init__(self):
        super().__init__("Mul")

    def evaluate(self, input_values):
        a = self.get_input_value("A", input_values)
        b = self.get_input_value("B", input_values)
        if _is_vec3(a) and isinstance(b, (int, float, np.floating)):
            return a * float(b)
        if isinstance(a, (int, float, np.floating)) and _is_vec3(b):
            return float(a) * b
        if _is_vec3(a) and _is_vec3(b):
            return a * b
        return _as_float(a, 1.0) * _as_float(b, 1.0)


class DivNode(_BinaryMathNode):
    type_name = "DivNode"

    def __init__(self):
        super().__init__("Div")

    def evaluate(self, input_values):
        a = self.get_input_value("A", input_values)
        b = self.get_input_value("B", input_values)
        if _is_vec3(a) and isinstance(b, (int, float, np.floating)):
            return a.copy() if float(b) == 0.0 else a / float(b)
        if _is_vec3(a) and _is_vec3(b):
            return np.where(b != 0.0, a / np.where(b == 0.0, 1.0, b), a)
        fa = _as_float(a, 1.0)
        fb = _as_float(b, 1.0)
        return fa if fb == 0.0 else fa / fb


# ---------------------------------------------------------------------------
# Transform nodes
# ---------------------------------------------------------------------------
class TransformNode(Node):
    """Position/euler-rotation/scale -> Transform (TransformNode.cs:77-118)."""

    type_name = "TransformNode"
    category = "Math"

    def __init__(self):
        super().__init__("Transform")
        self.default_position = np.zeros(3)
        self.default_rotation = np.zeros(3)  # euler degrees
        self.default_scale = np.ones(3)
        self.add_input("Position", SocketType.VECTOR3)
        self.add_input("Rotation", SocketType.VECTOR3)
        self.add_input("Scale", SocketType.VECTOR3)
        self.add_output("Transform", SocketType.TRANSFORM)

    def evaluate(self, input_values):
        pos = self.get_input_value("Position", input_values)
        rot = self.get_input_value("Rotation", input_values)
        scale = self.get_input_value("Scale", input_values)
        t = Transform(
            position=_as_vec(pos, 3, self.default_position),
            scale=_as_vec(scale, 3, self.default_scale),
        )
        t.euler_angles = _as_vec(rot, 3, self.default_rotation)
        return t


class CombineTransformNode(Node):
    type_name = "CombineTransformNode"
    category = "Math"

    def __init__(self):
        super().__init__("Combine Transform")
        self.add_input("Parent", SocketType.TRANSFORM)
        self.add_input("Local", SocketType.TRANSFORM)
        self.add_output("Transform", SocketType.TRANSFORM)

    def evaluate(self, input_values):
        parent = self.get_input_value("Parent", input_values) or Transform.identity()
        local = self.get_input_value("Local", input_values) or Transform.identity()
        return local.combine(parent)


# ---------------------------------------------------------------------------
# Material nodes
# ---------------------------------------------------------------------------
class MaterialBSDFNode(Node):
    """Full BSDF material (MaterialBSDFNode.cs:118-173)."""

    type_name = "MaterialBSDFNode"
    category = "Material"

    def __init__(self):
        super().__init__("BSDF")
        self.base_color = np.array([0.8, 0.8, 0.8, 1.0])
        self.metallic = 0.0
        self.roughness = 0.5
        self.transmission = 0.0
        self.ior = 1.5
        self.emission = np.zeros(4)
        self.absorption = np.zeros(3)
        self.add_input("Base Color", SocketType.COLOR)
        self.add_input("Metallic", SocketType.FLOAT)
        self.add_input("Roughness", SocketType.FLOAT)
        self.add_input("Transmission", SocketType.FLOAT)
        self.add_input("IOR", SocketType.FLOAT)
        self.add_input("Emission", SocketType.COLOR)
        self.add_input("Absorption", SocketType.VECTOR3)
        self.add_output("Material", SocketType.MATERIAL)

    def evaluate(self, input_values):
        base_color = _as_vec(self.get_input_value("Base Color", input_values), 4, self.base_color)
        metallic = _as_float(self.get_input_value("Metallic", input_values), self.metallic)
        roughness = _as_float(self.get_input_value("Roughness", input_values), self.roughness)
        transmission = _as_float(
            self.get_input_value("Transmission", input_values), self.transmission
        )
        ior = _as_float(self.get_input_value("IOR", input_values), self.ior)
        emission = _as_vec(self.get_input_value("Emission", input_values), 4, self.emission)
        absorption = _as_vec(self.get_input_value("Absorption", input_values), 3, self.absorption)
        return MaterialData(
            base_color=base_color,
            metallic=min(1.0, max(0.0, metallic)),
            roughness=min(1.0, max(0.0, roughness)),
            transmission=min(1.0, max(0.0, transmission)),
            ior=max(1.0, ior),
            emission=emission,
            specular=0.5,
            absorption=np.maximum(absorption, 0.0),
        )


class UniversalPBRNode(Node):
    """Opaque PBR subset (UniversalPBRNode.cs:74-99)."""

    type_name = "UniversalPBRNode"
    category = "Material"

    def __init__(self):
        super().__init__("Universal PBR")
        self.base_color = np.array([0.8, 0.8, 0.8, 1.0])
        self.metallic = 0.0
        self.roughness = 0.5
        self.emissive = np.zeros(3)
        self.add_input("Base Color", SocketType.COLOR)
        self.add_input("Metallic", SocketType.FLOAT)
        self.add_input("Roughness", SocketType.FLOAT)
        self.add_input("Emissive", SocketType.VECTOR3)
        self.add_output("Material", SocketType.MATERIAL)

    def evaluate(self, input_values):
        base_color = _as_vec(self.get_input_value("Base Color", input_values), 4, self.base_color)
        metallic = min(
            1.0, max(0.0, _as_float(self.get_input_value("Metallic", input_values), self.metallic))
        )
        roughness = min(
            1.0,
            max(0.0, _as_float(self.get_input_value("Roughness", input_values), self.roughness)),
        )
        emissive = _as_vec(self.get_input_value("Emissive", input_values), 3, self.emissive)
        return MaterialData(
            base_color=base_color,
            metallic=metallic,
            roughness=roughness,
            transmission=0.0,
            ior=1.5,
            emission=np.array([emissive[0], emissive[1], emissive[2], 1.0]),
            specular=0.5,
            absorption=np.zeros(3),
        )


class EmissionMaterialNode(Node):
    type_name = "EmissionMaterialNode"
    category = "Material"

    def __init__(self):
        super().__init__("Emission")
        self.emission_color = np.ones(4)
        self.strength = 1.0
        self.base_color = np.array([0.0, 0.0, 0.0, 1.0])
        self.add_input("Emission Color", SocketType.COLOR)
        self.add_input("Strength", SocketType.FLOAT)
        self.add_input("Base Color", SocketType.COLOR)
        self.add_output("Material", SocketType.MATERIAL)

    def evaluate(self, input_values):
        ec = _as_vec(self.get_input_value("Emission Color", input_values), 4, self.emission_color)
        strength = max(
            0.0, _as_float(self.get_input_value("Strength", input_values), self.strength)
        )
        base = _as_vec(self.get_input_value("Base Color", input_values), 4, self.base_color)
        emission = np.array([ec[0] * strength, ec[1] * strength, ec[2] * strength, ec[3]])
        return MaterialData(
            base_color=base,
            metallic=0.0,
            roughness=1.0,
            transmission=0.0,
            ior=1.5,
            emission=emission,
            specular=0.5,
            absorption=np.zeros(3),
        )


# ---------------------------------------------------------------------------
# Object nodes
# ---------------------------------------------------------------------------
class SphereNode(Node):
    """Sphere: radius scaled by max transform-scale component (SphereNode.cs:54-82)."""

    type_name = "SphereNode"
    category = "Object"

    def __init__(self):
        super().__init__("Sphere")
        self.object_transform = Transform.identity()
        self.radius = 1.0
        self.add_input("Transform", SocketType.TRANSFORM)
        self.add_input("Material", SocketType.MATERIAL)
        self.add_input("Radius", SocketType.FLOAT)
        self.add_output("Object", SocketType.OBJECT)

    def evaluate(self, input_values):
        transform = self.get_input_value("Transform", input_values) or self.object_transform
        material = self.get_input_value("Material", input_values) or MaterialData.default()
        radius = _as_float(self.get_input_value("Radius", input_values), self.radius)
        scaled = radius * float(np.max(transform.scale))
        return SphereData(
            position=np.array(transform.position), radius=scaled, material=material
        )


class PlaneNode(Node):
    """Infinite plane; normal rotated by the transform (PlaneNode.cs:57-83)."""

    type_name = "PlaneNode"
    category = "Object"

    def __init__(self):
        super().__init__("Plane")
        self.object_transform = Transform.identity()
        self.normal = np.array([0.0, 1.0, 0.0])
        self.add_input("Transform", SocketType.TRANSFORM)
        self.add_input("Material", SocketType.MATERIAL)
        self.add_input("Normal", SocketType.VECTOR3)
        self.add_output("Object", SocketType.OBJECT)

    def evaluate(self, input_values):
        transform = self.get_input_value("Transform", input_values) or self.object_transform
        material = self.get_input_value("Material", input_values) or MaterialData.default()
        normal = _as_vec(self.get_input_value("Normal", input_values), 3, self.normal)
        rotated = rotate_vector(normal, transform.rotation)
        length = np.linalg.norm(rotated)
        n = rotated / length if length > 1e-12 else np.array([0.0, 1.0, 0.0])
        return PlaneData(position=np.array(transform.position), normal=n, material=material)


class BoxNode(Node):
    """OBB box: half-extents = size*scale*0.5, axes from quaternion (BoxNode.cs:57-100)."""

    type_name = "BoxNode"
    category = "Object"

    def __init__(self):
        super().__init__("Box")
        self.object_transform = Transform.identity()
        self.size = np.ones(3)
        self.add_input("Transform", SocketType.TRANSFORM)
        self.add_input("Material", SocketType.MATERIAL)
        self.add_input("Size", SocketType.VECTOR3)
        self.add_output("Object", SocketType.OBJECT)

    def evaluate(self, input_values):
        transform = self.get_input_value("Transform", input_values) or self.object_transform
        material = self.get_input_value("Material", input_values) or MaterialData.default()
        size = _as_vec(self.get_input_value("Size", input_values), 3, self.size)
        half = size * transform.scale * 0.5
        ax, ay, az = obb_axes_from_quat(transform.rotation)
        return BoxData(
            center=np.array(transform.position),
            size=half,
            axis_x=ax,
            axis_y=ay,
            axis_z=az,
            material=material,
        )


class FBXMeshNode(Node):
    """FBX mesh instance via mesh-cache lookup (FBXMeshNode.cs:113-137)."""

    type_name = "FBXMeshNode"
    category = "Object"

    def __init__(self, mesh_name: str = ""):
        super().__init__(mesh_name or "FBXMesh")
        self.mesh_name = mesh_name
        self.object_transform = Transform.identity()
        self.add_input("Transform", SocketType.TRANSFORM)
        self.add_input("Material", SocketType.MATERIAL)
        self.add_output("Object", SocketType.OBJECT)

    def evaluate(self, input_values):
        # Drop instances whose mesh is not in the cache (FBXMeshNode.cs:116-117).
        if _MESH_RESOLVER is not None and _MESH_RESOLVER(self.mesh_name) is None:
            return None
        transform = self.get_input_value("Transform", input_values) or self.object_transform
        material = self.get_input_value("Material", input_values) or MaterialData.default()
        return MeshObjectData(mesh_name=self.mesh_name, transform=transform, material=material)


# ---------------------------------------------------------------------------
# Light nodes
# ---------------------------------------------------------------------------
class PointLightNode(Node):
    type_name = "PointLightNode"
    category = "Light"

    def __init__(self):
        super().__init__("Point Light")
        self.light_position = np.array([5.0, 5.0, -5.0])
        self.color = np.ones(4)
        self.intensity = 1.0
        self.attenuation = 0.1
        self.radius = 0.0
        self.soft_shadow_samples = 4.0
        self.add_input("Position", SocketType.VECTOR3)
        self.add_input("Color", SocketType.COLOR)
        self.add_input("Intensity", SocketType.FLOAT)
        self.add_input("Radius", SocketType.FLOAT)
        self.add_input("Shadow Samples", SocketType.FLOAT)
        self.add_output("Light", SocketType.LIGHT)

    def evaluate(self, input_values):
        position = _as_vec(self.get_input_value("Position", input_values), 3, self.light_position)
        color = _as_vec(self.get_input_value("Color", input_values), 4, self.color)
        intensity = _as_float(self.get_input_value("Intensity", input_values), self.intensity)
        radius = _as_float(self.get_input_value("Radius", input_values), self.radius)
        samples = _as_float(
            self.get_input_value("Shadow Samples", input_values), self.soft_shadow_samples
        )
        return LightData(
            type=LightType.POINT,
            position=position,
            direction=np.zeros(3),
            color=color,
            intensity=intensity,
            attenuation=self.attenuation,
            radius=radius,
            soft_shadow_samples=min(16.0, max(1.0, samples)),
        )


class DirectionalLightNode(Node):
    type_name = "DirectionalLightNode"
    category = "Light"

    def __init__(self):
        super().__init__("Directional Light")
        self.direction = np.array([0.0, -1.0, 0.0])
        self.color = np.ones(4)
        self.intensity = 1.0
        self.angular_radius = 0.0
        self.soft_shadow_samples = 4.0
        self.add_input("Direction", SocketType.VECTOR3)
        self.add_input("Color", SocketType.COLOR)
        self.add_input("Intensity", SocketType.FLOAT)
        self.add_input("Angular Radius", SocketType.FLOAT)
        self.add_input("Shadow Samples", SocketType.FLOAT)
        self.add_output("Light", SocketType.LIGHT)

    def evaluate(self, input_values):
        direction = _as_vec(self.get_input_value("Direction", input_values), 3, self.direction)
        color = _as_vec(self.get_input_value("Color", input_values), 4, self.color)
        intensity = _as_float(self.get_input_value("Intensity", input_values), self.intensity)
        angular = _as_float(
            self.get_input_value("Angular Radius", input_values), self.angular_radius
        )
        samples = _as_float(
            self.get_input_value("Shadow Samples", input_values), self.soft_shadow_samples
        )
        length = np.linalg.norm(direction)
        d = direction / length if length > 1e-12 else np.array([0.0, -1.0, 0.0])
        return LightData(
            type=LightType.DIRECTIONAL,
            position=np.zeros(3),
            direction=d,
            color=color,
            intensity=intensity,
            attenuation=0.0,
            radius=angular,
            soft_shadow_samples=min(16.0, max(1.0, samples)),
        )


class AmbientLightNode(Node):
    type_name = "AmbientLightNode"
    category = "Light"

    def __init__(self):
        super().__init__("Ambient Light")
        self.color = np.array([0.2, 0.2, 0.2, 1.0])
        self.intensity = 1.0
        self.add_input("Color", SocketType.COLOR)
        self.add_input("Intensity", SocketType.FLOAT)
        self.add_output("Light", SocketType.LIGHT)

    def evaluate(self, input_values):
        color = _as_vec(self.get_input_value("Color", input_values), 4, self.color)
        intensity = _as_float(self.get_input_value("Intensity", input_values), self.intensity)
        return LightData(
            type=LightType.AMBIENT,
            position=np.zeros(3),
            direction=np.zeros(3),
            color=color,
            intensity=intensity,
            attenuation=0.0,
            radius=0.0,
            soft_shadow_samples=1.0,
        )


# ---------------------------------------------------------------------------
# Camera / Scene nodes
# ---------------------------------------------------------------------------
class CameraNode(Node):
    type_name = "CameraNode"
    category = "Camera"

    def __init__(self):
        super().__init__("Camera")
        self.camera_position = np.array([0.0, 2.0, -5.0])
        self.look_at = np.array([0.0, 1.0, 0.0])
        self.up = np.array([0.0, 1.0, 0.0])
        self.field_of_view = 60.0
        self.near = 0.1
        self.far = 1000.0
        self.aperture_size = 0.0
        self.focus_distance = 5.0
        self.add_input("Position", SocketType.VECTOR3)
        self.add_input("Look At", SocketType.VECTOR3)
        self.add_output("Camera", SocketType.CAMERA)

    def evaluate(self, input_values):
        position = _as_vec(self.get_input_value("Position", input_values), 3, self.camera_position)
        look_at = _as_vec(self.get_input_value("Look At", input_values), 3, self.look_at)
        return CameraData(
            position=position,
            look_at=look_at,
            up=np.array(self.up),
            field_of_view=self.field_of_view,
            near=self.near,
            far=self.far,
            aperture_size=self.aperture_size,
            focus_distance=self.focus_distance,
        )


class SceneNode(Node):
    """Scene sink: dynamic Object*/Light* sockets + render settings (SceneNode.cs)."""

    type_name = "SceneNode"
    category = "Scene"

    def __init__(self, num_object_sockets: int = 6, num_light_sockets: int = 4):
        super().__init__("Scene")
        self.settings = RenderSettings()
        self.add_input("Camera", SocketType.CAMERA)
        self.object_socket_names = [f"Object{i + 1}" for i in range(num_object_sockets)]
        self.light_socket_names = [f"Light{i + 1}" for i in range(num_light_sockets)]
        for n in self.object_socket_names:
            self.add_input(n, SocketType.OBJECT)
        for n in self.light_socket_names:
            self.add_input(n, SocketType.LIGHT)
        self.add_output("Scene", SocketType.SCENE)

    def set_socket_names(self, object_names, light_names):
        """Rebuild dynamic sockets from saved names (SceneNode.cs:20-60)."""
        self.input_sockets = [s for s in self.input_sockets if s.name == "Camera"]
        self.object_socket_names = list(object_names)
        self.light_socket_names = list(light_names)
        for n in self.object_socket_names:
            self.add_input(n, SocketType.OBJECT)
        for n in self.light_socket_names:
            self.add_input(n, SocketType.LIGHT)

    def evaluate(self, input_values):
        camera = self.get_input_value("Camera", input_values)
        objects = []
        lights = []
        for s in self.input_sockets:
            v = input_values.get(s.id)
            if v is None:
                continue
            if s.type == SocketType.OBJECT:
                objects.append(v)
            elif s.type == SocketType.LIGHT and isinstance(v, LightData):
                lights.append(v)
        return SceneData(
            camera=camera if isinstance(camera, CameraData) else CameraData(),
            objects=objects,
            lights=lights,
            settings=self.settings,
        )


NODE_TYPES: Dict[str, type] = {
    cls.type_name: cls
    for cls in (
        SphereNode,
        PlaneNode,
        BoxNode,
        FBXMeshNode,
        EmissionMaterialNode,
        MaterialBSDFNode,
        UniversalPBRNode,
        PointLightNode,
        DirectionalLightNode,
        AmbientLightNode,
        CameraNode,
        SceneNode,
        FloatNode,
        Vector3Node,
        Vector4Node,
        ColorNode,
        AddNode,
        SubNode,
        MulNode,
        DivNode,
        TransformNode,
        CombineTransformNode,
    )
}

# NodeRegistry short names (NodeRegistry.cs:22-59) alias to the same classes.
_SHORT_ALIASES = {
    "Sphere": SphereNode,
    "Plane": PlaneNode,
    "Box": BoxNode,
    "FBXMesh": FBXMeshNode,
    "Emission": EmissionMaterialNode,
    "MaterialBSDF": MaterialBSDFNode,
    "UniversalPBR": UniversalPBRNode,
    "PointLight": PointLightNode,
    "DirectionalLight": DirectionalLightNode,
    "AmbientLight": AmbientLightNode,
    "Camera": CameraNode,
    "Scene": SceneNode,
    "Float": FloatNode,
    "Vector3": Vector3Node,
    "Vector4": Vector4Node,
    "Color": ColorNode,
    "Add": AddNode,
    "Sub": SubNode,
    "Mul": MulNode,
    "Div": DivNode,
    "Transform": TransformNode,
    "CombineTransform": CombineTransformNode,
}
NODE_TYPES.update(_SHORT_ALIASES)


def create_node(type_name: str) -> Optional[Node]:
    cls = NODE_TYPES.get(type_name)
    return cls() if cls is not None else None
