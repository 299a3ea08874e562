""".rtvs scene-file loading and saving.

The `.rtvs` format is JSON: {Version, Nodes[{Id, Type, Title, PositionX,
PositionY, Properties}], Connections[{OutputNodeId, OutputSocketName,
InputNodeId, InputSocketName}], Viewport} (SceneFileService.cs:20-33,
sample_scene.rtvs). This module reproduces the reference's per-type property
switch (SceneFileService.cs:162-306), the type-name factory (incl. legacy
"LightNode" -> PointLightNode at :131), dropping FBX nodes whose mesh cache
is missing (:52-62), and SceneNode dynamic-socket reconstruction.

Copied from raytracevs_tpu/scene/rtvs.py (json and numpy only).
"""
from __future__ import annotations

import json
import uuid
from typing import Any, Dict, Optional

import numpy as np

from . import nodes as N
from .graph import Node, NodeGraph, SocketType
from .transform import Transform


def _vec3(d: Optional[dict], default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if not isinstance(d, dict):
        return np.array(default, dtype=np.float64)
    return np.array(
        [d.get("X", default[0]), d.get("Y", default[1]), d.get("Z", default[2])],
        dtype=np.float64,
    )


def _vec4(d: Optional[dict], default=(0.0, 0.0, 0.0, 1.0)) -> np.ndarray:
    if not isinstance(d, dict):
        return np.array(default, dtype=np.float64)
    return np.array(
        [
            d.get("X", d.get("R", default[0])),
            d.get("Y", d.get("G", default[1])),
            d.get("Z", d.get("B", default[2])),
            d.get("W", d.get("A", default[3])),
        ],
        dtype=np.float64,
    )


def _transform(d: Optional[dict]) -> Transform:
    t = Transform.identity()
    if not isinstance(d, dict):
        return t
    t.position = _vec3(d.get("Position"))
    rot = d.get("Rotation")
    if isinstance(rot, dict):
        t.rotation = np.array(
            [rot.get("X", 0.0), rot.get("Y", 0.0), rot.get("Z", 0.0), rot.get("W", 1.0)],
            dtype=np.float64,
        )
        # Zero quaternion (uninitialized) -> identity, matching Transform.cs:66-71.
        if float(np.dot(t.rotation, t.rotation)) < 1e-10:
            t.rotation = np.array([0.0, 0.0, 0.0, 1.0])
    t.scale = _vec3(d.get("Scale"), (1.0, 1.0, 1.0))
    if np.all(t.scale == 0.0):
        t.scale = np.ones(3)
    return t


def _apply_properties(node: Node, props: Dict[str, Any]) -> None:
    """Per-type property deserialization (SceneFileService.cs:308-560)."""
    p = props or {}
    if isinstance(node, N.SphereNode):
        if "Transform" in p:
            node.object_transform = _transform(p["Transform"])
        elif "Position" in p:  # legacy
            node.object_transform.position = _vec3(p["Position"])
        node.radius = float(p.get("Radius", node.radius))
    elif isinstance(node, N.PlaneNode):
        if "Transform" in p:
            node.object_transform = _transform(p["Transform"])
        elif "Position" in p:
            node.object_transform.position = _vec3(p["Position"])
        if "Normal" in p:
            node.normal = _vec3(p["Normal"], (0.0, 1.0, 0.0))
    elif isinstance(node, N.BoxNode):
        if "Transform" in p:
            node.object_transform = _transform(p["Transform"])
        elif "Position" in p:
            node.object_transform.position = _vec3(p["Position"])
        if "Size" in p:
            node.size = _vec3(p["Size"], (1.0, 1.0, 1.0))
    elif isinstance(node, N.FBXMeshNode):
        node.mesh_name = str(p.get("MeshName", node.mesh_name))
        node.title = node.mesh_name or node.title
        if "Transform" in p:
            node.object_transform = _transform(p["Transform"])
    elif isinstance(node, N.CameraNode):
        if "CameraPosition" in p:
            node.camera_position = _vec3(p["CameraPosition"])
        elif "Position" in p:
            node.camera_position = _vec3(p["Position"])
        if "LookAt" in p:
            node.look_at = _vec3(p["LookAt"])
        if "Up" in p:
            node.up = _vec3(p["Up"], (0.0, 1.0, 0.0))
        node.field_of_view = float(p.get("FieldOfView", node.field_of_view))
        node.near = float(p.get("Near", node.near))
        node.far = float(p.get("Far", node.far))
        node.aperture_size = float(p.get("ApertureSize", node.aperture_size))
        node.focus_distance = float(p.get("FocusDistance", node.focus_distance))
    elif isinstance(node, N.PointLightNode):
        if "LightPosition" in p:
            node.light_position = _vec3(p["LightPosition"])
        elif "Position" in p:
            node.light_position = _vec3(p["Position"])
        if "Color" in p:
            node.color = _vec4(p["Color"], (1, 1, 1, 1))
        node.intensity = float(p.get("Intensity", node.intensity))
        node.attenuation = float(p.get("Attenuation", node.attenuation))
        node.radius = float(p.get("Radius", node.radius))
        node.soft_shadow_samples = float(p.get("SoftShadowSamples", node.soft_shadow_samples))
    elif isinstance(node, N.AmbientLightNode):
        if "Color" in p:
            node.color = _vec4(p["Color"], (0.2, 0.2, 0.2, 1.0))
        node.intensity = float(p.get("Intensity", node.intensity))
    elif isinstance(node, N.DirectionalLightNode):
        if "Direction" in p:
            node.direction = _vec3(p["Direction"], (0.0, -1.0, 0.0))
        if "Color" in p:
            node.color = _vec4(p["Color"], (1, 1, 1, 1))
        node.intensity = float(p.get("Intensity", node.intensity))
        node.angular_radius = float(p.get("AngularRadius", node.angular_radius))
        node.soft_shadow_samples = float(p.get("SoftShadowSamples", node.soft_shadow_samples))
    elif isinstance(node, N.MaterialBSDFNode):
        if "BaseColor" in p:
            node.base_color = _vec4(p["BaseColor"], (0.8, 0.8, 0.8, 1.0))
        node.metallic = float(p.get("Metallic", node.metallic))
        node.roughness = float(p.get("Roughness", node.roughness))
        node.transmission = float(p.get("Transmission", node.transmission))
        node.ior = float(p.get("IOR", node.ior))
        if "Emission" in p:
            node.emission = _vec4(p["Emission"], (0, 0, 0, 0))
        if "Absorption" in p:
            node.absorption = _vec3(p["Absorption"])
    elif isinstance(node, N.UniversalPBRNode):
        if "BaseColor" in p:
            node.base_color = _vec4(p["BaseColor"], (0.8, 0.8, 0.8, 1.0))
        node.metallic = float(p.get("Metallic", node.metallic))
        node.roughness = float(p.get("Roughness", node.roughness))
        if "Emissive" in p:
            node.emissive = _vec3(p["Emissive"])
    elif isinstance(node, N.EmissionMaterialNode):
        if "EmissionColor" in p:
            node.emission_color = _vec4(p["EmissionColor"], (1, 1, 1, 1))
        node.strength = float(p.get("Strength", node.strength))
        if "BaseColor" in p:
            node.base_color = _vec4(p["BaseColor"], (0, 0, 0, 1))
    elif isinstance(node, N.ColorNode):
        node.r = float(p.get("R", node.r))
        node.g = float(p.get("G", node.g))
        node.b = float(p.get("B", node.b))
        node.a = float(p.get("A", node.a))
    elif isinstance(node, N.Vector3Node):
        node.x = float(p.get("X", node.x))
        node.y = float(p.get("Y", node.y))
        node.z = float(p.get("Z", node.z))
    elif isinstance(node, N.Vector4Node):
        node.x = float(p.get("X", node.x))
        node.y = float(p.get("Y", node.y))
        node.z = float(p.get("Z", node.z))
        node.w = float(p.get("W", node.w))
    elif isinstance(node, N.FloatNode):
        node.value = float(p.get("Value", node.value))
    elif isinstance(node, N.TransformNode):
        node.default_position = np.array(
            [p.get("PositionX", 0.0), p.get("PositionY", 0.0), p.get("PositionZ", 0.0)]
        )
        node.default_rotation = np.array(
            [p.get("RotationX", 0.0), p.get("RotationY", 0.0), p.get("RotationZ", 0.0)]
        )
        node.default_scale = np.array(
            [p.get("ScaleX", 1.0), p.get("ScaleY", 1.0), p.get("ScaleZ", 1.0)]
        )
    elif isinstance(node, N.SceneNode):
        obj_names = p.get("ObjectSocketNames")
        light_names = p.get("LightSocketNames")
        if obj_names is not None or light_names is not None:
            node.set_socket_names(
                obj_names or node.object_socket_names, light_names or node.light_socket_names
            )
        s = node.settings
        s.samples_per_pixel = int(p.get("SamplesPerPixel", s.samples_per_pixel))
        s.max_bounces = int(p.get("MaxBounces", s.max_bounces))
        s.trace_recursion_depth = int(p.get("TraceRecursionDepth", s.trace_recursion_depth))
        s.exposure = float(p.get("Exposure", s.exposure))
        s.tone_map_operator = int(p.get("ToneMapOperator", s.tone_map_operator))
        s.denoiser_stabilization = float(p.get("DenoiserStabilization", s.denoiser_stabilization))
        s.shadow_strength = float(p.get("ShadowStrength", s.shadow_strength))
        s.shadow_absorption_scale = float(
            p.get("ShadowAbsorptionScale", s.shadow_absorption_scale)
        )
        s.enable_denoiser = bool(p.get("EnableDenoiser", s.enable_denoiser))
        s.gamma = float(p.get("Gamma", s.gamma))
        s.light_attenuation_constant = float(
            p.get("LightAttenuationConstant", s.light_attenuation_constant)
        )
        s.light_attenuation_linear = float(
            p.get("LightAttenuationLinear", s.light_attenuation_linear)
        )
        s.light_attenuation_quadratic = float(
            p.get("LightAttenuationQuadratic", s.light_attenuation_quadratic)
        )
        s.max_shadow_lights = int(p.get("MaxShadowLights", s.max_shadow_lights))
        s.nrd_bypass_distance = float(p.get("NRDBypassDistance", s.nrd_bypass_distance))
        s.nrd_bypass_blend_range = float(p.get("NRDBypassBlendRange", s.nrd_bypass_blend_range))


_LEGACY_TYPE_MAP = {"LightNode": "PointLightNode"}  # SceneFileService.cs:131


def load_graph(path_or_dict, mesh_resolver=None) -> NodeGraph:
    """Load a .rtvs file (path, JSON string, or parsed dict) into a NodeGraph."""
    if isinstance(path_or_dict, dict):
        doc = path_or_dict
    else:
        text = str(path_or_dict)
        if not text.lstrip().startswith("{"):
            # Treat as a file path; surface a clear error for missing files.
            with open(path_or_dict, "r", encoding="utf-8") as f:
                text = f.read()
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"invalid .rtvs scene file {path_or_dict!r}: {e}") from e

    graph = NodeGraph()
    by_id: Dict[str, Node] = {}
    for nd in doc.get("Nodes", []):
        type_name = _LEGACY_TYPE_MAP.get(nd.get("Type", ""), nd.get("Type", ""))
        node = N.create_node(type_name)
        if node is None:
            continue
        node.title = nd.get("Title", node.title)
        node.position = (float(nd.get("PositionX", 0.0)), float(nd.get("PositionY", 0.0)))
        _apply_properties(node, nd.get("Properties") or {})
        try:
            node.id = uuid.UUID(str(nd["Id"]))
        except (KeyError, ValueError):
            pass  # non-GUID ids keep the generated one (connections resolve by string)
        # Drop FBX nodes whose mesh is missing from the cache
        # (SceneFileService.cs:52-62).
        if isinstance(node, N.FBXMeshNode) and mesh_resolver is not None:
            if mesh_resolver(node.mesh_name) is None:
                continue
        graph.add_node(node)
        by_id[str(node.id).lower()] = node

    scene_nodes = [n for n in graph.nodes if isinstance(n, N.SceneNode)]
    for cd in doc.get("Connections", []):
        out_node = by_id.get(str(cd.get("OutputNodeId", "")).lower())
        in_node = by_id.get(str(cd.get("InputNodeId", "")).lower())
        if out_node is None or in_node is None:
            continue
        out_sock = out_node.find_output(cd.get("OutputSocketName", ""))
        in_name = cd.get("InputSocketName", "")
        # Legacy socket-name repair (SceneFileService.cs:79-107).
        if in_name.startswith("オブジェクト"):
            in_name = "Object" + in_name[len("オブジェクト"):]
        elif in_name.startswith("ライト"):
            in_name = "Light" + in_name[len("ライト"):]
        in_sock = in_node.find_input(in_name)
        # SceneNode dynamic sockets referenced by connections but missing from
        # the saved socket-name lists are re-created (legacy repair).
        if in_sock is None and isinstance(in_node, N.SceneNode):
            if in_name.startswith("Object"):
                in_sock = in_node.add_input(in_name, SocketType.OBJECT)
                in_node.object_socket_names.append(in_name)
            elif in_name.startswith("Light"):
                in_sock = in_node.add_input(in_name, SocketType.LIGHT)
                in_node.light_socket_names.append(in_name)
        if out_sock is None and len(out_node.output_sockets) == 1:
            out_sock = out_node.output_sockets[0]
        if out_sock is None or in_sock is None:
            continue
        try:
            graph.connect(out_sock, in_sock)
        except ValueError:
            continue
    # touch the scene nodes so first evaluation is full
    for sn in scene_nodes:
        sn.mark_dirty()
    # Preserve the editor viewport for round-trips (SceneFileService.cs:20-33)
    graph.viewport = doc.get("Viewport") or {}
    return graph


def _transform_to_json(t: Transform) -> dict:
    e = t.euler_angles
    return {
        "Position": {"X": t.position[0], "Y": t.position[1], "Z": t.position[2]},
        "Rotation": {
            "X": t.rotation[0],
            "Y": t.rotation[1],
            "Z": t.rotation[2],
            "W": t.rotation[3],
            "IsIdentity": bool(np.allclose(t.rotation, [0, 0, 0, 1])),
        },
        "Scale": {"X": t.scale[0], "Y": t.scale[1], "Z": t.scale[2]},
        "EulerAngles": {"X": e[0], "Y": e[1], "Z": e[2]},
    }


def _v3j(v) -> dict:
    return {"X": float(v[0]), "Y": float(v[1]), "Z": float(v[2])}


def _v4j(v) -> dict:
    return {"X": float(v[0]), "Y": float(v[1]), "Z": float(v[2]), "W": float(v[3])}


def _c4j(v) -> dict:
    return {"R": float(v[0]), "G": float(v[1]), "B": float(v[2]), "A": float(v[3])}


def _serialize_properties(node: Node) -> dict:
    """Per-type property serialization (SceneFileService.cs:162-306)."""
    if isinstance(node, N.SphereNode):
        return {"Transform": _transform_to_json(node.object_transform), "Radius": node.radius}
    if isinstance(node, N.PlaneNode):
        return {"Transform": _transform_to_json(node.object_transform), "Normal": _v3j(node.normal)}
    if isinstance(node, N.BoxNode):
        return {"Transform": _transform_to_json(node.object_transform), "Size": _v3j(node.size)}
    if isinstance(node, N.FBXMeshNode):
        return {"MeshName": node.mesh_name, "Transform": _transform_to_json(node.object_transform)}
    if isinstance(node, N.CameraNode):
        return {
            "CameraPosition": _v3j(node.camera_position),
            "LookAt": _v3j(node.look_at),
            "Up": _v3j(node.up),
            "FieldOfView": node.field_of_view,
            "Near": node.near,
            "Far": node.far,
            "ApertureSize": node.aperture_size,
            "FocusDistance": node.focus_distance,
        }
    if isinstance(node, N.PointLightNode):
        return {
            "LightPosition": _v3j(node.light_position),
            "Color": _v4j(node.color),
            "Intensity": node.intensity,
            "Attenuation": node.attenuation,
            "Radius": node.radius,
            "SoftShadowSamples": node.soft_shadow_samples,
        }
    if isinstance(node, N.AmbientLightNode):
        return {"Color": _v4j(node.color), "Intensity": node.intensity}
    if isinstance(node, N.DirectionalLightNode):
        return {
            "Direction": _v3j(node.direction),
            "Color": _v4j(node.color),
            "Intensity": node.intensity,
            "AngularRadius": node.angular_radius,
            "SoftShadowSamples": node.soft_shadow_samples,
        }
    if isinstance(node, N.MaterialBSDFNode):
        return {
            "BaseColor": _v4j(node.base_color),
            "Metallic": node.metallic,
            "Roughness": node.roughness,
            "Transmission": node.transmission,
            "IOR": node.ior,
            "Emission": _v4j(node.emission),
            "Absorption": _v3j(node.absorption),
        }
    if isinstance(node, N.UniversalPBRNode):
        return {
            "BaseColor": _v4j(node.base_color),
            "Metallic": node.metallic,
            "Roughness": node.roughness,
            "Emissive": _v3j(node.emissive),
        }
    if isinstance(node, N.EmissionMaterialNode):
        return {
            "EmissionColor": _v4j(node.emission_color),
            "Strength": node.strength,
            "BaseColor": _v4j(node.base_color),
        }
    if isinstance(node, N.ColorNode):
        return {"R": node.r, "G": node.g, "B": node.b, "A": node.a}
    if isinstance(node, N.Vector3Node):
        return {"X": node.x, "Y": node.y, "Z": node.z}
    if isinstance(node, N.Vector4Node):
        return {"X": node.x, "Y": node.y, "Z": node.z, "W": node.w}
    if isinstance(node, N.FloatNode):
        return {"Value": node.value}
    if isinstance(node, N.TransformNode):
        return {
            "PositionX": node.default_position[0],
            "PositionY": node.default_position[1],
            "PositionZ": node.default_position[2],
            "RotationX": node.default_rotation[0],
            "RotationY": node.default_rotation[1],
            "RotationZ": node.default_rotation[2],
            "ScaleX": node.default_scale[0],
            "ScaleY": node.default_scale[1],
            "ScaleZ": node.default_scale[2],
        }
    if isinstance(node, N.SceneNode):
        s = node.settings
        return {
            "ObjectSocketNames": list(node.object_socket_names),
            "LightSocketNames": list(node.light_socket_names),
            "SamplesPerPixel": s.samples_per_pixel,
            "MaxBounces": s.max_bounces,
            "TraceRecursionDepth": s.trace_recursion_depth,
            "Exposure": s.exposure,
            "ToneMapOperator": s.tone_map_operator,
            "DenoiserStabilization": s.denoiser_stabilization,
            "ShadowStrength": s.shadow_strength,
            "EnableDenoiser": s.enable_denoiser,
            "Gamma": s.gamma,
        }
    return {}


def save_graph(graph: NodeGraph, path: str, viewport: Optional[dict] = None) -> None:
    if viewport is None:
        viewport = getattr(graph, "viewport", None)
    """Save a NodeGraph to a .rtvs JSON file (SceneFileService.cs:20-33)."""
    doc = {
        "Version": "1.0",
        "Nodes": [
            {
                "Id": str(n.id),
                "Type": n.type_name,
                "Title": n.title,
                "PositionX": n.position[0],
                "PositionY": n.position[1],
                "Properties": _serialize_properties(n),
            }
            for n in graph.nodes
        ],
        "Connections": [
            {
                "OutputNodeId": str(c.output_node.id),
                "OutputSocketName": c.output_socket.name,
                "InputNodeId": str(c.input_node.id),
                "InputSocketName": c.input_socket.name,
            }
            for c in graph.connections
        ],
        "Viewport": viewport or {},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, default=float)


def copy_nodes(graph: NodeGraph, nodes) -> dict:
    """Serialize a node selection + intra-selection connections to a
    clipboard document (NodeEditorView.xaml.cs:742-797 HandleCopy)."""
    selected = set(n.id for n in nodes)
    return {
        "Nodes": [
            {
                "Id": str(n.id),
                "Type": n.type_name,
                "Title": n.title,
                "PositionX": n.position[0],
                "PositionY": n.position[1],
                "Properties": _serialize_properties(n),
            }
            for n in nodes
        ],
        "Connections": [
            {
                "OutputNodeId": str(c.output_node.id),
                "OutputSocketName": c.output_socket.name,
                "InputNodeId": str(c.input_node.id),
                "InputSocketName": c.input_socket.name,
            }
            for c in graph.connections
            if c.output_node.id in selected and c.input_node.id in selected
        ],
    }


def paste_nodes(graph: NodeGraph, clipboard: dict, offset=(30.0, 30.0)):
    """Instantiate clipboard nodes with fresh ids + a position offset and
    rebuild the intra-selection connections
    (NodeEditorView.xaml.cs:806-900 HandlePaste). Returns the new nodes."""
    from . import nodes as N  # noqa: F811 (module alias used by helpers)

    id_map = {}
    new_nodes = []
    for nd in clipboard.get("Nodes", []):
        type_name = _LEGACY_TYPE_MAP.get(nd.get("Type", ""), nd.get("Type", ""))
        cls = N.NODE_TYPES.get(type_name)
        if cls is None:
            continue
        node = cls()
        node.title = nd.get("Title", node.title)
        node.position = (
            float(nd.get("PositionX", 0.0)) + offset[0],
            float(nd.get("PositionY", 0.0)) + offset[1],
        )
        _apply_properties(node, nd.get("Properties") or {})
        graph.add_node(node)  # keeps the freshly generated id
        id_map[str(nd.get("Id", "")).lower()] = node
        new_nodes.append(node)
    for cd in clipboard.get("Connections", []):
        out_node = id_map.get(str(cd.get("OutputNodeId", "")).lower())
        in_node = id_map.get(str(cd.get("InputNodeId", "")).lower())
        if out_node is None or in_node is None:
            continue
        out_sock = out_node.find_output(cd.get("OutputSocketName", ""))
        in_sock = in_node.find_input(cd.get("InputSocketName", ""))
        if out_sock is not None and in_sock is not None:
            try:
                graph.connect(out_sock, in_sock)
            except ValueError:
                pass  # incompatible after property edits; skip like the editor
    return new_nodes
