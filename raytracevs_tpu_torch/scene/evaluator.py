"""SceneEvaluator: node graph -> SceneData.

Mirrors src/RayTraceVS.WPF/Services/SceneEvaluator.cs:34-311:
- If the graph contains a SceneNode, the evaluated SceneNode result wins —
  only objects/lights wired into it are rendered (:74-173).
- Otherwise all object/light/camera nodes in the graph are harvested
  directly (:174-311).
- Directional lights carry their direction in the position slot when flowing
  to the engine (:411-436); that convention is applied in flatten.py.

Copied from raytracevs_tpu/scene/evaluator.py.
"""
from __future__ import annotations

from typing import Optional

from .data import CameraData, LightData, SceneData
from .graph import NodeGraph
from .nodes import (
    AmbientLightNode,
    BoxData,
    CameraNode,
    DirectionalLightNode,
    FBXMeshNode,
    MeshObjectData,
    PlaneData,
    PlaneNode,
    PointLightNode,
    SceneNode,
    SphereData,
    SphereNode,
    BoxNode,
)


def evaluate_scene(graph: NodeGraph) -> SceneData:
    results = graph.evaluate()

    scene_nodes = [n for n in graph.nodes if isinstance(n, SceneNode)]
    if scene_nodes:
        result = results.get(scene_nodes[0].id)
        if isinstance(result, SceneData):
            return result
        return SceneData()

    # Fallback path: no SceneNode — harvest everything (SceneEvaluator.cs:174-311).
    scene = SceneData()
    camera_found: Optional[CameraData] = None
    for node in graph.nodes:
        value = results.get(node.id)
        if value is None:
            continue
        if isinstance(node, (SphereNode, PlaneNode, BoxNode, FBXMeshNode)) and isinstance(
            value, (SphereData, PlaneData, BoxData, MeshObjectData)
        ):
            scene.objects.append(value)
        elif isinstance(node, (PointLightNode, DirectionalLightNode, AmbientLightNode)):
            if isinstance(value, LightData):
                scene.lights.append(value)
        elif isinstance(node, CameraNode) and camera_found is None:
            if isinstance(value, CameraData):
                camera_found = value
    if camera_found is not None:
        scene.camera = camera_found
    return scene
