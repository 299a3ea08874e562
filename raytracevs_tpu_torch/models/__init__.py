"""Node-type "model zoo": the 22 built-in scene-graph node types."""
from ..scene.nodes import (
    NODE_TYPES, AddNode, AmbientLightNode, BoxNode, CameraNode, ColorNode,
    CombineTransformNode, DirectionalLightNode, DivNode, EmissionMaterialNode,
    FBXMeshNode, FloatNode, MaterialBSDFNode, MulNode, PlaneNode,
    PointLightNode, SceneNode, SphereNode, SubNode, TransformNode,
    UniversalPBRNode, Vector3Node, Vector4Node, create_node,
)
