""".rtvs scene files in the port (scene/rtvs.py, scene/evaluator.py) against
raytracevs_tpu: graphs built in code, written by one package's save_graph
and loaded by both, evaluate to SceneData whose flattened FlatScene leaves
are bit-equal (dtype, shape and bytes), in both directions. The graphs
cover every node type of scene/nodes.py, an FBX node resolved through an
in-code MeshCacheService (and one whose mesh is missing, dropped at load),
the legacy "LightNode", a graph without a SceneNode, and copy/paste between
the packages' clipboards. Engine.load_rtvs renders the demo scene's file
on the CPU against the JAX Engine in test_torch_engine.py's band."""
import os
import types

import numpy as np
import pytest
import torch

import _torch_scenes as S
import raytracevs_tpu.models as JM
import raytracevs_tpu.scene.evaluator as JE
import raytracevs_tpu.scene.graph as JG
import raytracevs_tpu.scene.rtvs as JR
import raytracevs_tpu.scene.transform as JT
from raytracevs_tpu import Engine as JEngine
from raytracevs_tpu.io import mesh_cache as JMC
from raytracevs_tpu.scene.flatten import flatten_scene as j_flatten
from raytracevs_tpu.scene.sanitize import sanitize_scene as j_sanitize
import raytracevs_tpu_torch.models as PM
import raytracevs_tpu_torch.scene.evaluator as PE
import raytracevs_tpu_torch.scene.graph as PG
import raytracevs_tpu_torch.scene.rtvs as PR
import raytracevs_tpu_torch.scene.transform as PT
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import FlatScene, flatten_scene
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

S.one_torch_thread()

JAX = types.SimpleNamespace(M=JM, G=JG, R=JR, E=JE, T=JT.Transform, flatten=j_flatten,
                            sanitize=j_sanitize)
PORT = types.SimpleNamespace(M=PM, G=PG, R=PR, E=PE, T=PT.Transform, flatten=flatten_scene,
                             sanitize=sanitize_scene)


def _wire(g, a, out_name, b, in_name):
    g.connect(a.find_output(out_name), b.find_input(in_name))


def all_nodes_graph(p):
    """A scene using each of the 22 node types, its values routed through
    the math, vector, colour and transform nodes; an FBX instance of
    "BigSphere" and one of "Missing", which no mesh service holds."""
    M = p.M
    g = p.G.NodeGraph()
    add = lambda node: g.add_node(node)  # noqa: E731

    def vec3(x, y, z):
        return add(M.Vector3Node(x, y, z))

    def flt(v):
        return add(M.FloatNode(v))

    def binop(cls, a, b):
        n = add(cls())
        _wire(g, flt(a), "Value", n, "A")
        _wire(g, flt(b), "Value", n, "B")
        return n

    def transform(pos, rot, scale):
        t = add(M.TransformNode())
        for name, v in (("Position", pos), ("Rotation", rot), ("Scale", scale)):
            _wire(g, vec3(*v), "Vector", t, name)
        return t

    scene = add(M.SceneNode(num_object_sockets=6, num_light_sockets=3))
    s = scene.settings
    s.samples_per_pixel, s.max_bounces, s.exposure, s.tone_map_operator = 1, 3, 1.25, 1
    s.gamma, s.shadow_strength = 2.2, 0.9
    cam = add(M.CameraNode())
    cam.field_of_view, cam.aperture_size = 55.0, 0.0
    _wire(g, vec3(0.3, 2.1, -5.2), "Vector", cam, "Position")
    look = add(M.Vector3Node(0.0, 0.9, 0.0))
    _wire(g, binop(M.AddNode, 0.25, 0.5), "Result", look, "X")
    _wire(g, look, "Vector", cam, "Look At")
    _wire(g, cam, "Camera", scene, "Camera")

    # sphere: BSDF glass, radius 0.5 * 1.5, a scaled and rotated transform
    sph = add(M.SphereNode())
    bsdf = add(M.MaterialBSDFNode())
    col = add(M.ColorNode(0.9, 0.4, 0.3, 1.0))
    _wire(g, col, "Color", bsdf, "Base Color")
    _wire(g, flt(0.85), "Value", bsdf, "Transmission")
    _wire(g, binop(M.SubNode, 0.35, 0.25), "Result", bsdf, "Roughness")
    _wire(g, vec3(0.2, 0.9, 0.9), "Vector", bsdf, "Absorption")
    _wire(g, bsdf, "Material", sph, "Material")
    _wire(g, binop(M.MulNode, 0.5, 1.5), "Result", sph, "Radius")
    _wire(g, transform((0.6, 0.8, 0.1), (10.0, 20.0, 30.0), (1.0, 1.2, 0.9)), "Transform",
          sph, "Transform")
    # plane: Universal PBR, emissive from a Vector3
    pln = add(M.PlaneNode())
    pbr = add(M.UniversalPBRNode())
    _wire(g, flt(0.3), "Value", pbr, "Metallic")
    _wire(g, vec3(0.01, 0.0, 0.02), "Vector", pbr, "Emissive")
    _wire(g, pbr, "Material", pln, "Material")
    # box: emission material, a combined transform, its size from a Vector3
    box = add(M.BoxNode())
    em = add(M.EmissionMaterialNode())
    v4 = add(M.Vector4Node(1.0, 0.6, 0.2, 1.0))
    _wire(g, v4, "Vector", em, "Emission Color")
    _wire(g, binop(M.DivNode, 3.0, 4.0), "Result", em, "Strength")
    _wire(g, em, "Material", box, "Material")
    comb = add(M.CombineTransformNode())
    _wire(g, transform((-1.2, 0.5, 0.6), (0.0, 35.0, 10.0), (1.0, 1.0, 1.0)), "Transform",
          comb, "Parent")
    _wire(g, transform((0.1, 0.05, 0.0), (5.0, 0.0, 0.0), (0.8, 1.0, 1.1)), "Transform",
          comb, "Local")
    _wire(g, comb, "Transform", box, "Transform")
    _wire(g, vec3(0.7, 0.9, 0.5), "Vector", box, "Size")
    # meshes: a glass BigSphere, and an instance of a mesh nobody holds
    fbx = add(M.FBXMeshNode("BigSphere"))
    fbx.object_transform = p.T(position=np.array([1.6, 0.9, 1.4]), scale=S.OUTWARD)
    fmat = add(M.MaterialBSDFNode())
    fmat.metallic, fmat.roughness = 0.2, 0.4
    _wire(g, fmat, "Material", fbx, "Material")
    missing = add(M.FBXMeshNode("Missing"))
    for i, obj in enumerate((sph, pln, box, fbx, missing)):
        _wire(g, obj, "Object", scene, f"Object{i + 1}")
    # lights
    pt = add(M.PointLightNode())
    pt.radius = 0.4
    _wire(g, vec3(2.5, 5.0, -2.5), "Vector", pt, "Position")
    _wire(g, flt(14.0), "Value", pt, "Intensity")
    _wire(g, flt(3.0), "Value", pt, "Shadow Samples")
    dl = add(M.DirectionalLightNode())
    _wire(g, vec3(0.4, -1.0, 0.3), "Vector", dl, "Direction")
    _wire(g, add(M.ColorNode(1.0, 0.95, 0.9, 1.0)), "Color", dl, "Color")
    amb = add(M.AmbientLightNode())
    _wire(g, add(M.ColorNode(0.25, 0.25, 0.3, 1.0)), "Color", amb, "Color")
    for i, lt in enumerate((pt, dl, amb)):
        _wire(g, lt, "Light", scene, f"Light{i + 1}")
    return g


def _services():
    return (S.mesh_service(JMC, S.MESH_DEMO_SMALL), S.mesh_service(PMC, S.MESH_DEMO_SMALL))


def _bits_equal(port_flat, jax_flat):
    """Every FlatScene leaf of the port equal in dtype, shape and bytes to
    the JAX package's, and every leaf of the mesh's fine tree."""
    jl = S.jax_leaves(jax_flat)
    jmesh = jl.pop("mesh")
    for name, pv in zip(FlatScene._fields[:-1], port_flat):
        jv = jl[name]
        assert (pv.dtype, pv.shape) == (jv.dtype, jv.shape), name
        assert pv.tobytes() == jv.tobytes(), name
    assert (port_flat.mesh is None) == (jmesh is None)
    if jmesh is not None:
        for name, jv in jmesh.items():
            pv = getattr(port_flat.mesh, name, None)
            if isinstance(pv, np.ndarray):
                assert (pv.dtype, pv.shape) == (jv.dtype, jv.shape), name
                assert pv.tobytes() == jv.tobytes(), f"mesh.{name}"


def _load_both(path, services=(None, None)):
    """(port SceneData, JAX SceneData, port FlatScene, JAX FlatScene) of the
    file, each package resolving FBX names through its own service."""
    out = []
    for p, svc in ((PORT, services[1]), (JAX, services[0])):
        resolver = svc.get_mesh if svc is not None else None
        scene = p.E.evaluate_scene(p.R.load_graph(path, mesh_resolver=resolver))
        out.append(scene)
    flats = [p.flatten(p.sanitize(sc), aspect=2.0, mesh_service=svc)
             for p, sc, svc in ((PORT, out[0], services[1]), (JAX, out[1], services[0]))]
    return (*out, *flats)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_every_node_type_loads_bit_equal(writer, tmp_path):
    """The all-node-types graph, written by one package, loads in both to
    bit-equal FlatScene leaves; the FBX node of a missing mesh is dropped,
    the BigSphere instance resolved."""
    w = JAX if writer == "jax" else PORT
    path = str(tmp_path / "all.rtvs")
    w.R.save_graph(all_nodes_graph(w), path)
    pscene, jscene, pflat, jflat = _load_both(path, _services())
    assert [type(o).__name__ for o in pscene.objects] == \
        ["SphereData", "PlaneData", "BoxData", "MeshObjectData"]
    assert [type(o).__name__ for o in jscene.objects] == \
        [type(o).__name__ for o in pscene.objects]
    assert len(pscene.lights) == 3 and pflat.mesh is not None
    _bits_equal(pflat, jflat)


@pytest.mark.parametrize("frame", [0, 2])
@pytest.mark.parametrize("name", ["demo", "mesh_demo"])
def test_scene_graph_round_trip_is_the_in_code_scene(name, frame, tmp_path):
    """The demo and mesh demo scenes as .rtvs files (tests/_torch_scenes.py::
    scene_graph, the port's save_graph): both packages load them to the
    leaves of the in-code scene (its directional light normalized, as_evaluated)."""
    build = S.mesh_demo_scene if name == "mesh_demo" else S.demo_scene
    jsvc, psvc = _services() if name == "mesh_demo" else (None, None)
    path = str(tmp_path / "scene.rtvs")
    PR.save_graph(S.scene_graph(PM, PG, build(PD, frame), [S.DEMO_BOX_QUAT]), path)
    _, _, pflat, jflat = _load_both(path, (jsvc, psvc))
    _bits_equal(pflat, jflat)
    want = flatten_scene(sanitize_scene(S.as_evaluated(build(PD, frame))), aspect=2.0,
                         mesh_service=psvc)
    for name_, a, b in zip(FlatScene._fields[:-1], pflat, want):
        assert a.tobytes() == b.tobytes(), name_


def _doc(*nodes):
    return {"Version": "1.0", "Connections": [], "Nodes": [
        {"Id": f"00000000-0000-0000-0000-00000000000{i + 1}", "Type": t, "Title": t,
         "PositionX": 0, "PositionY": 0, "Properties": props} for i, (t, props) in enumerate(nodes)]}


DOCS = {
    "legacy_lightnode": _doc(("LightNode", {"LightPosition": {"X": 1, "Y": 2, "Z": 3},
                                            "Intensity": 2.0})),
    "no_scene_node": _doc(("SphereNode", {"Radius": 2.0}),
                          ("CameraNode", {"CameraPosition": {"X": 0, "Y": 0, "Z": -9}}),
                          ("PointLightNode", {"Position": {"X": 0, "Y": 3, "Z": 0}}),
                          ("BoxNode", {"Transform": {"Position": {"X": 1, "Y": 0.5, "Z": 0},
                                                     "Rotation": {"X": 0, "Y": 0, "Z": 0,
                                                                  "W": 0}},
                                       "Size": {"X": 1, "Y": 2, "Z": 1}}),
                          ("FBXMeshNode", {"MeshName": "BigSphere"}),
                          ("FBXMeshNode", {"MeshName": "Missing"})),
}


@pytest.mark.parametrize("name", list(DOCS))
def test_documents_load_bit_equal(name):
    """Hand-written documents: a legacy LightNode (a point light), and a
    graph without a SceneNode, whose objects, lights and camera are
    harvested (a zero quaternion reads as the identity; the missing mesh's
    node is dropped)."""
    pscene, jscene, pflat, jflat = _load_both(DOCS[name], _services())
    _bits_equal(pflat, jflat)
    assert len(pscene.lights) == len(jscene.lights) == 1
    assert int(pscene.lights[0].type) == 1
    if name == "no_scene_node":
        assert [type(o).__name__ for o in pscene.objects] == \
            ["SphereData", "BoxData", "MeshObjectData"]
        np.testing.assert_array_equal(pscene.camera.position, [0, 0, -9])


def test_copy_paste_between_packages():
    """A clipboard copied in one package pastes in the other: the same
    nodes, properties and the one intra-selection connection."""
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        g = src.G.NodeGraph()
        mat = g.add_node(src.M.MaterialBSDFNode())
        mat.transmission = 0.7
        sph = g.add_node(src.M.SphereNode())
        sph.radius, sph.position = 2.5, (100.0, 50.0)
        g.connect(mat.find_output("Material"), sph.find_input("Material"))
        clip = src.R.copy_nodes(g, [mat, sph])
        h = dst.G.NodeGraph()
        new = dst.R.paste_nodes(h, clip)
        assert [type(n).__name__ for n in new] == ["MaterialBSDFNode", "SphereNode"]
        assert (new[0].transmission, new[1].radius, new[1].position) == \
            (0.7, 2.5, (130.0, 80.0))
        assert len(h.connections) == 1 and h.connections[0].input_node is new[1]
        assert dst.R.copy_nodes(h, new) == {**clip, "Nodes": [
            dict(nd, Id=str(n.id), PositionX=nd["PositionX"] + 30.0,
                 PositionY=nd["PositionY"] + 30.0)
            for nd, n in zip(clip["Nodes"], new)],
            "Connections": [dict(c, OutputNodeId=str(new[0].id), InputNodeId=str(new[1].id))
                            for c in clip["Connections"]]}


def test_engine_load_rtvs_matches_jax(tmp_path):
    """Engine(64, 32, device="cpu").load_rtvs of the demo scene's file (the
    JAX save_graph's) against the JAX Engine's, one frame, in
    test_torch_engine.py's band."""
    from test_torch_engine import _assert_frame_matches

    path = str(tmp_path / "demo.rtvs")
    JR.save_graph(S.scene_graph(JM, JG, S.demo_scene(PD), [S.DEMO_BOX_QUAT]), path)
    pe = Engine(64, 32, device="cpu")
    je = JEngine(64, 32, backend="jnp", device_mesh=None)
    pg = pe.load_rtvs(path, **S.DEMO_OVERRIDES)
    je.load_rtvs(path, **S.DEMO_OVERRIDES)
    assert isinstance(pg, PG.NodeGraph)
    fr = dict(pimg=pe.render(), jimg=je.render(), prays=pe.last_rays, jrays=je.last_rays,
              phdr=pe.last_hdr, jhdr=je.last_hdr)
    _assert_frame_matches(fr)


@pytest.mark.parametrize("tier", ["env", "Resource/Model", "Model"])
def test_engine_finds_the_model_directory(tier, tmp_path, monkeypatch):
    """An Engine without a mesh service takes the first model directory of
    $RAYTRACEVS_MODEL_PATH, Resource/Model and Model beside the file, as the
    JAX Engine does, and drops the FBX nodes whose mesh it lacks; the mesh
    cache goes under the cache directory the caller gives."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))  # the JAX Engine's mesh cache
    monkeypatch.delenv("RAYTRACEVS_MODEL_PATH", raising=False)
    models = tmp_path / "models" if tier == "env" else tmp_path / tier
    models.mkdir(parents=True)
    if tier == "env":
        monkeypatch.setenv("RAYTRACEVS_MODEL_PATH", str(models))
    path = str(tmp_path / "all.rtvs")
    JR.save_graph(all_nodes_graph(JAX), path)
    pe = Engine(16, 8, device="cpu")
    je = JEngine(16, 8, backend="jnp", device_mesh=None)
    pg, jg = pe.load_rtvs_graph(path, str(tmp_path / "cache")), je.load_rtvs_graph(path)
    assert pe.mesh_service.model_dir == je.mesh_service.model_dir == str(models)
    assert pe.mesh_service.cache_dir == str(tmp_path / "cache" / "meshcache")
    assert os.path.isdir(pe.mesh_service.cache_dir)
    assert [n.type_name for n in pg.nodes] == [n.type_name for n in jg.nodes]
    assert "FBXMeshNode" not in [n.type_name for n in pg.nodes]


def test_render_rtvs_runs_on_the_card(tmp_path):
    """render_rtvs builds Engine(w, h): on the card, so it raises without one."""
    from raytracevs_tpu_torch.runtime.engine import render_rtvs

    path = str(tmp_path / "demo.rtvs")
    PR.save_graph(S.scene_graph(PM, PG, S.demo_scene(PD), [S.DEMO_BOX_QUAT]), path)
    if torch.cuda.is_available():
        assert render_rtvs(path, 16, 8).shape == (8, 16, 4)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            render_rtvs(path, 16, 8)
