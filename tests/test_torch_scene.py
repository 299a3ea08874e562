"""Port host layer vs the JAX package: constants, sanitize, flatten,
make_config, checksums and the FlatScene bridge, exact leaf by leaf."""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu import constants as JC
from raytracevs_tpu.io import mesh_cache as JMC
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu.scene.flatten import flatten_scene as j_flatten
from raytracevs_tpu.scene.flatten import make_config as j_make_config
from raytracevs_tpu.scene.sanitize import sanitize_scene as j_sanitize
from raytracevs_tpu.utils import checksum as j_checksum
from raytracevs_tpu_torch import constants as PC
from raytracevs_tpu_torch.bridge import flat_from_numpy
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.ops import bvh as PB
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import (FlatScene, flatten_scene, leaf_layout, leaf_views,
                                                make_config, pack_leaves, to_device)
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene
from raytracevs_tpu_torch.utils import checksum as p_checksum

S.one_torch_thread()

SCENES = ("demo",) + S.GOLDEN
# scenes with meshes: (builder, mesh service contents)
MESH_SCENES = {
    "glass_ball": (lambda D: S.glass_ball_scene(D), {"GlassBall": (9, 9, 0.7)}),
    "opaque_ball": (lambda D: S.glass_ball_scene(D, opaque=True), {"GlassBall": (9, 9, 0.7)}),
    "nine_balls": (S.nine_ball_scene, {"Ball": (6, 8, 0.3)}),
    "mesh_demo": (S.mesh_demo_scene, S.MESH_DEMO_SMALL),
}


def _mesh_pair(name, **kw):
    """(JAX FlatScene, port FlatScene) of a mesh scene, flattened alike."""
    build, meshes = MESH_SCENES[name]
    jf = j_flatten(j_sanitize(build(JD)), mesh_service=S.mesh_service(JMC, meshes), **kw)
    pf = flatten_scene(sanitize_scene(build(PD)), mesh_service=S.mesh_service(PMC, meshes), **kw)
    return jf, pf


def _pair(name, frame_aspect=16 / 9):
    js, jo = S.scene_and_overrides(JD, name)
    ps, po = S.scene_and_overrides(PD, name)
    return js, ps, jo, po


def _assert_leaves_equal(port_flat, jax_flat):
    """Every FlatScene leaf equal, and every fine-tree leaf of the mesh."""
    jl = S.jax_leaves(jax_flat)
    assert list(jl) == list(FlatScene._fields)
    jmesh = jl.pop("mesh")
    for name, pv in zip(FlatScene._fields[:-1], port_flat):
        jv = jl[name]
        assert pv.dtype == jv.dtype, name
        assert pv.shape == jv.shape, name
        np.testing.assert_array_equal(pv, jv, err_msg=name)
    assert (port_flat.mesh is None) == (jmesh is None)
    if jmesh is not None:
        for name in PB.FINE_FIELDS:
            pv, jv = getattr(port_flat.mesh, name), jmesh[name]
            assert pv.dtype == jv.dtype and pv.shape == jv.shape, name
            np.testing.assert_array_equal(pv, jv, err_msg=f"mesh.{name}")


def test_constants_match():
    names = [n for n in dir(JC) if n.isupper()]
    assert names == [n for n in dir(PC) if n.isupper()]
    for n in names:
        assert getattr(JC, n) == getattr(PC, n), n


@pytest.mark.parametrize("name", SCENES)
def test_flatten_matches_jax_leaf_by_leaf(name):
    js, ps, _, _ = _pair(name)
    prev = np.arange(16, dtype=np.float32).reshape(4, 4) * 0.1
    jf = j_flatten(j_sanitize(js), frame_index=7, aspect=2.0, prev_view_proj=prev)
    pf = flatten_scene(sanitize_scene(ps), frame_index=7, aspect=2.0, prev_view_proj=prev)
    _assert_leaves_equal(pf, jf)


@pytest.mark.parametrize("name", list(MESH_SCENES))
def test_flatten_with_meshes_matches_jax_leaf_by_leaf(name):
    """Instance material rows at S+P+B+i, the instance forest's fine tree
    (BVH build, retransform, chaining) and the instance tables exact."""
    jf, pf = _mesh_pair(name, frame_index=5, aspect=1.5)
    assert pf.mesh is not None
    _assert_leaves_equal(pf, jf)
    n_inst = pf.mesh.num_inst
    assert pf.mat_color.shape[0] == (pf.sphere_capacity + pf.plane_capacity + pf.box_capacity
                                     + n_inst)


def test_flatten_skips_instances_without_a_mesh():
    """A mesh the service does not have drops its instance, as in the JAX
    package; no service drops every instance."""
    s = S.mesh_demo_scene(PD)
    s.objects[-1].mesh_name = "Missing"
    pf = flatten_scene(sanitize_scene(s), mesh_service=S.mesh_service(PMC, S.MESH_DEMO_SMALL))
    assert pf.mesh.num_inst == 1
    assert flatten_scene(sanitize_scene(s)).mesh is None


@pytest.mark.parametrize("name", SCENES + ("config5_caustics_denoise",))
def test_make_config_matches_jax(name):
    js, ps, jo, po = _pair(name)
    assert make_config(ps, 64, 32, **po)._asdict() == j_make_config(js, 64, 32, **jo)._asdict()


@pytest.mark.parametrize("name", SCENES)
def test_content_checksum_matches_jax(name):
    js, ps, _, _ = _pair(name)
    assert p_checksum.scene_content_checksum(ps) == j_checksum.scene_content_checksum(js)
    ps.objects[1].position = ps.objects[1].position + 0.5
    assert p_checksum.scene_content_checksum(ps) != j_checksum.scene_content_checksum(js)


def test_sanitize_matches_jax_on_bad_inputs():
    def build(D):
        s = D.SceneData()
        s.camera.field_of_view = float("nan")
        s.objects += [
            D.SphereData(position=np.array([np.inf, 1.0, 2e5]), radius=-1.0,
                         material=D.MaterialData(base_color=np.array([2.0, np.nan, 0.5, 1.0]),
                                                 ior=9.0, absorption=np.array([-1.0, 200.0, 3.0]))),
            D.PlaneData(normal=np.array([0.0, 0.0, 0.0])),
            D.BoxData(size=np.array([0.0, 5.0, np.nan])),
        ]
        s.lights += [D.LightData(intensity=5000.0, radius=np.nan, soft_shadow_samples=40.0)]
        return s

    def flat(x):
        if dataclasses.is_dataclass(x):
            return [flat(getattr(x, f.name)) for f in dataclasses.fields(x)]
        if isinstance(x, list):
            return [flat(v) for v in x]
        return np.asarray(x, dtype=np.float64).tolist() if not isinstance(x, str) else x

    assert flat(sanitize_scene(build(PD))) == flat(j_sanitize(build(JD)))


@pytest.mark.parametrize("name", SCENES)
def test_flat_from_numpy_matches_port_flatten(name):
    js, ps, _, _ = _pair(name)
    jf = j_flatten(j_sanitize(js), frame_index=2)
    bridged = flat_from_numpy(S.jax_leaves(jf))
    own = flatten_scene(sanitize_scene(ps), frame_index=2)
    assert bridged.mesh is None and own.mesh is None
    for name_, a, b in zip(FlatScene._fields[:-1], bridged, own):
        assert a.dtype == b.dtype, name_
        np.testing.assert_array_equal(a, b, err_msg=name_)


@pytest.mark.parametrize("name", ["glass_ball", "nine_balls"])
def test_flat_from_numpy_takes_jax_mesh_leaves(name):
    """The bridge takes the JAX MeshArrays' fine-tree leaves and leaves its
    fat-leaf mk_* leaves behind."""
    jf, pf = _mesh_pair(name, frame_index=2)
    leaves = S.jax_leaves(jf)
    assert any(k.startswith("mk_") for k in leaves["mesh"])
    bridged = flat_from_numpy(leaves)
    assert bridged.mesh._fields == PB.MeshArrays._fields and bridged.mesh.plane is None
    _assert_leaves_equal(bridged, jf)


def test_flat_from_numpy_rejects_mesh_and_missing_leaves():
    """A mesh leaf that is not a dict of the fine-tree leaves, or a missing
    scene leaf, raises."""
    leaves = S.jax_leaves(j_flatten(j_sanitize(S.demo_scene(JD))))
    with pytest.raises(ValueError, match="mesh"):
        flat_from_numpy(dict(leaves, mesh=np.zeros(3)))
    with pytest.raises(ValueError, match="mesh"):
        flat_from_numpy(dict(leaves, mesh={"v0": np.zeros((1, 3), np.float32)}))
    leaves.pop("cam_pos")
    with pytest.raises(ValueError):
        flat_from_numpy(leaves)


def test_to_device_keeps_values():
    _, pf = _mesh_pair("glass_ball", frame_index=2**32 - 1)
    t = to_device(pf, "cpu")
    for name, a, b in zip(FlatScene._fields[:-1], pf, t):
        assert torch.is_tensor(b), name
        assert tuple(b.shape) == np.asarray(a).shape, name
        np.testing.assert_array_equal(np.asarray(a).astype(b.numpy().dtype), b.numpy(), err_msg=name)
    assert t.frame_index.dtype == torch.int64 and int(t.frame_index) == 2**32 - 1
    for name in PB.FINE_FIELDS:
        a, b = getattr(pf.mesh, name), getattr(t.mesh, name)
        assert b.dtype == torch.from_numpy(a).dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    # the derived tables: 12 floats a triangle, and the shadow factor
    # exp(-absorption * 1 * shadow_absorption_scale) of the absorbing ball
    assert t.mesh.plane.shape == (pf.mesh.num_tris, 12)
    want = np.exp(-pf.mesh.inst_absorption.astype(np.float64) * float(pf.shadow_absorption_scale))
    np.testing.assert_allclose(t.mesh.inst_beer.numpy(), want, rtol=1e-6)
    assert to_device(flatten_scene(sanitize_scene(S.demo_scene(PD))), "cpu").mesh is None


@pytest.mark.parametrize("name", ["demo", "mesh_demo"])
def test_packed_leaves_match_the_per_leaf_copy(name):
    """to_device's packed block (its CUDA path), built here on a CPU byte
    tensor: each of the 47 leaves at a 16-byte-aligned offset of its own,
    and its view of the block with the dtype, shape and values of the
    per-leaf copy (the CPU path), contiguous; the 0-d leaves 0-d, the bool
    leaves bool, a frame index past 2**31 widened to int64. The CPU path
    counts no packed copy."""
    frame = 2**31 + 7
    svc = S.mesh_service(PMC, S.MESH_DEMO_SMALL) if name == "mesh_demo" else None
    build = S.mesh_demo_scene if name == "mesh_demo" else S.demo_scene
    pf = flatten_scene(sanitize_scene(build(PD, 3)), frame_index=frame, mesh_service=svc)
    assert (pf.mesh is None) == (name == "demo")
    copies = to_device.copies
    want = to_device(pf, "cpu")
    assert to_device.copies == copies
    leaves = [np.asarray(a) for a in pf[:-1]]
    layout = leaf_layout(leaves)
    spans = sorted((layout.record.fields[f][1], layout.record.fields[f][0].itemsize)
                   for f in layout.record.names)
    assert len(spans) == len(FlatScene._fields) - 1 == 47
    assert all(off % 16 == 0 for off, _ in spans) and layout.nbytes % 16 == 0
    assert all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:] + [(layout.nbytes, 0)]))
    block = torch.full((layout.nbytes,), 0xA5, dtype=torch.uint8)
    pack_leaves(leaves, layout, block.numpy())
    views = leaf_views(block, layout)
    assert len(views) == 47
    for field, v, w in zip(FlatScene._fields, views, want):
        assert v.dtype == w.dtype and v.shape == w.shape, field
        assert v.is_contiguous() and torch.equal(v, w), field
        assert v.untyped_storage().data_ptr() == block.untyped_storage().data_ptr(), field
    got = FlatScene(*views)
    assert got.frame_index.dtype == torch.int64 and got.frame_index.dim() == 0
    assert int(got.frame_index) == frame
    assert got.tan_half_fov.dim() == 0 and got.num_lights.dtype == torch.int32
    assert got.sph_valid.dtype == got.lt_valid.dtype == torch.bool
    assert got.box_axes.shape == want.box_axes.shape and got.box_axes.dim() == 3
    assert leaf_layout(leaves) is layout  # one layout per set of capacities


def test_mesh_instance_raises_in_flatten_and_make_config_rejects_caustics():
    """A mesh without triangles raises in the BVH build, as in the JAX
    package; caustics are ported: make_config takes the JAX package's
    photon budget, and a photon debug mode and its scale as the JAX
    package's make_config does."""
    s = S.demo_scene(PD)
    s.objects.append(PD.MeshObjectData(mesh_name="Empty"))
    empty = PMC.MeshCacheService(".")
    empty.register("Empty", PMC.CachedMesh("Empty", np.zeros(8, np.float32),
                                           np.zeros(0, np.uint32), np.zeros(3), np.zeros(3)))
    with pytest.raises(ValueError, match="empty triangle list"):
        flatten_scene(s, mesh_service=empty)
    c = S.demo_scene(PD)
    want = j_make_config(j_sanitize(S.demo_scene(JD)), 8, 8, enable_caustics=True).num_photons
    assert make_config(c, 8, 8, enable_caustics=True).num_photons == want == 16384
    assert make_config(c, 8, 8).num_photons == 0
    c.settings.photon_debug_mode, c.settings.photon_debug_scale = 1, 4.0
    j = S.demo_scene(JD)
    j.settings.photon_debug_mode, j.settings.photon_debug_scale = 1, 4.0
    got = make_config(c, 8, 8, enable_caustics=True)
    assert (got.photon_debug_mode, got.photon_debug_scale, got.num_photons) == (1, 4.0, 16384)
    assert got._asdict() == j_make_config(j_sanitize(j), 8, 8, enable_caustics=True)._asdict()
    assert make_config(c, 8, 8, photon_debug_mode=3).photon_debug_mode == 3
