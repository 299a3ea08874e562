"""The Engine's mesh caches (ops/bvh.py::BLASCache) on the CPU, on the
small mesh demo scene: an orbit keeps its world instances, its forest and
its device tables, and every frame is bit-equal to that of an Engine that
rebuilds everything on every update (a new BLASCache before each
update_scene), on the main path, the two-phase path and the sharded path.
An edit redoes only what depends on it: a moved instance is retransformed
alone, a material edit makes the MeshArrays again and retransforms nothing,
a new shadow absorption scale uploads the tables again, new mesh content
runs the SAH build again. The mesh spans nest under flatten and to_device."""
import types
import zlib

import numpy as np
import pytest
import torch

import _torch_scenes as S
import test_torch_spans as TS
from raytracevs_tpu_torch import BLASCache, Engine
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.ops import bvh as B
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import flatten_scene, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

S.one_torch_thread()

W, H = 32, 16
FRAMES = 4
PATHS = {"main": ({}, {}),
         "two_phase": ({"two_phase": True}, {"samples_per_pixel": 1}),
         "sharded": ({"device_mesh": ["cpu"] * 2}, {})}


def engine(**kw):
    return Engine(W, H, device="cpu", mesh_service=S.mesh_service(PMC, S.MESH_DEMO_SMALL), **kw)


def counters(cache):
    return (cache.build_count, cache.retransform_count, cache.combine_count,
            cache.upload_count)


def history(eng):
    state = eng._denoise_state
    return [s.packed for s in state] if isinstance(state, list) else [state.packed]


@pytest.mark.parametrize("path", list(PATHS))
def test_orbit_frames_equal_a_rebuilding_engine(path, monkeypatch):
    """FRAMES orbit frames: RGBA8, ray counts and denoiser history bit-equal
    to the rebuilding Engine's; one SAH build a mesh, one retransform an
    instance, one combine, one device-table build, and one fingerprint a
    mesh array (the service hands out the same arrays every update)."""
    kw, over = PATHS[path]
    over = dict(S.DEMO_OVERRIDES, **over)
    crcs = []
    monkeypatch.setattr(B, "zlib", types.SimpleNamespace(
        crc32=lambda data: crcs.append(1) or zlib.crc32(data)))
    kept, fresh = engine(**kw), engine(**kw)
    for f in range(FRAMES):
        kept.update_scene(S.mesh_demo_scene(PD, f), **over)
        fresh._blas_cache = BLASCache()
        fresh.update_scene(S.mesh_demo_scene(PD, f), **over)
        a, b = kept.render(), fresh.render()
        assert np.array_equal(a, b), f
        assert kept.last_rays == fresh.last_rays > 0
        ha, hb = history(kept), history(fresh)
        assert len(ha) == len(hb) and all(torch.equal(x, y) for x, y in zip(ha, hb))
    assert counters(kept._blas_cache) == (2, 2, 1, 1)
    assert len(crcs) == 2 * 3 + 2 * 3 * FRAMES  # kept: 3 arrays a mesh once; fresh: each update
    assert a[..., :3].std() > 10


def update(eng, scene):
    eng.update_scene(scene, **S.DEMO_OVERRIDES)
    return counters(eng._blas_cache)


def assert_tables_fresh(eng):
    """The Engine's host and device mesh tables equal a fresh flatten's."""
    clean = sanitize_scene(eng._scene)
    want = flatten_scene(clean, aspect=W / H, mesh_service=eng.mesh_service)
    got = eng._flat.mesh
    for f in B.FINE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want.mesh, f), err_msg=f)
    dw = to_device(want, "cpu").mesh
    for f in B.FINE_FIELDS + ("plane", "inst_beer", "wide"):
        a, b = getattr(eng._scene_t.mesh, f), getattr(dw, f)
        assert torch.equal(a.view(torch.int32) if f == "wide" else a,
                           b.view(torch.int32) if f == "wide" else b), f


def test_moving_one_instance_retransforms_it_alone():
    eng = engine()
    scene = S.mesh_demo_scene(PD, 0)
    assert update(eng, scene) == (2, 2, 1, 1)
    big = eng._blas_cache._world[0][2]
    scene.objects[-1].transform.position = np.array([-1.0, 0.7, -1.3])  # GlassBall
    assert update(eng, scene) == (2, 3, 2, 2)
    assert eng._blas_cache._world[0][2] is big
    assert_tables_fresh(eng)
    assert update(eng, scene) == (2, 3, 2, 2)


def test_material_edit_makes_the_arrays_again_and_retransforms_nothing():
    eng = engine()
    scene = S.mesh_demo_scene(PD, 0)
    update(eng, scene)
    host, worlds = eng._flat.mesh, [w[2] for w in eng._blas_cache._world]
    glass = scene.objects[-1].material
    glass.absorption = np.array([0.1, 0.3, 0.6])
    assert update(eng, scene) == (2, 2, 2, 2)
    assert eng._flat.mesh is not host
    assert all(w[2] is x for w, x in zip(eng._blas_cache._world, worlds))
    assert_tables_fresh(eng)
    glass.transmission = 0.5
    assert update(eng, scene) == (2, 2, 3, 3)
    assert_tables_fresh(eng)


def test_scene_without_meshes_releases_the_forest():
    """An update with no mesh instance drops the instances, the forest and
    its device tables; the object-space BLASes stay, so the meshes' return
    builds nothing."""
    eng = engine()
    scene = S.mesh_demo_scene(PD, 0)
    update(eng, scene)
    bare = S.mesh_demo_scene(PD, 0)
    bare.objects = [o for o in bare.objects if not isinstance(o, PD.MeshObjectData)]
    assert update(eng, bare) == (2, 2, 1, 1)
    c = eng._blas_cache
    assert eng._scene_t.mesh is None and not c._world
    assert c._arrays[2] is None and c._device[2] is None and c._combined[1] is None
    assert update(eng, scene) == (2, 4, 2, 2)
    assert_tables_fresh(eng)


def test_new_shadow_absorption_scale_rebuilds_the_device_tables():
    eng = engine()
    scene = S.mesh_demo_scene(PD, 0)
    update(eng, scene)
    host, beer = eng._flat.mesh, eng._scene_t.mesh.inst_beer
    scene.settings.shadow_absorption_scale = 2.0
    assert update(eng, scene) == (2, 2, 1, 2)
    assert eng._flat.mesh is host
    assert not torch.equal(eng._scene_t.mesh.inst_beer, beer)
    assert_tables_fresh(eng)


def test_new_mesh_content_runs_the_sah_build_again():
    """Re-registering a mesh with the same content fingerprints it again and
    builds nothing; with new content it runs the SAH build and retransforms
    that mesh's instance alone."""
    eng = engine()
    scene = S.mesh_demo_scene(PD, 0)
    update(eng, scene)
    svc = eng.mesh_service
    same = S.mesh_service(PMC, {"GlassBall": S.MESH_DEMO_SMALL["GlassBall"]})
    svc.register("GlassBall", same.get_mesh("GlassBall"))
    assert update(eng, scene) == (2, 2, 1, 1)
    bigger = S.mesh_service(PMC, {"GlassBall": (8, 12, 0.7)})
    svc.register("GlassBall", bigger.get_mesh("GlassBall"))
    assert update(eng, scene) == (3, 3, 2, 2)
    assert_tables_fresh(eng)


def test_mesh_spans_nest_under_flatten_and_to_device():
    eng = engine()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.update_scene(S.mesh_demo_scene(PD, 0), **S.DEMO_OVERRIDES)
    spans = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("rtvs.")]
    (tree,) = TS.span_trees(spans)
    assert [(s, p) for s, p, _ in tree] == [
        ("rtvs.update_scene", None), ("rtvs.scene.sanitize", "rtvs.update_scene"),
        ("rtvs.scene.flatten", "rtvs.update_scene"), ("rtvs.scene.mesh", "rtvs.scene.flatten"),
        ("rtvs.scene.mesh.blas", "rtvs.scene.mesh"),
        ("rtvs.scene.mesh.retransform", "rtvs.scene.mesh"),
        ("rtvs.scene.mesh.combine", "rtvs.scene.mesh"),
        ("rtvs.scene.checksum", "rtvs.update_scene"),
        ("rtvs.scene.to_device", "rtvs.update_scene"),
        ("rtvs.scene.to_device.mesh", "rtvs.scene.to_device")]
