"""The port's mesh input (raytracevs_tpu_torch/io/{fbx,mesh_cache}.py) vs
raytracevs_tpu.io on the CPU: the .mesh format, the cache service with its
suffix fallback, and FBX import of the binary and ASCII containers. Every
result is exact."""
import numpy as np
import pytest

import _torch_scenes as S
from raytracevs_tpu.io import fbx as JF
from raytracevs_tpu.io import mesh_cache as JMC
from raytracevs_tpu_torch.io import fbx as PF
from raytracevs_tpu_torch.io import mesh_cache as PMC
from test_fbx_binary import _cube, _cube_ascii, _tree, write_binary_fbx

S.one_torch_thread()


def _assert_mesh_equal(a, b):
    for f in ("vertices", "indices", "bounds_min", "bounds_max"):
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_mesh_file_round_trip_matches_jax(tmp_path):
    verts, idx = S.uv_sphere(6, 7, 0.8)
    lo, hi = np.full(3, -0.8, np.float32), np.full(3, 0.8, np.float32)
    PMC.write_mesh_cache(str(tmp_path / "p.mesh"), verts, idx, lo, hi)
    JMC.write_mesh_cache(str(tmp_path / "j.mesh"), verts, idx, lo, hi)
    assert (tmp_path / "p.mesh").read_bytes() == (tmp_path / "j.mesh").read_bytes()
    got = PMC.read_mesh_cache(str(tmp_path / "j.mesh"))
    _assert_mesh_equal(got, JMC.read_mesh_cache(str(tmp_path / "p.mesh")))
    assert got.name == "j" and got.vertex_count == len(verts) // 8
    np.testing.assert_array_equal(got.positions, verts.reshape(-1, 8)[:, 0:3])
    (tmp_path / "bad.mesh").write_bytes(b"NOPE" + bytes(40))
    with pytest.raises(ValueError, match="magic"):
        PMC.read_mesh_cache(str(tmp_path / "bad.mesh"))
    with pytest.raises(ValueError):
        PMC.write_mesh_cache(str(tmp_path / "odd.mesh"), verts[:-1], idx, lo, hi)


def test_interleave_matches_jax():
    rng = np.random.RandomState(0)
    p, n = rng.randn(11, 3).astype(np.float32), rng.randn(11, 3).astype(np.float32)
    np.testing.assert_array_equal(PMC.interleave(p, n), JMC.interleave(p, n))


def test_mesh_service_suffix_fallback_matches_jax():
    """"WineGlass2" falls back to "WineGlass", re-expressed in the legacy
    export convention; exact names win; unknown names give None."""
    verts, idx = S.uv_sphere(5, 8, 0.5)
    services = []
    for MC in (PMC, JMC):
        ms = MC.MeshCacheService(".")
        ms.register("WineGlass", MC.CachedMesh("WineGlass", verts.copy(), idx.copy(),
                                               np.full(3, -0.5), np.full(3, 0.5)))
        services.append(ms)
    p, j = (ms.get_mesh("WineGlass2") for ms in services)
    _assert_mesh_equal(p, j)
    assert p.name == "WineGlass2" and not np.array_equal(p.vertices, verts)
    assert services[0].has_mesh("WineGlass2") and services[0].get_mesh("Teapot") is None
    assert services[0].get_mesh("WineGlass").vertices is not p.vertices
    assert services[0].mesh_names() == services[1].mesh_names() == ["WineGlass", "WineGlass2"]


@pytest.mark.parametrize("container", ["ascii", "binary7400", "binary7500_zlib"])
def test_fbx_cube_import_matches_jax(tmp_path, container):
    path = tmp_path / "cube.fbx"
    if container == "ascii":
        path.write_text(_cube_ascii())
    else:
        path.write_bytes(write_binary_fbx(_tree([_cube()]), version=int(container[6:10]),
                                          compress=container.endswith("zlib")))
    p, j = PF.load_fbx(str(path)), JF.load_fbx(str(path))
    for f in ("vertices", "normals", "indices", "bounds_min", "bounds_max"):
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert p.indices.size == 36 and len(p.vertices) == 8


def test_cache_service_scan_converts_fbx_like_jax(tmp_path):
    """initialize() converts each FBX of the model directory to a .mesh,
    writes the manifest and serves the mesh: the same bytes as the JAX
    package's, and an unreadable FBX is skipped."""
    models = tmp_path / "models"
    models.mkdir()
    (models / "Cube.fbx").write_bytes(write_binary_fbx(_tree([_cube()]), compress=True))
    (models / "Broken.fbx").write_text("not an fbx at all")
    got = {}
    for name, MC in (("port", PMC), ("jax", JMC)):
        ms = MC.MeshCacheService(str(models), cache_dir=str(tmp_path / name))
        ms.initialize()
        got[name] = ms
        assert ms.mesh_names() == ["Cube"]
    assert ((tmp_path / "port" / "Cube.mesh").read_bytes()
            == (tmp_path / "jax" / "Cube.mesh").read_bytes())
    _assert_mesh_equal(got["port"].get_mesh("Cube"), got["jax"].get_mesh("Cube"))
    assert got["port"].get_mesh("Broken") is None
