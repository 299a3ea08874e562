"""The port's BVH (raytracevs_tpu_torch/ops/bvh.py and io/native.py) vs
raytracevs_tpu.ops.bvh on the CPU.

Builds are exact: the same native binned-SAH builder, retransform and
chaining give the same arrays, leaf by leaf. The walks are held against the
JAX walks run one operation at a time (jax.disable_jit) on 4096 seeded rays:
hit, triangle and instance exact; t, u, v, visibility, colour and occluder
distance within 1e-6 (they agree to the bit). The JAX walks compiled whole
contract multiply-adds into FMAs (XLA's whole-program rounding, ROADMAP C5),
which moves u and v by up to ~1e-5 on these rays; the port, like the CUDA
kernel built with --fmad=false, rounds each operation on its own, as the
op-by-op run does."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_scenes as S
from raytracevs_tpu.ops import bvh as J
from raytracevs_tpu_torch.io import native
from raytracevs_tpu_torch.ops import bvh as P
from raytracevs_tpu_torch.scene.transform import Transform, euler_deg_to_quat

S.one_torch_thread()

N_RAYS = 4096
ABSORB_SCALE = 4.0  # the default shadow_absorption_scale
BUILT = ("bbox_min", "bbox_max", "hit_next", "miss_next", "tri_start", "tri_count", "v0",
         "edge1", "edge2", "n0", "n1", "n2", "inst")


class _Mesh:
    """A uv_sphere as the positions/normals/indices a BLASCache reads."""

    def __init__(self, rings, segs, radius):
        verts, self.indices = S.uv_sphere(rings, segs, radius)
        v = verts.reshape(-1, 8)
        self.positions, self.normals = v[:, 0:3], v[:, 4:7]


def _triangles(mesh):
    t = mesh.indices.reshape(-1, 3).astype(np.int64)
    p, n = mesh.positions, mesh.normals
    return (p[t[:, 0]], p[t[:, 1]], p[t[:, 2]], n[t[:, 0]], n[t[:, 1]], n[t[:, 2]],
            np.zeros(len(t), np.int32))


def _forest(mod, count):
    """`count` instances of one ball in a row, built through mod's
    BLASCache, transform_blas and combine_blas."""
    cache = mod.BLASCache()
    blas = cache.get("Ball", _Mesh(9, 9, 0.7))
    worlds = []
    for i in range(count):
        tr = Transform(position=np.array([1.6 * (i - (count - 1) / 2), 0.2 * i, 0.3 * (i % 3)]),
                       rotation=euler_deg_to_quat([10.0 * i, 25.0 * i, 0.0]),
                       scale=np.array([1.0, 1.0 + 0.1 * i, 1.0]))
        worlds.append(mod.transform_blas(blas, tr.matrix(), i))
    return mod.combine_blas(worlds), cache


def _materials(count, opaque=()):
    trans = np.array([0.0 if i in opaque else 0.5 + 0.05 * i for i in range(count)], np.float32)
    ab = np.array([[0.5, 0.2, 0.05] if i % 3 else [0.0, 0.0, 0.0] for i in range(count)],
                  np.float32) * (1.0 + 0.1 * np.arange(count, dtype=np.float32))[:, None]
    return trans, ab


def _jax_mesh(built, trans, ab):
    fine = {f: jnp.asarray(getattr(built, f)) for f in BUILT}
    mk = {f: None for f in J.MeshArrays._fields if f.startswith("mk_")}
    return J.MeshArrays(**fine, inst_transmission=jnp.asarray(trans),
                        inst_absorption=jnp.asarray(ab), **mk)


def _port_mesh(built, trans, ab):
    return P.to_device(P.mesh_arrays(built, trans, ab), "cpu", np.float32(ABSORB_SCALE))


def _rays(built, seed, inside=False):
    """Seeded rays from around the forest toward points near its triangles
    (or, with inside, from inside the balls in random directions)."""
    rng = np.random.RandomState(seed)
    tri = rng.randint(0, len(built.v0), N_RAYS)
    target = built.v0[tri] + 0.3 * built.edge1[tri] + 0.3 * built.edge2[tri]
    target = target + rng.randn(N_RAYS, 3).astype(np.float32) * 0.15
    if inside:
        o = target * 0.5 + rng.randn(N_RAYS, 3).astype(np.float32) * 0.05
        d = rng.randn(N_RAYS, 3)
    else:
        o = target + rng.randn(N_RAYS, 3) * 0.3 + np.array([0.0, 0.4, -3.0])
        d = target - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _eq(got, want, name, atol=None):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, name
    if atol is None:
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def test_uv_sphere_copy_is_bit_equal():
    from test_big_mesh import _uv_sphere

    for args in ((9, 9, 0.7), (5, 7, 1.3), (96, 192, 0.6)):
        for a, b in zip(S.uv_sphere(*args), _uv_sphere(*args)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_build_bvh_matches_jax_leaf_by_leaf():
    tris = _triangles(_Mesh(9, 9, 0.7))
    jb, pb = J.build_bvh(*tris), P.build_bvh(*tris)
    for f in BUILT:
        a, b = getattr(pb, f), getattr(jb, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert pb.tri_count.max() == P.LEAF_SIZE


def test_transform_and_combine_match_jax_on_a_forest():
    """Three instances: object-space build, retransform (rotation, scale,
    translation) and chaining are exact."""
    (jb, _), (pb, _) = _forest(J, 3), _forest(P, 3)
    for f in BUILT:
        a, b = getattr(pb, f), getattr(jb, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert set(pb.inst.tolist()) == {0, 1, 2}


def test_blas_cache_skips_sah_on_transform_edit():
    mesh = _Mesh(5, 6, 1.0)
    cache = P.BLASCache()
    blas = cache.get("Ball", mesh)
    moved = P.transform_blas(cache.get("Ball", mesh), Transform(
        position=np.array([2.0, 0.5, 1.0]), rotation=euler_deg_to_quat([0, 45, 0]),
        scale=np.array([2.0, 1.0, 1.0])).matrix(), 0)
    assert cache.build_count == 1 and cache.get("Ball", mesh) is blas
    lo, hi = moved.bbox_min[0], moved.bbox_max[0]
    assert (moved.v0 >= lo - 1e-4).all() and (moved.v0 <= hi + 1e-4).all()
    stretched = _Mesh(5, 6, 1.0)
    stretched.positions = stretched.positions * np.float32(3.0)
    cache.get("Ball", stretched)
    assert cache.build_count == 2  # same name, new geometry: rebuilt


def test_traverse_closest_matches_jax():
    """Plain lanes, skip-self lanes (by instance) and lanes with a pending
    same-instance thickness, mixed in one walk; and the plane table."""
    built, _ = _forest(P, 3)
    trans, ab = _materials(3)
    jm, pm = _jax_mesh(built, trans, ab), _port_mesh(built, trans, ab)
    o, d = _rays(built, seed=1)
    rng = np.random.RandomState(2)
    skip = rng.rand(N_RAYS) < 0.5
    inst = rng.randint(0, 3, N_RAYS).astype(np.int32)
    thick = np.where(rng.rand(N_RAYS) < 0.5, inst, -1).astype(np.int32)
    with jax.disable_jit():
        jh = J.traverse_closest(jm, jnp.asarray(o), jnp.asarray(d), jnp.full((N_RAYS,), 1e-3),
                                jnp.full((N_RAYS,), 1e4), skip_active=jnp.asarray(skip),
                                skip_inst=jnp.asarray(inst), thick_inst=jnp.asarray(thick))
        jpk = J._plane_table(jm.v0, jm.edge1, jm.edge2)
    ph = P.traverse_closest(pm, torch.from_numpy(o), torch.from_numpy(d),
                            torch.full((N_RAYS,), 1e-3), torch.full((N_RAYS,), 1e4),
                            skip_active=torch.from_numpy(skip), skip_inst=torch.from_numpy(inst),
                            thick_inst=torch.from_numpy(thick))
    _eq(pm.plane, jpk, "plane table")
    assert 0.3 < float(ph.hit.float().mean()) < 1.0
    for f in ("hit", "tri", "inst", "thick_hit"):
        _eq(getattr(ph, f), getattr(jh, f), f)
    for f in ("t", "u", "v", "thick_t"):
        _eq(getattr(ph, f), getattr(jh, f), f, atol=1e-6)
    assert bool(ph.thick_hit.any())
    plain = ~skip & (thick < 0)
    assert bool(ph.hit.numpy()[plain].any())


@pytest.mark.parametrize("walk,count,opaque", [
    # glass + opaque: crossing counts, trans^n and beer^n, and the search
    # ending on an opaque crossing
    ("count", 2, (1,)),
    ("multiply", 9, (1, 4, 7)),  # more than 8 instances: a product per crossing
])
def test_traverse_shadow_matches_jax(walk, count, opaque):
    built, _ = _forest(P, count)
    trans, ab = _materials(count, opaque)
    jm, pm = _jax_mesh(built, trans, ab), _port_mesh(built, trans, ab)
    o, d = _rays(built, seed=3 + count)
    rng = np.random.RandomState(4)
    max_dist = (rng.rand(N_RAYS) * 8.0 + 0.5).astype(np.float32)
    blocked0 = rng.rand(N_RAYS) < 0.1
    with jax.disable_jit():
        jv = J.traverse_shadow(jm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_dist),
                               absorb_scale=jnp.float32(1.0) * jnp.float32(ABSORB_SCALE),
                               blocked0=jnp.asarray(blocked0))
    pv = P.traverse_shadow(pm, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(max_dist), blocked0=torch.from_numpy(blocked0))
    for name, a, b in zip(("vis", "color", "occ"), pv, jv):
        _eq(a, b, name, atol=1e-6)
    vis = pv[0].numpy()
    assert (vis[blocked0] == 0.0).all()
    assert ((vis > 0.0) & (vis < 1.0)).any()  # translucent crossings
    if opaque:
        assert (vis[~blocked0] == 0.0).any()  # blocked by an opaque instance


def test_traverse_thickness_matches_jax():
    """The first threaded-order leaf with a same-instance hit ends the walk."""
    built, _ = _forest(P, 3)
    trans, ab = _materials(3)
    jm, pm = _jax_mesh(built, trans, ab), _port_mesh(built, trans, ab)
    o, d = _rays(built, seed=5, inside=True)
    inst = np.random.RandomState(6).randint(0, 3, N_RAYS).astype(np.int32)
    with jax.disable_jit():
        jh, jt = J.traverse_thickness(jm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(inst))
    ph, pt = P.traverse_thickness(pm, torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(inst))
    _eq(ph, jh, "hit")
    _eq(pt, jt, "t", atol=1e-6)
    assert 0.2 < float(ph.float().mean()) < 1.0


def test_shading_normal_matches_jax():
    built, _ = _forest(P, 3)
    trans, ab = _materials(3)
    jm, pm = _jax_mesh(built, trans, ab), _port_mesh(built, trans, ab)
    rng = np.random.RandomState(7)
    tri = rng.randint(0, len(built.v0), N_RAYS).astype(np.int32)
    u = rng.rand(N_RAYS).astype(np.float32) * 0.5
    v = rng.rand(N_RAYS).astype(np.float32) * 0.5
    d = rng.randn(N_RAYS, 3).astype(np.float32)
    with jax.disable_jit():
        jn, jf = J.shading_normal(jm, J.TriHit(hit=None, t=None, tri=jnp.asarray(tri),
                                               u=jnp.asarray(u), v=jnp.asarray(v), inst=None),
                                  jnp.asarray(d))
    pn, pf = P.shading_normal(pm, P.TriHit(hit=None, t=None, tri=torch.from_numpy(tri),
                                           u=torch.from_numpy(u), v=torch.from_numpy(v),
                                           inst=None), torch.from_numpy(d))
    _eq(pn, jn, "normal", atol=1e-6)
    _eq(pf, jf, "front")


def test_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    """No numpy fallback: without a compiler the first build raises."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "lib.so"))
    monkeypatch.setenv("CXX", "no-such-compiler-rtvs")
    native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="compiler"):
            P.build_bvh(*_triangles(_Mesh(3, 4, 1.0)))
    finally:
        native.load_library.cache_clear()
