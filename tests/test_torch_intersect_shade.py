"""Port intersection and shading vs raytracevs_tpu/ops/{intersect,shade}.py
on random rays through the demo scene's tables: hit masks, object indices
and integer results exact; distances, normals and shading atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu.ops import intersect as JI
from raytracevs_tpu.ops import shade as JS
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu.scene.flatten import flatten_scene as j_flatten
from raytracevs_tpu.scene.sanitize import sanitize_scene as j_sanitize
from raytracevs_tpu_torch.ops import intersect as PI
from raytracevs_tpu_torch.ops import shade as PS
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import flatten_scene, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

N = 4096
ATOL = 1e-5


@pytest.fixture(scope="module")
def scenes():
    jf = j_flatten(j_sanitize(S.demo_scene(JD)), frame_index=5)
    pf = to_device(flatten_scene(sanitize_scene(S.demo_scene(PD)), frame_index=5), "cpu")
    return jf, pf


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(42)
    o = rng.uniform([-3, 0.05, -5], [3, 3, 3], size=(N, 3)).astype(np.float32)
    target = rng.uniform([-2.5, -0.5, -1.5], [2.5, 2.0, 3.0], size=(N, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _f(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(p, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), atol=atol, rtol=rtol)


def test_primitive_tests_match(scenes, rays):
    jf, pf = scenes
    o, d = rays
    tmin = np.full(N, 1e-3, np.float32)
    tmax = np.full(N, 1e4, np.float32)
    args_j = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    args_p = (_f(o), _f(d), _f(tmin), _f(tmax))
    for jt, pt in (
        (JI.intersect_spheres(*args_j, jf.sph_center, jf.sph_radius, jf.sph_valid),
         PI.intersect_spheres(*args_p, pf.sph_center, pf.sph_radius, pf.sph_valid)),
        (JI.intersect_planes(*args_j, jf.pln_position, jf.pln_normal, jf.pln_valid),
         PI.intersect_planes(*args_p, pf.pln_position, pf.pln_normal, pf.pln_valid)),
        (JI.intersect_boxes(*args_j, jf.box_center, jf.box_half, jf.box_axes, jf.box_valid)[0],
         PI.intersect_boxes(*args_p, pf.box_center, pf.box_half, pf.box_axes, pf.box_valid)[0]),
    ):
        jt, pt = np.asarray(jt), pt.numpy()
        np.testing.assert_array_equal(pt < 1e29, jt < 1e29)
        assert (jt < 1e29).any()
        _close(pt, jt)


def test_trace_closest_and_surface_normal_match(scenes, rays):
    jf, pf = scenes
    o, d = rays
    tmin = np.full(N, 1e-3, np.float32)
    tmax = np.full(N, 1e4, np.float32)
    jh = JI.trace_closest(jf, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    ph = PI.trace_closest(pf, _f(o), _f(d), _f(tmin), _f(tmax))
    hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(ph.hit.numpy(), hit)
    assert hit.mean() > 0.3
    for f in ("obj_type", "obj_index", "mat_slot"):
        np.testing.assert_array_equal(getattr(ph, f).numpy()[hit], np.asarray(getattr(jh, f))[hit])
    _close(ph.t.numpy()[hit], np.asarray(jh.t)[hit])
    jp, jn, jfront = JI.surface_normal(jf, jh, jnp.asarray(o), jnp.asarray(d))
    pp, pn, pfront = PI.surface_normal(pf, ph, _f(o), _f(d))
    _close(pp.numpy()[hit], np.asarray(jp)[hit], atol=1e-4)
    _close(pn.numpy()[hit], np.asarray(jn)[hit])
    np.testing.assert_array_equal(pfront.numpy()[hit], np.asarray(jfront)[hit])

    # self-skip: re-trace from the hit, skipping the primitive just hit
    st = np.where(hit, np.asarray(jh.obj_type), 0x7FFFFFFF).astype(np.int32)
    si = np.asarray(jh.obj_index).astype(np.int32)
    o2 = np.asarray(jp) + np.asarray(jn) * 0.002
    jh2 = JI.trace_closest(jf, jnp.asarray(o2), jnp.asarray(d), jnp.asarray(tmin),
                           jnp.asarray(tmax), jnp.asarray(st), jnp.asarray(si))
    ph2 = PI.trace_closest(pf, _f(o2), _f(d), _f(tmin), _f(tmax),
                           torch.from_numpy(st.astype(np.int64)), torch.from_numpy(si.astype(np.int64)))
    np.testing.assert_array_equal(ph2.hit.numpy(), np.asarray(jh2.hit))


def test_trace_shadow_and_thickness_match(scenes, rays):
    jf, pf = scenes
    o, d = rays
    dist = np.random.default_rng(3).uniform(0.5, 12.0, N).astype(np.float32)
    jv, jc, jo = JI.trace_shadow(jf, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist))
    pv, pc, po = PI.trace_shadow(pf, _f(o), _f(d), _f(dist))
    _close(pv.numpy(), jv)
    _close(pc.numpy(), jc)
    _close(po.numpy(), jo, rtol=1e-6)
    assert (np.asarray(jv) < 1).any() and (np.asarray(jv) > 0).any()
    types = np.random.default_rng(4).choice([0, 2], N).astype(np.int32)
    idx = np.random.default_rng(5).integers(0, 3, N).astype(np.int32)
    jhit, jt = JI.trace_thickness(jf, jnp.asarray(o), jnp.asarray(d), jnp.asarray(types),
                                  jnp.asarray(idx))
    phit, pt = PI.trace_thickness(pf, _f(o), _f(d), torch.from_numpy(types.astype(np.int64)),
                                  torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(phit.numpy(), np.asarray(jhit))
    _close(pt.numpy(), jt, rtol=1e-6)


def test_brdf_sky_checker_match():
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, N).astype(np.float32)
    y = rng.uniform(0.01, 1, N).astype(np.float32)
    r = rng.uniform(0, 1, N).astype(np.float32)
    f0 = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    _close(PS.ggx_d(_f(x), _f(r)), JS.ggx_d(jnp.asarray(x), jnp.asarray(r)), atol=1e-4, rtol=1e-5)
    _close(PS.smith_g(_f(x), _f(y), _f(r)), JS.smith_g(jnp.asarray(x), jnp.asarray(y), jnp.asarray(r)))
    _close(PS.fresnel_schlick(_f(x), _f(r)), JS.fresnel_schlick(jnp.asarray(x), jnp.asarray(r)))
    _close(PS.fresnel_schlick3(_f(x), _f(f0)), JS.fresnel_schlick3(jnp.asarray(x), jnp.asarray(f0)))
    _close(PS.compute_attenuation(_f(y * 20), 1.0, 0.1, 0.01),
           JS.compute_attenuation(jnp.asarray(y * 20), 1.0, 0.1, 0.01))
    _close(PS.luminance(_f(f0)), JS.luminance(jnp.asarray(f0)))
    n = np.random.default_rng(7).normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = np.random.default_rng(8).normal(size=(N, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    _close(PS.cook_torrance_specular(_f(n), _f(v), _f(n * 0.5 + v * 0.5), _f(f0), _f(r)),
           JS.cook_torrance_specular(jnp.asarray(n), jnp.asarray(v), jnp.asarray(n * 0.5 + v * 0.5),
                                     jnp.asarray(f0), jnp.asarray(r)), atol=1e-4, rtol=1e-4)
    _close(PS.sky_color(_f(v)), JS.sky_color(jnp.asarray(v)))
    pos = rng.uniform(-30, 30, (N, 3)).astype(np.float32)
    cam = np.array([0.0, 2.0, -5.0], np.float32)
    fwd = np.array([0.0, -0.2, 0.98], np.float32)
    _close(PS.checker_albedo(None, _f(pos), _f(cam), _f(fwd)),
           JS.checker_albedo(None, jnp.asarray(pos), jnp.asarray(cam), jnp.asarray(fwd)))
    d_occ = np.concatenate([rng.uniform(0, 20, N - 8), np.full(8, 65504.0)]).astype(np.float32)
    _close(PS.sigma_pack_penumbra_local(_f(d_occ), _f(y * 30), 0.8),
           JS.sigma_pack_penumbra_local(jnp.asarray(d_occ), jnp.asarray(y * 30), 0.8), rtol=1e-5)
    _close(PS.sigma_pack_penumbra_directional(_f(d_occ), 0.1),
           JS.sigma_pack_penumbra_directional(jnp.asarray(d_occ), 0.1), rtol=1e-6)


def test_dominant_lights_and_soft_shadow_match(scenes, rays):
    jf, pf = scenes
    o, d = rays
    tmin = np.full(N, 1e-3, np.float32)
    tmax = np.full(N, 1e4, np.float32)
    jh = JI.trace_closest(jf, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    jp, jn, _ = JI.surface_normal(jf, jh, jnp.asarray(o), jnp.asarray(d))
    hit = np.asarray(jh.hit)
    pos = np.asarray(jp)[hit]
    nrm = np.asarray(jn)[hit]
    m = pos.shape[0]
    jsel = JS.select_dominant_lights(jf, jnp.asarray(pos), jnp.asarray(nrm))
    psel = PS.select_dominant_lights(pf, _f(pos), _f(nrm))
    for k in (0, 2, 4):
        np.testing.assert_array_equal(psel[k].numpy(), np.asarray(jsel[k]))
    for k in (1, 3):
        _close(psel[k].numpy(), jsel[k], rtol=1e-6)
    seeds = np.random.default_rng(11).integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    active = np.random.default_rng(12).uniform(size=m) < 0.9
    for li in range(3):
        idx = np.full(m, li, np.int32)
        samples = np.asarray(JS.compute_shadow_samples(jf.lt_samples[idx], *jsel[:4], jnp.asarray(idx)))
        psamples = PS.compute_shadow_samples(pf.lt_samples[torch.from_numpy(idx.astype(np.int64))],
                                             *psel[:4], torch.from_numpy(idx.astype(np.int64)))
        np.testing.assert_array_equal(psamples.numpy(), samples)
        js, jr = JS.calculate_soft_shadow(
            jf, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(active), jf.lt_type[idx],
            jf.lt_position[idx], jf.lt_radius[idx], jnp.asarray(samples, jnp.float32),
            jnp.asarray(seeds), max_samples=4)
        ti = torch.from_numpy(idx.astype(np.int64))
        ps, pr = PS.calculate_soft_shadow(
            pf, _f(pos), _f(nrm), torch.from_numpy(active), pf.lt_type[ti], pf.lt_position[ti],
            pf.lt_radius[ti], _f(samples), torch.from_numpy(seeds.astype(np.int64)), max_samples=4)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(pr.rays.numpy(), np.asarray(jr.rays))
        _close(pr.visibility.numpy(), jr.visibility)
        _close(pr.shadow_color.numpy(), jr.shadow_color)
        _close(pr.occluder_distance.numpy(), jr.occluder_distance, rtol=1e-6)
        _close(pr.penumbra.numpy(), jr.penumbra, rtol=1e-5)
