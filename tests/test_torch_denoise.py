"""Port denoiser vs raytracevs_tpu/post/denoise.py (the jnp oracle) and
raytracevs_tpu/ops/pallas/denoise_kernels.py (interpret mode).

The plain versions of K2-K4 (temporal_accumulate, atrous, shadow_denoise)
and the plain ops around them are held to atol 1e-4: the oracle computes
the same sums, in another order where XLA fuses them and with
jnp.power(x, 8.0) where the port squares three times. Against the Pallas
kernels the comparison uses zero and uniform integer motion, where the
tile-quantized TPU reprojection and the per-pixel oracle agree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu.ops.pallas import denoise_kernels as dk
from raytracevs_tpu.ops.render import GBuffer
from raytracevs_tpu.post import denoise as JD_
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.ops.cuda import denoise_kernels as K
from raytracevs_tpu_torch.ops.render_cf import render_rows_cf
from raytracevs_tpu_torch.post import denoise as PD_
from raytracevs_tpu_torch.scene import data as PDATA

ATOL = 1e-4


def _inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        state=np.concatenate([rng.uniform(0, 1, (14, h, w)), rng.uniform(0, 10, (1, h, w)),
                              rng.uniform(1, 51, (1, h, w))]).astype(f),
        curr=rng.uniform(0, 2, (8, h, w)).astype(f),
        view_z=rng.uniform(1, 51, (h, w)).astype(f),
        nr=rng.uniform(0, 1, (4, h, w)).astype(f),
        img6=rng.uniform(0, 1, (6, h, w)).astype(f) ** 3 * 4,
        guide=rng.uniform(0, 6, (2, h, w)).astype(f),
        shadow=rng.uniform(0, 1, (2, h, w)).astype(f),
        obj_id=rng.integers(-1, 4, (h, w)).astype(np.int32),
        rough=rng.uniform(0, 0.2, (h, w)).astype(f),
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hwc(a):
    return jnp.asarray(np.moveaxis(a, 0, -1))


def _state_fields(packed):
    p = np.moveaxis(packed, 0, -1)
    return JD_.DenoiserState(diffuse=jnp.asarray(p[..., 0:4]), specular=jnp.asarray(p[..., 4:8]),
                             fast_diffuse=jnp.asarray(p[..., 8:11]),
                             fast_specular=jnp.asarray(p[..., 11:14]),
                             frames=jnp.asarray(p[..., 14]), view_z=jnp.asarray(p[..., 15]))


@pytest.mark.parametrize("moving", [False, True])
def test_temporal_accumulate_matches_oracle(moving):
    """Responsive accumulation and virtual motion on, as on the main path;
    a still camera (zero surface motion) and a moving one."""
    h, w = 24, 40
    x = _inputs(h, w, 1)
    rng = np.random.default_rng(2)
    motion = rng.uniform(-3, 3, (2, h, w)).astype(np.float32)
    if not moving:
        motion[:] = 0.0
    mspec = (motion + rng.uniform(-1, 1, (2, h, w))).astype(np.float32)
    vz = x["state"][15] * rng.choice([1.0, 1.05, 2.0], (h, w)).astype(np.float32)
    got = PD_.temporal_accumulate(_t(x["state"]), _t(x["curr"]), _t(motion), _t(vz),
                                  _t(x["rough"]), _t(mspec)).numpy()
    acc_d, acc_s, fast_d, fast_s, frames = JD_.temporal_accumulate(
        _hwc(x["curr"][0:4]), _hwc(x["curr"][4:8]), _hwc(motion), jnp.asarray(vz),
        _state_fields(x["state"]), roughness=jnp.asarray(x["rough"]), motion_spec=_hwc(mspec))
    want = np.concatenate([np.moveaxis(np.asarray(a), -1, 0) for a in (acc_d, acc_s, fast_d, fast_s)]
                          + [np.asarray(frames)[None], vz[None]])
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got[14] == 0).any() and (got[14] > 0).any()


def test_atrous_with_guide_and_firefly_matches_oracle():
    h, w = 24, 40
    x = _inputs(h, w, 3)
    normal = PD_.decode_oct_cf(_t(x["nr"]))
    got = PD_.atrous(_t(x["img6"]), _t(x["view_z"]), normal, _t(x["guide"])).numpy()
    want = JD_.atrous(_hwc(x["img6"]), jnp.asarray(x["view_z"]), jnp.asarray(np.moveaxis(normal.numpy(), 0, -1)),
                      guide=_hwc(x["guide"]), use_anti_firefly=True)
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 0), atol=ATOL)


def test_anti_firefly_and_decode_match_oracle():
    h, w = 16, 20
    x = _inputs(h, w, 4)
    np.testing.assert_allclose(PD_.anti_firefly(_t(x["img6"])).numpy(),
                               np.moveaxis(np.asarray(JD_.anti_firefly(_hwc(x["img6"]))), -1, 0),
                               atol=1e-6)
    np.testing.assert_allclose(PD_.decode_oct_cf(_t(x["nr"])).numpy(),
                               np.asarray(JD_._decode_oct_cf(jnp.asarray(x["nr"]))), atol=1e-6)


def test_shadow_denoise_matches_oracle():
    h, w = 24, 40
    x = _inputs(h, w, 5)
    normal = PD_.decode_oct_cf(_t(x["nr"]))
    got = PD_.shadow_denoise(_t(x["shadow"]), _t(x["obj_id"]), _t(x["view_z"]), normal).numpy()
    want = JD_.shadow_denoise(_hwc(x["shadow"]), jnp.asarray(x["obj_id"]), jnp.asarray(x["view_z"]),
                              _hwc(x["nr"]))
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 0), atol=ATOL)


def test_reblur_prepass_and_blur_radius_match_oracle():
    h, w = 24, 40
    x = _inputs(h, w, 6)
    curr = x["curr"].copy()
    curr[3, ::3] = 0.0  # missing hit distances to reconstruct
    curr[7, 1::4] = 0.0
    vz = x["view_z"].copy()
    vz[:, :5] = 10000.0  # sky
    sqrt_rough = x["nr"][3]
    got = PD_.reblur_prepass(_t(curr), _t(vz), _t(sqrt_rough)).numpy()
    want = np.asarray(JD_.reblur_prepass(jnp.asarray(curr), jnp.asarray(vz), jnp.asarray(sqrt_rough)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)
    frames = x["state"][14]
    for a, b in zip(PD_.blur_radius_planes(_t(frames), _t(curr[7]), _t(vz), _t(x["rough"])),
                    JD_.blur_radius_planes(jnp.asarray(frames), jnp.asarray(curr[7]), jnp.asarray(vz),
                                           jnp.asarray(x["rough"]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-6)


@pytest.fixture(scope="module")
def orbit_gbuffers():
    """G-buffers of three orbiting demo frames, rendered by the port."""
    eng = Engine(32, 24)
    out = []
    for f in range(3):
        eng.update_scene(S.demo_scene(PDATA, f), **S.DEMO_OVERRIDES)
        out.append(render_rows_cf(eng._scene_t, eng._cfg).gbuffer)
        eng._scene_t = eng._scene_t._replace(frame_index=torch.tensor(f + 1))
    return out


def test_denoise_frame_cf_three_moving_frames_match_oracle(orbit_gbuffers):
    h, w = 24, 32
    state_p = PD_.init_state_cf(h, w, "cpu")
    state_j = JD_.init_state(h, w)

    def lanes(a):
        a = a.numpy()
        return jnp.asarray(a.reshape(-1) if a.ndim == 2 else np.moveaxis(a, 0, -1).reshape(-1, a.shape[0]))

    for g in orbit_gbuffers:
        assert float(g.motion.abs().max()) > 0.0 or g is orbit_gbuffers[0]
        dd, ds, dsh, state_p = PD_.denoise_frame_cf(g, state_p)
        jgb = GBuffer(**{f: lanes(getattr(g, f)) for f in GBuffer._fields})
        jd, js, jsh, state_j = JD_.denoise_frame(jgb, h, w, state_j)
        for a, b in ((dd, jd), (ds, js), (dsh, jsh)):
            np.testing.assert_allclose(np.moveaxis(a.numpy(), 0, -1).reshape(-1, a.shape[0]),
                                       np.asarray(b), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(state_p.packed[14].numpy(), np.asarray(state_j.frames), atol=0)


@pytest.mark.parametrize("motion_xy", [(0.0, 0.0), (3.0, -2.0)])
def test_k2_plain_matches_pallas_interpret(motion_xy):
    h, w = 16, 256
    x = _inputs(h, w, 7)
    motion = np.broadcast_to(np.array(motion_xy, np.float32)[:, None, None], (2, h, w)).copy()
    vz = x["state"][15].copy()
    got = K.reproject_accumulate(_t(x["state"]), _t(x["curr"]), _t(motion), _t(vz),
                                 _t(x["rough"]), _t(motion)).numpy()
    want = np.asarray(dk.reproject_accumulate(jnp.asarray(x["state"]), jnp.asarray(x["curr"]),
                                              jnp.asarray(motion), jnp.asarray(vz), interpret=True,
                                              roughness=jnp.asarray(x["rough"]),
                                              motion_spec=jnp.asarray(motion)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_k3_k4_plain_match_pallas_interpret():
    h, w = 16, 256
    x = _inputs(h, w, 8)
    normal = PD_.decode_oct_cf(_t(x["nr"]))
    got = K.atrous(_t(x["img6"]), _t(x["view_z"]), normal, _t(x["guide"])).numpy()
    want = np.asarray(dk.atrous(jnp.asarray(x["img6"]), jnp.asarray(x["view_z"]),
                                jnp.asarray(normal.numpy()), interpret=True,
                                guide=jnp.asarray(x["guide"]), anti_firefly=True))
    np.testing.assert_allclose(got, want, atol=ATOL)
    got = K.shadow_denoise(_t(x["shadow"]), _t(x["obj_id"]), _t(x["view_z"]), normal).numpy()
    want = np.asarray(dk.shadow_denoise(jnp.asarray(x["shadow"]), jnp.asarray(x["obj_id"]),
                                        jnp.asarray(x["view_z"]), jnp.asarray(normal.numpy()),
                                        interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_wrappers_on_cpu_never_launch():
    h, w = 8, 8
    x = _inputs(h, w, 9)
    before = (K.reproject_accumulate.launches, K.atrous.launches, K.shadow_denoise.launches)
    normal = PD_.decode_oct_cf(_t(x["nr"]))
    still = _t(np.zeros((2, h, w), np.float32))
    K.reproject_accumulate(_t(x["state"]), _t(x["curr"]), still, _t(x["view_z"]), _t(x["rough"]),
                           still)
    K.atrous(_t(x["img6"]), _t(x["view_z"]), normal, _t(x["guide"]))
    K.shadow_denoise(_t(x["shadow"]), _t(x["obj_id"]), _t(x["view_z"]), normal)
    assert before == (K.reproject_accumulate.launches, K.atrous.launches, K.shadow_denoise.launches)
