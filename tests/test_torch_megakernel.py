"""Plain K1 (render_rows_cf on the CPU) vs raytracevs_tpu render_rows
(backend="jnp") at 32x32, on the demo scene and golden configs 2, 3, 6.

Bands: the ray count and object ids exact; HDR colour, and the radiance
planes of the G-buffer that split it, atol 2e-4 on >= 99% of pixels (the
two libraries' sin/cos/exp differ in the last bit, which moves a few glass
paths further); the geometric G-buffer planes atol 1e-4, plus rtol 1e-5
for the hit distances and view depths of grazing floor hits 10^3-10^4
units away, where float32 resolves only ~1e-3 and the plane division's
rounding is carried into view_z.
The CUDA kernel is held against this plain version on the card
(tests/test_torch_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu.ops.render import render_rows as j_render_rows
from raytracevs_tpu.ops.render_cf import assemble_frame_cf as j_assemble_cf
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu.scene.flatten import flatten_scene as j_flatten
from raytracevs_tpu.scene.flatten import make_config as j_make_config
from raytracevs_tpu.scene.sanitize import sanitize_scene as j_sanitize
from raytracevs_tpu_torch.ops import render as R
from raytracevs_tpu_torch.ops.cuda import megakernel as mk
from raytracevs_tpu_torch.ops.render_cf import accum_dict, assemble_frame_cf, render_rows_cf
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import flatten_scene, make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

W = H = 32
NAMES = ("demo", "config2_obb_mirror", "config3_glass_soft", "config6_soft_shadows")
GBUF_FIELDS = ("diffuse_hitdist", "specular_hitdist", "normal_roughness", "motion", "albedo",
               "shadow_data", "shadow_translucency", "motion_spec")
_CACHE = {}


def _setup(name):
    js, jo = S.scene_and_overrides(JD, name)
    ps, po = S.scene_and_overrides(PD, name)
    prev = None
    if name == "demo":  # a moving camera, so the motion vectors are not zero
        prev = j_flatten(j_sanitize(S.demo_scene(JD, 1)), aspect=1.0).view_proj
    jf = j_flatten(j_sanitize(js), aspect=1.0, frame_index=3, prev_view_proj=prev)
    pf = flatten_scene(sanitize_scene(ps), aspect=1.0, frame_index=3,
                       prev_view_proj=None if prev is None else np.asarray(prev))
    return jf, j_make_config(js, W, H, **jo), to_device(pf, "cpu"), make_config(ps, W, H, **po)


def _frames(name):
    if name not in _CACHE:
        jf, jc, pf, pc = _setup(name)
        jout = j_render_rows(jf, jc, jnp.int32(0), H, backend="jnp")
        jax.block_until_ready(jout.color)
        _CACHE[name] = (jout, render_rows_cf(pf, pc))
    return _CACHE[name]


def _lanes(a):
    """[c,H,W] or [H,W] tensor -> [N,c] / [N] numpy (the JAX lane layout)."""
    if a.dim() == 2:
        return a.reshape(-1).numpy()
    return a.permute(1, 2, 0).reshape(-1, a.shape[0]).numpy()


@pytest.mark.parametrize("name", NAMES)
def test_k1_plain_ray_count_and_obj_id_exact(name):
    jout, pout = _frames(name)
    assert int(pout.rays) == int(jout.rays)
    np.testing.assert_array_equal(_lanes(pout.gbuffer.obj_id), np.asarray(jout.gbuffer.obj_id))


@pytest.mark.parametrize("name", NAMES)
def test_k1_plain_hdr_color(name):
    jout, pout = _frames(name)
    d = np.abs(_lanes(pout.color) - np.asarray(jout.color)).max(axis=-1)
    assert (d <= 2e-4).mean() >= 0.99, (d.max(), (d > 2e-4).mean())
    assert np.isfinite(_lanes(pout.color)).all()


@pytest.mark.parametrize("name", NAMES)
def test_k1_plain_gbuffer(name):
    jout, pout = _frames(name)
    for f in GBUF_FIELDS:
        got = _lanes(getattr(pout.gbuffer, f))
        want = np.asarray(getattr(jout.gbuffer, f))
        if f in ("diffuse_hitdist", "specular_hitdist"):
            # the radiance channels are shares of the HDR colour: its band
            d = np.abs(got[:, :3] - want[:, :3]).max(axis=-1)
            assert (d <= 2e-4).mean() >= 0.99, (f, d.max())
            got, want = got[:, 3], want[:, 3]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(_lanes(pout.gbuffer.view_z), np.asarray(jout.gbuffer.view_z),
                               atol=1e-4, rtol=1e-5)
    d = np.abs(_lanes(pout.raw_specular) - np.asarray(jout.raw_specular)).max(axis=-1)
    assert (d <= 2e-4).mean() >= 0.99


def test_assemble_frame_cf_matches_jax_on_same_accumulators():
    jf, jc, pf, pc = _setup("demo")
    acc = R.render_accum(pf, pc)
    assert acc.shape == (R.NUM_CH, H, W)
    pd = accum_dict(acc)
    jd = {k: (jnp.asarray(v.numpy()) if k != "rays" else jnp.float32(float(v)))
          for k, v in pd.items()}
    jout = j_assemble_cf(jf, jc, jd)
    pout = assemble_frame_cf(pf, pc, pd)
    np.testing.assert_allclose(pout.color.numpy(), np.asarray(jout.color), atol=1e-6)
    for f in GBUF_FIELDS + ("view_z",):
        np.testing.assert_allclose(getattr(pout.gbuffer, f).numpy(),
                                   np.asarray(getattr(jout.gbuffer, f)),
                                   atol=1e-5, rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(pout.gbuffer.obj_id.numpy(), np.asarray(jout.gbuffer.obj_id))


def test_render_accum_cpu_runs_plain_version_without_launch():
    _, _, pf, pc = _setup("config2_obb_mirror")
    before = mk.render_accum.launches
    out = mk.render_accum(pf, pc._replace(height=8, width=8))
    assert out.shape == (R.NUM_CH, 8, 8) and mk.render_accum.launches == before


@pytest.mark.parametrize("name", ["demo", "config1_hard_shadows"])
def test_pack_scene_layout(name):
    """The float table K1 reads: rows of 5/7/16/16/12 floats, 32 params,
    then the blue-noise tile; scene scalars in the int table."""
    _, _, pf, _ = _setup(name)
    ftab, itab = mk.pack_scene(pf)
    s, p, b, l = pf.sphere_capacity, pf.plane_capacity, pf.box_capacity, pf.light_capacity
    m = pf.mat_color.shape[0]
    assert ftab.dtype == torch.float32 and ftab.dim() == 1
    assert ftab.numel() == 5 * s + 7 * p + 16 * b + 16 * m + 12 * l + 32 + 16 * 16 * 4
    mat = ftab[5 * s + 7 * p + 16 * b:][:16 * m].reshape(m, 16)
    np.testing.assert_array_equal(mat[:, 5].numpy(), pf.mat_transmission.numpy())
    np.testing.assert_array_equal(mat[:, 12:15].numpy(), pf.mat_absorption.numpy())
    par = ftab[5 * s + 7 * p + 16 * b + 16 * m + 12 * l:][:32]
    np.testing.assert_array_equal(par[0:3].numpy(), pf.cam_pos.numpy())
    assert itab.tolist() == [int(pf.num_lights), int(pf.max_shadow_lights), 3]
    # a material table that does not match the primitive slots would shift
    # every later table the kernel reads
    with pytest.raises(ValueError, match="material rows"):
        mk.pack_scene(pf._replace(mat_color=pf.mat_color[:-1]))
