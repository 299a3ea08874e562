"""The port's debug views (post/debug_modes.py, Engine.render_debug_view) and
photon debug modes against raytracevs_tpu, on the CPU.

- composite_debug, modes 0-11, on one G-buffer made from a seed: the JAX
  package's lane G-buffer [N,c] and the same values as the port's
  channel-first planes, with and without denoised planes and a photon map
  (its capacity bar), at 64x32 and at an odd size (the tile strip's
  scaling). Colour atol 2e-4 before RGBA8, RGBA8 |d| <= 1.
- Photon debug modes 1-4 on the caustics demo scene
  (tests/_torch_scenes.py), one 64x32 frame each through the port's Engine
  and the JAX Engine fed the port's photon map (ROADMAP C8), in
  test_torch_engine.py's band: modes 1/2 in the assembly, 3/4 in the
  shading at depth-0 hits, and for every mode the caustic's replacement
  fold-in.
- render_debug_view, modes 1-10, through both Engines after those frames."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_scenes as S
from raytracevs_tpu import Engine as JEngine
from raytracevs_tpu.ops import photon as JP
from raytracevs_tpu.ops.render import GBuffer
from raytracevs_tpu.post import debug_modes as JDM
from raytracevs_tpu.post import tonemap as JTM
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.ops import photon as PP
from raytracevs_tpu_torch.ops.render_cf import GBufferCF
from raytracevs_tpu_torch.post import debug_modes as PDM
from raytracevs_tpu_torch.post import tonemap as PTM
from raytracevs_tpu_torch.scene import data as PD
from test_torch_engine import _assert_frame_matches, _hdr_outliers, _near

S.one_torch_thread()

CHANNELS = dict(diffuse_hitdist=4, specular_hitdist=4, normal_roughness=4, view_z=0,
                motion=2, albedo=4, shadow_data=2, shadow_translucency=4, obj_id=0,
                motion_spec=2)


def _gbuffers(h, w, seed):
    """(JAX lane GBuffer, port GBufferCF, denoised lanes, denoised planes)
    of the same values, made with numpy from `seed`: radiance in [0, 3),
    view z across the sky, motion of a few pixels."""
    rng = np.random.default_rng(seed)
    n = h * w
    lanes = {}
    for name, c in CHANNELS.items():
        shape = (n, c) if c else (n,)
        if name == "obj_id":
            lanes[name] = rng.integers(-1, 5, n).astype(np.int32)
        elif name == "view_z":
            lanes[name] = rng.uniform(0.05, 150.0, n).astype(np.float32)
        elif name.startswith("motion"):
            lanes[name] = rng.uniform(-4.0, 4.0, shape).astype(np.float32)
        elif name in ("diffuse_hitdist", "specular_hitdist"):
            lanes[name] = rng.uniform(0.0, 3.0, shape).astype(np.float32)
        else:
            lanes[name] = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    den = [rng.uniform(0.0, 2.0, (n, c)).astype(np.float32) for c in (3, 3, 2)]

    def cf(a):
        a = a.reshape(h, w, -1) if a.ndim == 2 else a.reshape(h, w)
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0) if a.ndim == 3
                                                     else a))

    jg = GBuffer(**{k: jnp.asarray(v) for k, v in lanes.items()})
    pg = GBufferCF(**{k: cf(v) for k, v in lanes.items()})
    return jg, pg, [jnp.asarray(d) for d in den], [cf(d) for d in den]


@pytest.mark.parametrize("size", [(32, 64), (23, 37)], ids=["64x32", "37x23"])
@pytest.mark.parametrize("extras", ["inputs", "denoised_and_photons"])
def test_composite_debug_matches_jax(size, extras):
    h, w = size
    jg, pg, jden, pden = _gbuffers(h, w, seed=h * 1000 + w)
    kw = {}
    if extras != "inputs":
        kw = dict(exposure=1.3, photon_map_size=40000)
    for mode in range(12):
        jd = dict(zip(("denoised_diffuse", "denoised_specular", "denoised_shadow"), jden)) \
            if extras != "inputs" else {}
        pdn = dict(zip(("denoised_diffuse", "denoised_specular", "denoised_shadow"), pden)) \
            if extras != "inputs" else {}
        want = np.asarray(JDM.composite_debug(mode, jg, h, w, **jd, **kw))
        got = PDM.composite_debug(mode, pg, **pdn, **kw)
        assert got.shape == (3, h, w)
        np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, atol=2e-4, rtol=0,
                                   err_msg=f"mode {mode}")
        img = PTM.to_rgba8_cf(got).numpy()
        jimg = np.asarray(JTM.to_rgba8(jnp.asarray(want).reshape(-1, 3))).reshape(h, w, 4)
        assert np.abs(img.astype(np.int16) - jimg).max() <= 1, mode


MODES = [1, 2, 3, 4]


@pytest.fixture(scope="module")
def debug_frames():
    """One 64x32 caustics demo frame in each photon debug mode, through both
    Engines; the JAX Engine reads the port's photon map."""
    out = {}
    for mode in MODES:
        over = dict(S.DEMO_OVERRIDES, enable_caustics=True, photon_debug_mode=mode,
                    photon_debug_scale=4.0)
        pe = Engine(64, 32, device="cpu")
        je = JEngine(64, 32, backend="jnp", device_mesh=None)
        pe.update_scene(S.demo_scene(PD), **over)
        pmap = PP.emit_and_trace(pe._scene_t, pe._cfg.num_photons)
        jmap = JP.PhotonMap(*(jnp.asarray(a.numpy()) for a in pmap))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JP, "emit_and_trace", lambda *a, **k: jmap)
            je.update_scene(S.demo_scene(JD), **over)
            jimg = je.render()
        pimg = pe.render()
        out[mode] = dict(pimg=pimg, jimg=jimg, prays=pe.last_rays, jrays=je.last_rays,
                         phdr=pe.last_hdr, jhdr=je.last_hdr, pe=pe, je=je)
    return out


def _records(pg, jg):
    """The demodulated diffuse and specular records [H,W,6] of the port's
    and the JAX Engine's last G-buffer."""
    port = torch.cat([pg.diffuse_hitdist[:3], pg.specular_hitdist[:3]]).permute(1, 2, 0)
    jax_ = np.concatenate([np.asarray(jg.diffuse_hitdist)[:, :3],
                           np.asarray(jg.specular_hitdist)[:, :3]], axis=1)
    return port.numpy(), jax_.reshape(port.shape)


def _with_records(fr):
    """The frame with the diffuse and specular records beside its HDR
    colour, where test_torch_engine.py's band looks for outliers."""
    prec, jrec = _records(fr["pe"]._last_gbuffer, fr["je"]._last_gbuffer)
    return dict(fr, phdr=np.concatenate([fr["phdr"], prec], axis=-1),
                jhdr=np.concatenate([fr["jhdr"], jrec], axis=-1))


@pytest.mark.parametrize("mode", MODES)
def test_photon_debug_mode_frames_match_jax(debug_frames, mode):
    """The frame in each photon debug mode meets the engine band, beyond
    the reach of an outlier at a caustic, as test_torch_engine.py's
    caustics frames. In a debug mode the caustic reaches the frame through
    the diffuse record (mode 1 shows the colour without it), so an outlier
    is a pixel where the HDR colour or the diffuse or specular record
    differs by more than 2e-4. The mode's frame differs from the others'."""
    fr = debug_frames[mode]
    _assert_frame_matches(_with_records(fr), far_only=True)
    others = [debug_frames[m]["pimg"] for m in MODES if m != mode]
    assert all(not np.array_equal(fr["pimg"], o) for o in others)


@pytest.mark.parametrize("view", list(range(1, 11)))
def test_render_debug_view_matches_jax(debug_frames, view):
    """render_debug_view after a caustics frame in photon debug mode 3 (the
    capacity bar drawn), both Engines, in the frame's band: RGBA8 |d| <= 1
    on >= 99.5% of the pixels beyond the reach of the frame's outliers,
    <= 4 everywhere else but within it; the magenta fill exact below the
    bar."""
    fr = debug_frames[3]
    got, want = fr["pe"].render_debug_view(view), fr["je"].render_debug_view(view)
    assert got.shape == want.shape == (32, 64, 4) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
    if view == 5:
        assert d[8:].max() == 0
    near = _near(_hdr_outliers(_with_records(fr)))
    assert (d[~near] <= 1).mean() >= 0.995, (view, d.max(), (d[~near] > 1).mean())
    assert not ((d > 4) & ~near).any(), (view, d.max())
