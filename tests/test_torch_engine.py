"""The port's Engine end to end on the CPU vs raytracevs_tpu's Engine
(backend "jnp", no device mesh), over three frames of the orbiting demo
scene and of the mesh demo scene (small meshes), with the denoiser on;
plus the Engine's contract: no JAX import, device handling (the card by
default), meshes from the mesh service and the checksum-keyed history
reset. The caustics frames, in the same band, are in
test_torch_engine_caustics.py.

Band: RGBA8 |diff| <= 1 on >= 99.5% of pixels (the renderers agree to
float rounding; uint8 rounding near .5 moves by one), and <= 4 everywhere
except within the denoiser's reach (8 px) of an HDR outlier, on at most 1%
of the frame (so a wrong composite near an outlier still fails). Outliers are
pixels where one ulp flips a decision: a checker square 2000 units away on
the horizon, a soft-shadow sample at a penumbra edge. XLA's fused
whole-frame program rounds there differently from the same JAX code run
one operation at a time, and the port reproduces the latter
(test_engine_outliers_are_xla_whole_frame_rounding shows it per pixel)."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_scenes as S
from raytracevs_tpu import Engine as JEngine
from raytracevs_tpu.io import mesh_cache as JMC
from raytracevs_tpu.ops import photon as JP
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.ops import photon as PP
from raytracevs_tpu_torch.ops.render_cf import render_rows_cf
from raytracevs_tpu_torch.scene import data as PD

S.one_torch_thread()

W, H = 64, 32


HDR_ATOL = 2e-4


def _render_pair(build, jms=None, pms=None, overrides=S.DEMO_OVERRIDES):
    """Three orbiting frames of build(D, frame) through both Engines. With
    caustics on, the JAX Engine reads the port's photon map of the frame
    (bridged; the maps themselves are held per photon in
    test_caustics_photon_maps_match_jax), so the frames compare the render,
    the gather, the fold-in and the denoiser on one set of photons."""
    je = JEngine(W, H, backend="jnp", device_mesh=None, mesh_service=jms)
    pe = Engine(W, H, device="cpu", mesh_service=pms)
    out = []
    for f in range(3):
        pe.update_scene(build(PD, f), **overrides)
        pmap = None
        with pytest.MonkeyPatch.context() as mp:
            if pe._cfg.num_photons:
                pmap = PP.emit_and_trace(pe._scene_t, pe._cfg.num_photons)
                jmap = JP.PhotonMap(*(jnp.asarray(a.numpy()) for a in pmap))
                mp.setattr(JP, "emit_and_trace", lambda *a, **k: jmap)
            je.update_scene(build(JD, f), **overrides)
            jflat, jcfg = je._flat, je._cfg
            jimg = je.render()
        out.append(dict(jimg=jimg, pimg=pe.render(), jrays=je.last_rays,
                        prays=pe.last_rays, engine=pe, jhdr=je.last_hdr, phdr=pe.last_hdr,
                        jflat=jflat, jcfg=jcfg, pmap=pmap))
    return out


@pytest.fixture(scope="module")
def frames():
    return _render_pair(S.demo_scene)


@pytest.fixture(scope="module")
def mesh_frames():
    """The mesh demo scene, with small meshes (MESH_DEMO_SMALL)."""
    return _render_pair(S.mesh_demo_scene, S.mesh_service(JMC, S.MESH_DEMO_SMALL),
                        S.mesh_service(PMC, S.MESH_DEMO_SMALL))


def _hdr_outliers(fr):
    return np.argwhere(np.abs(fr["phdr"] - fr["jhdr"]).max(axis=-1) > HDR_ATOL)


def _near(outliers):
    """[H,W] mask of the pixels within the denoiser's reach (8 px) of an
    HDR outlier."""
    m = np.zeros((H, W), bool)
    for oy, ox in outliers:
        m[max(oy - 8, 0):oy + 9, max(ox - 8, 0):ox + 9] = True
    return m


def _assert_frame_matches(fr, far_only=False):
    """The band of the module docstring. far_only (caustics frames): the
    |d| <= 1 share is taken over the pixels beyond the reach of an HDR
    outlier, since an outlier at a caustic moves its neighbourhood
    through the denoiser by more than 1."""
    pimg, jimg = fr["pimg"], fr["jimg"]
    assert pimg.shape == (H, W, 4) and pimg.dtype == np.uint8
    assert fr["prays"] == fr["jrays"]
    d = np.abs(pimg.astype(np.int16) - jimg.astype(np.int16)).max(axis=-1)
    outliers = _hdr_outliers(fr)
    far = ~_near(outliers) if far_only else np.ones((H, W), bool)
    assert (d[far] <= 1).mean() >= 0.995, (d.max(), (d[far] > 1).mean())
    assert len(outliers) <= 0.005 * W * H
    assert (d > 4).mean() <= 0.01, ((d > 4).sum(), d.max())
    for y, x in np.argwhere(d > 4):
        assert any(abs(y - oy) <= 8 and abs(x - ox) <= 8 for oy, ox in outliers), (y, x, d[y, x])
    assert (pimg[..., 3] == 255).all() and pimg[..., :3].std() > 10


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_engine_frames_match_jax(frames, frame):
    _assert_frame_matches(frames[frame])


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_mesh_engine_frames_match_jax(mesh_frames, frame):
    """The mesh demo scene through both Engines (mesh_service, BVH build and
    retransform per update, K1's mesh walks, the denoiser) under the same
    bands; both mesh instances are in the frame."""
    fr = mesh_frames[frame]
    _assert_frame_matches(fr)
    ids = set(fr["engine"]._scene_t.mesh.inst.unique().tolist())
    assert ids == {0, 1}
    hdr = fr["phdr"]
    assert np.isfinite(hdr).all()


def test_mesh_engine_builds_each_bvh_once(mesh_frames):
    """Three orbit frames re-flatten the scene three times; each mesh's SAH
    build ran once (the Engine's BLASCache)."""
    assert mesh_frames[-1]["engine"]._blas_cache.build_count == 2


def _pixel_op_by_op(fr, y, x):
    """Linear HDR colour of pixel (y, x) rendered alone by the JAX package
    one operation at a time (one lane, jit disabled); with caustics, plus
    the gather at its first-hit record on the frame's photon map."""
    import jax

    from raytracevs_tpu.ops import render as JR
    from raytracevs_tpu.ops import sampling as JS
    from raytracevs_tpu.ops import wavefront as JW

    flat, cfg = fr["jflat"], fr["jcfg"]
    px, py = jnp.array([x]), jnp.array([y])
    total = np.zeros(3, np.float32)
    prev = jnp.zeros((1,), bool)
    rec = None
    with jax.disable_jit():
        for s in range(cfg.samples_per_pixel):
            ray = JR.primary_rays(flat, cfg, px, py, jnp.uint32(s), JS.blue_noise_tile())
            acc = JW.run_sample(flat, cfg, px, py, jnp.uint32(s), ray, prev)
            if rec is None or (bool(acc.prim_hit[0]) and not bool(prev[0])):
                rec = acc  # the record of the first sample that hits
            prev = prev | acc.prim_hit
            total = total + np.asarray(acc.sample_color)[0]
        if fr["pmap"] is not None:
            jmap = JP.PhotonMap(*(jnp.asarray(a.numpy()) for a in fr["pmap"]))
            delta, _ = JR.caustics_delta(flat, cfg, jmap, prev, rec.prim_pos, rec.prim_normal,
                                         rec.prim_metallic, rec.prim_transmission)
            total = total + np.asarray(delta)[0]
    return total * np.float32(1.0 / cfg.samples_per_pixel)


def test_engine_outliers_are_xla_whole_frame_rounding(frames):
    """Every HDR outlier pixel, rendered alone by the JAX package one
    operation at a time (one lane, jit disabled), matches the port's frame:
    the difference is how XLA's fused whole-frame program rounds."""
    for fr in frames:
        for y, x in _hdr_outliers(fr):
            np.testing.assert_allclose(fr["phdr"][y, x], _pixel_op_by_op(fr, y, x), atol=HDR_ATOL)


def test_engine_metrics_and_pixels(frames):
    pimg, prays, pe = frames[-1]["pimg"], frames[-1]["prays"], frames[-1]["engine"]
    assert pe.get_pixel_data() == pimg.tobytes()
    assert pe.last_rays == prays > W * H
    assert pe.last_render_ms > 0 and pe.last_mrays_per_s > 0
    assert pe._frame_index == 3
    hdr = render_rows_cf(pe._scene_t._replace(frame_index=pe._scene_t.frame_index - 1),
                         pe._cfg).color.permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(pe.last_hdr, hdr)  # last_hdr is the last frame's
    # frames 1 and 2 reprojected history through a moving camera
    assert float(pe._denoise_state.packed[14].max()) == 2.0


def test_import_needs_no_jax():
    code = ("import raytracevs_tpu_torch, raytracevs_tpu_torch.api.cli, "
            "raytracevs_tpu_torch.scene.rtvs, raytracevs_tpu_torch.post.debug_modes, "
            "raytracevs_tpu_torch.models, raytracevs_tpu_torch.runtime.profiler, "
            "raytracevs_tpu_torch.runtime.render_loop, raytracevs_tpu_torch.runtime.cache, "
            "raytracevs_tpu_torch.parallel.tiles, raytracevs_tpu_torch.scene.commands, "
            "raytracevs_tpu_torch.io.settings, raytracevs_tpu_torch.api.viewer, "
            "raytracevs_tpu_torch.utils.ssim, raytracevs_tpu_torch.utils.refcompare, sys; "
            "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules), "
            "[m for m in sys.modules if m.startswith('jax')]")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_cuda_device_requires_cuda():
    if torch.cuda.is_available():
        Engine(8, 8, device="cuda")
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Engine(8, 8, device="cuda")
    with pytest.raises(ValueError):
        Engine(8, 8, device="meta")


def test_engine_defaults_to_the_card():
    """Engine(w, h) targets CUDA: without a card it raises rather than run
    on the CPU, which takes device="cpu"."""
    if torch.cuda.is_available():
        assert Engine(8, 8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(8, 8)
    assert Engine(8, 8, device="cpu").device.type == "cpu"


def test_mesh_scene_raises():
    """A mesh the BVH builder cannot take (no triangles) raises in
    update_scene; without a mesh service the instance is dropped."""
    s = S.demo_scene(PD)
    s.objects.append(PD.MeshObjectData(mesh_name="WineGlass"))
    empty = PMC.MeshCacheService(".")
    empty.register("WineGlass", PMC.CachedMesh("WineGlass", np.zeros(8, np.float32),
                                               np.zeros(0, np.uint32), np.zeros(3), np.zeros(3)))
    with pytest.raises(ValueError, match="empty triangle list"):
        Engine(8, 8, device="cpu", mesh_service=empty).update_scene(s)
    e = Engine(8, 8, device="cpu")
    e.update_scene(s)
    assert e._flat.mesh is None


def test_history_resets_only_on_geometry_change():
    e = Engine(16, 8, device="cpu")
    e.update_scene(S.demo_scene(PD, 0), **S.DEMO_OVERRIDES)
    e.render()
    state = e._denoise_state
    assert state is not None
    e.update_scene(S.demo_scene(PD, 1), **S.DEMO_OVERRIDES)  # camera moved: kept
    assert e._denoise_state is state
    prev_vp = e._prev_view_proj
    e.render()
    moved = S.demo_scene(PD, 1)
    moved.objects[1].position = moved.objects[1].position + np.array([0.0, 0.1, 0.0])
    e.update_scene(moved, **S.DEMO_OVERRIDES)  # an object moved: reset
    assert e._denoise_state is None
    np.testing.assert_array_equal(e._flat.prev_view_proj, prev_vp)
    assert int(e._flat.frame_index) == 2  # the frame index never resets
    e.render()
    assert float(e._denoise_state.packed[14].max()) == 0.0
    with pytest.raises(RuntimeError):
        Engine(4, 4, device="cpu").render()
