"""The port's Engine end to end on the CPU vs raytracevs_tpu's Engine
(backend "jnp", no device mesh), over three frames of the orbiting demo
scene with the denoiser on; plus the Engine's contract: no JAX import,
device handling, mesh rejection and the checksum-keyed history reset.

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

import _torch_scenes as S
from raytracevs_tpu import Engine as JEngine
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.ops.render_cf import render_rows_cf
from raytracevs_tpu_torch.scene import data as PD

W, H = 64, 32


HDR_ATOL = 2e-4


@pytest.fixture(scope="module")
def frames():
    je = JEngine(W, H, backend="jnp", device_mesh=None)
    pe = Engine(W, H, device="cpu")
    out = []
    for f in range(3):
        je.update_scene(S.demo_scene(JD, f), **S.DEMO_OVERRIDES)
        pe.update_scene(S.demo_scene(PD, f), **S.DEMO_OVERRIDES)
        port_hdr = render_rows_cf(pe._scene_t, pe._cfg).color.permute(1, 2, 0).numpy()
        jflat, jcfg = je._flat, je._cfg
        out.append(dict(jimg=je.render(), pimg=pe.render(), jrays=je.last_rays,
                        prays=pe.last_rays, engine=pe, jhdr=je.last_hdr, phdr=port_hdr,
                        jflat=jflat, jcfg=jcfg))
    return out


def _hdr_outliers(fr):
    return np.argwhere(np.abs(fr["phdr"] - fr["jhdr"]).max(axis=-1) > HDR_ATOL)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_engine_frames_match_jax(frames, frame):
    fr = frames[frame]
    pimg, jimg = fr["pimg"], fr["jimg"]
    assert pimg.shape == (H, W, 4) and pimg.dtype == np.uint8
    assert fr["prays"] == fr["jrays"]
    d = np.abs(pimg.astype(np.int16) - jimg.astype(np.int16)).max(axis=-1)
    assert (d <= 1).mean() >= 0.995, (d.max(), (d > 1).mean())
    outliers = _hdr_outliers(fr)
    assert len(outliers) <= 0.005 * W * H
    assert (d > 4).mean() <= 0.01, ((d > 4).sum(), d.max())
    for y, x in np.argwhere(d > 4):
        assert any(abs(y - oy) <= 8 and abs(x - ox) <= 8 for oy, ox in outliers), (y, x, d[y, x])
    assert (pimg[..., 3] == 255).all() and pimg[..., :3].std() > 10


def test_engine_outliers_are_xla_whole_frame_rounding(frames):
    """Every HDR outlier pixel, rendered alone by the JAX package one
    operation at a time (one lane, jit disabled), matches the port's frame:
    the difference is how XLA's fused whole-frame program rounds."""
    import jax
    import jax.numpy as jnp

    from raytracevs_tpu.ops import render as JR
    from raytracevs_tpu.ops import sampling as JS
    from raytracevs_tpu.ops import wavefront as JW

    for fr in frames:
        flat, cfg = fr["jflat"], fr["jcfg"]
        for y, x in _hdr_outliers(fr):
            px, py = jnp.array([x]), jnp.array([y])
            total = np.zeros(3, np.float32)
            prev = jnp.zeros((1,), bool)
            with jax.disable_jit():
                for s in range(cfg.samples_per_pixel):
                    ray = JR.primary_rays(flat, cfg, px, py, jnp.uint32(s), JS.blue_noise_tile())
                    acc = JW.run_sample(flat, cfg, px, py, jnp.uint32(s), ray, prev)
                    prev = prev | acc.prim_hit
                    total = total + np.asarray(acc.sample_color)[0]
            np.testing.assert_allclose(fr["phdr"][y, x], total * np.float32(0.5), atol=HDR_ATOL)


def test_engine_metrics_and_pixels(frames):
    pimg, prays, pe = frames[-1]["pimg"], frames[-1]["prays"], frames[-1]["engine"]
    assert pe.get_pixel_data() == pimg.tobytes()
    assert pe.last_rays == prays > W * H
    assert pe.last_render_ms > 0 and pe.last_mrays_per_s > 0
    assert pe._frame_index == 3
    # frames 1 and 2 reprojected history through a moving camera
    assert float(pe._denoise_state.packed[14].max()) == 2.0


def test_import_needs_no_jax():
    code = ("import raytracevs_tpu_torch, sys; "
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


def test_mesh_scene_raises():
    s = S.demo_scene(PD)
    s.objects.append(PD.MeshObjectData(mesh_name="WineGlass"))
    with pytest.raises(NotImplementedError, match="mesh"):
        Engine(8, 8).update_scene(s)


def test_history_resets_only_on_geometry_change():
    e = Engine(16, 8)
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
        Engine(4, 4).render()
