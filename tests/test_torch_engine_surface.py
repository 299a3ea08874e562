"""The rest of the port's Engine surface against raytracevs_tpu's, on the CPU:
render(fail_safe=True) and its fills, copy_pixels_into's five fills (the
cases of tests/test_render.py:240-262), validate_frame's verdict and
violations, and the runtime modules runtime/{profiler,render_loop,cache}.py
and utils/logging.py (the cases of tests/test_aux.py:76-95 and :120-138,
tests/test_render.py::test_render_loop_coalesces_updates)."""
import logging as pylogging
import os
import re
import time

import numpy as np
import pytest

import _torch_scenes as S
from raytracevs_tpu import Engine as JEngine
from raytracevs_tpu.runtime import cache as JC
from raytracevs_tpu.runtime import profiler as JPROF
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.io import native
from raytracevs_tpu_torch.ops.cuda import _build
from raytracevs_tpu_torch.runtime import cache as PC
from raytracevs_tpu_torch.runtime import engine as PENG
from raytracevs_tpu_torch.runtime import profiler as PPROF
from raytracevs_tpu_torch.runtime.render_loop import RenderLoop
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.utils import logging as plog

S.one_torch_thread()

W, H = 16, 8


def _engines(build=S.demo_scene, **over):
    pe, je = Engine(W, H, device="cpu"), JEngine(W, H, backend="jnp", device_mesh=None)
    pe.update_scene(build(PD), **over)
    je.update_scene(build(JD), **over)
    return pe, je


# ---- render(fail_safe=True) ------------------------------------------------

def test_fail_safe_magenta_on_an_exception():
    """A render that raises (no scene yet) returns the magenta fill, as in
    the JAX Engine, and logs the failure."""
    for eng in (Engine(W, H, device="cpu"), JEngine(W, H, backend="jnp", device_mesh=None)):
        with pytest.raises(RuntimeError):
            eng.render()
        img = eng.render(fail_safe=True)
        assert img.shape == (H, W, 4) and img.dtype == np.uint8
        assert (img.reshape(-1, 4) == [255, 0, 255, 255]).all()


def test_fail_safe_orange_on_an_all_zero_frame_and_the_frame_otherwise(monkeypatch):
    """fail_safe=True returns the frame itself when it renders, and the
    orange fill when the frame is all zeros."""
    pe, _ = _engines(**S.DEMO_OVERRIDES)
    ref = Engine(W, H, device="cpu")
    ref.update_scene(S.demo_scene(PD), **S.DEMO_OVERRIDES)
    np.testing.assert_array_equal(pe.render(fail_safe=True), ref.render())
    real = PENG.render_frame

    def black(*a, **k):
        out = real(*a, **k)
        return (out[0] * 0,) + out[1:]

    monkeypatch.setattr(PENG, "render_frame", black)
    img = pe.render(fail_safe=True)
    assert (img.reshape(-1, 4) == [255, 165, 0, 255]).all()


# ---- copy_pixels_into ------------------------------------------------------

def _fills(eng):
    """copy_pixels_into's result and first pixel on a clean frame, then a
    buffer too small, an all-zero frame, and a frame of the wrong size (an
    exception inside: magenta)."""
    needed = eng.width * eng.height * 4
    out = []
    buf = bytearray(needed)
    out.append((eng.copy_pixels_into(buf), bytes(buf) == eng.get_pixel_data()))
    small = bytearray(needed // 2)
    out.append((eng.copy_pixels_into(small), bytes(small[0:4])))
    last = eng._last_rgba
    eng._last_rgba = np.zeros_like(last)
    out.append((eng.copy_pixels_into(buf), bytes(buf[0:4])))
    eng._last_rgba = np.ones((2, 2, 4), np.uint8)
    out.append((eng.copy_pixels_into(buf), bytes(buf[0:4])))
    eng._last_rgba = last
    return out


def test_copy_pixels_into_fills_match_jax():
    pe, je = _engines(**S.DEMO_OVERRIDES)
    pe.render()
    je.render()
    got, want = _fills(pe), _fills(je)
    assert got == want
    assert got == [(True, True), (False, bytes([255, 255, 0, 255])),
                   (False, bytes([255, 165, 0, 255])), (False, bytes([255, 0, 255, 255]))]
    for eng in (Engine(8, 8, device="cpu"), JEngine(8, 8, backend="jnp", device_mesh=None)):
        buf8 = bytearray(8 * 8 * 4)
        assert eng.copy_pixels_into(buf8) is False
        assert buf8[0:4] == bytes([0, 255, 0, 255])  # green: nothing rendered
    for eng in (Engine(0, 0, device="cpu"), JEngine(0, 0, backend="jnp", device_mesh=None)):
        z = bytearray(16)
        assert eng.copy_pixels_into(z) is False
        assert z[0:4] == bytes([255, 0, 0, 255])  # red: zero-size frame


# ---- validate_frame --------------------------------------------------------

def _normalized(violations):
    """The violation messages with their numbers at 4 significant digits
    (the two renderers agree to float rounding)."""
    num = re.compile(r"-?\d+\.\d+(e[-+]\d+)?|-?\d+e[-+]\d+")
    return [num.sub(lambda m: f"{float(m.group()):.4g}", v) for v in violations]


@pytest.mark.parametrize("name", ["demo", "config3_glass_soft"])
def test_validate_frame_matches_jax(name):
    """The same verdict (ok) and no violation on the demo scene and a golden
    config, without advancing the frame."""
    scene_over = (S.demo_scene, S.DEMO_OVERRIDES) if name == "demo" else \
        (lambda D: S.golden_scene(D, name)[0], S.golden_scene(PD, name)[1])
    pe, je = _engines(scene_over[0], **scene_over[1])
    got, want = pe.validate_frame(), je.validate_frame()
    assert got == want == {"ok": True, "violations": []}
    assert pe._frame_index == 0


@pytest.mark.parametrize("fault", ["nan", "negative"])
def test_validate_frame_reports_what_jax_reports(fault, monkeypatch):
    """A colour plane made non-finite or negative at one pixel: both Engines
    report the same violation."""
    pe, je = _engines(**S.DEMO_OVERRIDES)
    bad = float("nan") if fault == "nan" else -1.0
    real_p = PENG.render_rows_cf

    def port_rows(*a, **k):
        out = real_p(*a, **k)
        color = out.color.clone()
        color[1, 0, 0] = bad
        return out._replace(color=color)

    from raytracevs_tpu.ops import render as JR

    real_j = JR.render_rows

    def jax_rows(*a, **k):
        out = real_j(*a, **k)
        return out._replace(color=out.color.at[0, 1].set(bad))

    monkeypatch.setattr(PENG, "render_rows_cf", port_rows)
    monkeypatch.setattr(JR, "render_rows", jax_rows)
    got, want = pe.validate_frame(), je.validate_frame()
    assert not got["ok"] and not want["ok"]
    assert _normalized(got["violations"]) == _normalized(want["violations"])
    assert got["violations"][0].startswith("color: ")


# ---- profiler, render loop -------------------------------------------------

def test_profiler_matches_jax():
    """RenderProfiler drops the first (build) frame; FrameStats' Mrays/s."""
    for prof_mod in (PPROF, JPROF):
        prof = prof_mod.RenderProfiler()
        prof.record(1000.0, 10)
        prof.record(10.0, 1_000_000)
        prof.record(20.0, 2_000_000)
        assert len(prof.frames) == 2
        assert prof.mean_frame_ms == 15.0 and prof.best_frame_ms == 10.0
        assert prof.fps == pytest.approx(1000.0 / 15.0)
        assert prof.summary()["frames"] == 2
        assert prof_mod.FrameStats(frame_ms=10.0, rays=5_000_000).mrays_per_s == 500.0
        assert prof_mod.FrameStats(frame_ms=0.0, rays=1).mrays_per_s == 0.0
    assert PPROF.RenderProfiler().summary() == JPROF.RenderProfiler().summary()


def test_profile_engine_and_device_trace(tmp_path):
    """profile_engine over a CPU Engine, inside device_trace, which writes
    a torch.profiler trace into its directory; annotate names a region."""
    pe, _ = _engines(**S.DEMO_OVERRIDES)
    with PPROF.device_trace(str(tmp_path / "trace")):
        with PPROF.annotate("frames"):
            s = PPROF.profile_engine(pe, frames=2)
    assert s["frames"] == 2 and s["mean_frame_ms"] > 0 and s["mean_mrays_per_s"] > 0
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


def test_render_loop_coalesces_updates():
    """Rapid scene submissions coalesce, the newest wins
    (RenderWindow.xaml.cs:347-451)."""
    eng = Engine(W, H, device="cpu")
    frames = []
    loop = RenderLoop(eng, on_frame=lambda img, ms: frames.append((img, ms)))
    for r in (0.5, 0.7, 0.9, 1.1, 1.3):
        scene = S.golden_scene(PD, "config1_hard_shadows")[0]
        scene.objects[0] = PD.SphereData(position=np.array([0.0, 1.0, 0.0]), radius=r)
        loop.submit_scene(scene)
    assert loop.frames_coalesced == 4
    loop.start()
    deadline = time.time() + 120
    while not frames and time.time() < deadline:
        time.sleep(0.05)
    loop.stop()
    assert frames, "no frame rendered"
    img, ms = frames[0]
    assert img.shape == (H, W, 4) and ms > 0
    assert eng._scene.objects[0].radius == 1.3


# ---- cache tiers -----------------------------------------------------------

def test_cache_tiers(tmp_path, monkeypatch):
    """rtvs_config.ini's jitCachePath up to six levels up, then
    RAYTRACEVS_TPU_CACHE, as the JAX package resolves them; neither moves
    the libraries out of the package's _build/."""
    monkeypatch.delenv("RAYTRACEVS_TPU_CACHE", raising=False)
    deep = tmp_path / "a" / "b" / "c"
    deep.mkdir(parents=True)
    monkeypatch.chdir(deep)
    assert PC.resolve_cache_dir() is None
    env = str(tmp_path / "env")
    monkeypatch.setenv("RAYTRACEVS_TPU_CACHE", env)
    assert PC.resolve_cache_dir() == JC.resolve_cache_dir() == env
    (tmp_path / "a" / "rtvs_config.ini").write_text("# cache\njitCachePath=~/kernels\n")
    assert PC.resolve_cache_dir() == JC.resolve_cache_dir() == os.path.expanduser("~/kernels")
    assert PC.resolve_cache_dir(str(tmp_path)) == env  # the ini is below tmp_path
    assert os.path.dirname(_build.library_path()) == _build.BUILD_DIR
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR


# ---- logging ---------------------------------------------------------------

def test_warnings_and_errors_always_log(caplog):
    with caplog.at_level(pylogging.DEBUG, logger="raytracevs_tpu_torch"):
        plog.log_error("boom %d", 1)
        plog.log_warning("careful %s", "now")  # needs no opt-in
        plog.log_debug("hidden unless enabled")
    msgs = [r.getMessage() for r in caplog.records]
    assert "boom 1" in msgs and "careful now" in msgs
    assert "hidden unless enabled" not in msgs


def test_update_scene_dumps_the_scene_when_logging_is_on(tmp_path, monkeypatch):
    """With logging enabled, update_scene logs the JAX Engine's scene dump
    (EngineWrapper.cpp:222-230) into the log file."""
    path = tmp_path / "debug.log"
    monkeypatch.setattr(plog, "_enabled", False)
    monkeypatch.setattr(plog, "_file_handler", None)
    level = plog._logger.level
    plog.set_log_enabled(True, str(path))
    try:
        Engine(W, H, device="cpu").update_scene(S.demo_scene(PD))
    finally:
        plog._logger.removeHandler(plog._file_handler)
        plog._file_handler.close()
        plog._logger.setLevel(level)
    text = path.read_text()
    assert ("UpdateScene: 5 objects (PlaneData, SphereData, SphereData, SphereData, BoxData), "
            "3 lights, spp=2 bounces=6") in text
