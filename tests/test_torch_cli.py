"""The port's command-line renderer (api/cli.py) with --cpu on .rtvs files
written in code: --frames 2 --json, --orbit with --save-frames,
--debug-view and --photon-debug, each PNG equal to the frame of an Engine
driven by hand; and the same flags through the JAX package's CLI, in
test_torch_engine.py's band (the JAX CLI fed the port's photon map,
ROADMAP C8)."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_scenes as S
import raytracevs_tpu.models as JM
import raytracevs_tpu.scene.graph as JG
import raytracevs_tpu.scene.rtvs as JR
from raytracevs_tpu.api import cli as jcli
from raytracevs_tpu.ops import photon as JP
from raytracevs_tpu.runtime import engine as JENG
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.api import cli
from raytracevs_tpu_torch.io.png import read_png
from raytracevs_tpu_torch.ops import photon as PP
from raytracevs_tpu_torch.runtime import engine as PENG
from raytracevs_tpu_torch.scene import data as PD
from test_torch_engine import _assert_frame_matches

S.one_torch_thread()

W, H = 64, 32
SIZE = ["-W", str(W), "-H", str(H), "--cpu"]


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    """The demo scene as a .rtvs file (the JAX package's save_graph)."""
    path = str(tmp_path_factory.mktemp("scene") / "demo.rtvs")
    JR.save_graph(S.scene_graph(JM, JG, S.demo_scene(PD), [S.DEMO_BOX_QUAT]), path)
    return path


def _engine(path, **over):
    eng = Engine(W, H, device="cpu")
    eng.load_rtvs(path, **over)
    return eng


def test_cli_frames_json(scene_file, tmp_path, capsys):
    """--frames 2 --json: the PNG is the second frame of an Engine that
    loaded the file; the JSON line carries the stats."""
    out = tmp_path / "out.png"
    rc = cli.main([scene_file, "-o", str(out), *SIZE, "--frames", "2", "--json"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (stats["width"], stats["height"], stats["output"]) == (W, H, str(out))
    assert stats["first_frame_ms"] > 0 and stats["steady_frame_ms"] > 0
    eng = _engine(scene_file)
    eng.render()
    want = eng.render()
    assert stats["rays_per_frame"] == eng.last_rays
    np.testing.assert_array_equal(read_png(str(out)), want)


def test_cli_orbit_save_frames(scene_file, tmp_path):
    """--orbit 12 --frames 3 --save-frames --denoise: one PNG a frame, each
    the frame of an Engine orbited by hand, the last one the output."""
    outdir = tmp_path / "anim"
    rc = cli.main([scene_file, "-o", str(tmp_path / "last.png"), *SIZE, "--spp", "1",
                   "--frames", "3", "--orbit", "12", "--denoise", "--save-frames",
                   str(outdir)])
    assert rc == 0
    frames = sorted(outdir.glob("frame_*.png"))
    assert [f.name for f in frames] == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    imgs = [read_png(str(f)) for f in frames]
    over = dict(samples_per_pixel=1, enable_denoiser=True)
    eng = _engine(scene_file, **over)
    look = np.asarray(eng._scene.camera.look_at, float)
    rel = np.asarray(eng._scene.camera.position, float) - look
    for f, img in enumerate(imgs):
        if f:
            a = np.radians(12.0 * f)
            eng._scene.camera.position = look + np.array(
                [rel[0] * np.cos(a) + rel[2] * np.sin(a), rel[1],
                 -rel[0] * np.sin(a) + rel[2] * np.cos(a)])
            eng.update_scene(eng._scene, **over)
        np.testing.assert_array_equal(img, eng.render())
    assert not np.array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(read_png(str(tmp_path / "last.png")), imgs[2])


@pytest.mark.parametrize("view", [1, 4, 10])
def test_cli_debug_view(scene_file, tmp_path, view):
    out = tmp_path / "dbg.png"
    assert cli.main([scene_file, "-o", str(out), *SIZE, "--debug-view", str(view)]) == 0
    eng = _engine(scene_file)
    eng.render()
    np.testing.assert_array_equal(read_png(str(out)), eng.render_debug_view(view))


def test_cli_photon_debug(scene_file, tmp_path):
    """--photon-debug 3 --photon-scale 4 --caustics: the Engine's frame with
    those overrides; a mode outside 0-12 and a missing file fail."""
    out = tmp_path / "pd.png"
    assert cli.main([scene_file, "-o", str(out), *SIZE, "--caustics", "--photon-debug", "3",
                     "--photon-scale", "4"]) == 0
    eng = _engine(scene_file, enable_caustics=True, photon_debug_mode=3,
                  photon_debug_scale=4.0)
    np.testing.assert_array_equal(read_png(str(out)), eng.render())
    assert cli.main([scene_file, "-o", str(out), *SIZE, "--photon-debug", "13"]) == 1
    assert cli.main([str(tmp_path / "nope.rtvs"), "-o", str(out), *SIZE]) == 1


def test_cli_needs_the_card_without_cpu(scene_file, tmp_path):
    """Without --cpu the CLI renders on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would render on it")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([scene_file, "-o", str(tmp_path / "x.png"), "-W", "8", "-H", "8"])


@pytest.mark.parametrize("how", ["dir", "tiers", "default"])
def test_cli_cache_dir(scene_file, tmp_path, monkeypatch, how):
    """--cache-dir DIR puts the converted-mesh cache in DIR/meshcache,
    --cache-dir alone in the directory runtime/cache.py's tiers name
    ($RAYTRACEVS_TPU_CACHE here), no flag in the package's _build/, which
    the tiers never reach."""
    import os

    from raytracevs_tpu_torch.ops.cuda import _build

    monkeypatch.setenv("RAYTRACEVS_MODEL_PATH", str(tmp_path / "models"))
    (tmp_path / "models").mkdir()
    monkeypatch.setenv("RAYTRACEVS_TPU_CACHE", str(tmp_path / "env"))
    monkeypatch.chdir(tmp_path)
    made = _recording(monkeypatch, PENG, PENG.Engine)
    flag = {"dir": ["--cache-dir", str(tmp_path / "mine")], "tiers": ["--cache-dir"],
            "default": []}[how]
    assert cli.main([scene_file, "-o", str(tmp_path / "c.png"), "-W", "16", "-H", "8", "--cpu",
                     *flag]) == 0
    want = {"dir": str(tmp_path / "mine"), "tiers": str(tmp_path / "env"),
            "default": _build.BUILD_DIR}[how]
    assert made[0].mesh_service.cache_dir == os.path.join(want, "meshcache")
    assert os.path.isdir(made[0].mesh_service.cache_dir)


def _recording(monkeypatch, module, cls, **fixed):
    """Patch module.Engine with a subclass that keeps its instances."""
    made = []

    class Rec(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **dict(k, **fixed))
            made.append(self)

    monkeypatch.setattr(module, "Engine", Rec)
    return made


@pytest.mark.parametrize("flags", [["--frames", "2", "--orbit", "12", "--json"],
                                   ["--caustics", "--photon-debug", "3", "--photon-scale",
                                    "4"]], ids=["orbit", "photon_debug"])
def test_cli_matches_the_jax_cli(scene_file, tmp_path, monkeypatch, flags):
    """The same flags through both CLIs (the JAX Engine on one device),
    the PNGs in the engine band."""
    pmade = _recording(monkeypatch, PENG, PENG.Engine)
    jmade = _recording(monkeypatch, JENG, JENG.Engine, device_mesh=None)
    pout, jout = tmp_path / "port.png", tmp_path / "jax.png"
    assert cli.main([scene_file, "-o", str(pout), *SIZE, *flags]) == 0
    pe = pmade[0]
    if pe._cfg.num_photons:
        pmap = PP.emit_and_trace(pe._scene_t._replace(frame_index=torch.tensor(0)),
                                 pe._cfg.num_photons)
        jmap = JP.PhotonMap(*(jnp.asarray(a.numpy()) for a in pmap))
        monkeypatch.setattr(JP, "emit_and_trace", lambda *a, **k: jmap)
    assert jcli.main([scene_file, "-o", str(jout), *SIZE, *flags]) == 0
    je = jmade[0]
    fr = dict(pimg=read_png(str(pout)), jimg=read_png(str(jout)), prays=pe.last_rays,
              jrays=je.last_rays, phdr=pe.last_hdr, jhdr=je.last_hdr)
    _assert_frame_matches(fr, far_only=bool(pe._cfg.num_photons))
