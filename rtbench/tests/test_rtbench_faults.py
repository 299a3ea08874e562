"""The check against faults planted in the timed path, and its control.

Each run goes through the harness as run.py drives it, past its look for a
card, on the CPU at a small size: the port's wrappers run their plain
versions there, so a sound run reads 0 on every number, and a run with the
path broken underneath has to come out not correct. The control (the
reference with bfloat16 planes and history in the program's place) has to
fail a limit too.
"""
import json
import os
import time

import pytest
import torch

from rtbench.core import check, spec, window
from rtbench.core.runner import run_cell

SIZE = (48, 24)


def run(workload="demo.orbit", seconds=3.0, seed=2**31 + 77):
    cell = spec.load_cell(workload)
    return run_cell(cell, seed, seconds, False, "cpu", time.perf_counter(), size=SIZE)


def state_unchanged(monkeypatch):
    """The denoiser's step returns its history unchanged."""
    from raytracevs_tpu_torch.ops.cuda import denoise_kernels

    monkeypatch.setattr(denoise_kernels, "reproject_accumulate",
                        lambda packed, *a, **k: packed.clone())


def half_batch(monkeypatch):
    """Half of each pixel's samples left out, the mean taken over the rest."""
    from raytracevs_tpu_torch.ops import render as R
    from raytracevs_tpu_torch.ops.cuda import megakernel

    real = megakernel.render_accum

    def render_accum(scene, cfg, **kw):
        acc = real(scene, cfg._replace(samples_per_pixel=cfg.samples_per_pixel // 2), **kw)
        acc[R.CH_COLOR:R.CH_RAYS + 1] *= 2.0
        return acc

    monkeypatch.setattr(megakernel, "render_accum", render_accum)


def pixel_altered(monkeypatch):
    """One pixel of every frame altered where the RGBA8 frame is made."""
    from raytracevs_tpu_torch.post import tonemap

    real = tonemap.to_rgba8_cf

    def to_rgba8_cf(color01):
        out = real(color01)
        h, w = out.shape[:2]
        out[h // 2, w // 2, 0] ^= 128
        return out

    monkeypatch.setattr(tonemap, "to_rgba8_cf", to_rgba8_cf)


def caustic_skipped(monkeypatch):
    """The photon pass skipped: the frame is assembled without its caustic."""
    from raytracevs_tpu_torch.ops import render_cf

    monkeypatch.setattr(render_cf, "apply_caustics_cf", lambda scene, cfg, acc, *a, **k: acc)


def test_a_sound_run_is_correct():
    res = run()
    assert res["correct"], res["check"]
    assert all(v["value"] == 0 for v in res["check"].values())


@pytest.mark.parametrize("fault, caught_by", [(state_unchanged, "plane_err"),
                                               (half_batch, "rgb_off_share"),
                                               (half_batch, "rays_off"),
                                               (pixel_altered, "rgb_max_step")])
def test_a_fault_is_not_correct(fault, caught_by, monkeypatch):
    fault(monkeypatch)
    res = run()
    assert not res["correct"], res["check"]
    assert res["check"][caught_by]["value"] > res["check"][caught_by]["limit"], res["check"]


def test_the_mesh_cell_catches_an_altered_pixel(monkeypatch, tmp_path):
    """mesh_demo.orbit, kept under configs/ for a later cell (PERF.md, Open
    questions), composed in a root of its own beside BENCHMARK.json's."""
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "mesh_demo", "source": "test", "reduced": [], "why": "test",
                         "file": "rtbench/configs/mesh_demo.py"})
    b["workloads"].append({"name": "mesh_demo.orbit", "config": "mesh_demo", "traffic": "orbit",
                           "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    os.symlink(os.path.join(spec.ROOT, "rtbench"), tmp_path / "rtbench")
    pixel_altered(monkeypatch)
    cell = spec.load_cell("mesh_demo.orbit", str(tmp_path))
    res = run_cell(cell, 2**31 + 77, 0.5, False, "cpu", time.perf_counter(), size=SIZE)
    assert not res["correct"], res["check"]
    assert res["check"]["rgb_max_step"]["value"] == 128


@pytest.mark.parametrize("fault", [None, caustic_skipped])
def test_the_caustics_check(fault, caustics_config, monkeypatch):
    """The demo configuration with caustics on, a module local to the tests
    with its cell built here (not from BENCHMARK.json), under orbit: sound,
    the run is correct at 0 on every number; with the port's caustic
    skipped, it is not."""
    with open(os.path.join(spec.ROOT, "rtbench", "traffic", "orbit.json")) as f:
        traffic = json.load(f)
    cell = spec.Cell("demo_caustics.orbit", caustics_config, traffic, [], [], {}, 1)
    if fault is not None:
        fault(monkeypatch)
    res = run_cell(cell, 2**31 + 79, 3.0, False, "cpu", time.perf_counter(), size=SIZE)
    if fault is None:
        assert res["correct"], res["check"]
        assert all(v["value"] == 0 for v in res["check"].values()), res["check"]
    else:
        assert not res["correct"], res["check"]
        assert res["check"]["rgb_off_share"]["value"] > res["check"]["rgb_off_share"]["limit"]


def test_the_control_fails_a_limit():
    """The reference with its radiance planes and history stored as
    bfloat16, in the program's place, exceeds a limit; the program does not."""
    cell = spec.load_cell("demo.orbit")
    out = window.run_window(cell, 2**31 + 78, 3.0, False, "cpu", time.perf_counter(), SIZE)
    prog, low = check.compare(cell.config, out["traffic"], out["checked"], out["size"], "cpu",
                              control=True)
    limits = cell.config.LIMITS
    assert all(prog[k] <= limits[k] for k in check.NUMBERS), prog
    assert any(low[k] > limits[k] for k in check.NUMBERS), low
    assert torch.get_num_threads() == 1
