"""The Engine's spans in a torch.profiler trace, on the CPU: each frame's
update_scene and render give one span tree, named and nested as the
stages run, the two top spans carry the frame index; with no profiler
recording, annotate is one shared no-op; and tracing leaves the frames'
bits as they are."""
import json
import os

import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.runtime import profiler as PPROF
from raytracevs_tpu_torch.scene import data as PD

S.one_torch_thread()

W, H, FRAMES = 64, 32, 3

# (span, its parent span) in the order the stages start
UPDATE_TREE = [("rtvs.update_scene", None),
               ("rtvs.scene.sanitize", "rtvs.update_scene"),
               ("rtvs.scene.flatten", "rtvs.update_scene"),
               ("rtvs.scene.checksum", "rtvs.update_scene"),
               ("rtvs.scene.to_device", "rtvs.update_scene")]
DENOISE_TREE = [("rtvs.denoise", "rtvs.render"),
                ("rtvs.denoise.prepass", "rtvs.denoise"),
                ("rtvs.denoise.reproject", "rtvs.denoise"),
                ("rtvs.denoise.guide", "rtvs.denoise"),
                ("rtvs.denoise.atrous", "rtvs.denoise"),
                ("rtvs.denoise.shadow", "rtvs.denoise")]


CAUSTICS_TREE = [("rtvs.render.caustics", "rtvs.render"),
                 ("rtvs.render.caustics.emit_trace", "rtvs.render.caustics"),
                 ("rtvs.render.caustics.hash", "rtvs.render.caustics"),
                 ("rtvs.render.caustics.gather", "rtvs.render.caustics")]


def render_tree(caustics: bool):
    return ([("rtvs.render", None), ("rtvs.render.pack_tables", "rtvs.render"),
             ("rtvs.render.trace", "rtvs.render")]
            + CAUSTICS_TREE * caustics
            + [("rtvs.render.assemble", "rtvs.render")] + DENOISE_TREE
            + [("rtvs.render.composite", "rtvs.render"), ("rtvs.render.readback", "rtvs.render")])


# one sample and one bounce: the spans are the same at any budget, and the
# profiler records each of the plain pipeline's operations
BUDGET = {"samples_per_pixel": 1, "max_bounces": 1}


def scene(name: str, frame: int):
    if name == "demo":
        return S.demo_scene(PD, frame)
    return S.caustics_golden_scene(PD, frame)


def frames(name: str, n: int):
    """n frames of a new CPU Engine: [(rgba, rays, denoiser history)]."""
    eng = Engine(W, H, device="cpu")
    out = []
    for f in range(n):
        eng.update_scene(scene(name, f), **BUDGET)
        rgba = eng.render()
        out.append((rgba, eng.last_rays, eng._denoise_state.packed.clone()))
    return out


def traced(name: str, n: int):
    """frames(name, n) under torch.profiler (the host's events, with the
    spans' keywords): (frames, the profile's rtvs. spans as kineto events)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        out = frames(name, n)
    return out, [e for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("rtvs.")]


def span_trees(spans):
    """[[(name, parent span's name, frame keyword)]] a top span, each tree
    in start order; a span's parent is the innermost span around it."""
    trees, open_ = [], []
    for e in sorted(spans, key=lambda e: (e.start_ns(), -e.end_ns())):
        while open_ and open_[-1].end_ns() <= e.start_ns():
            open_.pop()
        if not open_:
            trees.append([])
        parent = open_[-1].name() if open_ else None
        trees[-1].append((e.name(), parent, e.kwinputs().get("frame")))
        open_.append(e)
    return trees


@pytest.fixture(scope="module")
def demo_runs():
    return traced("demo", FRAMES), frames("demo", FRAMES)


@pytest.mark.parametrize("name", ["demo", "caustics"])
def test_each_frame_gives_the_span_tree(name, demo_runs):
    """Each frame's update_scene and render give exactly the listed spans,
    each once, nested as listed; the two top spans carry the frame index."""
    n = FRAMES if name == "demo" else 1
    _, spans = demo_runs[0] if name == "demo" else traced(name, n)
    trees = span_trees(spans)
    want = []
    for f in range(n):
        for tree in (UPDATE_TREE, render_tree(name == "caustics")):
            want.append([(span, parent, f if parent is None else None)
                         for span, parent in tree])
    assert trees == want


@pytest.mark.parametrize("name", ["demo", "caustics"])
def test_each_caustics_frame_counts_one_hash_build_and_its_photons(name):
    """Golden config 5 builds the photon hash once a frame and traces the
    photon budget, 8,192 photons (one point light); the demo scene, with
    caustics off, builds none and reports 0."""
    from raytracevs_tpu_torch.ops import photon as PP

    eng = Engine(W, H, device="cpu")
    for f in range(2):
        eng.update_scene(scene(name, f), **BUDGET)
        before = PP.build_photon_hash.launches
        eng.render()
        assert PP.build_photon_hash.launches - before == (name == "caustics")
        assert eng.last_photons == (8192 if name == "caustics" else 0)
        assert isinstance(eng.last_photons, int)


def test_annotate_is_one_shared_no_op_without_a_profiler():
    """With no profiler recording annotate returns one shared object that
    does nothing; while one records, a span of its own each call."""
    a, b = PPROF.annotate("rtvs.render", 3), PPROF.annotate("rtvs.render.trace")
    assert a is b
    with a:
        with b:
            pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = PPROF.annotate("rtvs.x", 3)
        assert on is not a and PPROF.annotate("rtvs.x") is not on
        with on:
            pass
    assert [e.name for e in prof.events()] == ["rtvs.x"]
    assert PPROF.annotate("rtvs.x") is a


def test_frames_are_bit_identical_with_and_without_a_profiler(demo_runs):
    """The RGBA8 frames, ray counts and denoiser histories of frames
    rendered under the profiler equal those of frames rendered without."""
    (on, _), off = demo_runs
    for (rgba, rays, hist), (rgba0, rays0, hist0) in zip(on, off, strict=True):
        assert np.array_equal(rgba, rgba0) and rays == rays0
        assert torch.equal(hist, hist0)


def test_device_trace_exports_the_spans_with_their_frame(tmp_path):
    """device_trace's exported trace holds the frame's spans, the top two
    with the frame index among their args."""
    eng = Engine(16, 8, device="cpu")
    eng.update_scene(S.demo_scene(PD), **BUDGET)
    eng.render()
    with PPROF.device_trace(str(tmp_path)):
        eng.update_scene(S.demo_scene(PD, 1), **BUDGET)
        eng.render()
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    with open(tmp_path / path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("name", "").startswith("rtvs.")]
    names = {e["name"] for e in events}
    assert {s for s, _ in UPDATE_TREE + render_tree(False)} == names
    tops = {e["name"]: e["args"].get("frame") for e in events
            if e["name"] in ("rtvs.update_scene", "rtvs.render")}
    assert tops == {"rtvs.update_scene": 1, "rtvs.render": 1}
