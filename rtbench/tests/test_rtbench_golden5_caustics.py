"""The configuration golden5_caustics: its scene is golden config 5, the
frozen reference equals the port's plain CPU path on it frame by frame at
64x36 under the still mix (caustics, depth of field, ACES, the denoiser's
accumulation), and photon_pass_ms reads the stretch from K5 to K6."""
import dataclasses
import json
import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from rtbench.core import check, spec, trace, window
from rtbench.core.traffic import Traffic
from rtbench.core.window import FrameRecord, Run
from rtbench.reference import frame as ref_frame
from rtbench.reference.ops import photon as ref_photon

BASE = os.path.join(spec.ROOT, "rtbench")


def config():
    return spec.load_module(os.path.join(BASE, "configs", "golden5_caustics.py"),
                            "test_golden5_caustics")


def same(a, b) -> bool:
    """Scene records equal field by field (arrays by value)."""
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and all(
            same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return a == b


def test_the_scene_is_golden_config_5_at_1080p():
    """At azimuth 0 the scene equals tests/_torch_scenes.py's golden config 5
    (tests/test_golden.py's config5_caustics_denoise), in every field."""
    sys.path.insert(0, os.path.join(spec.ROOT, "tests"))
    try:
        import _torch_scenes as S
    finally:
        sys.path.pop(0)
    from raytracevs_tpu_torch.scene import data, transform

    cfg = config()
    want, overrides = S.golden_scene(data, "config5_caustics_denoise")
    got = cfg.scene(data, transform, {"azimuth_deg": 0.0})
    assert same(got, want)
    assert overrides == {} and got.settings.enable_caustics
    assert (cfg.WIDTH, cfg.HEIGHT, cfg.REDUCED) == (1920, 1080, [])
    assert cfg.OVERRIDES == {"enable_caustics": True}
    # the camera turns about the look-at point's vertical axis
    turned = cfg.scene(data, transform, {"azimuth_deg": 90.0}).camera.position
    np.testing.assert_allclose(turned, [-5.0, 2.0, 0.0], atol=1e-12)


def test_reference_equals_the_ports_plain_path_under_still():
    cfg = config()
    with open(os.path.join(BASE, "traffic", "still.json")) as f:
        traffic = Traffic(json.load(f), 2**31 + 23)
    prog = window.Program(cfg, traffic, 64, 36, "cpu")
    rep = ref_frame.Replay(64, 36, "cpu", check.reference_meshes(cfg))
    for i in range(3):
        if traffic.updates(i):
            prog.engine.update_scene(prog.scene(i), **cfg.OVERRIDES)
            rep.update_scene(check.reference_scene(cfg, traffic, i), **cfg.OVERRIDES)
        assert rep.cfg.num_photons == 8192
        assert tuple(prog.engine._cfg) == tuple(rep.cfg)
        got = prog.engine.render()
        want = rep.render()
        assert np.array_equal(got, want.rgba.numpy())
        assert prog.engine.last_rays == want.rays
        assert prog.engine.last_photons == 8192
        assert torch.equal(prog.engine._denoise_state.packed, want.history)
        assert torch.equal(prog.engine._last_denoised[2], want.shadow)
        for a, b in zip(prog.engine._flat[:-1], rep.flat[:-1]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert traffic.last_update(2) == 0  # one update_scene, three renders
    # the caustic is there to check: the glass sphere stores photons
    pmap = ref_photon.emit_and_trace(rep.scene_t, rep.cfg.num_photons)
    assert int(pmap.count) > 0


def ev(name, start, end, cuda):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def photon_trace(caustics: bool):
    """Three frames of 100 us (the first skipped): K1, then with caustics K5
    at 20-25 us, the hash build's sort and searchsorted at 28-30 and 32-33,
    K6 at 40-45 us, then K9."""
    events = []
    for f in range(3):
        t = 100.0 * f
        events += [ev(trace.FRAME, t, t + 100, False),
                   ev("void render_accum_kernel<0, false>(Cfg, Scene)", t + 5, t + 18, True),
                   ev("assemble_kernel(int, int)", t + 50, t + 55, True)]
        if caustics:
            events += [ev("photon_trace_kernel(Cfg, Scene, int const*, int)", t + 20, t + 25,
                          True),
                       ev("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>(int)",
                          t + 28, t + 30, True),
                       ev("void at::native::searchsorted_cuda_kernel<int>(int)", t + 32,
                          t + 33, True),
                       ev("void photon_gather_kernel<false>(int, int, float const*)", t + 40,
                          t + 45, True)]
    return trace.reduce_events(events, skip_frames=1)


def test_photon_pass_ms_reads_k5_to_k6():
    read = spec.load_module(os.path.join(BASE, "metrics", "photon_pass_ms.py"),
                            "test_metric_photon_pass_ms").read
    run = Run(1920, 1080, [], 1.0, 1.0, photon_trace(True),
              [FrameRecord(0, 1, None), FrameRecord(1, 2, None)])
    assert math.isclose(read(run), 0.025)  # 20 us to 45 us a frame
    assert read(run._replace(trace=photon_trace(False))) is None
    assert read(run._replace(trace=None)) is None
