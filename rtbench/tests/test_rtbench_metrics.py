"""The metric arithmetic: the denoiser's bytes, the trace reduction, the
readers, and the traffic generator."""
import math
from types import SimpleNamespace

import pytest

from rtbench.core import spec, trace
from rtbench.core.traffic import Traffic
from rtbench.core.window import FrameRecord, Run

METRICS = spec.ROOT + "/rtbench/metrics/"


def reader(name):
    return spec.load_module(METRICS + name + ".py", "test_metric_" + name).read


def test_denoise_bytes_at_1080p():
    m = spec.load_module(METRICS + "denoise_roofline.py", "test_denoise_roofline")
    mb = [round(m.kernel_bytes(k, 1920, 1080) / 1e6, 1)
          for k in ("reproject_kernel", "atrous_kernel", "shadow_kernel")]
    assert mb == [381.5, 149.3, 74.6]


def ev(name, start, end, cuda):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def synthetic_trace():
    """Three frames of 100 us (the first skipped); in each, update_scene
    for 30 us, then render with K1, K2, a plain add and the readback."""
    events = []
    for f in range(3):
        t = 100.0 * f
        events += [ev(trace.FRAME, t, t + 100, False), ev(trace.UPDATE, t, t + 30, False),
                   ev(trace.RENDER, t + 30, t + 100, False),
                   ev(trace.RENDER, t + 30, t + 100, True),  # the range's device copy
                   ev("void render_accum_kernel<0, false>(Cfg, Scene, int const*, float*)",
                      t + 40, t + 60, True),
                   ev("reproject_kernel(float const*, ...)", t + 60, t + 70, True),
                   ev("void at::native::vectorized_elementwise_kernel<4>(int)", t + 65, t + 75,
                      True),
                   ev("Memcpy DtoH (Device -> Pageable)", t + 80, t + 90, True)]
    return trace.reduce_events(events, skip_frames=1)


def test_trace_reduction_and_readers():
    t = synthetic_trace()
    assert t.frames == 2 and t.window_us == 200.0
    assert t.busy_us == 2 * 45.0  # [40, 75) and [80, 90) a frame
    run = Run(1920, 1080, [], 1.0, 1.0, t,
              [FrameRecord(0, 1, 0.003), FrameRecord(1, 2, 0.005)])
    assert math.isclose(reader("device_idle_share")(run), 55.0)
    assert math.isclose(reader("render_kernel_ms")(run), 0.020)
    assert math.isclose(reader("plain_torch_device_ms")(run), 0.020)
    assert reader("plain_torch_launches")(run) == 2
    assert math.isclose(reader("update_scene_ms")(run), 4.0)
    share = reader("denoise_roofline")(run)
    assert math.isclose(share, 100 * 381.5e6 / 3.35e12 / 10e-6, rel_tol=1e-3)
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["render_accum_kernel<0, false>", pytest.approx(40e-6)]
    names = [g[0] for g in b["idle_gaps"]]
    assert set(names) == {"update_scene", "render"} and len(b["idle_gaps"]) <= trace.TOP
    # nothing to read: no value, never a 0 share
    empty = trace.reduce_events([ev(trace.FRAME, 0, 10, False), ev(trace.FRAME, 10, 20, False)])
    run0 = Run(64, 32, [], 1.0, 1.0, empty, [FrameRecord(0, 1, None)])
    for name in ("render_kernel_ms", "denoise_roofline", "plain_torch_device_ms",
                 "plain_torch_launches", "update_scene_ms"):
        assert reader(name)(run0) is None


def test_end_to_end_readers():
    frames = [FrameRecord(i * 0.02, i * 0.02 + 0.02 + (0.01 if i % 10 == 0 else 0), None)
              for i in range(100)]
    run = Run(64, 32, frames, 2.5, 7.0, None, [])
    assert math.isclose(reader("frame_ms")(run), 25.0)
    assert math.isclose(reader("setup_s")(run), 7.0)
    assert math.isclose(reader("frame_ms_p95")(run), 30.0)


def test_traffic_is_fixed_by_the_seed():
    orbit = {"start_azimuth_deg": [0, 360], "degrees_per_frame": 2.0,
             "update_scene": "every_frame", "warmup_frames": 3}
    a, b = Traffic(orbit, 2**31 + 5), Traffic(orbit, 2**31 + 5)
    assert [a.view(i) for i in range(5)] == [b.view(i) for i in range(5)]
    assert Traffic(orbit, 7).azimuth0 != a.azimuth0
    assert math.isclose((a.view(1)["azimuth_deg"] - a.view(0)["azimuth_deg"]) % 360, 2.0)
    still = dict(orbit, start_azimuth_deg=[0, 1], degrees_per_frame=0.0,
                 update_scene="first_frame")
    for seed in (0, 1, 2**33, -4):
        s = Traffic(still, seed)
        assert 0.0 <= s.view(100)["azimuth_deg"] < 1.0 and s.updates(0) and not s.updates(1)
    with pytest.raises(ValueError):
        Traffic(dict(orbit, rate=3), 1)
