"""The trace reduction with the program's spans in the profile. The port's
Engine records its "rtvs." spans as host events alone, with no device-side
copy (runtime/profiler.py::annotate; tests/test_torch_gpu.py checks that on
the card), so the reduction and its readers read the same with and without
them."""
from rtbench.core import trace
from rtbench.core.window import FrameRecord, Run
from test_rtbench_metrics import ev, reader

READERS = ("device_idle_share", "render_kernel_ms", "plain_torch_device_ms",
           "plain_torch_launches", "update_scene_ms", "denoise_roofline")


def frames_events(spans: bool):
    """test_rtbench_metrics.synthetic_trace's events and, with `spans`, the
    Engine's spans of each frame on the host around its device work."""
    events = []
    for f in range(3):
        t = 100.0 * f
        events += [ev(trace.FRAME, t, t + 100, False), ev(trace.UPDATE, t, t + 30, False),
                   ev(trace.RENDER, t + 30, t + 100, False),
                   ev(trace.RENDER, t + 30, t + 100, True),
                   ev("void render_accum_kernel<0, false>(Cfg, Scene, int const*, float*)",
                      t + 40, t + 60, True),
                   ev("reproject_kernel(float const*, ...)", t + 60, t + 70, True),
                   ev("void at::native::vectorized_elementwise_kernel<4>(int)", t + 65, t + 75,
                      True),
                   ev("Memcpy DtoH (Device -> Pageable)", t + 80, t + 90, True)]
        if spans:
            events += [ev("rtvs.update_scene", t + 1, t + 29, False),
                       ev("rtvs.scene.to_device", t + 20, t + 28, False),
                       ev("rtvs.render", t + 31, t + 99, False),
                       ev("rtvs.render.trace", t + 32, t + 36, False),
                       ev("rtvs.denoise", t + 36, t + 50, False),
                       ev("rtvs.render.readback", t + 55, t + 98, False)]
    return events


def test_reduction_and_readers_read_the_same_with_the_programs_spans():
    plain = trace.reduce_events(frames_events(False), skip_frames=1)
    spanned = trace.reduce_events(frames_events(True), skip_frames=1)
    assert spanned == plain  # every TraceData field
    assert trace.breakdown(spanned) == trace.breakdown(plain)
    records = [FrameRecord(0, 1, 0.003), FrameRecord(1, 2, 0.005)]
    for name in READERS:
        got, want = (reader(name)(Run(1920, 1080, [], 1.0, 1.0, t, records))
                     for t in (spanned, plain))
        assert got == want and want is not None, name
    # a span with a device-side copy (a record_function range) would count
    # as a device operation and fill the idle gaps it spans
    copied = frames_events(True) + [ev("rtvs.render", 100.0 * f + 40, 100.0 * f + 90, True)
                                    for f in range(3)]
    assert trace.reduce_events(copied, skip_frames=1).busy_us > plain.busy_us
