"""The traced stretch of a --trace 1 run: torch.profiler over a fixed count
of frames, reduced in memory (no trace file) to the device's operations,
the harness's host ranges, the device's busy union and its idle gaps.

The harness marks each frame with record_function ranges of its own:
"rtbench.frame" around the frame, inside it "rtbench.update_scene" and
"rtbench.render" around its calls into the program. Times are the
profiler's microseconds, one clock for host and device events.
"""
from __future__ import annotations

from typing import NamedTuple

FRAME, UPDATE, RENDER = "rtbench.frame", "rtbench.update_scene", "rtbench.render"
# a gap's name: the innermost harness range open on the host at its midpoint
GAP_NAMES = ((UPDATE, "update_scene"), (RENDER, "render"))
TOP = 10


class TraceData(NamedTuple):
    frames: int  # frames traced
    start_us: float  # the first traced frame's start
    window_us: float  # from there to the last traced frame's end
    device_ops: list  # [(name, start_us, end_us)] inside the window
    host_ranges: list  # [(name, start_us, end_us)] of the harness's ranges
    busy_us: float  # the union of the device operations' intervals
    gaps: list  # [(start_us, end_us)] where the device ran nothing


def short_name(name: str) -> str:
    """A device operation's name without its argument list and anonymous
    namespaces, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    name = name[:cut] if cut > 0 else name
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:120]


def busy_union(intervals, lo, hi):
    """(total length, merged [(start, end)]) of `intervals` clipped to [lo, hi]."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def reduce_events(events, skip_frames: int = 1) -> TraceData:
    """TraceData of a profile's events (torch.profiler's prof.events()):
    every "rtbench.frame" range after the first `skip_frames` is traced."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        r = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name.startswith("rtbench."):
            if e.device_type != DeviceType.CUDA:  # not the ranges' device-side copies
                host.append(r)
        elif e.device_type == DeviceType.CUDA:
            device.append(r)
    frames = sorted(r for r in host if r[0] == FRAME)[skip_frames:]
    if not frames:
        raise RuntimeError("the profile holds no traced frame")
    lo, hi = frames[0][1], frames[-1][2]
    device = [r for r in device if r[2] > lo and r[1] < hi]
    busy, merged = busy_union([(s, e) for _, s, e in device], lo, hi)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return TraceData(len(frames), lo, hi - lo, device,
                     [r for r in host if r[2] > lo and r[1] < hi], busy, gaps)


def gap_name(trace: TraceData, gap) -> str:
    mid = 0.5 * (gap[0] + gap[1])
    for range_name, name in GAP_NAMES:
        if any(s <= mid < e for n, s, e in trace.host_ranges if n == range_name):
            return name
    return "harness"


def breakdown(trace: TraceData) -> dict:
    """The device operations that took most time (seconds over the traced
    frames, by name) and the longest idle gaps, each named by the harness
    range open on the host, TOP of each."""
    by_name = {}
    for name, s, e in trace.device_ops:
        k = short_name(name)
        by_name[k] = by_name.get(k, 0.0) + (min(e, trace.start_us + trace.window_us)
                                            - max(s, trace.start_us)) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(trace.gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[gap_name(trace, g), (g[1] - g[0]) * 1e-6] for g in gaps]}


def kernel_base(name: str) -> str:
    """A kernel's bare function name: "void ns::k<4, float>(int, ...)" -> "k"."""
    name = short_name(name)
    cut = name.find("<")
    name = name[:cut] if cut > 0 else name
    return name.rsplit("::", 1)[-1].strip()


def per_frame(trace: TraceData, keep):
    """(device seconds a traced frame, operations a traced frame) of the
    device operations whose name `keep(name)` accepts; (0, 0) if none."""
    lo, hi = trace.start_us, trace.start_us + trace.window_us
    ops = [(min(e, hi) - max(s, lo)) for name, s, e in trace.device_ops if keep(name)]
    return sum(ops) * 1e-6 / trace.frames, len(ops) / trace.frames
