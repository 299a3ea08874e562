"""Render profiling: frame timing, Mrays/s counters, device traces.

The reference's instrumentation (SURVEY §5.1): the editor times
`renderService.Render()` with a Stopwatch and reports ms via a
RenderCompleted event with first-frame warmup excluded
(Views/RenderWindow.xaml.cs:64-66, 388-414); command lists carry PIX names
(DXRPipeline.cpp:42-48). Here: wall-clock per frame with warmup exclusion,
rays/s from the render's own ray counters, and optional `torch.profiler`
traces for in-depth kernel analysis (the PIX analog).

FrameStats, RenderProfiler and profile_engine are copied from
raytracevs_tpu/runtime/profiler.py; device_trace runs torch.profiler
instead of jax.profiler.

Spans: `annotate(name)` names a stage of the frame in the trace of a
running `torch.profiler` (the Engine's "rtvs." spans, nested by call:
rtvs.update_scene and rtvs.render, each with its stages). The spans share
the profiler's clock with the device's operations, so the trace shows
which stage the host was issuing during each idle gap of the card. With no
profiler recording, annotate costs one check of a flag.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler


@dataclass
class FrameStats:
    frame_ms: float
    rays: int

    @property
    def mrays_per_s(self) -> float:
        return self.rays / (self.frame_ms * 1e-3) / 1e6 if self.frame_ms > 0 else 0.0


@dataclass
class RenderProfiler:
    """Accumulates per-frame stats; first frame (compile) excluded like the
    reference's warmup exclusion."""

    frames: List[FrameStats] = field(default_factory=list)
    include_first: bool = False
    _seen_first: bool = False

    def record(self, frame_ms: float, rays: int) -> FrameStats:
        stats = FrameStats(frame_ms, rays)
        if self._seen_first or self.include_first:
            self.frames.append(stats)
        self._seen_first = True
        return stats

    @property
    def mean_frame_ms(self) -> Optional[float]:
        if not self.frames:
            return None
        return sum(f.frame_ms for f in self.frames) / len(self.frames)

    @property
    def best_frame_ms(self) -> Optional[float]:
        return min((f.frame_ms for f in self.frames), default=None)

    @property
    def fps(self) -> Optional[float]:
        m = self.mean_frame_ms
        return 1000.0 / m if m else None

    @property
    def mean_mrays_per_s(self) -> Optional[float]:
        if not self.frames:
            return None
        return sum(f.mrays_per_s for f in self.frames) / len(self.frames)

    def summary(self) -> dict:
        return {
            "frames": len(self.frames),
            "mean_frame_ms": self.mean_frame_ms,
            "best_frame_ms": self.best_frame_ms,
            "fps": self.fps,
            "mean_mrays_per_s": self.mean_mrays_per_s,
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block (the card's kernels too,
    when there is one) into `log_dir`, in TensorBoard's trace format (also
    read by chrome://tracing and Perfetto).

    The PIX-capture analog: wraps a block of renders and dumps a device
    trace with per-kernel timings. Yields the profiler (its
    key_averages() give the kernels' times).
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # record_shapes: the trace then also holds the spans' frame indices
    with torch.profiler.profile(
            activities=activities, record_shapes=True,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str, frame: Optional[int] = None):
    """A named span of the trace (SetCommandListName analog,
    DXRPipeline.cpp:42-48), as a context manager: one shared no-op when no
    torch.profiler records, else a span of the profiler's own trace
    (torch's _RecordFunctionFast). Given `frame`, the span records it as
    its keyword "frame" (shown in a trace taken with record_shapes=True:
    the event's kwinputs, the exported trace's args).

    The span is a host event alone, with no device-side copy: a reader of
    the trace finds the device's operations and the host's spans apart.
    (torch.profiler.record_function would add a device-side copy of each
    span, from its first kernel to its last, and drops its `args` string
    from the trace.)"""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if frame is None:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, keyword_values={"frame": frame})


def profile_engine(engine, frames: int = 8) -> dict:
    """Render `frames` frames and return timing/Mrays summary."""
    prof = RenderProfiler()
    for _ in range(frames + 1):  # +1 warmup
        start = time.perf_counter()
        engine.render()
        prof.record((time.perf_counter() - start) * 1000.0, engine.last_rays)
    return prof.summary()
