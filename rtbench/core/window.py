"""The timed loop: set-up, warm-up, the measured window and, with trace,
the profiled stretch, on the port's Engine. Returns what the metric
readers and the correctness check need; the check itself is check.py's.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import trace as trace_mod
from .traffic import STREAM_CHECK, Traffic, rng


class FrameRecord(NamedTuple):
    start: float  # host clock, s
    end: float
    update_s: Optional[float]  # update_scene's share, None where it did not run


class Run(NamedTuple):
    """What the metric readers read."""

    width: int
    height: int
    frames: list  # FrameRecord of every window frame
    window_s: float  # from the window's start to its last frame's end
    setup_s: float
    trace: Optional[trace_mod.TraceData]
    traced_frames: list  # FrameRecord of the traced frames


class Checked(NamedTuple):
    """A frame of the program that the check compares, with the program's
    history before it (None: the check replays from the start)."""

    frame: int
    history_in: Optional[torch.Tensor]
    rgba: np.ndarray
    rays: int
    shadow: torch.Tensor
    history_out: torch.Tensor


class Program:
    """The port under test: its Engine on one device, fed by the traffic."""

    def __init__(self, config, traffic: Traffic, width, height, device):
        from raytracevs_tpu_torch.io.mesh_cache import CachedMesh, MeshCacheService
        from raytracevs_tpu_torch.runtime.engine import Engine
        from raytracevs_tpu_torch.scene import data, transform

        self.config, self.traffic = config, traffic
        self.D, self.T = data, transform
        service = None
        meshes = config.meshes()
        if meshes:
            service = MeshCacheService(".")  # register() only: no directory is read
            for name, (verts, indices, lo, hi) in meshes.items():
                service.register(name, CachedMesh(name=name, vertices=verts, indices=indices,
                                                  bounds_min=lo, bounds_max=hi))
        self.engine = Engine(width, height, device=device, mesh_service=service,
                             device_mesh=None)

    def scene(self, frame: int):
        return self.config.scene(self.D, self.T, self.traffic.view(frame))

    def history(self) -> Optional[torch.Tensor]:
        """A copy in host memory of the Engine's denoiser history (the
        port's Engine._denoise_state.packed, [16,H,W]), None before the
        first frame. The check's copies stay off the device, so that
        memory_peak_bytes reads the program's memory alone."""
        state = self.engine._denoise_state
        return None if state is None else state.packed.to("cpu", copy=True)

    def checked(self, frame: int, history_in, rgba) -> Checked:
        """The frame just rendered (its RGBA8 array `rgba`), with the
        Engine's ray count, denoised shadow planes (_last_denoised[2]) and
        history after it, the planes copied to host memory."""
        e = self.engine
        return Checked(frame, history_in, rgba, int(e.last_rays),
                       e._last_denoised[2].to("cpu", copy=True), self.history())


def run_window(cell, seed: int, seconds: float, trace: bool, device: str,
               t_process: float, size=None) -> dict:
    """Set up the cell, warm up, run the window of `seconds` and, with
    `trace`, profile the cell's TRACE frames of it. Returns {"run": Run,
    "checked": [Checked], "attempted", "failed", "memory_peak_bytes",
    "last_rays", "breakdown", "traffic", "size"}. `size` (width, height) overrides the
    configuration's, for tests on the CPU."""
    cfg = cell.config
    width, height = size or (cfg.WIDTH, cfg.HEIGHT)
    traffic = Traffic(cell.traffic, seed)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    prog = Program(cfg, traffic, width, height, device)
    engine = prog.engine
    def mark(name):
        return torch.profiler.record_function(name) if trace else contextlib.nullcontext()

    def frame(i, scene):
        t0 = time.perf_counter()
        upd = None
        with mark(trace_mod.FRAME):
            if scene is not None:
                with mark(trace_mod.UPDATE):
                    engine.update_scene(scene, **cfg.OVERRIDES)
                upd = time.perf_counter() - t0
            with mark(trace_mod.RENDER):
                rgba = engine.render()
        return FrameRecord(t0, time.perf_counter(), upd), rgba

    def scene_for(i):
        return prog.scene(i) if traffic.updates(i) else None

    checked = []
    start_frames = int(cfg.CHECK["start_frames"])
    for i in range(traffic.warmup_frames):
        _, rgba = frame(i, scene_for(i))
        if i < start_frames:
            checked.append(prog.checked(i, None, rgba))
    sync()
    setup_s = time.perf_counter() - t_process

    # the window frames the check compares: the first to start after each
    # of these times, drawn from the seed
    due = sorted(rng(seed, STREAM_CHECK).uniform(0.1, 0.9, int(cfg.CHECK["window_frames"]))
                 * seconds)
    tr = cfg.TRACE
    prof = done = None
    profiled = []
    records = []
    attempted = failed = 0
    i = traffic.warmup_frames
    nxt = scene_for(i)
    # set-up's objects leave the collector's generations, so that a full
    # collection in the window walks only what the window made
    gc.collect()
    gc.freeze()
    t_window = time.perf_counter()
    deadline = t_window + seconds
    while True:
        if trace and prof is None and done is None and len(records) >= tr["skip"]:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        history_in = None
        if due and time.perf_counter() - t_window >= due[0]:
            while due and time.perf_counter() - t_window >= due[0]:
                due.pop(0)  # times that fall in one frame check it once
            history_in = prog.history()
        attempted += 1
        try:
            rec, rgba = frame(i, nxt)
        except (RuntimeError, ValueError) as exc:
            failed += 1
            print(f"frame {i} failed: {exc!r}", file=sys.stderr, flush=True)
            rec = None
        if rec is not None:
            records.append(rec)
            if history_in is not None:
                checked.append(prog.checked(i, history_in, rgba))
            if prof is not None:
                profiled.append(rec)
        if prof is not None and len(profiled) == tr["frames"] + 1:
            sync()
            prof.stop()
            prof, done = None, prof
        i += 1
        # a check time still due past the deadline (a frame longer than a
        # tenth of the window) is served by one more frame
        if time.perf_counter() >= deadline and not due and (not trace or done is not None):
            break
        nxt = scene_for(i)
    t_end = records[-1].end if records else time.perf_counter()
    gc.unfreeze()
    sync()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    trace_data = brk = None
    if trace:
        # the first profiled frame carries the profiler's start: not traced
        trace_data = trace_mod.reduce_events(done.events(), skip_frames=1)
        brk = trace_mod.breakdown(trace_data)
        del done
    rays = int(engine.last_rays)
    del prog, engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    run = Run(width, height, records, t_end - t_window, setup_s, trace_data, profiled[1:])
    return {"run": run, "checked": checked, "attempted": attempted, "failed": failed,
            "memory_peak_bytes": memory_peak, "breakdown": brk, "traffic": traffic,
            "size": (width, height), "last_rays": rays}
