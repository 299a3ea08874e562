"""Asynchronous render loop with latest-wins parameter coalescing.

Re-implements the reference render window's threading model
(Views/RenderWindow.xaml.cs:347-451): scene evaluation happens on the
caller's thread, rendering on a worker, and while a frame is in flight any
number of scene updates coalesce into a single pending entry — only the
newest wins. Frame completions are reported through a callback with the
render time in ms (the RenderCompleted event, RenderWindow.xaml.cs:64-66).

Copied from raytracevs_tpu/runtime/render_loop.py (threading and numpy only).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import numpy as np


class RenderLoop:
    """Worker-thread render loop over an Engine."""

    def __init__(self, engine, on_frame: Optional[Callable[[np.ndarray, float], None]] = None):
        self.engine = engine
        self.on_frame = on_frame
        self._pending_scene: Any = None
        self._pending_flag = False
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.frames_rendered = 0
        self.frames_coalesced = 0
        self.continuous = False  # keep re-rendering (temporal accumulation)

    # -- control -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="rtvs-render", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- input -------------------------------------------------------------
    def submit_scene(self, scene) -> None:
        """Queue a scene update; newest wins (RenderWindow.xaml.cs:347-390)."""
        with self._lock:
            if self._pending_flag:
                self.frames_coalesced += 1
            self._pending_scene = scene
            self._pending_flag = True
        self._wake.set()

    def request_frame(self) -> None:
        """Re-render the current scene (e.g. temporal accumulation step)."""
        self._wake.set()

    # -- worker ------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            with self._lock:
                scene = self._pending_scene
                had_update = self._pending_flag
                self._pending_scene = None
                self._pending_flag = False
            try:
                if had_update and scene is not None:
                    self.engine.update_scene(scene)
                if self.engine._flat is None:
                    continue
                start = time.perf_counter()
                frame = self.engine.render()
                ms = (time.perf_counter() - start) * 1000.0
                self.frames_rendered += 1
                if self.on_frame is not None:
                    self.on_frame(frame, ms)
            except Exception:
                import traceback

                traceback.print_exc()
            if self.continuous and not self._stop.is_set():
                self._wake.set()
