"""The one traffic generator: a traffic file's parameters and a seed give
every frame's view and whether update_scene runs before it.

Parameters (a JSON object; unknown keys are refused):
- "start_azimuth_deg": [lo, hi], the camera's azimuth at frame 0, drawn
  from the seed uniformly in [lo, hi);
- "degrees_per_frame": the azimuth's step from one frame to the next;
- "update_scene": "every_frame" or "first_frame";
- "warmup_frames": frames rendered in set-up, before the window;
- "about": what the mix stands for (not read).
"""
from __future__ import annotations

import numpy as np

KEYS = {"about", "start_azimuth_deg", "degrees_per_frame", "update_scene", "warmup_frames"}
UPDATES = ("every_frame", "first_frame")

# streams of the seed: each draw has its own, so adding one moves no other
STREAM_VIEW, STREAM_CHECK = 0, 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a seed (any whole number)."""
    return np.random.default_rng([int(seed) % 2**64, stream])


class Traffic:
    def __init__(self, params: dict, seed: int):
        unknown = set(params) - KEYS
        if unknown:
            raise ValueError(f"traffic: unknown keys {sorted(unknown)}")
        if params["update_scene"] not in UPDATES:
            raise ValueError(f"traffic: update_scene {params['update_scene']!r}, not one of "
                             f"{UPDATES}")
        self.step = float(params["degrees_per_frame"])
        self.every_frame = params["update_scene"] == "every_frame"
        self.warmup_frames = int(params["warmup_frames"])
        if self.warmup_frames < 1:
            raise ValueError("traffic: warmup_frames must be at least 1")
        r = rng(seed, STREAM_VIEW)
        lo, hi = (float(x) for x in params["start_azimuth_deg"])
        self.azimuth0 = float(lo + (hi - lo) * r.random())

    def updates(self, frame: int) -> bool:
        """Whether update_scene runs before `frame`."""
        return frame == 0 or self.every_frame

    def last_update(self, frame: int) -> int:
        """The last frame at or before `frame` that update_scene ran before."""
        return frame if self.every_frame else 0

    def view(self, frame: int) -> dict:
        """The scene's view at `frame`: the camera azimuth."""
        return {"azimuth_deg": (self.azimuth0 + self.step * frame) % 360.0}
