"""The correctness check: the program's frames against the plain
reference's (rtbench/reference, which imports nothing of the port).

Compared frames: the run's first CHECK["start_frames"] frames, which the
reference replays from an empty history on its own scene tables and BVH,
and CHECK["window_frames"] frames of the window drawn from the seed, which
the reference renders from the program's denoiser history before the frame
(the one piece of the program's state it takes: it cannot replay a
thousand frames of history) and its own tables for that frame. Each
compared frame gives:

- rgb_off_share: the share of the frame's RGB values (8-bit) that differ;
- rgb_max_step: the largest difference of an RGB value, in 8-bit steps;
- plane_err: the largest error of a plane of the new denoiser history (16
  planes) or of the denoised shadow (2), each over the larger of its own
  and the median plane's largest reference magnitude; a NaN on one side
  only reads as infinite;
- rays_off: the difference of the frame's traced-ray counts.

A run's numbers are the largest over its compared frames (rgb_off_share:
pooled). `correct` holds where each is at most its limit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("rgb_off_share", "rgb_max_step", "plane_err", "rays_off")


def plane_errors(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-plane error of [C,H,W] planes against the reference's."""
    want = want.to(torch.float32)
    got = got.to(want.device, torch.float32)
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if bool((nan_g != nan_w).any()):
        return math.inf
    diff = torch.where(nan_g, 0.0, (got - want).abs()).flatten(1).amax(1)
    scale = torch.where(nan_w, 0.0, want.abs()).flatten(1).amax(1)
    floor = scale.median()
    return float((diff / torch.clamp(torch.maximum(scale, floor), min=1e-30)).max())


class Tally:
    """The compared numbers over a run's frames."""

    def __init__(self):
        self.off = self.values = 0
        self.max_step = 0
        self.plane_err = 0.0
        self.rays_off = 0
        self.frames = 0

    def add(self, rgba: np.ndarray, rays: int, planes: torch.Tensor, ref) -> None:
        """One frame: the program's (or the control's) RGBA8 [H,W,4] array,
        ray count and planes (history then shadow) against the reference's
        Frame."""
        want = ref.rgba[..., :3].cpu().numpy().astype(np.int16)
        d = np.abs(rgba[..., :3].astype(np.int16) - want)
        self.off += int(np.count_nonzero(d))
        self.values += d.size
        self.max_step = max(self.max_step, int(d.max()))
        self.plane_err = max(self.plane_err, plane_errors(
            planes, torch.cat([ref.history, ref.shadow])))
        self.rays_off = max(self.rays_off, abs(int(rays) - int(ref.rays)))
        self.frames += 1

    def numbers(self) -> dict:
        return {"rgb_off_share": self.off / max(self.values, 1), "rgb_max_step": self.max_step,
                "plane_err": self.plane_err, "rays_off": self.rays_off}


def reference_scene(config, traffic, frame: int):
    from rtbench.reference.scene import data, transform

    return config.scene(data, transform, traffic.view(frame))


def reference_meshes(config):
    from rtbench.reference.frame import Mesh

    return [Mesh(name, v, i, lo, hi) for name, (v, i, lo, hi) in config.meshes().items()]


def replay_to(rep, config, traffic, frame: int, history) -> None:
    """Bring Replay `rep` to the state the Engine is in before `frame`: the
    scene of the last update at or before it, with the view-projection of
    the update before that, the frame index, and `history` (the program's)
    unless that update changed the geometry at `frame` itself."""
    j = traffic.last_update(frame)
    if j > 0:
        prev = traffic.last_update(j - 1)
        rep.frame_index = prev
        rep.update_scene(reference_scene(config, traffic, prev), **config.OVERRIDES)
    rep.history = history
    rep.frame_index = j
    rep.update_scene(reference_scene(config, traffic, j), **config.OVERRIDES)
    if j < frame:
        rep.history = history
    rep.set_frame_index(frame)


def compare(config, traffic, checked, size, device, control: bool = False):
    """The compared numbers of the program's `checked` frames (window.Checked)
    against the reference's at `size` on `device`. With `control`, returns
    (the program's numbers, the control's): the control is the reference
    with its radiance planes and history stored as bfloat16, put in the
    program's place on the same frames from the same history."""
    from rtbench.reference import frame as ref_frame

    width, height = size
    meshes = reference_meshes(config)
    tally, low_tally = Tally(), Tally()
    rep = ref_frame.Replay(width, height, device, meshes)
    start = [c for c in checked if c.history_in is None]
    for c in start:  # the start, replayed from frame 0
        if traffic.updates(c.frame):
            rep.update_scene(reference_scene(config, traffic, c.frame), **config.OVERRIDES)
        rep.set_frame_index(c.frame)
        _tally_frame(tally, low_tally if control else None, rep, c)
    cache = rep.blas_cache
    for c in checked:
        if c.history_in is None:
            continue
        rep = ref_frame.Replay(width, height, device, meshes)
        rep.blas_cache = cache
        replay_to(rep, config, traffic, c.frame, c.history_in.to(device))
        _tally_frame(tally, low_tally if control else None, rep, c)
    return (tally.numbers(), low_tally.numbers()) if control else tally.numbers()


def _tally_frame(tally, low_tally, rep, c):
    if low_tally is None:
        ref = rep.render()
    else:
        ref, low = rep.render(control=True)
        low_tally.add(low.rgba.cpu().numpy(), low.rays, torch.cat([low.history, low.shadow]),
                      ref)
    tally.add(c.rgba, c.rays, torch.cat([c.history_out, c.shadow]), ref)
