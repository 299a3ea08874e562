"""Engine: create with a resolution and a device, push scenes in, pull RGBA8
frames out (the EngineWrapper surface, src/RayTraceVS.Interop/
EngineWrapper.h:18-58), restated from raytracevs_tpu/runtime/engine.py.

The device alone picks the backend: on "cuda" every stage of the frame runs
on the card and the four kernels launch (render K1, reprojection K2, a-trous
K3, shadow filter K4); on "cpu" the same pipeline runs their plain PyTorch
versions.

Example:
    engine = Engine(1920, 1080, device="cuda")
    engine.update_scene(scene_data)      # evaluated SceneData
    img = engine.render()                # np.uint8 [H, W, 4]
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.render_cf import render_rows_cf
from ..post import composite as composite_mod
from ..post import denoise as denoise_mod
from ..post import tonemap
from ..scene.data import SceneData
from ..scene.flatten import FlatScene, RenderConfig, flatten_scene, make_config, to_device
from ..scene.sanitize import sanitize_scene
from ..utils.checksum import scene_content_checksum


def render_frame(scene, cfg: RenderConfig, denoise_state):
    """One frame on the scene tensors' device: render -> (denoise) ->
    composite -> RGBA8. Returns (rgba uint8 [H,W,4] tensor, rays tensor,
    new denoiser state)."""
    out = render_rows_cf(scene, cfg)
    if cfg.enable_denoiser:
        dd, ds, _dshadow, denoise_state = denoise_mod.denoise_frame_cf(out.gbuffer, denoise_state)
        color01 = composite_mod.composite_cf(
            out.gbuffer, out.raw_specular, scene.exposure, scene.tone_map_operator, scene.gamma,
            denoised_diffuse=dd, denoised_specular=ds, use_denoised=True,
            nrd_bypass_distance=scene.nrd_bypass_distance,
            nrd_bypass_blend=scene.nrd_bypass_blend)
    else:
        color01 = composite_mod.composite_cf(
            out.gbuffer, out.raw_specular, scene.exposure, scene.tone_map_operator, scene.gamma,
            use_denoised=False)
    return tonemap.to_rgba8_cf(color01), out.rays, denoise_state


class Engine:
    """Render engine with the EngineWrapper-compatible surface."""

    def __init__(self, width: int, height: int, device="cpu"):
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Engine(device='cuda'): torch.cuda.is_available() is False")
        elif self.device.type != "cpu":
            raise ValueError(f"Engine: unsupported device {self.device}")
        self._flat: Optional[FlatScene] = None  # numpy tables
        self._scene_t: Optional[FlatScene] = None  # the same on the device
        self._cfg: Optional[RenderConfig] = None
        self._scene: Optional[SceneData] = None
        self._frame_index = 0
        self._checksum = None
        self._last_rgba: Optional[np.ndarray] = None
        self._last_rays = 0
        self._last_render_ms = 0.0
        self._prev_view_proj = None
        self._denoise_state = None

    # -- scene input ------------------------------------------------------
    def update_scene(self, scene: SceneData, **config_overrides) -> None:
        """Sanitize + flatten a SceneData (EngineWrapper::UpdateScene).

        The denoiser history resets only when the object geometry changes
        (the reference's FNV checksum, DXRPipeline.cpp:2795-2880): camera
        motion keeps it and reprojects it. The frame index never resets
        (DXRPipeline.cpp:779-780) and the previous view-projection carries
        over from the last update."""
        clean = sanitize_scene(scene)
        self._scene = clean
        new_checksum = scene_content_checksum(clean)
        if new_checksum != self._checksum:
            self._denoise_state = None
        self._checksum = new_checksum
        self._flat = flatten_scene(clean, frame_index=self._frame_index,
                                   aspect=self.width / self.height,
                                   prev_view_proj=self._prev_view_proj)
        self._cfg = make_config(clean, self.width, self.height, **config_overrides)
        self._prev_view_proj = np.asarray(self._flat.view_proj)
        self._scene_t = to_device(self._flat, self.device)

    # -- rendering --------------------------------------------------------
    def render(self) -> np.ndarray:
        """Render a frame; returns RGBA8 np.uint8 [H, W, 4]."""
        if self._flat is None:
            raise RuntimeError("update_scene() must be called before render()")
        if self._cfg.enable_denoiser and self._denoise_state is None:
            self._denoise_state = denoise_mod.init_state_cf(self.height, self.width, self.device)
        start = time.perf_counter()
        rgba_t, rays_t, self._denoise_state = render_frame(self._scene_t, self._cfg,
                                                           self._denoise_state)
        rgba = rgba_t.cpu().numpy()  # waits for the device
        self._last_render_ms = (time.perf_counter() - start) * 1000.0
        self._last_rgba = rgba
        self._last_rays = int(rays_t.item())
        self._frame_index += 1
        self._flat = self._flat._replace(frame_index=np.asarray(self._frame_index, np.uint32))
        self._scene_t = self._scene_t._replace(frame_index=torch.tensor(
            self._frame_index, dtype=torch.int64, device=self.device))
        return rgba

    def get_pixel_data(self) -> bytes:
        """Raw RGBA bytes of the last frame (EngineWrapper::GetPixelData)."""
        if self._last_rgba is None:
            raise RuntimeError("render() must be called before get_pixel_data()")
        return self._last_rgba.tobytes()

    # -- metrics ----------------------------------------------------------
    @property
    def last_render_ms(self) -> float:
        return self._last_render_ms

    @property
    def last_rays(self) -> int:
        """Rays traced in the last frame (TraceRay-equivalents)."""
        return self._last_rays

    @property
    def last_mrays_per_s(self) -> float:
        if self._last_render_ms <= 0:
            return 0.0
        return self._last_rays / (self._last_render_ms * 1e-3) / 1e6
