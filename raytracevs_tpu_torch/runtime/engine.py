"""Engine: create with a resolution and a device, push scenes in, pull RGBA8
frames out (the EngineWrapper surface, src/RayTraceVS.Interop/
EngineWrapper.h:18-58), restated from raytracevs_tpu/runtime/engine.py.

The device alone picks the backend. The default, "cuda", runs every stage
of the frame on the card through the kernels (render K1, reprojection K2,
a-trous K3, shadow filter K4, and with caustics on the photon trace K5 and
the photon gather K6); it raises when PyTorch sees no CUDA device. On
"cpu", asked for by name, the same pipeline runs their plain PyTorch
versions.

`two_phase=True` renders through the two-phase renderer instead of K1:
phase A (K7), the coherence sort, phase B (K8) (ops/twophase.py), the
counterpart of the JAX package's backend "pallas2" (or RTVS_TWOPHASE=1).
It needs spp 1 and a pinhole camera (aperture <= 1e-3); update_scene
raises ValueError otherwise.

Triangle meshes come from a mesh service (io/mesh_cache.MeshCacheService):
`update_scene` flattens each mesh instance into one BVH forest, building a
mesh's BVH once (the Engine's BLASCache) and retransforming it when an
instance moves.

Example:
    engine = Engine(1920, 1080, mesh_service=meshes)   # on the card
    # or Engine(1920, 1080, mesh_service=meshes, two_phase=True), spp 1
    engine.update_scene(scene_data)      # evaluated SceneData
    img = engine.render()                # np.uint8 [H, W, 4]
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.bvh import BLASCache
from ..ops.render_cf import render_rows_cf
from ..ops.twophase import check_two_phase
from ..post import composite as composite_mod
from ..post import denoise as denoise_mod
from ..post import tonemap
from ..scene.data import SceneData
from ..scene.flatten import FlatScene, RenderConfig, flatten_scene, make_config, to_device
from ..scene.sanitize import sanitize_scene
from ..utils.checksum import scene_content_checksum


def render_frame(scene, cfg: RenderConfig, denoise_state, two_phase=False, aperture_size=None):
    """One frame on the scene tensors' device: render -> (denoise) ->
    composite -> RGBA8. Returns (rgba uint8 [H,W,4] tensor, rays tensor,
    new denoiser state, linear HDR colour [3,H,W] tensor). two_phase and
    aperture_size (the host's): render_rows_cf's."""
    out = render_rows_cf(scene, cfg, two_phase, aperture_size)
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
    return tonemap.to_rgba8_cf(color01), out.rays, denoise_state, out.color


class Engine:
    """Render engine with the EngineWrapper-compatible surface."""

    def __init__(self, width: int, height: int, device="cuda", mesh_service=None,
                 two_phase=False):
        self.width = int(width)
        self.height = int(height)
        self.mesh_service = mesh_service
        self.two_phase = bool(two_phase)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"Engine(device={device!r}): torch.cuda.is_available() is "
                                   "False; pass device='cpu' for the plain PyTorch pipeline")
        elif self.device.type != "cpu":
            raise ValueError(f"Engine: unsupported device {self.device}")
        self._flat: Optional[FlatScene] = None  # numpy tables
        self._scene_t: Optional[FlatScene] = None  # the same on the device
        self._cfg: Optional[RenderConfig] = None
        self._scene: Optional[SceneData] = None
        self._frame_index = 0
        self._checksum = None
        self._last_rgba: Optional[np.ndarray] = None
        self._last_hdr_t: Optional[torch.Tensor] = None  # [3,H,W] on the device
        self._last_rays = 0
        self._last_render_ms = 0.0
        self._prev_view_proj = None
        self._denoise_state = None
        # object-space BLASes by mesh name: a transform edit retransforms,
        # only new geometry runs the SAH build (AccelerationStructure.cpp:560-663)
        self._blas_cache = BLASCache()

    # -- scene input ------------------------------------------------------
    def update_scene(self, scene: SceneData, **config_overrides) -> None:
        """Sanitize + flatten a SceneData (EngineWrapper::UpdateScene).

        The denoiser history resets only when the object geometry changes
        (the reference's FNV checksum, DXRPipeline.cpp:2795-2880): camera
        motion keeps it and reprojects it. The frame index never resets
        (DXRPipeline.cpp:779-780) and the previous view-projection carries
        over from the last update. With two_phase, a scene the two-phase
        renderer cannot render (spp != 1, aperture > 1e-3) raises
        ValueError and leaves the Engine's scene, configuration and history
        as they were."""
        clean = sanitize_scene(scene)
        cfg = make_config(clean, self.width, self.height, **config_overrides)
        flat = flatten_scene(clean, frame_index=self._frame_index,
                             aspect=self.width / self.height,
                             prev_view_proj=self._prev_view_proj,
                             mesh_service=self.mesh_service, blas_cache=self._blas_cache)
        if self.two_phase:
            check_two_phase(cfg, float(flat.aperture_size))
        self._scene = clean
        new_checksum = scene_content_checksum(clean)
        if new_checksum != self._checksum:
            self._denoise_state = None
        self._checksum = new_checksum
        self._flat = flat
        self._cfg = cfg
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
        rgba_t, rays_t, self._denoise_state, self._last_hdr_t = render_frame(
            self._scene_t, self._cfg, self._denoise_state, self.two_phase,
            float(self._flat.aperture_size))
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

    @property
    def last_hdr(self) -> Optional[np.ndarray]:
        """Linear HDR colour [H, W, 3] of the last frame, before composite
        and tone map (read from the device only when asked for)."""
        if self._last_hdr_t is None:
            return None
        return self._last_hdr_t.permute(1, 2, 0).cpu().numpy()

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
