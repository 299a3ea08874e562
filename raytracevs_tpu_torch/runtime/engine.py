"""Engine: create with a resolution and a device, push scenes in, pull RGBA8
frames out (the EngineWrapper surface, src/RayTraceVS.Interop/
EngineWrapper.h:18-58), restated from raytracevs_tpu/runtime/engine.py.

The device alone picks the backend. The default, "cuda", runs every stage
of the frame on the card through the kernels (render K1, reprojection K2,
a-trous K3, shadow filter K4, and with caustics on the photon trace K5 and
the photon gather K6); it raises when PyTorch sees no CUDA device. On
"cpu", asked for by name, the same pipeline runs their plain PyTorch
versions.

`device_mesh` shards the frame's rows over a list of devices
(parallel/tiles.py): each slab renders on its device, the denoiser
exchanges halo rows between neighbouring slabs (K2's slab form, one
a-trous launch a pass), and the stitched frame equals the single-device
one bit for bit; the denoiser history is kept per slab.

`two_phase=True` renders through the two-phase renderer instead of K1:
phase A (K7), the coherence sort, phase B (K8) (ops/twophase.py), the
counterpart of the JAX package's backend "pallas2" (or RTVS_TWOPHASE=1).
It needs spp 1 and a pinhole camera (aperture <= 1e-3); update_scene
raises ValueError otherwise.

Triangle meshes come from a mesh service (io/mesh_cache.MeshCacheService):
`update_scene` flattens each mesh instance into one BVH forest, building a
mesh's BVH once (the Engine's BLASCache) and retransforming an instance
only when it moves; an update that changes no instance (a camera orbit)
reuses the forest and its tables on the device, with no upload.

Scene files: `load_rtvs(path)` loads a .rtvs node graph (scene/rtvs.py),
evaluates it (scene/evaluator.py) and updates the scene; its FBX nodes
resolve against a mesh service, found next to the file when the Engine has
none. `render(fail_safe=True)`, `copy_pixels_into`, `validate_frame` and
`render_debug_view` are the rest of the JAX Engine's surface.

Under a running torch.profiler, update_scene and render record their
stages as spans ("rtvs.update_scene", "rtvs.render" and their children,
runtime/profiler.py::annotate) on the profiler's clock; the two top spans
carry the frame index.

On the card render() reads the frame and its ray count back through pinned
blocks of PyTorch's caching host allocator (runtime/readback.py), its one
wait on the device; each array it returns is the caller's own
(`readback_stats` counts them).

Example:
    engine = Engine(1920, 1080, mesh_service=meshes)   # on the card
    # or Engine(1920, 1080, mesh_service=meshes, two_phase=True), spp 1
    engine.update_scene(scene_data)      # evaluated SceneData
    # or engine.load_rtvs("scene.rtvs")
    img = engine.render()                # np.uint8 [H, W, 4]
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..ops.bvh import BLASCache
from ..ops.render_cf import render_rows_cf
from ..ops.twophase import check_two_phase
from ..parallel.tiles import make_mesh, render_pipeline_sharded
from ..post import composite as composite_mod
from ..post import denoise as denoise_mod
from ..post import tonemap
from ..scene.data import SceneData
from ..scene.evaluator import evaluate_scene
from ..scene.flatten import FlatScene, RenderConfig, flatten_scene, make_config, to_device
from ..scene.rtvs import load_graph
from ..scene.sanitize import sanitize_scene
from ..utils.checksum import scene_content_checksum
from ..utils.logging import log_debug, log_error
from .profiler import annotate
from .readback import ReadbackStats, read_back


def render_frame(scene, cfg: RenderConfig, denoise_state, two_phase=False, aperture_size=None):
    """One frame on the scene tensors' device: render -> (denoise) ->
    composite -> RGBA8. Returns (rgba uint8 [H,W,4] tensor, rays tensor,
    new denoiser state, linear HDR colour [3,H,W] tensor, channel-first
    G-buffer, denoised (diffuse [3,H,W], specular [3,H,W], shadow [2,H,W])
    or None). two_phase and aperture_size (the host's): render_rows_cf's."""
    out = render_rows_cf(scene, cfg, two_phase=two_phase, aperture_size=aperture_size)
    denoised = None
    if cfg.enable_denoiser:
        dd, ds, dshadow, denoise_state = denoise_mod.denoise_frame_cf(out.gbuffer, denoise_state)
        denoised = (dd, ds, dshadow)
    return (composite_mod.composite_rgba8(scene, out, denoised), out.rays, denoise_state, out.color, out.gbuffer,
            denoised)


class Engine:
    """Render engine with the EngineWrapper-compatible surface."""

    def __init__(self, width: int, height: int, device="cuda", mesh_service=None,
                 two_phase=False, device_mesh="auto"):
        """device_mesh: a list of devices to shard the frame's rows over
        (parallel/tiles.py::make_mesh; a device may repeat), None for one
        device, or "auto": shard over every visible CUDA device when there
        is more than one and the height divides by their number (None on
        the CPU and with a single card)."""
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
        if isinstance(device_mesh, str):
            if device_mesh != "auto":
                raise ValueError(f"Engine: device_mesh {device_mesh!r}")
            n = torch.cuda.device_count() if self.device.type == "cuda" else 0
            device_mesh = make_mesh() if n > 1 and self.height % n == 0 else None
        elif device_mesh is not None:
            device_mesh = make_mesh(device_mesh)
        self.device_mesh = device_mesh
        self._flat: Optional[FlatScene] = None  # numpy tables
        self._scene_t: Optional[FlatScene] = None  # the same on the device
        self._cfg: Optional[RenderConfig] = None
        self._scene: Optional[SceneData] = None
        self._frame_index = 0
        self._checksum = None
        self._last_rgba: Optional[np.ndarray] = None
        self._last_hdr_t: Optional[torch.Tensor] = None  # [3,H,W] on the device
        # the last frame's channel-first G-buffer and denoised planes, on the
        # device: every frame makes new tensors for them (K6 and the
        # denoiser write in place only into tensors of their own frame)
        self._last_gbuffer = None
        self._last_denoised = None  # (diffuse [3,H,W], specular [3,H,W], shadow [2,H,W])
        self._last_rays = 0
        self._last_photons = 0
        self._last_render_ms = 0.0
        self._readback_stats = ReadbackStats()
        self._prev_view_proj = None
        self._denoise_state = None
        # the mesh caches: object-space BLASes by mesh name (only new geometry
        # runs the SAH build, AccelerationStructure.cpp:560-663), world
        # instances by slot (only a moved one is retransformed), the forest
        # and its device tables (kept while no instance changes)
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
        with annotate("rtvs.update_scene", self._frame_index):
            with annotate("rtvs.scene.sanitize"):
                clean = sanitize_scene(scene)
            # per-object scene dump at the interop boundary (EngineWrapper.cpp:
            # 222-230), gated by the log level as in the reference
            log_debug(
                "UpdateScene: %d objects (%s), %d lights, spp=%d bounces=%d",
                len(clean.objects),
                ", ".join(type(o).__name__ for o in clean.objects) or "empty",
                len(clean.lights), clean.settings.samples_per_pixel,
                clean.settings.max_bounces,
            )
            with annotate("rtvs.scene.flatten"):
                cfg = make_config(clean, self.width, self.height, **config_overrides)
                flat = flatten_scene(clean, frame_index=self._frame_index,
                                     aspect=self.width / self.height,
                                     prev_view_proj=self._prev_view_proj,
                                     mesh_service=self.mesh_service,
                                     blas_cache=self._blas_cache)
            if self.two_phase:
                check_two_phase(cfg, float(flat.aperture_size))
            self._scene = clean
            with annotate("rtvs.scene.checksum"):
                new_checksum = scene_content_checksum(clean)
            if new_checksum != self._checksum:
                self._denoise_state = None
            self._checksum = new_checksum
            self._flat = flat
            self._cfg = cfg
            self._prev_view_proj = np.asarray(self._flat.view_proj)
            with annotate("rtvs.scene.to_device"):
                self._scene_t = to_device(self._flat, self.device, self._blas_cache)

    def load_rtvs(self, path: str, cache_dir: Optional[str] = None, **config_overrides):
        """Load a .rtvs file and update the scene; returns the loaded
        NodeGraph, so a caller that keeps editing it can re-evaluate and
        push updates. cache_dir: as load_rtvs_graph's."""
        graph = self.load_rtvs_graph(path, cache_dir)
        self.update_scene(evaluate_scene(graph), **config_overrides)
        return graph

    def load_rtvs_graph(self, path: str, cache_dir: Optional[str] = None):
        """Load a .rtvs node graph without updating the scene.

        Without a mesh service, FBX mesh names resolve against the first
        model directory that exists of: $RAYTRACEVS_MODEL_PATH,
        Resource/Model next to the scene file, Model next to it
        (MeshCacheService.cs:54-72, DXRPipeline.cpp:191-342); its converted
        meshes are cached in cache_dir/meshcache, or without cache_dir in
        the package's _build/meshcache (the CLI's --cache-dir passes one,
        runtime/cache.py). FBX nodes whose mesh is missing are dropped at
        load (SceneFileService.cs:52-62)."""
        if self.mesh_service is None:
            scene_dir = os.path.dirname(os.path.abspath(path))
            for candidate in (
                os.environ.get("RAYTRACEVS_MODEL_PATH", ""),
                os.path.join(scene_dir, "Resource", "Model"),
                os.path.join(scene_dir, "Model"),
            ):
                if os.path.isdir(candidate):
                    from ..io.mesh_cache import MeshCacheService
                    from ..ops.cuda import _build

                    svc = MeshCacheService(candidate, cache_dir=os.path.join(
                        cache_dir or _build.BUILD_DIR, "meshcache"))
                    try:
                        svc.initialize()
                        self.mesh_service = svc
                    except OSError:
                        pass
                    break
        resolver = self.mesh_service.get_mesh if self.mesh_service is not None else None
        return load_graph(path, mesh_resolver=resolver)

    # -- rendering --------------------------------------------------------
    def _sentinel(self, rgb) -> np.ndarray:
        """Colour-coded failure fill (NativeBridge.cpp:266-356)."""
        img = np.zeros((self.height, self.width, 4), np.uint8)
        img[..., 0], img[..., 1], img[..., 2], img[..., 3] = (*rgb, 255)
        return img

    def render(self, fail_safe: bool = False) -> np.ndarray:
        """Render a frame; returns RGBA8 np.uint8 [H, W, 4].

        With fail_safe=True (the caller's opt-in; the card's path never
        falls back to the CPU), a failure returns the reference's
        colour-coded fill instead of raising: magenta for an exception
        during the render, orange for an all-zero frame
        (NativeBridge.cpp:266-356)."""
        if fail_safe:
            try:
                img = self.render(fail_safe=False)
            except Exception:
                log_error("render failed; returning magenta sentinel")
                return self._sentinel((255, 0, 255))
            if not img[..., :3].any():
                return self._sentinel((255, 165, 0))
            return img
        with annotate("rtvs.render", self._frame_index):
            return self._render()

    def _render(self) -> np.ndarray:
        """render()'s frame: render, denoise, composite, read back."""
        if self._flat is None:
            raise RuntimeError("update_scene() must be called before render()")
        mesh = self.device_mesh
        if self._cfg.enable_denoiser and self._denoise_state is None:
            if mesh is None:
                self._denoise_state = denoise_mod.init_state_cf(self.height, self.width,
                                                                self.device)
            else:  # one history a slab, on its device
                self._denoise_state = [
                    denoise_mod.init_state_cf(self.height // len(mesh), self.width, d)
                    for d in mesh]
        start = time.perf_counter()
        if mesh is None:
            (rgba_t, rays_t, self._denoise_state, self._last_hdr_t, self._last_gbuffer,
             self._last_denoised) = render_frame(
                self._scene_t, self._cfg, self._denoise_state, self.two_phase,
                float(self._flat.aperture_size))
        else:
            (rgba_t, hdr, rays_t, self._last_gbuffer, self._denoise_state,
             self._last_denoised) = render_pipeline_sharded(
                self._scene_t, self._cfg, mesh, self._denoise_state,
                two_phase=self.two_phase, aperture_size=float(self._flat.aperture_size))
            self._last_hdr_t = hdr.permute(2, 0, 1)
            rays_t = rays_t.sum()
        with annotate("rtvs.render.readback"):
            rgba, self._last_rays = read_back(rgba_t, rays_t, self._readback_stats)
        self._last_render_ms = (time.perf_counter() - start) * 1000.0
        self._last_photons = self._cfg.num_photons
        self._last_rgba = rgba
        self._frame_index += 1
        self._flat = self._flat._replace(frame_index=np.asarray(self._frame_index, np.uint32))
        # a fill on the device: no pageable upload, so no second wait
        self._scene_t = self._scene_t._replace(frame_index=torch.full(
            (), self._frame_index, dtype=torch.int64, device=self.device))
        return rgba

    def render_debug_view(self, mode: int) -> np.ndarray:
        """Composite debug visualization of the last frame as RGBA8
        (Composite.hlsl:184-371, the render window's DebugMode selector:
        1 = G-buffer tile strip, 2-4 = shadow input/denoised/split,
        5 = magenta fill, 6-8 = diffuse taps, 9/10 = photon views), from the
        last frame's planes on the device (post/debug_modes.py)."""
        if self._last_gbuffer is None:
            raise RuntimeError("render() must be called before render_debug_view()")
        from ..post.debug_modes import composite_debug

        dd = ds = dsh = None
        if self._last_denoised is not None:
            dd, ds, dsh = self._last_denoised
        out01 = composite_debug(
            int(mode), self._last_gbuffer, denoised_diffuse=dd, denoised_specular=ds,
            denoised_shadow=dsh,
            exposure=float(self._scene.settings.exposure) if self._scene else 1.0,
            photon_map_size=self._cfg.num_photons if self._cfg else 0)
        return tonemap.to_rgba8_cf(out01).cpu().numpy()

    def validate_frame(self) -> dict:
        """Debug-layer analog (SURVEY §5.2): render one frame of the current
        scene through the Engine's own path (the kernels on the card, their
        plain versions on the CPU), without advancing the frame, and audit
        every output channel for NaN/Inf and its contract. Returns
        {"ok": bool, "violations": [str]}, with the JAX Engine's contracts
        and messages."""
        from .. import constants as C

        if self._flat is None:
            raise RuntimeError("update_scene() must be called before validate_frame()")
        out = render_rows_cf(self._scene_t, self._cfg, two_phase=self.two_phase,
                             aperture_size=float(self._flat.aperture_size))
        g = out.gbuffer
        v = []

        def host(a):
            return a.detach().cpu().numpy()

        def finite(name, a):
            if not np.isfinite(a).all():
                v.append(f"{name}: non-finite values")

        def in_range(name, a, lo, hi):
            if a.size and (a.min() < lo or a.max() > hi):
                v.append(f"{name}: out of [{lo}, {hi}] (min {a.min()}, max {a.max()})")

        color = host(out.color)
        finite("color", color)
        in_range("color", color, 0.0, np.inf)
        finite("raw_specular", host(out.raw_specular))
        nr = host(g.normal_roughness)
        finite("normal_roughness", nr)
        in_range("normal_roughness", nr, 0.0, 1.0)
        in_range("view_z", host(g.view_z), C.VIEWZ_MIN, C.VIEWZ_SKY)
        in_range("motion", host(g.motion), -C.MV_CLAMP_PIXELS, C.MV_CLAMP_PIXELS)
        in_range("albedo", host(g.albedo), 0.0, 1.0)
        in_range("shadow visibility", host(g.shadow_data[1]), 0.0, 1.0)
        oid = host(g.obj_id)
        if oid.size and oid.min() < -1:
            v.append(f"obj_id: below -1 (min {oid.min()})")
        sc = self._scene_t
        color01 = host(composite_mod.composite_cf(
            g, out.raw_specular, sc.exposure, sc.tone_map_operator, sc.gamma,
            use_denoised=False))
        finite("composite", color01)
        in_range("composite", color01, 0.0, 1.0)
        return {"ok": not v, "violations": v}

    def get_pixel_data(self) -> bytes:
        """Raw RGBA bytes of the last frame (EngineWrapper::GetPixelData)."""
        if self._last_rgba is None:
            raise RuntimeError("render() must be called before get_pixel_data()")
        return self._last_rgba.tobytes()

    def copy_pixels_into(self, buffer) -> bool:
        """Fill a caller-provided writable buffer with the last frame's RGBA.

        The readback analog of NativeBridge::GetPixelData with its
        colour-coded failure fills (NativeBridge.cpp:266-356): green = no
        frame to read, red = zero-size frame, yellow = buffer too small,
        orange = output was all zeros, magenta = exception. Returns True
        only on a clean copy."""
        mv = memoryview(buffer).cast("B")
        needed = self.width * self.height * 4

        def fill(rgb):
            n = min(len(mv), needed) if needed else len(mv)
            arr = np.frombuffer(mv, dtype=np.uint8, count=len(mv))
            px = arr[: n - n % 4].reshape(-1, 4)
            px[:, 0], px[:, 1], px[:, 2], px[:, 3] = (*rgb, 255)
            return False

        try:
            if needed == 0:
                return fill((255, 0, 0))  # red: zero-size frame
            if len(mv) < needed:
                return fill((255, 255, 0))  # yellow: buffer too small
            if self._last_rgba is None:
                return fill((0, 255, 0))  # green: no pixels to read
            data = self._last_rgba
            if not data[..., :3].any():
                return fill((255, 165, 0))  # orange: all-zero output
            np.frombuffer(mv, dtype=np.uint8, count=needed)[:] = data.reshape(-1)
            return True
        except Exception:
            log_error("copy_pixels_into failed; filling magenta sentinel")
            try:
                return fill((255, 0, 255))  # magenta: exception
            except Exception:
                return False

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
    def last_photons(self) -> int:
        """Photons the last frame emitted and traced for its caustics (the
        photon budget, a host int), 0 with caustics off."""
        return self._last_photons

    @property
    def readback_stats(self) -> ReadbackStats:
        """The frames render() read back through pinned host blocks, and
        those that needed a new block (runtime/readback.py); both 0 on the
        CPU."""
        return self._readback_stats

    @property
    def last_mrays_per_s(self) -> float:
        if self._last_render_ms <= 0:
            return 0.0
        return self._last_rays / (self._last_render_ms * 1e-3) / 1e6


def render_rtvs(path: str, width: int = 512, height: int = 512, **overrides) -> np.ndarray:
    """One-shot: render a .rtvs scene file to an RGBA8 array, on the card
    (Engine(width, height))."""
    engine = Engine(width, height)
    engine.load_rtvs(path, **overrides)
    return engine.render()
