"""The reference's frame loop: Engine.update_scene and Engine.render of the
port, restated on the plain stages of this frozen copy.

``Replay`` keeps what the Engine keeps between calls (the frame index, the
previous view-projection, the BLAS cache, the geometry checksum and the
denoiser history) and renders a frame as the Engine's default single-device
path does: render, the photon pass when caustics are on, assemble, denoise
(prepass, temporal accumulation, the a-trous passes, the shadow filter),
composite, RGBA8.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .ops import bvh, photon
from .ops import render as R
from .ops.render_cf import accum_dict, assemble_frame_cf
from .post import composite, denoise
from .scene.flatten import flatten_scene, make_config, to_device
from .scene.sanitize import sanitize_scene
from .utils.checksum import scene_content_checksum

# the accumulator planes of colour and hit distance (colour, primary,
# diffuse, specular, hit distance): what a narrower store would round
RADIANCE_PLANES = slice(R.CH_COLOR, R.CH_HITDIST + 1)


class Mesh(NamedTuple):
    """A mesh as the flatten reads it: interleaved vertices [V*8] float32
    (position, pad, normal, pad) and uint32 triangle indices."""

    name: str
    vertices: np.ndarray
    indices: np.ndarray
    bounds_min: np.ndarray
    bounds_max: np.ndarray

    @property
    def vertex_count(self) -> int:
        return len(self.vertices) // 8

    @property
    def positions(self) -> np.ndarray:
        return self.vertices.reshape(-1, 8)[:, 0:3]

    @property
    def normals(self) -> np.ndarray:
        return self.vertices.reshape(-1, 8)[:, 4:7]


class MeshTable:
    """Meshes by name, for flatten_scene's mesh_service."""

    def __init__(self, meshes):
        self._meshes = dict(meshes)

    def get_mesh(self, name: str) -> Optional[Mesh]:
        return self._meshes.get(name)


class Frame(NamedTuple):
    rgba: torch.Tensor  # [H,W,4] uint8
    rays: int
    shadow: torch.Tensor  # denoised (penumbra, visibility) [2,H,W]
    history: torch.Tensor  # the new denoiser history [16,H,W]


def bf16_store(t: torch.Tensor) -> torch.Tensor:
    """The values a bfloat16 store of float32 planes would read back."""
    return t.to(torch.bfloat16).to(torch.float32)


class Replay:
    """The Engine's scene and frame state on the plain stages."""

    def __init__(self, width: int, height: int, device, meshes=()):
        self.width, self.height = int(width), int(height)
        self.device = torch.device(device)
        self.meshes = MeshTable({m.name: m for m in meshes})
        self.blas_cache = bvh.BLASCache()
        self.frame_index = 0
        self.prev_view_proj = None
        self.checksum = None
        self.history = None  # [16,H,W] or None
        self.flat = self.scene_t = self.cfg = None

    def update_scene(self, scene, **overrides) -> None:
        """Engine.update_scene: sanitize, flatten with the frame index and
        the previous view-projection; a new geometry checksum drops the
        history."""
        clean = sanitize_scene(scene)
        cfg = make_config(clean, self.width, self.height, **overrides)
        flat = flatten_scene(clean, frame_index=self.frame_index,
                             aspect=self.width / self.height,
                             prev_view_proj=self.prev_view_proj,
                             mesh_service=self.meshes, blas_cache=self.blas_cache)
        checksum = scene_content_checksum(clean)
        if checksum != self.checksum:
            self.history = None
        self.checksum = checksum
        self.flat, self.cfg = flat, cfg
        self.prev_view_proj = np.asarray(flat.view_proj)
        self.scene_t = to_device(flat, self.device)

    def set_frame_index(self, index: int) -> None:
        """The frame index render() would have reached (it never resets)."""
        self.frame_index = int(index)
        self.flat = self.flat._replace(frame_index=np.asarray(index, np.uint32))
        self.scene_t = self.scene_t._replace(frame_index=torch.tensor(
            index, dtype=torch.int64, device=self.device))

    def _finish(self, acc, store):
        out = assemble_frame_cf(self.scene_t, self.cfg, accum_dict(acc))
        dd, ds, dsh, state = denoise.denoise_frame_cf(
            out.gbuffer, denoise.DenoiserStateCF(packed=self.history), store=store)
        rgba = composite.composite_rgba8(self.scene_t, out, (dd, ds, dsh))
        return Frame(rgba=rgba, rays=int(out.rays.item()), shadow=dsh, history=state.packed)

    def render(self, control: bool = False):
        """Engine.render's frame on the plain stages; the history moves on
        and the frame index advances. With caustics on (num_photons > 0),
        the photon map is built anew and its caustic added into the
        accumulator planes before the assembly, as the port's
        render_rows_cf does. With `control`, returns (frame,
        control frame): the control stores the radiance planes and the
        history as bfloat16 between the stages, from the same render and
        history, and the history moves on from the float32 frame."""
        if not self.cfg.enable_denoiser:
            raise ValueError("the reference frame runs the denoiser")
        if self.history is None:
            self.history = denoise.init_state_cf(self.height, self.width, self.device).packed
        acc = R.render_accum(self.scene_t, self.cfg)
        cfg = self.cfg
        if cfg.num_photons > 0:  # the port's apply_caustics_cf
            acc = photon.add_caustics(photon.emit_and_trace(self.scene_t, cfg.num_photons), acc,
                                      cfg.samples_per_pixel, replace=cfg.photon_debug_mode != 0,
                                      scale=cfg.photon_debug_scale)
        low = None
        if control:
            narrow = acc.clone()
            narrow[RADIANCE_PLANES] = bf16_store(narrow[RADIANCE_PLANES])
            low = self._finish(narrow, bf16_store)
        frame = self._finish(acc, None)
        self.history = frame.history
        self.set_frame_index(self.frame_index + 1)
        return (frame, low) if control else frame
