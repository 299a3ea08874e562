"""Wrapper of kernel K9 (csrc/gbuffer.cu): the G-buffer assembly from the
render kernels' accumulator planes.

On CPU tensors ``assemble`` runs its plain version,
ops/render_cf.py::assemble_frame_cf; on CUDA tensors it launches the kernel
or raises. ``assemble.launches`` counts its launches.
"""
from __future__ import annotations

import torch

from .. import render as R
from ..render_cf import FrameOutputCF, GBufferCF, accum_dict, assemble_frame_cf
from . import _build
from .denoise_kernels import _check

_F32 = torch.float32

# The planes of K9's float output [30, H, W]; the fields are views of it.
# The diffuse and specular pairs come first, adjacent, as the denoiser's
# prepass reads them ([8, H, W]).
PLANES = dict(diffuse_hitdist=(0, 4), specular_hitdist=(4, 8), color=(8, 11),
              normal_roughness=(11, 15), view_z=(15, 16), motion=(16, 18),
              motion_spec=(18, 20), albedo=(20, 24), shadow_data=(24, 26),
              shadow_translucency=(26, 30))
NUM_PLANES = 30


def assemble(scene, cfg, acc) -> FrameOutputCF:
    """K9: the frame's HDR colour and channel-first G-buffer from the
    accumulator planes acc [C >= NUM_CH, H, W] (a frame, or a row slab's
    rows; the caustic already added), as assemble_frame_cf(scene, cfg,
    accum_dict(acc)) returns them: every field a contiguous view of one
    [30, H, W] buffer (PLANES) but obj_id (int32), `rays` the float64 sum
    of the ray counts. The camera is read from the scene's device tensors
    in the kernel: nothing is read back to the host."""
    dev = acc.device
    if dev.type == "cpu":
        return assemble_frame_cf(scene, cfg, accum_dict(acc))
    if dev.type != "cuda":
        raise ValueError(f"assemble: unsupported device {dev}")
    if acc.dim() != 3 or acc.shape[0] < R.NUM_CH:
        raise ValueError(f"acc: shape {tuple(acc.shape)}, expected [>= {R.NUM_CH}, H, W]")
    _, h, w = acc.shape
    _check("acc", acc, acc.shape, _F32, dev)
    cam = [scene.cam_right, scene.cam_up, scene.cam_forward, scene.cam_pos]
    for name, t in zip(("cam_right", "cam_up", "cam_forward", "cam_pos"), cam):
        _check(f"scene.{name}", t, (3,), _F32, dev)
    _check("scene.view_proj", scene.view_proj, (4, 4), _F32, dev)
    _check("scene.prev_view_proj", scene.prev_view_proj, (4, 4), _F32, dev)
    out = torch.empty((NUM_PLANES, h, w), dtype=_F32, device=dev)
    obj_id = torch.empty((h, w), dtype=torch.int32, device=dev)
    mode = cfg.photon_debug_mode if cfg.photon_debug_mode in (1, 2) else 0
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rtvs_assemble(
            acc.data_ptr(), *(t.data_ptr() for t in cam), scene.view_proj.data_ptr(),
            scene.prev_view_proj.data_ptr(), out.data_ptr(), obj_id.data_ptr(), h, w, mode,
            1.0 / cfg.samples_per_pixel, float(max(cfg.max_bounces, 1)), cfg.width * 0.5,
            cfg.height * 0.5, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rtvs_assemble")
    assemble.launches += 1
    f = {name: out[a:b] for name, (a, b) in PLANES.items()}
    return FrameOutputCF(
        color=f["color"],
        gbuffer=GBufferCF(
            diffuse_hitdist=f["diffuse_hitdist"], specular_hitdist=f["specular_hitdist"],
            normal_roughness=f["normal_roughness"], view_z=f["view_z"][0], motion=f["motion"],
            albedo=f["albedo"], shadow_data=f["shadow_data"],
            shadow_translucency=f["shadow_translucency"], obj_id=obj_id,
            motion_spec=f["motion_spec"]),
        # per-pixel counts are exact in f32; their frame sum is not, at 1080p
        rays=acc[R.CH_RAYS].to(torch.float64).sum(),
        raw_specular=f["specular_hitdist"][0:3])


assemble.launches = 0
