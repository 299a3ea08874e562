"""Wrappers of kernels K2-K4 (csrc/denoise.cu): reprojection, a-trous and
the shadow filter.

On CPU tensors each wrapper runs its plain version from post/denoise.py; on
CUDA tensors it launches its kernel or raises. Each wrapper's ``launches``
counts its kernel launches (the a-trous wrapper counts one per pass).
"""
from __future__ import annotations

import torch

from ...post import denoise as plain
from . import _build

_F32 = torch.float32


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _device(t):
    """'cpu' for the plain version, the CUDA device for a kernel; raises else."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def reproject_accumulate(packed, curr, motion, view_z, roughness, motion_spec):
    """K2: temporal reprojection + accumulation -> new packed state [16,H,W]
    (see post/denoise.py::temporal_accumulate)."""
    dev = _device(packed)
    if dev.type == "cpu":
        return plain.temporal_accumulate(packed, curr, motion, view_z, roughness, motion_spec)
    h, w = view_z.shape
    _check("packed", packed, (plain.STATE_CH, h, w), _F32, dev)
    _check("curr", curr, (8, h, w), _F32, dev)
    _check("motion", motion, (2, h, w), _F32, dev)
    _check("view_z", view_z, (h, w), _F32, dev)
    _check("roughness", roughness, (h, w), _F32, dev)
    _check("motion_spec", motion_spec, (2, h, w), _F32, dev)
    out = torch.empty_like(packed)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rtvs_reproject_accumulate(
            packed.data_ptr(), curr.data_ptr(), motion.data_ptr(), motion_spec.data_ptr(),
            view_z.data_ptr(), roughness.data_ptr(), out.data_ptr(), h, w, _stream(dev))
    _build.check(err, "rtvs_reproject_accumulate")
    reproject_accumulate.launches += 1
    return out


def atrous(img, view_z, normal, guide):
    """K3: the anti-firefly clamp, then ATROUS_PASSES guided edge-stopping
    a-trous passes (strides 1, 2, 4) over the 6-channel diffuse+specular img
    [6,H,W] (see post/denoise.py::atrous)."""
    dev = _device(img)
    if dev.type == "cpu":
        return plain.atrous(img, view_z, normal, guide)
    h, w = view_z.shape
    _check("img", img, (6, h, w), _F32, dev)
    _check("view_z", view_z, (h, w), _F32, dev)
    _check("normal", normal, (3, h, w), _F32, dev)
    _check("guide", guide, (2, h, w), _F32, dev)
    lib = _build.load_library()
    bufs = [torch.empty_like(img), torch.empty_like(img)]
    with torch.cuda.device(dev):
        stream = _stream(dev)
        _build.check(lib.rtvs_anti_firefly(img.data_ptr(), bufs[1].data_ptr(), h, w, stream),
                     "rtvs_anti_firefly")
        src = bufs[1]
        for p in range(plain.ATROUS_PASSES):
            dst = bufs[p % 2]
            err = lib.rtvs_atrous_pass(src.data_ptr(), view_z.data_ptr(), normal.data_ptr(),
                                       guide.data_ptr(), dst.data_ptr(), h, w, 1 << p, stream)
            _build.check(err, "rtvs_atrous_pass")
            atrous.launches += 1
            src = dst
    return src


def shadow_denoise(shadow, obj_id, view_z, normal):
    """K4: the ShadowDenoise.hlsl filter on (penumbra, visibility) [2,H,W]
    (see post/denoise.py::shadow_denoise)."""
    dev = _device(shadow)
    if dev.type == "cpu":
        return plain.shadow_denoise(shadow, obj_id, view_z, normal)
    h, w = view_z.shape
    _check("shadow", shadow, (2, h, w), _F32, dev)
    _check("obj_id", obj_id, (h, w), torch.int32, dev)
    _check("view_z", view_z, (h, w), _F32, dev)
    _check("normal", normal, (3, h, w), _F32, dev)
    out = torch.empty_like(shadow)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rtvs_shadow_denoise(shadow.data_ptr(), obj_id.data_ptr(), view_z.data_ptr(),
                                      normal.data_ptr(), out.data_ptr(), h, w, _stream(dev))
    _build.check(err, "rtvs_shadow_denoise")
    shadow_denoise.launches += 1
    return out


reproject_accumulate.launches = 0
atrous.launches = 0
shadow_denoise.launches = 0
