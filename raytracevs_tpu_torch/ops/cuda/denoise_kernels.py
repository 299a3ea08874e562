"""Wrappers of kernels K2-K4 and K10 (csrc/denoise.cu): reprojection (whole
frames and row slabs), a-trous (the fused chain, and one pass a launch for
the sharded denoise), the shadow filter, and the REBLUR prepass before
reprojection.

On CPU tensors each wrapper runs its plain version from post/denoise.py; on
CUDA tensors it launches its kernel or raises. Each wrapper's ``launches``
counts its kernel launches, one a call; ``reproject_accumulate.
slab_launches`` counts those of K2's slab form among them, and
``atrous_pass.launches`` those of atrous_pass and atrous_pass_slab, one
kernel.
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


def reblur_prepass(curr, view_z, sqrt_rough):
    """K10: the hit-distance reconstruction and the specular prepass blur
    on curr [8,H,W] (diffuse rgb + hit distance, specular rgb + hit
    distance), view_z and sqrt_rough [H,W] -> [8,H,W] (see
    post/denoise.py::reblur_prepass). Any H: a row slab extended by
    PREPASS_HALO rows is a frame of its own."""
    dev = _device(curr)
    if dev.type == "cpu":
        return plain.reblur_prepass(curr, view_z, sqrt_rough)
    h, w = view_z.shape
    _check("curr", curr, (8, h, w), _F32, dev)
    _check("view_z", view_z, (h, w), _F32, dev)
    _check("sqrt_rough", sqrt_rough, (h, w), _F32, dev)
    out = torch.empty_like(curr)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rtvs_reblur_prepass(curr.data_ptr(), view_z.data_ptr(), sqrt_rough.data_ptr(),
                                      out.data_ptr(), h, w, _stream(dev))
    _build.check(err, "rtvs_reblur_prepass")
    reblur_prepass.launches += 1
    return out


def reproject_accumulate(packed, curr, motion, view_z, roughness, motion_spec, halo=0, row0=0,
                         global_h=None):
    """K2: temporal reprojection + accumulation -> new packed state [16,H,W]
    (see post/denoise.py::temporal_accumulate). For a row slab of H rows
    from frame row `row0` of a `global_h`-row frame, `packed` is the
    slab's history extended by `halo` rows on each side, [16,H+2 halo,W]."""
    dev = _device(packed)
    if dev.type == "cpu":
        return plain.temporal_accumulate(packed, curr, motion, view_z, roughness, motion_spec,
                                         halo, row0, global_h)
    h, w = view_z.shape
    global_h = h if global_h is None else int(global_h)
    if not (halo >= 0 and 0 <= row0 and row0 + h <= global_h):
        raise ValueError(f"reproject_accumulate: slab [{row0}, {row0 + h}) of {global_h} rows, "
                         f"halo {halo}")
    _check("packed", packed, (plain.STATE_CH, h + 2 * halo, w), _F32, dev)
    _check("curr", curr, (8, h, w), _F32, dev)
    _check("motion", motion, (2, h, w), _F32, dev)
    _check("view_z", view_z, (h, w), _F32, dev)
    _check("roughness", roughness, (h, w), _F32, dev)
    _check("motion_spec", motion_spec, (2, h, w), _F32, dev)
    out = torch.empty((plain.STATE_CH, h, w), dtype=_F32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rtvs_reproject_accumulate(
            packed.data_ptr(), curr.data_ptr(), motion.data_ptr(), motion_spec.data_ptr(),
            view_z.data_ptr(), roughness.data_ptr(), out.data_ptr(), h, w, int(halo), int(row0),
            global_h, _stream(dev))
    _build.check(err, "rtvs_reproject_accumulate")
    reproject_accumulate.launches += 1
    if (halo, row0, global_h) != (0, 0, h):  # a row slab
        reproject_accumulate.slab_launches += 1
    return out


def atrous(img, view_z, normal, guide):
    """K3: the anti-firefly clamp, then ATROUS_PASSES guided edge-stopping
    a-trous passes (strides 1, 2, 4) over the 6-channel diffuse+specular img
    [6,H,W], all in one launch (see post/denoise.py::atrous)."""
    dev = _device(img)
    if dev.type == "cpu":
        return plain.atrous(img, view_z, normal, guide)
    h, w = view_z.shape
    _check("img", img, (6, h, w), _F32, dev)
    _check("view_z", view_z, (h, w), _F32, dev)
    _check("normal", normal, (3, h, w), _F32, dev)
    _check("guide", guide, (2, h, w), _F32, dev)
    out = torch.empty_like(img)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rtvs_atrous(img.data_ptr(), view_z.data_ptr(), normal.data_ptr(),
                              guide.data_ptr(), out.data_ptr(), h, w, _stream(dev))
    _build.check(err, "rtvs_atrous")
    atrous.launches += 1
    return out


def atrous_pass(img, view_z, normal, guide, stride, anti_firefly):
    """One guided edge-stopping a-trous pass at `stride` (1, 2 or 4) over
    the 6-channel diffuse+specular img [6,H,W], with `anti_firefly` the
    3x3 luminance clamp applied to img first; one launch (see
    post/denoise.py::atrous_single_pass): the slab form's body on the whole
    frame, the slab with no rows above or below."""
    dev = _device(img)
    if dev.type == "cpu":
        return plain.atrous_single_pass(img, view_z, normal, guide, stride, anti_firefly)
    h, w = view_z.shape
    _check("img", img, (6, h, w), _F32, dev)
    _check("view_z", view_z, (h, w), _F32, dev)
    _check("normal", normal, (3, h, w), _F32, dev)
    _check("guide", guide, (2, h, w), _F32, dev)
    return _launch_pass(img, img[:, :0], img[:, :0], view_z, normal, guide, 0, h, stride,
                        anti_firefly)


def atrous_pass_slab(img, above, below, view_z, normal, guide, row0, global_h, stride,
                     anti_firefly):
    """The pass on a row slab, read where it lies (see post/denoise.py::
    atrous_pass_slab): img [6,rows,W], frame rows [row0, row0 + rows) of a
    global_h-row frame; above and below [6,n,W] the frame rows next to it
    (n from pass_halo, the pass's reach: the stride, one more with the
    clamp); view_z [R,W], normal [3,R,W] and guide [2,R,W] the slab's rows
    extended by ATROUS_REACH rows, cut at the frame's edges. Each may be a
    view whose rows are contiguous (a plane stride of its own): one launch,
    no copy. Returns [6,rows,W]."""
    dev = _device(img)
    if dev.type == "cpu":
        return plain.atrous_pass_slab(img, above, below, view_z, normal, guide, row0, global_h,
                                      stride, anti_firefly)
    rows, w = img.shape[1:]
    reach = int(stride) + int(bool(anti_firefly))
    n_above, n_below = plain.pass_halo(row0, rows, global_h, reach)
    aux = (min(row0 + rows + plain.ATROUS_REACH, global_h)
           - max(row0 - plain.ATROUS_REACH, 0))
    for name, t, shape in (("img", img, (6, rows, w)), ("above", above, (6, n_above, w)),
                           ("below", below, (6, n_below, w)), ("view_z", view_z, (aux, w)),
                           ("normal", normal, (3, aux, w)), ("guide", guide, (2, aux, w))):
        _check_rows(name, t, shape, dev)
    return _launch_pass(img, above, below, view_z, normal, guide, row0, global_h, stride,
                        anti_firefly)


def _check_rows(name, t, shape, device):
    """As _check, but a view's planes may lie apart: rows of W contiguous
    floats, planes at any stride the C int holds."""
    if t.device != device or t.dtype != _F32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected float32 "
                         f"{tuple(shape)} on {device}")
    if t.stride()[-1] != 1 or (t.dim() > 1 and t.shape[-2] > 1 and t.stride()[-2] != t.shape[-1]):
        raise ValueError(f"{name}: its rows are not contiguous (strides {t.stride()})")
    if t.dim() == 3 and t.stride(0) >= 2 ** 31:
        raise ValueError(f"{name}: plane stride {t.stride(0)} past the kernel's int")


def _launch_pass(img, above, below, view_z, normal, guide, row0, global_h, stride, anti_firefly):
    if stride not in (1, 2, 4):
        raise ValueError(f"atrous_pass: stride {stride}, the kernel takes 1, 2 or 4")
    dev = img.device
    rows, w = img.shape[1:]
    if not (0 <= row0 and row0 + rows <= global_h):
        raise ValueError(f"atrous_pass: slab [{row0}, {row0 + rows}) of {global_h} rows")
    out = torch.empty((6, rows, w), dtype=_F32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rtvs_atrous_pass(
            img.data_ptr(), img.stride(0), above.data_ptr(), above.stride(0), below.data_ptr(),
            below.stride(0), view_z.data_ptr(), normal.data_ptr(), normal.stride(0),
            guide.data_ptr(), guide.stride(0), out.data_ptr(), rows, w, int(row0),
            int(global_h), max(int(row0) - plain.ATROUS_REACH, 0), int(stride),
            int(bool(anti_firefly)), _stream(dev))
    _build.check(err, "rtvs_atrous_pass")
    atrous_pass.launches += 1
    return out


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


reblur_prepass.launches = 0
reproject_accumulate.launches = 0
reproject_accumulate.slab_launches = 0
atrous.launches = 0
atrous_pass.launches = 0
shadow_denoise.launches = 0
