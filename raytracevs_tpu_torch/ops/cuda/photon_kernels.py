"""Wrappers of kernels K5 and K6 (csrc/photon.cu): the photon emission and
trace, and the photon gather added into the frame's planes.

On CPU tensors each wrapper runs its plain version from ops/photon.py; on
CUDA tensors it launches its kernel or raises. ``emit_and_trace.launches``
and ``add_caustics.launches`` count the launches.
"""
from __future__ import annotations

import torch

from .. import photon as plain
from .. import render as R
from . import _build
from .megakernel import pack_scene

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
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def emit_and_trace(scene, total_photons: int, offset: int, count: int, tables=None):
    """K5: photons [offset, offset+count) of a total_photons batch emitted
    from the scene's lights and traced up to 4 bounces (ops/photon.py::
    _emit_photons, then _trace_photons; every photon is keyed on its
    global index, so a slice equals the same rows of the whole batch).
    `tables`: pack_tables(scene) (or pack_scene's pair), the frame's pack,
    when the caller packed them already: a mesh scene keeps its instance
    material rows, which the light table follows; the meshes are not
    traced. Returns (store_pos, store_dir, store_color [count,3],
    store_power [count], store_mask [count] bool)."""
    dev = _device(scene.cam_pos)
    if not (0 <= offset and 0 <= count and offset + count < 2**31 and total_photons > 0):
        raise ValueError(f"emit_and_trace: photons [{offset}, {offset + count}) of "
                         f"{total_photons}")
    if dev.type == "cpu":
        em = plain._emit_photons(scene, total_photons, offset, count)
        idx = torch.arange(count, dtype=torch.int32) + offset
        return plain._trace_photons(scene, *em, idx)
    ftab, itab = pack_scene(scene) if tables is None else tables[:2]
    _check("ftab", ftab, tuple(ftab.shape), _F32, dev)
    _check("itab", itab, (3,), torch.int32, dev)
    out = [torch.empty((count, 3), dtype=_F32, device=dev) for _ in range(3)]
    out_power = torch.empty((count,), dtype=_F32, device=dev)
    out_mask = torch.empty((count,), dtype=torch.bool, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rtvs_photon_trace(
            ftab.data_ptr(), itab.data_ptr(), scene.sphere_capacity, scene.plane_capacity,
            scene.box_capacity, scene.mat_color.shape[0], scene.light_capacity, total_photons,
            offset, count, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out_power.data_ptr(), out_mask.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rtvs_photon_trace")
    emit_and_trace.launches += 1
    return out[0], out[1], out[2], out_power, out_mask


def add_caustics(pmap: plain.PhotonMap, acc, spp: int, replace: bool = False,
                 scale: float = 1.0):
    """K6: adds the caustic, times spp, into the colour and diffuse planes
    of the accumulator acc [NUM_CH,H,W] in place, at the eligible primary
    hits whose gather finds weight; with replace (a photon debug mode), the
    caustic times spp times scale replaces the depth-0 contribution at
    every eligible pixel instead. Returns acc (see ops/photon.py::
    add_caustics)."""
    dev = _device(acc)
    if dev.type == "cpu":
        return plain.add_caustics(pmap, acc, spp, replace, scale)
    _, h, w = acc.shape
    _check("acc", acc, (R.NUM_CH, h, w), _F32, dev)
    n = pmap.position.shape[0]
    size = pmap.cell_start.shape[0]
    for name, t, shape, dtype in (("position", pmap.position, (n, 3), _F32),
                                  ("direction", pmap.direction, (n, 3), _F32),
                                  ("color", pmap.color, (n, 3), _F32),
                                  ("power", pmap.power, (n,), _F32),
                                  ("valid", pmap.valid, (n,), torch.bool),
                                  ("cell_start", pmap.cell_start, (size,), torch.int32),
                                  ("cell_count", pmap.cell_count, (size,), torch.int32),
                                  ("count", pmap.count, (), torch.int32),
                                  ("radius", pmap.radius, (), _F32),
                                  ("intensity", pmap.intensity, (), _F32)):
        _check(f"pmap.{name}", t, shape, dtype, dev)
    if size != plain.C.PHOTON_HASH_TABLE_SIZE or n == 0:
        raise ValueError(f"add_caustics: {n} photons, {size} hash cells")
    lib = _build.load_library()
    base, plane_bytes = acc.data_ptr(), h * w * acc.element_size()

    def ch(c):  # channel c's plane (acc is contiguous)
        return base + c * plane_bytes

    with torch.cuda.device(dev):
        err = lib.rtvs_photon_gather(
            w, h, ch(R.CH_POS), ch(R.CH_NORMAL), ch(R.CH_PRIM_HIT), ch(R.CH_METALLIC),
            ch(R.CH_TRANSMISSION), pmap.position.data_ptr(), pmap.direction.data_ptr(),
            pmap.color.data_ptr(), pmap.power.data_ptr(), pmap.valid.data_ptr(), n,
            pmap.cell_start.data_ptr(), pmap.cell_count.data_ptr(), pmap.count.data_ptr(),
            pmap.radius.data_ptr(), pmap.intensity.data_ptr(), float(spp), int(bool(replace)),
            float(scale), ch(R.CH_COLOR), ch(R.CH_PRIMARY), ch(R.CH_DIFFUSE), ch(R.CH_SPECULAR),
            ch(R.CH_SHADOW_VIS), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rtvs_photon_gather")
    add_caustics.launches += 1
    return acc


emit_and_trace.launches = 0
add_caustics.launches = 0
