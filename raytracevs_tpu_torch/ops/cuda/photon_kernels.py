"""Wrappers of kernels K5 and K6 (csrc/photon.cu): the photon trace and the
photon gather of the caustics pass.

On CPU tensors each wrapper runs its plain version from ops/photon.py; on
CUDA tensors it launches its kernel or raises. ``trace_photons.launches``
and ``gather.launches`` count the launches.
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


def trace_photons(scene, origin, direction, color, power, alive, idx):
    """K5: the 4-bounce photon loop (see ops/photon.py::_trace_photons).
    origin/direction/color [P,3] f32, power [P] f32, alive [P] bool, idx
    [P] int32 global photon indices. The scene is packed as K1 packs it: a
    mesh scene keeps its instance material rows, which the light table
    follows; the meshes are not traced. Returns (store_pos, store_dir,
    store_color [P,3], store_power [P], store_mask [P] bool)."""
    dev = _device(origin)
    if dev.type == "cpu":
        return plain._trace_photons(scene, origin, direction, color, power, alive, idx)
    if scene.cam_pos.device != dev:
        raise ValueError(f"trace_photons: scene on {scene.cam_pos.device}, photons on {dev}")
    ftab, _ = pack_scene(scene)
    s, p, b = scene.sphere_capacity, scene.plane_capacity, scene.box_capacity
    m, lights = scene.mat_color.shape[0], scene.light_capacity
    n = origin.shape[0]
    _check("ftab", ftab, tuple(ftab.shape), _F32, dev)
    for name, t, shape, dtype in (("origin", origin, (n, 3), _F32),
                                  ("direction", direction, (n, 3), _F32),
                                  ("color", color, (n, 3), _F32), ("power", power, (n,), _F32),
                                  ("alive", alive, (n,), torch.bool),
                                  ("idx", idx, (n,), torch.int32)):
        _check(name, t, shape, dtype, dev)
    out = [torch.empty((n, 3), dtype=_F32, device=dev) for _ in range(3)]
    out_power = torch.empty((n,), dtype=_F32, device=dev)
    out_mask = torch.empty((n,), dtype=torch.bool, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.rtvs_photon_trace(
            ftab.data_ptr(), s, p, b, m, lights, n, origin.data_ptr(), direction.data_ptr(),
            color.data_ptr(), power.data_ptr(), alive.data_ptr(), idx.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), out_power.data_ptr(),
            out_mask.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rtvs_photon_trace")
    trace_photons.launches += 1
    return out[0], out[1], out[2], out_power, out_mask


def gather(pmap: plain.PhotonMap, acc, spp: int):
    """K6: the caustic delta [3,H,W] at the eligible primary hits of the
    accumulator planes acc [NUM_CH,H,W], already times spp (see
    ops/photon.py::caustics_delta)."""
    dev = _device(acc)
    if dev.type == "cpu":
        return plain.caustics_delta(pmap, acc, spp)
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
        raise ValueError(f"gather: {n} photons, {size} hash cells")
    out = torch.empty((3, h, w), dtype=_F32, device=dev)
    lib = _build.load_library()

    def ch(c):
        return acc[c].data_ptr()

    with torch.cuda.device(dev):
        err = lib.rtvs_photon_gather(
            w, h, ch(R.CH_POS), ch(R.CH_NORMAL), ch(R.CH_PRIM_HIT), ch(R.CH_METALLIC),
            ch(R.CH_TRANSMISSION), pmap.position.data_ptr(), pmap.direction.data_ptr(),
            pmap.color.data_ptr(), pmap.power.data_ptr(), pmap.valid.data_ptr(), n,
            pmap.cell_start.data_ptr(), pmap.cell_count.data_ptr(), pmap.count.data_ptr(),
            pmap.radius.data_ptr(), pmap.intensity.data_ptr(), float(spp), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rtvs_photon_gather")
    gather.launches += 1
    return out


trace_photons.launches = 0
gather.launches = 0
