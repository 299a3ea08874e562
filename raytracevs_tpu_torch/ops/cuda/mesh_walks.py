"""Wrappers of the walk-only entry points of csrc/walks.cu: the mesh walks
of the render kernels (csrc/closest.cuh) for given rays, one thread a ray.

``closest(mesh, o, d, tmin, tmax, skip_active, skip_inst, thick_inst)``
returns what ops/bvh.py::traverse_closest returns (a TriHit), and
``shadow(mesh, o, d, max_dist, blocked0)`` what traverse_shadow returns
(visibility, colour, occluder distance), bit for bit. On CPU tensors they
run those plain walks; on CUDA tensors they launch the kernel or raise.
Each wrapper's ``.launches`` counts its launches. A mesh whose wide table
needs a deeper stack than the kernels hold walks the fine tree's threaded
links, as the render kernels do (megakernel.py::mesh_tables). They are not
on a render path: they hold the walks against the plain ones on many rays.
"""
from __future__ import annotations

import torch

from .. import bvh
from . import _build
from .megakernel import mesh_tables


def _check_lanes(name, dev, **tensors):
    for k, (t, dtype, shape) in tensors.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {k} {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")


def _tables(mesh, name):
    """(the tensors to keep alive, the entry's table arguments)."""
    t = mesh_tables(mesh, name)
    return t, [t.nodes.data_ptr(), t.plane.data_ptr(), t.inst.data_ptr(), t.inst_tbl.data_ptr(),
               t.T, t.I, t.Nn, int(t.threaded)]


def _call(entry, dev, args):
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)


def closest(mesh, o, d, tmin: float, tmax: float, skip_active, skip_inst,
            thick_inst) -> bvh.TriHit:
    """The closest-hit walk of [N] rays: o, d [N,3] float32; skip_active
    [N] bool, skip_inst and thick_inst [N] int32 (-1: no thickness query)."""
    n, dev = o.shape[0], o.device
    if dev.type == "cpu":
        return bvh.traverse_closest(mesh, o, d, torch.full((n,), tmin), torch.full((n,), tmax),
                                    skip_active=skip_active, skip_inst=skip_inst,
                                    thick_inst=thick_inst)
    f32, i32 = torch.float32, torch.int32
    _check_lanes("closest", dev, o=(o, f32, (n, 3)), d=(d, f32, (n, 3)),
                 skip_active=(skip_active, torch.bool, (n,)), skip_inst=(skip_inst, i32, (n,)),
                 thick_inst=(thick_inst, i32, (n,)))
    keep, tables = _tables(mesh, "closest")
    t, u, v, thick_t = (torch.empty((n,), dtype=f32, device=dev) for _ in range(4))
    tri, inst = (torch.empty((n,), dtype=i32, device=dev) for _ in range(2))
    hit, thick_hit = (torch.empty((n,), dtype=torch.bool, device=dev) for _ in range(2))
    _call("rtvs_mesh_closest", dev, tables + [
        n, o.data_ptr(), d.data_ptr(), float(tmin), float(tmax), skip_active.data_ptr(),
        skip_inst.data_ptr(), thick_inst.data_ptr(), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
        v.data_ptr(), inst.data_ptr(), hit.data_ptr(), thick_hit.data_ptr(),
        thick_t.data_ptr()])
    closest.launches += 1
    return bvh.TriHit(hit=hit, t=t, tri=tri, u=u, v=v, inst=inst, thick_hit=thick_hit,
                      thick_t=thick_t)


def shadow(mesh, o, d, max_dist, blocked0):
    """The shadow walk of [N] rays: o, d [N,3] float32, max_dist [N]
    float32, blocked0 [N] bool. Returns (visibility [N], colour [N,3],
    occluder distance [N])."""
    n, dev = o.shape[0], o.device
    if dev.type == "cpu":
        return bvh.traverse_shadow(mesh, o, d, max_dist, blocked0=blocked0)
    f32 = torch.float32
    _check_lanes("shadow", dev, o=(o, f32, (n, 3)), d=(d, f32, (n, 3)),
                 max_dist=(max_dist, f32, (n,)), blocked0=(blocked0, torch.bool, (n,)))
    keep, tables = _tables(mesh, "shadow")
    vis, occ = (torch.empty((n,), dtype=f32, device=dev) for _ in range(2))
    color = torch.empty((n, 3), dtype=f32, device=dev)
    _call("rtvs_mesh_shadow", dev, tables + [
        n, o.data_ptr(), d.data_ptr(), max_dist.data_ptr(), blocked0.data_ptr(), vis.data_ptr(),
        color.data_ptr(), occ.data_ptr()])
    shadow.launches += 1
    return vis, color, occ


closest.launches = 0
shadow.launches = 0
