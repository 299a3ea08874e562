"""Row-sharded rendering over a list of torch devices (restates
raytracevs_tpu/parallel/tiles.py).

The frame's rows are cut into equal slabs, one per entry of the mesh, a
list of devices. A device may repeat: make_mesh(["cuda:0"] * 4) renders
four slabs in turns on one card, and with more cards the same code puts
each slab on its own card. The scene is replicated (its tensors go to each
distinct device once a call), each slab renders its rows with their frame
coordinates (ops/render_cf.py::render_rows_cf with row_start, num_rows),
the photon batch is split over the slabs and gathered back
(ops/photon.py::sharded_photon_map), and the denoiser exchanges halo rows
between neighbouring slabs (post/denoise.py::denoise_frame_sharded_cf), so
the stitched frame equals the single-device frame bit for bit. Composite
and tone map are per pixel.
"""
from __future__ import annotations

import torch

from ..ops.cuda import megakernel
from ..ops.photon import sharded_photon_map
from ..ops.render_cf import FrameOutputCF, GBufferCF, render_rows_cf
from ..post import denoise as denoise_mod
from ..post.composite import composite_rgba8


def make_mesh(devices=None) -> list:
    """The mesh: a list of torch.device, all visible CUDA devices or the
    given ones (which may repeat). Raises RuntimeError when no CUDA
    device is visible and none are given."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass the devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [_device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: an empty device list")
    return mesh


def _device(d):
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _to(x, dev):
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(leaf, dev) for leaf in x))
    return x


def replicate(scene, mesh) -> list:
    """The scene (a FlatScene of tensors, scene/flatten.py::to_device's) on
    each slab's device, in mesh order; each distinct device gets its copy
    once, and the device the scene is on gets the scene itself."""
    copies = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = _to(scene, dev)
    return [copies[dev] for dev in mesh]


def _slab_rows(cfg, mesh) -> int:
    n = len(mesh)
    if cfg.height % n != 0:
        raise ValueError(f"height {cfg.height} not divisible by {n} devices")
    return cfg.height // n


def _stitch(parts, dim, dev):
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def _render_slabs(scenes, cfg, mesh, two_phase, aperture_size):
    """Each slab's FrameOutputCF: the tables packed once for each distinct
    CUDA device, the photon map built from per-slab slices when the count
    divides (else each slab's render builds the whole map itself)."""
    rows = _slab_rows(cfg, mesh)
    packed = {}
    tables = []
    for sc in scenes:
        dev = sc.cam_pos.device
        if dev.type == "cuda" and dev not in packed:
            packed[dev] = megakernel.pack_tables(sc)
        tables.append(packed.get(dev))
    pmaps = sharded_photon_map(scenes, cfg.num_photons, tables)
    return [render_rows_cf(sc, cfg, i * rows, rows, two_phase, aperture_size,
                           pmap=None if pmaps is None else pmaps[i], tables=tables[i])
            for i, sc in enumerate(scenes)]


def _stitch_gbuffer(gbufs, dev):
    def rows_dim(x):
        return x.dim() - 2  # [c, rows, W] or [rows, W]

    return GBufferCF(*(None if parts[0] is None else _stitch(parts, rows_dim(parts[0]), dev)
                       for parts in zip(*gbufs)))


def render_frame_sharded(scene, cfg, mesh=None, two_phase=False, aperture_size=None):
    """Render a frame with its rows sharded over the mesh (make_mesh() by
    default). cfg.height must divide by the mesh's length, else
    ValueError. Returns (the stitched FrameOutputCF on the mesh's first
    device, whose `rays` is the frame's; the rays of each slab [n],
    float64). two_phase, aperture_size: render_rows_cf's."""
    mesh = make_mesh() if mesh is None else make_mesh(mesh)
    outs = _render_slabs(replicate(scene, mesh), cfg, mesh, two_phase, aperture_size)
    dev = mesh[0]
    rays = torch.stack([o.rays.to(dev) for o in outs])
    frame = FrameOutputCF(color=_stitch([o.color for o in outs], 1, dev),
                          gbuffer=_stitch_gbuffer([o.gbuffer for o in outs], dev),
                          rays=rays.sum(), raw_specular=_stitch([o.raw_specular for o in outs],
                                                                1, dev))
    return frame, rays


def render_pipeline_sharded(scene, cfg, mesh=None, denoise_state=None, want_aux=True,
                            two_phase=False, aperture_size=None):
    """The engine's frame with its rows sharded over the mesh: render,
    denoise (halo-row exchanges between the slabs), composite and tone map
    per slab. Returns (rgba [H,W,4] uint8, hdr [H,W,3], rays [n] float64,
    gbuffer, new_state, denoised), the JAX package's contract: rgba, hdr,
    the channel-first G-buffer and denoised (diffuse [3,H,W], specular
    [3,H,W], shadow [2,H,W]) stitched on the mesh's first device;
    new_state one DenoiserStateCF per slab, on its device (denoise_state:
    the last frame's, a list in mesh order; None skips the denoiser).
    want_aux=False leaves hdr, gbuffer and denoised None. cfg.height must
    divide by the mesh's length, else ValueError."""
    mesh = make_mesh() if mesh is None else make_mesh(mesh)
    _slab_rows(cfg, mesh)
    scenes = replicate(scene, mesh)
    outs = _render_slabs(scenes, cfg, mesh, two_phase, aperture_size)
    denoised = None
    new_state = denoise_state
    if cfg.enable_denoiser and denoise_state is not None:
        dd, ds, dsh, new_state = denoise_mod.denoise_frame_sharded_cf(
            [o.gbuffer for o in outs], denoise_state, cfg.height)
        denoised = list(zip(dd, ds, dsh))
    dev = mesh[0]
    rgba = _stitch([composite_rgba8(sc, o, None if denoised is None else denoised[i])
                    for i, (sc, o) in enumerate(zip(scenes, outs))], 0, dev)
    rays = torch.stack([o.rays.to(dev) for o in outs])
    if not want_aux:
        return rgba, None, rays, None, new_state, None
    hdr = _stitch([o.color for o in outs], 1, dev).permute(1, 2, 0)
    gbuffer = _stitch_gbuffer([o.gbuffer for o in outs], dev)
    if denoised is not None:
        denoised = tuple(_stitch(parts, 1, dev) for parts in zip(*denoised))
    return rgba, hdr, rays, gbuffer, new_state, denoised
