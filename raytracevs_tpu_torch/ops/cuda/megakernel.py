"""Wrappers of the render kernels of csrc/megakernel.cu: K1, the render
megakernel, and the two-phase renderer's K7 (phase A) and K8 (phase B).

``render_accum(scene, cfg)`` returns the [32, H, W] accumulator planes of
the frame. On CPU tensors it runs the plain version
(ops/render.py::render_accum); on CUDA tensors it launches the kernel or
raises. ``render_phase_a`` and ``render_phase_b`` do the same for K7 and
K8 (ops/render.py::render_accum_phase_a/_b; K8 takes K7's hit planes).
Each kernel has one C entry (rtvs_render_accum, rtvs_render_phase_a,
rtvs_render_phase_b), which takes ``pack_tables``' RenderTables and
chooses its instantiation: K1-mesh (MODE_MESH) for a scene with a mesh
leaf, and for a mesh whose wide table needs a deeper walk stack than the
kernels hold (``check_mesh``) the instantiations of
csrc/megakernel_threaded.cu, whose walks follow the fine tree's threaded
links (``fine_nodes``). A frame whose planes pass the kernels' 32-bit
plane index renders in row bands (``row_bands``), a launch each into a
band buffer copied into the frame's planes. Each wrapper's ``.launches``
counts its launches. Given ``counts`` (a [len(R.COUNT_ROWS), 4] int64
CUDA tensor), the entries launch the counting build instead (the same
pixels) and add their work to it: the mesh walks' by ray class, then the
DFS's (ops/render.py::COUNT_ROWS).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import bvh
from .. import render as R
from . import _build

_F32 = torch.float32


def pack_scene(scene):
    """(ftab float32, itab int32) device tables in the kernel's layout:
    spheres [S,5], planes [P,7], boxes [B,16], materials [M,16] (M =
    max(S+P+B+I, 1) with I mesh instances), lights [L,12], 32 params, then
    the 16x16x4 blue-noise tile."""
    dev = scene.cam_pos.device

    def f(x):  # [n, ...] -> [n, k] float32 rows (n may be 0)
        x = x.to(_F32)
        return x[:, None] if x.dim() == 1 else x.flatten(1)

    m = scene.mat_color.shape[0]
    prims = scene.sphere_capacity + scene.plane_capacity + scene.box_capacity
    if scene.mesh is not None:
        prims += scene.mesh.num_inst
    if m != max(prims, 1):  # the kernel finds the light table after max(S+P+B+I, 1) rows
        raise ValueError(f"pack_scene: {m} material rows for {prims} primitive and instance slots")
    zero_m = torch.zeros((m, 1), dtype=_F32, device=dev)
    mat = torch.cat([
        f(scene.mat_color[:, :3]), f(scene.mat_metallic), f(scene.mat_roughness),
        f(scene.mat_transmission), f(scene.mat_ior), f(scene.mat_specular), zero_m,
        f(scene.mat_emission), f(scene.mat_absorption), zero_m], dim=1)
    lts = torch.cat([
        f(scene.lt_type), f(scene.lt_position), f(scene.lt_color[:, :3]), f(scene.lt_intensity),
        f(scene.lt_radius), f(scene.lt_samples), f(scene.lt_valid),
        torch.zeros((scene.light_capacity, 1), dtype=_F32, device=dev)], dim=1)
    params = torch.zeros(32, dtype=_F32, device=dev)
    params[0:3] = scene.cam_pos
    params[3:6] = scene.cam_forward
    params[6:9] = scene.cam_right
    params[9:12] = scene.cam_up
    for i, leaf in enumerate((scene.tan_half_fov, scene.aperture_size, scene.focus_distance,
                              scene.shadow_strength, scene.shadow_absorption_scale,
                              scene.atten_const, scene.atten_linear, scene.atten_quadratic)):
        params[12 + i] = leaf
    from ..sampling import blue_noise_tile

    ftab = torch.cat([
        torch.cat([f(scene.sph_center), f(scene.sph_radius), f(scene.sph_valid)], 1).reshape(-1),
        torch.cat([f(scene.pln_position), f(scene.pln_normal), f(scene.pln_valid)], 1).reshape(-1),
        torch.cat([f(scene.box_center), f(scene.box_half), f(scene.box_axes),
                   f(scene.box_valid)], 1).reshape(-1),
        mat.reshape(-1), lts.reshape(-1), params, blue_noise_tile(dev).reshape(-1)])
    frame = scene.frame_index.to(torch.int64) & 0xFFFFFFFF
    frame = torch.where(frame >= 2**31, frame - 2**32, frame)  # u32 bits as int32
    itab = torch.stack([scene.num_lights.to(torch.int64), scene.max_shadow_lights.to(torch.int64),
                        frame]).to(torch.int32)
    return ftab.contiguous(), itab.contiguous()


def pack_mesh(mesh):
    """The mesh kernels' instance table inst_tbl [I,8] f32 (transmission,
    absorption, shadow Beer factor, 1 pad). The wide nodes, the plane table
    and the triangle arrays are read as they are."""
    inst_tbl = torch.cat([mesh.inst_transmission[:, None], mesh.inst_absorption, mesh.inst_beer,
                          torch.zeros_like(mesh.inst_transmission)[:, None]], dim=1)
    return inst_tbl.contiguous()


def fine_nodes(mesh):
    """[Nn,8] f32 the fine tree as the threaded walks read it
    (csrc/closest.cuh::walk_threaded), 32 bytes a node: min x, min y, min
    z, max x, max y, max z, then as int32 bits the hit word (hit_next; a
    leaf's ~(tri_start << 3 | tri_count), its hit link being its miss link)
    and miss_next."""
    leaf = mesh.tri_count > 0
    word = torch.where(leaf, ~((mesh.tri_start << 3) | mesh.tri_count), mesh.hit_next)
    links = torch.stack([word, mesh.miss_next], dim=1).to(torch.int32).view(_F32)
    return torch.cat([mesh.bbox_min, mesh.bbox_max, links], dim=1).contiguous()


def check_mesh(mesh, name) -> bool:
    """Raise unless the mesh tables are what the walks take (contiguous
    float32/int32 tables); return whether the walks follow the fine tree's
    threaded links, which need no stack, because the wide table's deepest
    walk needs more stack entries than the kernels hold (bvh.WALK_STACK)."""
    for n in ("wide", "plane", "n0", "n1", "n2", "edge1", "edge2", "inst"):
        if not getattr(mesh, n).is_contiguous():
            raise ValueError(f"{name}: mesh.{n} is not contiguous")
    if mesh.inst.dtype != torch.int32 or mesh.plane.dtype != _F32 or mesh.wide.dtype != _F32:
        raise ValueError(f"{name}: mesh dtypes {mesh.inst.dtype}, {mesh.plane.dtype}, "
                         f"{mesh.wide.dtype}")
    return mesh.wide_stack > bvh.WALK_STACK


def walk_nodes(mesh, name):
    """(nodes, threaded): the node table the mesh walks read, the wide
    table or, where check_mesh sends the walks along the threaded links,
    fine_nodes."""
    threaded = check_mesh(mesh, name)
    return (fine_nodes(mesh) if threaded else mesh.wide), threaded


class RenderTables(NamedTuple):
    """Everything the render kernels read of a scene, packed once
    (pack_tables): the launch arguments that do not change with the
    configuration, and the tensors behind their pointers, which it keeps
    alive. ftab and itab come first, so ``tables[:2]`` is pack_scene's
    pair. Without a mesh the mesh fields are None and 0."""
    ftab: Optional[torch.Tensor] = None
    itab: Optional[torch.Tensor] = None
    S: int = 0  # sphere, plane, box and light slots
    P: int = 0
    B: int = 0
    L: int = 0
    nodes: Optional[torch.Tensor] = None  # the wide table, or fine_nodes given threaded
    plane: Optional[torch.Tensor] = None
    n0: Optional[torch.Tensor] = None
    n1: Optional[torch.Tensor] = None
    n2: Optional[torch.Tensor] = None
    e1: Optional[torch.Tensor] = None
    e2: Optional[torch.Tensor] = None
    inst: Optional[torch.Tensor] = None
    inst_tbl: Optional[torch.Tensor] = None  # pack_mesh
    T: int = 0  # triangles, instances, fine nodes
    I: int = 0  # noqa: E741
    Nn: int = 0
    threaded: bool = False


def mesh_tables(mesh, name) -> RenderTables:
    """The mesh fields of RenderTables (the rest left empty): the tables
    the mesh walks read, checked by check_mesh."""
    inst_tbl = pack_mesh(mesh)
    nodes, threaded = walk_nodes(mesh, name)
    return RenderTables(nodes=nodes, plane=mesh.plane, n0=mesh.n0, n1=mesh.n1, n2=mesh.n2,
                        e1=mesh.edge1, e2=mesh.edge2, inst=mesh.inst, inst_tbl=inst_tbl,
                        T=mesh.num_tris, I=mesh.num_inst, Nn=mesh.num_nodes, threaded=threaded)


def pack_tables(scene) -> RenderTables:
    """The scene's RenderTables: pack_scene's (ftab, itab), its slot
    counts and, with a mesh leaf, mesh_tables. Raises unless every leaf is
    on the scene's device."""
    dev = scene.cam_pos.device
    leaves = [(n, leaf) for n, leaf in zip(scene._fields, scene) if n != "mesh"]
    if scene.mesh is not None:
        leaves += [(f"mesh.{n}", leaf) for n, leaf in zip(scene.mesh._fields, scene.mesh)
                   if torch.is_tensor(leaf)]
    for n, leaf in leaves:
        if leaf.device != dev:
            raise ValueError(f"pack_tables: scene.{n} on {leaf.device}, expected {dev}")
    ftab, itab = pack_scene(scene)
    tables = RenderTables() if scene.mesh is None else mesh_tables(scene.mesh, "pack_tables")
    return tables._replace(ftab=ftab, itab=itab, S=scene.sphere_capacity,
                           P=scene.plane_capacity, B=scene.box_capacity,
                           L=scene.light_capacity)


# The kernels index a launch's planes in 32 bits (csrc/render.cuh::Planes
# keeps its stride an int, which keeps K1 and K7 within their registers)
PLANE_LIMIT = 2**31


def row_bands(width, height, channels, limit=PLANE_LIMIT):
    """[(row0, rows), ...]: the row bands, of near-equal height and in
    order, that cover a frame's `height` rows once, each band's `channels`
    planes under `limit` floats; one band (0, height) when the whole
    frame's are. Raises ValueError if one row's planes reach the limit."""
    per_row = channels * width
    if per_row >= limit:
        raise ValueError(f"{channels} planes of a {width}-pixel row reach {limit} floats")
    if height <= 0:
        return []
    n = -(-height // ((limit - 1) // per_row))
    size, extra = divmod(height, n)
    sizes = [size + (i < extra) for i in range(n)]
    return [(sum(sizes[:i]), rows) for i, rows in enumerate(sizes)]


def _check(scene, cfg, name):
    if scene.cam_pos.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {scene.cam_pos.device}")
    if not (1 <= cfg.max_soft_samples <= 16):
        raise ValueError(f"max_soft_samples {cfg.max_soft_samples} outside 1..16")
    # num_photons is not read: the caustics pass follows K1; of the photon
    # debug modes only 3 and 4 reach the shading
    debug = {3: 1, 4: 2}.get(cfg.photon_debug_mode, 0)
    return (int(cfg.has_lights) | int(cfg.any_glass) << 1 | int(cfg.any_metal) << 2
            | int(cfg.any_absorption) << 3 | debug << 4)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def launch_args(tables, cfg, flags, lead, counts=None, band=None):
    """The arguments of a render entry but the stream
    (ops/cuda/_build.py::SIGNATURES): the packed tables, the `lead`
    arguments, the configuration with the row band (row0, rows) it renders
    (the whole frame without one), the mesh tables (nulls without a mesh),
    threaded, then `counts` (null: the plain build)."""
    t = tables
    if counts is not None and (counts.device != t.ftab.device or counts.dtype != torch.int64
                               or tuple(counts.shape) != (len(R.COUNT_ROWS), 4)):
        raise ValueError(f"counts {counts.dtype} {tuple(counts.shape)} on {counts.device}, "
                         f"expected int64 ({len(R.COUNT_ROWS)}, 4) on the scene's device")
    row0, rows = (0, cfg.height) if band is None else band
    return [t.ftab.data_ptr(), t.itab.data_ptr(), *lead, cfg.width, cfg.height, row0, rows,
            t.S, t.P, t.B, t.L, cfg.samples_per_pixel, cfg.max_bounces, cfg.max_queue_iters,
            cfg.max_soft_samples, flags, float(cfg.aspect_ratio),
            *(_ptr(x) for x in (t.nodes, t.plane, t.n0, t.n1, t.n2, t.e1, t.e2, t.inst,
                                t.inst_tbl)),
            t.T, t.I, t.Nn, int(t.threaded), _ptr(counts)]


def _launch(entry, tables, cfg, flags, lead, counts=None, band=None):
    """Call the library's `entry` on launch_args, on the current stream."""
    args = launch_args(tables, cfg, flags, lead, counts, band)
    lib = _build.load_library()
    dev = tables.ftab.device
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)


def _render_bands(entry, wrapper, scene, cfg, flags, tables, channels, slab, limit, counts):
    """The [channels, rows, width] planes of the row slab (row_start, rows)
    of the frame, a launch of `entry` a row band of row_bands(..., limit)
    over it: into the slab's planes for a single band, else into a band
    buffer each, copied into them."""
    row_start, rows = slab
    bands = [(row_start + r0, n) for r0, n in row_bands(cfg.width, rows, channels, limit)]
    dev = scene.cam_pos.device
    out = torch.empty((channels, rows, cfg.width), dtype=_F32, device=dev)
    tables = pack_tables(scene) if tables is None else tables
    for row0, n in bands:
        buf = out if len(bands) == 1 else torch.empty((channels, n, cfg.width), dtype=_F32,
                                                      device=dev)
        _launch(entry, tables, cfg, flags, [buf.data_ptr()], counts, (row0, n))
        wrapper.launches += 1
        if buf is not out:
            out[:, row0 - row_start:row0 - row_start + n].copy_(buf)
    return out


def render_accum(scene, cfg, counts=None, tables=None, limit=PLANE_LIMIT, row_start=0,
                 num_rows=None) -> torch.Tensor:
    """K1: the [NUM_CH, height, width] accumulator planes of the frame
    (K1-mesh when the scene has meshes), a launch per row band of
    row_bands(..., limit); given `num_rows`, the [NUM_CH, num_rows, width]
    planes of the row slab from `row_start` alone (ops/render.py::
    render_accum's). `tables`: pack_tables(scene), when the caller packed
    them already; `counts`: see the module."""
    if scene.cam_pos.device.type == "cpu":
        return R.render_accum(scene, cfg, counts, row_start, num_rows)
    flags = _check(scene, cfg, "render_accum")
    return _render_bands("rtvs_render_accum", render_accum, scene, cfg, flags, tables, R.NUM_CH,
                         R.row_slab(cfg, row_start, num_rows), limit, counts)


def render_phase_a(scene, cfg, tables=None, counts=None, band=None,
                   limit=PLANE_LIMIT) -> torch.Tensor:
    """K7, phase A of the two-phase renderer (spp 1): the [NUM_CH_A,
    height, width] planes of one DFS iteration per pixel and the
    continuation it spawned, a launch per row band of row_bands(...,
    limit); given `band` (row0, rows), the [NUM_CH_A, rows, width] planes
    of that band alone, on the card in one launch. `tables`:
    pack_tables(scene), when the caller packed them already."""
    if scene.cam_pos.device.type == "cpu":
        return R.render_accum_phase_a(scene, cfg, counts, *((0, None) if band is None else band))
    if cfg.samples_per_pixel != 1:
        raise ValueError(f"render_phase_a: samples_per_pixel {cfg.samples_per_pixel}, not 1")
    flags = _check(scene, cfg, "render_phase_a")
    if band is None:
        return _render_bands("rtvs_render_phase_a", render_phase_a, scene, cfg, flags, tables,
                             R.NUM_CH_A, (0, cfg.height), limit, counts)
    row0, rows = _check_band(band, cfg, R.NUM_CH_A, limit, "render_phase_a")
    out = torch.empty((R.NUM_CH_A, rows, cfg.width), dtype=_F32, device=scene.cam_pos.device)
    _launch("rtvs_render_phase_a", pack_tables(scene) if tables is None else tables, cfg, flags,
            [out.data_ptr()], counts, band)
    render_phase_a.launches += 1
    return out


def _check_band(band, cfg, channels, limit, name):
    row0, rows = band
    if not (0 <= row0 and 0 < rows and row0 + rows <= cfg.height
            and channels * rows * cfg.width < limit):
        raise ValueError(f"{name}: band {band} of a {cfg.width}x{cfg.height} frame, "
                         f"{channels} planes under {limit} floats")
    return row0, rows


def render_phase_b(scene, cfg, order, count, acc, hits, tables=None, counts=None,
                   band=None) -> torch.Tensor:
    """K8, phase B of the two-phase renderer (spp 1): resumes the first
    `count` ([1] int32) pixels of `order` ([L] int32 pixel ids) from the
    primary rays' closest hits K7 traced (`hits`, its [NUM_CH_HIT, H, W]
    planes from CH_HIT) and folds each subtree into the phase-A planes
    `acc` ([NUM_CH, H, W] float32, updated in place and returned). Given
    `band` (row0, rows), acc and hits are that band's [C, rows, W] planes
    and the ids are the band's. On the card the count stays on the device:
    the kernel reads it, so the launch needs no host sync."""
    if scene.cam_pos.device.type == "cpu":
        return R.render_accum_phase_b(scene, cfg, order[:int(count)], acc, hits, counts,
                                      0 if band is None else band[0])
    if cfg.samples_per_pixel != 1:
        raise ValueError(f"render_phase_b: samples_per_pixel {cfg.samples_per_pixel}, not 1")
    flags = _check(scene, cfg, "render_phase_b")
    dev = scene.cam_pos.device
    rows = cfg.height if band is None else _check_band(band, cfg, 1, PLANE_LIMIT,
                                                       "render_phase_b")[1]
    for name, t, dtype, shape in (("order", order, torch.int32, (order.numel(),)),
                                  ("count", count, torch.int32, (1,)),
                                  ("acc", acc, _F32, (R.NUM_CH, rows, cfg.width)),
                                  ("hits", hits, _F32, (R.NUM_CH_HIT, rows, cfg.width))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"render_phase_b: {name} {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"render_phase_b: {name} is not contiguous")
    if order.numel() > cfg.width * rows:
        raise ValueError(f"render_phase_b: {order.numel()} lanes for {cfg.width * rows} pixels")
    _launch("rtvs_render_phase_b", pack_tables(scene) if tables is None else tables, cfg, flags,
            [order.data_ptr(), count.data_ptr(), acc.data_ptr(), hits.data_ptr(), order.numel()],
            counts, band)
    render_phase_b.launches += 1
    return acc


render_accum.launches = 0
render_phase_a.launches = 0
render_phase_b.launches = 0
