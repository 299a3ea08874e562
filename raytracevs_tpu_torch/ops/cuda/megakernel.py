"""Wrapper of kernel K1 (csrc/megakernel.cu), the render megakernel.

``render_accum(scene, cfg)`` returns the [32, H, W] accumulator planes of
the frame. On CPU tensors it runs the plain version
(ops/render.py::render_accum); on CUDA tensors it launches the kernel or
raises: the analytic instantiation for a scene without meshes, and K1-mesh
(``render_accum_mesh``, entry rtvs_render_accum_mesh) for a scene with a
mesh leaf. ``render_accum.launches`` and ``render_accum_mesh.launches``
count the launches of each.
"""
from __future__ import annotations

import torch

from ..render import NUM_CH
from ..render import render_accum as render_accum_plain
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
    """K1-mesh's node and instance tables: node_box [Nn,8] f32 (bbox_min,
    bbox_max, 2 pad), node_link [Nn,4] int32 (hit_next, miss_next,
    tri_start, tri_count), inst_tbl [I,8] f32 (transmission, absorption,
    shadow Beer factor, 1 pad). The plane table and the triangle arrays are
    read as they are."""
    nn = mesh.num_nodes
    node_box = torch.cat([mesh.bbox_min, mesh.bbox_max,
                          torch.zeros((nn, 2), dtype=_F32, device=mesh.bbox_min.device)], dim=1)
    node_link = torch.stack([mesh.hit_next, mesh.miss_next, mesh.tri_start, mesh.tri_count],
                            dim=1).to(torch.int32)
    inst_tbl = torch.cat([mesh.inst_transmission[:, None], mesh.inst_absorption, mesh.inst_beer,
                          torch.zeros_like(mesh.inst_transmission)[:, None]], dim=1)
    return node_box.contiguous(), node_link.contiguous(), inst_tbl.contiguous()


def _check(scene, cfg, name):
    dev = scene.cam_pos.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    leaves = [(n, leaf) for n, leaf in zip(scene._fields, scene) if n != "mesh"]
    if scene.mesh is not None:
        leaves += [(f"mesh.{n}", leaf) for n, leaf in zip(scene.mesh._fields, scene.mesh)]
    for n, leaf in leaves:
        if leaf.device != dev:
            raise ValueError(f"{name}: scene.{n} on {leaf.device}, expected {dev}")
    if cfg.photon_debug_mode:  # num_photons is not read: the caustics pass follows K1
        raise NotImplementedError("photon debug modes: not ported yet")
    if not (1 <= cfg.max_soft_samples <= 16):
        raise ValueError(f"max_soft_samples {cfg.max_soft_samples} outside 1..16")
    flags = (int(cfg.has_lights) | int(cfg.any_glass) << 1 | int(cfg.any_metal) << 2
             | int(cfg.any_absorption) << 3)
    return dev, flags


def _common_args(scene, cfg, ftab, itab, out, flags):
    return (ftab.data_ptr(), itab.data_ptr(), out.data_ptr(), cfg.width, cfg.height,
            scene.sphere_capacity, scene.plane_capacity, scene.box_capacity,
            scene.light_capacity, cfg.samples_per_pixel, cfg.max_bounces, cfg.max_queue_iters,
            cfg.max_soft_samples, flags, float(cfg.aspect_ratio))


def render_accum(scene, cfg) -> torch.Tensor:
    """K1: the [NUM_CH, height, width] accumulator planes of the frame
    (K1-mesh when the scene has meshes)."""
    dev = scene.cam_pos.device
    if dev.type == "cpu":
        return render_accum_plain(scene, cfg)
    if scene.mesh is not None:
        return render_accum_mesh(scene, cfg)
    dev, flags = _check(scene, cfg, "render_accum")
    ftab, itab = pack_scene(scene)
    out = torch.empty((NUM_CH, cfg.height, cfg.width), dtype=_F32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rtvs_render_accum(*_common_args(scene, cfg, ftab, itab, out, flags), stream)
    _build.check(err, "rtvs_render_accum")
    render_accum.launches += 1
    return out


def render_accum_mesh(scene, cfg) -> torch.Tensor:
    """K1-mesh: render_accum for a scene with triangle meshes."""
    dev = scene.cam_pos.device
    if dev.type == "cpu":
        return render_accum_plain(scene, cfg)
    if scene.mesh is None:
        raise ValueError("render_accum_mesh: the scene has no mesh leaf")
    dev, flags = _check(scene, cfg, "render_accum_mesh")
    mesh = scene.mesh
    for n in ("plane", "n0", "n1", "n2", "edge1", "edge2", "inst"):
        leaf = getattr(mesh, n)
        if not leaf.is_contiguous():
            raise ValueError(f"render_accum_mesh: mesh.{n} is not contiguous")
    if mesh.inst.dtype != torch.int32 or mesh.plane.dtype != _F32:
        raise ValueError(f"render_accum_mesh: mesh dtypes {mesh.inst.dtype}, {mesh.plane.dtype}")
    ftab, itab = pack_scene(scene)
    node_box, node_link, inst_tbl = pack_mesh(mesh)
    out = torch.empty((NUM_CH, cfg.height, cfg.width), dtype=_F32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rtvs_render_accum_mesh(
            *_common_args(scene, cfg, ftab, itab, out, flags), node_box.data_ptr(),
            node_link.data_ptr(), mesh.plane.data_ptr(), mesh.n0.data_ptr(), mesh.n1.data_ptr(),
            mesh.n2.data_ptr(), mesh.edge1.data_ptr(), mesh.edge2.data_ptr(),
            mesh.inst.data_ptr(), inst_tbl.data_ptr(), mesh.num_nodes, mesh.num_tris,
            mesh.num_inst, stream)
    _build.check(err, "rtvs_render_accum_mesh")
    render_accum_mesh.launches += 1
    return out


render_accum.launches = 0
render_accum_mesh.launches = 0
