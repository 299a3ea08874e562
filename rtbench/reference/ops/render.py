"""Primary rays and the per-sample loop: the plain version of kernel K1,
and of the two-phase renderer's kernels K7 (phase A) and K8 (phase B).

Restates raytracevs_tpu/ops/render.py (``primary_rays`` and the sample scan
of ``render_rows``, RayGen.hlsl:48-172) and writes the megakernel's
32-plane accumulator layout (raytracevs_tpu/ops/pallas/megakernel.py:118-136),
so the CUDA kernel and this function return the same tensor.
"""
from __future__ import annotations

import torch

from .. import constants as C
from . import bvh, intersect, sampling, vec, wavefront

# Accumulator planes [NUM_CH, H, W] (megakernel.py:118-136)
CH_COLOR = 0  # 3
CH_PRIMARY = 3  # 3
CH_DIFFUSE = 6  # 3
CH_SPECULAR = 9  # 3
CH_HITDIST = 12
CH_BOUNCE = 13
CH_RAYS = 14
CH_PRIM_HIT = 15
CH_NORMAL = 16  # 3
CH_ROUGH = 19
CH_ALBEDO = 20  # 3
CH_METALLIC = 23
CH_TRANSMISSION = 24
CH_POS = 25  # 3
CH_SHADOW_VIS = 28
CH_SHADOW_PEN = 29
CH_SHADOW_DIST = 30
CH_OBJ_ID = 31  # type*65536+index as f32 (exact below 2**24); -1 = sky
NUM_CH = 32
# Phase A of the two-phase renderer adds the continuation its one iteration
# spawned (megakernel.py:139-142)
CH_SPAWN_VALID = 32
CH_SPAWN_O = 33  # 3
CH_SPAWN_D = 36  # 3
# ... and the primary ray's closest hit, which phase B takes instead of
# tracing the primary again: hit (1 or 0), t, object type, object index,
# triangle (the three as int32 bits), u, v
CH_HIT = 39  # 7
NUM_CH_HIT = 7
NUM_CH_A = 46
# Rows of the counts that the render kernels' counting build adds up
# (csrc/megakernel_count.cu) and that the plain versions here add up given
# counts= ([len(COUNT_ROWS), 4] int64): the mesh walks' rows
# (bvh.WALK_CLASSES: walks, node fetches, box tests, triangle tests; the
# plain threaded walk fetches and tests one node a step), then the DFS's:
# "dfs" = lane iterations, warp iterations x 32 (the kernels' alone: their
# ratio is the loop's SIMT share; the plain version leaves it 0), items
# capped at the depth limit, items killed by their throughput; "rays" =
# shade calls at depth 0, shade calls deeper, shadow rays, thickness rays
# (their sum is the CH_RAYS plane's); "hits" = shade calls that miss (the
# sky), that hit glass, that hit anything else, and the lights those last
# shade by their BRDF.
COUNT_ROWS = bvh.WALK_CLASSES + ("dfs", "rays", "hits")
# Phase B pads its lanes to a multiple of this, so PyTorch's CPU loops run
# every lane in their vector body: a lane's arithmetic then does not depend
# on where it sits (a scalar tail can round torch.pow differently)
LANE_PAD = 64


def primary_rays(scene, cfg, px, py, sample_index, tile) -> wavefront.RayState:
    """Primary ray per lane (RayGen.hlsl:107-172): blue-noise AA + thin-lens DoF."""
    n = px.shape[0]
    dev = px.device
    bn = sampling.sample_blue_noise(tile, px, py, scene.frame_index, sample_index)
    if cfg.samples_per_pixel > 1:
        off_x, off_y = bn[:, 0], bn[:, 1]
    else:
        off_x = off_y = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    pc_x = px.to(torch.float32) + off_x
    pc_y = py.to(torch.float32) + off_y
    ndc_x = vec.div_const(pc_x, float(cfg.width)) * 2.0 - 1.0
    ndc_y = -(vec.div_const(pc_y, float(cfg.height)) * 2.0 - 1.0)
    aspect = torch.tensor(cfg.aspect_ratio, dtype=torch.float32, device=dev)
    d = (scene.cam_forward[None, :]
         + scene.cam_right[None, :] * (ndc_x * scene.tan_half_fov * aspect)[:, None]
         + scene.cam_up[None, :] * (ndc_y * scene.tan_half_fov)[:, None])
    d = vec.normalize(d)
    origin = scene.cam_pos[None, :].expand(n, 3)

    # DoF thin lens (RayGen.hlsl:124-138)
    dof = scene.aperture_size > 0.001
    focus = scene.cam_pos[None, :] + d * scene.focus_distance
    r = torch.sqrt(bn[:, 2])
    theta = bn[:, 3] * 6.28318530718
    disk_x = r * torch.cos(theta) * scene.aperture_size
    disk_y = r * torch.sin(theta) * scene.aperture_size
    origin_dof = (scene.cam_pos[None, :] + scene.cam_right[None, :] * disk_x[:, None]
                  + scene.cam_up[None, :] * disk_y[:, None])
    d_dof = vec.normalize(focus - origin_dof)
    origin = torch.where(dof, origin_dof, origin)
    d = torch.where(dof, d_dof, d)

    return wavefront.empty_ray(n, dev)._replace(
        valid=torch.ones((n,), dtype=torch.bool, device=dev),
        origin=origin, direction=d,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev))


def counted(scene, counts):
    """(the scene whose mesh walks add to the walk rows of `counts`, the
    DFS rows of `counts`), or (scene, None) without counts."""
    if counts is None:
        return scene, None
    if counts.dtype != torch.int64 or tuple(counts.shape) != (len(COUNT_ROWS), 4):
        raise ValueError(f"counts {counts.dtype} {tuple(counts.shape)}, expected int64 "
                         f"({len(COUNT_ROWS)}, 4)")
    nw = len(bvh.WALK_CLASSES)
    if scene.mesh is not None:
        scene = scene._replace(mesh=scene.mesh._replace(walk_counts=counts[:nw]))
    return scene, counts[nw:]


def row_slab(cfg, row_start, num_rows):
    """(row_start, num_rows) of a row slab of the frame, the whole frame's
    rows without num_rows; raises ValueError outside the frame."""
    rows = cfg.height - row_start if num_rows is None else num_rows
    if not (0 <= row_start and 0 < rows and row_start + rows <= cfg.height):
        raise ValueError(f"rows [{row_start}, {row_start + rows}) outside a frame of "
                         f"{cfg.height}")
    return row_start, rows


def _slab_pixels(cfg, row_start, rows, dev):
    """(px, py) of the slab's pixels in row-major order, frame coordinates."""
    idx = torch.arange(cfg.width * rows, device=dev)
    return idx % cfg.width, row_start + idx // cfg.width


def _render_samples(scene, cfg, max_iters=None, counts=None, row_start=0, num_rows=None):
    """Every sample's DFS (up to `max_iters` iterations each), summed into
    the [NUM_CH, rows, width] accumulator planes of the slab of `num_rows`
    rows from `row_start` (the whole frame by default). Returns (planes,
    the last sample's current rays where its DFS stopped). counts: the DFS
    rows of COUNT_ROWS to add to."""
    dev = scene.cam_pos.device
    row_start, h = row_slab(cfg, row_start, num_rows)
    w = cfg.width
    n = w * h
    px, py = _slab_pixels(cfg, row_start, h, dev)
    tile = sampling.blue_noise_tile(dev)
    f32 = torch.float32
    zero3 = torch.zeros((n, 3), dtype=f32, device=dev)
    out = {
        "color": zero3, "primary": zero3, "diffuse": zero3, "specular": zero3,
        "hitdist": torch.zeros((n,), dtype=f32, device=dev),
        "bounce": torch.zeros((n,), dtype=f32, device=dev),
        "rays": torch.zeros((n,), dtype=f32, device=dev),
    }
    prim = None
    for s in range(cfg.samples_per_pixel):
        primary = primary_rays(scene, cfg, px, py, s, tile)
        prev_hit = prim["prim_hit"] if prim is not None else torch.zeros(
            (n,), dtype=torch.bool, device=dev)
        a, cur = wavefront.run_sample(scene, cfg, px, py, s, primary, prev_hit, max_iters,
                                      counts)
        for k in ("color", "primary", "diffuse", "specular", "hitdist"):
            out[k] = out[k] + a[k]
        out["bounce"] = out["bounce"] + a["bounce"].to(f32)
        out["rays"] = out["rays"] + a["rays"].to(f32)
        if prim is None:
            # SIGMA wants the RAW first-sample shadow record (RayGen.hlsl:95-105)
            prim = {k: a[k] for k in a if k.startswith(("prim_", "shadow_"))}
        else:
            new_hit = a["prim_hit"]  # run_sample already masked earlier hits
            for k in ("prim_normal", "prim_albedo", "prim_pos"):
                prim[k] = vec.where3(new_hit, a[k], prim[k])
            for k in ("prim_rough", "prim_metallic", "prim_transmission", "prim_obj_id"):
                prim[k] = torch.where(new_hit, a[k], prim[k])
            prim["prim_hit"] = prim["prim_hit"] | new_hit

    def plane(v):
        return v.reshape(h, w)

    def planes3(v):
        return v.T.reshape(3, h, w)

    chans = [
        planes3(out["color"]), planes3(out["primary"]), planes3(out["diffuse"]),
        planes3(out["specular"]), plane(out["hitdist"])[None], plane(out["bounce"])[None],
        plane(out["rays"])[None], plane(prim["prim_hit"].to(f32))[None],
        planes3(prim["prim_normal"]), plane(prim["prim_rough"])[None],
        planes3(prim["prim_albedo"]), plane(prim["prim_metallic"])[None],
        plane(prim["prim_transmission"])[None], planes3(prim["prim_pos"]),
        plane(prim["shadow_vis"])[None], plane(prim["shadow_pen"])[None],
        plane(prim["shadow_dist"])[None], plane(prim["prim_obj_id"].to(f32))[None],
    ]
    return torch.cat(chans, dim=0).contiguous(), cur


def render_accum(scene, cfg, counts=None, row_start=0, num_rows=None) -> torch.Tensor:
    """Render the frame: every sample's DFS, summed into the
    [NUM_CH, height, width] float32 accumulator planes
    (colour sums over samples, first-sample SIGMA shadow record, first-hit
    primary record). Given `num_rows`, the [NUM_CH, num_rows, width] planes
    of the row slab from `row_start` alone (JAX render_rows): the camera,
    the pixels' random keys and cfg.height stay the frame's. Runs on the
    device of the scene tensors. Given `counts`, adds its work to it
    (COUNT_ROWS)."""
    scene, dfs_counts = counted(scene, counts)
    return _render_samples(scene, cfg, counts=dfs_counts, row_start=row_start,
                           num_rows=num_rows)[0]


def _require_spp1(cfg, name):
    if cfg.samples_per_pixel != 1:
        raise ValueError(f"{name}: the two-phase renderer needs samples_per_pixel == 1, "
                         f"got {cfg.samples_per_pixel}")


def _primary_hit_planes(scene, cfg, row_start, rows):
    """[NUM_CH_HIT, rows*W] the primary ray's closest hit as iteration 0
    traces it (wavefront._hit_context) for the slab's pixels; no hit (t
    1e30, type INVALID) where the primary is not traced (max_bounces 0)."""
    dev = scene.cam_pos.device
    n = cfg.width * rows
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    zero_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    if cfg.max_bounces > 0:
        primary = primary_rays(scene, cfg, *_slab_pixels(cfg, row_start, rows, dev), 0,
                               sampling.blue_noise_tile(dev))
        h = wavefront._hit_context(scene, cfg, primary,
                                   torch.ones((n,), dtype=torch.bool, device=dev))[1]["hit"]
    else:
        h = intersect.Hit(hit=zero > 0.0, t=torch.full_like(zero, 1e30),
                          obj_type=torch.full_like(zero_i, intersect.INVALID), obj_index=zero_i,
                          mat_slot=zero_i)
    bits = torch.stack([h.obj_type, h.obj_index, zero_i if h.tri is None else h.tri])
    return torch.cat([h.hit.to(torch.float32)[None], h.t[None],
                      bits.to(torch.int32).view(torch.float32),
                      (zero if h.bary_u is None else h.bary_u)[None],
                      (zero if h.bary_v is None else h.bary_v)[None]])


def hit_from_planes(scene, planes):
    """The intersect.Hit of the lanes' primary rays from their CH_HIT
    planes ([NUM_CH_HIT, M]), as intersect.trace_closest returns it for
    those rays (no thickness query pending)."""
    m = planes.shape[1]
    dev = planes.device
    obj_type, obj_index, tri = planes[2:5].view(torch.int32).to(torch.int64)
    s, p, b = scene.sphere_capacity, scene.plane_capacity, scene.box_capacity
    slot = torch.where(obj_type == C.OBJECT_TYPE_SPHERE, obj_index, torch.where(
        obj_type == C.OBJECT_TYPE_PLANE, s + obj_index, torch.where(
            obj_type == C.OBJECT_TYPE_BOX, s + p + obj_index, torch.where(
                obj_type == C.OBJECT_TYPE_MESH, s + p + b + obj_index, 0))))
    mesh = {}
    if scene.mesh is not None:
        mesh = dict(tri=tri, bary_u=planes[5], bary_v=planes[6],
                    thick_hit=torch.zeros((m,), dtype=torch.bool, device=dev),
                    thick_t=torch.full((m,), 1e30, dtype=torch.float32, device=dev))
    return intersect.Hit(hit=planes[0] > 0.5, t=planes[1], obj_type=obj_type,
                         obj_index=obj_index, mat_slot=slot, **mesh)


def render_accum_phase_a(scene, cfg, counts=None, row_start=0, num_rows=None) -> torch.Tensor:
    """Phase A of the two-phase renderer, the plain version of kernel K7
    (raytracevs_tpu/ops/pallas/megakernel.py::make_kernel(phase_a=True)),
    spp 1: one DFS iteration per pixel (the primary ray traced and shaded,
    its depth-0 records, its children). Returns [NUM_CH_A, height, width]:
    the NUM_CH accumulator planes of that iteration, the continuation it
    spawned (valid, origin, direction; (0,0,0) and (0,0,1) where none),
    then the primary ray's closest hit (CH_HIT). Given `counts`, adds
    the iteration's work to it (COUNT_ROWS; the hit planes' own trace of
    the primaries is not counted). Given `num_rows`, the planes of the row
    slab from `row_start` alone, as render_accum's."""
    _require_spp1(cfg, "render_accum_phase_a")
    row_start, h = row_slab(cfg, row_start, num_rows)
    counted_scene, dfs_counts = counted(scene, counts)
    planes, cur = _render_samples(counted_scene, cfg, max_iters=1, counts=dfs_counts,
                                  row_start=row_start, num_rows=h)
    w = cfg.width
    spawn = torch.cat([cur.valid.to(torch.float32)[None], cur.origin.T, cur.direction.T])
    return torch.cat([planes, spawn.reshape(7, h, w),
                      _primary_hit_planes(scene, cfg, row_start, h).reshape(NUM_CH_HIT, h, w)],
                     dim=0).contiguous()


def render_accum_phase_b(scene, cfg, order, acc, hits, counts=None, row_start=0) -> torch.Tensor:
    """Phase B of the two-phase renderer, the plain version of kernel K8
    (megakernel.py::make_kernel_b), spp 1. Resumes each pixel listed in
    `order` ([M] row-major pixel ids whose phase A spawned a continuation,
    in any order): re-derives its iteration-0 state (the primary ray, its
    children without lighting from the closest hit phase A traced, `hits`
    [NUM_CH_HIT, height, width], the continuation and stack), runs the DFS
    from iteration 1, and folds the subtree into the phase-A planes `acc`
    ([NUM_CH, height, width], updated in place and returned): colour
    added, rays added, bounce the maximum. Nothing else changes: the
    records are depth-0 only and the primary ray is not counted again.
    Given `counts`, adds the resumed DFS's work to it (COUNT_ROWS). For a
    row slab from `row_start`, acc and hits are the slab's planes and the
    ids in `order` the slab's."""
    _require_spp1(cfg, "render_accum_phase_b")
    scene, dfs_counts = counted(scene, counts)
    dev = scene.cam_pos.device
    m = order.numel()
    n = -(-m // LANE_PAD) * LANE_PAD
    live = torch.arange(n, device=dev) < m
    pix = torch.cat([order.to(torch.int64), torch.zeros((n - m,), dtype=torch.int64, device=dev)])
    px = pix % cfg.width
    py = row_start + pix // cfg.width
    primary = primary_rays(scene, cfg, px, py, 0, sampling.blue_noise_tile(dev))
    primary = primary._replace(valid=live)
    # a fresh primary is never capped (max_bounces >= 1 where phase A
    # spawned) nor killed (throughput 1)
    hit = hit_from_planes(scene, hits.reshape(NUM_CH_HIT, -1)[:, pix])
    ch = wavefront.children_only(scene, cfg, px, py, 0, primary, live, hit)
    cur, stack = wavefront.advance(primary, ch, live, wavefront.empty_stack(n, dev))
    sub, _, _ = wavefront.dfs(scene, cfg, px, py, 0, cur, stack,
                              wavefront.new_accumulators(n, dev),
                              torch.zeros((n,), dtype=torch.bool, device=dev), 1,
                              cfg.max_queue_iters, dfs_counts)
    flat = acc.view(NUM_CH, -1)
    ids = pix[:m]
    flat[CH_COLOR:CH_COLOR + 3, ids] = flat[CH_COLOR:CH_COLOR + 3, ids] + sub["color"][:m].T
    flat[CH_RAYS, ids] = flat[CH_RAYS, ids] + sub["rays"][:m].to(torch.float32)
    flat[CH_BOUNCE, ids] = torch.maximum(flat[CH_BOUNCE, ids], sub["bounce"][:m].to(torch.float32))
    return acc
