"""Batched primitive intersection (rays x primitives).

Restates raytracevs_tpu/ops/intersect.py: the sphere quadratic, infinite
plane and OBB slab tests (src/Shader/Intersection.hlsl:17-198), the
closest-hit resolve, AnyHit_SkipSelf (AnyHit_SkipSelf.hlsl:6-28), shadow
transmission (AnyHit_Shadow.hlsl:10-57) and the same-object thickness query
(:91-108), with the triangle meshes' BVH walks (ops/bvh.py) merged in.

Rays are [N,3]/[N] tensors; the primitive axis is reduced here. The CUDA
megakernel (csrc/megakernel.cu) walks the same tables per thread with the
same arithmetic in the same order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import constants as C
from . import bvh, vec

_BIG = 1e30
_INF = 1e20  # Intersection.hlsl:102
_EPS = 1e-6
INVALID = C.OBJECT_TYPE_INVALID & 0x7FFFFFFF


def intersect_spheres(origin, direction, tmin, tmax, centers, radii, valid):
    """Sphere quadratic (Intersection.hlsl:17-52). Returns t [N,S] (1e30 = miss)."""
    oc = origin[:, None, :] - centers[None, :, :]
    a = vec.dot(direction, direction)[:, None]
    b = 2.0 * vec.dot(oc, direction[:, None, :])
    c = vec.dot(oc, oc) - (radii * radii)[None, :]
    disc = b * b - 4.0 * a * c
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sqrt_d) / (2.0 * a)
    t2 = (-b + sqrt_d) / (2.0 * a)
    t = torch.where(t1 < tmin[:, None], t2, t1)
    ok = (disc >= 0.0) & (t >= tmin[:, None]) & (t <= tmax[:, None]) & valid[None, :]
    return torch.where(ok, t, _BIG)


def intersect_planes(origin, direction, tmin, tmax, positions, normals, valid):
    """Infinite plane (Intersection.hlsl:53-77). Returns t [N,P]."""
    n = vec.normalize(normals)
    denom = vec.dot(direction[:, None, :], n[None, :, :])
    p0 = positions[None, :, :] - origin[:, None, :]
    big_denom = torch.abs(denom) > 1e-4
    t = vec.dot(p0, n[None, :, :]) / torch.where(big_denom, denom, 1.0)
    ok = big_denom & (t >= tmin[:, None]) & (t <= tmax[:, None]) & valid[None, :]
    return torch.where(ok, t, _BIG)


def intersect_boxes(origin, direction, tmin, tmax, centers, halves, axes, valid):
    """OBB slab method in local space (Intersection.hlsl:78-198).

    axes [B,3,3] rows = local X/Y/Z in world space. Returns (t [N,B], entering)."""
    delta = origin[:, None, :] - centers[None, :, :]  # [N,B,3]
    lo = vec.dot(delta[:, :, None, :], axes[None, :, :, :])  # [N,B,3]
    ld = vec.dot(direction[:, None, None, :], axes[None, :, :, :])
    h = halves[None, :, :]
    par = torch.abs(ld) < _EPS
    par_miss = par & ((lo < -h) | (lo > h))
    inv = 1.0 / torch.where(par, 1.0, ld)
    t0 = torch.where(par, -_INF, (-h - lo) * inv)
    t1 = torch.where(par, _INF, (h - lo) * inv)
    slab_min = torch.minimum(t0, t1)
    slab_max = torch.maximum(t0, t1)
    t_near = torch.amax(slab_min, dim=-1)
    t_far = torch.amin(slab_max, dim=-1)
    hit_any = (t_near <= t_far) & (t_far >= tmin[:, None]) & ~torch.any(par_miss, dim=-1)
    entering = t_near >= tmin[:, None]
    t = torch.where(entering, t_near, t_far)
    ok = hit_any & (t >= tmin[:, None]) & (t <= tmax[:, None]) & valid[None, :]
    return torch.where(ok, t, _BIG), entering


class Hit(NamedTuple):
    hit: torch.Tensor  # [N] bool
    t: torch.Tensor  # [N]
    obj_type: torch.Tensor  # [N] int64 (OBJECT_TYPE_*; INVALID on a miss)
    obj_index: torch.Tensor  # [N] int64, index within its type (mesh: instance)
    mat_slot: torch.Tensor  # [N] int64, row of the combined material table
    tri: Optional[torch.Tensor] = None  # [N] triangle index (mesh hits)
    bary_u: Optional[torch.Tensor] = None  # [N]
    bary_v: Optional[torch.Tensor] = None  # [N]
    thick_hit: Optional[torch.Tensor] = None  # [N] fused same-instance thickness found
    thick_t: Optional[torch.Tensor] = None  # [N] its distance


def _apply_skip(t, obj_type, skip_type, skip_index):
    """AnyHit_SkipSelf: drop the (type, index) the ray asks to skip."""
    idx = torch.arange(t.shape[1], device=t.device)[None, :]
    skip = (skip_type[:, None] == obj_type) & (skip_index[:, None] == idx)
    return torch.where(skip, _BIG, t)


def trace_closest(scene, origin, direction, tmin, tmax, skip_type=None, skip_index=None,
                  thick_inst=None, active=None, count_class=None) -> Hit:
    """Closest hit over spheres ++ planes ++ boxes (the global primitive
    order of the reference's procedural BLAS, so mat_slot = global index),
    then the mesh instances, whose material rows follow. Ties go to the
    first primitive in that order, and to an analytic hit over a triangle.
    thick_inst rides the mesh walk for deferred same-instance thickness
    (bvh.traverse_closest); the mesh is walked on `active` lanes only;
    count_class classes its lanes for the mesh's walk_counts."""
    n = origin.shape[0]
    dev = origin.device
    if skip_type is None:
        skip_type = torch.full((n,), INVALID, dtype=torch.int64, device=dev)
        skip_index = torch.zeros((n,), dtype=torch.int64, device=dev)
    s_cap, p_cap, b_cap = scene.sphere_capacity, scene.plane_capacity, scene.box_capacity
    parts = []
    if s_cap:
        ts = intersect_spheres(origin, direction, tmin, tmax, scene.sph_center,
                               scene.sph_radius, scene.sph_valid)
        parts.append(_apply_skip(ts, C.OBJECT_TYPE_SPHERE, skip_type, skip_index))
    if p_cap:
        tp = intersect_planes(origin, direction, tmin, tmax, scene.pln_position,
                              scene.pln_normal, scene.pln_valid)
        parts.append(_apply_skip(tp, C.OBJECT_TYPE_PLANE, skip_type, skip_index))
    if b_cap:
        tb, _ = intersect_boxes(origin, direction, tmin, tmax, scene.box_center,
                                scene.box_half, scene.box_axes, scene.box_valid)
        parts.append(_apply_skip(tb, C.OBJECT_TYPE_BOX, skip_type, skip_index))
    if parts:
        all_t = torch.cat(parts, dim=1)
        best = torch.argmin(all_t, dim=1)  # first minimum, like jnp.argmin
        t = torch.gather(all_t, 1, best[:, None])[:, 0]
    else:
        best = torch.zeros((n,), dtype=torch.int64, device=dev)
        t = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    hit = t < _BIG * 0.5
    is_plane = (best >= s_cap) & (best < s_cap + p_cap)
    is_box = best >= s_cap + p_cap
    obj_type = torch.where(is_box, C.OBJECT_TYPE_BOX,
                           torch.where(is_plane, C.OBJECT_TYPE_PLANE, C.OBJECT_TYPE_SPHERE))
    obj_type = torch.where(hit, obj_type, INVALID)
    obj_index = torch.where(is_box, best - s_cap - p_cap, torch.where(is_plane, best - s_cap, best))
    if scene.mesh is None:
        return Hit(hit=hit, t=t, obj_type=obj_type, obj_index=obj_index, mat_slot=best)
    mh = bvh.traverse_closest(scene.mesh, origin, direction, tmin, tmax,
                              skip_active=skip_type == C.OBJECT_TYPE_MESH, skip_inst=skip_index,
                              thick_inst=thick_inst, active=active, count_class=count_class)
    better = mh.hit & (mh.t < t)
    inst = mh.inst.to(torch.int64)
    return Hit(hit=hit | better, t=torch.where(better, mh.t, t),
               obj_type=torch.where(better, C.OBJECT_TYPE_MESH, obj_type),
               obj_index=torch.where(better, inst, obj_index),
               mat_slot=torch.where(better, s_cap + p_cap + b_cap + inst, best),
               tri=torch.where(better, mh.tri.to(torch.int64), 0),
               bary_u=torch.where(better, mh.u, 0.0), bary_v=torch.where(better, mh.v, 0.0),
               thick_hit=mh.thick_hit, thick_t=mh.thick_t)


def box_face_normal(hit_position, centers, halves, axes, index):
    """Box normal recomputed from the hit position (ClosestHit.hlsl:109-124)."""
    c = centers[index]
    h = torch.clamp(halves[index], min=1e-4)
    axn = vec.normalize(axes[index])  # [N,3,3], each row normalized
    local = vec.dot((hit_position - c)[:, None, :], axn)  # [N,3]
    scaled = torch.abs(local / h)
    sign = torch.where(local >= 0.0, 1.0, -1.0)
    x_wins = (scaled[:, 0] >= scaled[:, 1]) & (scaled[:, 0] >= scaled[:, 2])
    y_wins = ~x_wins & (scaled[:, 1] >= scaled[:, 2])
    ln = torch.stack([
        torch.where(x_wins, sign[:, 0], 0.0),
        torch.where(y_wins, sign[:, 1], 0.0),
        torch.where(~x_wins & ~y_wins, sign[:, 2], 0.0),
    ], dim=-1)
    world = (ln[:, 0:1] * axn[:, 0] + ln[:, 1:2] * axn[:, 1]) + ln[:, 2:3] * axn[:, 2]
    return vec.normalize(world)


def surface_normal(scene, hit: Hit, origin, direction):
    """(hit position, normal faced against the ray, front-face flag):
    the outward geometric normal flipped to face the ray
    (ClosestHit.hlsl:127-129); on a triangle the smooth normal, with the
    geometric normal deciding the face (ClosestHit_Triangle.hlsl:122-126)."""
    pos = origin + direction * hit.t[:, None]
    n = vec.const3(0.0, 1.0, 0.0, like=pos).expand_as(pos)
    if scene.sphere_capacity:
        sc = scene.sph_center[torch.clamp(hit.obj_index, 0, scene.sphere_capacity - 1)]
        n = vec.where3(hit.obj_type == C.OBJECT_TYPE_SPHERE, vec.normalize(pos - sc), n)
    if scene.plane_capacity:
        pn = scene.pln_normal[torch.clamp(hit.obj_index, 0, scene.plane_capacity - 1)]
        n = vec.where3(hit.obj_type == C.OBJECT_TYPE_PLANE, vec.normalize(pn), n)
    if scene.box_capacity:
        n_box = box_face_normal(pos, scene.box_center, scene.box_half, scene.box_axes,
                                torch.clamp(hit.obj_index, 0, scene.box_capacity - 1))
        n = vec.where3(hit.obj_type == C.OBJECT_TYPE_BOX, n_box, n)
    front_face = vec.dot(direction, n) < 0.0
    faced = vec.where3(front_face, n, -n)
    if scene.mesh is not None:
        is_mesh = hit.obj_type == C.OBJECT_TYPE_MESH
        smooth, front_geo = bvh.shading_normal(scene.mesh, bvh.TriHit(
            hit=is_mesh, t=hit.t, tri=hit.tri, u=hit.bary_u, v=hit.bary_v, inst=hit.obj_index),
            direction)
        faced = vec.where3(is_mesh, vec.where3(front_geo, smooth, -smooth), faced)
        front_face = torch.where(is_mesh, front_geo, front_face)
    return pos, faced, front_face


def trace_shadow(scene, origin, direction, max_dist, active=None):
    """Shadow transmission along a segment (AnyHit_Shadow.hlsl:10-57).

    An opaque (transmission < 0.01) hit blocks fully; translucent hits
    multiply their transmission into the visibility and a Beer-Lambert tint
    into the shadow colour, one intersection per primitive; then the mesh
    walk folds in every triangle crossed, seeded blocked where an opaque
    analytic hit already ended the search. The mesh is walked on `active`
    lanes only (the others keep the analytic result). Returns
    (visibility [N], shadow_color [N,3], occluder_distance [N])."""
    n = origin.shape[0]
    dev = origin.device
    tmin = torch.full((n,), C.RAY_TMIN, dtype=torch.float32, device=dev)
    parts = []
    if scene.sphere_capacity:
        parts.append(intersect_spheres(origin, direction, tmin, max_dist, scene.sph_center,
                                       scene.sph_radius, scene.sph_valid))
    if scene.plane_capacity:
        parts.append(intersect_planes(origin, direction, tmin, max_dist, scene.pln_position,
                                      scene.pln_normal, scene.pln_valid))
    if scene.box_capacity:
        parts.append(intersect_boxes(origin, direction, tmin, max_dist, scene.box_center,
                                     scene.box_half, scene.box_axes, scene.box_valid)[0])
    if not parts:
        vis = torch.ones((n,), dtype=torch.float32, device=dev)
        color = torch.ones((n, 3), dtype=torch.float32, device=dev)
        occ = torch.full((n,), C.NRD_FP16_MAX, dtype=torch.float32, device=dev)
        return _merge_mesh_shadow(scene, origin, direction, max_dist, vis, color, occ, None, active)
    all_t = torch.cat(parts, dim=1)
    hit_mask = all_t < _BIG * 0.5
    m = all_t.shape[1]
    transmission = scene.mat_transmission[None, :m]
    absorption = scene.mat_absorption[:m]
    blocked = torch.any(hit_mask & (transmission < 0.01), dim=1)
    translucent = hit_mask & (transmission >= 0.01)
    beer = torch.exp(-absorption * C.SHADOW_ABSORPTION_THICKNESS * scene.shadow_absorption_scale)
    beer = torch.where(torch.any(absorption > 0.0, dim=-1)[:, None], beer, 1.0)
    trans_f = torch.where(translucent, transmission, 1.0)
    beer_f = torch.where(translucent[..., None], beer[None], 1.0)
    # products in primitive order, as the kernel multiplies per hit
    vis = trans_f[:, 0]
    color = beer_f[:, 0]
    for k in range(1, m):
        vis = vis * trans_f[:, k]
        color = color * beer_f[:, k]
    vis = torch.where(blocked, 0.0, vis)
    color = vec.where3(blocked, torch.zeros_like(color), color)
    occluder = torch.amin(torch.where(hit_mask, all_t, C.NRD_FP16_MAX), dim=1)
    return _merge_mesh_shadow(scene, origin, direction, max_dist, vis, color, occluder, blocked,
                              active)


def _merge_mesh_shadow(scene, origin, direction, max_dist, vis, color, occluder, blocked, active):
    """Fold the mesh instances' shadow transmission into the analytic result."""
    if scene.mesh is None:
        return vis, color, occluder
    mvis, mcolor, mocc = bvh.traverse_shadow(scene.mesh, origin, direction, max_dist,
                                             blocked0=blocked, active=active)
    return vis * mvis, color * mcolor, torch.minimum(occluder, mocc)


def trace_thickness(scene, origin, direction, obj_type, obj_index):
    """Same-object thickness query (RayGen.hlsl:646-672, AnyHit_Thickness):
    the nearest intersection with the *same* sphere or box along the
    refraction direction, and for a mesh instance its thickness walk (the
    render passes no mesh lanes: it resolves mesh-glass thickness in the
    refract child's closest walk). Returns (hit [N] bool, t [N])."""
    n = origin.shape[0]
    dev = origin.device
    tmin = torch.full((n,), C.RAY_TMIN, dtype=torch.float32, device=dev)
    tmax = torch.full((n,), C.NRD_FP16_MAX, dtype=torch.float32, device=dev)
    t = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    if scene.sphere_capacity:
        ts = intersect_spheres(origin, direction, tmin, tmax, scene.sph_center,
                               scene.sph_radius, scene.sph_valid)
        idx = torch.clamp(obj_index, 0, ts.shape[1] - 1)
        t = torch.where(obj_type == C.OBJECT_TYPE_SPHERE,
                        torch.gather(ts, 1, idx[:, None])[:, 0], t)
    if scene.box_capacity:
        tb, _ = intersect_boxes(origin, direction, tmin, tmax, scene.box_center,
                                scene.box_half, scene.box_axes, scene.box_valid)
        idx = torch.clamp(obj_index, 0, tb.shape[1] - 1)
        t = torch.where(obj_type == C.OBJECT_TYPE_BOX,
                        torch.gather(tb, 1, idx[:, None])[:, 0], t)
    hit = (t < _BIG * 0.5) & ((obj_type == C.OBJECT_TYPE_SPHERE) | (obj_type == C.OBJECT_TYPE_BOX))
    t = torch.where(hit, t, C.NRD_FP16_MAX)
    if scene.mesh is not None:
        is_mesh = obj_type == C.OBJECT_TYPE_MESH
        mh, mt = bvh.traverse_thickness(scene.mesh, origin, direction, obj_index, active=is_mesh)
        hit = torch.where(is_mesh, mh, hit)
        t = torch.where(is_mesh, mt, t)
    return hit, t
