"""The per-pixel DFS render core, vectorised over pixels: the plain PyTorch
version of the CUDA megakernel (csrc/megakernel.cu).

Restates raytracevs_tpu/ops/wavefront.py (itself the reference's RayGen
work-queue loop, src/Shader/RayGen.hlsl:48-1045) for analytic scenes. Per
lane a "current ray" register file holds the WorkItem being traced and an
8-deep LIFO stack holds deferred siblings; each iteration traces and shades
the current item of every lane, records the depth-0 NRD payload, and picks
the continuation (refract > unpushed reflect > metal > pop). The loop ends
when every lane's stack is empty or at cfg.max_queue_iters.

Radiance accumulation, budgets, the throughput kill, sky fallbacks, NaN
guards, child throughput rules and the RNG stream follow the JAX package
operation for operation, so the two agree to float rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from . import intersect, sampling, shade, vec

STACK_DEPTH = C.WORK_QUEUE_STRIDE
_INVALID = intersect.INVALID
_M32 = 0xFFFFFFFF


class RayState(NamedTuple):
    """Live WorkItem fields (Common.hlsli:194-212) as lane tensors."""

    valid: torch.Tensor  # [N] bool
    origin: torch.Tensor  # [N,3]
    direction: torch.Tensor  # [N,3]
    depth: torch.Tensor  # [N] int64
    throughput: torch.Tensor  # [N,3]
    flags: torch.Tensor  # [N] int64 PATH_FLAG_*
    sky_boost: torch.Tensor  # [N]
    ray_flags: torch.Tensor  # [N] int64 RAYFLAG_*
    skip_type: torch.Tensor  # [N] int64
    skip_index: torch.Tensor  # [N] int64


def empty_ray(n, device) -> RayState:
    f32, i64 = torch.float32, torch.int64
    return RayState(
        valid=torch.zeros((n,), dtype=torch.bool, device=device),
        origin=torch.zeros((n, 3), dtype=f32, device=device),
        direction=vec.const3(0.0, 0.0, 1.0, like=torch.empty(0, device=device)).expand(n, 3),
        depth=torch.zeros((n,), dtype=i64, device=device),
        throughput=torch.zeros((n, 3), dtype=f32, device=device),
        flags=torch.zeros((n,), dtype=i64, device=device),
        sky_boost=torch.ones((n,), dtype=f32, device=device),
        ray_flags=torch.zeros((n,), dtype=i64, device=device),
        skip_type=torch.full((n,), _INVALID, dtype=i64, device=device),
        skip_index=torch.zeros((n,), dtype=i64, device=device),
    )


def _pack_f(r: RayState):
    return torch.cat([r.origin, r.direction, r.throughput, r.sky_boost[:, None]], dim=-1)


def _pack_i(r: RayState):
    return torch.stack([r.depth, r.flags, r.ray_flags, r.skip_type, r.skip_index], dim=-1)


def _select(mask, a: RayState, b: RayState) -> RayState:
    """Per lane: a where mask else b (valid included)."""
    out = []
    for fa, fb in zip(a, b):
        m = mask[:, None] if fa.dim() == 2 else mask
        out.append(torch.where(m, fa, fb))
    return RayState(*out)


def _reflect(i, n):
    return i - (2.0 * vec.dot(i, n))[:, None] * n


def _refract(i, n, eta):
    """HLSL refract(): returns (dir, tir_mask)."""
    cosi = vec.dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    kk = torch.sqrt(torch.clamp(k, min=0.0))
    r = eta[:, None] * i - (eta * cosi + kk)[:, None] * n
    return vec.where3(tir, torch.zeros_like(r), r), tir


def _light_geom(scene, pos, nrm, lt, lpos):
    """(l_vec, atten, ndotl) toward light type lt at lpos ([N] or scalar)."""
    is_dir = lt == C.LIGHT_TYPE_DIRECTIONAL
    to_l = lpos - pos
    dist = vec.length(to_l)
    ldn = lpos / torch.clamp(vec.length(lpos), min=1e-12)[..., None]
    lane_dir = is_dir[:, None] if is_dir.dim() else is_dir
    l_vec = torch.where(lane_dir, -ldn, to_l / torch.clamp(dist, min=1e-12)[:, None])
    atten = torch.where(is_dir, 1.0, shade.compute_attenuation(
        dist, scene.atten_const, scene.atten_linear, scene.atten_quadratic))
    ndotl = torch.clamp(vec.dot(nrm, l_vec), min=0.0)
    return l_vec, atten, ndotl


def _brdf_terms(nrm, view, l_vec, ndotl, f0, roughness, metallic, diffuse_color):
    """(diffuse BRDF, specular BRDF) of the RayGen lighting loop."""
    half = vec.normalize(view + l_vec)
    ndotv = torch.clamp(vec.dot(nrm, view), min=0.001)
    ndoth = torch.clamp(vec.dot(nrm, half), min=0.0)
    vdoth = torch.clamp(vec.dot(view, half), min=0.0)
    fr = shade.fresnel_schlick3(vdoth, f0)
    d = shade.ggx_d(ndoth, torch.clamp(roughness, min=0.04))
    g = shade.smith_g(ndotv, ndotl, roughness)
    spec_brdf = (d * g)[:, None] * fr / (4.0 * ndotv * ndotl + 0.001)[:, None]
    kd = (1.0 - fr) * (1.0 - metallic)[:, None]
    diff_brdf = vec.div_const(kd * diffuse_color, C.PI)
    return diff_brdf, spec_brdf


def shade_and_spawn(scene, cfg, px, py, sample_index, state: RayState, traced):
    """Trace + shade one WorkItem per lane (RayGen.hlsl:174-848).
    Returns (color, records, children, extra_rays)."""
    n = px.shape[0]
    dev = px.device
    f32 = torch.float32
    zeros3 = torch.zeros((n, 3), dtype=f32, device=dev)
    ones3 = torch.ones((n, 3), dtype=f32, device=dev)
    tmin = torch.full((n,), C.RAY_TMIN, dtype=f32, device=dev)
    tmax = torch.full((n,), C.RAY_TMAX, dtype=f32, device=dev)
    skip_self = (state.ray_flags & C.RAYFLAG_SKIP_SELF) != 0
    skip_t = torch.where(skip_self, state.skip_type, _INVALID)
    skip_i = torch.where(skip_self, state.skip_index, 0)
    hit = intersect.trace_closest(scene, state.origin, state.direction, tmin, tmax, skip_t, skip_i)
    hit_mask = hit.hit & traced
    pos, nrm, front_face = intersect.surface_normal(scene, hit, state.origin, state.direction)

    # Material fetch (ClosestHit.hlsl:54-125)
    slot = hit.mat_slot
    albedo = scene.mat_color[slot][:, :3]
    metallic = scene.mat_metallic[slot]
    roughness = scene.mat_roughness[slot]
    transmission = scene.mat_transmission[slot]
    ior = scene.mat_ior[slot]
    specular = scene.mat_specular[slot]
    emission = scene.mat_emission[slot]
    absorption = scene.mat_absorption[slot]
    if scene.plane_capacity > 0:
        is_plane = hit.obj_type == C.OBJECT_TYPE_PLANE
        checker = shade.checker_albedo(albedo, pos, scene.cam_pos[None, :],
                                       scene.cam_forward[None, :])
        albedo = vec.where3(is_plane, checker, albedo)
        transmission = torch.where(is_plane, 0.0, transmission)
        ior = torch.where(is_plane, 1.5, ior)

    view = -state.direction
    is_glass = transmission > 0.01
    l_cap = scene.light_capacity

    # ---- Glass: specular highlights only (RayGen.hlsl:283-334) ----------
    f0_from_ior = torch.square((ior - 1.0) / (ior + 1.0))
    spec_blend = torch.clamp(specular, 0.0, 1.0)
    f0_glass = f0_from_ior + (spec_blend - f0_from_ior) * spec_blend
    highlight = zeros3
    if cfg.any_glass and cfg.has_lights:
        for li in range(l_cap):
            lv = (li < scene.num_lights) & scene.lt_valid[li]
            lt = scene.lt_type[li]
            non_ambient = lv & (lt != C.LIGHT_TYPE_AMBIENT)
            l_vec, atten, ndotl = _light_geom(scene, pos, nrm, lt, scene.lt_position[li][None, :])
            half = vec.normalize(l_vec + view)
            shininess = torch.clamp(512.0 * (1.0 - roughness), min=64.0)
            spec = torch.pow(torch.clamp(vec.dot(nrm, half), min=0.0), shininess)
            sf = shade.fresnel_schlick(torch.clamp(vec.dot(half, view), min=0.0), f0_glass)
            contrib = scene.lt_color[li][None, :3] * (
                scene.lt_intensity[li] * spec * sf * atten)[:, None]
            highlight = highlight + torch.where((non_ambient & (ndotl > 0.0))[:, None], contrib, 0.0)
        highlight = highlight * (spec_blend * (1.0 - roughness))[:, None]
        highlight = torch.where((specular > 0.01)[:, None], highlight, 0.0)
    glass_color = highlight + emission

    # ---- Non-glass: PBR direct lighting (RayGen.hlsl:336-539) -----------
    f0 = 0.04 + (albedo - 0.04) * metallic[:, None]
    diffuse_color = albedo * (1.0 - metallic)[:, None]
    sample_idx_rng = (sampling.u32(sample_index, dev) + state.depth * 4096) & _M32
    seed = sampling.rng_init(px, py, scene.frame_index, sample_idx_rng, C.RNG_SALT_SHADOW)
    shade_mask = hit_mask & ~is_glass

    ambient = zeros3
    direct_diffuse = zeros3
    direct_specular = zeros3
    best_vis = torch.ones((n,), dtype=f32, device=dev)
    best_pen = torch.zeros((n,), dtype=f32, device=dev)
    best_dist = torch.full((n,), C.NRD_FP16_MAX, dtype=f32, device=dev)
    ray_count = torch.zeros((n,), dtype=torch.int64, device=dev)

    if cfg.has_lights:
        top0_i, top0_c, top1_i, top1_c, top_count = shade.select_dominant_lights(scene, pos, nrm)
        sel0 = (top_count > 0) & (top0_c > 0.0)
        sel1 = (top_count > 1) & (top1_c > 0.0)
        # shadow rays for the (<=2) dominant lights, in light-index order to
        # keep the reference's sequential RNG stream
        a_idx = torch.where(sel0 & sel1, torch.minimum(top0_i, top1_i),
                            torch.where(sel0, top0_i, top1_i))
        b_idx = torch.where(sel0 & sel1, torch.maximum(top0_i, top1_i), a_idx)
        a_sel = sel0 | sel1
        b_sel = sel0 & sel1
        results = []
        for idx, selm in ((a_idx, a_sel), (b_idx, b_sel)):
            lt = scene.lt_type[idx]
            lpos = scene.lt_position[idx]
            _, _, ndotl = _light_geom(scene, pos, nrm, lt, lpos)
            samples = shade.compute_shadow_samples(scene.lt_samples[idx], top0_i, top0_c,
                                                   top1_i, top1_c, idx)
            active = shade_mask & selm & (ndotl > 0.0)
            seed, res = shade.calculate_soft_shadow(
                scene, pos, nrm, active, lt, lpos, scene.lt_radius[idx],
                samples.to(f32), seed, max_samples=cfg.max_soft_samples)
            results.append(res)
            ray_count = ray_count + torch.where(active, res.rays, 0)
        res_a, res_b = results

        best_w = torch.full((n,), -1.0, dtype=f32, device=dev)
        for li in range(l_cap):
            lv = (li < scene.num_lights) & scene.lt_valid[li]
            lt = scene.lt_type[li]
            l_vec, atten, ndotl = _light_geom(scene, pos, nrm, lt, scene.lt_position[li][None, :])
            is_ambient = lt == C.LIGHT_TYPE_AMBIENT
            lcol = scene.lt_color[li][None, :3]
            lint = scene.lt_intensity[li]
            amb = lcol * lint * (diffuse_color + (albedo * 0.3 - diffuse_color) * metallic[:, None])
            ambient = ambient + torch.where(lv & is_ambient, 1.0, 0.0) * amb

            lit = lv & ~is_ambient & (ndotl > 0.0)
            use_a = (a_idx == li) & a_sel
            use_b = (b_idx == li) & b_sel
            vis = torch.where(use_a, res_a.visibility, torch.where(use_b, res_b.visibility, 1.0))
            pen = torch.where(use_a, res_a.penumbra, torch.where(use_b, res_b.penumbra, 0.0))
            occ = torch.where(use_a, res_a.occluder_distance,
                              torch.where(use_b, res_b.occluder_distance, C.NRD_FP16_MAX))
            scol = vec.where3(use_a, res_a.shadow_color,
                              vec.where3(use_b, res_b.shadow_color, ones3))
            # depth-0 best shadow for SIGMA (RayGen.hlsl:415-423)
            w = ndotl * atten * lint
            better = lit & (state.depth == 0) & (w > best_w)
            best_w = torch.where(better, w, best_w)
            best_vis = torch.where(better, vis, best_vis)
            best_pen = torch.where(better, pen, best_pen)
            best_dist = torch.where(better, occ, best_dist)

            adj_vis = 1.0 - torch.clamp((1.0 - vis) * scene.shadow_strength, 0.0, 1.0)
            radiance = lcol * (lint * atten * adj_vis)[:, None] * scol
            diff_brdf, spec_brdf = _brdf_terms(nrm, view, l_vec, ndotl, f0, roughness,
                                               metallic, diffuse_color)
            m = lit[:, None]
            direct_diffuse = direct_diffuse + torch.where(m, diff_brdf * radiance * ndotl[:, None], 0.0)
            direct_specular = direct_specular + torch.where(m, spec_brdf * radiance * ndotl[:, None], 0.0)
    else:
        # No-light fallback (RayGen.hlsl:452-501): legacy point light + flat
        # ambient, only at depth 0.
        fb_pos = vec.const3(3.0, 5.0, -3.0, like=pos)
        fb_needed = state.depth == 0
        to_l = fb_pos[None, :] - pos
        fb_dist = vec.length(to_l)
        fb_l = to_l / torch.clamp(fb_dist, min=1e-12)[:, None]
        fb_atten = shade.compute_attenuation(fb_dist, scene.atten_const, scene.atten_linear,
                                             scene.atten_quadratic)
        fb_ndotl = torch.clamp(vec.dot(nrm, fb_l), min=0.0)
        fb_active = shade_mask & fb_needed
        fb_vis, fb_scol, fb_occ = intersect.trace_shadow(
            scene, pos + nrm * C.SHADOW_NORMAL_OFFSET, fb_l, fb_dist)
        ray_count = ray_count + fb_active.to(torch.int64)
        fb_amount = torch.clamp((1.0 - fb_vis) * scene.shadow_strength, 0.0, 1.0)
        fb_radiance = (1.5 * fb_atten * (1.0 - fb_amount))[:, None] * fb_scol
        fb_diff, fb_spec = _brdf_terms(nrm, view, fb_l, fb_ndotl, f0, roughness, metallic,
                                       diffuse_color)
        fb_lit = ((fb_ndotl > 0.0) & fb_needed)[:, None]
        direct_diffuse = torch.where(fb_lit, fb_diff * fb_radiance * fb_ndotl[:, None], 0.0)
        direct_specular = torch.where(fb_lit, fb_spec * fb_radiance * fb_ndotl[:, None], 0.0)
        fb_amb = (diffuse_color + (albedo * 0.3 - diffuse_color) * metallic[:, None]) * 0.2
        ambient = vec.where3(fb_needed, fb_amb, ambient)
        best_vis = torch.where(fb_needed, fb_vis, best_vis)
        best_dist = torch.where(fb_needed, torch.where(fb_vis < 0.99, fb_occ, C.NRD_FP16_MAX),
                                best_dist)

    reflection_weight = metallic * (1.0 - roughness * 0.5)
    direct_weight = 1.0 - reflection_weight * 0.5
    diff_lit = ambient + direct_diffuse * direct_weight[:, None]
    final = torch.clamp(diff_lit + direct_specular + emission, min=0.0)
    color = vec.where3(is_glass, glass_color, final)
    # Miss: sky * pathSkyBoost (Miss.hlsl:4-16)
    sky = shade.sky_color(state.direction)
    color = vec.where3(hit_mask, color, sky * state.sky_boost[:, None])
    # NaN/Inf guard (RayGen.hlsl:250-260)
    bad = ~torch.all(torch.isfinite(color), dim=-1)
    color = vec.where3(bad, state.throughput * sky, color)

    # Depth-0 NRD payload fields (RayGen.hlsl:328-334, 531-538; Miss.hlsl:12-17)
    diff_rad = vec.where3(is_glass, zeros3, diff_lit + emission)
    diff_rad = vec.where3(hit_mask, diff_rad, sky * state.sky_boost[:, None])
    spec_rad = vec.where3(is_glass, highlight, direct_specular)
    spec_rad = vec.where3(hit_mask, spec_rad, zeros3)
    lit_rec = hit_mask & ~is_glass
    records = {
        "color": color,
        "diffuse": diff_rad,
        "specular": spec_rad,
        "hit_distance": torch.where(hit_mask, hit.t, 10000.0),
        "shadow_vis": torch.where(lit_rec, best_vis, 1.0),
        "shadow_pen": torch.where(lit_rec, best_pen, 0.0),
        "shadow_dist": torch.where(lit_rec, best_dist, C.NRD_FP16_MAX),
        "hit_mask": hit_mask,
        "normal": nrm,
        "roughness": roughness,
        "albedo": albedo,
        "metallic": metallic,
        "transmission": transmission,
        "position": pos,
        "obj_id": torch.where(hit_mask, hit.obj_type * 65536 + hit.obj_index, -1),
    }

    # ---- Children (RayGen.hlsl:591-847) ----------------------------------
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    entering = front_face
    glass_spawn, tir = no, no
    g_reflect = g_refract = reflect_tp = refract_tp = zeros3
    refraction_absorb = ones3
    if cfg.any_glass:
        eta = torch.where(entering, 1.0 / ior, ior)
        reflect_dir0 = vec.normalize(_reflect(state.direction, nrm))
        refract_dir, tir = _refract(state.direction, nrm, eta)
        refract_dir = vec.where3(tir, refract_dir, vec.normalize(refract_dir))
        # roughness perturbation at depth 0 (RayGen.hlsl:613-623)
        rng_reflect = sampling.rng_init(px, py, scene.frame_index, sample_idx_rng,
                                        C.RNG_SALT_REFLECT)
        _, pert_reflect = sampling.perturb_reflection(reflect_dir0, nrm, roughness, rng_reflect)
        rng_refract = sampling.rng_init(px, py, scene.frame_index, sample_idx_rng,
                                        C.RNG_SALT_REFRACT)
        _, pert_refract = sampling.perturb_reflection(refract_dir, -nrm, roughness, rng_refract)
        glass_perturb = (roughness > 0.01) & (state.depth == 0)
        g_reflect = vec.where3(glass_perturb, pert_reflect, reflect_dir0)
        g_refract = vec.where3(glass_perturb & ~tir, pert_refract, refract_dir)

        cos_theta = torch.clamp(vec.dot(-state.direction, nrm), 0.0, 1.0)
        fresnel = torch.where(tir, 1.0, shade.fresnel_schlick(cos_theta, f0_glass))
        reflect_tp = torch.clamp(fresnel, 0.0, 1.0)[:, None].expand(n, 3)
        tint = vec.where3(entering, 1.0 + (albedo - 1.0) * C.GLASS_TINT_STRENGTH, ones3)
        refract_tp = torch.clamp(
            (1.0 - fresnel)[:, None] * torch.clamp(transmission, 0.0, 1.0)[:, None] * tint, 0.0, 1.0)
        glass_spawn = hit_mask & is_glass
        if cfg.any_absorption:
            # thickness ray for Beer-Lambert absorption (RayGen.hlsl:646-678)
            th_origin = pos + g_refract * C.SELF_OFFSET
            do_thickness = glass_spawn & ~tir
            th_hit, th_t = intersect.trace_thickness(scene, th_origin, g_refract,
                                                     hit.obj_type, hit.obj_index)
            ray_count = ray_count + do_thickness.to(torch.int64)
            thickness = torch.where(do_thickness & th_hit, th_t, 0.0)
            refraction_absorb = vec.where3(
                ~tir & (thickness > 0.0),
                torch.exp(-absorption * (thickness * C.GLASS_ABSORPTION_SCALE)[:, None]), ones3)

    metal_spawn = no
    metal_dir = metal_tp = zeros3
    if cfg.any_metal:
        # metal child (RayGen.hlsl:806-846)
        is_metal = ~is_glass & (metallic > 0.1)
        rng_metal = sampling.rng_init(px, py, scene.frame_index, sample_idx_rng,
                                      C.RNG_SALT_REFLECT)
        _, metal_dir = sampling.perturb_reflection(_reflect(state.direction, nrm), nrm,
                                                   roughness, rng_metal)
        ndotv_m = torch.clamp(vec.dot(nrm, -state.direction), 0.0, 1.0)
        f_metal = shade.fresnel_schlick3(ndotv_m, f0)
        reflect_scale = 1.0 - roughness * 0.5
        boost = torch.where(state.depth > 0, C.METAL_SECONDARY_BOOST, 1.0)
        metal_tp = f_metal * (reflect_scale * boost)[:, None] * state.throughput
        metal_spawn = hit_mask & is_metal

    children = {
        "glass_spawn": glass_spawn,
        "metal_spawn": metal_spawn,
        "tir": tir,
        "entering": entering,
        "reflect_dir": g_reflect,
        "refract_dir": g_refract,
        "metal_dir": metal_dir,
        "reflect_tp": reflect_tp * state.throughput,
        "refract_tp": refract_tp * refraction_absorb * state.throughput,
        "metal_tp": metal_tp,
        "hit_pos": pos,
        "normal": nrm,
        "hit_obj_type": hit.obj_type,
        "hit_obj_index": hit.obj_index,
    }
    return color, records, children, ray_count


def run_sample(scene, cfg, px, py, sample_index, primary: RayState, prev_prim_hit):
    """Run the full DFS for one sample; returns a dict of lane accumulators."""
    n = px.shape[0]
    dev = px.device
    f32, i64 = torch.float32, torch.int64

    def full(v, dt=i64):
        return torch.full((n,), v, dtype=dt, device=dev)

    zero3 = torch.zeros((n, 3), dtype=f32, device=dev)
    acc = {
        "color": zero3, "primary": zero3, "diffuse": zero3, "specular": zero3,
        "hitdist": torch.zeros((n,), dtype=f32, device=dev),
        "bounce": torch.zeros((n,), dtype=i64, device=dev),
        "rays": torch.zeros((n,), dtype=i64, device=dev),
        "shadow_vis": torch.ones((n,), dtype=f32, device=dev),
        "shadow_pen": torch.zeros((n,), dtype=f32, device=dev),
        "shadow_dist": torch.full((n,), C.NRD_FP16_MAX, dtype=f32, device=dev),
        "prim_hit": torch.zeros((n,), dtype=torch.bool, device=dev),
        "prim_normal": vec.const3(0.0, 1.0, 0.0, like=zero3).expand(n, 3),
        "prim_rough": torch.ones((n,), dtype=f32, device=dev),
        "prim_albedo": zero3,
        "prim_metallic": torch.zeros((n,), dtype=f32, device=dev),
        "prim_transmission": torch.zeros((n,), dtype=f32, device=dev),
        "prim_pos": zero3,
        "prim_obj_id": torch.full((n,), -1, dtype=i64, device=dev),
    }
    stack_f = torch.zeros((n, STACK_DEPTH, 10), dtype=f32, device=dev)
    stack_i = torch.zeros((n, STACK_DEPTH, 5), dtype=i64, device=dev)
    count = torch.zeros((n,), dtype=i64, device=dev)
    slots = torch.arange(STACK_DEPTH, device=dev)[None, :]
    cur = primary
    it = 0
    while it < cfg.max_queue_iters and bool(torch.any(cur.valid | (count > 0))):
        it += 1
        active = cur.valid
        acc["bounce"] = torch.maximum(acc["bounce"], torch.where(active, cur.depth + 1, 0))
        # depth cap -> sky fallback without boost (RayGen.hlsl:184-193)
        capped = active & (cur.depth >= cfg.max_bounces)
        cap_contrib = cur.throughput * shade.sky_color(cur.direction)
        acc["color"] = acc["color"] + torch.where(capped[:, None], cap_contrib, 0.0)
        acc["primary"] = acc["primary"] + torch.where(
            (capped & (cur.depth == 0))[:, None], cap_contrib, 0.0)
        # throughput kill (RayGen.hlsl:195-199)
        killed = (active & ~capped & (torch.amax(cur.throughput, dim=-1) < C.THROUGHPUT_THRESHOLD)
                  & ((cur.flags & C.PATH_FLAG_SPECULAR) == 0))
        traced = active & ~capped & ~killed

        color, rec, ch, extra_rays = shade_and_spawn(scene, cfg, px, py, sample_index, cur, traced)
        acc["rays"] = acc["rays"] + traced.to(i64) + torch.where(traced, extra_rays, 0)
        contrib = cur.throughput * color
        acc["color"] = acc["color"] + torch.where(traced[:, None], contrib, 0.0)
        acc["primary"] = acc["primary"] + torch.where(
            (traced & (cur.depth == 0))[:, None], contrib, 0.0)

        # depth-0 records (RayGen.hlsl:560-589)
        rec_now = traced & (cur.depth == 0)
        acc["diffuse"] = acc["diffuse"] + torch.where(rec_now[:, None], rec["diffuse"], 0.0)
        acc["specular"] = acc["specular"] + torch.where(rec_now[:, None], rec["specular"], 0.0)
        acc["hitdist"] = acc["hitdist"] + torch.where(rec_now, rec["hit_distance"], 0.0)
        for k in ("shadow_vis", "shadow_pen", "shadow_dist"):
            acc[k] = torch.where(rec_now, rec[k], acc[k])
        first_hit = rec_now & rec["hit_mask"] & ~prev_prim_hit & ~acc["prim_hit"]
        for k, rk in (("prim_normal", "normal"), ("prim_albedo", "albedo"),
                      ("prim_pos", "position")):
            acc[k] = vec.where3(first_hit, rec[rk], acc[k])
        for k, rk in (("prim_rough", "roughness"), ("prim_metallic", "metallic"),
                      ("prim_transmission", "transmission"), ("prim_obj_id", "obj_id")):
            acc[k] = torch.where(first_hit, rec[rk], acc[k])
        acc["prim_hit"] = acc["prim_hit"] | first_hit

        # ---- continuation / stack update (RayGen.hlsl:697-846) ----------
        glass_spawn = ch["glass_spawn"] & traced
        metal_spawn = ch["metal_spawn"] & traced
        push_reflect = glass_spawn & (count < STACK_DEPTH)
        refract_ok = glass_spawn & ~ch["tir"] & (count + push_reflect.to(i64) < STACK_DEPTH)
        stack_write = push_reflect & refract_ok

        next_depth = cur.depth + 1
        spec_flags = cur.flags | C.PATH_FLAG_SPECULAR
        reflect_child = RayState(
            valid=push_reflect,
            origin=ch["hit_pos"] + ch["normal"] * C.SELF_OFFSET,
            direction=ch["reflect_dir"], depth=next_depth, throughput=ch["reflect_tp"],
            flags=spec_flags, sky_boost=full(C.SKY_BOOST_GLASS, f32),
            ray_flags=full(C.RAYFLAG_SKIP_SELF),
            skip_type=ch["hit_obj_type"], skip_index=ch["hit_obj_index"])
        # push the reflect child only when refract becomes the continuation
        onehot = ((slots == torch.clamp(count, 0, STACK_DEPTH - 1)[:, None])
                  & stack_write[:, None])[..., None]
        stack_f = torch.where(onehot, _pack_f(reflect_child)[:, None, :], stack_f)
        stack_i = torch.where(onehot, _pack_i(reflect_child)[:, None, :], stack_i)
        count = count + stack_write.to(i64)

        refract_child = RayState(
            valid=refract_ok,
            origin=ch["hit_pos"] + ch["refract_dir"] * C.SELF_OFFSET,
            direction=ch["refract_dir"], depth=next_depth, throughput=ch["refract_tp"],
            flags=torch.where(ch["entering"], spec_flags | C.PATH_FLAG_INSIDE,
                              spec_flags & ~C.PATH_FLAG_INSIDE),
            sky_boost=full(C.SKY_BOOST_GLASS, f32), ray_flags=full(0),
            skip_type=full(_INVALID), skip_index=full(0))
        metal_inside = (spec_flags & C.PATH_FLAG_INSIDE) != 0
        metal_child = RayState(
            valid=metal_spawn,
            origin=ch["hit_pos"] + ch["normal"] * C.SELF_OFFSET,
            direction=ch["metal_dir"], depth=next_depth, throughput=ch["metal_tp"],
            flags=spec_flags, sky_boost=full(C.SKY_BOOST_METAL, f32),
            ray_flags=torch.where(metal_inside, 0, C.RAYFLAG_SKIP_SELF),
            skip_type=torch.where(metal_inside, _INVALID, ch["hit_obj_type"]),
            skip_index=torch.where(metal_inside, 0, ch["hit_obj_index"]))

        # continuation: refract > reflect (unpushed) > metal > pop
        cont_reflect = push_reflect & ~refract_ok
        has_cont = refract_ok | cont_reflect | metal_spawn
        cont = _select(metal_spawn, metal_child, empty_ray(n, dev))
        cont = _select(cont_reflect, reflect_child, cont)
        cont = _select(refract_ok, refract_child, cont)
        cont = cont._replace(valid=has_cont)

        # terminal lanes pop the deferred sibling
        popped = ~has_cont & (count > 0)
        pslot = torch.clamp(count - 1, 0, STACK_DEPTH - 1)
        fv = torch.gather(stack_f, 1, pslot[:, None, None].expand(n, 1, 10))[:, 0]
        iv = torch.gather(stack_i, 1, pslot[:, None, None].expand(n, 1, 5))[:, 0]
        count = count - popped.to(i64)
        popped_ray = RayState(
            valid=popped, origin=fv[:, 0:3], direction=fv[:, 3:6], depth=iv[:, 0],
            throughput=fv[:, 6:9], flags=iv[:, 1], sky_boost=fv[:, 9], ray_flags=iv[:, 2],
            skip_type=iv[:, 3], skip_index=iv[:, 4])
        cur = _select(popped, popped_ray, cont)._replace(valid=has_cont | popped)
    return acc
