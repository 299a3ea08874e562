"""Shading: BRDF, sky, checker albedo, dominant lights and soft shadows.

Restates raytracevs_tpu/ops/shade.py on [N]-lane tensors:
- GGX D / Smith G / Fresnel-Schlick / Cook-Torrance (Common.hlsli:620-697)
- procedural sky gradient (Common.hlsli:699-755)
- plane checkerboard with exponential distance fade (ClosestHit.hlsl:77-95)
- dominant-light selection for shadow budgeting (Common.hlsli:982-1079)
- area-light soft shadows with SIGMA penumbra packing (Common.hlsli:1199-1357)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from . import intersect, sampling, vec


def luminance(color):
    """Rec.709 luminance (Common.hlsli:563-566)."""
    return color[..., 0] * 0.2126 + color[..., 1] * 0.7152 + color[..., 2] * 0.0722


def compute_attenuation(dist, const_term, linear_term, quad_term):
    """Configurable attenuation (Common.hlsli:575-578)."""
    return 1.0 / torch.clamp(const_term + linear_term * dist + quad_term * dist * dist, min=1e-4)


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def fresnel_schlick(cos_theta, f0):
    """Scalar Fresnel-Schlick (Common.hlsli:598-601)."""
    return f0 + (1.0 - f0) * _pow5(1.0 - cos_theta)


def fresnel_schlick3(vdoth, f0):
    """float3 Fresnel-Schlick (Common.hlsli:662-665)."""
    return f0 + (1.0 - f0) * _pow5(torch.clamp(1.0 - vdoth, 0.0, 1.0))[..., None]


def ggx_d(ndoth, roughness):
    """GGX/Trowbridge-Reitz NDF (Common.hlsli:621-627)."""
    a = roughness * roughness
    a2 = a * a
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (C.PI * denom * denom + 1e-4)


def smith_g1(ndotv, k):
    return ndotv / (ndotv * (1.0 - k) + k)


def smith_g(ndotv, ndotl, roughness):
    """Smith geometry, direct-lighting remap (Common.hlsli:638-643)."""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return smith_g1(ndotv, k) * smith_g1(ndotl, k)


def cook_torrance_specular(n, v, l, f0, roughness):
    """Cook-Torrance specular BRDF (Common.hlsli:669-691)."""
    h = vec.normalize(v + l)
    ndotl = torch.clamp(vec.dot(n, l), min=0.001)
    ndotv = torch.clamp(vec.dot(n, v), min=0.001)
    ndoth = torch.clamp(vec.dot(n, h), min=0.0)
    vdoth = torch.clamp(vec.dot(v, h), min=0.0)
    d = ggx_d(ndoth, roughness)
    g = smith_g(ndotv, ndotl, roughness)
    f = fresnel_schlick3(vdoth, f0)
    return (d * g)[..., None] * f / (4.0 * ndotv * ndotl + 0.001)[..., None]


def _smoothstep(e0, e1, x):
    t = torch.clamp(vec.div_const(x - e0, e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _lerp(a, b, t):
    return a + (b - a) * t


def sky_color(direction):
    """Procedural atmospheric sky gradient (Common.hlsli:699-755). [...,3]."""
    d = vec.normalize(direction)
    elevation = d[..., 1]
    t = torch.clamp(elevation, 0.0, 1.0)
    t_below = torch.clamp(-elevation, 0.0, 1.0)
    zenith = vec.const3(0.15, 0.35, 0.75, like=d)
    sky_mid = vec.const3(0.35, 0.55, 0.90, like=d)
    horizon = vec.const3(0.70, 0.80, 0.95, like=d)
    glow = vec.const3(0.95, 0.85, 0.70, like=d)
    ground = vec.const3(0.25, 0.28, 0.35, like=d)

    horizon_fade = _smoothstep(0.0, 0.15, t)[..., None]
    zenith_fade = _smoothstep(0.4, 1.0, t)[..., None]
    glow_i = (1.0 - _smoothstep(0.0, 0.08, t))[..., None]

    above = horizon.expand_as(d)
    above = _lerp(above, glow, glow_i * 0.4)
    above = _lerp(above, sky_mid, horizon_fade)
    above = _lerp(above, zenith, zenith_fade)
    haze = (torch.exp(-t * 8.0) * 0.3)[..., None]
    above = _lerp(above, horizon, haze)

    ground_fade = _smoothstep(0.0, 0.3, t_below)[..., None]
    below = _lerp(horizon, ground, ground_fade)
    below = below * (0.8 + (0.4 - 0.8) * ground_fade)
    return vec.where3(elevation >= 0.0, above, below)


def checker_albedo(base_rgb, hit_position, cam_pos, cam_forward):
    """World-space plane checkerboard with distance fade (ClosestHit.hlsl:77-95).
    base_rgb is unused, as in the reference (the checker replaces it)."""
    view_z = torch.clamp(vec.dot(hit_position - cam_pos, cam_forward), min=0.0)
    fade = torch.exp(vec.div_const(-view_z, C.CHECKER_FADE_DISTANCE))
    contrast = 0.3 + (1.0 - 0.3) * fade
    ix = torch.floor(hit_position[..., 0]).to(torch.int32)
    iy = torch.floor(hit_position[..., 2]).to(torch.int32)
    checker = ((ix + iy) & 1).to(torch.float32)
    value = 0.5 + (checker - 0.5) * contrast
    dark = vec.const3(0.1, 0.1, 0.1, like=hit_position)
    bright = vec.const3(0.9, 0.9, 0.9, like=hit_position)
    return dark + (bright - dark) * value[..., None]


def sigma_pack_penumbra_local(d_occ, d_light, light_size):
    """SIGMA penumbra, local light (NRDEncoding.hlsli:188-194)."""
    size = light_size * d_occ / torch.clamp(d_light - d_occ, min=C.NRD_EPS)
    radius = size * 0.5
    return torch.where(d_occ >= C.NRD_FP16_MAX, C.NRD_FP16_MAX,
                       torch.clamp(radius, max=C.SIGMA_PENUMBRA_ABSOLUTE_MAX))


def sigma_pack_penumbra_directional(d_occ, tan_angular_radius):
    """SIGMA penumbra, infinite light (NRDEncoding.hlsli:177-183)."""
    radius = d_occ * tan_angular_radius * 0.5
    return torch.where(d_occ >= C.NRD_FP16_MAX, C.NRD_FP16_MAX,
                       torch.clamp(radius, max=C.SIGMA_PENUMBRA_ABSOLUTE_MAX))


class ShadowResult(NamedTuple):
    visibility: torch.Tensor  # [N]
    penumbra: torch.Tensor  # [N]
    occluder_distance: torch.Tensor  # [N]
    shadow_color: torch.Tensor  # [N,3]
    rays: torch.Tensor  # [N] shadow rays traced


def calculate_soft_shadow(scene, hit_pos, normal, active, lt_type, lt_position, lt_radius,
                          lt_samples, seed, max_samples: int):
    """CalculateSoftShadow for one gathered light per lane
    (Common.hlsli:1199-1357). Returns (new_seed, ShadowResult); the seed
    advances only on lanes that sample. Hard lights (radius <= 0.001)
    trace the light-centre direction on iteration 0 and draw no randoms."""
    n = hit_pos.shape[0]
    dev = hit_pos.device
    f32 = torch.float32
    is_dir = lt_type == C.LIGHT_TYPE_DIRECTIONAL
    is_ambient = lt_type == C.LIGHT_TYPE_AMBIENT
    soft = lt_radius > 0.001
    origin = hit_pos + normal * C.SHADOW_NORMAL_OFFSET

    dir_point = lt_position - hit_pos
    dist_point = vec.length(dir_point)
    l_point = dir_point / torch.clamp(dist_point, min=1e-12)[:, None]
    l_dir = vec.normalize(-lt_position)
    hard_dir = vec.where3(is_dir, l_dir, l_point)
    hard_dist = torch.where(is_dir, 10000.0, dist_point)

    num_samples = torch.clamp(lt_samples.to(torch.int32), 1, 16)
    light_size = lt_radius * 2.0
    tan_ang = torch.tan(lt_radius)
    t_p, b_p = sampling.build_orthonormal_basis(vec.normalize(dir_point))
    t_d, b_d = sampling.build_orthonormal_basis(l_dir)

    vis_sum = torch.zeros((n,), dtype=f32, device=dev)
    pen_sum = torch.zeros((n,), dtype=f32, device=dev)
    min_occ = torch.full((n,), C.NRD_FP16_MAX, dtype=f32, device=dev)
    occluded = torch.zeros((n,), dtype=torch.int32, device=dev)
    valid_samples = torch.zeros((n,), dtype=torch.int32, device=dev)
    color_sum = torch.zeros((n, 3), dtype=f32, device=dev)
    vis_h = torch.ones((n,), dtype=f32, device=dev)
    color_h = torch.ones((n, 3), dtype=f32, device=dev)
    occ_h = torch.full((n,), C.NRD_FP16_MAX, dtype=f32, device=dev)
    rays = torch.zeros((n,), dtype=torch.int32, device=dev)

    shadowed = active & ~is_ambient
    soft_active = shadowed & soft
    hard_active = shadowed & ~soft
    for s in range(max_samples):
        iter_soft = soft_active & (s < num_samples)
        seed, u1 = sampling.masked_rng_next(seed, iter_soft)
        seed, u2 = sampling.masked_rng_next(seed, iter_soft)
        r = torch.sqrt(u1)
        theta = u2 * 6.28318530718
        dx = (r * torch.cos(theta))[:, None]
        dy = (r * torch.sin(theta))[:, None]
        sample_pos = lt_position + (t_p * dx + b_p * dy) * lt_radius[:, None]
        samp_vec = sample_pos - hit_pos
        samp_dist = vec.length(samp_vec)
        samp_dir_point = samp_vec / torch.clamp(samp_dist, min=1e-12)[:, None]
        samp_dir_dir = vec.normalize(l_dir + (t_d * dx + b_d * dy) * lt_radius[:, None])
        samp_dir = vec.where3(is_dir, samp_dir_dir, samp_dir_point)
        samp_max = torch.where(is_dir, 10000.0, samp_dist)
        iter_hard = hard_active & (s == 0)
        trace_dir = vec.where3(soft, samp_dir, hard_dir)
        trace_max = torch.where(soft, samp_max, hard_dist)
        above = vec.dot(samp_dir, normal) > 0.0
        do_trace = (iter_soft & above) | iter_hard
        sv, sc, so = intersect.trace_shadow(scene, origin, trace_dir, trace_max)
        rays = rays + do_trace.to(torch.int32)

        vis_h = torch.where(iter_hard, sv, vis_h)
        color_h = vec.where3(iter_hard, sc, color_h)
        occ_h = torch.where(iter_hard & (sv < 0.99), so, occ_h)

        acc = iter_soft & above
        vis_sum = torch.where(acc, vis_sum + sv, vis_sum)
        color_sum = vec.where3(acc, color_sum + sc * sv[:, None], color_sum)
        valid_samples = valid_samples + acc.to(torch.int32)
        occ_now = acc & (sv < 0.99)
        occluded = occluded + occ_now.to(torch.int32)
        min_occ = torch.where(occ_now, torch.minimum(min_occ, so), min_occ)
        pen = torch.where(is_dir, sigma_pack_penumbra_directional(so, tan_ang),
                          sigma_pack_penumbra_local(so, dist_point, light_size))
        pen_sum = torch.where(occ_now, pen_sum + pen, pen_sum)

    vis_soft = torch.where(valid_samples > 0,
                           vis_sum / torch.clamp(valid_samples, min=1).to(f32), 1.0)
    occ_soft = torch.where(occluded > 0, min_occ, C.NRD_FP16_MAX)
    pen_soft = torch.where(occluded > 0, pen_sum / torch.clamp(occluded, min=1).to(f32), 0.0)
    color_soft = vec.where3(vis_sum > 0.01,
                            color_sum / torch.clamp(vis_sum, min=1e-12)[:, None],
                            torch.zeros_like(color_sum))

    visibility = torch.where(soft, vis_soft, vis_h)
    occluder = torch.where(soft, occ_soft, occ_h)
    penumbra = torch.where(soft, pen_soft, 0.0)
    shadow_color = vec.where3(soft, color_soft, color_h)

    # ambient lights never shadow (Common.hlsli:1340-1348); inactive lanes lit
    lit = is_ambient | ~active
    visibility = torch.where(lit, 1.0, visibility)
    occluder = torch.where(lit, C.NRD_FP16_MAX, occluder)
    penumbra = torch.where(lit, 0.0, penumbra)
    shadow_color = vec.where3(lit, torch.ones_like(shadow_color), shadow_color)
    return seed, ShadowResult(visibility, penumbra, occluder, shadow_color, rays)


def estimate_light_contribution(scene, hit_pos, normal, li: int):
    """EstimateLightContribution (Common.hlsli:982-1004) for light index li."""
    lpos = scene.lt_position[li]
    is_dir = scene.lt_type[li] == C.LIGHT_TYPE_DIRECTIONAL
    to_light = lpos[None, :] - hit_pos
    dist = vec.length(to_light)
    l_point = to_light / torch.clamp(dist, min=0.001)[:, None]
    l_dir = vec.normalize(-lpos)[None, :]
    l = torch.where(is_dir, l_dir, l_point)
    atten = torch.where(is_dir, 1.0, compute_attenuation(
        dist, scene.atten_const, scene.atten_linear, scene.atten_quadratic))
    ndotl = torch.clamp(vec.dot(normal, l), min=0.0)
    lum = luminance(scene.lt_color[li][:3])
    return ndotl * atten * scene.lt_intensity[li] * lum


def select_dominant_lights(scene, hit_pos, normal):
    """SelectDominantLights (Common.hlsli:1008-1047), per lane.
    Returns (top0_idx, top0_c, top1_idx, top1_c, top_count), each [N]."""
    n = hit_pos.shape[0]
    dev = hit_pos.device
    max_shadow = torch.clamp(scene.max_shadow_lights, max=2)
    max_shadow = torch.where(max_shadow == 0, 2, max_shadow)
    top0_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    top0_c = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    top1_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    top1_c = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    count = torch.zeros((n,), dtype=torch.int64, device=dev)
    for li in range(min(scene.light_capacity, 8)):
        in_range = (li < scene.num_lights) & scene.lt_valid[li]
        skip = (scene.lt_type[li] == C.LIGHT_TYPE_AMBIENT) | ~in_range
        contrib = estimate_light_contribution(scene, hit_pos, normal, li)
        beats0 = ~skip & (contrib > top0_c)
        beats1 = ~skip & ~beats0 & (contrib > top1_c) & (max_shadow > 1)
        top1_i = torch.where(beats0, top0_i, torch.where(beats1, li, top1_i))
        top1_c = torch.where(beats0, top0_c, torch.where(beats1, contrib, top1_c))
        top0_i = torch.where(beats0, li, top0_i)
        top0_c = torch.where(beats0, contrib, top0_c)
        count = torch.where(beats0 | beats1, torch.minimum(count + 1, max_shadow), count)
    return top0_i, top0_c, top1_i, top1_c, count


def compute_shadow_samples(base_samples, top0_i, top0_c, top1_i, top1_c, li):
    """ComputeShadowSamples (Common.hlsli:1062-1079) per lane for light li."""
    base = torch.clamp(base_samples.to(torch.int32), 1, 16)
    ratio = top1_c / torch.clamp(top0_c, min=0.001)
    reduced = torch.clamp((base.to(torch.float32) * ratio).to(torch.int32), min=1)
    secondary = torch.minimum(reduced, base // 2 + 1)
    return torch.where(top0_i == li, base, torch.where(top1_i == li, secondary, 1))
