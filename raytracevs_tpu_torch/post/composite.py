"""Composite pass (src/Shader/Composite.hlsl:170-509), channel-first.

Restates raytracevs_tpu/post/composite.py::composite_cf: (optionally
denoised) diffuse/specular with albedo remodulation, the material-class
dispatch on albedo.alpha (sky / specular-dominant / diffuse), the
distance-based NRD bypass, exposure, tone map and gamma.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import vec
from ..runtime.profiler import annotate
from . import tonemap


def composite_cf(
    gbuf_cf,
    raw_specular,
    exposure,
    tone_map_operator,
    gamma,
    denoised_diffuse: Optional[torch.Tensor] = None,
    denoised_specular: Optional[torch.Tensor] = None,
    use_denoised: bool = False,
    nrd_bypass_distance=8.0,
    nrd_bypass_blend=2.0,
):
    """gbuf_cf is a GBufferCF; raw_specular and denoised_* are [3,H,W].
    Returns display colour [3,H,W] in [0,1]."""
    albedo = gbuf_cf.albedo[0:3]
    material_alpha = gbuf_cf.albedo[3]
    is_sky = material_alpha < 0.25
    is_specular_dom = (material_alpha >= 0.25) & (material_alpha < 0.75)
    t = torch.clamp(vec.div_const(material_alpha - 0.7, 0.9 - 0.7), 0.0, 1.0)
    specular_weight = t * t * (3.0 - 2.0 * t)

    diffuse_in = gbuf_cf.diffuse_hitdist[0:3]
    raw_color = diffuse_in * albedo + raw_specular
    if use_denoised and denoised_diffuse is not None:
        view_z = gbuf_cf.view_z
        nrd_color = denoised_diffuse * albedo + denoised_specular
        blend_f = torch.clamp((view_z - nrd_bypass_distance) / nrd_bypass_blend, 0.0, 1.0)
        near = view_z < nrd_bypass_distance + nrd_bypass_blend
        diffuse_color = torch.where(near, nrd_color + (raw_color - nrd_color) * blend_f, raw_color)
    else:
        diffuse_color = raw_color

    surf = raw_specular + (diffuse_color - raw_specular) * specular_weight
    input_color = torch.where(is_sky, diffuse_in, torch.where(is_specular_dom, raw_specular, surf))
    return tonemap.tonemap_and_gamma(input_color, exposure, tone_map_operator, gamma)


def composite_rgba8(scene, out, denoised):
    """RGBA8 [H,W,4] of a rendered frame (or row slab) `out`, with its
    denoised (diffuse, specular, shadow) planes or None."""
    with annotate("rtvs.render.composite"):
        if denoised is not None:
            color01 = composite_cf(
                out.gbuffer, out.raw_specular, scene.exposure, scene.tone_map_operator, scene.gamma,
                denoised_diffuse=denoised[0], denoised_specular=denoised[1], use_denoised=True,
                nrd_bypass_distance=scene.nrd_bypass_distance,
                nrd_bypass_blend=scene.nrd_bypass_blend)
        else:
            color01 = composite_cf(
                out.gbuffer, out.raw_specular, scene.exposure, scene.tone_map_operator, scene.gamma,
                use_denoised=False)
        return tonemap.to_rgba8_cf(color01)
