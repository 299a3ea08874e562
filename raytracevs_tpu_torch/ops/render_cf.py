"""Channel-first frame assembly: accumulator planes -> HDR colour + G-buffer.

Restates raytracevs_tpu/ops/render_cf.py (the plane form of RayGen.hlsl:
850-1044): 3-vectors are [3,H,W] planes, scalars [H,W]; every operation is
elementwise. The output feeds post/denoise.denoise_frame_cf and
post/composite.composite_cf without a transpose.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import constants as C
from . import render as R
from . import vec

F32 = torch.float32


class GBufferCF(NamedTuple):
    """Channel-first NRD G-buffer (Common.hlsli:538-545)."""

    diffuse_hitdist: torch.Tensor  # [4,H,W]
    specular_hitdist: torch.Tensor  # [4,H,W]
    normal_roughness: torch.Tensor  # [4,H,W]
    view_z: torch.Tensor  # [H,W]
    motion: torch.Tensor  # [2,H,W]
    albedo: torch.Tensor  # [4,H,W]
    shadow_data: torch.Tensor  # [2,H,W]
    shadow_translucency: torch.Tensor  # [4,H,W]
    obj_id: torch.Tensor  # [H,W] int32
    motion_spec: Optional[torch.Tensor] = None  # [2,H,W] virtual-motion vectors


class FrameOutputCF(NamedTuple):
    color: torch.Tensor  # [3,H,W] linear HDR
    gbuffer: GBufferCF
    rays: torch.Tensor  # [] float64, exact ray count
    raw_specular: torch.Tensor  # [3,H,W]


def accum_dict(acc: torch.Tensor) -> dict:
    """Named views of the [NUM_CH,H,W] accumulator planes."""
    return dict(
        color=acc[R.CH_COLOR:R.CH_COLOR + 3],
        primary=acc[R.CH_PRIMARY:R.CH_PRIMARY + 3],
        diffuse=acc[R.CH_DIFFUSE:R.CH_DIFFUSE + 3],
        specular=acc[R.CH_SPECULAR:R.CH_SPECULAR + 3],
        hitdist=acc[R.CH_HITDIST],
        bounce=acc[R.CH_BOUNCE],
        # per-pixel counts are exact in f32; their frame sum is not, at 1080p
        rays=acc[R.CH_RAYS].to(torch.float64).sum(),
        prim_hit=acc[R.CH_PRIM_HIT] > 0.5,
        prim_normal=acc[R.CH_NORMAL:R.CH_NORMAL + 3],
        prim_rough=acc[R.CH_ROUGH],
        prim_albedo=acc[R.CH_ALBEDO:R.CH_ALBEDO + 3],
        prim_metallic=acc[R.CH_METALLIC],
        prim_transmission=acc[R.CH_TRANSMISSION],
        prim_pos=acc[R.CH_POS:R.CH_POS + 3],
        shadow_vis=acc[R.CH_SHADOW_VIS],
        shadow_pen=acc[R.CH_SHADOW_PEN],
        shadow_dist=acc[R.CH_SHADOW_DIST],
        obj_id=acc[R.CH_OBJ_ID].to(torch.int32),
    )


def _smoothstep(e0, e1, x):
    t = torch.clamp(vec.div_const(x - e0, e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _oct_encode_cf(n):
    """EncodeUnitVector (NRDEncoding.hlsli:73-79). n: [3,H,W] -> [2,H,W]."""
    s = torch.abs(n[0]) + torch.abs(n[1]) + torch.abs(n[2])
    v = n / torch.clamp(s, min=1e-12)
    x, y = v[0], v[1]
    sx = torch.where(x >= 0.0, 1.0, -1.0)
    sy = torch.where(y >= 0.0, 1.0, -1.0)
    up = v[2] >= 0.0
    ox = torch.where(up, x, (1.0 - torch.abs(y)) * sx)
    oy = torch.where(up, y, (1.0 - torch.abs(x)) * sy)
    return torch.stack([ox, oy], dim=0) * 0.5 + 0.5


def _norm3(v):
    m = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return v / torch.clamp(m, min=1e-12)


def _clip_xy(vp, p):
    """NDC x, y of world points p [3,H,W] under row-vector matrix vp [4,4]."""
    cx = p[0] * vp[0, 0] + p[1] * vp[1, 0] + p[2] * vp[2, 0] + vp[3, 0]
    cy = p[0] * vp[0, 1] + p[1] * vp[1, 1] + p[2] * vp[2, 1] + vp[3, 1]
    cw = p[0] * vp[0, 3] + p[1] * vp[1, 3] + p[2] * vp[2, 3] + vp[3, 3]
    safe_w = torch.where(torch.abs(cw) < 1e-9, 1.0, cw)
    return cx / safe_w, cy / safe_w


def _motion(scene, cfg, p, prim_hit):
    """Clamped pixel-space motion [2,H,W] of points p, zero off hits."""
    cx, cy = _clip_xy(scene.view_proj, p)
    px_, py_ = _clip_xy(scene.prev_view_proj, p)
    mvx = torch.clamp((cx - px_) * float(cfg.width * 0.5), -C.MV_CLAMP_PIXELS, C.MV_CLAMP_PIXELS)
    mvy = torch.clamp((cy - py_) * float(cfg.height * 0.5), -C.MV_CLAMP_PIXELS, C.MV_CLAMP_PIXELS)
    return torch.stack([torch.where(prim_hit, mvx, 0.0), torch.where(prim_hit, mvy, 0.0)], dim=0)


def assemble_frame_cf(scene, cfg, acc: dict) -> FrameOutputCF:
    """G-buffer assembly on planes (RayGen.hlsl:850-1044); `acc` is
    accum_dict() of the accumulator planes."""
    inv = 1.0 / cfg.samples_per_pixel
    final_color = acc["color"] * inv
    prim_hit = acc["prim_hit"]
    up3 = torch.tensor([0.0, 1.0, 0.0], dtype=F32, device=final_color.device)[:, None, None]
    world_normal = torch.where(prim_hit, acc["prim_normal"], up3)
    out_rough = torch.where(prim_hit, acc["prim_rough"], 1.0)
    out_albedo = torch.where(prim_hit, acc["prim_albedo"], 1.0)

    # Material classification (RayGen.hlsl:913-963)
    spec_dom = torch.maximum(acc["prim_transmission"], acc["prim_metallic"])
    blend = 1.0 - _smoothstep(0.3, 0.7, spec_dom)
    diffuse_mod = acc["diffuse"] * inv
    direct_spec = acc["specular"] * inv
    secondary = torch.clamp(final_color - diffuse_mod - direct_spec, min=0.0)
    demod = diffuse_mod / torch.clamp(out_albedo, min=0.04)
    diffuse_nrd = torch.where(
        prim_hit,
        torch.where(spec_dom > 0.7, 0.0, torch.where(spec_dom > 0.3, demod * blend, demod)),
        final_color)
    spec_mid = final_color + (direct_spec + secondary - final_color) * blend
    specular_nrd = torch.where(
        prim_hit,
        torch.where(spec_dom > 0.7, final_color,
                    torch.where(spec_dom > 0.3, spec_mid, direct_spec + secondary)),
        0.0)
    mean_hitdist = acc["hitdist"] * inv
    diffuse_hitdist = torch.cat([diffuse_nrd, mean_hitdist[None]], dim=0)
    specular_hitdist = torch.cat([specular_nrd, mean_hitdist[None]], dim=0)

    # NRD inputs (NRDEncoding.hlsli:302-376)
    wn0, wn1, wn2 = world_normal[0], world_normal[1], world_normal[2]
    r, u, f = scene.cam_right, scene.cam_up, scene.cam_forward
    view_n = _norm3(torch.stack([
        wn0 * r[0] + wn1 * r[1] + wn2 * r[2],
        wn0 * u[0] + wn1 * u[1] + wn2 * u[2],
        wn0 * f[0] + wn1 * f[1] + wn2 * f[2],
    ], dim=0))
    prim_pos = acc["prim_pos"]
    rel = prim_pos - scene.cam_pos[:, None, None]
    view_z = torch.where(
        prim_hit,
        torch.clamp(rel[0] * f[0] + rel[1] * f[1] + rel[2] * f[2], min=C.VIEWZ_MIN),
        C.VIEWZ_SKY)
    normal_roughness = torch.cat([
        _oct_encode_cf(view_n),
        torch.where(view_n[2] >= 0.0, 1.0, 0.0)[None],
        torch.sqrt(torch.clamp(out_rough, 0.0, 1.0))[None],
    ], dim=0)

    # Motion vectors via current/previous view-projection (NRDEncoding.hlsli:352-369)
    mv = _motion(scene, cfg, prim_pos, prim_hit)
    # Specular virtual-motion vectors: reproject Xv = X + V*hitDist*(1-roughness)
    # (REBLUR virtual-motion reprojection; a static camera gives mv_spec == mv)
    vlen = torch.sqrt(torch.clamp(rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2], min=1e-18))
    v_amount = torch.clamp(1.0 - out_rough, 0.0, 1.0)
    vd = torch.clamp(mean_hitdist, min=0.0) * v_amount / vlen
    mv_spec = _motion(scene, cfg, prim_pos + rel * vd[None], prim_hit)

    # Material alpha for Composite (RayGen.hlsl:987-1000)
    material_alpha = torch.where(
        prim_hit, torch.where(spec_dom > 0.5, 0.5, 0.75 + (1.0 - 0.75) * blend), 0.0)
    albedo_out = torch.cat([out_albedo, material_alpha[None]], dim=0)

    # SIGMA shadow inputs from the RAW first sample (RayGen.hlsl:1002-1039)
    sigma_pen = torch.where(
        acc["shadow_vis"] > C.SHADOW_FULLY_LIT_THRESHOLD, C.NRD_FP16_MAX,
        torch.clamp(acc["shadow_pen"], C.SIGMA_PENUMBRA_MIN, C.SIGMA_PENUMBRA_PRACTICAL_MAX))
    vis_clean = torch.clamp(acc["shadow_vis"], 0.0, 1.0)
    vis_clean = torch.where(torch.isfinite(vis_clean), vis_clean, 1.0)
    sigma_pen = torch.where(torch.isfinite(sigma_pen), sigma_pen, C.NRD_FP16_MAX)
    shadow_translucency = torch.cat([
        (acc["shadow_dist"] >= C.NRD_FP16_MAX).to(F32)[None],
        torch.zeros((3,) + vis_clean.shape, dtype=F32, device=vis_clean.device)], dim=0)

    return FrameOutputCF(
        color=final_color,
        gbuffer=GBufferCF(
            diffuse_hitdist=diffuse_hitdist,
            specular_hitdist=specular_hitdist,
            normal_roughness=normal_roughness,
            view_z=view_z,
            motion=mv,
            albedo=albedo_out,
            shadow_data=torch.stack([sigma_pen, vis_clean], dim=0),
            shadow_translucency=shadow_translucency,
            obj_id=acc["obj_id"],
            motion_spec=mv_spec,
        ),
        rays=acc["rays"],
        raw_specular=specular_nrd,
    )


def render_rows_cf(scene, cfg) -> FrameOutputCF:
    """Render the frame through kernel K1 (or its plain version on the CPU)
    and assemble the channel-first frame. Caustics are not part of this port."""
    from .cuda import megakernel

    if cfg.num_photons > 0:
        raise NotImplementedError("caustics: not ported yet")
    acc = megakernel.render_accum(scene, cfg)
    return assemble_frame_cf(scene, cfg, accum_dict(acc))
