"""Primary rays and the per-sample loop: the plain version of kernel K1.

Restates raytracevs_tpu/ops/render.py (``primary_rays`` and the sample scan
of ``render_rows``, RayGen.hlsl:48-172) and writes the megakernel's
32-plane accumulator layout (raytracevs_tpu/ops/pallas/megakernel.py:118-136),
so the CUDA kernel and this function return the same tensor.
"""
from __future__ import annotations

import torch

from . import sampling, vec, wavefront

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


def render_accum(scene, cfg) -> torch.Tensor:
    """Render the frame: every sample's DFS, summed into the
    [NUM_CH, height, width] float32 accumulator planes
    (colour sums over samples, first-sample SIGMA shadow record, first-hit
    primary record). Runs on the device of the scene tensors."""
    dev = scene.cam_pos.device
    w, h = cfg.width, cfg.height
    n = w * h
    idx = torch.arange(n, device=dev)
    px = idx % w
    py = idx // w
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
        a = wavefront.run_sample(scene, cfg, px, py, s, primary, prev_hit)
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
    return torch.cat(chans, dim=0).contiguous()
