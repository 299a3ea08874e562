"""Denoiser: REBLUR-style temporal accumulation, edge-stopping a-trous, and
the ShadowDenoise.hlsl shadow filter, on channel-first [C,H,W] planes.

Restates raytracevs_tpu/post/denoise.py. The three stencil stages are the
plain versions of kernels K2-K4 (ops/cuda/denoise_kernels.py):
``temporal_accumulate`` (K2), ``atrous`` (K3) and ``shadow_denoise`` (K4);
``denoise_frame_cf`` calls the kernels' wrappers, which run these on CPU
tensors. Reprojection warps every pixel bilinearly, as the JAX package's jnp
oracle does (not the TPU kernel's tile-mean quantization).

The JAX package's REBLUR features are all on, with its defaults hard-coded
(no environment flags): hit-distance reconstruction, the specular prepass,
the hit-distance/accumulation guided blur radius, anti-firefly, responsive
accumulation for near-mirrors, specular virtual motion, 3 a-trous passes,
and a float32 history.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from .. import constants as C

F32 = torch.float32

MAX_ACCUM_FRAMES = 16.0  # NRDDenoiser.cpp:870
MAX_FAST_FRAMES = 4.0  # NRDDenoiser.cpp:871
ATROUS_PASSES = 3
DEPTH_SIGMA = 0.05
MAX_BLUR_RADIUS = 30.0  # NRDDenoiser.cpp:860
RESPONSIVE_ROUGHNESS = 0.05  # NRDDenoiser.cpp:864
SPEC_PREPASS_RADIUS = 10.0  # NRDDenoiser.cpp:868
SHADOW_RADIUS = 2  # ShadowDenoise.hlsl: 5x5 taps
SHADOW_SOFTNESS = 1.0
SHADOW_DEPTH_THRESHOLD = 0.1
STATE_CH = 16  # packed history: 0:4 diffuse, 4:8 specular, 8:11 fast diffuse,
#                11:14 fast specular, 14 frames, 15 view_z
_ATROUS_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))
_SPEC_PREPASS_TAPS = ((0, 3), (0, -3), (3, 0), (-3, 0), (2, 2), (2, -2), (-2, 2), (-2, -2),
                      (0, 7), (0, -7), (7, 0), (-7, 0), (5, 5), (5, -5), (-5, 5), (-5, -5))


class DenoiserStateCF(NamedTuple):
    """Channel-first packed history [16,H,W] (STATE_CH layout)."""

    packed: torch.Tensor


def init_state_cf(height: int, width: int, device) -> DenoiserStateCF:
    packed = torch.zeros((STATE_CH, height, width), dtype=F32, device=device)
    packed[15] = C.VIEWZ_SKY
    return DenoiserStateCF(packed=packed)


def _pad_edge(x, p: int):
    """Edge-replicate the last two axes of [C,H,W] (or [H,W]) by p."""
    if x.dim() == 2:
        return Fn.pad(x[None], (p, p, p, p), mode="replicate")[0]
    return Fn.pad(x, (p, p, p, p), mode="replicate")


def _shifted(padded, pad: int, dy: int, dx: int, h: int, w: int):
    """Edge-clamped neighbour view (dy, dx) of an array padded by `pad`."""
    return padded[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def _pow8(x):
    x2 = x * x
    x4 = x2 * x2
    return x4 * x4


def _lum(rgb):
    return rgb[0] * 0.2126 + rgb[1] * 0.7152 + rgb[2] * 0.0722


def anti_firefly(img6):
    """REBLUR enableAntiFirefly (NRDDenoiser.cpp:859): clamp each pixel's
    luminance to the max over its 8 edge-clamped neighbours, separately for
    the diffuse (0:3) and specular (3:6) groups. img6 [6,H,W]."""
    h, w = img6.shape[1:]
    p = _pad_edge(img6, 1)
    out = []
    for g in (0, 3):
        grp = img6[g:g + 3]
        m = None
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                q = _lum(_shifted(p[g:g + 3], 1, dy, dx, h, w))
                m = q if m is None else torch.maximum(m, q)
        out.append(grp * torch.clamp(m / torch.clamp(_lum(grp), min=1e-6), max=1.0)[None])
    return torch.cat(out, dim=0)


def reblur_prepass(curr, view_z, sqrt_rough):
    """REBLUR input conditioning before temporal accumulation. curr [8,H,W]
    (diffuse rgb+hitdist, specular rgb+hitdist); view_z, sqrt_rough [H,W].

    1) AREA_3X3 hit-distance reconstruction (NRDDenoiser.cpp:858): surface
       pixels without hit distance take the mean of their valid 3x3
       neighbours (edge-clamped).
    2) Specular prepass blur (NRDDenoiser.cpp:867-868): a two-ring 16-tap
       kernel with per-pixel radius R = 10 sqrt(roughness) hd/(hd + 0.2 z),
       tap weights exp(-(d/R)^2) times the depth weight."""
    h, w = view_z.shape
    not_sky = view_z < C.VIEWZ_SKY * 0.99
    out = curr.clone()
    for ch in (3, 7):
        hd = curr[ch]
        vf = ((hd > 0.0) & not_sky).to(F32)
        hp = _pad_edge(hd * vf, 1)
        vp = _pad_edge(vf, 1)
        s = torch.zeros_like(hd)
        cnt = torch.zeros_like(hd)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                s = s + _shifted(hp, 1, dy, dx, h, w)
                cnt = cnt + _shifted(vp, 1, dy, dx, h, w)
        recon = s / torch.clamp(cnt, min=1.0)
        need = (hd <= 0.0) & not_sky & (cnt > 0.0)
        out[ch] = torch.where(need, recon, hd)

    hd = torch.clamp(out[7], min=0.0)
    zc = torch.clamp(view_z, min=C.VIEWZ_MIN)
    hd_factor = hd / (hd + 0.2 * zc + 1e-6)
    radius = SPEC_PREPASS_RADIUS * torch.clamp(sqrt_rough, 0.0, 1.0) * hd_factor
    r2 = torch.square(torch.clamp(radius, min=1e-3))
    spec = out[4:7]
    p = 7
    sp = _pad_edge(spec, p)
    zp = _pad_edge(view_z, p)
    acc = spec
    wsum = torch.ones_like(view_z)
    for dy, dx in _SPEC_PREPASS_TAPS:
        d2 = float(dy * dy + dx * dx)
        q = _shifted(sp, p, dy, dx, h, w)
        qz = _shifted(zp, p, dy, dx, h, w)
        wt = torch.exp(-d2 / r2) * torch.exp(-torch.abs(qz - view_z) / (DEPTH_SIGMA * zc))
        acc = acc + q * wt[None]
        wsum = wsum + wt
    out[4:7] = acc / wsum[None]
    return out


def blur_radius_planes(frames, spec_hitdist, view_z, roughness):
    """Per-pixel blur radii in pixels (REBLUR maxBlurRadius=30,
    minBlurRadius=0): shrinks as 1/(1+frames); the specular radius also
    scales with hit distance relative to depth and sqrt(roughness).
    Returns (r_diffuse, r_specular), each [H,W]."""
    base = MAX_BLUR_RADIUS / (1.0 + frames)
    hd = torch.clamp(spec_hitdist, min=0.0)
    hd_factor = hd / (hd + 0.2 * torch.clamp(view_z, min=C.VIEWZ_MIN) + 1e-6)
    r_spec = base * torch.sqrt(torch.clamp(roughness, 0.0, 1.0)) * hd_factor
    return base, r_spec


def _bilinear(img, xf, yf):
    """Bilinear sample of img [C,H,W] at float pixel coords (xf, yf) [H,W],
    taps clamped to the frame."""
    c, h, w = img.shape
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = (xf - x0)[None]
    fy = (yf - y0)[None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    flat = img.reshape(c, h * w)

    def tap(yi, xi):
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        return flat[:, idx.reshape(-1)].reshape(c, h, w)

    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
            + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)


def temporal_accumulate(packed, curr, motion, view_z, roughness, motion_spec):
    """Plain version of K2: motion-reprojected accumulation with a 16-frame
    slow and a 4-frame fast history, the slow one clamped to the fast.

    packed [16,H,W] (STATE_CH layout), curr [8,H,W], motion [2,H,W]
    (pixel-space current - previous), view_z [H,W]; roughness [H,W] caps
    near-mirror specular at the fast frame count (responsive accumulation,
    NRDDenoiser.cpp:864-865); motion_spec [2,H,W] fetches the specular
    history by virtual motion, per pixel falling back to surface motion
    outside the frame. History is
    rejected outside the frame, on a depth mismatch and on sky. Returns
    the new packed state [16,H,W]."""
    h, w = view_z.shape
    dev = view_z.device
    ys = torch.arange(h, device=dev, dtype=F32)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev, dtype=F32)[None, :].expand(h, w)
    prev_x = xs - motion[0]
    prev_y = ys - motion[1]
    hist = _bilinear(packed, prev_x, prev_y)
    hist_d, hist_s = hist[0:4], hist[4:8]
    fast_d, fast_s = hist[8:11], hist[11:14]
    hist_frames, hist_z = hist[14], hist[15]

    pvx = xs - motion_spec[0]
    pvy = ys - motion_spec[1]
    vh = _bilinear(torch.cat([packed[4:8], packed[11:14]], dim=0), pvx, pvy)
    virt_in = ((pvx >= 0) & (pvx <= w - 1) & (pvy >= 0) & (pvy <= h - 1))[None]
    hist_s = torch.where(virt_in, vh[0:4], hist_s)
    fast_s = torch.where(virt_in, vh[4:7], fast_s)

    in_bounds = (prev_x >= 0) & (prev_x <= w - 1) & (prev_y >= 0) & (prev_y <= h - 1)
    depth_ok = torch.abs(hist_z - view_z) <= 0.1 * torch.clamp(view_z, min=C.VIEWZ_MIN)
    not_sky = view_z < C.VIEWZ_SKY * 0.99
    valid = in_bounds & depth_ok & not_sky

    frames = torch.where(valid, torch.clamp(hist_frames + 1.0, max=MAX_ACCUM_FRAMES), 0.0)
    alpha = (1.0 / (1.0 + frames))[None]
    fast_frames = torch.clamp(frames, max=MAX_FAST_FRAMES)
    fast_alpha = (1.0 / (1.0 + fast_frames))[None]
    frames_s = torch.where(roughness < RESPONSIVE_ROUGHNESS, fast_frames, frames)
    alpha_s = (1.0 / (1.0 + frames_s))[None]

    acc_d = hist_d + (curr[0:4] - hist_d) * alpha
    acc_s = hist_s + (curr[4:8] - hist_s) * alpha_s
    new_fast_d = fast_d + (curr[0:3] - fast_d) * fast_alpha
    new_fast_s = fast_s + (curr[4:7] - fast_s) * fast_alpha

    def clamp_to_fast(slow, fast):
        # anti-lag: the slow history stays within [fast/2, 2 fast + 1e-3]
        lo = fast * 0.5
        hi = fast * 2.0 + 1e-3
        return torch.minimum(torch.maximum(slow, torch.minimum(lo, hi)), torch.maximum(lo, hi))

    return torch.cat([clamp_to_fast(acc_d[0:3], new_fast_d), acc_d[3:4],
                      clamp_to_fast(acc_s[0:3], new_fast_s), acc_s[3:4],
                      new_fast_d, new_fast_s, frames[None], view_z[None]], dim=0)


def atrous_pass(img, view_z, normal, stride: int, guide):
    """One guided edge-stopping a-trous pass (edge-clamped reads) on the
    diffuse+specular img [6,H,W]; weights exp(-|dz|/(0.05 z)) *
    max(n.n', 0)^8 * 2/3, each group's scaled by exp(-stride^2 /
    max(R, 1e-3)^2) with R its blur radius in guide [2,H,W] (diffuse 0:3,
    specular 3:6)."""
    h, w = view_z.shape
    pimg = _pad_edge(img, stride)
    pz = _pad_edge(view_z, stride)
    pn = _pad_edge(normal, stride)
    zc = DEPTH_SIGMA * torch.clamp(view_z, min=C.VIEWZ_MIN)
    s2 = float(stride * stride)
    g_d = torch.exp(-s2 / torch.square(torch.clamp(guide[0], min=1e-3)))
    g_s = torch.exp(-s2 / torch.square(torch.clamp(guide[1], min=1e-3)))
    wsum_d = torch.ones_like(view_z)
    wsum_s = torch.ones_like(view_z)
    acc = img
    for dy, dx in _ATROUS_OFFSETS:
        q = _shifted(pimg, stride, dy * stride, dx * stride, h, w)
        qz = _shifted(pz, stride, dy * stride, dx * stride, h, w)
        qn = _shifted(pn, stride, dy * stride, dx * stride, h, w)
        w_depth = torch.exp(-torch.abs(qz - view_z) / zc)
        ndot = qn[0] * normal[0] + qn[1] * normal[1] + qn[2] * normal[2]
        wt = w_depth * _pow8(torch.clamp(ndot, min=0.0)) * (2.0 / 3.0)
        w_d = wt * g_d
        w_s = wt * g_s
        acc = acc + torch.cat([q[0:3] * w_d[None], q[3:6] * w_s[None]], dim=0)
        wsum_d = wsum_d + w_d
        wsum_s = wsum_s + w_s
    return torch.cat([acc[0:3] / wsum_d[None], acc[3:6] / wsum_s[None]], dim=0)


def atrous(img, view_z, normal, guide):
    """Plain version of K3: the anti-firefly clamp, then ATROUS_PASSES
    guided a-trous passes at strides 1, 2, 4 on the diffuse+specular img
    [6,H,W]."""
    out = anti_firefly(img)
    for p in range(ATROUS_PASSES):
        out = atrous_pass(out, view_z, normal, 1 << p, guide)
    return out


def shadow_denoise(shadow, obj_id, view_z, normal):
    """Plain version of K4: the ShadowDenoise.hlsl:39-131 filter on
    (penumbra, visibility) [2,H,W]. Taps need an exact obj_id match
    (int32 [H,W]); weights come from depth, max(n.n', 0)^8 (normal [3,H,W],
    decoded) and a Gaussian. Sky pixels (obj_id < 0) pass through."""
    h, w = view_z.shape
    radius, softness = SHADOW_RADIUS, SHADOW_SOFTNESS
    p_sh = _pad_edge(shadow, radius)
    p_id = _pad_edge(obj_id.to(F32), radius)  # replicate pad is float-only; ids < 2**24
    p_z = _pad_edge(view_z, radius)
    p_n = _pad_edge(normal, radius)
    oid = obj_id.to(F32)
    dz = torch.clamp(SHADOW_DEPTH_THRESHOLD * view_z, min=0.001)
    wsum = torch.zeros_like(view_z)
    vis_sum = torch.zeros_like(view_z)
    pen_sum = torch.zeros_like(view_z)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            q = _shifted(p_sh, radius, dy, dx, h, w)
            q_n = _shifted(p_n, radius, dy, dx, h, w)
            same = _shifted(p_id, radius, dy, dx, h, w) == oid
            w_depth = torch.exp(-torch.abs(view_z - _shifted(p_z, radius, dy, dx, h, w)) / dz)
            ndot = q_n[0] * normal[0] + q_n[1] * normal[1] + q_n[2] * normal[2]
            w_spatial = torch.exp(torch.tensor(-float(dx * dx + dy * dy)
                                               / (2.0 * softness * softness + 0.01),
                                               dtype=F32, device=view_z.device))
            wt = torch.where(same, w_depth * _pow8(torch.clamp(ndot, min=0.0)) * w_spatial, 0.0)
            vis_sum = vis_sum + q[1] * wt
            pen_sum = pen_sum + q[0] * wt
            wsum = wsum + wt
    ok = wsum > 0.001
    out = torch.stack([
        torch.where(ok, pen_sum / torch.clamp(wsum, min=1e-6), shadow[0]),
        torch.where(ok, vis_sum / torch.clamp(wsum, min=1e-6), shadow[1])], dim=0)
    return torch.where((obj_id < 0)[None], shadow, out)


def decode_oct_cf(nr):
    """DecodeUnitVector (NRDEncoding.hlsli:82-91): [>=2,H,W] -> [3,H,W]."""
    px = nr[0] * 2.0 - 1.0
    py = nr[1] * 2.0 - 1.0
    z = 1.0 - torch.abs(px) - torch.abs(py)
    t = torch.clamp(-z, 0.0, 1.0)
    x = px + torch.where(px >= 0.0, -t, t)
    y = py + torch.where(py >= 0.0, -t, t)
    n = torch.stack([x, y, z], dim=0)
    m = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    return n / torch.clamp(m, min=1e-12)


def guide_cf(new_packed, view_z, sqrt_rough):
    """REBLUR blur-radius guide planes [2,H,W] from the accumulated state
    (ch 7 = specular hit-distance history, ch 14 = frames)."""
    r_d, r_s = blur_radius_planes(new_packed[14], new_packed[7], view_z,
                                  torch.square(sqrt_rough))
    return torch.stack([r_d, r_s], dim=0)


def denoise_frame_cf(gbuf_cf, state: DenoiserStateCF):
    """The frame's denoise: prepass, K2, K3 (with guide and anti-firefly),
    K4. Returns (diffuse [3,H,W], specular [3,H,W], shadow [2,H,W],
    new state)."""
    from ..ops.cuda import denoise_kernels as dk

    curr = torch.cat([gbuf_cf.diffuse_hitdist, gbuf_cf.specular_hitdist], dim=0)
    sqrt_rough = gbuf_cf.normal_roughness[3]
    curr = reblur_prepass(curr, gbuf_cf.view_z, sqrt_rough)
    new_packed = dk.reproject_accumulate(state.packed, curr, gbuf_cf.motion, gbuf_cf.view_z,
                                         torch.square(sqrt_rough), gbuf_cf.motion_spec)
    normal = decode_oct_cf(gbuf_cf.normal_roughness)
    guide = guide_cf(new_packed, gbuf_cf.view_z, sqrt_rough)
    out_ds = dk.atrous(torch.cat([new_packed[0:3], new_packed[4:7]], dim=0), gbuf_cf.view_z,
                       normal, guide)
    out_shadow = dk.shadow_denoise(gbuf_cf.shadow_data, gbuf_cf.obj_id, gbuf_cf.view_z, normal)
    return out_ds[0:3], out_ds[3:6], out_shadow, DenoiserStateCF(packed=new_packed)
