"""Denoiser: REBLUR-style temporal accumulation, edge-stopping a-trous, and
the ShadowDenoise.hlsl shadow filter, on channel-first [C,H,W] planes.

Restates raytracevs_tpu/post/denoise.py. The four stencil stages are the
plain versions of kernels K10 and K2-K4 (ops/cuda/denoise_kernels.py):
``reblur_prepass`` (K10), ``temporal_accumulate`` (K2), ``atrous`` (K3) and
``shadow_denoise`` (K4); ``denoise_frame_cf`` calls the kernels' wrappers,
which run these on CPU tensors. Reprojection warps every pixel bilinearly,
as the JAX package's jnp oracle does (not the TPU kernel's tile-mean
quantization).

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
from ..runtime.profiler import annotate

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
       tap weights exp(-(d/R)^2) times the depth weight.
    The plain version of K10."""
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


def _bilinear(img, xf, yf, row_shift: int = 0):
    """Bilinear sample of img [C,H,W] at float pixel coords (xf, yf) [h,w]
    (any grid), taps clamped to img. Returns [C,h,w]. With row_shift,
    coordinate row y is img's row y + row_shift; the weights come from the
    unshifted coordinate, so they are the same bits."""
    c, h, w = img.shape
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    fx = (xf - x0)[None]
    fy = (yf - y0)[None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64) + row_shift
    flat = img.reshape(c, h * w)

    def tap(yi, xi):
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        return flat[:, idx.reshape(-1)].reshape(c, *xf.shape)

    return (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
            + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)


def temporal_accumulate(packed, curr, motion, view_z, roughness, motion_spec, halo=0, row0=0,
                        global_h=None):
    """Plain version of K2: motion-reprojected accumulation with a 16-frame
    slow and a 4-frame fast history, the slow one clamped to the fast.

    packed [16,H,W] (STATE_CH layout), curr [8,H,W], motion [2,H,W]
    (pixel-space current - previous), view_z [H,W]; roughness [H,W] caps
    near-mirror specular at the fast frame count (responsive accumulation,
    NRDDenoiser.cpp:864-865); motion_spec [2,H,W] fetches the specular
    history by virtual motion, per pixel falling back to surface motion
    outside the frame. History is
    rejected outside the frame, on a depth mismatch and on sky. Returns
    the new packed state [16,H,W].

    Row slab form (the JAX package's jnp temporal_accumulate with
    packed_ext): the planes hold H rows from frame row `row0` of a
    `global_h`-row frame, and `packed` is their history extended by `halo`
    rows on each side, [16,H+2 halo,W]. Rows are global: the bilinear tap
    at global row y reads history row y - row0 + halo, and the in-frame
    tests take global_h - 1. The tap's weights come from the global
    coordinate (the jnp form's prev_y - row0 + halo rounds its fraction
    where the sum grows past a power of two), so each slab row equals the
    whole frame's bit for bit."""
    h, w = view_z.shape
    global_h = h if global_h is None else global_h
    dev = view_z.device
    ys = torch.arange(h, device=dev, dtype=F32)[:, None].expand(h, w)
    if row0:
        ys = ys + row0
    xs = torch.arange(w, device=dev, dtype=F32)[None, :].expand(h, w)
    shift = halo - row0
    prev_x = xs - motion[0]
    prev_y = ys - motion[1]
    hist = _bilinear(packed, prev_x, prev_y, shift)
    hist_d, hist_s = hist[0:4], hist[4:8]
    fast_d, fast_s = hist[8:11], hist[11:14]
    hist_frames, hist_z = hist[14], hist[15]

    pvx = xs - motion_spec[0]
    pvy = ys - motion_spec[1]
    vh = _bilinear(torch.cat([packed[4:8], packed[11:14]], dim=0), pvx, pvy, shift)
    virt_in = ((pvx >= 0) & (pvx <= w - 1) & (pvy >= 0) & (pvy <= global_h - 1))[None]
    hist_s = torch.where(virt_in, vh[0:4], hist_s)
    fast_s = torch.where(virt_in, vh[4:7], fast_s)

    in_bounds = (prev_x >= 0) & (prev_x <= w - 1) & (prev_y >= 0) & (prev_y <= global_h - 1)
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


def atrous_single_pass(img, view_z, normal, guide, stride: int, anti_firefly_first: bool):
    """Plain version of the per-pass a-trous kernel (JAX denoise_kernels.py::
    atrous_single_pass): the anti-firefly clamp when asked, then one
    guided pass at `stride`."""
    return atrous_pass(anti_firefly(img) if anti_firefly_first else img, view_z, normal, stride,
                       guide)


# The largest a-trous stride: the sharded denoise extends z, the normal and
# the guide of each slab by this many rows, once a frame, for all passes.
ATROUS_REACH = 1 << (ATROUS_PASSES - 1)


def pass_halo(row0: int, rows: int, global_h: int, reach: int):
    """(rows above, rows below): the frame rows within `reach` of the slab
    of `rows` rows from frame row `row0`, cut at the frame's edges."""
    return min(reach, row0), min(reach, global_h - row0 - rows)


def atrous_pass_slab(img, above, below, view_z, normal, guide, row0: int, global_h: int,
                     stride: int, anti_firefly_first: bool):
    """Plain version of the per-pass kernel's slab form: the pass on the
    slab img [6,rows,W], frame rows [row0, row0 + rows) of a global_h-row
    frame. above and below [6,n,W] hold the frame rows next to it, n from
    pass_halo with the pass's reach (stride, one more with the clamp);
    view_z [R,W], normal [3,R,W] and guide [2,R,W] the slab's rows extended
    by ATROUS_REACH rows on each side, cut at the frame's edges. Returns
    [6,rows,W], those rows of atrous_single_pass on the whole frame bit for
    bit: the frame's own edge padding at its edges, whole rows elsewhere."""
    rows = img.shape[1]
    ext = torch.cat([above, img, below], dim=1)  # frame rows from row0 - above rows
    if anti_firefly_first:
        ext = anti_firefly(ext)
    e0, a0 = row0 - above.shape[1], max(row0 - ATROUS_REACH, 0)
    lo, hi = max(row0 - stride, 0), min(row0 + rows + stride, global_h)
    out = atrous_single_pass(ext[:, lo - e0:hi - e0], view_z[lo - a0:hi - a0],
                             normal[:, lo - a0:hi - a0], guide[:, lo - a0:hi - a0], stride, False)
    return out[:, row0 - lo:row0 - lo + rows]


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


def _hitdist_planes(gbuf_cf):
    """[8,H,W]: the diffuse and specular (rgb, hit distance) planes, a view
    where they lie adjacent in one buffer (K9's output), else joined."""
    d, s = gbuf_cf.diffuse_hitdist, gbuf_cf.specular_hitdist
    if (d.is_contiguous() and s.is_contiguous() and s.shape == d.shape
            and d.untyped_storage().data_ptr() == s.untyped_storage().data_ptr()
            and s.data_ptr() == d.data_ptr() + d.nbytes):
        return d.as_strided((8,) + tuple(d.shape[1:]), d.stride())
    return torch.cat([d, s], dim=0)


def denoise_frame_cf(gbuf_cf, state: DenoiserStateCF):
    """The frame's denoise: the prepass (K10), K2, K3 (with guide and
    anti-firefly), K4. Returns (diffuse [3,H,W], specular [3,H,W], shadow
    [2,H,W], new state). Spans: rtvs.denoise, with .prepass (K10),
    .reproject (K2), .guide (decode and guide), .atrous (K3) and .shadow
    (K4)."""
    from ..ops.cuda import denoise_kernels as dk

    with annotate("rtvs.denoise"):
        with annotate("rtvs.denoise.prepass"):
            sqrt_rough = gbuf_cf.normal_roughness[3]
            curr = dk.reblur_prepass(_hitdist_planes(gbuf_cf), gbuf_cf.view_z, sqrt_rough)
        with annotate("rtvs.denoise.reproject"):
            new_packed = dk.reproject_accumulate(state.packed, curr, gbuf_cf.motion,
                                                 gbuf_cf.view_z, torch.square(sqrt_rough),
                                                 gbuf_cf.motion_spec)
        with annotate("rtvs.denoise.guide"):
            normal = decode_oct_cf(gbuf_cf.normal_roughness)
            guide = guide_cf(new_packed, gbuf_cf.view_z, sqrt_rough)
        with annotate("rtvs.denoise.atrous"):
            out_ds = dk.atrous(torch.cat([new_packed[0:3], new_packed[4:7]], dim=0),
                               gbuf_cf.view_z, normal, guide)
        with annotate("rtvs.denoise.shadow"):
            out_shadow = dk.shadow_denoise(gbuf_cf.shadow_data, gbuf_cf.obj_id, gbuf_cf.view_z,
                                           normal)
    return out_ds[0:3], out_ds[3:6], out_shadow, DenoiserStateCF(packed=new_packed)


# ---- row-sharded denoise with halo-row exchange ------------------------------
#
# The denoiser is the frame's only cross-pixel stage, so it is the only
# place where row slabs read each other's rows: each slab is extended by
# its neighbours' boundary rows, filtered, and cropped back (the a-trous
# passes: read with its neighbours' rows in place), which gives the whole
# frame's result bit for bit (JAX post/denoise.py:758-1057, the lane path's
# halos).

# The reprojection reaches at most MV_CLAMP_PIXELS (64) rows plus the
# bilinear +1 tap
TEMPORAL_HALO = 72
# reblur_prepass reaches 7 rows (the specular prepass's outer ring)
PREPASS_HALO = 8
SHADOW_HALO = SHADOW_RADIUS


def exchange_row_halo(slabs, halo: int):
    """Each of the equal row slabs [c, rows, W] (in frame order, each on its
    own device) extended to [c, rows + 2 halo, W] by its neighbours' rows,
    copied with .to(slab.device); a halo past one slab reaches across
    several. At the frame's top and bottom the edge rows replicate, as the
    whole frame's edge padding (JAX exchange_row_halo)."""
    n, rows = len(slabs), slabs[0].shape[1]
    last = n * rows - 1
    out = []
    for i, slab in enumerate(slabs):
        if halo == 0:
            out.append(slab)
            continue
        rows_above = [min(max(g, 0), last) for g in range(i * rows - halo, i * rows)]
        rows_below = [min(max(g, 0), last) for g in range((i + 1) * rows, (i + 1) * rows + halo)]
        out.append(torch.cat(_gather_rows(slabs, rows, rows_above, slab.device) + [slab]
                             + _gather_rows(slabs, rows, rows_below, slab.device), dim=1))
    return out


def _gather_rows(slabs, rows, global_rows, device):
    """The frame rows `global_rows` (ascending, an edge row repeated where
    the frame ends), a view or a broadcast a run, on `device`: no index
    tensor, so no copy from the host."""
    pieces, k = [], 0
    while k < len(global_rows):
        g = global_rows[k]
        e = k + 1
        if e < len(global_rows) and global_rows[e] == g:  # a replicated edge row
            while e < len(global_rows) and global_rows[e] == g:
                e += 1
            src = slabs[g // rows][:, g % rows:g % rows + 1]
            pieces.append(src.expand(-1, e - k, *src.shape[2:]).to(device))
        else:
            while (e < len(global_rows) and global_rows[e] == global_rows[e - 1] + 1
                   and global_rows[e] // rows == g // rows):
                e += 1
            a = g % rows
            pieces.append(slabs[g // rows][:, a:a + e - k].to(device))
        k = e
    return pieces


def _frame_halo(slabs, i: int, n_above: int, n_below: int):
    """(above, below): the n_above frame rows just above slab i and the
    n_below just below it, on its device, each a view of its neighbour's
    rows (.to() copies them to another device) or, where it reaches over
    several slabs, their rows joined."""
    rows, slab = slabs[0].shape[1], slabs[i]

    def piece(global_rows):
        if not global_rows:
            return slab[:, :0]
        parts = _gather_rows(slabs, rows, global_rows, slab.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    row0 = i * rows
    return (piece(list(range(row0 - n_above, row0))),
            piece(list(range(row0 + rows, row0 + rows + n_below))))


def denoise_frame_sharded_cf(gbufs, states, global_h: int):
    """The frame's denoise over row slabs: gbufs and states are each slab's
    channel-first G-buffer and DenoiserStateCF, in frame order, each on its
    slab's device; global_h the frame's height. Runs stage by stage over all
    slabs with a halo exchange before each stage that reads across a cut:
    the prepass (K10 on the slab extended by PREPASS_HALO rows), K2 on the
    history extended by TEMPORAL_HALO rows (its slab form), the a-trous
    passes one launch each (the per-pass kernel's slab form: each slab read
    where it lies, its neighbours' `stride` rows, one more on pass 0 for
    the anti-firefly clamp, as views; z, the normals and the guide extended
    by ATROUS_REACH rows once a frame) and K4 (SHADOW_HALO rows). Returns per-slab lists
    (diffuse [3,rows,W], specular [3,rows,W], shadow [2,rows,W], new
    state), each slab equal to those rows of denoise_frame_cf on the whole
    frame."""
    from ..ops.cuda import denoise_kernels as dk

    rows = gbufs[0].view_z.shape[0]
    row0s = [i * rows for i in range(len(gbufs))]
    packed_ext = exchange_row_halo([s.packed for s in states], TEMPORAL_HALO)
    pp = exchange_row_halo([torch.cat([g.diffuse_hitdist, g.specular_hitdist, g.view_z[None],
                                       g.normal_roughness[3:4]], dim=0) for g in gbufs],
                           PREPASS_HALO)
    packed, normals, guides = [], [], []
    for g, ext, ppe, row0 in zip(gbufs, packed_ext, pp, row0s):
        curr = dk.reblur_prepass(ppe[0:8], ppe[8], ppe[9])[:, PREPASS_HALO:PREPASS_HALO + rows]
        sqrt_rough = g.normal_roughness[3]
        new_packed = dk.reproject_accumulate(ext, curr.contiguous(), g.motion, g.view_z,
                                             torch.square(sqrt_rough), g.motion_spec,
                                             TEMPORAL_HALO, row0, global_h)
        packed.append(new_packed)
        normals.append(decode_oct_cf(g.normal_roughness))
        guides.append(guide_cf(new_packed, g.view_z, sqrt_rough))
    six = [torch.cat([p[0:3], p[4:7]], dim=0) for p in packed]
    # z, the normal and the guide, extended once a frame by ATROUS_REACH rows
    own = [torch.cat([g.view_z[None], n, gd], dim=0) for g, n, gd in zip(gbufs, normals, guides)]
    aux = []
    for i, row0 in enumerate(row0s):
        above, below = _frame_halo(own, i, *pass_halo(row0, rows, global_h, ATROUS_REACH))
        aux.append(torch.cat([above, own[i], below], dim=1))
    for p in range(ATROUS_PASSES):
        stride, clamp = 1 << p, p == 0
        halo = [pass_halo(row0, rows, global_h, stride + (1 if clamp else 0)) for row0 in row0s]
        six = [dk.atrous_pass_slab(six[i], *_frame_halo(six, i, *halo[i]), a[0], a[1:4], a[4:6],
                                   row0, global_h, stride, clamp)
               for i, (a, row0) in enumerate(zip(aux, row0s))]
    she = exchange_row_halo([torch.cat([g.shadow_data, g.obj_id.to(F32)[None], g.view_z[None], n],
                                       dim=0) for g, n in zip(gbufs, normals)], SHADOW_HALO)
    shadows = [dk.shadow_denoise(e[0:2], e[2].to(torch.int32), e[3], e[4:7])
               [:, SHADOW_HALO:SHADOW_HALO + rows] for e in she]
    return ([s[0:3] for s in six], [s[3:6] for s in six], shadows,
            [DenoiserStateCF(packed=p) for p in packed])
