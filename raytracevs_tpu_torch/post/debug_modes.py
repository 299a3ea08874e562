"""Composite debug visualization modes (src/Shader/Composite.hlsl:184-371,
487-506).

Restates raytracevs_tpu/post/debug_modes.py on the port's channel-first
planes: the same images, computed in plain PyTorch from the G-buffer
[C,H,W] planes (no lane interleave). Mode numbers match the reference's
CompositeConstants.DebugMode: 1 the G-buffer tile strip, 2-4 the shadow
input, denoised and split, 5 the magenta fill, 6-8 the diffuse taps, 9/10
the photon views; every mode > 0 draws the photon capacity bar when a
photon map is on.
"""
from __future__ import annotations

import torch

from .. import constants as C
from ..ops import vec
from . import tonemap

F32 = torch.float32


def _const3(x, y, z, like):
    return torch.tensor([x, y, z], dtype=F32, device=like.device)[:, None, None]


def _heatmap(t):
    """Heatmap (Composite.hlsl:108-123). t [H,W] -> [3,H,W]."""
    t = torch.clamp(t, 0.0, 1.0)
    c = [_const3(*v, like=t) for v in ((0.0, 0.0, 0.2), (0.0, 0.4, 1.0), (0.0, 1.0, 0.2),
                                       (1.0, 1.0, 0.0), (1.0, 0.2, 0.0))]

    def seg(a, b, lo):
        f = ((t - lo) / 0.25)[None]
        return a + (b - a) * f

    return torch.where((t < 0.25)[None], seg(c[0], c[1], 0.0),
                       torch.where((t < 0.5)[None], seg(c[1], c[2], 0.25),
                                   torch.where((t < 0.75)[None], seg(c[2], c[3], 0.5),
                                               seg(c[3], c[4], 0.75))))


def _visualize_depth(view_z):
    """VisualizeDepth (Composite.hlsl:130-147): near blue, mid green, far red."""
    nd = torch.clamp(vec.div_const(view_z, 100.0), 0.0, 1.0)
    lo = torch.stack([torch.zeros_like(nd), nd * 2.0, 1.0 - nd * 2.0], dim=0)
    t = (nd - 0.5) * 2.0
    hi = torch.stack([t, 1.0 - t, torch.zeros_like(nd)], dim=0)
    return torch.where((nd < 0.5)[None], lo, hi)


def _visualize_motion(mv):
    """VisualizeMotionVectors (Composite.hlsl:150-155). mv [2,H,W]."""
    scaled = mv * 10.0
    return torch.stack([torch.abs(scaled[0]), torch.abs(scaled[1]),
                        torch.full(mv.shape[1:], 0.5, dtype=F32, device=mv.device)], dim=0)


def _visualize_normal(nr):
    """VisualizeNormal (Composite.hlsl:158-164). nr [4,H,W]."""
    n = nr[:3] * 2.0 - 1.0
    return n * 0.5 + 0.5


def composite_debug(mode: int, gbuffer, denoised_diffuse=None, denoised_specular=None,
                    denoised_shadow=None, exposure=1.0, photon_map_size: int = 0,
                    max_photons: int = C.MAX_PHOTONS, debug_tile_scale: float = 0.15):
    """A debug visualization of the channel-first G-buffer (ops/render_cf.py::
    GBufferCF) and the denoiser's outputs ([3,H,W], [3,H,W], [2,H,W], or
    None for the inputs); returns [3,H,W] display-ready colour. mode follows
    Composite.hlsl's DebugMode switch (modes 1-10)."""
    height, width = gbuffer.view_z.shape
    dev = gbuffer.view_z.device
    diffuse_in = gbuffer.diffuse_hitdist[:3]
    specular_in = gbuffer.specular_hitdist[:3]
    nr = gbuffer.normal_roughness
    view_z = gbuffer.view_z
    motion = gbuffer.motion
    albedo = gbuffer.albedo[:3]
    shadow = gbuffer.shadow_data
    dd = denoised_diffuse if denoised_diffuse is not None else diffuse_in
    ds = denoised_specular if denoised_specular is not None else specular_in
    dsh = denoised_shadow if denoised_shadow is not None else shadow

    srgb = tonemap.linear_to_srgb
    aces = tonemap.aces_film
    ys = torch.arange(height, device=dev, dtype=torch.int32)[:, None].expand(height, width)
    xs = torch.arange(width, device=dev, dtype=torch.int32)[None, :].expand(height, width)

    def grey(v):
        return srgb(torch.stack([v, v, v], dim=0))

    if mode == 2:  # input shadow visibility (Composite.hlsl:193-198)
        out = grey(shadow[1])
    elif mode == 3:  # denoised shadow (Composite.hlsl:200-205)
        out = grey(dsh[1])
    elif mode == 4:  # split input | denoised shadow (Composite.hlsl:207-221)
        out = grey(torch.where(xs < width // 2, shadow[1], dsh[1]))
    elif mode == 5:  # solid magenta sanity fill (Composite.hlsl:223-227)
        out = _const3(1.0, 0.0, 1.0, like=view_z).expand(3, height, width)
    elif mode == 6:  # denoised diffuse only (Composite.hlsl:229-235)
        out = srgb(aces(dd * exposure))
    elif mode == 7:  # diffuse * albedo (Composite.hlsl:237-244)
        out = srgb(aces(dd * albedo * exposure))
    elif mode in (8, 9):  # raw diffuse input, photon contribution (Composite.hlsl:246-260)
        out = srgb(aces(diffuse_in * exposure))
    elif mode == 10:  # photon heatmap (Composite.hlsl:262-269)
        lum = diffuse_in[0] * 0.2126 + diffuse_in[1] * 0.7152 + diffuse_in[2] * 0.0722
        mapped = torch.log2(1.0 + lum * 4.0) / 4.0
        out = srgb(_heatmap(mapped))
    elif mode == 1:  # G-buffer tile strip along the bottom (Composite.hlsl:282-371)
        out = srgb(torch.clamp(dd, 0.0, 1.0))
        tile_h = max(int(height * debug_tile_scale), 8)
        area_y = height - tile_h - 10
        in_strip = ys > area_y
        tile_idx = xs // tile_h
        local_x = vec.div_const((xs % tile_h).to(F32), float(tile_h))
        local_y = vec.div_const((ys - area_y).to(F32), float(tile_h))
        # nearest-neighbour sample of each buffer at tile-local uv
        sy = torch.clamp((local_y * height).to(torch.int32), 0, height - 1).long()
        sx = torch.clamp((local_x * width).to(torch.int32), 0, width - 1).long()

        def at(p):
            return p[:, sy, sx]

        tiles = [
            torch.clamp(at(diffuse_in), 0.0, 1.0),     # 0 input diffuse
            torch.clamp(at(specular_in), 0.0, 1.0),    # 1 input specular
            torch.clamp(at(dd), 0.0, 1.0),             # 2 denoised diffuse
            torch.clamp(at(ds), 0.0, 1.0),             # 3 denoised specular
            _visualize_normal(at(nr)),                 # 4 normal+roughness
            _visualize_depth(view_z[sy, sx]),          # 5 viewZ
            _visualize_motion(at(motion)),             # 6 motion vectors
            at(shadow[1:2]).expand(3, height, width),  # 7 input shadow
            at(dsh[1:2]).expand(3, height, width),     # 8 denoised shadow
        ]
        tile_color = torch.zeros((3, height, width), dtype=F32, device=dev)
        for i, t in enumerate(tiles):
            tile_color = torch.where((tile_idx == i)[None], t, tile_color)
        border = (local_x < 0.01) | (local_x > 0.99) | (local_y < 0.01) | (local_y > 0.99)
        tile_color = torch.where(border[None], 1.0, tile_color)
        out = torch.where(in_strip[None], srgb(tile_color), out)
    else:
        out = srgb(torch.clamp(dd, 0.0, 1.0))

    # Photon capacity overlay bar (Composite.hlsl:487-506)
    if mode > 0 and max_photons > 0 and photon_map_size > 0:
        bar_w = max(64, width // 5)
        bar_h = 8
        in_bar = (xs < bar_w) & (ys < bar_h)
        ratio = min(photon_map_size / max_photons, 1.0)
        filled = int(round(ratio * bar_w))
        green, red = _const3(0.1, 0.9, 0.1, like=view_z), _const3(0.9, 0.1, 0.1, like=view_z)
        fill_color = green + (red - green) * ratio
        bar = torch.where((xs < filled)[None], fill_color, _const3(0.05, 0.05, 0.05, like=view_z))
        out = torch.where(in_bar[None], bar, out)
    return out
