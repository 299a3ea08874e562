"""Tone mapping and gamma (src/Shader/Composite.hlsl:63-100, 456-486).

Restates raytracevs_tpu/post/tonemap.py on tensors.
"""
from __future__ import annotations

import torch

from .. import constants as C


def reinhard(color):
    """ReinhardToneMap (Composite.hlsl:68-71)."""
    return color / (1.0 + color)


def aces_film(x):
    """ACESFilm approximation (Composite.hlsl:75-83)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def linear_to_srgb(color):
    """Exact sRGB OETF (Composite.hlsl:86-94)."""
    lo = 12.92 * color
    hi = 1.055 * torch.pow(torch.clamp(color, min=1e-12), 1.0 / 2.4) - 0.055
    return torch.where(color < 0.0031308, lo, hi)


def apply_gamma(color, gamma):
    """Custom power gamma (Composite.hlsl:97-100)."""
    return torch.pow(torch.clamp(color, min=0.0), 1.0 / gamma)


def tonemap_and_gamma(color, exposure, tone_map_operator, gamma):
    """Exposure -> tonemap (0 Reinhard, 1 ACES, 2 none) -> gamma, matching
    CSMain (Composite.hlsl:456-486); gamma 2.2 (within tolerance) uses the
    exact sRGB curve. The scene scalars are 0-d tensors."""
    x = color * exposure
    mapped = torch.where(tone_map_operator < 1, reinhard(x),
                         torch.where(tone_map_operator < 2, aces_film(x), x))
    mapped = torch.clamp(mapped, 0.0, 1.0)
    is_srgb = torch.abs(gamma - C.GAMMA_SRGB_STANDARD) < C.GAMMA_SRGB_TOLERANCE
    return torch.where(is_srgb, linear_to_srgb(mapped), apply_gamma(mapped, gamma))


def to_rgba8_cf(color01_cf):
    """[3,H,W] in [0,1] -> [H,W,4] uint8 RGBA (alpha 255)."""
    rgb = torch.clamp(color01_cf * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8).permute(1, 2, 0)
    alpha = torch.full(rgb.shape[:2] + (1,), 255, dtype=torch.uint8, device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)
