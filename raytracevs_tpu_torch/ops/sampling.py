"""Stateless RNG and sampling, bit-exact with raytracevs_tpu/ops/sampling.py.

The reference's PCG-hash RNG with per-decision salt channels
(src/Shader/Common.hlsli:611-618, 761-797, 832-874, 1086-1091). PyTorch has
no full uint32 arithmetic, so a u32 value lives in an int64 tensor and every
product or sum is masked with ``& 0xFFFFFFFF`` (no product here exceeds
2**62, so int64 never overflows). The blue-noise tile is the reference's
Resource/Texture/BlueNoise16.png, shipped in this package.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import vec

_M32 = 0xFFFFFFFF
_TWO_PI = 6.28318530718


def u32(x, device=None):
    """A u32 value as an int64 tensor (python ints and tensors alike)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _M32


def pcg_hash(v):
    """PCG-inspired hash (Common.hlsli:773-778). v: u32 in int64."""
    v = (v * 747796405 + 2891336453) & _M32
    word = (((v >> ((v >> 28) + 4)) ^ v) * 277803737) & _M32
    return (word >> 22) ^ word


def wang_hash(seed):
    """WangHash (Common.hlsli:762-770)."""
    seed = seed & _M32
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & _M32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & _M32
    seed = seed ^ (seed >> 15)
    return seed


def rng_init(pixel_x, pixel_y, frame, sample, salt):
    """rng_init (Common.hlsli:785-791): returns the u32 state."""
    s = (u32(pixel_x) * 1973 + u32(pixel_y) * 9277 + u32(frame) * 26699
         + u32(sample) * 31837 + int(salt) * 911) & _M32
    return pcg_hash(s)


def u24_to_float(state):
    """The top 24 bits of a u32 state as a float in [0, 1)."""
    return (state >> 8).to(torch.float32) * (1.0 / 16777216.0)


def rng_next(state):
    """rng_next (Common.hlsli:793-797): (new_state, float in [0,1))."""
    state = pcg_hash(state)
    return state, u24_to_float(state)


# RandomFloat (Common.hlsli:833-837) has identical semantics to rng_next.
random_float = rng_next


def masked_rng_next(state, active):
    """rng_next that advances the state only where `active`."""
    new = pcg_hash(state)
    return torch.where(active, new, state), u24_to_float(new)


def random_on_disk(state):
    """RandomOnDisk (Common.hlsli:1086-1091)."""
    state, u1 = random_float(state)
    state, u2 = random_float(state)
    r = torch.sqrt(u1)
    theta = u2 * _TWO_PI
    return state, torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def random_on_sphere(state):
    """RandomOnSphere (Common.hlsli:840-846)."""
    state, z0 = random_float(state)
    state, p0 = random_float(state)
    z = z0 * 2.0 - 1.0
    phi = p0 * _TWO_PI
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return state, torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _pick_axis(mask, d, a, b):
    """[...,3] constant axis a where mask else b, shaped like d."""
    return torch.where(mask[..., None], vec.const3(*a, like=d), vec.const3(*b, like=d)).expand_as(d)


def build_orthonormal_basis(direction):
    """BuildOrthonormalBasis (Common.hlsli:1094-1099). direction: [...,3]."""
    d = direction
    up = _pick_axis(torch.abs(d[..., 1]) < 0.999, d, (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))
    tangent = vec.normalize(vec.cross(up, d))
    bitangent = vec.cross(d, tangent)
    return tangent, bitangent


def cosine_sample_hemisphere(normal, state):
    """CosineSampleHemisphere (Common.hlsli:856-874)."""
    state, u1 = random_float(state)
    state, u2 = random_float(state)
    r = torch.sqrt(u1)
    theta = _TWO_PI * u2
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    tangent, bitangent = build_orthonormal_basis(normal)
    d = tangent * x[..., None] + bitangent * y[..., None] + normal * z[..., None]
    return state, vec.normalize(d)


def perturb_reflection(reflect_dir, normal, roughness, state):
    """PerturbReflection (Common.hlsli:804-830): consumes two randoms and
    returns (state, direction); roughness < 0.01 keeps reflect_dir."""
    state, r1 = random_float(state)
    state, r2 = random_float(state)
    n = normal
    t0 = _pick_axis(torch.abs(n[..., 0]) > 0.9, n, (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))
    tangent = vec.normalize(vec.cross(n, t0))
    bitangent = vec.cross(n, tangent)
    angle = r1 * 6.28318
    radius = roughness * roughness * r2
    offset = (torch.cos(angle)[..., None] * tangent
              + torch.sin(angle)[..., None] * bitangent) * radius[..., None]
    perturbed = vec.normalize(reflect_dir + offset)
    pdn = vec.dot(perturbed, n)
    reflected = perturbed - (2.0 * pdn)[..., None] * n
    perturbed = vec.where3(pdn < 0.0, reflected, perturbed)
    return state, vec.where3(roughness < 0.01, reflect_dir, perturbed)


def sample_spherical_light(light_center, light_radius, hit_pos, state):
    """SampleSphericalLight (Common.hlsli:1102-1116)."""
    state, disk = random_on_disk(state)
    to_light = vec.normalize(light_center - hit_pos)
    tangent, bitangent = build_orthonormal_basis(to_light)
    offset = (tangent * disk[..., 0:1] + bitangent * disk[..., 1:2]) * light_radius[..., None]
    return state, light_center + offset


_BLUE_NOISE_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "resources", "BlueNoise16.png")


@functools.lru_cache(maxsize=1)
def _blue_noise_numpy() -> np.ndarray:
    from ..io.png import read_png

    rgba = read_png(_BLUE_NOISE_ASSET)
    if rgba.shape != (16, 16, 4):
        raise ValueError(f"{_BLUE_NOISE_ASSET}: expected 16x16 RGBA, got {rgba.shape}")
    # R8G8B8A8_UNORM (DXRPipeline.cpp:1613): float = v / 255
    return rgba.astype(np.float32) / np.float32(255.0)


def blue_noise_tile(device) -> torch.Tensor:
    """The reference's 16x16x4 blue-noise tile, float32 on `device`. A CUDA
    device gets it from pinned memory without blocking: the tables are
    packed every frame, and a pageable upload would wait on the device."""
    tile = _blue_noise_numpy()
    if torch.device(device).type == "cuda":
        return torch.from_numpy(tile).pin_memory().to(device, non_blocking=True)
    return torch.from_numpy(tile.copy()).to(device)


def sample_blue_noise(tile, pixel_x, pixel_y, frame, sample_index):
    """SampleBlueNoise (RayGen.hlsl:9-15): scrolling 16x16 tile lookup."""
    ox = u32(frame) * 3 + u32(sample_index) * 11
    oy = u32(frame) * 5 + u32(sample_index) * 7
    px = (u32(pixel_x) + ox) & 15
    py = (u32(pixel_y) + oy) & 15
    return tile[py, px]
