"""SceneData -> FlatScene: padded numpy tables, and tensors on a device.

The host half of DXRPipeline::UpdateSceneData
(src/RayTraceVS.DXEngine/DXRPipeline.cpp:709-1270), restated from
raytracevs_tpu/scene/flatten.py with numpy leaves: the scene becomes padded
structure-of-arrays tables with validity masks. ``to_device`` turns every
leaf into a tensor on one device; the renderer reads those.

Primitive index convention matches the reference's procedural BLAS ordering
(AccelerationStructure.cpp:107-300): global primitive index =
spheres ++ planes ++ boxes; the combined material table is indexed the same
way so a hit's (type, index) resolves materials with one gather.

Triangle meshes are not part of this port yet: a scene holding a
``MeshObjectData`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from .data import LightType, MeshObjectData, SceneData


def _pad_capacity(n: int, minimum: int) -> int:
    """Next power-of-two capacity >= n, at least `minimum`; 0 stays 0."""
    if n == 0:
        return 0
    cap = max(1, minimum)
    while cap < n:
        cap *= 2
    return cap


class FlatScene(NamedTuple):
    """Padded SoA scene tables. Leaves are numpy arrays after
    ``flatten_scene`` and tensors after ``to_device``."""

    # Spheres (SphereData, Common.hlsli:302-319)
    sph_center: object  # [S,3] f32
    sph_radius: object  # [S] f32
    sph_valid: object  # [S] bool
    # Planes (Common.hlsli:322-337)
    pln_position: object  # [P,3]
    pln_normal: object  # [P,3]
    pln_valid: object  # [P]
    # Boxes / OBB (Common.hlsli:340-367)
    box_center: object  # [B,3]
    box_half: object  # [B,3] half extents
    box_axes: object  # [B,3,3] rows = axisX/axisY/axisZ in world space
    box_valid: object  # [B]
    # Combined material table, indexed spheres ++ planes ++ boxes [M]
    mat_color: object  # [M,4]
    mat_metallic: object  # [M]
    mat_roughness: object  # [M]
    mat_transmission: object  # [M]
    mat_ior: object  # [M]
    mat_specular: object  # [M]
    mat_emission: object  # [M,3]
    mat_absorption: object  # [M,3]
    # Lights (Common.hlsli:370-379); directional stores its direction in
    # the position slot (SceneEvaluator.cs:411-436)
    lt_type: object  # [L] i32
    lt_position: object  # [L,3]
    lt_color: object  # [L,4]
    lt_intensity: object  # [L]
    lt_radius: object  # [L]
    lt_samples: object  # [L]
    lt_valid: object  # [L]
    num_lights: object  # i32 scalar
    # Camera basis (DXRPipeline.cpp:730-766)
    cam_pos: object  # [3]
    cam_forward: object  # [3]
    cam_right: object  # [3]
    cam_up: object  # [3]
    tan_half_fov: object  # f32 scalar
    aperture_size: object
    focus_distance: object
    # Scene-carried render parameters (SceneConstantBuffer fields)
    exposure: object
    tone_map_operator: object  # i32: 0 Reinhard, 1 ACES, 2 None
    shadow_strength: object
    shadow_absorption_scale: object
    gamma: object
    atten_const: object
    atten_linear: object
    atten_quadratic: object
    max_shadow_lights: object  # i32
    nrd_bypass_distance: object
    nrd_bypass_blend: object
    frame_index: object  # u32 (int64 once on a device)
    # Row-vector view-projection matrices (DXRPipeline.cpp:794-804)
    view_proj: object  # [4,4]
    prev_view_proj: object  # [4,4]

    @property
    def sphere_capacity(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def plane_capacity(self) -> int:
        return self.pln_normal.shape[0]

    @property
    def box_capacity(self) -> int:
        return self.box_half.shape[0]

    @property
    def light_capacity(self) -> int:
        return self.lt_type.shape[0]


class RenderConfig(NamedTuple):
    """Static render configuration (same fields and defaults as
    raytracevs_tpu.scene.flatten.RenderConfig)."""

    width: int = 512
    height: int = 512
    samples_per_pixel: int = 1  # effective, after the ray-budget cap
    max_bounces: int = 8  # effective, after clamping
    max_queue_iters: int = 64  # safety bound on the DFS loop
    enable_denoiser: bool = False
    photon_debug_mode: int = 0
    photon_debug_scale: float = 1.0
    num_photons: int = 0  # caustics; the port renders only 0
    has_lights: bool = True
    any_glass: bool = True
    any_metal: bool = True
    any_absorption: bool = True
    max_soft_samples: int = 1  # unroll bound for soft-shadow sampling

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height


def effective_budget(spp: int, max_bounces: int) -> tuple:
    """Apply the reference's TDR ray budget (RayGen.hlsl:69-77)."""
    sample_count = min(max(int(spp), 1), C.MAX_SPP)
    mb = min(int(max_bounces), C.MAX_BOUNCES_CLAMP) if max_bounces > 0 else C.DEFAULT_MAX_BOUNCES
    if sample_count * mb > C.MAX_RAYS_PER_PIXEL:
        sample_count = max(1, C.MAX_RAYS_PER_PIXEL // mb)
    return sample_count, mb


def camera_basis(position, look_at, up):
    """Right-handed camera basis (DXRPipeline.cpp:736-747)."""
    pos = np.asarray(position, dtype=np.float64)
    fwd = np.asarray(look_at, dtype=np.float64) - pos
    n = np.linalg.norm(fwd)
    fwd = fwd / n if n > 1e-12 else np.array([0.0, 0.0, 1.0])
    right = np.cross(np.asarray(up, dtype=np.float64), fwd)
    n = np.linalg.norm(right)
    right = right / n if n > 1e-12 else np.array([1.0, 0.0, 0.0])
    real_up = np.cross(fwd, right)
    n = np.linalg.norm(real_up)
    real_up = real_up / n if n > 1e-12 else np.array([0.0, 1.0, 0.0])
    return fwd, right, real_up


def look_at_lh(eye, focus, up) -> np.ndarray:
    """XMMatrixLookAtLH (row-vector convention), Camera.cpp:26-33."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(focus, np.float64) - eye
    zn = np.linalg.norm(z)
    z = z / zn if zn > 1e-12 else np.array([0.0, 0.0, 1.0])
    x = np.cross(np.asarray(up, np.float64), z)
    xn = np.linalg.norm(x)
    x = x / xn if xn > 1e-12 else np.array([1.0, 0.0, 0.0])
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[3, 0] = -np.dot(x, eye)
    m[3, 1] = -np.dot(y, eye)
    m[3, 2] = -np.dot(z, eye)
    return m


def perspective_fov_lh(fov_deg: float, aspect: float, zn: float = 0.1, zf: float = 1000.0):
    """XMMatrixPerspectiveFovLH (row-vector convention), Camera.cpp:35-39."""
    h = 1.0 / math.tan(math.radians(fov_deg) * 0.5)
    w = h / aspect
    m = np.zeros((4, 4))
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = zf / (zf - zn)
    m[2, 3] = 1.0
    m[3, 2] = -zn * zf / (zf - zn)
    return m


def view_projection(scene: SceneData, aspect: float) -> np.ndarray:
    cam = scene.camera
    return look_at_lh(cam.position, cam.look_at, cam.up) @ perspective_fov_lh(
        cam.field_of_view, aspect
    )


def flatten_scene(scene: SceneData, *, frame_index: int = 0,
                  aspect: float = 16.0 / 9.0,
                  prev_view_proj: np.ndarray = None) -> FlatScene:
    """Build the numpy FlatScene from an evaluated, sanitized SceneData."""
    if any(isinstance(o, MeshObjectData) for o in scene.objects):
        raise NotImplementedError("mesh: not ported yet")
    f32 = np.float32
    spheres = scene.spheres
    planes = scene.planes
    boxes = scene.boxes

    s_cap = _pad_capacity(len(spheres), 2)
    p_cap = _pad_capacity(len(planes), 1)
    b_cap = _pad_capacity(len(boxes), 2)
    l_cap = _pad_capacity(len(scene.lights), 2)
    m_cap = max(1, s_cap + p_cap + b_cap)

    sph_center = np.zeros((s_cap, 3), f32)
    sph_radius = np.full((s_cap,), 1.0, f32)
    sph_valid = np.zeros((s_cap,), bool)
    pln_position = np.zeros((p_cap, 3), f32)
    pln_normal = np.tile(np.array([0, 1, 0], f32), (p_cap, 1))
    pln_valid = np.zeros((p_cap,), bool)
    box_center = np.zeros((b_cap, 3), f32)
    box_half = np.full((b_cap, 3), 0.5, f32)
    box_axes = np.tile(np.eye(3, dtype=f32), (b_cap, 1, 1))
    box_valid = np.zeros((b_cap,), bool)

    mat_color = np.tile(np.array([0.8, 0.8, 0.8, 1.0], f32), (m_cap, 1))
    mat_metallic = np.zeros((m_cap,), f32)
    mat_roughness = np.full((m_cap,), 0.5, f32)
    mat_transmission = np.zeros((m_cap,), f32)
    mat_ior = np.full((m_cap,), 1.5, f32)
    mat_specular = np.full((m_cap,), 0.5, f32)
    mat_emission = np.zeros((m_cap, 3), f32)
    mat_absorption = np.zeros((m_cap, 3), f32)

    def put_material(slot, m):
        mat_color[slot] = np.asarray(m.base_color, f32)[:4]
        mat_metallic[slot] = m.metallic
        mat_roughness[slot] = m.roughness
        mat_transmission[slot] = m.transmission
        mat_ior[slot] = m.ior
        mat_specular[slot] = m.specular
        mat_emission[slot] = np.asarray(m.emission, f32).ravel()[:3]
        mat_absorption[slot] = np.asarray(m.absorption, f32)[:3]

    for i, s in enumerate(spheres):
        sph_center[i] = np.asarray(s.position, f32)
        sph_radius[i] = s.radius
        sph_valid[i] = True
        put_material(i, s.material)
    for i, p in enumerate(planes):
        pln_position[i] = np.asarray(p.position, f32)
        pln_normal[i] = np.asarray(p.normal, f32)
        pln_valid[i] = True
        put_material(s_cap + i, p.material)
    for i, b in enumerate(boxes):
        box_center[i] = np.asarray(b.center, f32)
        box_half[i] = np.asarray(b.size, f32)
        box_axes[i] = np.stack(
            [np.asarray(b.axis_x, f32), np.asarray(b.axis_y, f32), np.asarray(b.axis_z, f32)]
        )
        box_valid[i] = True
        put_material(s_cap + p_cap + i, b.material)

    lt_type = np.zeros((l_cap,), np.int32)
    lt_position = np.zeros((l_cap, 3), f32)
    lt_color = np.ones((l_cap, 4), f32)
    lt_intensity = np.zeros((l_cap,), f32)
    lt_radius = np.zeros((l_cap,), f32)
    lt_samples = np.ones((l_cap,), f32)
    lt_valid = np.zeros((l_cap,), bool)
    for i, lt in enumerate(scene.lights):
        lt_type[i] = int(lt.type)
        lt_position[i] = np.asarray(
            lt.direction if lt.type == LightType.DIRECTIONAL else lt.position, f32
        )
        lt_color[i] = np.asarray(lt.color, f32)[:4]
        lt_intensity[i] = lt.intensity
        lt_radius[i] = lt.radius
        # the true per-light count (1-16, Common.hlsli:1226); the TDR clamp
        # is the cfg.max_soft_samples unroll bound (see make_config)
        lt_samples[i] = min(max(lt.soft_shadow_samples, 1.0), 16.0)
        lt_valid[i] = True

    fwd, right, up = camera_basis(scene.camera.position, scene.camera.look_at, scene.camera.up)
    st = scene.settings
    vp = view_projection(scene, aspect)
    pvp = vp if prev_view_proj is None else np.asarray(prev_view_proj, np.float64)

    return FlatScene(
        sph_center=sph_center,
        sph_radius=sph_radius,
        sph_valid=sph_valid,
        pln_position=pln_position,
        pln_normal=pln_normal,
        pln_valid=pln_valid,
        box_center=box_center,
        box_half=box_half,
        box_axes=box_axes,
        box_valid=box_valid,
        mat_color=mat_color,
        mat_metallic=mat_metallic,
        mat_roughness=mat_roughness,
        mat_transmission=mat_transmission,
        mat_ior=mat_ior,
        mat_specular=mat_specular,
        mat_emission=mat_emission,
        mat_absorption=mat_absorption,
        lt_type=lt_type,
        lt_position=lt_position,
        lt_color=lt_color,
        lt_intensity=lt_intensity,
        lt_radius=lt_radius,
        lt_samples=lt_samples,
        lt_valid=lt_valid,
        num_lights=np.asarray(len(scene.lights), np.int32),
        cam_pos=np.asarray(scene.camera.position, f32),
        cam_forward=fwd.astype(f32),
        cam_right=right.astype(f32),
        cam_up=up.astype(f32),
        tan_half_fov=np.asarray(
            math.tan(scene.camera.field_of_view * 0.5 * math.pi / 180.0), f32),
        aperture_size=np.asarray(scene.camera.aperture_size, f32),
        focus_distance=np.asarray(scene.camera.focus_distance, f32),
        exposure=np.asarray(st.exposure, f32),
        tone_map_operator=np.asarray(st.tone_map_operator, np.int32),
        shadow_strength=np.asarray(st.shadow_strength, f32),
        shadow_absorption_scale=np.asarray(st.shadow_absorption_scale, f32),
        gamma=np.asarray(st.gamma, f32),
        atten_const=np.asarray(st.light_attenuation_constant, f32),
        atten_linear=np.asarray(st.light_attenuation_linear, f32),
        atten_quadratic=np.asarray(st.light_attenuation_quadratic, f32),
        max_shadow_lights=np.asarray(st.max_shadow_lights, np.int32),
        nrd_bypass_distance=np.asarray(st.nrd_bypass_distance, f32),
        nrd_bypass_blend=np.asarray(st.nrd_bypass_blend_range, f32),
        frame_index=np.asarray(frame_index, np.uint32),
        view_proj=np.asarray(vp, f32),
        prev_view_proj=np.asarray(pvp, f32),
    )


def to_device(flat: FlatScene, device) -> FlatScene:
    """The same FlatScene with every leaf a tensor on `device` (the u32
    frame index widens to int64, which holds every u32 exactly)."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(a.copy()).to(device)  # copy: contiguous, keeps 0-d

    return FlatScene(*(conv(leaf) for leaf in flat))


def make_config(scene: SceneData, width: int, height: int, **overrides) -> RenderConfig:
    """Static render configuration for a scene (raytracevs_tpu make_config
    semantics). Caustics and the photon debug modes are not part of this
    port yet: a scene or override that enables them raises."""
    spp, max_bounces = effective_budget(
        scene.settings.samples_per_pixel, scene.settings.max_bounces
    )
    # DFS iteration cap: the reference's own budget (RayGen.hlsl:73)
    max_iters = min(C.MAX_RAYS_PER_PIXEL, 4 * max_bounces + C.WORK_QUEUE_STRIDE)
    mats = [o.material for o in scene.objects if hasattr(o, "material")]
    any_glass = any(m.transmission > 0.01 for m in mats)
    any_metal = any(m.metallic > 0.1 for m in mats)
    any_absorption = any(
        m.transmission > 0.01 and float(np.max(np.asarray(m.absorption)[:3])) > 1e-6
        for m in mats
    )
    if bool(overrides.pop("enable_caustics", scene.settings.enable_caustics)):
        raise NotImplementedError("caustics: not ported yet")
    if int(overrides.get("photon_debug_mode", scene.settings.photon_debug_mode)):
        raise NotImplementedError("photon debug modes: not ported yet")
    cfg = dict(
        width=int(width),
        height=int(height),
        samples_per_pixel=spp,
        max_bounces=max_bounces,
        max_queue_iters=max_iters,
        enable_denoiser=bool(scene.settings.enable_denoiser),
        photon_debug_mode=int(scene.settings.photon_debug_mode),
        photon_debug_scale=float(scene.settings.photon_debug_scale),
        num_photons=0,
        has_lights=len(scene.lights) > 0,
        any_glass=any_glass,
        any_metal=any_metal,
        any_absorption=any_absorption,
        # 1 = the reference's TDR clamp (DXRPipeline.cpp:928); override up
        # to 16 to unlock multi-sample soft shadows
        max_soft_samples=1,
    )
    cfg.update(overrides)
    return RenderConfig(**cfg)
