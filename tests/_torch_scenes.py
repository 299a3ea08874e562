"""Scenes built in code for the port's parity tests.

Every builder takes a package's ``scene.data`` module, so the same literals
build a raytracevs_tpu SceneData and a raytracevs_tpu_torch SceneData. The
demo scene is the slice's workload (chip_smoke.py keeps its own copy of
these literals, because it cannot import this tests helper's JAX side).
"""
import math

import numpy as np

from raytracevs_tpu_torch.scene.transform import euler_deg_to_quat, obb_axes_from_quat

DEMO_OVERRIDES = {"max_soft_samples": 4}
DEMO_LOOK_AT = np.array([0.0, 0.8, 0.6])
DEMO_EYE = np.array([0.0, 1.9, -4.4])


def orbit_eye(frame: int, degrees_per_frame: float = 2.0) -> np.ndarray:
    """The demo camera position after `frame` steps of a y-axis orbit
    around DEMO_LOOK_AT."""
    a = math.radians(degrees_per_frame * frame)
    rel = DEMO_EYE - DEMO_LOOK_AT
    x = rel[0] * math.cos(a) + rel[2] * math.sin(a)
    z = -rel[0] * math.sin(a) + rel[2] * math.cos(a)
    return DEMO_LOOK_AT + np.array([x, rel[1], z])


def demo_scene(D, frame: int = 0):
    """The analytic demo scene: checker plane, mirror sphere, rough metal
    sphere, red absorbing glass sphere, rotated glass OBB; a soft point
    light, a directional light and an ambient light. Default settings
    (spp 2, 6 bounces, denoiser on, tone map 2); render with
    DEMO_OVERRIDES (4 soft-shadow samples)."""
    s = D.SceneData()
    s.camera.position = orbit_eye(frame)
    s.camera.look_at = DEMO_LOOK_AT.copy()
    ax, ay, az = obb_axes_from_quat(euler_deg_to_quat([0.0, 35.0, 10.0]))
    s.objects += [
        D.PlaneData(),
        D.SphereData(position=np.array([-1.7, 1.0, 0.8]), radius=1.0,
                     material=D.MaterialData(base_color=np.array([0.95, 0.95, 0.95, 1.0]),
                                             metallic=1.0, roughness=0.0)),
        D.SphereData(position=np.array([1.7, 0.7, 1.3]), radius=0.7,
                     material=D.MaterialData(base_color=np.array([1.0, 0.78, 0.35, 1.0]),
                                             metallic=1.0, roughness=0.2)),
        D.SphereData(position=np.array([0.3, 0.75, -0.9]), radius=0.75,
                     material=D.MaterialData(base_color=np.array([1.0, 0.35, 0.35, 1.0]),
                                             transmission=0.9, ior=1.5, roughness=0.0,
                                             absorption=np.array([0.1, 1.2, 1.2]))),
        D.BoxData(center=np.array([-0.2, 0.55, 2.4]), size=np.array([0.55, 0.55, 0.35]),
                  axis_x=ax, axis_y=ay, axis_z=az,
                  material=D.MaterialData(base_color=np.array([0.7, 0.85, 1.0, 1.0]),
                                          transmission=0.85, ior=1.45, roughness=0.0,
                                          absorption=np.array([0.9, 0.35, 0.05]))),
    ]
    s.lights += [
        D.LightData(type=D.LightType.POINT, position=np.array([3.0, 5.5, -3.0]),
                    intensity=12.0, radius=0.5, soft_shadow_samples=4),
        D.LightData(type=D.LightType.DIRECTIONAL, direction=np.array([0.4, -1.0, 0.3]),
                    intensity=0.8),
        D.LightData(type=D.LightType.AMBIENT, color=np.array([0.2, 0.2, 0.2, 1.0])),
    ]
    return s


def golden_scene(D, name: str):
    """The analytic golden configs of tests/test_golden.py::_engine_for
    (1, 2, 3 and 6). Returns (SceneData, config overrides)."""
    s = D.SceneData()
    s.camera.position = np.array([0.0, 2.0, -5.0])
    s.camera.look_at = np.array([0.0, 1.0, 0.0])
    s.settings.samples_per_pixel = 2
    s.settings.max_bounces = 6
    s.settings.tone_map_operator = 2
    overrides = {}
    if name == "config1_hard_shadows":
        s.objects += [D.SphereData(position=np.array([0.0, 1.0, 0.0]), radius=1.0), D.PlaneData()]
        s.lights += [D.LightData(type=D.LightType.POINT, position=np.array([3.0, 5.0, -3.0]),
                                 intensity=8.0)]
    elif name == "config2_obb_mirror":
        ax, ay, az = obb_axes_from_quat(euler_deg_to_quat([0, 30, 0]))
        s.objects += [
            D.BoxData(center=np.array([0.0, 1.0, 0.0]), size=np.array([0.6, 1.0, 0.6]),
                      axis_x=ax, axis_y=ay, axis_z=az,
                      material=D.MaterialData(metallic=1.0, roughness=0.0)),
            D.PlaneData(),
        ]
        s.lights += [
            D.LightData(type=D.LightType.DIRECTIONAL, direction=np.array([0.4, -1.0, 0.3]),
                        intensity=1.0),
            D.LightData(type=D.LightType.AMBIENT, color=np.array([0.25, 0.25, 0.25, 1.0])),
        ]
        s.settings.tone_map_operator = 0
    elif name == "config3_glass_soft":
        glass = D.MaterialData(transmission=0.9, ior=1.5, roughness=0.0,
                               absorption=np.array([0.1, 1.2, 1.2]))
        s.objects += [D.SphereData(position=np.array([0.0, 1.2, 0.0]), radius=0.9, material=glass),
                      D.PlaneData()]
        s.lights += [
            D.LightData(type=D.LightType.POINT, position=np.array([2.0, 6.0, -2.0]),
                        intensity=15.0, radius=0.4, soft_shadow_samples=4),
            D.LightData(type=D.LightType.AMBIENT, color=np.array([0.2, 0.2, 0.2, 1.0])),
        ]
    elif name == "config6_soft_shadows":
        s.objects += [D.SphereData(position=np.array([0.0, 1.0, 0.0]), radius=1.0), D.PlaneData()]
        s.lights += [
            D.LightData(type=D.LightType.POINT, position=np.array([2.5, 4.0, -2.0]),
                        intensity=10.0, radius=1.0, soft_shadow_samples=8),
            D.LightData(type=D.LightType.AMBIENT, color=np.array([0.15, 0.15, 0.15, 1.0])),
        ]
        overrides["max_soft_samples"] = 8
    else:
        raise ValueError(name)
    return s, overrides


GOLDEN = ("config1_hard_shadows", "config2_obb_mirror", "config3_glass_soft",
          "config6_soft_shadows")


def scene_and_overrides(D, name: str):
    """(SceneData, overrides) for "demo" or a golden config name."""
    if name == "demo":
        return demo_scene(D), dict(DEMO_OVERRIDES)
    return golden_scene(D, name)


def jax_leaves(flat) -> dict:
    """A raytracevs_tpu FlatScene's leaves as numpy, keyed by field name."""
    return {k: (None if v is None else np.asarray(v)) for k, v in flat._asdict().items()}
