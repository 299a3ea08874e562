"""Configuration `demo`: the analytic demo scene at 1920x1080.

A checker plane, a mirror and a rough metal sphere, a red absorbing glass
sphere, a glass OBB, a soft point light (it asks for 4 shadow samples), a
directional and an ambient light, rendered with the reference application's
defaults as the port runs them: spp 2, 6 bounces, the denoiser on, tone map
2 (the SceneData defaults), and soft shadows clamped to one sample (the
reference's clamp, make_config's max_soft_samples=1; no override). The
camera looks at LOOK_AT from EYE turned by the traffic's azimuth about the
vertical axis.
"""
import math

import numpy as np

SOURCE = ("https://github.com/HiroyukiTsunoda/RayTraceVS MainWindow.xaml.cs:24-25 "
          "(1920x1080 default) and README.md:304-319 (1080p frame rate)")
ASSUMED = [
    "the scene (the port's chip_smoke.py demo scene) stands in for sample_scene.rtvs, "
    "which the repository does not hold",
]
REDUCED = []
WIDTH, HEIGHT = 1920, 1080
# make_config overrides passed to update_scene: none, the defaults as the
# reference application's CLI and viewer run them
OVERRIDES = {}
# frames the correctness check compares: the first `start_frames` of the run
# from an empty history, and `window_frames` drawn from the seed in the window
CHECK = {"start_frames": 2, "window_frames": 3}
# frames of the window that a --trace 1 run profiles, after `skip` frames
TRACE = {"skip": 10, "frames": 20}
# each compared number's limit (PERF.md gives the readings behind them)
LIMITS = {"rgb_off_share": 1e-2, "rgb_max_step": 1, "plane_err": 1e-3, "rays_off": 0}

LOOK_AT = np.array([0.0, 0.8, 0.6])
EYE = np.array([0.0, 1.9, -4.4])


def meshes():
    """{name: (vertices [V*8] float32, indices uint32, bounds_min, bounds_max)}."""
    return {}


def camera_position(azimuth_deg):
    a = math.radians(azimuth_deg)
    rel = EYE - LOOK_AT
    return LOOK_AT + np.array([rel[0] * math.cos(a) + rel[2] * math.sin(a), rel[1],
                               -rel[0] * math.sin(a) + rel[2] * math.cos(a)])


def scene(D, T, view):
    """The SceneData of one frame. D: a scene data module, T: its transform
    module (the port's or the reference's); view: {"azimuth_deg": float}."""
    s = D.SceneData()
    s.camera.position = camera_position(view["azimuth_deg"])
    s.camera.look_at = LOOK_AT.copy()
    ax, ay, az = T.obb_axes_from_quat(T.euler_deg_to_quat([0.0, 35.0, 10.0]))
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
