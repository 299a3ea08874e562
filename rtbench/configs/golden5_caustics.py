"""Configuration `golden5_caustics`: golden config 5 at 1920x1080, the
repository's fifth target configuration (BASELINE.json configs[4]:
"Photon-mapped caustics (spatial hash) + REBLUR/SIGMA denoise + ACES + DoF,
1080p multi-frame").

The scene is tests/test_golden.py's config5_caustics_denoise: a clear glass
sphere (radius 0.8 at (0, 1.2, 0), transmission 0.9, ior 1.5) on the checker
plane, focusing one point light at (0, 6, 0), intensity 20, onto the floor;
the camera at (0, 2, -5) looks at (0, 1, 0) through a thin lens (aperture
0.05, focus distance 5). spp 2, 6 bounces, the denoiser on, tone map 1
(ACES), caustics on: the photon budget gives min(32,768 x 1 light, 8,192 x
1 point light) = 8,192 photons (DXRPipeline.cpp:3604-3633), gathered at
radius 0.5 from 65,536 hash slots. The camera turns by the traffic's
azimuth about the look-at point's vertical axis. "Multi-frame" is the
accumulate loop: one update_scene, then render() frame after frame.
"""
import math

import numpy as np

SOURCE = ("https://github.com/HiroyukiTsunoda/RayTraceVS DXRPipeline.cpp:3604-3633 (photon "
          "caps); BASELINE.json configs[4]; tests/test_golden.py config5_caustics_denoise")
ASSUMED = [
    "the golden scene (tests/test_golden.py config5_caustics_denoise) stands in for the "
    "reference's own sample files, which the repository does not hold",
]
REDUCED = []
WIDTH, HEIGHT = 1920, 1080
# make_config overrides passed to update_scene: caustics on (the scene's
# settings say so too)
OVERRIDES = {"enable_caustics": True}
# frames the correctness check compares: the first `start_frames` of the run
# from an empty history, and `window_frames` drawn from the seed in the window
CHECK = {"start_frames": 2, "window_frames": 3}
# frames of the window that a --trace 1 run profiles, after `skip` frames
TRACE = {"skip": 10, "frames": 20}
# each compared number's limit, between the program's readings and the
# control's (the reference with bfloat16 planes and history) at 1080p on the
# card (PERF.md): the program read 0 / 0 / 0 / 0 on every seed; the control
# read rgb_off_share 0.048113-0.048227, rgb_max_step 1, plane_err
# 0.0038397-0.0039493 and rays_off 0 on three seeds. The share's limit lies
# 4.8x below the control, plane_err's 3.8x below; 8-bit steps are whole
# numbers, so the step's limit lies halfway between 0 and the control's 1;
# rays_off reads 0 on both sides.
LIMITS = {"rgb_off_share": 1e-2, "rgb_max_step": 0.5, "plane_err": 1e-3, "rays_off": 0}

LOOK_AT = np.array([0.0, 1.0, 0.0])
EYE = np.array([0.0, 2.0, -5.0])


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
    s.camera.aperture_size = 0.05
    s.camera.focus_distance = 5.0
    s.settings.samples_per_pixel = 2
    s.settings.max_bounces = 6
    s.settings.tone_map_operator = 1
    s.settings.enable_caustics = True
    s.settings.enable_denoiser = True
    s.objects += [
        D.SphereData(position=np.array([0.0, 1.2, 0.0]), radius=0.8,
                     material=D.MaterialData(transmission=0.9, ior=1.5, roughness=0.0)),
        D.PlaneData(),
    ]
    s.lights += [D.LightData(type=D.LightType.POINT, position=np.array([0.0, 6.0, 0.0]),
                             intensity=20.0)]
    return s
