"""Configuration `wineglass_demo`: the demo scene plus one glass wine glass
of 5,888 triangles, at 1920x1080.

The reference's sample scene holds one mesh, the node "WineGlass2", whose
asset the reference ships as Resource/Model/WineGlass.fbx: about 5.9k
triangles (the repository's bench.py:19). The repository does not hold
the file, so a lathe-turned glass of that size stands in for it: the
outline of WineGlass2 as it renders in the reference's screenshot (foot,
stem, tulip bowl; the measured profile of raytracevs_tpu/io/mesh_cache.py,
_TARGET_PROFILE, at the node's scale 0.3: 3.015 tall, rim halfwidth 0.429)
turned in 64 segments, with a 0.015 wall, its foot seated 0.03 into the
floor as the node seats it. It stands at (1.2, -0.03, -1.7), beside the
demo scene's red glass sphere, which occupies the node's own place
(0.5, -0.03, -1.5). Everything else is configs/demo.py's scene and settings.
"""
import importlib.util
import os

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "rtbench_config_demo_base", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                             "demo.py"))
demo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(demo)

SOURCE = ("https://github.com/HiroyukiTsunoda/RayTraceVS MainWindow.xaml.cs:24-25 "
          "(1920x1080), README.md:304-319 (1080p frame rate), Resource/Model/WineGlass.fbx")
ASSUMED = demo.ASSUMED + [
    "a lathe-turned glass of 5,888 triangles (WineGlass.fbx has about 5.9k, bench.py:19) "
    "stands in for WineGlass.fbx, which the repository does not hold",
    "its outline is WineGlass2's as measured off the reference's screenshot "
    "(raytracevs_tpu/io/mesh_cache.py, _TARGET_PROFILE), at the node's scale 0.3",
    "it stands at (1.2, -0.03, -1.7): the node's (0.5, -0.03, -1.5) is inside the demo "
    "scene's red glass sphere",
    "its material: clear glass, ior 1.5, a faint absorption",
]
REDUCED = []
WIDTH, HEIGHT = demo.WIDTH, demo.HEIGHT
OVERRIDES = dict(demo.OVERRIDES)
# one frame from an empty history and one window frame: the reference's
# plain mesh walks take about a minute a 1080p frame of this glass
CHECK = {"start_frames": 1, "window_frames": 1}
TRACE = {"skip": 10, "frames": 20}
# the control reads an RGB step of 2 and plane_err from 0.0216: the limits
# sit below both, above the program's 0 (PERF.md)
LIMITS = {"rgb_off_share": 1e-2, "rgb_max_step": 1, "plane_err": 1e-3, "rays_off": 0}

SEGMENTS = 64
WALL = 0.015
# WineGlass2's outer outline in world units at the node's scale: heights,
# halfwidths (mesh_cache.py's _TARGET_PROFILE times 0.3)
PROFILE_H = 0.3 * np.array([0.00, 0.30, 0.60, 0.84, 2.83, 3.17, 3.67, 4.17, 4.83, 5.83,
                            7.30, 8.70, 10.05])
PROFILE_R = 0.3 * np.array([1.27, 1.27, 0.40, 0.13, 0.13, 0.33, 0.67, 1.00, 1.50, 1.83,
                            1.73, 1.60, 1.43])
BOWL_FLOOR = 1.0  # height of the bowl's inside bottom, on the axis
POSITION = np.array([1.2, -0.03, -1.7])
GLASS = dict(base_color=np.array([0.95, 0.95, 0.95, 1.0]), transmission=1.0, ior=1.5,
             roughness=0.0, absorption=np.array([0.08, 0.04, 0.02]))


def outline():
    """The closed outline in (halfwidth, height), 48 points: the axis under
    the foot, the outer wall up to the rim (the table's points, 17 more in
    the bowl), the rim's inner edge, the inner wall down, the axis at the
    bowl's floor. Turned, its 46 spans give 2 * 64 * 46 = 5,888 triangles."""
    h_bowl = np.linspace(PROFILE_H[4], PROFILE_H[-1], 26)
    h_out = np.concatenate([PROFILE_H[:4], h_bowl])
    outer = np.stack([np.interp(h_out, PROFILE_H, PROFILE_R), h_out], -1)
    h_in = np.linspace(PROFILE_H[-1], BOWL_FLOOR + 0.05, 16)
    inner = np.stack([np.interp(h_in, PROFILE_H, PROFILE_R) - WALL, h_in], -1)
    return np.concatenate([[[0.0, 0.0]], outer, inner, [[0.0, BOWL_FLOOR]]])


def lathe(points, segs):
    """Turn an outline about the y axis: (vertices [V*8] float32 interleaved
    position, pad, normal, pad; indices uint32). Each outline point is a
    ring of segs + 1 vertices; a span between two rings is 2 * segs
    triangles, segs where one end is on the axis. Normals are the
    outline's, averaged at each point; each triangle winds so that its
    edges' cross product points the way its normals do."""
    n = len(points)
    seg_dir = np.diff(points, axis=0)
    seg_n = np.stack([seg_dir[:, 1], -seg_dir[:, 0]], -1)  # right of travel: outward
    seg_n /= np.linalg.norm(seg_n, axis=1, keepdims=True)
    pn = np.zeros_like(points)
    pn[:-1] += seg_n
    pn[1:] += seg_n
    pn /= np.linalg.norm(pn, axis=1, keepdims=True)
    ph = 2.0 * np.pi * np.arange(segs + 1) / segs
    c, s = np.cos(ph), np.sin(ph)
    pos = np.stack([points[:, None, 0] * c, np.broadcast_to(points[:, None, 1], (n, segs + 1)),
                    points[:, None, 0] * s], -1).reshape(-1, 3)
    nrm = np.stack([pn[:, None, 0] * c, np.broadcast_to(pn[:, None, 1], (n, segs + 1)),
                    pn[:, None, 0] * s], -1).reshape(-1, 3)
    tris = []
    for i in range(n - 1):
        a = i * (segs + 1) + np.arange(segs)
        b = a + segs + 1
        if points[i, 0] > 0.0:
            tris.append(np.stack([a, b, a + 1], -1))
        if points[i + 1, 0] > 0.0:
            tris.append(np.stack([a + 1, b, b + 1], -1))
    idx = np.concatenate(tris)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    face = np.cross(p1 - p0, p2 - p0)
    flip = np.sum(face * (nrm[idx[:, 0]] + nrm[idx[:, 1]] + nrm[idx[:, 2]]), -1) < 0.0
    idx[flip] = idx[flip][:, [0, 2, 1]]
    verts = np.zeros((len(pos), 8), np.float32)
    verts[:, 0:3] = pos
    verts[:, 4:7] = nrm
    return verts.reshape(-1), idx.reshape(-1).astype(np.uint32)


def meshes():
    verts, indices = lathe(outline(), SEGMENTS)
    p = verts.reshape(-1, 8)[:, :3]
    return {"WineGlass": (verts, indices, p.min(0), p.max(0))}


def scene(D, T, view):
    s = demo.scene(D, T, view)
    s.objects.append(D.MeshObjectData(mesh_name="WineGlass",
                                      material=D.MaterialData(**GLASS),
                                      transform=D.Transform(position=POSITION.copy())))
    return s
