"""Scenes built in code for the port's parity tests.

Every builder takes a package's ``scene.data`` module (and, for meshes, its
``io.mesh_cache`` module), so the same literals build a raytracevs_tpu
SceneData and a raytracevs_tpu_torch SceneData. The demo scene and the mesh
demo scene are the port's workloads. Nothing here imports JAX, so
chip_smoke.py and tests/test_torch_gpu.py build their scenes from here on
the card; importing it sets nothing: the port's test files call
one_torch_thread themselves.
"""
import math

import numpy as np

from raytracevs_tpu_torch.scene.transform import euler_deg_to_quat, obb_axes_from_quat
# the goldens' directory and file names and the bar a frame must pass (no JAX
# import: test_golden.py imports the JAX package only inside its functions)
from test_golden import GOLDEN_DIR, SSIM_THRESHOLD, _golden_path as golden_path  # noqa: F401

DEMO_OVERRIDES = {"max_soft_samples": 4}
DEMO_LOOK_AT = np.array([0.0, 0.8, 0.6])
DEMO_EYE = np.array([0.0, 1.9, -4.4])
# the rotation of the demo scene's glass box
DEMO_BOX_QUAT = euler_deg_to_quat([0.0, 35.0, 10.0])


def orbit_eye(frame: int, degrees_per_frame: float = 2.0, eye=DEMO_EYE,
              look_at=DEMO_LOOK_AT) -> np.ndarray:
    """The camera position after `frame` steps of a y-axis orbit of `eye`
    around `look_at` (the demo camera by default)."""
    a = math.radians(degrees_per_frame * frame)
    rel = eye - look_at
    x = rel[0] * math.cos(a) + rel[2] * math.sin(a)
    z = -rel[0] * math.sin(a) + rel[2] * math.cos(a)
    return look_at + np.array([x, rel[1], z])


def demo_scene(D, frame: int = 0):
    """The analytic demo scene: checker plane, mirror sphere, rough metal
    sphere, red absorbing glass sphere, rotated glass OBB; a soft point
    light, a directional light and an ambient light. Default settings
    (spp 2, 6 bounces, denoiser on, tone map 2); render with
    DEMO_OVERRIDES (4 soft-shadow samples)."""
    s = D.SceneData()
    s.camera.position = orbit_eye(frame)
    s.camera.look_at = DEMO_LOOK_AT.copy()
    ax, ay, az = obb_axes_from_quat(DEMO_BOX_QUAT)
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
    (1, 2, 3, 5 and 6). Returns (SceneData, config overrides)."""
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
    elif name == "config5_caustics_denoise":
        # a glass sphere focusing a point light onto the floor: caustics on
        s.objects += [D.SphereData(position=np.array([0.0, 1.2, 0.0]), radius=0.8,
                                   material=D.MaterialData(transmission=0.9, ior=1.5,
                                                           roughness=0.0)),
                      D.PlaneData()]
        s.lights += [D.LightData(type=D.LightType.POINT, position=np.array([0.0, 6.0, 0.0]),
                                 intensity=20.0)]
        s.settings.enable_caustics = True
        s.settings.enable_denoiser = True
        s.settings.tone_map_operator = 1
        s.camera.aperture_size = 0.05
        s.camera.focus_distance = 5.0
    else:
        raise ValueError(name)
    return s, overrides


def caustics_golden_scene(D, frame: int = 0):
    """Golden config 5 (caustics on, denoiser on, ACES, depth of field),
    its camera orbiting 2 degrees a frame around its look-at point."""
    s, _ = golden_scene(D, "config5_caustics_denoise")
    s.camera.position = orbit_eye(frame, eye=np.array([0.0, 2.0, -5.0]),
                                  look_at=np.array([0.0, 1.0, 0.0]))
    return s


# the analytic golden configs without caustics (config 5 has them)
GOLDEN = ("config1_hard_shadows", "config2_obb_mirror", "config3_glass_soft",
          "config6_soft_shadows")


def scene_and_overrides(D, name: str):
    """(SceneData, overrides) for "demo" or a golden config name."""
    if name == "demo":
        return demo_scene(D), dict(DEMO_OVERRIDES)
    return golden_scene(D, name)


# the golden configs the port renders (configs 0 and 4 read reference files
# that the repository does not hold)
GOLDEN_RENDERED = ("config1_hard_shadows", "config2_obb_mirror", "config3_glass_soft",
                   "config5_caustics_denoise", "config6_soft_shadows")


def render_golden(Engine, D, name: str, res: int, **engine_kw):
    """A golden config's frame as tests/test_golden.py::_render makes it:
    Engine(res, res, **engine_kw), update_scene with the config's overrides,
    render(); config 5 renders three frames (temporal accumulation) and
    returns the third. Returns (the frame, each frame's last_render_ms)."""
    eng = Engine(res, res, **engine_kw)
    scene, overrides = golden_scene(D, name)
    eng.update_scene(scene, **overrides)
    ms = []
    for _ in range(3 if name == "config5_caustics_denoise" else 1):
        img = eng.render()
        ms.append(eng.last_render_ms)
    return img, ms


def one_torch_thread():
    """Run torch's CPU ops on one intra-op thread in this process. The tests
    run as several worker processes on one machine's cores (pytest -n 6),
    and torch's default pool of a thread a core in each worker makes them
    fight: on eight cores a case that takes 15 s alone took 150 s with six
    copies at once. The tests pass alike on one thread: their bit-equality
    checks compare runs of one process, and their comparisons with JAX hold
    stated bands."""
    import torch

    torch.set_num_threads(1)


def jax_leaves(flat) -> dict:
    """A raytracevs_tpu FlatScene's leaves as numpy, keyed by field name;
    the mesh leaf as a dict of its MeshArrays leaves (or None)."""
    out = {k: (None if v is None else np.asarray(v)) for k, v in flat._asdict().items()
           if k != "mesh"}
    out["mesh"] = (None if flat.mesh is None
                   else {k: np.asarray(v) for k, v in flat.mesh._asdict().items()})
    return out


def uv_sphere(rings=78, segs=78, radius=0.9):
    """Smooth UV sphere, 2*rings*segs triangles with analytic normals, as
    interleaved vertices [V*8] f32 and indices [3T] u32 (the same arrays as
    tests/test_big_mesh.py::_uv_sphere)."""
    vs = []
    for r in range(rings + 1):
        th = np.pi * r / rings
        for s in range(segs + 1):
            ph = 2.0 * np.pi * s / segs
            n = np.array([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)])
            vs.append((radius * n, n))
    verts = np.zeros((len(vs), 8), np.float32)
    for i, (p, n) in enumerate(vs):
        verts[i, 0:3] = p
        verts[i, 4:7] = n
    idx = []
    for r in range(rings):
        for s in range(segs):
            a = r * (segs + 1) + s
            b = a + segs + 1
            idx += [a, b, a + 1, a + 1, b, b + 1]
    return verts.reshape(-1), np.asarray(idx, np.uint32)


def mesh_service(MC, meshes: dict):
    """A MeshCacheService of `MC` (a package's io.mesh_cache) serving
    {name: uv_sphere arguments}; register() only, no directory is read."""
    ms = MC.MeshCacheService(".")
    for name, (rings, segs, radius) in meshes.items():
        verts, indices = uv_sphere(rings, segs, radius)
        ms.register(name, MC.CachedMesh(name=name, vertices=verts, indices=indices,
                                        bounds_min=np.full(3, -radius),
                                        bounds_max=np.full(3, radius)))
    return ms


GLASS_BALL = dict(base_color=np.array([0.95, 0.95, 0.95, 1.0]), transmission=1.0, ior=1.5,
                  roughness=0.0, absorption=np.array([0.5, 0.2, 0.05]))
BIG_SPHERE = dict(base_color=np.array([0.8, 0.5, 0.3, 1.0]), roughness=0.5)
# uv_sphere winds its triangles clockwise seen from outside, so its geometric
# normals (e1 x e2) point inward and the renderer, which decides the face by
# them (ClosestHit_Triangle.hlsl:122-126), sees its outside as a back face.
# An instance scaled by -1 in z is the same sphere turned right side out.
OUTWARD = np.array([1.0, 1.0, -1.0])
# The mesh demo scene's meshes, (rings, segs, radius), cut down for the tests;
# full size (chip_smoke.py) is BigSphere (316, 316, 0.9), GlassBall (96, 192, 0.6)
MESH_DEMO_SMALL = {"BigSphere": (10, 12, 0.9), "GlassBall": (8, 12, 0.6)}


def mesh_demo_scene(D, frame: int = 0):
    """The demo scene plus two mesh instances: "BigSphere", an opaque
    rough sphere behind the metal sphere, and "GlassBall", an absorbing
    glass ball standing in front of the mirror sphere. Neither overlaps an
    analytic object; both stay in view over the orbit. Render with
    DEMO_OVERRIDES and a mesh service of MESH_DEMO_SMALL (or the full size)."""
    s = demo_scene(D, frame)
    s.objects += [
        D.MeshObjectData(mesh_name="BigSphere", material=D.MaterialData(**BIG_SPHERE),
                         transform=D.Transform(position=np.array([2.4, 0.95, 3.2]),
                                               scale=OUTWARD)),
        D.MeshObjectData(mesh_name="GlassBall", material=D.MaterialData(**GLASS_BALL),
                         transform=D.Transform(position=np.array([-1.25, 0.65, -1.2]),
                                               scale=OUTWARD)),
    ]
    return s


def glass_ball_scene(D, opaque=False):
    """The mesh scene of tests/test_shadow_fuse.py::_mesh_scene: one mesh
    ball (absorbing glass, or opaque) on a checker floor beside an analytic
    sphere, a soft point light, a directional and an ambient light. Render
    with {"max_soft_samples": 2} and a mesh service {"GlassBall": (9, 9, 0.7)}."""
    mat = (D.MaterialData(base_color=np.array([0.7, 0.7, 0.8, 1.0]), roughness=0.3) if opaque
           else D.MaterialData(**dict(GLASS_BALL, ior=1.2)))
    s = D.SceneData()
    s.camera.position = np.array([0.0, 1.2, -3.0])
    s.camera.look_at = np.array([0.0, 0.7, 0.0])
    s.settings.samples_per_pixel = 1
    s.settings.max_bounces = 3
    s.objects += [
        D.MeshObjectData(mesh_name="GlassBall", material=mat,
                         transform=D.Transform(position=np.array([0.0, 0.7, 0.0]))),
        D.SphereData(position=np.array([1.4, 1.2, -0.6]), radius=0.4,
                     material=D.MaterialData(roughness=0.4)),
        D.PlaneData(),
    ]
    s.lights += [
        D.LightData(type=D.LightType.POINT, position=np.array([2.5, 5.0, -2.0]), intensity=12.0,
                    radius=0.35, soft_shadow_samples=2.0),
        D.LightData(type=D.LightType.DIRECTIONAL, direction=np.array([0.4, -1.0, 0.2]),
                    intensity=0.8),
        D.LightData(type=D.LightType.AMBIENT, color=np.array([0.3, 0.3, 0.3, 1.0])),
    ]
    return s


def nine_ball_scene(D):
    """Nine mesh instances of one ball in a 3x3 grid, glass and opaque
    alternating, the odd ones turned right side out (more than 8 instances:
    the shadow walk multiplies per crossing). Render with a mesh service
    {"Ball": (6, 8, 0.3)}."""
    s = D.SceneData()
    s.camera.position = np.array([0.0, 2.2, -3.4])
    s.camera.look_at = np.array([0.0, 0.4, 0.4])
    s.settings.samples_per_pixel = 1
    s.settings.max_bounces = 4
    for i in range(9):
        glass = i % 2 == 0
        mat = (D.MaterialData(**dict(GLASS_BALL, absorption=np.array([0.2, 0.6, 1.0]) * (i / 8.0)))
               if glass else D.MaterialData(base_color=np.array([0.3 + 0.07 * i, 0.5, 0.6, 1.0]),
                                            metallic=float(i % 4 == 1), roughness=0.3))
        pos = np.array([(i % 3 - 1) * 0.8, 0.32 + 0.05 * (i // 3), (i // 3) * 0.8])
        s.objects.append(D.MeshObjectData(mesh_name="Ball", material=mat, transform=D.Transform(
            position=pos, scale=OUTWARD if i % 2 else np.ones(3))))
    s.objects.append(D.PlaneData())
    s.lights += [
        D.LightData(type=D.LightType.POINT, position=np.array([1.5, 4.0, -1.5]), intensity=10.0),
        D.LightData(type=D.LightType.AMBIENT, color=np.array([0.25, 0.25, 0.25, 1.0])),
    ]
    return s


def deep_forest(levels=78):
    """A mesh whose binary BVH is a chain `levels` deep, as interleaved
    vertices [V*8] f32 and indices [3T] u32: one triangle a level, each
    placed far out along the next axis in turn (x, y, z, x, ...) beyond the
    triangles inside it, so that binned SAH can split it off only alone
    (every other triangle's centroid falls in its first bin). Collapsed into
    wide nodes the chain needs a walk stack of 69 entries, more than the
    kernels' 64 (csrc/closest.cuh::WALK_STACK). The extents grow ~2.6x a
    level from 1e-18 to 1e14, inside float32's range of box areas."""
    lo, hi = np.zeros(3), np.full(3, 1e-18)
    centres, sizes = [(lo + hi) / 2], [3e-19]
    for k in range(levels):
        a = k % 3
        ext = hi - lo
        gap = max(16.5 * ext[a], 1.6 * ext.max())
        c = (lo + hi) / 2
        c[a] = lo[a] + gap
        centres.append(c)
        sizes.append(0.3 * ext.max())
        hi[a] = c[a]
    corners = np.array([[-0.5, -0.5, -0.5], [0.5, -0.5, 0.0], [0.0, 0.5, 0.5]])
    p = np.asarray(centres)[:, None, :] + np.asarray(sizes)[:, None, None] * corners[None]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    verts = np.zeros((len(p), 3, 8), np.float32)
    verts[..., 0:3] = p
    verts[..., 4:7] = n[:, None, :]
    return verts.reshape(-1), np.arange(3 * len(p), dtype=np.uint32)


def deep_forest_service(MC):
    """A MeshCacheService of `MC` serving "DeepForest" (deep_forest())."""
    verts, indices = deep_forest()
    pos = verts.reshape(-1, 8)[:, :3]
    ms = MC.MeshCacheService(".")
    ms.register("DeepForest", MC.CachedMesh(name="DeepForest", vertices=verts, indices=indices,
                                            bounds_min=pos.min(0), bounds_max=pos.max(0)))
    return ms


def deep_forest_scene(D):
    """Two instances of "DeepForest" (an opaque one and an absorbing glass
    one in front of it) over the checker floor, seen where its triangles
    are a unit across; a soft point light and an ambient light. Render with
    a deep_forest_service and {"max_soft_samples": 2}."""
    s = D.SceneData()
    s.camera.position = np.array([1.0, 1.5, 2.0])
    s.camera.look_at = np.array([0.9, 1.4, 4.7])
    s.settings.samples_per_pixel = 2
    s.settings.max_bounces = 4
    s.objects += [
        D.MeshObjectData(mesh_name="DeepForest", material=D.MaterialData(**BIG_SPHERE)),
        D.MeshObjectData(mesh_name="DeepForest", material=D.MaterialData(**GLASS_BALL),
                         transform=D.Transform(position=np.array([-0.8, -0.2, -1.5]))),
        D.PlaneData(),
    ]
    s.lights += [
        D.LightData(type=D.LightType.POINT, position=np.array([2.0, 5.0, -2.0]), intensity=12.0,
                    radius=0.3, soft_shadow_samples=2.0),
        D.LightData(type=D.LightType.AMBIENT, color=np.array([0.25, 0.25, 0.25, 1.0])),
    ]
    return s


def scene_graph(N, G, scene, box_quats=()):
    """A node graph of `N` and `G` (a package's scene.nodes and scene.graph)
    that evaluates to `scene`: a SceneNode with the scene's settings, a
    CameraNode, an object node per object with its MaterialBSDFNode, a light
    node per light. box_quats: each box's rotation quaternion in order (the
    identity for a box not given one); a box's axes must be its rotation's.
    Its materials must have the node's specular, 0.5. A DirectionalLightNode
    normalizes its direction, so the graph evaluates to as_evaluated(scene)."""
    import copy

    g = G.NodeGraph()
    sn = g.add_node(N.SceneNode(num_object_sockets=len(scene.objects),
                                num_light_sockets=len(scene.lights)))
    sn.settings = copy.deepcopy(scene.settings)
    cam = g.add_node(N.CameraNode())
    c = scene.camera
    cam.camera_position, cam.look_at, cam.up = (np.array(v, float) for v in
                                                (c.position, c.look_at, c.up))
    (cam.field_of_view, cam.near, cam.far, cam.aperture_size,
     cam.focus_distance) = (c.field_of_view, c.near, c.far, c.aperture_size, c.focus_distance)
    g.connect(cam.find_output("Camera"), sn.find_input("Camera"))
    quats = list(box_quats)
    for i, o in enumerate(scene.objects):
        kind = type(o).__name__
        if kind == "SphereData":
            node = N.SphereNode()
            node.object_transform.position = np.array(o.position, float)
            node.radius = float(o.radius)
        elif kind == "PlaneData":
            node = N.PlaneNode()
            node.object_transform.position = np.array(o.position, float)
            node.normal = np.array(o.normal, float)
        elif kind == "BoxData":
            node = N.BoxNode()
            node.object_transform.position = np.array(o.center, float)
            node.object_transform.rotation = np.array(
                quats.pop(0) if quats else [0.0, 0.0, 0.0, 1.0], float)
            node.size = np.array(o.size, float) * 2.0
        else:
            node = N.FBXMeshNode(o.mesh_name)
            node.object_transform = copy.deepcopy(o.transform)
        m = o.material
        assert m.specular == 0.5, "MaterialBSDFNode's specular is 0.5"
        mat = g.add_node(N.MaterialBSDFNode())
        mat.base_color, mat.emission, mat.absorption = (np.array(v, float) for v in
                                                        (m.base_color, m.emission, m.absorption))
        mat.metallic, mat.roughness, mat.transmission, mat.ior = (
            m.metallic, m.roughness, m.transmission, m.ior)
        g.add_node(node)
        g.connect(mat.find_output("Material"), node.find_input("Material"))
        g.connect(node.find_output("Object"), sn.find_input(f"Object{i + 1}"))
    for i, lt in enumerate(scene.lights):
        kind = int(lt.type)
        if kind == 1:  # point
            node = N.PointLightNode()
            node.light_position = np.array(lt.position, float)
            node.attenuation, node.radius = lt.attenuation, lt.radius
            node.soft_shadow_samples = lt.soft_shadow_samples
        elif kind == 2:  # directional
            node = N.DirectionalLightNode()
            node.direction = np.array(lt.direction, float)
            node.angular_radius = lt.radius
            node.soft_shadow_samples = lt.soft_shadow_samples
        else:  # ambient
            node = N.AmbientLightNode()
        node.color, node.intensity = np.array(lt.color, float), lt.intensity
        g.add_node(node)
        g.connect(node.find_output("Light"), sn.find_input(f"Light{i + 1}"))
    return g


def as_evaluated(scene):
    """A copy of `scene` with each directional light's direction normalized
    as DirectionalLightNode normalizes it: what scene_graph(scene)
    evaluates to."""
    import copy

    out = copy.deepcopy(scene)
    for lt in out.lights:
        if int(lt.type) == 2:
            d = np.asarray(lt.direction, float)
            lt.direction = d / np.linalg.norm(d)
    return out
