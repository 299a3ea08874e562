"""Smoke run of raytracevs_tpu_torch on one CUDA card.

Drives the port's two main paths: Engine(1920, 1080, device="cuda") renders
three frames of the analytic demo scene, then Engine(1920, 1080,
device="cuda", mesh_service=...) three frames of the mesh demo scene (the
demo scene plus a 199,712-triangle opaque sphere and a 36,864-triangle
absorbing glass ball), spp 2, 6 bounces, denoiser on, the camera orbiting 2
degrees a frame. Before that it builds the CUDA kernels from csrc/ and the
host BVH builder from csrc/host/, holds each kernel against its plain
PyTorch version on the card at 1920x1080 (K2-K4 on the G-buffer of a
rendered frame; K1-mesh also on nine mesh instances at 480x270), and times
both; after each path it checks the frames and that every kernel of the
path launched; then it compares small frames with the CPU's plain pipeline
and times each stage of a 1080p frame of both scenes. It prints a JSON line
of the kernels, the card's name and power limit, and as its last line
{"ok": true, "device": {...}}.

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one. Nothing in it
catches an error: any failed phase ends the run with a traceback.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# The kernels' table; the launch counts come from the main-path run.
KERNELS = [
    ("render_accum", "raytracevs_tpu_torch/csrc/megakernel.cu",
     "raytracevs_tpu/ops/pallas/megakernel.py:2443"),
    ("reproject_accumulate", "raytracevs_tpu_torch/csrc/denoise.cu",
     "raytracevs_tpu/ops/pallas/denoise_kernels.py:99"),
    ("atrous", "raytracevs_tpu_torch/csrc/denoise.cu",
     "raytracevs_tpu/ops/pallas/denoise_kernels.py:472"),
    ("shadow_denoise", "raytracevs_tpu_torch/csrc/denoise.cu",
     "raytracevs_tpu/ops/pallas/denoise_kernels.py:657"),
    ("render_accum_mesh", "raytracevs_tpu_torch/csrc/megakernel.cu",
     "raytracevs_tpu/ops/pallas/megakernel.py:3155"),
]
FULL_W, FULL_H = 1920, 1080
FRAMES = 3
LOOK_AT = np.array([0.0, 0.8, 0.6])
EYE = np.array([0.0, 1.9, -4.4])


def demo_scene(D, frame):
    """The analytic demo scene (the same literals as tests/_torch_scenes.py)."""
    from raytracevs_tpu_torch.scene.transform import euler_deg_to_quat, obb_axes_from_quat

    a = math.radians(2.0 * frame)
    rel = EYE - LOOK_AT
    eye = LOOK_AT + np.array([rel[0] * math.cos(a) + rel[2] * math.sin(a), rel[1],
                              -rel[0] * math.sin(a) + rel[2] * math.cos(a)])
    s = D.SceneData()
    s.camera.position = eye
    s.camera.look_at = LOOK_AT.copy()
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


OVERRIDES = {"max_soft_samples": 4}


def uv_sphere(rings, segs, radius):
    """Smooth UV sphere, 2*rings*segs triangles (tests/_torch_scenes.py::uv_sphere)."""
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


def mesh_service(meshes):
    """A MeshCacheService serving {name: (rings, segs, radius)} UV spheres."""
    from raytracevs_tpu_torch.io.mesh_cache import CachedMesh, MeshCacheService

    ms = MeshCacheService(".")  # register() only: no directory is read
    for name, (rings, segs, radius) in meshes.items():
        verts, indices = uv_sphere(rings, segs, radius)
        ms.register(name, CachedMesh(name=name, vertices=verts, indices=indices,
                                     bounds_min=np.full(3, -radius),
                                     bounds_max=np.full(3, radius)))
    return ms


# the mesh demo scene (tests/_torch_scenes.py::mesh_demo_scene), full size;
# the -1 z scale turns uv_sphere's inward-wound triangles right side out
OUTWARD = np.array([1.0, 1.0, -1.0])
MESH_DEMO = {"BigSphere": (316, 316, 0.9), "GlassBall": (96, 192, 0.6)}
GLASS_BALL = dict(base_color=np.array([0.95, 0.95, 0.95, 1.0]), transmission=1.0, ior=1.5,
                  roughness=0.0, absorption=np.array([0.5, 0.2, 0.05]))


def mesh_demo_scene(D, frame):
    s = demo_scene(D, frame)
    s.objects += [
        D.MeshObjectData(mesh_name="BigSphere", material=D.MaterialData(
            base_color=np.array([0.8, 0.5, 0.3, 1.0]), roughness=0.5),
            transform=D.Transform(position=np.array([2.4, 0.95, 3.2]), scale=OUTWARD)),
        D.MeshObjectData(mesh_name="GlassBall", material=D.MaterialData(**GLASS_BALL),
                         transform=D.Transform(position=np.array([-1.25, 0.65, -1.2]),
                                               scale=OUTWARD)),
    ]
    return s


def nine_ball_scene(D):
    """Nine instances of one ball (tests/_torch_scenes.py::nine_ball_scene):
    more than 8 instances, so the shadow walk multiplies per crossing."""
    s = D.SceneData()
    s.camera.position = np.array([0.0, 2.2, -3.4])
    s.camera.look_at = np.array([0.0, 0.4, 0.4])
    s.settings.samples_per_pixel = 1
    s.settings.max_bounces = 4
    for i in range(9):
        mat = (D.MaterialData(**dict(GLASS_BALL, absorption=np.array([0.2, 0.6, 1.0]) * (i / 8.0)))
               if i % 2 == 0 else D.MaterialData(
                   base_color=np.array([0.3 + 0.07 * i, 0.5, 0.6, 1.0]),
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


def gpu_ms(fn, reps):
    """Mean ms of fn() over `reps` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms(fn):
    """(fn(), ms of that one call by CUDA events, the device synchronised)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_k1(name, MK, R, sc, cfg):
    """K1 (or K1-mesh) against its plain version on the card: per-pixel ray
    counts and object ids equal, colour 2e-4 on >= 99% of pixels. Returns
    (max |d|, kernel ms of the compared launch, plain ms of its run)."""
    got, k_ms = timed_ms(lambda: MK.render_accum(sc, cfg))
    want, p_ms = timed_ms(lambda: R.render_accum(sc, cfg))
    rays_k, rays_p = int(got[R.CH_RAYS].double().sum()), int(want[R.CH_RAYS].double().sum())
    same_rays = torch.equal(got[R.CH_RAYS], want[R.CH_RAYS])
    same_ids = torch.equal(got[R.CH_OBJ_ID], want[R.CH_OBJ_ID])
    d = (got[0:3] - want[0:3]).abs().amax(0)
    frac = float((d <= 2e-4).float().mean())
    err = float(d.max())
    bad = int((d > 2e-4).sum())
    print(f"{name} {cfg.width}x{cfg.height}: rays kernel {rays_k} plain {rays_p} per-pixel "
          f"equal {same_rays}, obj_id equal {same_ids}, colour |d|<=2e-4 on {frac:.5f} of "
          f"pixels ({bad} above), max |d| {err:.3g}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms",
          flush=True)
    if not (same_rays and same_ids and frac >= 0.99):
        raise AssertionError(f"{name} disagrees with its plain version beyond the band "
                             "(rays exact, obj_id exact, colour 2e-4 on >= 99%)")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite accumulator planes")
    return err, k_ms, p_ms


def stage_times(P, D, MK, K, PD, frames, build, meshes=None):
    """Host ms of each stage of Engine.render's 1080p frame (runtime/engine.py::
    render_frame and post/denoise.py::denoise_frame_cf, stage by stage), the
    device synchronised before and after each, over `frames` orbiting frames
    of build(D, frame). With meshes, update_scene includes the BVH work:
    the SAH build on frame 0, a retransform after it."""
    from raytracevs_tpu_torch.ops.render_cf import accum_dict, assemble_frame_cf
    from raytracevs_tpu_torch.post import composite, tonemap

    eng = P.Engine(FULL_W, FULL_H, device="cuda",
                   mesh_service=None if meshes is None else mesh_service(meshes))
    state = PD.init_state_cf(FULL_H, FULL_W, eng.device)
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for f in range(frames):
        stage("update_scene: sanitize, flatten, to_device (host)",
              lambda: eng.update_scene(build(D, f), **OVERRIDES))
        sc, cfg = eng._scene_t, eng._cfg
        acc = stage("K1 render_accum (incl. table packing)", lambda: MK.render_accum(sc, cfg))
        out = stage("assemble_frame_cf (plain torch)",
                    lambda: assemble_frame_cf(sc, cfg, accum_dict(acc)))
        gb = out.gbuffer
        sqrt_rough = gb.normal_roughness[3]
        curr = stage("reblur_prepass (plain torch)", lambda: PD.reblur_prepass(
            torch.cat([gb.diffuse_hitdist, gb.specular_hitdist]), gb.view_z, sqrt_rough))
        packed = stage("K2 reproject_accumulate", lambda: K.reproject_accumulate(
            state.packed, curr, gb.motion, gb.view_z, torch.square(sqrt_rough), gb.motion_spec))
        state = PD.DenoiserStateCF(packed=packed)
        normal, guide = stage("decode normals + guide planes (plain torch)", lambda: (
            PD.decode_oct_cf(gb.normal_roughness), PD.guide_cf(packed, gb.view_z, sqrt_rough)))
        ds = stage("K3 atrous: anti-firefly + 3 passes", lambda: K.atrous(
            torch.cat([packed[0:3], packed[4:7]]), gb.view_z, normal, guide))
        stage("K4 shadow_denoise", lambda: K.shadow_denoise(gb.shadow_data, gb.obj_id, gb.view_z,
                                                            normal))
        color01 = stage("composite_cf (plain torch)", lambda: composite.composite_cf(
            gb, out.raw_specular, sc.exposure, sc.tone_map_operator, sc.gamma,
            denoised_diffuse=ds[0:3], denoised_specular=ds[3:6], use_denoised=True,
            nrd_bypass_distance=sc.nrd_bypass_distance, nrd_bypass_blend=sc.nrd_bypass_blend))
        rgba = stage("to_rgba8_cf (plain torch)", lambda: tonemap.to_rgba8_cf(color01))
        stage("readback .cpu().numpy() (RGBA8)", lambda: rgba.cpu().numpy())
    return times


def print_stages(label, stages):
    for name, ms in stages.items():
        print(f"phase 7 {label} stage {name}: median {float(np.median(ms[1:])):.3f} ms "
              f"(frame 0: {ms[0]:.3f}; frames 1-4: {[round(m, 3) for m in ms[1:]]})", flush=True)
    print(f"phase 7 {label} sum of stage medians "
          f"{sum(float(np.median(ms[1:])) for ms in stages.values()):.3f} ms", flush=True)


def run_engine(P, D, label, build, counters, meshes=None):
    """Three orbiting 1080p frames through the Engine, every launch count set
    to 0 just before and read just after; checks the frames."""
    for c in counters.values():
        c.launches = 0
    eng = P.Engine(FULL_W, FULL_H, device="cuda",
                   mesh_service=None if meshes is None else mesh_service(meshes))
    imgs = []
    for f in range(FRAMES):
        t0 = time.perf_counter()
        eng.update_scene(build(D, f), **OVERRIDES)
        upd = (time.perf_counter() - t0) * 1e3
        imgs.append(eng.render())
        print(f"phase 5 {label} frame {f}: {eng.last_render_ms:.2f} ms, {eng.last_rays} rays, "
              f"{eng.last_mrays_per_s:.1f} Mrays/s (update_scene {upd:.1f} ms)", flush=True)
    launches = {name: c.launches for name, c in counters.items()}
    print(f"phase 5 {label} launches: {launches}", flush=True)
    for img in imgs:
        if img.shape != (FULL_H, FULL_W, 4) or img.dtype != np.uint8:
            raise AssertionError(f"frame shape {img.shape} {img.dtype}")
        if not img[..., :3].any():
            raise AssertionError("an all-zero frame")
    if not bool(torch.isfinite(eng._denoise_state.packed).all()):
        raise AssertionError("non-finite denoiser history")
    if not bool(torch.isfinite(eng._last_hdr_t).all()):
        raise AssertionError("non-finite HDR frame")
    return launches


def compare_small(P, D, label, build, frames, meshes=None):
    """A 96x54 frame through the CUDA Engine and the CPU's plain pipeline:
    ray counts equal, RGBA |d| <= 1 on >= 99.5% of pixels."""
    w, h = 96, 54
    ms = None if meshes is None else mesh_service(meshes)
    gpu_e = P.Engine(w, h, device="cuda", mesh_service=ms)
    cpu_e = P.Engine(w, h, device="cpu", mesh_service=ms)
    for f in range(frames):
        for e in (gpu_e, cpu_e):
            e.update_scene(build(D, f), **OVERRIDES)
        a, b = gpu_e.render(), cpu_e.render()
        dd = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
        print(f"phase 6 {label} {w}x{h} frame {f}: rays cuda {gpu_e.last_rays} cpu "
              f"{cpu_e.last_rays}, RGBA |d|<=1 on {(dd <= 1).mean():.5f}, max {dd.max()} "
              f"(cpu frame {cpu_e.last_render_ms:.0f} ms)", flush=True)
        if gpu_e.last_rays != cpu_e.last_rays or (dd <= 1).mean() < 0.995:
            raise AssertionError("CUDA frame differs from the CPU plain frame beyond the band")


def main():
    # phase 1: the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    print(f"phase 1 cuda: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}", flush=True)

    # phase 2: name and power limit
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"phase 2 nvidia-smi: {smi}", flush=True)

    # phase 3: build the kernels from csrc/ and the host BVH builder from csrc/host/
    import raytracevs_tpu_torch as P
    from raytracevs_tpu_torch.io import native
    from raytracevs_tpu_torch.ops import render as R
    from raytracevs_tpu_torch.ops.cuda import _build
    from raytracevs_tpu_torch.ops.cuda import denoise_kernels as K
    from raytracevs_tpu_torch.ops.cuda import megakernel as MK
    from raytracevs_tpu_torch.ops.render_cf import render_rows_cf
    from raytracevs_tpu_torch.post import denoise as PD
    from raytracevs_tpu_torch.scene import data as D

    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 3 build: {time.perf_counter() - t0:.1f} s -> {_build.library_path()}", flush=True)
    with open(_build.build_log_path()) as f:
        for line in f:
            if ("Compiling entry function" in line or "registers" in line or "spill" in line
                    or "stack frame" in line):
                print("  ptxas:", line.strip())
    t0 = time.perf_counter()
    native.load_library()
    print(f"phase 3 host BVH builder: {time.perf_counter() - t0:.1f} s -> "
          f"{native.library_path()}", flush=True)

    # phase 4: every kernel against its plain version on the card, at the
    # main path's size
    results = {}
    dev = torch.device("cuda")
    scene = demo_scene(D, 0)
    sc = P.to_device(P.flatten_scene(P.sanitize_scene(scene), aspect=FULL_W / FULL_H), dev)
    cfg = P.make_config(scene, FULL_W, FULL_H, **OVERRIDES)
    k1_err, _, _ = check_k1("phase 4 K1", MK, R, sc, cfg)
    k1_ms = gpu_ms(lambda: MK.render_accum(sc, cfg), 3)
    k1_plain_ms = gpu_ms(lambda: R.render_accum(sc, cfg), 1)
    results["render_accum"] = (k1_err, k1_ms, k1_plain_ms)
    print(f"  render_accum: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms", flush=True)

    # K2-K4 on the G-buffers of two orbiting 1080p frames
    g = []
    for f in range(2):
        s = demo_scene(D, f)
        prev = None if f == 0 else P.flatten_scene(P.sanitize_scene(demo_scene(D, 0)),
                                                   aspect=FULL_W / FULL_H).view_proj
        st = P.to_device(P.flatten_scene(P.sanitize_scene(s), frame_index=f,
                                         aspect=FULL_W / FULL_H, prev_view_proj=prev), dev)
        g.append(render_rows_cf(st, P.make_config(s, FULL_W, FULL_H, **OVERRIDES)).gbuffer)
    state = PD.denoise_frame_cf(g[0], PD.init_state_cf(FULL_H, FULL_W, dev))[3].packed
    gb = g[1]
    sqrt_rough = gb.normal_roughness[3]
    curr = PD.reblur_prepass(torch.cat([gb.diffuse_hitdist, gb.specular_hitdist]), gb.view_z,
                             sqrt_rough)
    k2_args = (state, curr, gb.motion, gb.view_z, torch.square(sqrt_rough), gb.motion_spec)
    new_state = K.reproject_accumulate(*k2_args)
    k2_err = float((new_state - PD.temporal_accumulate(*k2_args)).abs().max())
    normal = PD.decode_oct_cf(gb.normal_roughness)
    guide = PD.guide_cf(new_state, gb.view_z, sqrt_rough)
    k3_args = (torch.cat([new_state[0:3], new_state[4:7]]).contiguous(), gb.view_z, normal, guide)
    k3_err = float((K.atrous(*k3_args) - PD.atrous(*k3_args)).abs().max())
    k4_args = (gb.shadow_data, gb.obj_id, gb.view_z, normal)
    k4_err = float((K.shadow_denoise(*k4_args) - PD.shadow_denoise(*k4_args)).abs().max())
    frames_kept = float((new_state[14] > 0).float().mean())
    print(f"phase 4 K2-K4 {FULL_W}x{FULL_H}: max |d| K2 {k2_err:.3g} K3 {k3_err:.3g} "
          f"K4 {k4_err:.3g}; history kept on {frames_kept:.3f} of pixels", flush=True)
    if max(k2_err, k3_err, k4_err) > 1e-5:
        raise AssertionError("K2-K4 disagree with their plain versions beyond atol 1e-5")
    for name, err, kern, plain in (
            ("reproject_accumulate", k2_err, lambda: K.reproject_accumulate(*k2_args),
             lambda: PD.temporal_accumulate(*k2_args)),
            ("atrous", k3_err, lambda: K.atrous(*k3_args), lambda: PD.atrous(*k3_args)),
            ("shadow_denoise", k4_err, lambda: K.shadow_denoise(*k4_args),
             lambda: PD.shadow_denoise(*k4_args))):
        results[name] = (err, gpu_ms(kern, 20), gpu_ms(plain, 5))
        print(f"  {name}: kernel {results[name][1]:.4f} ms, plain {results[name][2]:.4f} ms",
              flush=True)
    del g, state, gb, curr, k2_args, new_state, normal, guide, k3_args, k4_args

    # K1-mesh on the mesh demo scene at 1080p, and on nine instances
    meshes, blas_cache = mesh_service(MESH_DEMO), P.BLASCache()
    mscene = mesh_demo_scene(D, 0)
    t0 = time.perf_counter()
    mflat = P.flatten_scene(P.sanitize_scene(mscene), aspect=FULL_W / FULL_H,
                            mesh_service=meshes, blas_cache=blas_cache)
    t1 = time.perf_counter()
    P.flatten_scene(P.sanitize_scene(mesh_demo_scene(D, 1)), aspect=FULL_W / FULL_H,
                    mesh_service=meshes, blas_cache=blas_cache)
    t2 = time.perf_counter()
    msc = P.to_device(mflat, dev)
    torch.cuda.synchronize()
    print(f"phase 4 mesh demo scene: {mflat.mesh.num_tris} triangles, {mflat.mesh.num_nodes} "
          f"nodes, {mflat.mesh.num_inst} instances; flatten with the SAH builds "
          f"{(t1 - t0) * 1e3:.1f} ms, flatten with cached BLASes (retransform only) "
          f"{(t2 - t1) * 1e3:.1f} ms, to_device with the plane table "
          f"{(time.perf_counter() - t2) * 1e3:.1f} ms", flush=True)
    mcfg = P.make_config(mscene, FULL_W, FULL_H, **OVERRIDES)
    mk_err, _, mk_plain_ms = check_k1("phase 4 K1-mesh", MK, R, msc, mcfg)
    mk_ms = gpu_ms(lambda: MK.render_accum(msc, mcfg), 3)
    results["render_accum_mesh"] = (mk_err, mk_ms, mk_plain_ms)
    print(f"  render_accum_mesh: kernel {mk_ms:.3f} ms (mean of 3), plain {mk_plain_ms:.3f} ms "
          f"(one run)", flush=True)
    nscene = nine_ball_scene(D)
    nsc = P.to_device(P.flatten_scene(P.sanitize_scene(nscene), aspect=480 / 270,
                                      mesh_service=mesh_service({"Ball": (24, 32, 0.3)})), dev)
    n_err, _, _ = check_k1("phase 4 K1-mesh, nine instances,", MK, R, nsc,
                           P.make_config(nscene, 480, 270))
    results["render_accum_mesh"] = (max(mk_err, n_err),) + results["render_accum_mesh"][1:]
    del msc, nsc

    # phase 5: the main paths, through the Engine
    counters = {"render_accum": MK.render_accum, "reproject_accumulate": K.reproject_accumulate,
                "atrous": K.atrous, "shadow_denoise": K.shadow_denoise,
                "render_accum_mesh": MK.render_accum_mesh}
    launches = run_engine(P, D, "analytic", demo_scene, counters)
    for name in ("render_accum", "reproject_accumulate", "atrous", "shadow_denoise"):
        if launches[name] < FRAMES:
            raise AssertionError(f"{name} launched {launches[name]} times in {FRAMES} frames")
    mesh_launches = run_engine(P, D, "mesh", mesh_demo_scene, counters, MESH_DEMO)
    for name in ("render_accum_mesh", "reproject_accumulate", "atrous", "shadow_denoise"):
        if mesh_launches[name] < FRAMES:
            raise AssertionError(f"{name} launched {mesh_launches[name]} times in {FRAMES} "
                                 "mesh frames")
    launches["render_accum_mesh"] = mesh_launches["render_accum_mesh"]

    # phase 6: frames against the plain pipeline on a small input
    compare_small(P, D, "analytic", demo_scene, 2)
    compare_small(P, D, "mesh", mesh_demo_scene, 1, MESH_DEMO)

    # phase 7: where the time of a 1080p frame goes
    print_stages("analytic", stage_times(P, D, MK, K, PD, 5, demo_scene))
    print_stages("mesh", stage_times(P, D, MK, K, PD, 5, mesh_demo_scene, MESH_DEMO))

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": results[name][0],
         "ms": results[name][1], "plain_ms": results[name][2]}
        for name, src, rep in KERNELS]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
