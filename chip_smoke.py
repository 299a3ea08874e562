"""Smoke run of raytracevs_tpu_torch on one CUDA card.

Drives the port's main path: Engine(1920, 1080, device="cuda") renders three
frames of the analytic demo scene (spp 2, 6 bounces, denoiser on) with the
camera orbiting 2 degrees a frame. Before that it builds the four CUDA
kernels from csrc/, holds each against its plain PyTorch version on the card
at 1920x1080 (K2-K4 on the G-buffer of a rendered frame), and times both;
after it, it checks the frames and that every kernel launched, compares a
small frame with the CPU's plain pipeline, and times each stage of a 1080p
frame. It prints a JSON line of the kernels, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}.

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


def stage_times(P, D, MK, K, PD, frames):
    """Host ms of each stage of Engine.render's 1080p frame (runtime/engine.py::
    render_frame and post/denoise.py::denoise_frame_cf, stage by stage), the
    device synchronised before and after each, over `frames` orbiting frames."""
    from raytracevs_tpu_torch.ops.render_cf import accum_dict, assemble_frame_cf
    from raytracevs_tpu_torch.post import composite, tonemap

    eng = P.Engine(FULL_W, FULL_H, device="cuda")
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
              lambda: eng.update_scene(demo_scene(D, f), **OVERRIDES))
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

    # phase 3: build the kernels from csrc/
    import raytracevs_tpu_torch as P
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
            if "registers" in line or "spill" in line or "stack frame" in line:
                print("  ptxas:", line.strip())

    # phase 4: every kernel against its plain version on the card, at the
    # main path's size
    results = {}
    dev = torch.device("cuda")
    scene = demo_scene(D, 0)
    sc = P.to_device(P.flatten_scene(P.sanitize_scene(scene), aspect=FULL_W / FULL_H), dev)
    cfg = P.make_config(scene, FULL_W, FULL_H, **OVERRIDES)
    got = MK.render_accum(sc, cfg)
    want = R.render_accum(sc, cfg)
    torch.cuda.synchronize()
    rays_k, rays_p = int(got[R.CH_RAYS].double().sum()), int(want[R.CH_RAYS].double().sum())
    same_rays = torch.equal(got[R.CH_RAYS], want[R.CH_RAYS])
    same_ids = torch.equal(got[R.CH_OBJ_ID], want[R.CH_OBJ_ID])
    d = (got[0:3] - want[0:3]).abs().amax(0)
    frac = float((d <= 2e-4).float().mean())
    k1_err = float(d.max())
    print(f"phase 4 K1 {FULL_W}x{FULL_H}: rays kernel {rays_k} plain {rays_p} per-pixel equal "
          f"{same_rays}, obj_id equal {same_ids}, colour |d|<=2e-4 on {frac:.5f} of pixels, "
          f"max |d| {k1_err:.3g}", flush=True)
    if not (same_rays and same_ids and frac >= 0.99):
        raise AssertionError("K1 disagrees with its plain version beyond the band "
                             "(rays exact, obj_id exact, colour 2e-4 on >= 99%)")
    del got, want
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

    # phase 5: the main path, through the Engine
    counters = [MK.render_accum, K.reproject_accumulate, K.atrous, K.shadow_denoise]
    for c in counters:
        c.launches = 0
    eng = P.Engine(FULL_W, FULL_H, device="cuda")
    imgs = []
    for f in range(FRAMES):
        eng.update_scene(demo_scene(D, f), **OVERRIDES)
        imgs.append(eng.render())
        print(f"phase 5 frame {f}: {eng.last_render_ms:.2f} ms, {eng.last_rays} rays, "
              f"{eng.last_mrays_per_s:.1f} Mrays/s", flush=True)
    launches = {name: c.launches for (name, _, _), c in zip(KERNELS, counters)}
    print(f"phase 5 launches: {launches}", flush=True)
    for name, n in launches.items():
        if n < FRAMES:
            raise AssertionError(f"{name} launched {n} times in {FRAMES} frames")
    for img in imgs:
        if img.shape != (FULL_H, FULL_W, 4) or img.dtype != np.uint8:
            raise AssertionError(f"frame shape {img.shape} {img.dtype}")
        if not img[..., :3].any():
            raise AssertionError("an all-zero frame")
    if not bool(torch.isfinite(eng._denoise_state.packed).all()):
        raise AssertionError("non-finite denoiser history")

    # phase 6: the frame against the plain pipeline on a small input
    w, h = 96, 54
    gpu_e, cpu_e = P.Engine(w, h, device="cuda"), P.Engine(w, h, device="cpu")
    for f in range(2):
        for e in (gpu_e, cpu_e):
            e.update_scene(demo_scene(D, f), **OVERRIDES)
        a, b = gpu_e.render(), cpu_e.render()
        dd = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
        print(f"phase 6 {w}x{h} frame {f}: rays cuda {gpu_e.last_rays} cpu {cpu_e.last_rays}, "
              f"RGBA |d|<=1 on {(dd <= 1).mean():.5f}, max {dd.max()}", flush=True)
        if (dd <= 1).mean() < 0.995:
            raise AssertionError("CUDA frame differs from the CPU plain frame beyond the band")

    # phase 7: where the time of a 1080p frame goes
    stages = stage_times(P, D, MK, K, PD, frames=5)
    for name, ms in stages.items():
        print(f"phase 7 stage {name}: median {float(np.median(ms[1:])):.3f} ms "
              f"(frames 1-4: {[round(m, 3) for m in ms[1:]]})", flush=True)
    print(f"phase 7 sum of stage medians "
          f"{sum(float(np.median(ms[1:])) for ms in stages.values()):.3f} ms", flush=True)

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
