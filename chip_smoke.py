"""Smoke run of raytracevs_tpu_torch on one CUDA card.

Drives the port's four main paths: Engine(1920, 1080) renders three frames
of the analytic demo scene; Engine(1920, 1080, mesh_service=...) three
frames of the mesh demo scene (the demo scene plus a 199,712-triangle
opaque sphere and a 36,864-triangle absorbing glass ball); three frames of
the demo scene with photon-mapped caustics on (16,384 photons), all at spp
2; and Engine(1920, 1080, two_phase=True, mesh_service=...) three frames of
the mesh demo scene at spp 1 through the two-phase renderer (K7, the
coherence sort, K8). All at 6 bounces, denoiser on, the camera orbiting 2
degrees a frame. Before that it builds the CUDA kernels from csrc/ and the
host BVH builder from csrc/host/, holds each kernel against its plain
PyTorch version on the card at the main paths' shapes (K1, K1-mesh, K7 and
K8 bit for bit; K2 within 1e-5, K3 and K4 bit for bit, on the G-buffer of a
rendered 1080p frame, K3 and K4 also on it cut to 1917x1079; K9, the
G-buffer assembly, on K1's 1080p planes of a moved camera and K10, the
REBLUR prepass, on its G-buffer, each bit for bit; K1-mesh also on
nine mesh instances at 480x270; the photon emission and trace K5 at 16,384
and 131,072 photons, on an offset slice and on the mesh demo scene's
tables, against the plain emission and bounce loop; the photon gather K6,
added into the colour and diffuse planes in place, at 1920x1080 with both
maps; K7 and K8 at 1920x1080 and spp 1 on the mesh
demo scene and the demo scene, and together against K1-mesh and K1
there; the mesh walks alone, bit-equal to the plain walks on over a
million camera, secondary and shadow rays of the mesh demo scene and on
the nine instances), renders frames past the kernels' 32-bit plane index
in row bands (K1 at 8192x8200) and 1080p frames in forced bands (K1,
K1-mesh, the two-phase path), bit-equal to one launch, renders a mesh whose wide
table needs more walk stack than the kernels hold through the threaded
instantiations (K1-mesh, K7, K8 and the walks alone, against their plain
versions), counts each render kernel's work (the counting build: the mesh
walks' node fetches, box tests and triangle tests by ray class at 1080p
and 480x270, the plain threaded walks' at 480x270; the DFS's lane and warp
iterations, whose ratio is K1's SIMT share, shade calls, shadow and
thickness rays, hits by kind and the lights their BRDF shades, all but the
warp figure held equal to the plain version's), times both (K1 and
K1-mesh as the launch alone, their table packing apart; each kernel's
wrapper by CUDA events around back-to-back calls, and its device time
alone by torch.profiler) and computes each
kernel's bound (the larger of its bytes over the memory rate and its
operations over the float32 rate: for the render kernels the shading, the
shadow samples and the intersection tests at the counting build's counts,
the walks' box and triangle tests included); after each path it checks the
frames and that every kernel of the path launched; then it compares small
frames with the CPU's plain pipeline and times each stage of a 1080p frame
of the scenes. The card's path runs no plain emission op (counted on
ops/photon.py::_emit_photons.launches). Then the scene files: the demo
and mesh demo scenes written as .rtvs graphs with the port's save_graph,
Engine(1920, 1080).load_rtvs rendering three frames of each (every launch
count set to 0 just before, read just after), their FlatScene leaves and
frames bit-equal to the in-code scenes'; the photon debug modes (K1 and
K7 in modes 3 and 4 on the demo scene, K1-mesh and K7 in mode 3 on the
full mesh demo scene at spp 1, bit-equal to their plain versions; K6's
replacement fold-in within 1e-5 with every other plane's bits kept, all
at 480x270; K7 + sort + K8 against K1 in mode 3), and render_debug_view
modes 1-10 after a 1080p caustics frame; the Engine's surface on the card
(validate_frame, copy_pixels_into's fills, render(fail_safe=True)); and
the CLI (python -m raytracevs_tpu_torch.api.cli, a process of its own,
three 1080p frames of the demo scene's file), its PNG equal to the
Engine's frame. Then the row-sharded paths (phase 4a: K2's slab form and the per-pass
a-trous kernel against their plain versions at 1080p and 1917x1079, the
per-pass kernel on whole frames and in its slab form (top, second and last
slabs, the neighbours' rows as views), the three passes against the fused
K3, its three passes timed in the slab form on an interior slab with their
registers, spills and blocks an SM; phase 12: Engine(1920, 1080,
device_mesh=make_mesh([cuda:0] * 4)) over three orbiting frames of each of
the four paths, bit-equal to the single-device Engine's, every kernel of
the path launched, and the sharded demo render()'s ms and device-busy ms)
and the live viewer (phase 13: api/viewer.py on the card at 1280x720 on
an ephemeral 127.0.0.1 port: five frames, a setprop and its undo, the
photon debug mode 1 with K5 and K6 launched, debug mode 3, a resolution
switch) and the golden images (phase 14: configs 1, 2, 3, 5 and 6 of
tests/golden/ through Engine(res, res) on the card at 96x96 and 256x256,
SSIM >= 0.98 by the port's utils/ssim.py, beside the plain CPU Engine's
score, the kernels of each frame launched; utils/refcompare.py on the
256x256 config 1 frame, its score the direct one). Phase 3 prints the mode-0 instantiations' registers and
spills beside PR 8's and fails if K1 or K7 pass 128 registers or spill,
or K1-mesh leaves 184 registers without spills. It prints a JSON line of
the kernels (debug_modes_max_abs_err: the photon debug modes' check), the
card's name and power limit, and as its last line {"ok": true, "device":
{...}}. Each path launches K9, K10, K2, K3 and K4 once a frame.

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one. Nothing in it
catches an error: any failed phase ends the run with a traceback.
"""
import ctypes
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

# the scenes of the port's tests (tests/_torch_scenes.py, which imports no JAX)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
import _torch_scenes as TS  # noqa: E402
from _torch_scenes import demo_scene, mesh_demo_scene, nine_ball_scene  # noqa: E402

# The kernels' table; the launch counts come from the main-path run.
KERNELS = [
    ("render_accum", "raytracevs_tpu_torch/csrc/render.cuh",
     "raytracevs_tpu/ops/pallas/megakernel.py:2443"),
    ("reproject_accumulate", "raytracevs_tpu_torch/csrc/denoise.cu",
     "raytracevs_tpu/ops/pallas/denoise_kernels.py:99"),
    ("atrous", "raytracevs_tpu_torch/csrc/denoise.cu",
     "raytracevs_tpu/ops/pallas/denoise_kernels.py:472"),
    ("shadow_denoise", "raytracevs_tpu_torch/csrc/denoise.cu",
     "raytracevs_tpu/ops/pallas/denoise_kernels.py:657"),
    ("render_accum_mesh", "raytracevs_tpu_torch/csrc/render.cuh",
     "raytracevs_tpu/ops/pallas/megakernel.py:3155"),
    ("photon_trace", "raytracevs_tpu_torch/csrc/photon.cu",
     "raytracevs_tpu/ops/pallas/photon_trace.py:58"),
    ("photon_gather", "raytracevs_tpu_torch/csrc/photon.cu",
     "raytracevs_tpu/ops/pallas/photon_gather.py:151"),
    ("render_phase_a", "raytracevs_tpu_torch/csrc/render.cuh",
     "raytracevs_tpu/ops/pallas/megakernel.py:2443"),
    ("render_phase_b", "raytracevs_tpu_torch/csrc/render.cuh",
     "raytracevs_tpu/ops/pallas/megakernel.py:2569"),
    ("K2-slab", "raytracevs_tpu_torch/csrc/denoise.cu",
     "raytracevs_tpu/ops/pallas/denoise_kernels.py:99"),
    ("K3-pass", "raytracevs_tpu_torch/csrc/denoise.cu",
     "raytracevs_tpu/ops/pallas/denoise_kernels.py:589"),
    # no TPU kernel: the JAX package leaves these two chains to XLA's fusion
    ("assemble", "raytracevs_tpu_torch/csrc/gbuffer.cu", "none"),
    ("reblur_prepass", "raytracevs_tpu_torch/csrc/denoise.cu", "none"),
]
# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): device
# memory bytes/s and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations of one intersection test of csrc/closest.cuh
# (isect_sphere, isect_plane, isect_box), counted by hand from the source;
# every closest hit and every shadow ray needs a test of every valid
# primitive (the padded slots are not counted), a thickness ray one sphere
# or box (counted as a sphere's).
SPHERE_OPS, PLANE_OPS, BOX_OPS = 36, 29, 84
# ... and of the mesh walks' tests, by hand: a box test (closest.cuh::slab:
# 6 subtractions, 6 multiplications, 6 min/max of the slab pairs, 3 and 3
# into t_near and t_far with the clamps, 1 compare) and a triangle test
# (tri_plane: two 3-term dots, the division, the hit point, two 4-term
# plane rows, 5 compares). The bounds of K1-mesh, K7 and K8 add them at the
# counts of the counting build, which tests fewer boxes than the threaded walk.
BOX_TEST_OPS, TRI_TEST_OPS = 25, 38
# The shading of csrc/render.cuh, by hand, each arithmetic operation,
# compare, sqrt or transcendental one operation, applied at the counting
# build's counts (render_ops). SKY_OPS: a miss, or an item capped at the
# depth limit (sky_color: the normalize 10, 4 smoothsteps 32, 5 lerps 45,
# clamps, haze and ground 14; the radiance and the sums 9). HIT_OPS: a
# shade call that hits, before its lights (the hit point 6, the cheapest
# normal, a plane's, 10, the face 8, the colour's clamp, guard and sums
# 16). Only the valid lights count, and an ambient light only in its
# ambient term (render_ops): SELECT_OPS a point or directional light of the
# dominant-light choice among the first 8 (estimate_light 33, the compares
# 4), LIGHT_OPS one of an opaque hit's lighting loop (light_geom 38, the lit
# test 2), AMBIENT_OPS an ambient light there (its colour 3, the base 12,
# the product and sum 6), LIT_OPS a light its BRDF shades (brdf_terms 92,
# the weights, radiance and sums 33), OPAQUE_OPS an opaque hit's own (f0,
# the diffuse colour, the SIGMA record, the direct weight: 20).
# GLASS_LIGHT_OPS a point or directional light of a glass hit's highlight
# (light_geom 38, the half vector, powf, Fresnel and sum 38),
# GLASS_CHILD_OPS its reflect and refract children (120). SHADOW_SAMPLE_OPS
# a shadow ray besides its primitive tests (two u24f, the disc sample, the
# offset, the direction or the distance, the facing test, the sums: 50).
# Left out, so the bound stays below the work: the shadow rays' per-light
# set-up, the metal child, the checker, boxes' normals.
SKY_OPS, HIT_OPS, OPAQUE_OPS = 110, 40, 20
SELECT_OPS, LIGHT_OPS, AMBIENT_OPS, LIT_OPS = 37, 40, 21, 125
GLASS_LIGHT_OPS, GLASS_CHILD_OPS, SHADOW_SAMPLE_OPS = 76, 120, 50
# per photon bounce besides the closest hit (K5's Russian roulette, Fresnel
# or metal lobe), per photon emitted (K5's emission: the two randoms, the
# sphere direction, the emitter plane's two normalizes and crosses, the
# power and colour) and per photon scanned by the gather (K6), by hand
PHOTON_BOUNCE_OPS, EMIT_OPS, GATHER_PHOTON_OPS = 60, 75, 30
# per pixel of K2 (two bilinear fetches of 16 and 7 channels, the blends),
# K3 (anti-firefly, then 3 passes of 8 taps) and K4 (25 taps), by hand
REPROJECT_OPS, ATROUS_OPS, SHADOW_OPS = 370, 930, 606
# per pixel of K9 (the classification, the view normal and its octahedral
# encoding, two motions of two projections each, the shadow inputs: ~230)
# and K10 (the reconstruction's two 3x3 means, 40; 16 taps of two expf, a
# division and 9 other operations, 192; the radius and the 3 divisions, 15)
ASSEMBLE_OPS, PREPASS_OPS = 230, 250
# planes K9 reads (the accumulator's in photon debug mode 0) and writes (30
# float, the int32 ids), and K10 reads (curr, view_z, sqrt_rough) and writes
ASSEMBLE_PLANES, PREPASS_PLANES = 28 + 31, 10 + 8
# per pixel of one a-trous pass (8 taps of a depth weight with its
# division and expf, the normal term, 6 weighted sums; the guide's two
# expf and the 6 final divisions) and of the anti-firefly clamp before it
# (two luminances, 16 maxima, the ratio and 6 products), by hand
PASS_OPS, CLAMP_OPS = 275, 40
# the sharded paths: row slabs a frame (make_mesh([cuda:0] * SHARDS))
SHARDS = 4
# the device's busy ms of a sharded demo render() when the a-trous stage
# still copied the 12 planes of each slab twice a pass (NVIDIA H100 80GB
# HBM3, 700 W), printed beside today's
SHARDED_BUSY_BEFORE_MS = 14.064
# the bands of tests/test_megakernel.py:190-197 for the photon store fields
# (position, direction, colour, power): atol, and rtol 1e-3
STORE_ATOL = (5e-3, 1e-4, 1e-5, 1e-4)
FULL_W, FULL_H = 1920, 1080
FRAMES = 3


def mesh_service(meshes):
    """A MeshCacheService serving {name: (rings, segs, radius)} UV spheres."""
    from raytracevs_tpu_torch.io import mesh_cache

    return TS.mesh_service(mesh_cache, meshes)


OVERRIDES = TS.DEMO_OVERRIDES
CAUSTICS = dict(OVERRIDES, enable_caustics=True)
SPP1 = dict(OVERRIDES, samples_per_pixel=1)  # the two-phase renderer's
# the mesh demo scene's meshes at full size
MESH_DEMO = {"BigSphere": (316, 316, 0.9), "GlassBall": (96, 192, 0.6)}


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


def device_ms(fn, reps):
    """(mean device ms of fn()'s work a call, over `reps` calls after a
    warm-up; the method): the time of the CUDA kernels and copies the
    calls ran, by torch.profiler (CUDA activity), apart from the host's
    time in the wrappers; where the profiler records fewer device events
    than calls (each call launches at least one kernel), CUDA events
    around the calls with the device held back (torch.cuda._sleep) until
    the host has queued them all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a profile with fewer device events than calls is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(events) >= reps:
            return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3, "profiler"
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0  # one call's host time, the device's included
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (0.01 + 2 * call_s * reps)))  # ~2 GHz cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "events after a sleep"


def timed_ms(fn):
    """(fn(), ms of that one call by CUDA events, the device synchronised)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time for moving `nbytes`
    and doing `ops` float32 operations, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def closest_ops(sc):
    """Operations of one closest-hit test against every valid primitive."""
    return (int(sc.sph_valid.sum()) * SPHERE_OPS + int(sc.pln_valid.sum()) * PLANE_OPS
            + int(sc.box_valid.sum()) * BOX_OPS)


def light_counts(sc):
    """(point and directional lights, the first 8 slots' of them, ambient
    lights) among the scene's valid lights."""
    from raytracevs_tpu_torch import constants as C

    slots = torch.arange(sc.light_capacity, device=sc.lt_valid.device)
    valid = sc.lt_valid.bool() & (slots < sc.num_lights)
    ambient = valid & (sc.lt_type == C.LIGHT_TYPE_AMBIENT)
    direct = valid & ~ambient
    return int(direct.sum()), int(direct[:8].sum()), int(ambient.sum())


def kernel_row(err, ms, plain_ms, nbytes, ops, dev):
    """The kernel line's row: `ms` the wrapper's time, `dev` device_ms'
    (ms, method) of the same call."""
    b_ms, b_by = bound(nbytes, ops)
    print(f"  bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G operations)"
          f"; device {dev[0]:.4f} ms ({dev[1]}), wrapper {ms:.4f} ms; the device time reaches "
          f"{b_ms / dev[0]:.4f} of the bound", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=dev[0], plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def same_bits(a, b):
    """Whether float tensors a and b hold the same bits (K7's hit planes
    hold ints as their bits, some of them NaN patterns)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_denoise_bits(name, kern, plain, args):
    """A denoiser kernel (K3, K4) against its plain version on the same
    inputs: every output bit equal. Returns the max |d| (0)."""
    got, want = kern(*args), plain(*args)
    err = float((got - want).abs().max())
    same = same_bits(got, want)
    h, w = args[1].shape  # view_z (K3), obj_id (K4)
    print(f"phase 4 {name} {w}x{h}: bit-equal to the plain version {same}, max |d| {err:.3g}",
          flush=True)
    if not same:
        raise AssertionError(f"{name} {w}x{h}: output differs from the plain version's bits")
    return err


def assert_like_plain(name, R, cfg, got, want, note=""):
    """Accumulator planes of a render kernel against its plain version's:
    per-pixel ray counts and object ids equal, colour 2e-4 on >= 99% of
    pixels, every plane finite. Returns the colour's max |d|."""
    rays_k, rays_p = int(got[R.CH_RAYS].double().sum()), int(want[R.CH_RAYS].double().sum())
    same_rays = torch.equal(got[R.CH_RAYS], want[R.CH_RAYS])
    same_ids = torch.equal(got[R.CH_OBJ_ID], want[R.CH_OBJ_ID])
    d = (got[0:3] - want[0:3]).abs().amax(0)
    frac = float((d <= 2e-4).float().mean())
    err = float(d.max())
    bad = int((d > 2e-4).sum())
    print(f"{name} {cfg.width}x{cfg.height}: rays kernel {rays_k} plain {rays_p} per-pixel "
          f"equal {same_rays}, obj_id equal {same_ids}, colour |d|<=2e-4 on {frac:.5f} of "
          f"pixels ({bad} above), max |d| {err:.3g}{note}", flush=True)
    if not (same_rays and same_ids and frac >= 0.99):
        raise AssertionError(f"{name} disagrees with its plain version beyond the band "
                             "(rays exact, obj_id exact, colour 2e-4 on >= 99%)")
    if not bool(torch.isfinite(got[:R.CH_HIT]).all()):  # K7's hit planes hold int bits
        raise AssertionError(f"{name}: non-finite accumulator planes")
    return err


def check_k1(name, MK, R, sc, cfg, plain_counts=None):
    """K1 (or K1-mesh) against its plain version on the card: every plane
    bit-equal, as the kernel follows the plain version operation for
    operation (the plain run adds its work to plain_counts). Returns (max
    |d|, kernel ms of the compared launch, plain ms of its run, rays)."""
    got, k_ms = timed_ms(lambda: MK.render_accum(sc, cfg))
    want, p_ms = timed_ms(lambda: R.render_accum(sc, cfg, counts=plain_counts))
    bits = same_bits(got, want)
    err = assert_like_plain(name, R, cfg, got, want,
                            f"; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; every plane bit-equal "
                            f"{bits}")
    if not bits:
        raise AssertionError(f"{name}: planes differ from the plain version's in their bits")
    return err, k_ms, p_ms, int(got[R.CH_RAYS].double().sum())


def check_phases(label, MK, R, TP, sc, cfg, plain_counts):
    """K7 against plain phase A, and K8 against plain phase B on the same
    phase-A planes and their whole sorted order: every plane bit-equal
    (K7's continuation and hit planes included). The plain runs add their
    work to plain_counts (phase A's, phase B's). Returns (K7 max |d|, K8
    max |d|, plain A ms, plain B ms), the plain times of one run each."""
    got_a = MK.render_phase_a(sc, cfg)
    want_a, pa_ms = timed_ms(lambda: R.render_accum_phase_a(sc, cfg, plain_counts[0]))
    bits = same_bits(got_a, want_a)
    err_a = assert_like_plain(f"phase 4 K7 {label}", R, cfg, got_a, want_a,
                              f"; plain {pa_ms:.3f} ms; every plane bit-equal {bits}")
    if not bits:
        raise AssertionError(f"K7 {label}: planes differ from plain phase A's in their bits")
    order, count = TP.coherence_order(want_a)
    hits = want_a[R.CH_HIT:]
    got_b = MK.render_phase_b(sc, cfg, order, count, want_a[:R.NUM_CH].clone(), hits)
    want_b, pb_ms = timed_ms(lambda: R.render_accum_phase_b(
        sc, cfg, order[:int(count)], want_a[:R.NUM_CH].clone(), hits, plain_counts[1]))
    bits = same_bits(got_b, want_b)
    err_b = assert_like_plain(f"phase 4 K8 {label}", R, cfg, got_b, want_b,
                              f"; {int(count)} pixels resumed; plain {pb_ms:.3f} ms; every plane "
                              f"bit-equal {bits}")
    if not bits:
        raise AssertionError(f"K8 {label}: planes differ from plain phase B's in their bits")
    return err_a, err_b, pa_ms, pb_ms


def check_two_phase_vs_k1(label, MK, R, TP, sc, cfg, aperture):
    """K7 + sort + K8 (render_accum_two_phase) against K1 (K1-mesh) at spp
    1: per-pixel rays, bounce and every record plane bit-equal, colour
    within 2e-5 * max(1, |K1|) (phase A's term plus phase B's sum is K1's
    running sum in another order). Returns (the two-phase planes, phase A's
    rays, the pixels phase B resumed)."""
    k1 = MK.render_accum(sc, cfg)
    two = TP.render_accum_two_phase(sc, cfg, aperture)
    a = MK.render_phase_a(sc, cfg)
    rays_a = int(a[R.CH_RAYS].double().sum())
    resumed = int(a[R.CH_SPAWN_VALID].sum())
    records = list(range(R.CH_PRIMARY, R.CH_HITDIST + 1)) + list(range(R.CH_PRIM_HIT, R.NUM_CH))
    same = [torch.equal(two[c], k1[c]) for c in (R.CH_RAYS, R.CH_BOUNCE)]
    same.append(torch.equal(two[records], k1[records]))
    d = (two[0:3] - k1[0:3]).abs()
    rel = float((d / k1[0:3].abs().clamp(min=1.0)).max())
    print(f"phase 4 K7+K8 vs K1 {label} {cfg.width}x{cfg.height} spp 1: {resumed} pixels "
          f"resumed; rays {int(two[R.CH_RAYS].double().sum())} (phase A {rays_a}); rays, bounce, "
          f"records bit-equal {same}; colour max |d| {float(d.max()):.3g}, relative {rel:.3g}",
          flush=True)
    if not (all(same) and rel <= 2e-5):
        raise AssertionError(f"the two phases disagree with K1 ({label})")
    return two, rays_a, resumed


def time_two_phase(label, MK, R, TP, sc, cfg, aperture):
    """ms of K7, the key and sort, K8 (each on its own, tables packed once
    beforehand), the whole two-phase render, and K1 before and after it,
    each the mean of 3 runs after a warm-up (CUDA events)."""
    tables = MK.pack_tables(sc)
    a = MK.render_phase_a(sc, cfg, tables)
    order, count = TP.coherence_order(a)
    acc = a[:R.NUM_CH].clone()
    t = {"k1": gpu_ms(lambda: MK.render_accum(sc, cfg), 3)}
    t["k7"] = gpu_ms(lambda: MK.render_phase_a(sc, cfg, tables), 3)
    t["sort"] = gpu_ms(lambda: TP.coherence_order(a), 3)
    t["k8"] = gpu_ms(lambda: MK.render_phase_b(sc, cfg, order, count, acc, a[R.CH_HIT:],
                                               tables), 3)
    t["k7_dev"] = device_ms(lambda: MK.render_phase_a(sc, cfg, tables), 3)
    t["sort_dev"] = device_ms(lambda: TP.coherence_order(a), 3)
    t["k8_dev"] = device_ms(lambda: MK.render_phase_b(sc, cfg, order, count, acc, a[R.CH_HIT:],
                                                      tables), 3)
    t["two_phase"] = gpu_ms(lambda: TP.render_accum_two_phase(sc, cfg, aperture), 3)
    t["k1_again"] = gpu_ms(lambda: MK.render_accum(sc, cfg), 3)
    t["sum"] = t["k7"] + t["sort"] + t["k8"]
    print(f"phase 4 time {label} {cfg.width}x{cfg.height} spp 1: K7 {t['k7']:.4f} ms (device "
          f"{t['k7_dev'][0]:.4f}), key + sort {t['sort']:.4f} ms (device {t['sort_dev'][0]:.4f}), "
          f"K8 {t['k8']:.4f} ms (device {t['k8_dev'][0]:.4f}), sum {t['sum']:.4f} ms; "
          f"render_accum_two_phase (packing included) {t['two_phase']:.4f} ms; K1 (packing "
          f"included) {t['k1']:.4f} ms before, {t['k1_again']:.4f} ms after", flush=True)
    return t


def check_bands(P, D, MK, R, TP, sc, cfg, msc, mcfg, maperture):
    """Row bands (ROADMAP C10). At 1080p, with a limit that forces 4 bands:
    K1 on the demo scene and K1-mesh on the mesh demo scene (spp 2), and
    the two-phase path on the mesh demo scene (spp 1, K7, the sort and K8
    per band), each bit-equal to one launch. Then K1 at 8192x8200, spp 1,
    whose planes pass 2**31 floats: a launch a band (two), the frame's
    planes first filled with NaN by a tensor freed just before (the
    caching allocator hands its block to them), none left, and the frame
    bit-equal to the same frame in three bands."""
    limit = R.NUM_CH_A * FULL_W * 300
    for label, s_, c_ in (("K1, demo scene", sc, cfg), ("K1-mesh, mesh demo scene", msc, mcfg)):
        one = MK.render_accum(s_, c_)
        before = MK.render_accum.launches
        banded = MK.render_accum(s_, c_, limit=limit)
        n = MK.render_accum.launches - before
        same = same_bits(banded, one)
        print(f"phase 4 bands {label} {FULL_W}x{FULL_H} spp {c_.samples_per_pixel}: {n} bands, "
              f"bit-equal to one launch {same}", flush=True)
        if not same or n < 2:
            raise AssertionError(f"{label}: the banded frame differs from one launch")
    c1 = mcfg._replace(samples_per_pixel=1)
    one = TP.render_accum_two_phase(msc, c1, maperture)
    before = (MK.render_phase_a.launches, MK.render_phase_b.launches)
    banded = TP.render_accum_two_phase(msc, c1, maperture, limit=limit)
    n = (MK.render_phase_a.launches - before[0], MK.render_phase_b.launches - before[1])
    same = same_bits(banded, one)
    print(f"phase 4 bands two-phase, mesh demo scene {FULL_W}x{FULL_H} spp 1: {n} bands (K7, K8), "
          f"bit-equal to one pass {same}", flush=True)
    if not same or min(n) < 2:
        raise AssertionError("the banded two-phase frame differs from one pass")
    del one, banded

    w8, h8 = 8192, 8200
    scene = demo_scene(D, 0)
    s8 = P.to_device(P.flatten_scene(P.sanitize_scene(scene), aspect=w8 / h8), "cuda")
    c8 = P.make_config(scene, w8, h8, **SPP1)
    bands = MK.row_bands(w8, h8, R.NUM_CH)
    sentinel = torch.full((R.NUM_CH, h8, w8), float("nan"), device="cuda")
    del sentinel
    before = MK.render_accum.launches
    big, k_ms = timed_ms(lambda: MK.render_accum(s8, c8))
    n = MK.render_accum.launches - before
    nan_free = not bool(torch.isnan(big).any())
    last_finite = bool(torch.isfinite(big[:, bands[-1][0]:]).all())
    three = MK.render_accum(s8, c8, limit=R.NUM_CH * w8 * 3000)
    same = same_bits(big, three)
    print(f"phase 4 bands K1 {w8}x{h8} spp 1 ({R.NUM_CH * w8 * h8} plane floats): bands {bands}, "
          f"{n} launches, {k_ms:.1f} ms; no NaN left {nan_free}, the last band finite "
          f"{last_finite}, {int(big[R.CH_RAYS].double().sum())} rays; bit-equal to three bands "
          f"{same}", flush=True)
    if not (n == len(bands) >= 2 and nan_free and last_finite and same):
        raise AssertionError(f"K1 at {w8}x{h8} in row bands failed")
    del big, three
    torch.cuda.empty_cache()


def check_k5(label, PP, PK, sc, tables, total, offset=0, count=None):
    """K5 (emission and the bounce loop in one launch, on the frame's
    tables) against the plain emission and bounce loop on photons [offset,
    offset+count) of a total-photon batch of scene `sc`: store masks equal
    photon for photon and at least one photon stored, each store field
    bit-equal or within STORE_ATOL; no plain emission op runs for the
    kernel. Returns the kernel_row (the
    wrapper as the main path calls it, mean of 20; its device time; the
    plain pair, mean of 3)."""
    count = total - offset if count is None else count
    dev = sc.cam_pos.device
    emitted = PP._emit_photons.launches
    got = PK.emit_and_trace(sc, total, offset, count, tables)
    if PP._emit_photons.launches != emitted:
        raise AssertionError("K5's wrapper ran the plain emission")
    em = PP._emit_photons(sc, total, offset, count)
    idx = torch.arange(count, dtype=torch.int32, device=dev) + offset
    want = PP._trace_photons(sc, *em, idx)
    torch.cuda.synchronize()
    m = want[4]
    masks = torch.equal(got[4], m)
    same = [torch.equal(got[c], want[c]) for c in range(4)]
    errs = [float((got[c][m] - want[c][m]).abs().max()) if bool(m.any()) else 0.0
            for c in range(4)]
    off_bits = [int((got[c][m] != want[c][m]).reshape(int(m.sum()), -1).any(1).sum())
                for c in range(4)]
    within = all(bool(((got[c][m] - want[c][m]).abs() <= atol + 1e-3 * want[c][m].abs()).all())
                 for c, atol in enumerate(STORE_ATOL))
    print(f"phase 4 K5 {label}, photons [{offset}, {offset + count}) of {total}: stored kernel "
          f"{int(got[4].sum())} plain {int(m.sum())}, masks equal {masks}, fields (position, "
          f"direction, colour, power) bit-equal {same}, stored photons off in their bits "
          f"{off_bits}, max |d| {errs}", flush=True)
    if not (masks and within and int(m.sum()) > 0):
        raise AssertionError(f"K5 disagrees with its plain emission and bounce loop ({label}, "
                             f"photons [{offset}, {offset + count}) of {total})")
    ms = gpu_ms(lambda: PK.emit_and_trace(sc, total, offset, count, tables), 20)
    dev_ms = device_ms(lambda: PK.emit_and_trace(sc, total, offset, count, tables), 20)
    plain_ms = gpu_ms(lambda: PP._trace_photons(sc, *PP._emit_photons(sc, total, offset, count),
                                                idx), 3)
    # bounces the kernel traces: the photons alive entering each bounce
    s, bounces = PP._initial_state(*em), 0
    for depth in range(4):
        bounces += int(s.alive.sum())
        s = PP._bounce(sc._replace(mesh=None), s, idx, depth)
    # the primitive tables every closest hit reads, the material rows of the
    # valid primitives (the only ones a photon can hit), the light rows,
    # the light count, and 41 bytes a photon out
    valid = int(sc.sph_valid.sum()) + int(sc.pln_valid.sum()) + int(sc.box_valid.sum())
    nbytes = 4 * (5 * sc.sphere_capacity + 7 * sc.plane_capacity + 16 * sc.box_capacity
                  + 16 * valid + 12 * sc.light_capacity + 1) + count * 41
    print(f"  photon_trace {label}: wrapper {ms:.4f} ms, device {dev_ms[0]:.4f} ms "
          f"({dev_ms[1]}); plain emission and loop {plain_ms:.3f} ms; {bounces} bounces",
          flush=True)
    return kernel_row(max(errs), ms, plain_ms, nbytes,
                      count * EMIT_OPS + bounces * (closest_ops(sc) + PHOTON_BOUNCE_OPS),
                      dev_ms)


def check_k5_slice(PK, sc, tables, total, offset, count):
    """A slice of the batch equals the same rows of the whole, bit for bit."""
    part = PK.emit_and_trace(sc, total, offset, count, tables)
    whole = PK.emit_and_trace(sc, total, 0, total, tables)
    same = all(torch.equal(a, b[offset:offset + count]) for a, b in zip(part, whole))
    print(f"phase 4 K5 slice [{offset}, {offset + count}) of {total}: equal to the whole "
          f"batch's rows {same}", flush=True)
    if not same:
        raise AssertionError("K5's slice differs from the whole batch's rows")


def check_k6(label, PP, PK, R, pmap, acc, spp):
    """K6 (the caustic added into the colour and diffuse planes in place)
    against its plain version (the same add, ops/photon.py::add_caustics)
    on two copies of the accumulator planes `acc`: colour and diffuse |d|
    <= 1e-5 * max(1, |plain|), every other plane's bits kept. Returns the
    kernel_row (the wrapper mean of 20, the device time, the plain version
    one run)."""
    got, want = acc.clone(), acc.clone()
    PK.add_caustics(pmap, got, spp)
    _, plain_ms = timed_ms(lambda: PP.add_caustics(pmap, want, spp))
    cd = [c for r in (R.CH_COLOR, R.CH_DIFFUSE) for c in range(r, r + 3)]  # K6 adds into these
    others = [c for c in range(R.NUM_CH) if c not in cd]
    d = (got[cd] - want[cd]).abs()
    err = float(d.max())
    ok = bool((d <= 1e-5 * want[cd].abs().clamp(min=1.0)).all())
    kept = same_bits(got[others], acc[others])
    lit = float((want[R.CH_COLOR:R.CH_COLOR + 3] != acc[R.CH_COLOR:R.CH_COLOR + 3]).any(0)
                .float().mean())
    print(f"phase 4 K6 {label} {acc.shape[2]}x{acc.shape[1]}, {int(pmap.count)} stored photons: "
          f"colour and diffuse max |d| {err:.3g} (within 1e-5 relative: {ok}), the other "
          f"{len(others)} planes' bits kept {kept}, caustic on {lit:.5f} of pixels", flush=True)
    if not (ok and kept) or lit == 0.0:
        raise AssertionError(f"K6 disagrees with its plain version ({label})")
    work = acc.clone()  # the timed calls add into it again and again
    ms = gpu_ms(lambda: PK.add_caustics(pmap, work, spp), 20)
    dev = device_ms(lambda: PK.add_caustics(pmap, work, spp), 20)
    nbytes, visits = gather_work(PP, R, pmap, acc)
    print(f"  photon_gather: wrapper {ms:.4f} ms, device {dev[0]:.4f} ms ({dev[1]}), plain "
          f"{plain_ms:.3f} ms, {visits} photon visits", flush=True)
    return kernel_row(err, ms, plain_ms, nbytes, visits * GATHER_PHOTON_OPS, dev)


def gather_work(PP, R, pmap, acc):
    """(bytes, photon visits) that K6 needs on these inputs, each input read
    once: the hit plane at every pixel, metallic where there is a hit,
    transmission where the hit is not metal, position and normal at the
    eligible pixels, colour and diffuse read and written at the pixels the
    caustic lights (no other plane is written); the cell ranges of the hash slots
    its walks reach, and of the photons they scan, the valid flag, then
    position and direction of the valid ones, colour and power of the
    accepted ones. The walks are ops/photon.py::gather's steps, cut by the
    32-accept early-out; a visit is one valid photon tested by one pixel."""
    hit = acc[R.CH_PRIM_HIT] > 0.5
    diffuse = hit & (acc[R.CH_METALLIC] < 0.5)
    elig = (diffuse & (acc[R.CH_TRANSMISSION] <= 0.01)).reshape(-1)
    px = hit.numel()
    pos = acc[R.CH_POS:R.CH_POS + 3].reshape(3, -1).T[elig]
    lit = int((PP._gather_weighted(pmap, pos, acc[R.CH_NORMAL:R.CH_NORMAL + 3].reshape(3, -1)
                                   .T[elig])[1] > 0.0).sum())
    plane_floats = px + int(hit.sum()) + int(diffuse.sum()) + 6 * int(elig.sum()) + 12 * lit
    base = torch.floor(pos / torch.clamp(pmap.radius * 2.0, min=1e-4)).to(torch.int32)
    slots = torch.stack([PP.hash_cell(base[:, 0] + x, base[:, 1] + y, base[:, 2] + z)
                         for x, y, z in PP.CELL_OFFSETS], dim=1).long()
    n_cells, n = len(PP.CELL_OFFSETS), pmap.position.shape[0]
    zi = torch.zeros((pos.shape[0],), dtype=torch.int32, device=pos.device)
    s = dict(cell=zi, off=zi, gathered=zi, caustic=torch.zeros_like(pos),
             weight=torch.zeros_like(zi, dtype=torch.float32), pos=pos,
             nrm=acc[R.CH_NORMAL:R.CH_NORMAL + 3].reshape(3, -1).T[elig],
             starts=pmap.cell_start[slots], counts=pmap.cell_count[slots])
    cells_read = torch.zeros(pmap.cell_start.shape, dtype=torch.bool, device=pos.device)
    scanned, valid_read, accepted = (torch.zeros((n,), dtype=torch.bool, device=pos.device)
                                     for _ in range(3))
    visits = 0
    while s["cell"].numel() > 0:
        in_range = s["cell"] < n_cells
        ci = torch.clamp(s["cell"], 0, n_cells - 1).long()[:, None]
        cells_read[torch.gather(slots, 1, ci)[:, 0][in_range & (s["off"] == 0)]] = True
        cnt = torch.clamp(torch.gather(s["counts"], 1, ci)[:, 0], max=64)
        have = in_range & (s["off"] < cnt)
        pi = torch.clamp(torch.gather(s["starts"], 1, ci)[:, 0] + s["off"], 0, n - 1).long()
        pval = have & pmap.valid[pi] & (pi < pmap.count)
        scanned[pi[have]] = True
        valid_read[pi[pval]] = True
        visits += int(pval.sum())
        gathered = s["gathered"]
        s = PP._gather_step(pmap, s, pmap.radius * pmap.radius)
        accepted[pi[s["gathered"] > gathered]] = True
        live = s["cell"] < n_cells
        s = {k: v[live] for k, v in s.items()}
        slots = slots[live]
    nbytes = (4 * plane_floats + 8 * int(cells_read.sum()) + int(scanned.sum())
              + 24 * int(valid_read.sum()) + 16 * int(accepted.sum()) + 12)
    return nbytes, visits


def check_gbuffer_kernels(P, D, MK, K, PD, R, dev):
    """K9 (gbuffer_kernels.assemble) on K1's 1080p accumulator planes of the
    demo scene's second orbiting frame, and K10 (reblur_prepass) on the
    G-buffer it assembles, each bit-equal to its plain version; their
    rows: wrapper ms, device ms, plain ms and bound."""
    from raytracevs_tpu_torch.ops.cuda import gbuffer_kernels as G
    from raytracevs_tpu_torch.ops.render_cf import accum_dict, assemble_frame_cf

    prev = P.flatten_scene(P.sanitize_scene(demo_scene(D, 0)), aspect=FULL_W / FULL_H).view_proj
    scene = demo_scene(D, 1)
    sc = P.to_device(P.flatten_scene(P.sanitize_scene(scene), frame_index=1,
                                     aspect=FULL_W / FULL_H, prev_view_proj=prev), dev)
    cfg = P.make_config(scene, FULL_W, FULL_H, **OVERRIDES)
    acc = MK.render_accum(sc, cfg)
    got, want = G.assemble(sc, cfg, acc), assemble_frame_cf(sc, cfg, accum_dict(acc))
    names = ["color", "raw_specular", *got.gbuffer._fields]
    fields = zip(names, [got.color, got.raw_specular, *got.gbuffer],
                 [want.color, want.raw_specular, *want.gbuffer])
    differ = [n for n, a, b in fields if a is not None and not same_bits(a, b)]
    print(f"phase 4 K9 assemble {FULL_W}x{FULL_H}: every field bit-equal to the plain version "
          f"but {differ}", flush=True)
    if differ or not torch.equal(got.rays, want.rays):
        raise AssertionError(f"K9: {differ} differ from the plain version's bits")
    gb = got.gbuffer
    pre_args = (PD._hitdist_planes(gb), gb.view_z, gb.normal_roughness[3])
    k10_err = check_denoise_bits("K10 reblur_prepass", K.reblur_prepass, PD.reblur_prepass,
                                 pre_args)
    px = FULL_W * FULL_H
    rows = {}
    for name, err, kern, plain, planes, ops in (
            ("assemble", 0.0, lambda: G.assemble(sc, cfg, acc),
             lambda: assemble_frame_cf(sc, cfg, accum_dict(acc)), ASSEMBLE_PLANES, ASSEMBLE_OPS),
            ("reblur_prepass", k10_err, lambda: K.reblur_prepass(*pre_args),
             lambda: PD.reblur_prepass(*pre_args), PREPASS_PLANES, PREPASS_OPS)):
        ms = gpu_ms(kern, 20)
        dev_t = device_ms(kern, 20)
        plain_ms = gpu_ms(plain, 5)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        rows[name] = kernel_row(err, ms, plain_ms, planes * px * 4, px * ops, dev_t)
    return rows


def stage_times(P, D, MK, K, PD, frames, build, meshes=None, overrides=OVERRIDES,
                two_phase=False, label=""):
    """Host ms of each stage of Engine.render's 1080p frame (runtime/engine.py::
    render_frame, ops/render_cf.py::render_rows_cf and apply_caustics_cf,
    and post/denoise.py::denoise_frame_cf, stage by stage), the device
    synchronised before and after each, over `frames` orbiting frames of
    build(D, frame). With meshes, update_scene includes the BVH work: the
    SAH builds, retransforms and the mesh tables' upload on frame 0, after
    it the Engine's mesh caches reused (their counters are printed, under
    `label`). The tables are packed
    once a frame, for the render kernels and K5. With two_phase, the
    render is ops/twophase.py::render_accum_two_phase's steps. The
    readback is the Engine's (runtime/readback.py), its last two frames
    held as an orbit's caller holds them; two "compare:" stages, left out
    of the sum, read the frame back pageable (.cpu().numpy()), held alike
    and dropped at once, and the three's minor page faults are printed."""
    from raytracevs_tpu_torch.ops import photon as PP
    from raytracevs_tpu_torch.ops import render as R
    from raytracevs_tpu_torch.ops import twophase as TP
    from raytracevs_tpu_torch.ops.cuda import gbuffer_kernels as G
    from raytracevs_tpu_torch.ops.cuda import photon_kernels as PK
    from raytracevs_tpu_torch.post import composite, tonemap
    from raytracevs_tpu_torch.runtime.readback import read_back

    eng = P.Engine(FULL_W, FULL_H, device="cuda",
                   mesh_service=None if meshes is None else mesh_service(meshes),
                   two_phase=two_phase)
    state = PD.init_state_cf(FULL_H, FULL_W, eng.device)
    times = {}
    faults = {}
    held = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        faults.setdefault(name, []).append(resource.getrusage(resource.RUSAGE_SELF).ru_minflt
                                           - f0)
        return out

    def readback(name, fn, hold):
        img = stage(name, fn)
        if hold:  # the orbit's caller holds its frame, and Engine._last_rgba the last
            held[name] = (held.get(name, ()) + (img,))[-2:]

    for f in range(frames):
        stage("update_scene: sanitize, flatten, to_device (host)",
              lambda: eng.update_scene(build(D, f), **overrides))
        sc, cfg = eng._scene_t, eng._cfg
        tables = stage("pack_tables (plain torch, once a frame)", lambda: MK.pack_tables(sc))
        if two_phase:
            a = stage("K7 render_phase_a", lambda: MK.render_phase_a(sc, cfg, tables))
            order, count = stage("coherence key + torch.sort", lambda: TP.coherence_order(a))
            acc = stage("K8 render_phase_b", lambda: MK.render_phase_b(
                sc, cfg, order, count, a[:R.NUM_CH], a[R.CH_HIT:], tables))
        else:
            acc = stage("K1 render_accum", lambda: MK.render_accum(sc, cfg, tables=tables))
        if cfg.num_photons:
            n = cfg.num_photons
            stores = stage("K5 emit_and_trace (emission in the kernel)",
                           lambda: PK.emit_and_trace(sc, n, 0, n, tables))
            pmap = stage("build_photon_hash (torch sort, searchsorted)",
                         lambda: PP.build_photon_hash(*stores))
            stage("K6 add_caustics (into the planes)",
                  lambda: PK.add_caustics(pmap, acc, cfg.samples_per_pixel))
        out = stage("K9 assemble", lambda: G.assemble(sc, cfg, acc))
        gb = out.gbuffer
        sqrt_rough = gb.normal_roughness[3]
        curr = stage("K10 reblur_prepass", lambda: K.reblur_prepass(
            PD._hitdist_planes(gb), gb.view_z, sqrt_rough))
        packed = stage("K2 reproject_accumulate", lambda: K.reproject_accumulate(
            state.packed, curr, gb.motion, gb.view_z, torch.square(sqrt_rough), gb.motion_spec))
        state = PD.DenoiserStateCF(packed=packed)
        normal, guide = stage("decode normals + guide planes (plain torch)", lambda: (
            PD.decode_oct_cf(gb.normal_roughness), PD.guide_cf(packed, gb.view_z, sqrt_rough)))
        ds = stage("K3 atrous (anti-firefly and 3 passes, one launch)", lambda: K.atrous(
            torch.cat([packed[0:3], packed[4:7]]), gb.view_z, normal, guide))
        stage("K4 shadow_denoise", lambda: K.shadow_denoise(gb.shadow_data, gb.obj_id, gb.view_z,
                                                            normal))
        color01 = stage("composite_cf (plain torch)", lambda: composite.composite_cf(
            gb, out.raw_specular, sc.exposure, sc.tone_map_operator, sc.gamma,
            denoised_diffuse=ds[0:3], denoised_specular=ds[3:6], use_denoised=True,
            nrd_bypass_distance=sc.nrd_bypass_distance, nrd_bypass_blend=sc.nrd_bypass_blend))
        rgba = stage("to_rgba8_cf (plain torch)", lambda: tonemap.to_rgba8_cf(color01))
        readback("readback through pinned blocks (runtime/readback.py)",
                 lambda: read_back(rgba, out.rays)[0], True)
        readback("compare: readback .cpu().numpy(), held", lambda: rgba.cpu().numpy(), True)
        readback("compare: readback .cpu().numpy(), dropped", lambda: rgba.cpu().numpy(), False)
    if meshes is not None:
        c = eng._blas_cache
        print(f"phase 7 {label} mesh caches after {frames} frames: SAH builds {c.build_count}, "
              f"retransforms {c.retransform_count}, combines {c.combine_count}, device-table "
              f"builds {c.upload_count}", flush=True)
    print(f"phase 7 {label} minor page faults of the readbacks, frames 1-{frames - 1}: "
          + "; ".join(f"{name} {n[1:]}" for name, n in faults.items() if "readback" in name),
          flush=True)
    return times


def print_stages(label, stages):
    for name, ms in stages.items():
        print(f"phase 7 {label} stage {name}: median {float(np.median(ms[1:])):.3f} ms "
              f"(frame 0: {ms[0]:.3f}; frames 1-4: {[round(m, 3) for m in ms[1:]]})", flush=True)
    total = sum(float(np.median(ms[1:])) for name, ms in stages.items()
                if not name.startswith("compare:"))
    print(f"phase 7 {label} sum of stage medians {total:.3f} ms", flush=True)


def run_engine(P, D, label, build, counters, meshes=None, overrides=OVERRIDES, two_phase=False):
    """Three orbiting 1080p frames through the Engine (on the card, its
    default), every launch count set to 0 just before and read just after;
    checks the frames. Returns (launches, the Engine)."""
    for c in counters.values():
        c.launches = 0
    eng = P.Engine(FULL_W, FULL_H, mesh_service=None if meshes is None else mesh_service(meshes),
                   two_phase=two_phase)
    if eng.device.type != "cuda":
        raise AssertionError(f"Engine(w, h) runs on {eng.device}, not the card")
    imgs = []
    for f in range(FRAMES):
        t0 = time.perf_counter()
        eng.update_scene(build(D, f), **overrides)
        upd = (time.perf_counter() - t0) * 1e3
        imgs.append(eng.render())
        print(f"phase 5 {label} frame {f}: {eng.last_render_ms:.2f} ms, {eng.last_rays} rays, "
              f"{eng.last_mrays_per_s:.1f} Mrays/s (update_scene {upd:.1f} ms)", flush=True)
    launches = {name: c.launches for name, c in counters.items()}
    print(f"phase 5 {label} launches: {launches}", flush=True)
    for name in ("assemble", "reblur_prepass", "reproject_accumulate", "atrous",
                 "shadow_denoise"):
        if launches[name] != FRAMES:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times in {FRAMES} "
                                 "frames, not once a frame")
    for img in imgs:
        if img.shape != (FULL_H, FULL_W, 4) or img.dtype != np.uint8:
            raise AssertionError(f"frame shape {img.shape} {img.dtype}")
        if not img[..., :3].any():
            raise AssertionError("an all-zero frame")
    if not bool(torch.isfinite(eng._denoise_state.packed).all()):
        raise AssertionError("non-finite denoiser history")
    if not bool(torch.isfinite(eng._last_hdr_t).all()):
        raise AssertionError("non-finite HDR frame")
    return launches, eng


def compare_small(P, D, label, build, frames, meshes=None, overrides=OVERRIDES,
                  two_phase=False):
    """96x54 frames through the CUDA Engine and the CPU's plain pipeline:
    ray counts equal, RGBA |d| <= 1 on >= 99.5% of pixels. Returns each
    frame's linear HDR colour [3,H,W] on the host, (CUDA, CPU) a frame."""
    w, h = 96, 54
    ms = None if meshes is None else mesh_service(meshes)
    gpu_e = P.Engine(w, h, device="cuda", mesh_service=ms, two_phase=two_phase)
    cpu_e = P.Engine(w, h, device="cpu", mesh_service=ms, two_phase=two_phase)
    hdrs = []
    for f in range(frames):
        for e in (gpu_e, cpu_e):
            e.update_scene(build(D, f), **overrides)
        a, b = gpu_e.render(), cpu_e.render()
        dd = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
        print(f"phase 6 {label} {w}x{h} frame {f}: rays cuda {gpu_e.last_rays} cpu "
              f"{cpu_e.last_rays}, RGBA |d|<=1 on {(dd <= 1).mean():.5f}, max {dd.max()} "
              f"(cpu frame {cpu_e.last_render_ms:.0f} ms)", flush=True)
        if gpu_e.last_rays != cpu_e.last_rays or (dd <= 1).mean() < 0.995:
            raise AssertionError("CUDA frame differs from the CPU plain frame beyond the band")
        hdrs.append((gpu_e._last_hdr_t.cpu(), cpu_e._last_hdr_t))
    return hdrs


def caustic_share(hdr, plain_hdr):
    """Share of pixels where frame `hdr` differs from `plain_hdr`, the same
    frame rendered without caustics: the pixels its caustic lights."""
    return float(((hdr - plain_hdr).abs().amax(0) > 0).float().mean())


def walk_rays(R, I, C, sc, cfg, seed):
    """Rays of a frame for the walk-only kernels. Closest: the camera rays,
    and from every mesh hit point a random direction, skip-self by its
    instance on half of them and a pending thickness query into it on a
    quarter. Shadow: from every hit point (the analytic closest hit and the
    mesh walk) to each point light and along each directional light, 5% of
    them seeded blocked. Returns ((o, d, skip_active, skip_inst,
    thick_inst), (o, d, max_dist, blocked0))."""
    from raytracevs_tpu_torch.ops import sampling, vec

    dev = sc.cam_pos.device
    n = cfg.width * cfg.height
    idx = torch.arange(n, device=dev)
    cam = R.primary_rays(sc, cfg, idx % cfg.width, idx // cfg.width, 0,
                         sampling.blue_noise_tile(dev))
    o, d = cam.origin.contiguous(), cam.direction.contiguous()
    h = I.trace_closest(sc, o, d, torch.full((n,), C.RAY_TMIN, device=dev),
                        torch.full((n,), C.RAY_TMAX, device=dev))
    pos = (o + d * h.t[:, None])[h.hit]
    on_mesh = (h.obj_type == C.OBJECT_TYPE_MESH)[h.hit]
    g = torch.Generator(device=dev).manual_seed(seed)
    mo = pos[on_mesh]
    minst = h.obj_index[h.hit][on_mesh].to(torch.int32)
    m = mo.shape[0]
    md = vec.normalize(torch.randn((m, 3), generator=g, device=dev))
    r = torch.rand((m,), generator=g, device=dev)
    no = torch.zeros((n,), dtype=torch.bool, device=dev)
    closest = (torch.cat([o, mo]).contiguous(), torch.cat([d, md]).contiguous(),
               torch.cat([no, r < 0.5]),
               torch.cat([torch.zeros((n,), dtype=torch.int32, device=dev), minst]),
               torch.cat([torch.full((n,), -1, dtype=torch.int32, device=dev),
                          torch.where(r >= 0.75, minst, -1)]))
    so, sd, sm = [], [], []
    for i in range(int(sc.num_lights)):
        lpos = sc.lt_position[i]
        if int(sc.lt_type[i]) == C.LIGHT_TYPE_POINT:
            to_l = lpos[None, :] - pos
            dist = vec.length(to_l)
            so.append(pos)
            sd.append(to_l / dist[:, None])
            sm.append(dist)
        elif int(sc.lt_type[i]) == C.LIGHT_TYPE_DIRECTIONAL:
            so.append(pos)
            sd.append(vec.normalize(-lpos)[None, :].expand_as(pos))
            sm.append(torch.full((pos.shape[0],), 10000.0, device=dev))
    sm = torch.cat(sm)
    shadow = (torch.cat(so).contiguous(), torch.cat(sd).contiguous(), sm.contiguous(),
              torch.rand(sm.shape, generator=g, device=dev) < 0.05)
    return closest, shadow


def check_walks(label, MW, B, C, mesh, rays):
    """The walk-only kernels against the plain walks on `rays`
    (walk_rays'): every output bit-equal. Returns (closest rays, shadow
    rays, ms of the kernels' closest walk over the camera rays and of the
    plain one)."""
    (o, d, skip, sinst, thick), (so, sd, sm, blocked) = rays
    n = o.shape[0]
    got = MW.closest(mesh, o, d, C.RAY_TMIN, C.RAY_TMAX, skip, sinst, thick)
    want = B.traverse_closest(mesh, o, d, torch.full((n,), C.RAY_TMIN, device=o.device),
                              torch.full((n,), C.RAY_TMAX, device=o.device), skip_active=skip,
                              skip_inst=sinst, thick_inst=thick)
    same = {f: torch.equal(getattr(got, f), getattr(want, f)) for f in B.TriHit._fields}
    gs = MW.shadow(mesh, so, sd, sm, blocked)
    ws = B.traverse_shadow(mesh, so, sd, sm, blocked0=blocked)
    same.update({f: torch.equal(a, b) for f, a, b in zip(("vis", "color", "occ"), gs, ws)})
    print(f"phase 4 walks {label}: {n} closest rays ({int(want.hit.sum())} hit, "
          f"{int((thick >= 0).sum())} with a thickness query, {int(skip.sum())} skip-self), "
          f"{so.shape[0]} shadow rays ({int((ws[0] == 0).sum())} blocked); bit-equal {same}",
          flush=True)
    if not all(same.values()):
        raise AssertionError(f"the walk-only kernels differ from the plain walks ({label})")
    return n, so.shape[0]


def walk_counts(MK, R, TP, sc, cfg, cfg1):
    """The counting build's counts ([len(R.COUNT_ROWS), 4] int64 on the
    host: the walk rows ops/bvh.py::WALK_CLASSES, columns walks, node
    fetches, box tests, triangle tests, then the DFS rows) of K1-mesh at
    cfg and of K7 and K8 at cfg1; its planes must equal the plain
    instantiation's."""
    k1, k7, k8 = new_counts(R, 3)
    same = [torch.equal(MK.render_accum(sc, cfg, counts=k1), MK.render_accum(sc, cfg))]
    a = MK.render_phase_a(sc, cfg1, counts=k7)
    same.append(same_bits(a, MK.render_phase_a(sc, cfg1)))
    order, count = TP.coherence_order(a)
    b = MK.render_phase_b(sc, cfg1, order, count, a[:R.NUM_CH].clone(), a[R.CH_HIT:], counts=k8)
    same.append(torch.equal(b, MK.render_phase_b(sc, cfg1, order, count, a[:R.NUM_CH].clone(),
                                                 a[R.CH_HIT:])))
    if not all(same):
        raise AssertionError(f"the counting build's planes differ from the kernels' {same}")
    return k1.cpu(), k7.cpu(), k8.cpu()


def plain_walk_counts(R, TP, sc, cfg, cfg1):
    """The same counts of the plain versions (the plain threaded walks) in
    the plain K1-mesh, phase A and phase B."""
    k1, k7, k8 = new_counts(R, 3)
    R.render_accum(sc, cfg, counts=k1)
    a = R.render_accum_phase_a(sc, cfg1, counts=k7)
    order, count = TP.coherence_order(a)
    R.render_accum_phase_b(sc, cfg1, order[:int(count)], a[:R.NUM_CH].clone(), a[R.CH_HIT:],
                           counts=k8)
    return k1.cpu(), k7.cpu(), k8.cpu()


def print_counts(B, label, counts):
    """The walk rows of counting-build counts, per walk."""
    for i, name in enumerate(B.WALK_CLASSES):
        walks, fetches, boxes, tris = (int(x) for x in counts[i])
        per = max(walks, 1)
        print(f"phase 4 walk counts {label}, {name}: {walks} walks; per walk {fetches / per:.3f} "
              f"node fetches, {boxes / per:.3f} box tests, {tris / per:.3f} triangle tests",
              flush=True)
    tot = counts[:4].sum(0)
    print(f"phase 4 walk counts {label}, all: {int(tot[0])} walks, {int(tot[1])} node fetches, "
          f"{int(tot[2])} box tests, {int(tot[3])} triangle tests", flush=True)


def walk_ops(counts):
    """Float operations of the walks' box and triangle tests at `counts`
    (the walk rows of the counting build's)."""
    tot = counts[:4].sum(0)
    return int(tot[2]) * BOX_TEST_OPS + int(tot[3]) * TRI_TEST_OPS


def render_ops(R, sc, counts):
    """Float operations a render kernel needs at the counting build's
    `counts` (R.COUNT_ROWS): the shading, the shadow samples, the
    intersection tests of every closest hit, shadow and thickness ray, and
    the mesh walks' tests."""
    row = {k: [int(x) for x in counts[i]] for i, k in enumerate(R.COUNT_ROWS)}
    _, _, capped, _ = row["dfs"]
    shade0, shade1, shadow, thick = row["rays"]
    misses, glass, opaque, lit = row["hits"]
    direct, select, ambient = light_counts(sc)
    return ((misses + capped) * SKY_OPS + (glass + opaque) * HIT_OPS
            + glass * (GLASS_CHILD_OPS + direct * GLASS_LIGHT_OPS)
            + opaque * (OPAQUE_OPS + select * SELECT_OPS + direct * LIGHT_OPS
                        + ambient * AMBIENT_OPS)
            + lit * LIT_OPS + shadow * SHADOW_SAMPLE_OPS
            + (shade0 + shade1 + shadow) * closest_ops(sc) + thick * SPHERE_OPS
            + walk_ops(counts))


def check_counts(R, label, counts, plain, exact_walks=False):
    """Counting-build counts (R.COUNT_ROWS, on the host) against the plain
    version's on the same inputs: the DFS rows equal but the warp figure,
    the walks and triangle tests equal (every walk column with
    exact_walks: the threaded walks'). Prints the DFS rows and the DFS
    loop's SIMT share."""
    counts, plain = counts.cpu(), plain.cpu()
    dfs = R.COUNT_ROWS.index("dfs")
    share = int(counts[dfs, 0]) / max(int(counts[dfs, 1]), 1)
    print(f"phase 4 counts {label}: lane iterations {int(counts[dfs, 0])}, warp iterations x 32 "
          f"{int(counts[dfs, 1])} (SIMT share {share:.4f}), capped {int(counts[dfs, 2])}, killed "
          f"{int(counts[dfs, 3])}; shade calls at depth 0 and deeper, shadow and thickness rays "
          f"{counts[dfs + 1].tolist()}; misses, glass hits, other hits, lights shaded "
          f"{counts[dfs + 2].tolist()}", flush=True)
    walks = (counts[:4] == plain[:4]).all() if exact_walks else (
        counts[:4, [0, 3]] == plain[:4, [0, 3]]).all()
    same = bool(walks) and torch.equal(counts[dfs + 1:], plain[dfs + 1:]) and torch.equal(
        counts[dfs, [0, 2, 3]], plain[dfs, [0, 2, 3]])
    if not same:
        raise AssertionError(f"the counting build's counts ({label}) differ from the plain "
                             f"version's:\n{counts}\n{plain}")
    return counts


def counted(MK, R, label, run, plain, exact_walks=False):
    """check_counts of the counting build's counts of run(counts)."""
    counts = torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64, device="cuda")
    run(counts)
    return check_counts(R, label, counts, plain, exact_walks)


def new_counts(R, n=1):
    """n zeroed count tables (R.COUNT_ROWS) on the card."""
    return [torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64, device="cuda")
            for _ in range(n)]


def check_deep_forest(P, D, MK, MW, R, TP, B, C, I, w, h):
    """The deep forest through the threaded instantiations at w x h: K1-mesh
    (spp 2), K7 and K8 (spp 1) and the walks alone, each against its plain
    version; their counting builds' counts equal the plain versions',
    node fetches included (both walk the threaded links). Returns the
    largest colour max |d|."""
    from raytracevs_tpu_torch.io import mesh_cache

    ms = TS.deep_forest_service(mesh_cache)
    scene = TS.deep_forest_scene(D)
    sc = P.to_device(P.flatten_scene(P.sanitize_scene(scene), aspect=w / h, mesh_service=ms),
                     "cuda")
    threaded = MK.check_mesh(sc.mesh, "chip_smoke")
    print(f"phase 4 deep forest: {sc.mesh.num_tris} triangles, {sc.mesh.num_nodes} nodes, a wide "
          f"walk stack of {sc.mesh.wide_stack} (the kernels hold {B.WALK_STACK}): threaded walks "
          f"{threaded}", flush=True)
    if not threaded:
        raise AssertionError("the deep forest does not need the threaded walks")
    cfg = P.make_config(scene, w, h, max_soft_samples=2)
    plain = new_counts(R)[0]
    err = check_k1("phase 4 K1-mesh, deep forest,", MK, R, sc, cfg, plain)[0]
    counted(MK, R, f"K1-mesh, deep forest {w}x{h}",
            lambda k: MK.render_accum(sc, cfg, counts=k), plain, exact_walks=True)
    cfg1 = cfg._replace(samples_per_pixel=1)
    pa, pb = new_counts(R, 2)
    err = max(err, *check_phases("deep forest", MK, R, TP, sc, cfg1, (pa, pb))[:2])
    counted(MK, R, f"K7, deep forest {w}x{h}",
            lambda k: MK.render_phase_a(sc, cfg1, counts=k), pa, exact_walks=True)
    a = MK.render_phase_a(sc, cfg1)
    order, count = TP.coherence_order(a)
    counted(MK, R, f"K8, deep forest {w}x{h}", lambda k: MK.render_phase_b(
        sc, cfg1, order, count, a[:R.NUM_CH].clone(), a[R.CH_HIT:], counts=k), pb,
        exact_walks=True)
    check_walks(f"deep forest {w}x{h}", MW, B, C, sc.mesh, walk_rays(R, I, C, sc, cfg, 4))
    return err


def denoise_inputs(P, D, PD, K, dev):
    """The denoiser kernels' inputs at 1080p: the G-buffer of the second of
    two orbiting demo frames, with the first frame's denoised history.
    Returns (K2's arguments, K2's output, K3's arguments, built on that
    output, K4's arguments)."""
    from raytracevs_tpu_torch.ops.render_cf import render_rows_cf

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
    normal = PD.decode_oct_cf(gb.normal_roughness)
    guide = PD.guide_cf(new_state, gb.view_z, sqrt_rough)
    k3_args = (torch.cat([new_state[0:3], new_state[4:7]]).contiguous(), gb.view_z, normal, guide)
    k4_args = (gb.shadow_data, gb.obj_id, gb.view_z, normal)
    return k2_args, new_state, k3_args, k4_args


# ---- scene files, the photon debug modes, the Engine's surface, the CLI ----

# the render kernels' mode-0 instantiations in the build log, by a piece of
# their mangled names, with the parent tree's ptxas figures (PR 8's, built
# beside this tree's by scripts/torch_k1_ab.py): registers, spill stores.
# K1, K7 and K8 analytic and with meshes (whole frames), K6's add.
PTXAS_PR8 = (
    ("K1", "render_accum_kernelILi0ELb0ELb0E", (128, 0)),
    ("K7", "render_accum_kernelILi0ELb1ELb0E", (120, 0)),
    ("K1-mesh", "render_accum_kernelILi1ELb0ELb0E", (184, 0)),
    ("K7-mesh", "render_accum_kernelILi1ELb1ELb0E", (128, 292)),
    ("K8", "render_phase_b_kernelILi0E", (128, 0)),
    ("K8-mesh", "render_phase_b_kernelILi1E", (186, 0)),
    ("K6 (add)", "photon_gather_kernelILb0E", (40, 4)),
)


def ptxas_mode0(log_path):
    """Registers and spill stores of the mode-0 instantiations (PTXAS_PR8)
    in the library's build log, printed beside PR 8's; raises unless K1
    and K7 keep at most 128 registers without spill stores and K1-mesh its
    PR 8 registers without spill stores. Returns {name: (registers, spill
    stores)}."""
    import re

    found, entry, spills = {}, None, None
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                entry = next((k for k, piece, _ in PTXAS_PR8 if piece in name
                              and "_count_" not in name and "_threaded_" not in name), None)
            elif entry and "spill stores" in line:
                spills = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            elif entry and "registers" in line:
                found.setdefault(entry, (int(re.search(r"Used (\d+) registers", line).group(1)),
                                         spills))
                entry = None
    for name, _, (regs8, spills8) in PTXAS_PR8:
        regs, sp = found[name]
        print(f"phase 3 ptxas mode 0 {name}: {regs} registers, {sp} bytes of spill stores "
              f"(PR 8: {regs8} registers, {spills8} bytes)", flush=True)
    if any(found[k][0] > 128 or found[k][1] for k in ("K1", "K7")):
        raise AssertionError("K1 or K7 passed 128 registers or spilled in mode 0")
    if found["K1-mesh"] != (184, 0):
        raise AssertionError(f"K1-mesh's registers or spills moved: {found['K1-mesh']}")
    return found


def write_scene_file(path, scene):
    """`scene` as a .rtvs file, through the port's save_graph: tests/
    _torch_scenes.py::scene_graph, the box turned as demo_scene's. It
    evaluates to as_evaluated(scene), the directional lights' directions
    normalized."""
    from raytracevs_tpu_torch.scene import graph as G
    from raytracevs_tpu_torch.scene import nodes as N
    from raytracevs_tpu_torch.scene.rtvs import save_graph

    save_graph(TS.scene_graph(N, G, scene, [TS.DEMO_BOX_QUAT]), path)


def flat_bytes(flat):
    """A host FlatScene's leaves as bytes, the mesh's fine tree included."""
    from raytracevs_tpu_torch.ops import bvh as B

    out = {n: np.asarray(v).tobytes() for n, v in zip(flat._fields, flat) if n != "mesh"}
    if flat.mesh is not None:
        out.update({f"mesh.{n}": np.asarray(getattr(flat.mesh, n)).tobytes()
                    for n in B.FINE_FIELDS})
    return out


def check_scene_file(P, D, label, build, counters, path, meshes=None):
    """Phase 8: build(D, 0) written as a .rtvs file; Engine(1920, 1080)
    .load_rtvs renders FRAMES frames, every launch count set to 0 just
    before and read just after. Its FlatScene leaves must be bit-equal to
    the in-code scene's, and its frames to those of an Engine fed the
    in-code SceneData. Returns (launches, the in-code Engine)."""
    write_scene_file(path, build(D, 0))
    ms = None if meshes is None else mesh_service(meshes)
    for c in counters.values():
        c.launches = 0
    eng = P.Engine(FULL_W, FULL_H, mesh_service=ms)
    t0 = time.perf_counter()
    eng.load_rtvs(path, **OVERRIDES)
    load_ms = (time.perf_counter() - t0) * 1e3
    imgs = []
    for f in range(FRAMES):
        imgs.append(eng.render())
        print(f"phase 8 {label} file frame {f}: {eng.last_render_ms:.2f} ms, {eng.last_rays} "
              f"rays (load_rtvs with update_scene {load_ms:.1f} ms)", flush=True)
    launches = {name: c.launches for name, c in counters.items()}
    print(f"phase 8 {label} launches: {launches}", flush=True)
    ref = P.Engine(FULL_W, FULL_H, mesh_service=ms)
    ref.update_scene(TS.as_evaluated(build(D, 0)), **OVERRIDES)
    a, b = flat_bytes(eng._flat._replace(frame_index=ref._flat.frame_index)), flat_bytes(ref._flat)
    differ = [n for n in a if a[n] != b[n]]
    same = [bool(np.array_equal(img, ref.render())) for img in imgs]
    print(f"phase 8 {label}: {len(a)} FlatScene leaves, differing {differ}; the {FRAMES} frames "
          f"bit-equal to the in-code scene's {same}", flush=True)
    if differ or not all(same):
        raise AssertionError(f"the {label} scene file differs from its in-code scene")
    for name in ("render_accum", "assemble", "reblur_prepass", "reproject_accumulate", "atrous",
                 "shadow_denoise"):
        if launches[name] < FRAMES:
            raise AssertionError(f"{name} launched {launches[name]} times in {FRAMES} frames of "
                                 f"the {label} file")
    return launches, ref


def check_debug_k1(P, MK, R, sc, scene, w, h, label, overrides=OVERRIDES, modes=(3, 4)):
    """K1 (or K1-mesh) and K7 in the photon debug modes `modes` against
    their plain versions, every plane bit-equal, at w x h (K7 at spp 1);
    the mode changes the planes. Returns the largest colour max |d| of K1
    and of K7 (0 both)."""
    err, err_a = 0.0, 0.0
    for mode in modes:
        cfg = P.make_config(scene, w, h, **dict(overrides, photon_debug_mode=mode))
        err = max(err, check_k1(f"phase 9 {label} mode {mode},", MK, R, sc, cfg)[0])
        if torch.equal(MK.render_accum(sc, cfg), MK.render_accum(sc, cfg._replace(
                photon_debug_mode=0))):
            raise AssertionError(f"mode {mode} leaves the {label} planes as mode 0's")
        c1 = cfg._replace(samples_per_pixel=1)
        got, want = MK.render_phase_a(sc, c1), R.render_accum_phase_a(sc, c1)
        bits = same_bits(got, want)
        err_a = max(err_a, assert_like_plain(f"phase 9 K7 {label} mode {mode} spp 1,", R, c1,
                                             got, want, f"; every plane bit-equal {bits}"))
        if not bits:
            raise AssertionError(f"K7 {label} mode {mode}: planes differ from plain phase A's")
    return err, err_a


def check_k6_replace(P, PP, PK, R, MK, sc, scene, w, h):
    """K6 in replacement mode (photon debug scale 1 and 4) against its plain
    version on K1's planes of a caustics frame at w x h: the colour,
    primary, diffuse, specular and shadow planes within 1e-5 * max(1,
    |plain|), every other plane's bits kept. Returns the max |d|."""
    cfg = P.make_config(scene, w, h, **CAUSTICS)
    acc = MK.render_accum(sc, cfg)
    pmap = PP.emit_and_trace(sc, cfg.num_photons)
    ch = [c for r in (R.CH_COLOR, R.CH_PRIMARY, R.CH_DIFFUSE, R.CH_SPECULAR)
          for c in range(r, r + 3)] + [R.CH_SHADOW_VIS, R.CH_SHADOW_PEN, R.CH_SHADOW_DIST]
    others = [c for c in range(R.NUM_CH) if c not in ch]
    err = 0.0
    for scale in (1.0, 4.0):
        got, want = acc.clone(), acc.clone()
        PK.add_caustics(pmap, got, cfg.samples_per_pixel, replace=True, scale=scale)
        PP.add_caustics(pmap, want, cfg.samples_per_pixel, replace=True, scale=scale)
        d = (got[ch] - want[ch]).abs()
        ok = bool((d <= 1e-5 * want[ch].abs().clamp(min=1.0)).all())
        kept = same_bits(got[others], acc[others])
        changed = int((want[ch] != acc[ch]).any(0).sum())
        err = max(err, float(d.max()))
        print(f"phase 9 K6 replacement {w}x{h}, scale {scale}: {changed} pixels replaced, max |d| "
              f"{float(d.max()):.3g} (within 1e-5 {ok}), other planes' bits kept {kept}",
              flush=True)
        if not (ok and kept and changed):
            raise AssertionError("K6 in replacement mode disagrees with its plain version")
    return err


# ---- row-sharded rendering and the live viewer ----

def reached_history(ext, motion, motion_spec, halo, row0, global_h):
    """(bytes, rows) of the extended history [16, rows + 2 halo, W] that
    K2's slab form must read on this input: the 16 planes at each element
    one of its surface-motion bilinear taps reaches, and the 7 specular
    planes at each further element a virtual-motion tap of a pixel whose
    virtual motion lands in the frame reaches (taps of nonzero weight,
    clamped to the buffer as the kernel clamps them); rows, those holding
    such an element."""
    hx, w = ext.shape[1:]
    h = motion.shape[1]
    ys = torch.arange(h, device=ext.device, dtype=torch.float32)[:, None] + row0
    xs = torch.arange(w, device=ext.device, dtype=torch.float32)[None, :]

    def reached(m, keep):
        px, py = xs - m[0], ys - m[1]
        fx, fy = torch.floor(px), torch.floor(py)
        x0, y0 = fx.long(), fy.long() + (halo - row0)
        hit = torch.zeros(hx * w, dtype=torch.bool, device=ext.device)
        for dy in (0, 1):
            for dx in (0, 1):
                # a tap of weight 0 (an integral coordinate) is not needed
                need = keep & ((px != fx) if dx else True) & ((py != fy) if dy else True)
                idx = (y0 + dy).clamp(0, hx - 1) * w + (x0 + dx).clamp(0, w - 1)
                hit[idx[need]] = True
        return hit

    surf = reached(motion, torch.ones(h, w, dtype=torch.bool, device=ext.device))
    vx, vy = xs - motion_spec[0], ys - motion_spec[1]
    virt_in = (vx >= 0) & (vx <= w - 1) & (vy >= 0) & (vy <= global_h - 1)
    spec = reached(motion_spec, virt_in) & ~surf
    nbytes = 4 * (16 * int(surf.sum()) + 7 * int(spec.sum()))
    return nbytes, int((surf | spec).view(hx, w).any(1).sum())


def slab_pass_args(PD, k3_args, row0, rows, stride, clamp, slabs=None):
    """K3-pass's slab-form arguments for frame rows [row0, row0 + rows) of
    k3_args = (img6, view_z, normal, guide): the slab, its neighbours' rows
    as views (of `slabs`, the frame's row slabs, where given: planes a slab
    apart, as the sharded denoise passes them; else of the frame), and z,
    normal and guide extended by ATROUS_REACH rows once."""
    img, view_z, normal, guide = k3_args
    h = view_z.shape[0]
    na, nb = PD.pass_halo(row0, rows, h, stride + int(clamp))
    a0, a1 = max(row0 - PD.ATROUS_REACH, 0), min(row0 + rows + PD.ATROUS_REACH, h)
    aux = torch.cat([view_z[None], normal, guide])[:, a0:a1].contiguous()
    if slabs is None:
        own, above, below = (img[:, row0:row0 + rows].contiguous(), img[:, row0 - na:row0],
                             img[:, row0 + rows:row0 + rows + nb])
    else:
        i = row0 // rows
        own = slabs[i]
        above = slabs[i - 1][:, rows - na:] if na else own[:, :0]
        below = slabs[i + 1][:, :nb] if nb else own[:, :0]
    return own, above, below, aux[0], aux[1:4], aux[4:6], row0, h, stride, clamp


def pass_kernel_occupancy():
    """{(stride, clamp): (registers, spill stores, shared bytes a block,
    blocks an SM)} of K3-pass's instantiations: ptxas's log, and
    rtvs_denoise_occupancy."""
    import re

    from raytracevs_tpu_torch.ops.cuda import _build

    occ = (ctypes.c_int * 15)()
    _build.check(_build.load_library().rtvs_denoise_occupancy(occ), "rtvs_denoise_occupancy")
    found, key, spills = {}, None, None
    with open(_build.build_log_path()) as f:
        for line in f:
            if "Compiling entry function" in line:
                m = re.search(r"atrous_pass_kernelILi(\d)ELb([01])E", line)
                key = (int(m.group(1)), m.group(2) == "1") if m else None
            elif key and "spill stores" in line:
                spills = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            elif key and "registers" in line:
                found[key] = (int(re.search(r"Used (\d+) registers", line).group(1)), spills)
                key = None
    out = {}
    keys = ((1, False), (1, True), (2, False), (2, True), (4, False), (4, True))
    for k, key in enumerate(keys):
        out[key] = found[key] + (occ[3 + 2 * k], occ[4 + 2 * k])
    return out


def check_slab_kernels(K, PD, k2_args, k3_args):
    """Phase 4a: the per-pass a-trous kernel at strides 1, 2 and 4, with and
    without the clamp, bit-equal to its plain version on the 1080p
    G-buffer's planes and on them cut to 1917x1079, whole frames and the
    slab form (the top, second and last of four row slabs, the last taking
    the remainder, the neighbours' rows as views), and its chain of three
    whole-frame launches bit-equal to the fused K3; K2's slab form on the
    270-row slabs at row0 270 and 810, the history extended by
    TEMPORAL_HALO rows, within 1e-5 of its plain version (which is
    bit-equal to the whole frame's rows). Times both at the sharded path's
    shapes (an interior slab; K3-pass in its slab form with its registers,
    spills and blocks an SM). Returns their kernel rows."""
    k3_err = 0.0
    for cut in (None, (FULL_H - 1, FULL_W - 3)):
        args = k3_args if cut is None else [a[..., :cut[0], :cut[1]].contiguous()
                                            for a in k3_args]
        h, w = args[1].shape
        rows = h // SHARDS
        for stride in (1, 2, 4):
            for clamp in (False, True):
                got = K.atrous_pass(*args, stride, clamp)
                want = PD.atrous_single_pass(*args, stride, clamp)
                err = float((got - want).abs().max())
                k3_err = max(k3_err, err)
                if not same_bits(got, want):
                    raise AssertionError(f"atrous_pass stride {stride} clamp {clamp} {w}x{h}: "
                                         f"max |d| {err:.3g}")
                for row0, n in ((0, rows), (rows, rows), (3 * rows, h - 3 * rows)):
                    a = slab_pass_args(PD, args, row0, n, stride, clamp)
                    got_s = K.atrous_pass_slab(*a)
                    want_s = PD.atrous_pass_slab(*a)
                    err = float((got_s - want_s).abs().max())
                    k3_err = max(k3_err, err)
                    if not (same_bits(got_s, want_s) and same_bits(want_s, want[:, row0:row0 + n])):
                        raise AssertionError(f"atrous_pass_slab stride {stride} clamp {clamp} "
                                             f"{w}x{h} rows [{row0}, {row0 + n}): max |d| "
                                             f"{err:.3g}")
        chain = args[0]
        for p in range(PD.ATROUS_PASSES):
            chain = K.atrous_pass(chain, *args[1:], 1 << p, p == 0)
        fused = same_bits(chain, K.atrous(*args))
        print(f"phase 4a K3-pass {w}x{h}: strides 1, 2, 4 with and without the clamp, whole "
              f"frames and the top, second and last slabs, bit-equal to the plain version; the "
              f"chain of three launches bit-equal to the fused K3 {fused}", flush=True)
        if not fused:
            raise AssertionError("the three per-pass launches differ from the fused K3")
    rows, halo = FULL_H // SHARDS, PD.TEMPORAL_HALO
    state, rest = k2_args[0], k2_args[1:]
    ext = PD.exchange_row_halo([state[:, i * rows:(i + 1) * rows] for i in range(SHARDS)], halo)
    whole = PD.temporal_accumulate(*k2_args)
    whole_k = K.reproject_accumulate(*k2_args)
    k2_err, slab_args = 0.0, {}
    for i in (1, 3):
        sl = slice(i * rows, (i + 1) * rows)
        a = (ext[i],) + tuple(t[..., sl, :].contiguous() for t in rest)
        got = K.reproject_accumulate(*a, halo, i * rows, FULL_H)
        want = PD.temporal_accumulate(*a, halo, i * rows, FULL_H)
        err = float((got - want).abs().max())
        k2_err = max(k2_err, err)
        print(f"phase 4a K2-slab rows [{i * rows}, {(i + 1) * rows}) halo {halo}: max |d| "
              f"{err:.3g} against the plain slab form; the plain slab bit-equal to the whole "
              f"frame's rows {same_bits(want, whole[:, sl])}; the kernel's slab bit-equal to the "
              f"whole-frame kernel's rows {same_bits(got, whole_k[:, sl])}", flush=True)
        if err > 1e-5 or not same_bits(want, whole[:, sl]):
            raise AssertionError("K2's slab form disagrees with its plain version")
        slab_args[i] = a
    a, slab = slab_args[1], (halo, rows, FULL_H)  # the slab at row0 270
    ms = gpu_ms(lambda: K.reproject_accumulate(*a, *slab), 20)
    dev_t = device_ms(lambda: K.reproject_accumulate(*a, *slab), 20)
    plain_ms = gpu_ms(lambda: PD.temporal_accumulate(*a, *slab), 5)
    px = rows * FULL_W
    hist_bytes, hist_rows = reached_history(a[0], a[2], a[5], halo, rows, FULL_H)
    nbytes = hist_bytes + sum(t.nbytes for t in a[1:]) + 16 * px * 4
    print(f"  K2-slab ({rows} rows, history {rows + 2 * halo}, of which the taps reach "
          f"{hist_rows} rows, {hist_bytes / 1e6:.1f} MB): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)
    rows_out = {"K2-slab": kernel_row(k2_err, ms, plain_ms, nbytes, px * REPROJECT_OPS, dev_t)}
    # the three passes of an interior slab as the sharded denoise runs
    # them: the slab where it lies, its neighbours' rows as views of theirs
    occ = pass_kernel_occupancy()
    slabs = [k3_args[0][:, i * rows:(i + 1) * rows].contiguous() for i in range(SHARDS)]
    by_stride, sums = {}, np.zeros(5)
    for p in range(3):
        stride, clamp = 1 << p, p == 0
        args = slab_pass_args(PD, k3_args, rows, rows, stride, clamp, slabs)
        t_ms = gpu_ms(lambda: K.atrous_pass_slab(*args), 20)
        t_dev = device_ms(lambda: K.atrous_pass_slab(*args), 20)
        t_plain = gpu_ms(lambda: PD.atrous_pass_slab(*args), 5)
        px = rows * FULL_W
        # the slab's image rows and halo rows, the z and normal rows the
        # taps reach, the guide at each pixel, the 6 output planes
        nb = (6 * (rows + args[1].shape[1] + args[2].shape[1]) * FULL_W + 4 * (rows + 2 * stride)
              * FULL_W + 2 * px + 6 * px) * 4
        ops = px * PASS_OPS + ((rows + 2 * stride) * FULL_W * CLAMP_OPS if clamp else 0)
        b_ms = bound(nb, ops)[0]
        regs, spills, smem, blocks = occ[(stride, clamp)]
        by_stride[str(stride)] = dict(ms=t_ms, device_ms=t_dev[0], plain_ms=t_plain,
                                      bound_ms=b_ms, clamp=clamp, rows=rows, registers=regs,
                                      spill_stores=spills, shared_bytes=smem, blocks_an_sm=blocks)
        sums += (t_ms, t_dev[0], t_plain, nb, ops)
        print(f"  K3-pass stride {stride}{' with the clamp' if clamp else ''}, slab form on "
              f"{rows} rows: kernel {t_ms:.4f} ms, device {t_dev[0]:.4f} ms ({t_dev[1]}), plain "
              f"{t_plain:.4f} ms, bound {b_ms:.4f} ms ({nb / 1e6:.1f} MB), share "
              f"{b_ms / t_dev[0]:.4f}; {regs} registers, {spills} bytes of spill stores, "
              f"{smem} bytes of shared memory a block, {blocks} blocks an SM", flush=True)
    # the row: the mean of one launch over the three passes
    ms, dev, plain_ms, nb, ops = sums / 3
    rows_out["K3-pass"] = dict(kernel_row(k3_err, ms, plain_ms, nb, ops, (dev, "profiler")),
                               by_stride=by_stride)
    return rows_out


def run_sharded(P, D, label, build, counters, meshes=None, overrides=OVERRIDES, two_phase=False,
                timing=False):
    """Phase 12: FRAMES orbiting 1080p frames through Engine(1920, 1080,
    device_mesh=make_mesh([cuda:0] * SHARDS)), after the same frames
    through the single-device Engine: RGBA, HDR, the denoised planes and
    the history (its slabs stitched) bit-equal frame by frame. Every launch
    count is set to 0 just before the sharded frames and read just after.
    With timing, then both Engines' render() over 10 more frames of the
    last scene, by CUDA events and by the device's own time. Returns the
    launches (K2-slab: K2's slab-form launches)."""
    from raytracevs_tpu_torch.ops.cuda import denoise_kernels as K
    from raytracevs_tpu_torch.parallel.tiles import make_mesh

    ms = None if meshes is None else mesh_service(meshes)
    one = P.Engine(FULL_W, FULL_H, mesh_service=ms, two_phase=two_phase)
    ref = []
    for f in range(FRAMES):
        one.update_scene(build(D, f), **overrides)
        ref.append((one.render(), one._last_hdr_t, one._last_denoised, one._denoise_state.packed,
                    one.last_render_ms))
    for c in counters.values():
        c.launches = 0
    K.reproject_accumulate.slab_launches = 0
    four = P.Engine(FULL_W, FULL_H, mesh_service=ms, two_phase=two_phase,
                    device_mesh=make_mesh(["cuda:0"] * SHARDS))
    for f in range(FRAMES):
        four.update_scene(build(D, f), **overrides)
        img = four.render()
        img1, hdr1, den1, st1, ms1 = ref[f]
        same = dict(rgba=bool(np.array_equal(img, img1)), hdr=same_bits(four._last_hdr_t, hdr1),
                    denoised=all(same_bits(a, b) for a, b in zip(four._last_denoised, den1)),
                    state=same_bits(torch.cat([s.packed for s in four._denoise_state], 1), st1))
        print(f"phase 12 {label} frame {f}: sharded {four.last_render_ms:.2f} ms, one device "
              f"{ms1:.2f} ms; bit-equal {same}", flush=True)
        if not all(same.values()):
            raise AssertionError(f"{label}: the sharded frame {f} differs from the single-device "
                                 "frame")
    launches = {name: c.launches for name, c in counters.items()}
    launches["K2-slab"] = K.reproject_accumulate.slab_launches
    print(f"phase 12 {label} launches: {launches}", flush=True)
    if timing:
        for name, e in (("one device", one), ("sharded", four)):
            ms = gpu_ms(e.render, 10)
            dev = device_ms(e.render, 10)
            before = (f"; with a copy of 12 planes a slab a pass, the device was busy "
                      f"{SHARDED_BUSY_BEFORE_MS} ms" if name == "sharded" else "")
            print(f"phase 12 {label} {name}: render() {ms:.3f} ms a frame by CUDA events, the "
                  f"device busy {dev[0]:.3f} ms of it ({dev[1]}){before}", flush=True)
    del one
    n = FRAMES * SHARDS
    want = {"K2-slab": n, "atrous_pass": 3 * n, "shadow_denoise": n, "atrous": 0,
            "assemble": n, "reblur_prepass": n}
    if two_phase:
        want.update(render_phase_a=n, render_phase_b=n)
    else:
        want["render_accum"] = n
    if overrides.get("enable_caustics"):
        want.update(photon_trace=n, photon_gather=n)
    for name, k in want.items():
        if launches[name] != k:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times in {FRAMES} "
                                 f"sharded frames, not {k}")
    return launches


def check_viewer(path, counters):
    """Phase 13: the port's viewer on the card (ViewerState(path, 1280, 720))
    served on an ephemeral 127.0.0.1 port: five 1280x720 /frame.png, a
    setprop and its undo through /cmd (the graph changed, then restored),
    op=photon (photon debug mode 1: caustics on, K5 and K6 launch) with a
    frame served in it, op=debug 3 and back to 0, a resolution switch; its
    fps and render ms. The loop and the server stop at the end."""
    import tempfile
    import threading
    import urllib.request

    from raytracevs_tpu_torch.api import viewer as V
    from raytracevs_tpu_torch.io.png import read_png

    w, h = 1280, 720
    state = V.ViewerState(path, w, h, overrides=dict(OVERRIDES), device="cuda")
    server = V.make_server(state, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    t0 = time.perf_counter()

    def get(q):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{q}", timeout=120) as r:
            return r.status, r.read()

    def status():
        return json.loads(get("/status")[1])

    def wait_frames(n):
        deadline = time.time() + 120
        while time.time() < deadline:
            s = status()
            if s["frames"] >= n:
                return s
            time.sleep(0.02)
        raise AssertionError(f"the viewer served fewer than {n} frames")

    def frame_png(shape):
        code, png = get("/frame.png")
        with tempfile.NamedTemporaryFile(suffix=".png") as f:
            f.write(png)
            f.flush()
            img = read_png(f.name)
        if code != 200 or img.shape[:2] != shape:
            raise AssertionError(f"/frame.png: {code}, {img.shape}, expected {shape}")
        return img

    def cmd(q):
        out = json.loads(get("/cmd?" + q)[1])
        if "error" in out:
            raise AssertionError(f"/cmd?{q}: {out['error']}")
        return out

    try:
        for k in range(5):
            wait_frames(k + 1)
            frame_png((h, w))
        s = status()
        print(f"phase 13 viewer {w}x{h}: 5 frames served; {s['fps']:.1f} fps, render "
              f"{s['render_ms']:.2f} ms, {s['frames']} frames in {time.perf_counter() - t0:.1f} s",
              flush=True)
        graph = json.loads(get("/graph")[1])
        sphere = next(n for n in graph["nodes"] if n["type"] == "SphereNode")
        props = dict(sphere["properties"], Radius=sphere["properties"]["Radius"] + 0.1)
        from urllib.parse import quote

        cmd(f"op=setprop&node={sphere['id']}&props={quote(json.dumps(props))}")
        edited = json.loads(get("/graph")[1])
        cmd("op=undo")
        restored = json.loads(get("/graph")[1])
        changed, back = edited != graph, restored["nodes"] == graph["nodes"]
        print(f"phase 13 viewer setprop: the graph changed {changed}; undo restored it {back}",
              flush=True)
        if not (changed and back):
            raise AssertionError("the viewer's setprop/undo")
        for name in ("photon_trace", "photon_gather"):
            counters[name].launches = 0
        out = cmd("op=photon")
        s = wait_frames(out["frames"] + 2)
        frame_png((h, w))
        k5, k6 = counters["photon_trace"].launches, counters["photon_gather"].launches
        print(f"phase 13 viewer photon debug mode {s['photon_debug_mode']}: {s['render_ms']:.2f} "
              f"ms a frame; K5 launched {k5}, K6 {k6} times", flush=True)
        if s["photon_debug_mode"] != 1 or not (k5 and k6):
            raise AssertionError("the viewer's photon mode did not run the photon pass")
        for mode in (3, 0):
            out = cmd(f"op=debug&mode={mode}")
            wait_frames(out["frames"] + 2)
            frame_png((h, w))
        out = cmd("op=res&dir=1")
        s = wait_frames(out["frames"] + 3)
        res = V.RESOLUTIONS
        nw, nh = res[(res.index((w, h)) + 1) % len(res)]
        frame_png((nh, nw))
        print(f"phase 13 viewer after the switch to {s['width']}x{s['height']}: {s['fps']:.1f} "
              f"fps, render {s['render_ms']:.2f} ms; {time.perf_counter() - t0:.1f} s in all",
              flush=True)
        return s
    finally:
        server.shutdown()
        server.server_close()
        state.loop.stop()


def check_debug_views(P, D, PDM):
    """render_debug_view modes 1-10 after a 1080p caustics frame: each the
    frame's shape, its colour (post/debug_modes.py) finite. Returns the
    Engine."""
    eng = P.Engine(FULL_W, FULL_H)
    eng.update_scene(demo_scene(D, 0), **CAUSTICS)
    eng.render()
    dd, ds, dsh = eng._last_denoised
    for view in range(1, 11):
        t0 = time.perf_counter()
        img = eng.render_debug_view(view)
        ms = (time.perf_counter() - t0) * 1e3
        col = PDM.composite_debug(view, eng._last_gbuffer, denoised_diffuse=dd,
                                  denoised_specular=ds, denoised_shadow=dsh,
                                  photon_map_size=eng._cfg.num_photons)
        fin = bool(torch.isfinite(col).all())
        print(f"phase 9 render_debug_view {view}: {img.shape} {img.dtype}, colour finite {fin}, "
              f"{ms:.2f} ms", flush=True)
        if img.shape != (FULL_H, FULL_W, 4) or img.dtype != np.uint8 or not fin:
            raise AssertionError(f"debug view {view}")
    return eng


def check_surface(P, eng):
    """Phase 10: validate_frame on the card, copy_pixels_into's fills,
    render(fail_safe=True) (magenta only for a render made to raise)."""
    report = eng.validate_frame()
    print(f"phase 10 validate_frame, demo scene {FULL_W}x{FULL_H}: {report}", flush=True)
    if not report["ok"]:
        raise AssertionError(f"validate_frame: {report['violations']}")
    img = eng.render(fail_safe=True)
    fills = {}
    needed = FULL_W * FULL_H * 4
    buf = bytearray(needed)
    fills["clean"] = (eng.copy_pixels_into(buf), bytes(buf) == img.tobytes())
    small = bytearray(needed // 2)
    fills["too small"] = (eng.copy_pixels_into(small), bytes(small[:4]))
    last = eng._last_rgba
    eng._last_rgba = np.zeros_like(last)
    fills["all zero"] = (eng.copy_pixels_into(buf), bytes(buf[:4]))
    eng._last_rgba = np.ones((2, 2, 4), np.uint8)
    fills["exception"] = (eng.copy_pixels_into(buf), bytes(buf[:4]))
    eng._last_rgba = last
    fresh, empty = P.Engine(64, 32), P.Engine(0, 0)
    b8 = bytearray(64 * 32 * 4)
    fills["no frame"] = (fresh.copy_pixels_into(b8), bytes(b8[:4]))
    z = bytearray(16)
    fills["zero size"] = (empty.copy_pixels_into(z), bytes(z[:4]))
    want = {"clean": (True, True), "too small": (False, bytes([255, 255, 0, 255])),
            "all zero": (False, bytes([255, 165, 0, 255])),
            "exception": (False, bytes([255, 0, 255, 255])),
            "no frame": (False, bytes([0, 255, 0, 255])),
            "zero size": (False, bytes([255, 0, 0, 255]))}
    print(f"phase 10 copy_pixels_into: {fills}", flush=True)
    if fills != want:
        raise AssertionError("copy_pixels_into's fills")
    magenta = np.array([255, 0, 255, 255], np.uint8)
    raised = fresh.render(fail_safe=True)  # no scene: the render raises
    good = bool((raised.reshape(-1, 4) == magenta).all())
    clean = not bool((img.reshape(-1, 4) == magenta).all(axis=1).all()) and img[..., :3].any()
    print(f"phase 10 fail_safe: a render that raises gives magenta {good}; a frame that renders "
          f"is the frame {clean}", flush=True)
    if not (good and clean):
        raise AssertionError("render(fail_safe=True)")


def check_cli(P, path, out):
    """Phase 11: the port's CLI as a subprocess on the card: `path` to `out`
    at 1920x1080, 3 frames, --json; the PNG must equal the third frame of
    an Engine that loaded the file."""
    from raytracevs_tpu_torch.io.png import read_png

    cmd = [sys.executable, "-m", "raytracevs_tpu_torch.api.cli", path, "-o", out, "-W",
           str(FULL_W), "-H", str(FULL_H), "--frames", "3", "--json"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed ({proc.returncode}): {proc.stderr[-3000:]}")
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    eng = P.Engine(FULL_W, FULL_H)
    eng.load_rtvs(path)
    for _ in range(3):
        want = eng.render()
    got = read_png(out)
    same = got.shape == want.shape and bool(np.array_equal(got, want))
    print(f"phase 11 cli: {stats}; {wall:.1f} s with the process's start; the PNG equals the "
          f"Engine's frame {same}", flush=True)
    if not same:
        raise AssertionError("the CLI's PNG differs from the Engine's frame")


def check_golden(P, counters, smi):
    """Phase 14: the golden configs 1, 2, 3, 5 and 6 (tests/_torch_scenes.py::
    golden_scene, as tests/test_golden.py renders them: config 5 three
    frames) through Engine(res, res) on the card at 96x96 and 256x256,
    scored by the port's ssim against tests/golden/ (read by the port's
    read_png), beside the plain CPU Engine's score at the same size; every
    launch count set to 0 just before a config's frames and read just after.
    Then refcompare on the card's 256x256 config 1 frame with its golden as
    the reference: its ssim must be the direct score. Raises on a missing
    golden, an SSIM below 0.98, or a kernel of the frame not launched."""
    from raytracevs_tpu_torch.io.png import read_png
    from raytracevs_tpu_torch.scene import data as D
    from raytracevs_tpu_torch.utils.refcompare import compare_to_reference
    from raytracevs_tpu_torch.utils.ssim import ssim

    kept = None
    for res in (96, 256):
        for name in TS.GOLDEN_RENDERED:
            path = TS.golden_path(name, res)
            if not os.path.exists(path):
                raise AssertionError(f"golden missing: {path}")
            golden = read_png(path)
            for c in counters.values():
                c.launches = 0
            img, ms = TS.render_golden(P.Engine, D, name, res)
            launches = {k: c.launches for k, c in counters.items() if c.launches}
            score = ssim(img, golden)
            cpu_score = ssim(TS.render_golden(P.Engine, D, name, res, device="cpu")[0], golden)
            print(f"phase 14 golden {name} {res}x{res}: SSIM {score!r} on the card, {cpu_score!r} "
                  f"the plain CPU Engine's (|d| {abs(score - cpu_score):.3g}); frame ms "
                  f"{', '.join(f'{m:.3f}' for m in ms)}; launches {launches}; {smi}", flush=True)
            frames = len(ms)
            need = ["render_accum", "assemble", "reblur_prepass", "reproject_accumulate",
                    "atrous", "shadow_denoise"]
            if name == "config5_caustics_denoise":
                need += ["photon_trace", "photon_gather"]
            if any(launches.get(k, 0) < frames for k in need):
                raise AssertionError(f"{name} {res}: a kernel of the frame launched fewer than "
                                     f"{frames} times: {launches}")
            if img.shape != golden.shape:
                raise AssertionError(f"{name} {res}: frame {img.shape}, golden {golden.shape}")
            if score < TS.SSIM_THRESHOLD:
                raise AssertionError(f"{name} {res}: SSIM {score:.4f} < {TS.SSIM_THRESHOLD}")
            if name == "config1_hard_shadows" and res == 256:
                kept = (img, golden, score)
    img, golden, score = kept
    out = compare_to_reference(img, ref=golden)
    print(f"phase 14 refcompare config1_hard_shadows 256x256, the card's frame against its "
          f"golden: {out}; the direct score rounded as refcompare rounds it {round(score, 4)}",
          flush=True)
    if out["ssim"] != round(score, 4):
        raise AssertionError("refcompare's ssim differs from the direct score")


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
    from raytracevs_tpu_torch.ops.cuda import gbuffer_kernels as G
    from raytracevs_tpu_torch.ops.cuda import megakernel as MK
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
    occ = (ctypes.c_int * 15)()
    _build.check(_build.load_library().rtvs_denoise_occupancy(occ), "rtvs_denoise_occupancy")
    print(f"  K3 atrous_kernel: {occ[0]} bytes of dynamic shared memory a block, {occ[1]} blocks "
          f"an SM; K4 shadow_kernel: {occ[2]} blocks an SM; K3-pass (strides 1, 2, 4, without "
          f"and with the clamp) bytes and blocks an SM {list(occ)[3:]}", flush=True)
    ptxas_mode0(_build.build_log_path())
    t0 = time.perf_counter()
    native.load_library()
    print(f"phase 3 host BVH builder: {time.perf_counter() - t0:.1f} s -> "
          f"{native.library_path()}", flush=True)

    # phase 4: every kernel against its plain version on the card, at the
    # main paths' sizes
    from raytracevs_tpu_torch.ops import photon as PP
    from raytracevs_tpu_torch.ops.cuda import photon_kernels as PK

    results = {}
    dev = torch.device("cuda")
    scene = demo_scene(D, 0)
    flat = P.flatten_scene(P.sanitize_scene(scene), aspect=FULL_W / FULL_H)
    sc = P.to_device(flat, dev)
    cfg = P.make_config(scene, FULL_W, FULL_H, **OVERRIDES)
    k1_err, k1_counts = None, {}
    for spp in (2, 1):  # the main path's, then the two-phase renderer's
        c = cfg._replace(samples_per_pixel=spp)
        plain = torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64, device=dev)
        err = check_k1(f"phase 4 K1 spp {spp}", MK, R, sc, c, plain)[0]
        k1_err = err if k1_err is None else max(k1_err, err)
        k1_counts[spp] = counted(MK, R, f"K1, demo scene {FULL_W}x{FULL_H} spp {spp}",
                                 lambda k, c=c: MK.render_accum(sc, c, counts=k), plain)
    # the launch alone, the tables packed beforehand, and the packing apart
    tables = MK.pack_tables(sc)
    k1_ms = gpu_ms(lambda: MK.render_accum(sc, cfg, tables=tables), 10)
    pack_ms = gpu_ms(lambda: MK.pack_tables(sc), 10)
    k1_dev = device_ms(lambda: MK.render_accum(sc, cfg, tables=tables), 10)
    k1_plain_ms = gpu_ms(lambda: R.render_accum(sc, cfg), 1)
    print(f"  render_accum: kernel {k1_ms:.4f} ms (the launch alone), pack_tables {pack_ms:.4f} "
          f"ms, plain {k1_plain_ms:.3f} ms", flush=True)
    out_bytes = R.NUM_CH * FULL_H * FULL_W * 4
    results["render_accum"] = dict(
        kernel_row(k1_err, k1_ms, k1_plain_ms, out_bytes, render_ops(R, sc, k1_counts[2]),
                   k1_dev),
        pack_tables_ms=pack_ms)

    # K2-K4 on the G-buffers of two orbiting 1080p frames
    k2_args, new_state, k3_args, k4_args = denoise_inputs(P, D, PD, K, dev)
    k2_err = float((new_state - PD.temporal_accumulate(*k2_args)).abs().max())
    frames_kept = float((new_state[14] > 0).float().mean())
    print(f"phase 4 K2 {FULL_W}x{FULL_H}: max |d| {k2_err:.3g}; history kept on "
          f"{frames_kept:.3f} of pixels", flush=True)
    if k2_err > 1e-5:
        raise AssertionError("K2 disagrees with its plain version beyond atol 1e-5")
    # K3 and K4 bit for bit, at 1080p and on the same planes cut to an odd
    # size (ragged against both kernels' tiles)
    k3_err = k4_err = 0.0
    for cut in (None, (FULL_H - 1, FULL_W - 3)):
        a3, a4 = k3_args, k4_args
        if cut:
            a3, a4 = ([a[..., :cut[0], :cut[1]].contiguous() for a in args]
                      for args in (k3_args, k4_args))
        k3_err = max(k3_err, check_denoise_bits("K3 atrous", K.atrous, PD.atrous, a3))
        k4_err = max(k4_err, check_denoise_bits("K4 shadow_denoise", K.shadow_denoise,
                                                PD.shadow_denoise, a4))
    px = FULL_W * FULL_H
    for name, err, kern, plain, args, out_planes, ops in (
            ("reproject_accumulate", k2_err, K.reproject_accumulate, PD.temporal_accumulate,
             k2_args, 16, REPROJECT_OPS),
            ("atrous", k3_err, K.atrous, PD.atrous, k3_args, 6, ATROUS_OPS),
            ("shadow_denoise", k4_err, K.shadow_denoise, PD.shadow_denoise, k4_args, 2,
             SHADOW_OPS)):
        ms = gpu_ms(lambda: kern(*args), 20)
        dev_t = device_ms(lambda: kern(*args), 20)
        plain_ms = gpu_ms(lambda: plain(*args), 5)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        nbytes = sum(a.nbytes for a in args) + out_planes * px * 4
        results[name] = kernel_row(err, ms, plain_ms, nbytes, px * ops, dev_t)
    # phase 4a: the sharded denoise's kernel forms, K2's slab form and the
    # per-pass a-trous kernel
    results.update(check_slab_kernels(K, PD, k2_args, k3_args))
    del k2_args, new_state, k3_args, k4_args
    # K9 on K1's 1080p planes of an orbiting frame, and K10 on its G-buffer
    results.update(check_gbuffer_kernels(P, D, MK, K, PD, R, dev))

    # K5 on the demo scene's tables at its budget and at the reference's
    # safe cap, and on an offset slice; K6 at 1080p on the primary planes
    # of a caustics demo frame, both maps
    ccfg = P.make_config(scene, FULL_W, FULL_H, **CAUSTICS)
    rows = [check_k5("demo scene", PP, PK, sc, tables, n) for n in (ccfg.num_photons, 131072)]
    rows.append(check_k5("demo scene, a slice", PP, PK, sc, tables, ccfg.num_photons, 5000, 3000))
    check_k5_slice(PK, sc, tables, ccfg.num_photons, 5000, 3000)
    acc = MK.render_accum(sc, ccfg)
    gathers = [check_k6(f"demo scene, {n}-photon map", PP, PK, R,
                        PP.emit_and_trace(sc, n, tables), acc, ccfg.samples_per_pixel)
               for n in (ccfg.num_photons, 131072)]
    results["photon_gather"] = dict(gathers[0], max_abs_err=max(r["max_abs_err"] for r in gathers))
    del acc

    # K1-mesh on the mesh demo scene at 1080p, and on nine instances
    from raytracevs_tpu_torch.ops import twophase as TP

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
          f"nodes ({mflat.mesh.wide_topology.child.shape[0]} wide, a walk stack of "
          f"{mflat.mesh.wide_stack} at most), {mflat.mesh.num_inst} instances; flatten with the "
          f"SAH builds and collapses {(t1 - t0) * 1e3:.1f} ms, flatten with cached BLASes "
          f"and instances (the camera moved only) {(t2 - t1) * 1e3:.1f} ms, to_device with "
          f"the plane table and the wide nodes {(time.perf_counter() - t2) * 1e3:.1f} ms", flush=True)
    mcfg = P.make_config(mscene, FULL_W, FULL_H, **OVERRIDES)
    mk_plain_counts = new_counts(R)[0]
    mk_err, _, mk_plain_ms, _ = check_k1("phase 4 K1-mesh", MK, R, msc, mcfg, mk_plain_counts)
    mtables = MK.pack_tables(msc)
    mk_ms = gpu_ms(lambda: MK.render_accum(msc, mcfg, tables=mtables), 5)
    mk_dev = device_ms(lambda: MK.render_accum(msc, mcfg, tables=mtables), 5)
    mpack_ms = gpu_ms(lambda: MK.pack_tables(msc), 10)
    print(f"  render_accum_mesh: kernel {mk_ms:.4f} ms (the launch alone, mean of 5), "
          f"pack_tables {mpack_ms:.4f} ms, plain {mk_plain_ms:.3f} ms (one run)", flush=True)
    nscene = nine_ball_scene(D)
    nsc = P.to_device(P.flatten_scene(P.sanitize_scene(nscene), aspect=480 / 270,
                                      mesh_service=mesh_service({"Ball": (24, 32, 0.3)})), dev)
    ncfg = P.make_config(nscene, 480, 270)
    n_err, _, _, _ = check_k1("phase 4 K1-mesh, nine instances,", MK, R, nsc, ncfg)

    # frames past the kernels' 32-bit plane index render in row bands; at
    # 1080p, forced bands are bit-equal to one launch
    check_bands(P, D, MK, R, TP, sc, cfg, msc, mcfg, float(mflat.aperture_size))

    # the mesh walks alone against the plain walks, bit for bit: the mesh
    # demo scene's rays at 1080p and the nine instances' at 480x270
    from raytracevs_tpu_torch import constants as C
    from raytracevs_tpu_torch.ops import bvh as B
    from raytracevs_tpu_torch.ops import intersect as I
    from raytracevs_tpu_torch.ops.cuda import mesh_walks as MW

    n_closest, n_shadow = check_walks("mesh demo scene 1920x1080", MW, B, C, msc.mesh,
                                      walk_rays(R, I, C, msc, mcfg, 1))
    n9 = check_walks("nine instances 480x270", MW, B, C, nsc.mesh,
                     walk_rays(R, I, C, nsc, ncfg, 2))
    print(f"phase 4 walks: {n_closest + n9[0]} closest and {n_shadow + n9[1]} shadow rays "
          f"bit-equal in all", flush=True)
    if n_closest < 1_000_000 or n_shadow < 1_000_000:
        raise AssertionError("fewer than a million rays of each walk on the mesh demo scene")
    cam = walk_rays(R, I, C, msc, mcfg, 3)[0]
    npx = FULL_W * FULL_H
    cam = [x[:npx] for x in cam]
    w_ms = gpu_ms(lambda: MW.closest(msc.mesh, *cam[:2], C.RAY_TMIN, C.RAY_TMAX, *cam[2:]), 5)
    print(f"  closest walk alone over {npx} camera rays: kernel {w_ms:.4f} ms", flush=True)
    del cam

    # a table deeper than the kernels' walk stack (ROADMAP C9), through the
    # threaded walks
    deep_err = check_deep_forest(P, D, MK, MW, R, TP, B, C, I, 480, 270)

    # the render kernels' work: the counting build at 1080p (the main
    # paths' frames) and at 480x270, the plain versions at 480x270 (and at
    # 1080p those that were run above); walks by ray class, then the DFS's
    mcfg1 = P.make_config(mscene, FULL_W, FULL_H, **SPP1)
    qcfg, qcfg1 = (P.make_config(mscene, 480, 270, **o) for o in (OVERRIDES, SPP1))
    names = ("K1-mesh spp 2", "K7 spp 1", "K8 spp 1")
    counts = {}
    for res, (c, c1) in (("1920x1080", (mcfg, mcfg1)), ("480x270", (qcfg, qcfg1))):
        for name, k in zip(names, walk_counts(MK, R, TP, msc, c, c1)):
            counts[(name, res)] = k
            print_counts(B, f"wide walks, {name}, {res}", k)
    for name, k in zip(names, plain_walk_counts(R, TP, msc, qcfg, qcfg1)):
        print_counts(B, f"threaded walks (plain), {name}, 480x270", k)
        check_counts(R, f"{name} mesh demo scene 480x270", counts[(name, "480x270")], k)
    check_counts(R, "K1-mesh spp 2, mesh demo scene 1920x1080",
                 counts[("K1-mesh spp 2", "1920x1080")], mk_plain_counts)
    k8c = counts[("K8 spp 1", "1920x1080")]
    prim = B.WALK_CLASSES.index("primary")
    print(f"phase 4 walk counts: K8 walks {int(k8c[prim, 0])} primary rays (K7 hands it "
          f"their hits)", flush=True)
    if int(k8c[prim, 0]):
        raise AssertionError("K8 walked primary rays again")
    results["render_accum_mesh"] = dict(kernel_row(
        max(mk_err, n_err, deep_err), mk_ms, mk_plain_ms, out_bytes,
        render_ops(R, msc, counts[("K1-mesh spp 2", "1920x1080")]), mk_dev),
        pack_tables_ms=mpack_ms)
    # K5 on the mesh demo scene's tables: the instance material rows stay,
    # and the light table follows them
    rows.append(check_k5("mesh demo scene", PP, PK, msc, mtables, ccfg.num_photons))
    results["photon_trace"] = dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))

    # K7 and K8 against their plain versions at 1080p, spp 1: on the mesh
    # demo scene (the two-phase main path) and on the demo scene; the two
    # phases against K1-mesh and K1; their times. The kernels' rows are the
    # mesh demo scene's; the demo scene's bounds are printed only.
    mpa, mpb = new_counts(R, 2)
    ma_err, mb_err, pa_ms, pb_ms = check_phases("mesh demo scene", MK, R, TP, msc, mcfg1,
                                                (mpa, mpb))
    check_counts(R, "K7 spp 1, mesh demo scene 1920x1080", counts[("K7 spp 1", "1920x1080")],
                 mpa)
    check_counts(R, "K8 spp 1, mesh demo scene 1920x1080", k8c, mpb)
    cfg1 = P.make_config(scene, FULL_W, FULL_H, **SPP1)
    pa, pb = new_counts(R, 2)
    a_err, b_err, _, _ = check_phases("demo scene", MK, R, TP, sc, cfg1, (pa, pb))
    k7d = counted(MK, R, "K7, demo scene 1920x1080",
                  lambda k: MK.render_phase_a(sc, cfg1, counts=k), pa)
    a = MK.render_phase_a(sc, cfg1)
    order, count = TP.coherence_order(a)
    k8d = counted(MK, R, "K8, demo scene 1920x1080", lambda k: MK.render_phase_b(
        sc, cfg1, order, count, a[:R.NUM_CH].clone(), a[R.CH_HIT:], counts=k), pb)
    del a, order, count
    mtwo, mrays_a, mresumed = check_two_phase_vs_k1("mesh demo scene", MK, R, TP, msc, mcfg1,
                                                    float(mflat.aperture_size))
    two, rays_a, resumed = check_two_phase_vs_k1("demo scene", MK, R, TP, sc, cfg1,
                                                 float(flat.aperture_size))
    t = time_two_phase("mesh demo scene", MK, R, TP, msc, mcfg1, float(mflat.aperture_size))
    time_two_phase("demo scene", MK, R, TP, sc, cfg1, float(flat.aperture_size))
    # bounds: K7 writes 46 planes; K8 reads its pixel id and 7 hit floats
    # and read-modify-writes 5 floats a resumed pixel; both do the work of
    # the counting build's counts
    results["render_phase_a"] = kernel_row(
        max(a_err, ma_err), t["k7"], pa_ms, R.NUM_CH_A * px * 4,
        render_ops(R, msc, counts[("K7 spp 1", "1920x1080")]), t["k7_dev"])
    results["render_phase_b"] = kernel_row(
        max(b_err, mb_err), t["k8"], pb_ms, 4 + 72 * mresumed, render_ops(R, msc, k8c),
        t["k8_dev"])
    # the coherence sort between them (a library call, no kernel of the
    # port): its 2,073,600 int32 keys and indices, each read and written
    sort_ms, sort_by = bound(4 * 4 * px, 0)
    print(f"  coherence key + torch.sort: {t['sort']:.4f} ms, device {t['sort_dev'][0]:.4f} ms "
          f"({t['sort_dev'][1]}), bound {sort_ms:.4f} ms by {sort_by} ({4 * 4 * px / 1e6:.1f} MB)",
          flush=True)
    for name, nbytes, ops in (("K7", R.NUM_CH_A * px * 4, render_ops(R, sc, k7d)),
                              ("K8", 4 + 72 * resumed, render_ops(R, sc, k8d))):
        b_ms, b_by = bound(nbytes, ops)
        print(f"  {name} bound on the demo scene at 1080p: {b_ms:.4f} ms by {b_by} "
              f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G operations)", flush=True)
    del msc, nsc, two, mtwo

    # phase 5: the main paths, through the Engine
    counters = {"render_accum": MK.render_accum, "reproject_accumulate": K.reproject_accumulate,
                "atrous": K.atrous, "shadow_denoise": K.shadow_denoise,
                "photon_trace": PK.emit_and_trace, "photon_gather": PK.add_caustics,
                "render_phase_a": MK.render_phase_a, "render_phase_b": MK.render_phase_b,
                "atrous_pass": K.atrous_pass, "assemble": G.assemble,
                "reblur_prepass": K.reblur_prepass}
    launches, aeng = run_engine(P, D, "analytic", demo_scene, counters)
    if launches["render_accum"] < FRAMES:
        raise AssertionError(f"render_accum launched {launches['render_accum']} times in "
                             f"{FRAMES} frames")
    mesh_launches, _ = run_engine(P, D, "mesh", mesh_demo_scene, counters, MESH_DEMO)
    if mesh_launches["render_accum"] < FRAMES:
        raise AssertionError(f"render_accum launched {mesh_launches['render_accum']} times in "
                             f"{FRAMES} mesh frames")
    launches["render_accum_mesh"] = mesh_launches["render_accum"]  # K1-mesh's row
    PP._emit_photons.launches = 0
    caustics_launches, ceng = run_engine(P, D, "caustics", demo_scene, counters,
                                         overrides=CAUSTICS)
    print(f"phase 5 caustics: plain emission calls {PP._emit_photons.launches}", flush=True)
    if PP._emit_photons.launches:
        raise AssertionError("the card's caustics path ran the plain emission")
    for name in ("render_accum", "photon_trace", "photon_gather"):
        if caustics_launches[name] < FRAMES:
            raise AssertionError(f"{name} launched {caustics_launches[name]} times in {FRAMES} "
                                 "caustics frames")
    for name in ("photon_trace", "photon_gather"):
        launches[name] = caustics_launches[name]
    # the caustic in the Engine's own last frame: its HDR against the analytic
    # run's last frame (the same camera and frame index, so the same K1
    # planes), and against that frame rebuilt from the planes and a photon
    # pass, after the counts were read
    hdr, ahdr = ceng._last_hdr_t, aeng._last_hdr_t
    lit = caustic_share(hdr, ahdr)
    ccfg = ceng._cfg
    csc = ceng._scene_t._replace(frame_index=torch.tensor(FRAMES - 1, dtype=torch.int64,
                                                          device=dev))
    acc = MK.render_accum(csc, ccfg)
    pmap = PP.emit_and_trace(csc, ccfg.num_photons)
    color = acc[R.CH_COLOR:R.CH_COLOR + 3]
    inv = 1.0 / ccfg.samples_per_pixel
    plain = color * inv
    lit_acc = PK.add_caustics(pmap, acc.clone(), ccfg.samples_per_pixel)
    want = lit_acc[R.CH_COLOR:R.CH_COLOR + 3] * inv
    errs = [float((a - b).abs().max()) for a, b in ((hdr, want), (ahdr, plain))]
    print(f"phase 5 caustics: {ccfg.num_photons} photons, {int(pmap.count)} stored; the last "
          f"frame's caustic lights {lit:.5f} of its pixels, adds up to "
          f"{float((hdr - ahdr).max()):.4g} HDR; max |d| against the rebuilt frame {errs[0]:.3g}, "
          f"the analytic frame against its planes {errs[1]:.3g}", flush=True)
    if lit == 0.0 or not bool(torch.isfinite(hdr).all()):
        raise AssertionError("the Engine's caustics frames carry no caustic")
    if not all(bool(((a - b).abs() <= 1e-6 * b.abs().clamp(min=1.0)).all())
               for a, b in ((hdr, want), (ahdr, plain))):
        raise AssertionError("the Engine's last frames differ from their planes and photon pass")
    del csc, ceng, aeng, pmap, acc, hdr, ahdr, want, plain
    tp_launches, _ = run_engine(P, D, "two-phase mesh", mesh_demo_scene, counters, MESH_DEMO,
                                overrides=SPP1, two_phase=True)
    for name in ("render_phase_a", "render_phase_b"):
        if tp_launches[name] < FRAMES:
            raise AssertionError(f"{name} launched {tp_launches[name]} times in {FRAMES} "
                                 "two-phase frames")
    if tp_launches["render_accum"]:
        raise AssertionError("the two-phase frames launched K1")
    for name in ("render_phase_a", "render_phase_b"):
        launches[name] = tp_launches[name]

    # phase 6: frames against the plain pipeline on a small input
    analytic = compare_small(P, D, "analytic", demo_scene, 2)
    compare_small(P, D, "mesh", mesh_demo_scene, 1, MESH_DEMO)
    caustics = compare_small(P, D, "caustics", demo_scene, 1, overrides=CAUSTICS)
    compare_small(P, D, "two-phase analytic", demo_scene, 1, overrides=SPP1, two_phase=True)
    compare_small(P, D, "two-phase mesh", mesh_demo_scene, 1, MESH_DEMO, overrides=SPP1,
                  two_phase=True)
    for name, hdr, plain in zip(("cuda", "cpu"), caustics[0], analytic[0]):
        lit = caustic_share(hdr, plain)
        print(f"phase 6 caustics 96x54 frame 0, {name}: the caustic lights {lit:.5f} of the "
              "pixels", flush=True)
        if lit == 0.0:
            raise AssertionError(f"the 96x54 caustics frame ({name}) carries no caustic")

    # phase 7: where the time of a 1080p frame goes
    print_stages("analytic", stage_times(P, D, MK, K, PD, 5, demo_scene))
    print_stages("mesh", stage_times(P, D, MK, K, PD, 5, mesh_demo_scene, MESH_DEMO,
                                     label="mesh"))
    print_stages("caustics", stage_times(P, D, MK, K, PD, 5, demo_scene, overrides=CAUSTICS))
    print_stages("mesh spp 1", stage_times(P, D, MK, K, PD, 5, mesh_demo_scene, MESH_DEMO, SPP1,
                                           label="mesh spp 1"))
    print_stages("two-phase mesh spp 1", stage_times(P, D, MK, K, PD, 5, mesh_demo_scene,
                                                     MESH_DEMO, SPP1, two_phase=True,
                                                     label="two-phase mesh spp 1"))

    # phase 12: the four paths row-sharded over four slabs on the card,
    # against the single-device Engine
    t_new = time.perf_counter()
    sharded = run_sharded(P, D, "analytic", demo_scene, counters, timing=True)
    launches["K2-slab"], launches["K3-pass"] = sharded["K2-slab"], sharded["atrous_pass"]
    run_sharded(P, D, "mesh", mesh_demo_scene, counters, MESH_DEMO)
    run_sharded(P, D, "caustics", demo_scene, counters, overrides=CAUSTICS)
    run_sharded(P, D, "two-phase mesh", mesh_demo_scene, counters, MESH_DEMO, SPP1,
                two_phase=True)
    print(f"phase 12: {time.perf_counter() - t_new:.1f} s", flush=True)

    # phase 8: the demo and mesh demo scenes as .rtvs files through
    # Engine(1920, 1080).load_rtvs, the counts set to 0 just before each
    import tempfile

    from raytracevs_tpu_torch.post import debug_modes as PDM

    t_new = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        demo_path = os.path.join(tmp, "demo.rtvs")
        _, ref = check_scene_file(P, D, "demo scene", demo_scene, counters, demo_path)
        check_scene_file(P, D, "mesh demo scene", mesh_demo_scene, counters,
                         os.path.join(tmp, "mesh_demo.rtvs"), MESH_DEMO)

        # phase 9: the photon debug modes in K1, K1-mesh, K7 and K6 against
        # their plain versions at 480x270; the two phases against K1 in mode
        # 3; the debug views after a 1080p caustics frame
        qw, qh = 480, 270
        qscene = demo_scene(D, 0)
        qflat = P.flatten_scene(P.sanitize_scene(qscene), aspect=qw / qh)
        qsc = P.to_device(qflat, dev)
        mqscene = mesh_demo_scene(D, 0)
        mqsc = P.to_device(P.flatten_scene(P.sanitize_scene(mqscene), aspect=qw / qh,
                                           mesh_service=mesh_service(MESH_DEMO)), dev)
        k1_err, k7_err = check_debug_k1(P, MK, R, qsc, qscene, qw, qh, "K1 demo scene")
        # the mesh demo scene at full size and spp 1 in mode 3 alone (its
        # glass ball; mode 4's grey is the same code with metallic, which
        # the demo scene checks)
        km_err, k7m_err = check_debug_k1(P, MK, R, mqsc, mqscene, qw, qh,
                                         "K1-mesh mesh demo scene", SPP1, modes=(3,))
        results["render_accum"]["debug_modes_max_abs_err"] = k1_err
        results["render_accum_mesh"]["debug_modes_max_abs_err"] = km_err
        results["render_phase_a"]["debug_modes_max_abs_err"] = max(k7_err, k7m_err)
        results["photon_gather"]["debug_modes_max_abs_err"] = check_k6_replace(
            P, PP, PK, R, MK, qsc, qscene, qw, qh)
        check_two_phase_vs_k1("demo scene, photon debug mode 3", MK, R, TP, qsc,
                              P.make_config(qscene, qw, qh, **dict(SPP1, photon_debug_mode=3)),
                              float(qflat.aperture_size))
        del qsc, mqsc
        check_debug_views(P, D, PDM)

        # phase 10: validate_frame, copy_pixels_into and fail_safe on the card
        check_surface(P, ref)
        del ref

        # phase 11: the CLI from the demo scene's file, in a process of its own
        check_cli(P, demo_path, os.path.join(tmp, "out.png"))
        print(f"phases 8-11: {time.perf_counter() - t_new:.1f} s", flush=True)

        # phase 13: the viewer on the card, serving the demo scene's file
        t_new = time.perf_counter()
        check_viewer(demo_path, counters)
        print(f"phase 13: {time.perf_counter() - t_new:.1f} s", flush=True)

    # phase 14: the golden configs on the card against tests/golden/
    t_new = time.perf_counter()
    check_golden(P, counters, smi)
    print(f"phase 14: {time.perf_counter() - t_new:.1f} s", flush=True)

    line = {"kernels": [
        dict({"name": name, "route": "cuda", "source": src, "replaces": rep,
              "launches": launches[name]}, **results[name])
        for name, src, rep in KERNELS]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
