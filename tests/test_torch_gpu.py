"""The port's CUDA kernels K1 (analytic and mesh), K2-K4, the photon
kernels K5-K6, the two-phase kernels K7-K8, the G-buffer assembly K9, the
REBLUR prepass K10 and the mesh walks alone vs
their plain PyTorch versions, on the card. Every test needs a CUDA device and skips without one. This file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Bands: K1 ray count and object ids exact, HDR colour atol 2e-4 on >= 99%
of pixels; K2 atol 1e-5, K3 and K4 bit for bit from one pixel to 270x480
(the kernels round like the plain ops; they are built with --fmad=false);
K5 (emission and bounce loop in one launch) store masks equal, store
fields within tests/test_megakernel.py:190-197's bands; K6 (the caustic
added into the colour and diffuse planes in place) |d| <= 1e-5 * max(1,
|plain|), every other plane's bits kept;
K7 and K8 as K1, and K7+K8 against K1 at spp 1: rays, bounce and record
planes bit-equal, colour within 2e-5 * max(1, |K1|); the mesh walks alone
and the counting build's triangle tests and walks bit-equal to the plain
walks'. The per-pass a-trous kernel bit for bit, whole frames and
row slabs whose neighbours' rows are views or copies (and its chain of
three launches against K3); K2's slab form within 1e-5; the
sharded Engine over [cuda:0] * 4 bit-equal to the single-device one.
K1 and K7 also bit for bit, with K7's continuation and hit planes,
at odd sizes and sample counts; the counting build's counts equal the plain
version's; a mesh deeper than the kernels' walk stack renders through the
threaded instantiations as its plain version does; a frame rendered in
row bands (K1, K1-mesh, the two-phase path) is bit-equal to one launch. In
the photon debug modes: K1 and K1-mesh in modes 3 and 4, and K7 in mode 3,
bit for bit at 64x32, and K7+K8 against K1 in mode 3; K6's replacement
fold-in within 1e-5 * max(1, |plain|) on the planes it writes, every other
plane's bits kept. K9 bit for bit in photon debug modes 0, 1 and 2 on K1's,
a row slab's and the two-phase renderer's planes and at 53x37; K10 bit for
bit from one pixel to 1080p and on PREPASS_HALO-extended slabs; neither
wrapper waits on the device (torch.cuda.set_sync_debug_mode("error")). The
mesh demo scene orbiting at 1080p keeps its device mesh tables, bit-equal
to an Engine that rebuilds them every update (main, two-phase, sharded).
The frame's readback through pinned host blocks (runtime/readback.py) on a
1080p demo orbit: bit-equal to the pageable readback, every array the
caller's own, the blocks reused once the pool holds the frames still held,
and render() under set_sync_debug_mode("error") waiting on nothing but the
readback's event."""
import os
import sys

import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch import constants as C
from raytracevs_tpu_torch.ops import bvh as B
from raytracevs_tpu_torch.ops import intersect as I
from raytracevs_tpu_torch.ops import photon as PP
from raytracevs_tpu_torch.ops import render as R
from raytracevs_tpu_torch.ops import twophase as TP
from raytracevs_tpu_torch.ops.cuda import denoise_kernels as K
from raytracevs_tpu_torch.ops.cuda import gbuffer_kernels as G
from raytracevs_tpu_torch.ops.cuda import megakernel as MK
from raytracevs_tpu_torch.ops.cuda import mesh_walks as MW
from raytracevs_tpu_torch.ops.cuda import photon_kernels as PK
from raytracevs_tpu_torch.ops.render_cf import accum_dict, assemble_frame_cf
from raytracevs_tpu_torch.post import denoise as PD_
from raytracevs_tpu_torch.scene import data as D
from raytracevs_tpu_torch.scene.flatten import flatten_scene, make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

pytestmark = pytest.mark.gpu


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _render_modes(fn):
    """(fn(), the MODE template argument of each render_accum_kernel it
    launched), the modes read from the kernels' names in a torch.profiler
    trace: the instantiation the C entry chose (MODE_MESH 1, MODE_THREADED
    2, MODE_COUNT 4; csrc/closest.cuh)."""
    import re

    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [int(m.group(1)) for e in prof.events() if e.device_type == DeviceType.CUDA
                 for m in [re.search(r"render_accum_kernel<(\d+),", e.name)] if m]


def test_library_exports_one_entry_a_render_kernel():
    """K1, K7 and K8 have one C entry each, which chooses the mesh,
    threaded and counting instantiation itself: none of the old _mesh,
    _count and _mesh_count forms is exported."""
    _need_cuda()
    from raytracevs_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    entries = ("rtvs_render_accum", "rtvs_render_phase_a", "rtvs_render_phase_b")
    assert all(hasattr(lib, e) for e in entries)
    assert sorted(k for k in _build.SIGNATURES if k.startswith("rtvs_render_")) == sorted(entries)
    for e in entries:
        for suffix in ("_mesh", "_count", "_mesh_count"):
            assert not hasattr(lib, e + suffix), e + suffix


@pytest.mark.parametrize("name", ["demo"] + list(S.GOLDEN))
def test_k1_cuda_matches_plain(name):
    _need_cuda()
    scene, over = S.scene_and_overrides(D, name)
    w, h = 72, 40  # ragged against the 16x16 blocks
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3), "cuda")
    cfg = make_config(scene, w, h, **over)
    before = MK.render_accum.launches
    got, modes = _render_modes(lambda: MK.render_accum(sc, cfg))
    assert modes == [0] and MK.render_accum.launches == before + 1
    want = R.render_accum(sc, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got[R.CH_RAYS], want[R.CH_RAYS])
    assert torch.equal(got[R.CH_OBJ_ID], want[R.CH_OBJ_ID])
    d = (got[0:3] - want[0:3]).abs().amax(0)
    assert float((d <= 2e-4).float().mean()) >= 0.99, float(d.max())
    assert torch.isfinite(got).all()


MESH_SCENES = {
    "glass_ball": (lambda: S.glass_ball_scene(D), {"max_soft_samples": 2},
                   {"GlassBall": (9, 9, 0.7)}),
    "opaque_ball": (lambda: S.glass_ball_scene(D, opaque=True), {"max_soft_samples": 2},
                    {"GlassBall": (9, 9, 0.7)}),
    "nine_balls": (lambda: S.nine_ball_scene(D), {}, {"Ball": (6, 8, 0.3)}),
    "mesh_demo": (lambda: S.mesh_demo_scene(D), S.DEMO_OVERRIDES, S.MESH_DEMO_SMALL),
}


@pytest.mark.parametrize("name", list(MESH_SCENES))
def test_k1_mesh_cuda_matches_plain(name):
    """K1-mesh launches for a scene with meshes: render_accum's one launch
    runs the MODE_MESH instantiation (the kernel's name in a trace), and
    matches the plain walks."""
    _need_cuda()
    build, over, meshes = MESH_SCENES[name]
    scene = build()
    w, h = 72, 40
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3,
                                 mesh_service=S.mesh_service(PMC, meshes)), "cuda")
    cfg = make_config(scene, w, h, **over)
    before = MK.render_accum.launches
    got, modes = _render_modes(lambda: MK.render_accum(sc, cfg))
    assert modes == [1] and MK.render_accum.launches == before + 1  # MODE_MESH
    want = R.render_accum(sc, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got[R.CH_RAYS], want[R.CH_RAYS])
    assert torch.equal(got[R.CH_OBJ_ID], want[R.CH_OBJ_ID])
    assert bool((got[R.CH_OBJ_ID] >= 3 * 65536).any())  # a mesh is in the frame
    d = (got[0:3] - want[0:3]).abs().amax(0)
    assert float((d <= 2e-4).float().mean()) >= 0.99, float(d.max())
    assert torch.isfinite(got).all()


def test_mesh_walks_cuda_match_plain():
    """The walk-only kernels (rtvs_mesh_closest, rtvs_mesh_shadow) return
    the plain walks' outputs bit for bit on over a million rays of each
    walk of the full-size mesh demo scene at 1920x1080 (camera rays,
    secondary rays from mesh hits with skip-self and thickness queries,
    shadow rays to both lights; chip_smoke.py::walk_rays) and on the nine
    instances at 480x270; each wrapper counts its launches."""
    _need_cuda()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as CS

    rays = 0
    for build, meshes, (w, h) in ((S.mesh_demo_scene, CS.MESH_DEMO, (1920, 1080)),
                                  (S.nine_ball_scene, {"Ball": (24, 32, 0.3)}, (480, 270))):
        scene = build(D)
        sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h,
                                     mesh_service=S.mesh_service(PMC, meshes)), "cuda")
        before = (MW.closest.launches, MW.shadow.launches)
        n = CS.check_walks(f"{w}x{h}", MW, B, C, sc.mesh,
                           CS.walk_rays(R, I, C, sc, make_config(scene, w, h), 5))
        assert (MW.closest.launches, MW.shadow.launches) == (before[0] + 1, before[1] + 1)
        rays = rays or min(n)
    assert rays >= 1_000_000


def test_counting_build_counts_the_walks():
    """The counting build (rtvs_render_accum given counts, on a mesh scene)
    renders K1-mesh's planes. Per ray class it runs the plain render's walks and tests the
    same triangles as the threaded walks (the same leaves in the same
    order), in fewer node fetches; its DFS counts are the plain render's."""
    _need_cuda()
    build, over, meshes = MESH_SCENES["mesh_demo"]
    scene = build()
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=72 / 40, frame_index=3,
                                 mesh_service=S.mesh_service(PMC, meshes)), "cuda")
    cfg = make_config(scene, 72, 40, **over)
    counts = torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64, device="cuda")
    got, modes = _render_modes(lambda: MK.render_accum(sc, cfg, counts=counts))
    assert modes == [5]  # MODE_MESH | MODE_COUNT
    assert torch.equal(got, MK.render_accum(sc, cfg))
    plain = torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64, device="cuda")
    R.render_accum(sc, cfg, counts=plain)
    counts, plain = counts[:4].cpu(), plain[:4].cpu()
    assert torch.equal(counts[:, 0], plain[:, 0]) and torch.equal(counts[:, 3], plain[:, 3])
    assert int(counts[:, 1].sum()) < int(plain[:, 1].sum())
    assert (counts[[0, 3], 0] > 0).all()


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("spp", [1, 2, 4])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (97, 61)])
def test_k1_bit_equal_to_plain(size, spp):
    """K1 on the demo scene, every plane bit for bit, at sizes the 16x16
    blocks do not divide and at several sample counts."""
    _need_cuda()
    w, h = size
    scene, over = S.scene_and_overrides(D, "demo")
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3), "cuda")
    cfg = make_config(scene, w, h, **dict(over, samples_per_pixel=spp))
    got = MK.render_accum(sc, cfg)
    want = R.render_accum(sc, cfg)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


@pytest.mark.parametrize("size", [(1, 1), (17, 9), (97, 61)])
def test_k7_bit_equal_to_plain(size):
    """K7 on the demo scene (spp 1), its continuation and hit planes
    included, bit for bit."""
    _need_cuda()
    w, h = size
    scene, over = S.scene_and_overrides(D, "demo")
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3), "cuda")
    cfg = make_config(scene, w, h, **dict(over, samples_per_pixel=1))
    got = MK.render_phase_a(sc, cfg)
    want = R.render_accum_phase_a(sc, cfg)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


@pytest.mark.parametrize("name", ["demo", "glass_ball"])
def test_k1_bit_equal_to_plain_without_dfs_iterations(name):
    """max_queue_iters 0: K1 (K1-mesh for the glass ball) traces no sample
    and writes the planes of no sample, bit for bit as the plain version."""
    _need_cuda()
    if name == "glass_ball":
        scene, over = S.glass_ball_scene(D), {"max_soft_samples": 2}
        ms = S.mesh_service(PMC, {"GlassBall": (9, 9, 0.7)})
    else:
        (scene, over), ms = S.scene_and_overrides(D, name), None
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=17 / 9, frame_index=3,
                                 mesh_service=ms), "cuda")
    cfg = make_config(scene, 17, 9, **dict(over, max_queue_iters=0))
    got = MK.render_accum(sc, cfg)
    want = R.render_accum(sc, cfg)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    assert int(got[R.CH_RAYS].sum()) == 0


BAND_SCENES = {
    "demo": (lambda: S.demo_scene(D), S.DEMO_OVERRIDES, None),
    "glass_ball": (lambda: S.glass_ball_scene(D), {"max_soft_samples": 2},
                   {"GlassBall": (9, 9, 0.7)}),
}


@pytest.mark.parametrize("name", list(BAND_SCENES))
def test_wrappers_refuse_frames_past_the_plane_index(name):
    """A frame whose planes pass the plane index (here a limit of five
    64-pixel rows of K7's planes, which bands 64x32 into 5 bands for K1, 8
    for K7) renders in row bands, a launch a band, bit-equal to one launch:
    K1 (K1-mesh for the glass ball) at spp 2, and K7 + sort + K8 at spp 1
    (each band sorted on its own; a pixel's result does not depend on the
    order)."""
    _need_cuda()
    build, over, meshes = BAND_SCENES[name]
    scene = build()
    w, h = 64, 32
    ms = None if meshes is None else S.mesh_service(PMC, meshes)
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3,
                                 mesh_service=ms), "cuda")
    limit = R.NUM_CH_A * w * 5
    for spp in (2, 1):
        cfg = make_config(scene, w, h, **dict(over, samples_per_pixel=spp))
        one = MK.render_accum(sc, cfg)
        before = MK.render_accum.launches
        banded = MK.render_accum(sc, cfg, limit=limit)
        assert MK.render_accum.launches - before == len(MK.row_bands(w, h, R.NUM_CH, limit)) == 5
        torch.cuda.synchronize()
        assert _bits_equal(banded, one)
    one = TP.render_accum_two_phase(sc, cfg, 0.0)
    before = (MK.render_phase_a.launches, MK.render_phase_b.launches)
    banded = TP.render_accum_two_phase(sc, cfg, 0.0, limit=limit)
    n = (MK.render_phase_a.launches - before[0], MK.render_phase_b.launches - before[1])
    assert n == (8, 8)
    torch.cuda.synchronize()
    assert _bits_equal(banded, one)
    a = MK.render_phase_a(sc, cfg, limit=limit)
    assert _bits_equal(a, MK.render_phase_a(sc, cfg))


@pytest.mark.parametrize("name", ["demo", "config6_soft_shadows", "glass_ball"])
def test_counting_build_counts_equal_plain(name):
    """The counting build of K1 (without and with meshes) renders the
    kernel's planes and counts what the plain version counts: the DFS's
    iterations, shade calls, shadow and thickness rays, hits and lights
    (all but the warp figure), the walks and their triangle tests."""
    _need_cuda()
    if name == "glass_ball":
        scene, over = S.glass_ball_scene(D), {"max_soft_samples": 2}
        ms = S.mesh_service(PMC, {"GlassBall": (9, 9, 0.7)})
    else:
        (scene, over), ms = S.scene_and_overrides(D, name), None
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=72 / 40, frame_index=3,
                                 mesh_service=ms), "cuda")
    cfg = make_config(scene, 72, 40, **over)
    counts, plain = (torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64, device="cuda")
                     for _ in range(2))
    assert _bits_equal(MK.render_accum(sc, cfg, counts=counts), MK.render_accum(sc, cfg))
    R.render_accum(sc, cfg, counts=plain)
    counts, plain = counts.cpu(), plain.cpu()
    dfs = R.COUNT_ROWS.index("dfs")
    assert torch.equal(counts[dfs + 1:], plain[dfs + 1:])
    assert torch.equal(counts[dfs, [0, 2, 3]], plain[dfs, [0, 2, 3]])
    assert int(counts[dfs, 1]) >= int(counts[dfs, 0]) > 0  # warp slots cover the lanes
    assert torch.equal(counts[:4, [0, 3]], plain[:4, [0, 3]])


def test_deep_forest_through_the_threaded_walks():
    """A mesh whose wide table needs more stack than the kernels hold: K1-mesh,
    K7 and K8 take the threaded instantiations and render what the plain
    version renders, bit for bit, and the walks alone return the plain
    walks' results; their counting build counts the plain walks' node
    fetches."""
    _need_cuda()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as CS

    scene = S.deep_forest_scene(D)
    w, h = 97, 61
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3,
                                 mesh_service=S.deep_forest_service(PMC)), "cuda")
    assert sc.mesh.wide_stack > B.WALK_STACK and MK.check_mesh(sc.mesh, "test")
    cfg = make_config(scene, w, h, max_soft_samples=2)
    before = MK.render_accum.launches
    got, modes = _render_modes(lambda: MK.render_accum(sc, cfg))
    assert modes == [3] and MK.render_accum.launches == before + 1  # MODE_MESH | MODE_THREADED
    assert _bits_equal(got, R.render_accum(sc, cfg))
    assert bool((got[R.CH_OBJ_ID] >= 3 * 65536).any())
    cfg1 = cfg._replace(samples_per_pixel=1)
    a = MK.render_phase_a(sc, cfg1)
    want_a = R.render_accum_phase_a(sc, cfg1)
    assert _bits_equal(a, want_a)
    order, count = TP.coherence_order(want_a)
    b = MK.render_phase_b(sc, cfg1, order, count, want_a[:R.NUM_CH].clone(), want_a[R.CH_HIT:])
    want_b = R.render_accum_phase_b(sc, cfg1, order[:int(count)], want_a[:R.NUM_CH].clone(),
                                    want_a[R.CH_HIT:])
    assert _bits_equal(b, want_b)
    counts, plain = (torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64, device="cuda")
                     for _ in range(2))
    MK.render_accum(sc, cfg, counts=counts)
    R.render_accum(sc, cfg, counts=plain)
    dfs = R.COUNT_ROWS.index("dfs")
    assert torch.equal(counts[:dfs], plain[:dfs])
    CS.check_walks("deep forest", MW, B, C, sc.mesh, CS.walk_rays(R, I, C, sc, cfg, 6))


def _inputs(h, w, seed):
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return (torch.rand(shape, generator=g) * (hi - lo) + lo).cuda()

    state = torch.cat([u(14, h, w), u(1, h, w, hi=10.0), u(1, h, w, lo=1.0, hi=51.0)])
    return dict(state=state, curr=u(8, h, w, hi=2.0), view_z=u(h, w, lo=1.0, hi=51.0),
                nr=u(4, h, w), img6=u(6, h, w) ** 3 * 4, guide=u(2, h, w, hi=6.0),
                shadow=u(2, h, w), rough=u(h, w, hi=0.2),
                obj_id=torch.randint(-1, 4, (h, w), generator=g, dtype=torch.int32).cuda(),
                motion=u(2, h, w, lo=-3.0, hi=3.0))


def test_k2_cuda_matches_plain():
    _need_cuda()
    x = _inputs(72, 136, 1)
    ms = x["motion"] + 0.5
    got = K.reproject_accumulate(x["state"], x["curr"], x["motion"], x["view_z"], x["rough"], ms)
    want = PD_.temporal_accumulate(x["state"], x["curr"], x["motion"], x["view_z"], x["rough"],
                                   ms)
    assert float((got - want).abs().max()) <= 1e-5


# Frames of one pixel, smaller than K3's halo (8) or K4's (2) in one axis or
# both, one tile row or column, ragged against both kernels' tiles (K3 32x24,
# K4 32x16), and several tiles with edge and corner tiles.
DENOISE_SIZES = [(1, 1), (3, 5), (7, 300), (37, 61), (72, 136), (270, 480)]


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("size", DENOISE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k3_cuda_matches_plain(size):
    """K3 (the clamp and three passes, one launch) bit-equal to its plain
    version, edge and corner tiles included."""
    _need_cuda()
    h, w = size
    x = _inputs(h, w, 2 + h * w)
    # a surface of one depth and black pixels: the kernel's zero dividends
    x["view_z"][:h // 2, :w // 2] = 7.0
    x["img6"][:, h // 3:, w // 3:] = 0.0
    normal = PD_.decode_oct_cf(x["nr"])
    before = K.atrous.launches
    got = K.atrous(x["img6"], x["view_z"], normal, x["guide"])
    assert K.atrous.launches == before + 1
    want = PD_.atrous(x["img6"], x["view_z"], normal, x["guide"])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _same_bits(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("size", DENOISE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_k4_cuda_matches_plain(size):
    """K4 (the 5x5 filter over a shared-memory tile) bit-equal to its plain
    version."""
    _need_cuda()
    h, w = size
    x = _inputs(h, w, 3 + h * w)
    x["view_z"][:h // 2, :w // 2] = 7.0
    x["shadow"][:, h // 3:, w // 3:] = 0.0
    normal = PD_.decode_oct_cf(x["nr"])
    got = K.shadow_denoise(x["shadow"], x["obj_id"], x["view_z"], normal)
    want = PD_.shadow_denoise(x["shadow"], x["obj_id"], x["view_z"], normal)
    torch.cuda.synchronize()
    assert _same_bits(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("size", DENOISE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_atrous_pass_cuda_matches_plain(size, stride, clamp):
    """The per-pass a-trous kernel (one pass, the clamp first when asked)
    bit-equal to its plain version; the chain of three launches bit-equal
    to the fused K3."""
    _need_cuda()
    h, w = size
    x = _inputs(h, w, 4 + h * w)
    x["view_z"][:h // 2, :w // 2] = 7.0
    x["img6"][:, h // 3:, w // 3:] = 0.0
    normal = PD_.decode_oct_cf(x["nr"])
    before = K.atrous_pass.launches
    got = K.atrous_pass(x["img6"], x["view_z"], normal, x["guide"], stride, clamp)
    assert K.atrous_pass.launches == before + 1
    want = PD_.atrous_single_pass(x["img6"], x["view_z"], normal, x["guide"], stride, clamp)
    torch.cuda.synchronize()
    assert _same_bits(got, want), float((got - want).abs().max())
    if stride == 1 and clamp:
        chain = x["img6"]
        for p in range(PD_.ATROUS_PASSES):
            chain = K.atrous_pass(chain, x["view_z"], normal, x["guide"], 1 << p, p == 0)
        assert _same_bits(chain, K.atrous(x["img6"], x["view_z"], normal, x["guide"]))


def _slab_pieces(img, view_z, normal, guide, row0, rows, stride, clamp, copies):
    """The slab form's arguments for frame rows [row0, row0 + rows): the
    slab, its neighbours' rows as views of the frame (planes a frame apart)
    or as contiguous copies, and z, normal and guide extended by
    ATROUS_REACH rows."""
    h = view_z.shape[0]
    na, nb = PD_.pass_halo(row0, rows, h, stride + int(clamp))
    a0, a1 = max(row0 - PD_.ATROUS_REACH, 0), min(row0 + rows + PD_.ATROUS_REACH, h)
    above, below = img[:, row0 - na:row0], img[:, row0 + rows:row0 + rows + nb]
    aux = torch.cat([view_z[None], normal, guide])[:, a0:a1]
    if copies:
        above, below, aux = above.contiguous(), below.contiguous(), aux.contiguous()
    return (img[:, row0:row0 + rows].contiguous(), above, below, aux[0], aux[1:4], aux[4:6], row0,
            h)


@pytest.mark.parametrize("copies", [False, True], ids=["views", "copies"])
@pytest.mark.parametrize("size", DENOISE_SIZES + [(1079, 1917)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_atrous_pass_slab_cuda_matches_plain(size, copies):
    """The per-pass kernel's slab form on the top, second and last of four
    row slabs (the last takes the remainder), its neighbours' rows given as
    views or as contiguous copies, at strides 1, 2 and 4 with and without
    the clamp: bit-equal to its plain version, which is bit-equal to the
    whole frame's rows."""
    _need_cuda()
    h, w = size
    x = _inputs(h, w, 6 + h * w)
    x["view_z"][:h // 2, :w // 2] = 7.0
    x["img6"][:, h // 3:, w // 3:] = 0.0
    normal = PD_.decode_oct_cf(x["nr"])
    rows = max(h // 4, 1)
    slabs = sorted({(0, rows), (rows, rows), (3 * rows, h - 3 * rows)} if h >= 4 else {(0, h)})
    for stride in (1, 2, 4):
        for clamp in (False, True):
            whole = PD_.atrous_single_pass(x["img6"], x["view_z"], normal, x["guide"], stride,
                                           clamp)
            for row0, n in slabs:
                args = _slab_pieces(x["img6"], x["view_z"], normal, x["guide"], row0, n, stride,
                                    clamp, copies)
                before = K.atrous_pass.launches
                got = K.atrous_pass_slab(*args, stride, clamp)
                assert K.atrous_pass.launches == before + 1
                want = PD_.atrous_pass_slab(*args, stride, clamp)
                torch.cuda.synchronize()
                assert _same_bits(want, whole[:, row0:row0 + n])
                assert _same_bits(got, want), (stride, clamp, row0,
                                               float((got - want).abs().max()))


# ---- K9 (the G-buffer assembly) and K10 (the REBLUR prepass) --------------

def _k9_case(source):
    """(scene tensors, cfg, accumulator planes) on the card: the demo
    scene's second orbiting frame (a moved camera, so motion is not zero)
    through K1 at 64x36 spp 2 ("k1"), a 12-row slab of it from row 8
    ("slab"), the two-phase renderer at 72x40 spp 1 ("two_phase") and K1
    at a ragged 53x37 ("ragged")."""
    if source == "two_phase":
        sc, cfg = _two_phase_scene("demo")
        return sc, cfg, TP.render_accum_two_phase(sc, cfg, 0.0)
    w, h = (53, 37) if source == "ragged" else (64, 36)
    prev = flatten_scene(sanitize_scene(S.demo_scene(D, 0)), aspect=w / h).view_proj
    scene = S.demo_scene(D, 1)
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=1,
                                 prev_view_proj=prev), "cuda")
    cfg = make_config(scene, w, h, **S.DEMO_OVERRIDES)
    if source == "slab":
        return sc, cfg, MK.render_accum(sc, cfg, row_start=8, num_rows=12)
    return sc, cfg, MK.render_accum(sc, cfg)


def _frame_fields(out):
    return dict(color=out.color, raw_specular=out.raw_specular, rays=out.rays,
                **{k: v for k, v in out.gbuffer._asdict().items() if v is not None})


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("source", ["k1", "two_phase", "slab", "ragged"])
def test_k9_bit_equal_to_plain(source, mode):
    """K9 against assemble_frame_cf on the same accumulator planes in photon
    debug modes 0, 1 and 2: every field's shape, dtype and bits; one
    launch; the diffuse and specular pairs adjacent in one buffer."""
    _need_cuda()
    sc, cfg, acc = _k9_case(source)
    cfg = cfg._replace(photon_debug_mode=mode)
    before = G.assemble.launches
    got = _frame_fields(G.assemble(sc, cfg, acc))
    assert G.assemble.launches == before + 1
    want = _frame_fields(assemble_frame_cf(sc, cfg, accum_dict(acc)))
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for name, b in want.items():
        a = got[name]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), name
        same = torch.equal(a, b) if a.dtype != torch.float32 else _same_bits(a, b)
        assert same, (name, float((a.double() - b.double()).abs().max()))
    d, s = got["diffuse_hitdist"], got["specular_hitdist"]
    assert s.data_ptr() == d.data_ptr() + d.nbytes
    assert PD_._hitdist_planes(G.assemble(sc, cfg, acc).gbuffer).is_contiguous()
    if source != "two_phase":  # the two-phase case's camera does not move
        assert float(got["motion"].abs().max()) > 0.0


def _prepass_case(h, w, seed):
    """K10's inputs: curr [8,h,w] with a third of the hit distances cleared
    (the reconstruction's work), view_z with a sky corner, sqrt_rough."""
    x = _inputs(h, w, seed)
    curr, view_z = x["curr"], x["view_z"]
    curr[3, ::3, ::2] = 0.0
    curr[7, 1::3, ::2] = 0.0
    curr[7, ::5, 1::4] = -1.0
    view_z[:h // 3, :w // 3] = C.VIEWZ_SKY
    return curr, view_z, x["nr"][3].contiguous()


@pytest.mark.parametrize("size", DENOISE_SIZES + [(1080, 1920)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_k10_bit_equal_to_plain(size):
    """K10 against reblur_prepass bit for bit, one launch, whole frames from
    one pixel to 1080p (ragged against its 32x16 tile)."""
    _need_cuda()
    h, w = size
    curr, view_z, sqrt_rough = _prepass_case(h, w, 8 + h * w)
    before = K.reblur_prepass.launches
    got = K.reblur_prepass(curr, view_z, sqrt_rough)
    assert K.reblur_prepass.launches == before + 1
    want = PD_.reblur_prepass(curr, view_z, sqrt_rough)
    torch.cuda.synchronize()
    assert _same_bits(got, want), float((got - want).abs().max())


def test_k10_on_prepass_halo_slabs_bit_equal_to_plain():
    """K10 on the four PREPASS_HALO-extended row slabs of a 72x136 frame,
    as the sharded denoise runs it: each bit-equal to the plain version on
    the same slab, whose kept rows equal the whole frame's."""
    _need_cuda()
    h, w, n = 72, 136, 4
    curr, view_z, sqrt_rough = _prepass_case(h, w, 11)
    whole = PD_.reblur_prepass(curr, view_z, sqrt_rough)
    rows, halo = h // n, PD_.PREPASS_HALO
    ext = PD_.exchange_row_halo([torch.cat([curr, view_z[None], sqrt_rough[None]])
                                 [:, i * rows:(i + 1) * rows] for i in range(n)], halo)
    for i, e in enumerate(ext):
        got = K.reblur_prepass(e[0:8], e[8], e[9])
        want = PD_.reblur_prepass(e[0:8], e[8], e[9])
        torch.cuda.synchronize()
        assert _same_bits(got, want), (i, float((got - want).abs().max()))
        assert _same_bits(want[:, halo:halo + rows], whole[:, i * rows:(i + 1) * rows])


def test_k9_k10_read_nothing_back_to_the_host():
    """Both wrappers under torch.cuda.set_sync_debug_mode("error"): no
    operation that waits on the device (a host read, a pageable upload)."""
    _need_cuda()
    sc, cfg, acc = _k9_case("k1")
    g = G.assemble(sc, cfg, acc).gbuffer  # builds the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = G.assemble(sc, cfg, acc).gbuffer
        K.reblur_prepass(PD_._hitdist_planes(g), g.view_z, g.normal_roughness[3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_k2_slab_form_cuda_matches_plain():
    """K2 on 18-row slabs of a 72-row frame, the history extended by
    TEMPORAL_HALO rows: within 1e-5 of the plain slab form, which is
    bit-equal to the whole frame's rows."""
    _need_cuda()
    h, w, n = 72, 136, 4
    x = _inputs(h, w, 5)
    motion = x["motion"] * 9.0
    ms = motion + 0.5
    rows, halo = h // n, PD_.TEMPORAL_HALO
    whole = PD_.temporal_accumulate(x["state"], x["curr"], motion, x["view_z"], x["rough"], ms)
    ext = PD_.exchange_row_halo([x["state"][:, i * rows:(i + 1) * rows] for i in range(n)], halo)
    for i in range(n):
        sl = slice(i * rows, (i + 1) * rows)
        args = (ext[i], x["curr"][:, sl].contiguous(), motion[:, sl].contiguous(),
                x["view_z"][sl].contiguous(), x["rough"][sl].contiguous(),
                ms[:, sl].contiguous())
        got = K.reproject_accumulate(*args, halo, i * rows, h)
        want = PD_.temporal_accumulate(*args, halo, i * rows, h)
        assert torch.equal(want, whole[:, sl])
        assert float((got - want).abs().max()) <= 1e-5


def test_sharded_engine_cuda_bit_equal_to_single_device():
    """Engine(device_mesh=[cuda:0] * 4) on the card: three orbiting frames
    bit-equal to the single-device Engine's, the per-pass kernel and K2's
    slab form launched."""
    _need_cuda()
    w, h = 64, 36
    one = Engine(w, h)
    four = Engine(w, h, device_mesh=["cuda:0"] * 4)
    before = K.atrous_pass.launches
    for f in range(3):
        for e in (one, four):
            e.update_scene(S.demo_scene(D, f), **S.DEMO_OVERRIDES)
        a, b = one.render(), four.render()
        np.testing.assert_array_equal(a, b)
        assert _same_bits(one._last_hdr_t, four._last_hdr_t)
        assert _same_bits(one._denoise_state.packed,
                          torch.cat([s.packed for s in four._denoise_state], 1))
    assert K.atrous_pass.launches - before == 3 * 3 * 4


def test_engine_cuda_matches_cpu_and_launches_every_kernel():
    _need_cuda()
    w, h = 64, 36
    gpu, cpu = Engine(w, h, device="cuda"), Engine(w, h, device="cpu")
    kernels = [MK.render_accum, G.assemble, K.reblur_prepass, K.reproject_accumulate, K.atrous,
               K.shadow_denoise]
    counts = [k.launches for k in kernels]
    for f in range(2):
        for e in (gpu, cpu):
            e.update_scene(S.demo_scene(D, f), **S.DEMO_OVERRIDES)
        a, b = gpu.render(), cpu.render()
        assert gpu.last_rays == cpu.last_rays
        d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
        assert (d <= 1).mean() >= 0.995
    assert [k.launches - c for k, c in zip(kernels, counts)] == [2, 2, 2, 2, 2, 2]


def test_mesh_engine_cuda_matches_cpu_and_launches_every_kernel():
    _need_cuda()
    w, h = 64, 36
    gpu = Engine(w, h, device="cuda", mesh_service=S.mesh_service(PMC, S.MESH_DEMO_SMALL))
    cpu = Engine(w, h, device="cpu", mesh_service=S.mesh_service(PMC, S.MESH_DEMO_SMALL))
    counts = [MK.render_accum.launches, K.reproject_accumulate.launches, K.atrous.launches,
              K.shadow_denoise.launches]
    for f in range(2):
        for e in (gpu, cpu):
            e.update_scene(S.mesh_demo_scene(D, f), **S.DEMO_OVERRIDES)
        a, b = gpu.render(), cpu.render()
        assert gpu.last_rays == cpu.last_rays
        d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
        assert (d <= 1).mean() >= 0.995
    after = [MK.render_accum.launches, K.reproject_accumulate.launches, K.atrous.launches,
             K.shadow_denoise.launches]
    assert [y - x for x, y in zip(counts, after)] == [2, 2, 2, 2]


PHOTON_SCENES = {
    "demo": (lambda: S.demo_scene(D), None),
    "config5": (lambda: S.caustics_golden_scene(D), None),
    "mesh_demo": (lambda: S.mesh_demo_scene(D), S.MESH_DEMO_SMALL),
}


def _photon_scene(name):
    build, meshes = PHOTON_SCENES[name]
    ms = None if meshes is None else S.mesh_service(PMC, meshes)
    scene = build()
    return scene, to_device(flatten_scene(sanitize_scene(scene), aspect=72 / 40,
                                          mesh_service=ms), "cuda")


@pytest.mark.parametrize("total,offset,count", [(None, 0, None), (256, 0, 256),
                                                (16384, 0, 16384), (16384, 5000, 3000)])
@pytest.mark.parametrize("name", list(PHOTON_SCENES))
def test_k5_cuda_matches_plain(name, total, offset, count):
    """K5 (emission and the bounce loop in one launch) on the frame's
    packed tables (a mesh scene keeps its instance material rows, which
    the light table follows) against the plain emission and bounce loop,
    photons [offset, offset+count) of a total-photon batch (None: 4x the
    scene's photon budget, the whole batch); no plain emission op runs for
    the kernel. A whole batch of 16,384 or more photons stores more than
    10, every other case at least one, so the masks never compare empty."""
    _need_cuda()
    scene, sc = _photon_scene(name)
    if total is None:
        total = count = 4 * PP.photon_budget(sanitize_scene(scene))
    tables = MK.pack_tables(sc)
    before = (PK.emit_and_trace.launches, PP._emit_photons.launches)
    got = PK.emit_and_trace(sc, total, offset, count, tables)
    assert (PK.emit_and_trace.launches, PP._emit_photons.launches) == (before[0] + 1, before[1])
    em = PP._emit_photons(sc, total, offset, count)
    idx = torch.arange(count, dtype=torch.int32, device="cuda") + offset
    want = PP._trace_photons(sc, *em, idx)
    torch.cuda.synchronize()
    m = want[4]
    assert torch.equal(got[4], m)
    assert int(m.sum()) > (10 if count >= 16384 else 0)
    for c, atol in enumerate((5e-3, 1e-4, 1e-5, 1e-4)):
        torch.testing.assert_close(got[c][m], want[c][m], atol=atol, rtol=1e-3)


@pytest.mark.parametrize("name", ["demo", "config5"])
def test_k6_cuda_matches_plain(name):
    """K6 on K1's accumulator planes of a caustics frame, with the frame's
    map and one of 8x the budget (the 32-photon cap binds at the focus)."""
    _need_cuda()
    scene, sc = _photon_scene(name)
    w, h = 72, 40
    cfg = make_config(scene, w, h, enable_caustics=True)
    acc = MK.render_accum(sc, cfg)
    cd = [c for r in (R.CH_COLOR, R.CH_DIFFUSE) for c in range(r, r + 3)]
    others = [c for c in range(R.NUM_CH) if c not in cd]
    for n in (cfg.num_photons, 8 * cfg.num_photons):
        pmap = PP.emit_and_trace(sc, n)
        got, want = acc.clone(), acc.clone()
        before = PK.add_caustics.launches
        assert PK.add_caustics(pmap, got, cfg.samples_per_pixel) is got
        assert PK.add_caustics.launches == before + 1
        PP.add_caustics(pmap, want, cfg.samples_per_pixel)
        torch.cuda.synchronize()
        assert bool((want[cd] != acc[cd]).any())
        assert bool(((got[cd] - want[cd]).abs() <= 1e-5 * want[cd].abs().clamp(min=1.0)).all()), \
            float((got[cd] - want[cd]).abs().max())
        assert _bits_equal(got[others], acc[others])


def test_caustics_engine_cuda_matches_cpu_and_launches_every_kernel():
    _need_cuda()
    w, h = 64, 36
    gpu, cpu = Engine(w, h, device="cuda"), Engine(w, h, device="cpu")
    kernels = [MK.render_accum, PK.emit_and_trace, PK.add_caustics, K.reproject_accumulate,
               K.atrous, K.shadow_denoise]
    counts = [k.launches for k in kernels]
    emitted = PP._emit_photons.launches
    for f in range(2):
        for e in (gpu, cpu):
            e.update_scene(S.caustics_golden_scene(D, f))
        a, b = gpu.render(), cpu.render()
        assert gpu.last_rays == cpu.last_rays
        d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
        assert (d <= 1).mean() >= 0.995
    assert [k.launches - c for k, c in zip(kernels, counts)] == [2, 2, 2, 2, 2, 2]
    assert PP._emit_photons.launches - emitted == 2  # the CPU Engine's two frames


TWO_PHASE_SCENES = {
    "demo": (lambda: S.demo_scene(D), dict(S.DEMO_OVERRIDES, samples_per_pixel=1), None),
    "glass_ball": (lambda: S.glass_ball_scene(D), {"max_soft_samples": 2},
                   {"GlassBall": (9, 9, 0.7)}),
}
RECORD_PLANES = list(range(R.CH_PRIMARY, R.CH_HITDIST + 1)) + list(range(R.CH_PRIM_HIT, R.NUM_CH))


def _two_phase_scene(name):
    build, over, meshes = TWO_PHASE_SCENES[name]
    scene = build()
    w, h = 72, 40
    ms = None if meshes is None else S.mesh_service(PMC, meshes)
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3,
                                 mesh_service=ms), "cuda")
    cfg = make_config(scene, w, h, **over)
    assert cfg.samples_per_pixel == 1
    return sc, cfg


def _assert_like_plain(got, want):
    """K1's band against the plain version: rays and ids exact, colour 2e-4
    on >= 99% of the pixels, the planes finite (but K7's hit planes, which
    hold int bits)."""
    assert torch.equal(got[R.CH_RAYS], want[R.CH_RAYS])
    assert torch.equal(got[R.CH_OBJ_ID], want[R.CH_OBJ_ID])
    d = (got[0:3] - want[0:3]).abs().amax(0)
    assert float((d <= 2e-4).float().mean()) >= 0.99, float(d.max())
    assert torch.isfinite(got[:R.CH_HIT]).all()


@pytest.mark.parametrize("name", list(TWO_PHASE_SCENES))
def test_k7_cuda_matches_plain(name):
    """K7 (rtvs_render_phase_a[_mesh]) against plain phase A, the spawned
    continuations included."""
    _need_cuda()
    sc, cfg = _two_phase_scene(name)
    before = MK.render_phase_a.launches
    got = MK.render_phase_a(sc, cfg)
    assert MK.render_phase_a.launches == before + 1
    want = R.render_accum_phase_a(sc, cfg)
    torch.cuda.synchronize()
    assert got.shape == (R.NUM_CH_A, 40, 72)
    _assert_like_plain(got, want)
    # the continuation and the primary's hit (ints as their bits) bit-equal
    assert torch.equal(got[R.CH_SPAWN_VALID:].view(torch.int32),
                       want[R.CH_SPAWN_VALID:].view(torch.int32))
    assert int(want[R.CH_SPAWN_VALID].sum()) > 50


@pytest.mark.parametrize("name", list(TWO_PHASE_SCENES))
def test_k8_cuda_matches_plain(name):
    """K8 (rtvs_render_phase_b[_mesh]) against plain phase B on the same
    phase-A planes and the same sorted order; the count stays on the card."""
    _need_cuda()
    sc, cfg = _two_phase_scene(name)
    a = R.render_accum_phase_a(sc, cfg)
    order, count = TP.coherence_order(a)
    before = MK.render_phase_b.launches
    got = MK.render_phase_b(sc, cfg, order, count, a[:R.NUM_CH].clone(), a[R.CH_HIT:])
    assert MK.render_phase_b.launches == before + 1
    want = R.render_accum_phase_b(sc, cfg, order[:int(count)], a[:R.NUM_CH].clone(),
                                  a[R.CH_HIT:])
    torch.cuda.synchronize()
    _assert_like_plain(got, want)
    assert torch.equal(got[R.CH_BOUNCE], want[R.CH_BOUNCE])
    assert float(got[R.CH_RAYS].sum()) > float(a[R.CH_RAYS].sum())


@pytest.mark.parametrize("name", list(TWO_PHASE_SCENES))
def test_k7_k8_match_k1(name):
    """The two phases on the card against K1 at spp 1: rays, bounce and
    every record plane bit-equal, colour within 2e-5 * max(1, |K1|)."""
    _need_cuda()
    sc, cfg = _two_phase_scene(name)
    k1 = MK.render_accum(sc, cfg)
    two = TP.render_accum_two_phase(sc, cfg, 0.0)
    torch.cuda.synchronize()
    assert torch.equal(two[R.CH_RAYS], k1[R.CH_RAYS])
    assert torch.equal(two[R.CH_BOUNCE], k1[R.CH_BOUNCE])
    assert torch.equal(two[RECORD_PLANES], k1[RECORD_PLANES])
    c1, c2 = k1[0:3], two[0:3]
    assert bool(((c2 - c1).abs() <= 2e-5 * c1.abs().clamp(min=1.0)).all())


def test_two_phase_engine_cuda_matches_cpu_and_launches_every_kernel():
    _need_cuda()
    w, h = 64, 36
    over = dict(S.DEMO_OVERRIDES, samples_per_pixel=1)
    gpu = Engine(w, h, device="cuda", mesh_service=S.mesh_service(PMC, S.MESH_DEMO_SMALL),
                 two_phase=True)
    cpu = Engine(w, h, device="cpu", mesh_service=S.mesh_service(PMC, S.MESH_DEMO_SMALL),
                 two_phase=True)
    kernels = [MK.render_accum, MK.render_phase_a, MK.render_phase_b,
               K.reproject_accumulate, K.atrous, K.shadow_denoise]
    counts = [k.launches for k in kernels]
    for f in range(2):
        for e in (gpu, cpu):
            e.update_scene(S.mesh_demo_scene(D, f), **over)
        a, b = gpu.render(), cpu.render()
        assert gpu.last_rays == cpu.last_rays
        d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
        assert (d <= 1).mean() >= 0.995
    assert [k.launches - c for k, c in zip(kernels, counts)] == [0, 2, 2, 2, 2, 2]


def test_wrappers_reject_bad_inputs():
    _need_cuda()
    sc, cfg = _two_phase_scene("demo")
    a = MK.render_phase_a(sc, cfg)
    order, count = TP.coherence_order(a)
    with pytest.raises(ValueError, match="order"):
        MK.render_phase_b(sc, cfg, order.long(), count, a[:R.NUM_CH], a[R.CH_HIT:])
    with pytest.raises(ValueError, match="samples_per_pixel"):
        MK.render_phase_a(sc, cfg._replace(samples_per_pixel=2))
    with pytest.raises(ValueError, match="aperture"):
        TP.render_accum_two_phase(sc, cfg, 0.1)
    x = _inputs(16, 16, 4)
    with pytest.raises(ValueError, match="contiguous"):
        K.atrous(x["img6"].transpose(1, 2).contiguous().transpose(1, 2), x["view_z"],
                 PD_.decode_oct_cf(x["nr"]), x["guide"])
    with pytest.raises(ValueError, match="dtype"):
        K.shadow_denoise(x["shadow"], x["obj_id"].to(torch.int64), x["view_z"],
                         PD_.decode_oct_cf(x["nr"]))
    args = list(_slab_pieces(x["img6"], x["view_z"], PD_.decode_oct_cf(x["nr"]), x["guide"], 4, 4,
                             2, False, False))
    with pytest.raises(ValueError, match="above"):  # the reach is 3 rows with the clamp
        K.atrous_pass_slab(*args, 2, True)
    args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="rows are not contiguous"):
        K.atrous_pass_slab(*args, 2, False)
    _, sc = _photon_scene("demo")
    with pytest.raises(ValueError, match="photons"):
        PK.emit_and_trace(sc, 256, -1, 256)
    with pytest.raises(ValueError, match="dtype"):
        PK.emit_and_trace(sc, 256, 0, 256, (MK.pack_tables(sc)[0], torch.zeros(3, device="cuda")))
    pmap = PP.emit_and_trace(sc, 256)
    with pytest.raises(ValueError, match="shape"):
        PK.add_caustics(pmap, torch.zeros((8, 16, 16), device="cuda"), 2)
    curr, view_z, sqrt_rough = _prepass_case(16, 16, 4)
    with pytest.raises(ValueError, match="shape"):
        K.reblur_prepass(curr[:6].contiguous(), view_z, sqrt_rough)
    with pytest.raises(ValueError, match="dtype"):
        K.reblur_prepass(curr, view_z.double(), sqrt_rough)
    with pytest.raises(ValueError, match="contiguous"):
        K.reblur_prepass(curr, view_z, sqrt_rough.t())
    sc, cfg, acc = _k9_case("k1")
    with pytest.raises(ValueError, match="acc"):
        G.assemble(sc, cfg, acc[:R.NUM_CH - 1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        G.assemble(sc, cfg, acc.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="view_proj"):
        G.assemble(sc._replace(view_proj=sc.view_proj.double()), cfg, acc)


# ---- the photon debug modes ------------------------------------------------

@pytest.mark.parametrize("mode", [3, 4])
@pytest.mark.parametrize("name", ["demo", "mesh_demo"])
def test_k1_debug_modes_bit_equal_to_plain(name, mode):
    """K1 (analytic) and K1-mesh in photon debug modes 3 and 4 (transmission
    or metallic as grey at depth-0 hits) at 64x32, every plane bit for bit;
    the mode changes the frame."""
    _need_cuda()
    meshes = S.MESH_DEMO_SMALL if name == "mesh_demo" else None
    build = S.mesh_demo_scene if meshes else S.demo_scene
    ms = None if meshes is None else S.mesh_service(PMC, meshes)
    scene = build(D)
    w, h = 64, 32
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3,
                                 mesh_service=ms), "cuda")
    cfg = make_config(scene, w, h, **dict(S.DEMO_OVERRIDES, photon_debug_mode=mode))
    got = MK.render_accum(sc, cfg)
    want = R.render_accum(sc, cfg)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    assert not torch.equal(got, MK.render_accum(sc, cfg._replace(photon_debug_mode=0)))


def test_k7_debug_mode_bit_equal_to_plain_and_k7_k8_match_k1():
    """K7 in photon debug mode 3 at 64x32 (spp 1), bit for bit with plain
    phase A; K7 + sort + K8 against K1 in mode 3 as in mode 0."""
    _need_cuda()
    scene = S.demo_scene(D)
    w, h = 64, 32
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3), "cuda")
    cfg = make_config(scene, w, h, **dict(S.DEMO_OVERRIDES, samples_per_pixel=1,
                                          photon_debug_mode=3))
    got = MK.render_phase_a(sc, cfg)
    want = R.render_accum_phase_a(sc, cfg)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    k1 = MK.render_accum(sc, cfg)
    two = TP.render_accum_two_phase(sc, cfg, 0.0)
    assert torch.equal(two[R.CH_RAYS], k1[R.CH_RAYS])
    assert torch.equal(two[RECORD_PLANES], k1[RECORD_PLANES])
    c1, c2 = k1[0:3], two[0:3]
    assert bool(((c2 - c1).abs() <= 2e-5 * c1.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_k6_replacement_mode_matches_plain(scale):
    """K6 in replacement mode (a nonzero photon debug mode) at 64x32 on K1's
    planes of a caustics frame: the colour, primary, diffuse, specular and
    shadow planes within 1e-5 * max(1, |plain|) of the plain version's,
    every other plane's bits kept."""
    _need_cuda()
    scene, sc = _photon_scene("demo")
    cfg = make_config(scene, 64, 32, enable_caustics=True)
    acc = MK.render_accum(sc, cfg)
    pmap = PP.emit_and_trace(sc, cfg.num_photons)
    ch = [c for r in (R.CH_COLOR, R.CH_PRIMARY, R.CH_DIFFUSE, R.CH_SPECULAR)
          for c in range(r, r + 3)] + [R.CH_SHADOW_VIS, R.CH_SHADOW_PEN, R.CH_SHADOW_DIST]
    others = [c for c in range(R.NUM_CH) if c not in ch]
    got, want = acc.clone(), acc.clone()
    before = PK.add_caustics.launches
    assert PK.add_caustics(pmap, got, cfg.samples_per_pixel, replace=True, scale=scale) is got
    assert PK.add_caustics.launches == before + 1
    PP.add_caustics(pmap, want, cfg.samples_per_pixel, replace=True, scale=scale)
    torch.cuda.synchronize()
    assert bool((want[ch] != acc[ch]).any())
    assert bool(((got[ch] - want[ch]).abs() <= 1e-5 * want[ch].abs().clamp(min=1.0)).all()), \
        float((got[ch] - want[ch]).abs().max())
    assert _bits_equal(got[others], acc[others])


def test_engine_spans_on_the_card_are_host_events_alone():
    """A 480x270 demo frame on the card under torch.profiler (host and
    device): its update_scene and render give the span trees of the CPU
    (tests/test_torch_spans.py), the device ran the frame's kernels, and no
    device-side event carries a span's name, so a reader of the trace finds
    the device's operations without the spans."""
    _need_cuda()
    from torch.autograd import DeviceType

    import test_torch_spans as TS

    eng = Engine(480, 270, device="cuda")
    eng.update_scene(S.demo_scene(D), **S.DEMO_OVERRIDES)
    eng.render()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        eng.update_scene(S.demo_scene(D, 1), **S.DEMO_OVERRIDES)
        eng.render()
    spans = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("rtvs.")]
    assert TS.span_trees(spans) == [[(s, p, 1 if p is None else None) for s, p in tree]
                                    for tree in (TS.UPDATE_TREE, TS.render_tree(False))]
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert any("render_accum" in n for n in device)
    assert not [n for n in device if n.startswith("rtvs.")]


MESH_ORBIT_PATHS = {"main": ({}, {}),
                    "two_phase": ({"two_phase": True}, {"samples_per_pixel": 1}),
                    "sharded": ({"device_mesh": ["cuda:0"] * 4}, {})}


@pytest.mark.parametrize("path", list(MESH_ORBIT_PATHS))
def test_mesh_orbit_keeps_its_tables_and_equals_a_rebuilding_engine(path):
    """The full-size mesh demo scene orbiting at 1920x1080 for four frames:
    RGBA8, rays and denoiser history bit-equal to an Engine given a new
    BLASCache before each update; one SAH build a mesh, one retransform an
    instance, one combine, one device-table build. A reused update copies
    the analytic leaves to the card in one copy (to_device.copies) and none
    of the mesh tables (the profiler's "Memcpy HtoD" operations, which
    rtbench/metrics/upload_ms.py reads), and the mesh stage runs under
    torch.cuda.set_sync_debug_mode("error"), so it neither uploads nor
    waits on the device."""
    _need_cuda()
    from torch.autograd import DeviceType

    from raytracevs_tpu_torch import BLASCache
    from raytracevs_tpu_torch.scene.flatten import to_device

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as CS

    kw, over = MESH_ORBIT_PATHS[path]
    over = dict(S.DEMO_OVERRIDES, **over)
    kept, fresh = (Engine(1920, 1080, mesh_service=S.mesh_service(PMC, CS.MESH_DEMO), **kw)
                   for _ in range(2))

    def host_to_device(update):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            # device work before the update: late in a run of this file the
            # profiler drops the first device records of a window, which
            # were all of a reused update's (its one copy)
            x = torch.zeros(1, device=kept.device)
            for _ in range(200):
                x += 1
            torch.cuda.synchronize()
            update()
            torch.cuda.synchronize()
        return sum(e.device_type == DeviceType.CUDA and "Memcpy HtoD" in e.name
                   for e in prof.events())

    copies = []
    for f in range(4):
        n = to_device.copies
        copies.append(host_to_device(
            lambda: kept.update_scene(S.mesh_demo_scene(D, f), **over)))
        assert to_device.copies == n + 1
        fresh._blas_cache = BLASCache()
        fresh.update_scene(S.mesh_demo_scene(D, f), **over)
        a, b = kept.render(), fresh.render()
        np.testing.assert_array_equal(a, b)
        assert kept.last_rays == fresh.last_rays > 0
        ha, hb = kept._denoise_state, fresh._denoise_state
        ha, hb = (ha, hb) if isinstance(ha, list) else ([ha], [hb])
        assert all(_same_bits(x.packed, y.packed) for x, y in zip(ha, hb))
    cache = kept._blas_cache
    assert (cache.build_count, cache.retransform_count, cache.combine_count,
            cache.upload_count) == (2, 2, 1, 1)
    assert copies[1:] == [1, 1, 1], copies
    assert copies[0] >= copies[1] + len(B.FINE_FIELDS), copies
    flat = kept._flat
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mesh = cache.device_tables(flat.mesh, kept.device, flat.shadow_absorption_scale)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert mesh is kept._scene_t.mesh and cache.upload_count == 1


def _demo_orbit(engine, frames):
    """Each frame of the demo scene orbiting, as engine.render() returns it."""
    for f in range(frames):
        engine.update_scene(S.demo_scene(D, f), **S.DEMO_OVERRIDES)
        yield engine.render()


def test_pinned_readback_bit_equal_to_pageable(monkeypatch):
    """Six 1080p orbiting frames through runtime/readback.py's pinned
    blocks: each array and ray count equal to the pageable readback of the
    same frame tensors (rgba_t.cpu().numpy(), int(rays_t.item()))."""
    _need_cuda()
    from raytracevs_tpu_torch.runtime import engine as E
    from raytracevs_tpu_torch.runtime import readback as RB

    pageable = []

    def spy(rgba_t, rays_t, stats=None):
        got = RB.read_back(rgba_t, rays_t, stats)
        pageable.append((rgba_t.cpu().numpy(), int(rays_t.item())))
        return got

    monkeypatch.setattr(E, "read_back", spy)
    eng = Engine(1920, 1080)
    for f, img in enumerate(_demo_orbit(eng, 6)):
        want, rays = pageable[f]
        np.testing.assert_array_equal(img, want)
        assert eng.last_rays == rays > 1920 * 1080
    assert eng.readback_stats.pinned == 6


def test_pinned_readback_frames_are_the_callers():
    """Every array of a six-frame 1080p orbit, all kept: each still equals
    the copy taken when it was returned, none shares memory with another,
    and each is a writable, C-contiguous np.uint8 [1080, 1920, 4]."""
    _need_cuda()
    eng = Engine(1920, 1080)
    kept = [(img, img.copy()) for img in _demo_orbit(eng, 6)]
    for img, copy in kept:
        np.testing.assert_array_equal(img, copy)
        assert img.dtype == np.uint8 and img.shape == (1080, 1920, 4)
        assert img.flags.c_contiguous and img.flags.writeable
    frames = [img for img, _ in kept]
    assert not any(np.may_share_memory(a, b)
                   for i, a in enumerate(frames) for b in frames[i + 1:])
    assert eng.readback_stats.pinned == 6


def test_pinned_readback_reuses_its_blocks():
    """A six-frame 1080p orbit whose caller drops each frame at once (the
    Engine keeps the last): six pinned readbacks, and the frames that
    needed a new pinned block stop after the third, as the dropped frames'
    blocks return to the caching host allocator's pool."""
    _need_cuda()
    eng = Engine(1920, 1080)
    counts = []
    for _ in _demo_orbit(eng, 6):
        counts.append(eng.readback_stats.new_blocks)
    assert eng.readback_stats.pinned == 6
    assert counts[2] is not None, "torch.cuda.host_memory_stats has no num_host_alloc"
    assert counts[2] == counts[5] <= 3, counts


def test_render_waits_on_the_device_once(monkeypatch):
    """A 1080p demo frame's render() under torch.cuda.set_sync_debug_mode(
    "error"): nothing in the frame waits on the device but the readback's
    event (which the mode does not flag), while the pageable readback it
    replaced raises under the same mode."""
    _need_cuda()
    from raytracevs_tpu_torch.runtime import engine as E

    eng = Engine(1920, 1080)
    eng.update_scene(S.demo_scene(D, 0), **S.DEMO_OVERRIDES)
    eng.render()
    eng.update_scene(S.demo_scene(D, 1), **S.DEMO_OVERRIDES)  # one non-blocking upload

    def pageable(rgba_t, rays_t, stats=None):
        return rgba_t.cpu().numpy(), int(rays_t.item())

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.render()
        monkeypatch.setattr(E, "read_back", pageable)
        with pytest.raises(RuntimeError, match="synchroniz"):
            eng.render()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eng.readback_stats.pinned == 2


@pytest.mark.parametrize("name", ["demo", "mesh_demo"])
def test_update_scene_waits_on_nothing(name, monkeypatch):
    """Engine.update_scene under torch.cuda.set_sync_debug_mode("error")
    raises nothing: the demo scene's update, and the mesh demo scene's
    second (its mesh tables cached by then). Each update uploads the
    scene's leaves in one copy (to_device.copies), and its frames equal
    those of the same updates uploaded leaf by leaf."""
    _need_cuda()
    from raytracevs_tpu_torch.runtime import engine as E
    from raytracevs_tpu_torch.scene import flatten as F

    build = S.mesh_demo_scene if name == "mesh_demo" else S.demo_scene

    def orbit(check):
        svc = S.mesh_service(PMC, S.MESH_DEMO_SMALL) if name == "mesh_demo" else None
        eng = Engine(480, 270, mesh_service=svc)
        frames = []
        for f in range(3):
            copies = F.to_device.copies
            torch.cuda.synchronize()
            if check and f > 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                eng.update_scene(build(D, f), **S.DEMO_OVERRIDES)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if check:
                assert F.to_device.copies == copies + 1
                assert all(leaf.untyped_storage().data_ptr()
                           == eng._scene_t.cam_pos.untyped_storage().data_ptr()
                           for leaf in eng._scene_t[:-1])
            frames.append((eng.render(), eng.last_rays))
        return frames

    packed = orbit(True)

    def per_leaf(flat, device, blas_cache=None):
        leaves = F.to_device(flat._replace(mesh=None), "cpu")[:-1]
        return F.FlatScene(*(t.to(device) for t in leaves),
                           mesh=F.to_device(flat, device, blas_cache).mesh)

    monkeypatch.setattr(E, "to_device", per_leaf)
    for (a, ra), (b, rb) in zip(packed, orbit(False)):
        np.testing.assert_array_equal(a, b)
        assert ra == rb
