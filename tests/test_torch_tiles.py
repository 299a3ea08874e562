"""Row-sharded rendering in the port (parallel/tiles.py, the sharded denoise
of post/denoise.py, K2's slab form and the per-pass a-trous step) on the
CPU, where a mesh repeats the CPU device: make_mesh(["cpu"] * 4) renders
four row slabs in turns.

Held bit-equal within the port: exchange_row_halo against JAX's under
shard_map (4 of conftest's 8 CPU devices, several hops); the slab form of
the plain temporal_accumulate against the whole frame's rows; render_rows_cf
slabs against the whole frame's rows (analytic, mesh, two-phase);
sharded_photon_map against the whole map; Engine(device_mesh=...) over
three orbiting frames against the single-device Engine (analytic, mesh,
caustics, two-phase), the denoiser history carried per slab. Held against
JAX at its bands: the slab form of temporal_accumulate against the jnp one
(atol 1e-4, test_torch_denoise.py's), the per-pass step and its slab form
(top, interior and bottom slabs, bit-equal to the whole frame's rows)
against _atrous_pass and anti_firefly, and the sharded pipeline against JAX's
render_pipeline_sharded(backend="jnp") on 4 CPU devices (one frame at
32x16, test_torch_engine.py's RGBA band)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _torch_scenes as S
from raytracevs_tpu import Engine as JEngine
from raytracevs_tpu.parallel import tiles as JT
from raytracevs_tpu.post import denoise as JD_
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.ops import photon as PP
from raytracevs_tpu_torch.ops.render_cf import render_rows_cf
from raytracevs_tpu_torch.parallel import tiles as PT
from raytracevs_tpu_torch.post import denoise as PD_
from raytracevs_tpu_torch.scene import data as PD

S.one_torch_thread()

W, H = 64, 32
N = 4
ROWS = H // N
CPU4 = ["cpu"] * N
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _slabs(x, n=N):
    rows = x.shape[1] // n
    return [x[:, i * rows:(i + 1) * rows] for i in range(n)]


@pytest.mark.parametrize("halo", [2, 8, 72])
def test_exchange_row_halo_matches_jax(halo):
    """Halos of 2, 8 and 72 rows on 8-row slabs (72: nine hops, the
    frame's edge rows replicated) equal JAX's ppermute exchange."""
    rng = np.random.default_rng(halo)
    x = rng.uniform(-1, 1, (3, N * 8, 5)).astype(np.float32)
    mesh = JT.make_mesh(jax.devices()[:N])
    fn = shard_map(lambda a: JD_.exchange_row_halo(a, halo, JT.TILE_AXIS, N, axis=1),
                   mesh=mesh, in_specs=(P(None, JT.TILE_AXIS),),
                   out_specs=P(None, JT.TILE_AXIS), check_vma=False)
    want = np.asarray(fn(jnp.asarray(x)))
    got = PD_.exchange_row_halo(_slabs(_t(x)), halo)
    for i, g in enumerate(got):
        assert g.shape == (3, 8 + 2 * halo, 5)
        np.testing.assert_array_equal(g.numpy(), want[:, i * (8 + 2 * halo):(i + 1) * (8 + 2 * halo)])


def _k2_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    state = np.concatenate([rng.uniform(0, 1, (14, h, w)), rng.uniform(0, 10, (1, h, w)),
                            rng.uniform(1, 51, (1, h, w))]).astype(f)
    motion = rng.uniform(-9, 9, (2, h, w)).astype(f)
    mspec = (motion + rng.uniform(-1, 1, (2, h, w))).astype(f)
    vz = (state[15] * rng.choice([1.0, 1.05, 2.0], (h, w))).astype(f)
    return dict(state=state, curr=rng.uniform(0, 2, (8, h, w)).astype(f), motion=motion,
                mspec=mspec, vz=vz, rough=rng.uniform(0, 0.2, (h, w)).astype(f))


def test_temporal_accumulate_slab_form():
    """Each slab's K2 (plain) on the history extended by TEMPORAL_HALO rows
    is bit-equal to the whole frame's rows, and within atol 1e-4 of the
    jnp oracle's slab form (packed_ext, halo, row0, global_h)."""
    h, w = 32, 24
    x = _k2_inputs(h, w, 11)
    whole = PD_.temporal_accumulate(_t(x["state"]), _t(x["curr"]), _t(x["motion"]), _t(x["vz"]),
                                    _t(x["rough"]), _t(x["mspec"]))
    halo = PD_.TEMPORAL_HALO
    ext = PD_.exchange_row_halo(_slabs(_t(x["state"])), halo)
    rows = h // N
    for i in range(N):
        sl = slice(i * rows, (i + 1) * rows)
        got = PD_.temporal_accumulate(ext[i], _t(x["curr"][:, sl]), _t(x["motion"][:, sl]),
                                      _t(x["vz"][sl]), _t(x["rough"][sl]), _t(x["mspec"][:, sl]),
                                      halo, i * rows, h)
        assert torch.equal(got, whole[:, sl])
        p = np.moveaxis(ext[i].numpy(), 0, -1)
        st = JD_.DenoiserState(*(jnp.asarray(a) for a in (
            p[halo:-halo, :, 0:4], p[halo:-halo, :, 4:8], p[halo:-halo, :, 8:11],
            p[halo:-halo, :, 11:14], p[halo:-halo, :, 14], p[halo:-halo, :, 15])))
        acc_d, acc_s, fast_d, fast_s, frames = JD_.temporal_accumulate(
            jnp.asarray(np.moveaxis(x["curr"][0:4, sl], 0, -1)),
            jnp.asarray(np.moveaxis(x["curr"][4:8, sl], 0, -1)),
            jnp.asarray(np.moveaxis(x["motion"][:, sl], 0, -1)), jnp.asarray(x["vz"][sl]), st,
            packed_ext=jnp.asarray(p), halo=halo, row0=i * rows, global_h=h,
            roughness=jnp.asarray(x["rough"][sl]),
            motion_spec=jnp.asarray(np.moveaxis(x["mspec"][:, sl], 0, -1)))
        want = np.concatenate([np.moveaxis(np.asarray(a), -1, 0)
                               for a in (acc_d, acc_s, fast_d, fast_s)]
                              + [np.asarray(frames)[None], x["vz"][None, sl]])
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert (whole[14] == 0).any() and (whole[14] > 0).any()


def _atrous_inputs(stride, h=24, w=40):
    rng = np.random.default_rng(20 + stride)
    img = (rng.uniform(0, 1, (6, h, w)) ** 3 * 4).astype(np.float32)
    vz = rng.uniform(1, 51, (h, w)).astype(np.float32)
    normal = PD_.decode_oct_cf(_t(rng.uniform(0, 1, (4, h, w)).astype(np.float32)))
    guide = rng.uniform(0, 6, (2, h, w)).astype(np.float32)
    return _t(img), _t(vz), normal, _t(guide)


@functools.lru_cache(maxsize=None)
def _jax_single_pass(stride, clamp):
    """JAX's anti_firefly (when asked) and _atrous_pass on _atrous_inputs."""
    img, vz, normal, guide = (a.numpy() for a in _atrous_inputs(stride))
    j_img = jnp.asarray(np.moveaxis(img, 0, -1))
    if clamp:
        j_img = JD_.anti_firefly(j_img)
    want = JD_._atrous_pass(j_img, jnp.asarray(vz), jnp.asarray(np.moveaxis(normal, 0, -1)),
                            stride, guide=jnp.asarray(np.moveaxis(guide, 0, -1)))
    return np.moveaxis(np.asarray(want), -1, 0)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("clamp", [False, True])
def test_atrous_single_pass_matches_jax(stride, clamp):
    """The per-pass step's plain version (anti_firefly when asked, then one
    guided pass) against JAX's anti_firefly and _atrous_pass; the chain of
    three steps, the clamp on the first, is the fused K3's plain version
    bit for bit."""
    img, vz, normal, guide = _atrous_inputs(stride)
    got = PD_.atrous_single_pass(img, vz, normal, guide, stride, clamp)
    np.testing.assert_allclose(got.numpy(), _jax_single_pass(stride, clamp), atol=ATOL)
    chain = img
    for p in range(PD_.ATROUS_PASSES):
        chain = PD_.atrous_single_pass(chain, vz, normal, guide, 1 << p, p == 0)
    assert torch.equal(chain, PD_.atrous(img, vz, normal, guide))


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("slab", [0, 1, 3], ids=["top", "interior", "bottom"])
def test_atrous_pass_slab_matches_whole_frame(slab, stride, clamp):
    """The slab form's plain version on 6-row slabs of the 24-row frame (the
    slab where it lies, its neighbours' rows as views, z, normal and guide
    extended by ATROUS_REACH rows and cut at the frame's edges) equals the
    whole frame's atrous_single_pass rows bit for bit, and JAX's
    anti_firefly and _atrous_pass on the whole frame within ATOL."""
    img, vz, normal, guide = _atrous_inputs(stride)
    h, rows = vz.shape[0], 6
    row0 = slab * rows
    n_above, n_below = PD_.pass_halo(row0, rows, h, stride + int(clamp))
    assert (n_above, n_below) == (min(stride + int(clamp), row0),
                                  min(stride + int(clamp), h - row0 - rows))
    a0 = max(row0 - PD_.ATROUS_REACH, 0)
    a1 = min(row0 + rows + PD_.ATROUS_REACH, h)
    got = PD_.atrous_pass_slab(img[:, row0:row0 + rows], img[:, row0 - n_above:row0],
                               img[:, row0 + rows:row0 + rows + n_below], vz[a0:a1],
                               normal[:, a0:a1], guide[:, a0:a1], row0, h, stride, clamp)
    sl = slice(row0, row0 + rows)
    assert torch.equal(got, PD_.atrous_single_pass(img, vz, normal, guide, stride, clamp)[:, sl])
    np.testing.assert_allclose(got.numpy(), _jax_single_pass(stride, clamp)[:, sl], atol=ATOL)


SCENES = {
    "analytic": (S.demo_scene, S.DEMO_OVERRIDES, False, None),
    "mesh": (S.mesh_demo_scene, S.DEMO_OVERRIDES, False, S.MESH_DEMO_SMALL),
    "caustics": (S.demo_scene, dict(S.DEMO_OVERRIDES, enable_caustics=True), False, None),
    "two_phase": (S.demo_scene, dict(S.DEMO_OVERRIDES, samples_per_pixel=1), True, None),
}
# the mesh scene's plain walks cost the most a pixel: it renders at 32x16,
# 4-row slabs (every denoiser halo then reaches over several slabs)
SIZES = dict.fromkeys(SCENES, (W, H)) | {"mesh": (W // 2, H // 2)}


def _engine(name, mesh):
    build, over, two_phase, meshes = SCENES[name]
    ms = None if meshes is None else S.mesh_service(PMC, meshes)
    return Engine(*SIZES[name], device="cpu", mesh_service=ms, two_phase=two_phase,
                  device_mesh=mesh)


@pytest.fixture(scope="module", params=list(SCENES))
def sharded_frames(request):
    """Three orbiting frames of each scene through the single-device Engine
    and through Engine(device_mesh=["cpu"] * 4); each frame's outputs."""
    name = request.param
    build, over = SCENES[name][:2]
    runs = []
    for mesh in (None, CPU4):
        e = _engine(name, mesh)
        frames = []
        for f in range(3):
            e.update_scene(build(PD, f), **over)
            img = e.render()
            frames.append(dict(img=img, hdr=e._last_hdr_t, rays=e.last_rays,
                               gbuffer=e._last_gbuffer, denoised=e._last_denoised,
                               state=e._denoise_state))
        runs.append((e, frames))
    return name, runs


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_sharded_engine_bit_equal_to_single_device(sharded_frames, frame):
    """Frame by frame: RGBA, HDR, rays, the G-buffer, the denoised planes
    and the history (stitched from its slabs) bit-equal."""
    name, ((one, a), (four, b)) = sharded_frames
    assert one.device_mesh is None and four.device_mesh == [torch.device("cpu")] * N
    x, y = a[frame], b[frame]
    np.testing.assert_array_equal(y["img"], x["img"])
    assert torch.equal(y["hdr"], x["hdr"]) and y["rays"] == x["rays"]
    for p, q in zip(x["gbuffer"], y["gbuffer"]):
        assert (p is None and q is None) or torch.equal(p, q)
    for p, q in zip(x["denoised"], y["denoised"]):
        assert torch.equal(p, q)
    assert len(y["state"]) == N
    w, h = SIZES[name]
    assert all(s.packed.shape == (PD_.STATE_CH, h // N, w) for s in y["state"])
    assert torch.equal(torch.cat([s.packed for s in y["state"]], dim=1), x["state"].packed)
    if frame:
        assert float(x["state"].packed[14].max()) == frame  # history reprojected
    assert x["img"][..., :3].std() > 10


def test_sharded_engine_surface():
    """render_debug_view and validate_frame read the stitched planes: the
    views of a sharded frame equal the single-device Engine's."""
    one, four = (Engine(32, 16, device="cpu", device_mesh=m) for m in (None, CPU4))
    for e in (one, four):
        e.update_scene(S.demo_scene(PD, 0), **S.DEMO_OVERRIDES)
        e.render()
    for mode in (1, 3, 6):
        np.testing.assert_array_equal(four.render_debug_view(mode), one.render_debug_view(mode))
    assert four.validate_frame()["ok"]


@pytest.mark.parametrize("name", ["analytic", "mesh", "two_phase"])
def test_render_rows_cf_slabs_equal_whole_frame_rows(name):
    build, over, two_phase, meshes = SCENES[name]
    e = _engine(name, None)
    e.update_scene(build(PD, 1), **over)
    sc, cfg = e._scene_t, e._cfg
    aperture = float(e._flat.aperture_size)
    whole = render_rows_cf(sc, cfg, two_phase=two_phase, aperture_size=aperture)
    rows = cfg.height // N
    slabs = [render_rows_cf(sc, cfg, i * rows, rows, two_phase, aperture) for i in range(N)]
    assert torch.equal(torch.cat([s.color for s in slabs], 1), whole.color)
    assert torch.equal(torch.cat([s.raw_specular for s in slabs], 1), whole.raw_specular)
    for k, field in enumerate(whole.gbuffer):
        parts = [s.gbuffer[k] for s in slabs]
        assert torch.equal(torch.cat(parts, field.dim() - 2), field), whole.gbuffer._fields[k]
    assert sum(float(s.rays) for s in slabs) == float(whole.rays)
    with pytest.raises(ValueError):
        render_rows_cf(sc, cfg, cfg.height - 4, 8)


def test_sharded_photon_map_equals_whole_map():
    e = _engine("caustics", None)
    e.update_scene(S.demo_scene(PD, 0), **SCENES["caustics"][1])
    sc, n = e._scene_t, e._cfg.num_photons
    assert n % N == 0
    whole = PP.emit_and_trace(sc, n)
    maps = PP.sharded_photon_map([sc] * N, n)
    assert len(maps) == N and all(m is maps[0] for m in maps)
    for a, b in zip(maps[0], whole):
        assert torch.equal(a, b)
    assert int(whole.count) > 0
    assert PP.sharded_photon_map([sc] * 3, n + 1) is None  # no even split
    assert PP.sharded_photon_map([sc] * N, 0) is None


def test_render_pipeline_sharded_contract():
    """The return contract, want_aux=False, and the ValueError for a
    height the mesh does not divide."""
    e = _engine("analytic", None)
    e.update_scene(S.demo_scene(PD, 0), **S.DEMO_OVERRIDES)
    sc, cfg = e._scene_t, e._cfg
    state = [PD_.init_state_cf(ROWS, W, "cpu") for _ in range(N)]
    rgba, hdr, rays, gb, new_state, den = PT.render_pipeline_sharded(sc, cfg, CPU4, state)
    assert rgba.shape == (H, W, 4) and rgba.dtype == torch.uint8
    assert hdr.shape == (H, W, 3) and rays.shape == (N,) and gb.view_z.shape == (H, W)
    assert [d.shape for d in den] == [(3, H, W), (3, H, W), (2, H, W)]
    assert len(new_state) == N
    lean = PT.render_pipeline_sharded(sc, cfg, CPU4, new_state, want_aux=False)
    assert lean[1] is None and lean[3] is None and lean[5] is None and len(lean[4]) == N
    frame, slab_rays = PT.render_frame_sharded(sc, cfg, CPU4)
    assert torch.equal(frame.color.permute(1, 2, 0), hdr) and torch.equal(slab_rays, rays)
    with pytest.raises(ValueError, match="not divisible"):
        PT.render_pipeline_sharded(sc, cfg, ["cpu"] * 3, state)
    with pytest.raises(ValueError, match="not divisible"):
        PT.render_frame_sharded(sc, cfg, ["cpu"] * 5)


def test_device_mesh_auto_and_make_mesh():
    assert Engine(W, H, device="cpu").device_mesh is None  # "auto" on the CPU
    assert Engine(W, H, device="cpu", device_mesh=None).device_mesh is None
    assert PT.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PT.make_mesh()
    e = Engine(W, 30, device="cpu", device_mesh=CPU4)
    e.update_scene(S.demo_scene(PD, 0), **S.DEMO_OVERRIDES)
    with pytest.raises(ValueError, match="not divisible"):
        e.render()


def test_sharded_engine_matches_jax_sharded():
    """One 32x16 frame of the demo scene: the port's Engine over four CPU
    slabs against the JAX Engine over 4 CPU devices (render_pipeline_sharded,
    backend "jnp"): rays equal, RGBA |d| <= 1 on >= 99.5% of pixels and
    <= 4 on >= 99%, HDR within 2e-4 on >= 99.5%."""
    w, h = 32, 16
    je = JEngine(w, h, backend="jnp", device_mesh=JT.make_mesh(jax.devices()[:N]))
    pe = Engine(w, h, device="cpu", device_mesh=CPU4)
    je.update_scene(S.demo_scene(JD, 0), **S.DEMO_OVERRIDES)
    pe.update_scene(S.demo_scene(PD, 0), **S.DEMO_OVERRIDES)
    jimg, pimg = je.render(), pe.render()
    assert pimg.shape == jimg.shape == (h, w, 4)
    assert pe.last_rays == je.last_rays
    d = np.abs(pimg.astype(np.int16) - jimg.astype(np.int16)).max(axis=-1)
    assert (d <= 1).mean() >= 0.995 and (d <= 4).mean() >= 0.99, (d.max(), (d > 1).sum())
    hd = np.abs(pe.last_hdr - je.last_hdr).max(axis=-1)
    assert (hd <= 2e-4).mean() >= 0.995, hd.max()
