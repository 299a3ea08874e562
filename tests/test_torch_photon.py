"""The port's photon pass (raytracevs_tpu_torch/ops/photon.py: budget,
emission, the plain bounce loop of K5, the hash build, the plain gather of
K6 and the caustic delta) vs raytracevs_tpu/ops/photon.py on the CPU, on
the same inputs.

Bands: budgets, the hash build and the integer/boolean fields exact;
emission floats within 1e-6 relative; the bounce loop against
`_trace_photons_jnp` run op by op (jax.disable_jit, ROADMAP C5): fates
equal on >= 99.5% of photons, store fields within the bands of
tests/test_megakernel.py:190-197; the gather on one bridged map atol 1e-6,
rtol 1e-5; against the Pallas gather, whose documented deviations (corner
cells, slot collisions, cap order) the port does not share, the band of
tests/test_megakernel.py:123-125."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu.io import mesh_cache as JMC
from raytracevs_tpu.ops import photon as JP
from raytracevs_tpu.ops import render as JR
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu.scene.flatten import flatten_scene as j_flatten
from raytracevs_tpu.scene.flatten import make_config as j_make_config
from raytracevs_tpu.scene.sanitize import sanitize_scene as j_sanitize
from raytracevs_tpu_torch.bridge import flat_from_numpy, photon_map_from_numpy
from raytracevs_tpu_torch.ops import photon as PP
from raytracevs_tpu_torch.ops import render as PR
from raytracevs_tpu_torch.ops.cuda import photon_kernels
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

S.one_torch_thread()

# the trace's bands (tests/test_megakernel.py:190-197): pos, dir, colour,
# power atol, all rtol 1e-3
TRACE_ATOL = (5e-3, 1e-4, 1e-5, 1e-4)


def _scene(D, name):
    if name == "demo":
        return S.demo_scene(D)
    if name == "mesh_demo":
        return S.mesh_demo_scene(D)
    return S.golden_scene(D, name)[0]


def _flat_pair(name):
    """(JAX FlatScene, the port's FlatScene on the CPU from its leaves)."""
    ms = S.mesh_service(JMC, S.MESH_DEMO_SMALL) if name == "mesh_demo" else None
    jf = j_flatten(j_sanitize(_scene(JD, name)), aspect=2.0, mesh_service=ms)
    return jf, to_device(flat_from_numpy(S.jax_leaves(jf)), "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["demo", "mesh_demo", "config5_caustics_denoise",
                                  "config1_hard_shadows", "config2_obb_mirror"])
def test_photon_budget_matches_jax(name):
    """Point + directional lights cap the demo at 16,384; config 5 (one
    point light) at 8,192; config 2 (one directional light, a metal box)
    at 32,768; no specular object (config 1) gives 0."""
    want = JP.photon_budget(j_sanitize(_scene(JD, name)))
    ps = sanitize_scene(_scene(PD, name))
    assert PP.photon_budget(ps) == want
    assert make_config(ps, 8, 8, enable_caustics=True).num_photons == want
    assert want == {"demo": 16384, "mesh_demo": 16384, "config5_caustics_denoise": 8192,
                    "config1_hard_shadows": 0, "config2_obb_mirror": 32768}[name]


@pytest.mark.parametrize("name", ["demo", "config2_obb_mirror"])
def test_emission_matches_jax(name):
    """Point (demo) and directional (both) emission; a slice equals the
    same rows of the whole batch."""
    jf, pf = _flat_pair(name)
    n = 8192
    want = [np.asarray(a) for a in JP._emit_photons(jf, n)]
    got = [a.numpy() for a in PP._emit_photons(pf, n)]
    np.testing.assert_array_equal(got[4], want[4])
    assert got[4].any()
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    part = [a.numpy() for a in PP._emit_photons(pf, n, offset=4096, count=1024)]
    for g, full in zip(part, got):
        np.testing.assert_array_equal(g, full[4096:5120])


def _emission(jf, n):
    return [np.asarray(a) for a in JP._emit_photons(jf, n)]


def _assert_trace_close(got, want):
    same = got[4] == want[4]
    assert same.mean() >= 0.995, f"fates differ on {(~same).mean():.4f}"
    both = got[4] & want[4]
    for c, atol in enumerate(TRACE_ATOL):
        np.testing.assert_allclose(got[c][both], want[c][both], atol=atol, rtol=1e-3,
                                   err_msg=f"store field {c}")


@pytest.mark.parametrize("name,n", [("demo", 16384), ("config5_caustics_denoise", 8192),
                                    ("mesh_demo", 4096)])
def test_trace_matches_jax_op_by_op(name, n):
    """The plain bounce loop against _trace_photons_jnp run one operation at
    a time, on the same numpy emission; meshes are not traced by either."""
    jf, pf = _flat_pair(name)
    em = _emission(jf, n)
    with jax.disable_jit():
        want = [np.asarray(a) for a in JP._trace_photons_jnp(
            jf._replace(mesh=None), *[jnp.asarray(a) for a in em])]
    got = [a.numpy() for a in PP._trace_photons(pf, *[_t(a) for a in em],
                                                torch.arange(n, dtype=torch.int32))]
    assert want[4].sum() > 10  # the scene stores caustic photons
    _assert_trace_close(got, want)


def test_trace_matches_pallas_interpret():
    """The plain bounce loop against the Pallas tile kernel (interpret mode)
    at 4,096 photons on a scene with a glass sphere and a metal box."""
    from raytracevs_tpu.ops.pallas.photon_trace import trace_photons_pallas

    jf, pf = _flat_pair("config5_caustics_denoise")
    n = 4096
    em = _emission(jf, n)
    want = [np.asarray(a) for a in trace_photons_pallas(
        jf, *[jnp.asarray(a) for a in em], interpret=True)]
    got = [a.numpy() for a in PP._trace_photons(pf, *[_t(a) for a in em],
                                                torch.arange(n, dtype=torch.int32))]
    assert want[4].sum() > 10
    _assert_trace_close(got, want)


def test_emit_and_trace_on_the_cpu_runs_the_plain_versions():
    """emit_and_trace through the K5 wrapper on CPU tensors: the plain
    emission and loop, no launch; a mesh scene traces its analytic
    primitives only."""
    before = photon_kernels.emit_and_trace.launches
    _, pf = _flat_pair("mesh_demo")
    pm = PP.emit_and_trace(pf, 2048)
    assert photon_kernels.emit_and_trace.launches == before
    ref = PP.build_photon_hash(*PP._trace_photons(
        pf._replace(mesh=None), *PP._emit_photons(pf, 2048), torch.arange(2048, dtype=torch.int32)))
    for a, b in zip(pm, ref):
        assert torch.equal(a, b)


def test_build_photon_hash_matches_jax():
    """Identical store arrays give identical maps: sorted arrays (stable
    order within a cell), cell ranges and the count."""
    jf, _ = _flat_pair("config5_caustics_denoise")
    n = 65536
    stores = [np.asarray(a) for a in jax.jit(JP._trace_photons_jnp)(
        jf, *[jnp.asarray(a) for a in _emission(jf, n)])]
    want = JP.build_photon_hash(*[jnp.asarray(a) for a in stores])
    got = PP.build_photon_hash(*[_t(a) for a in stores])
    assert int(want.count) > 100
    for f in JP.PhotonMap._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.fixture(scope="module")
def focus_map():
    """A JAX photon map of golden config 5's glass sphere focusing a point
    light onto the floor, with 8x the budget so the 32-photon cap binds."""
    jf, _ = _flat_pair("config5_caustics_denoise")
    return JP.emit_and_trace(jf, 65536)


def _receivers(pm):
    """Floor points: a grid over the caustic, the densest photons
    themselves, and points on cell corners and edges (integer coordinates:
    the cell of a receiver changes there)."""
    pos = np.asarray(pm.position)[np.asarray(pm.valid)]
    xs = np.linspace(-1.5, 1.5, 40, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs)
    grid = np.stack([gx.ravel(), np.zeros(gx.size, np.float32), gz.ravel()], -1)
    ci = np.arange(-2, 3, dtype=np.float32)
    cx, cz = np.meshgrid(ci, ci)
    corners = np.stack([cx.ravel(), np.zeros(cx.size, np.float32), cz.ravel()], -1)
    edges = corners + np.array([0.5, 0.0, 0.0], np.float32)
    recv = np.concatenate([grid, pos[:200], corners, edges]).astype(np.float32)
    nrm = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (recv.shape[0], 1))
    return recv, nrm


def test_gather_matches_jax(focus_map):
    recv, nrm = _receivers(focus_map)
    want = np.asarray(JP.gather(focus_map, jnp.asarray(recv), jnp.asarray(nrm)))
    got = PP.gather(photon_map_from_numpy(focus_map), _t(recv), _t(nrm)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    assert (want.max(-1) > 0).mean() > 0.2
    # the cap binds: a receiver at the focus finds more than 32 photons
    # within the radius
    pos = np.asarray(focus_map.position)[np.asarray(focus_map.valid)]
    within = (((pos[None, :200] - pos[:200, None]) ** 2).sum(-1) < 0.25).sum(-1)
    assert within.max() > 64


@pytest.mark.parametrize("offset,count", [(0, 4096), (1024, 2048)])
def test_k5_entry_on_the_cpu_matches_jax_slice(offset, count):
    """The K5 wrapper (emission and bounce loop in one entry) on CPU
    tensors runs the plain pair and launches nothing: photons [offset,
    offset+count) of a 4,096-photon batch against JAX trace_photon_slice
    (jnp, run op by op, ROADMAP C5) in the trace's bands, and a slice
    equals the same rows of the whole batch bit for bit."""
    jf, pf = _flat_pair("config5_caustics_denoise")
    n = 4096
    with jax.disable_jit():
        want = [np.asarray(a) for a in JP.trace_photon_slice(jf, n, offset, count)]
    before = (photon_kernels.emit_and_trace.launches, PP._emit_photons.launches)
    got = [a.numpy() for a in photon_kernels.emit_and_trace(pf, n, offset, count)]
    assert photon_kernels.emit_and_trace.launches == before[0]
    assert PP._emit_photons.launches == before[1] + 1  # the plain emission ran
    assert want[4].any()  # the slice stores caustic photons
    _assert_trace_close(got, want)
    whole = [a.numpy() for a in PP.trace_photon_slice(pf, n, 0, n)]
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g, w[offset:offset + count])


def _caustic_planes(focus_map, lit_planes=True):
    """(accumulator planes of receivers on the focus map's floor: 80% hit,
    a fifth of them metal and a fifth glass; the other planes random, and
    colour and diffuse too when lit_planes, else zero), the JAX delta
    [N,3] and its eligibility mask, spp."""
    recv, nrm = _receivers(focus_map)
    h, w = 16, recv.shape[0] // 16
    n = h * w
    recv, nrm = recv[:n], nrm[:n]
    rng = np.random.default_rng(5)
    hit = rng.random(n) < 0.8
    metal = np.where(rng.random(n) < 0.2, 1.0, 0.0).astype(np.float32)
    trans = np.where(rng.random(n) < 0.2, 0.9, 0.0).astype(np.float32)
    spp = 2
    cfg = j_make_config(j_sanitize(_scene(JD, "demo")), w, h, samples_per_pixel=spp)
    want, mask = JR.caustics_delta(None, cfg, focus_map, jnp.asarray(hit), jnp.asarray(recv),
                                   jnp.asarray(nrm), jnp.asarray(metal), jnp.asarray(trans))
    acc = _t(rng.random((PR.NUM_CH, h, w), dtype=np.float32))
    acc[PR.CH_PRIM_HIT] = _t(hit.astype(np.float32)).reshape(h, w)
    acc[PR.CH_METALLIC] = _t(metal).reshape(h, w)
    acc[PR.CH_TRANSMISSION] = _t(trans).reshape(h, w)
    acc[PR.CH_POS:PR.CH_POS + 3] = _t(recv.T).reshape(3, h, w)
    acc[PR.CH_NORMAL:PR.CH_NORMAL + 3] = _t(nrm.T).reshape(3, h, w)
    if not lit_planes:
        acc[PR.CH_COLOR:PR.CH_COLOR + 3] = 0.0
        acc[PR.CH_DIFFUSE:PR.CH_DIFFUSE + 3] = 0.0
    return acc, np.asarray(want), np.asarray(mask), spp


def _assert_caustic_added(got, before, want, mask):
    """got: the planes after the in-place add; before: a copy of them
    taken before it. Colour and diffuse equal JAX's plane + delta (JAX
    adds the delta's +0.0 at every unlit pixel, which could differ from
    an unwritten plane only in the sign of a zero, and array_equal and
    allclose count -0.0 and +0.0 as equal); every other plane keeps its
    bits; a pixel that is not eligible keeps its colour."""
    h, w = got.shape[1:]
    for ch in (PR.CH_COLOR, PR.CH_DIFFUSE):
        plane = before[ch:ch + 3].reshape(3, -1).T.numpy()
        np.testing.assert_allclose(got[ch:ch + 3].reshape(3, -1).T.numpy(), plane + want,
                                   atol=1e-6, rtol=1e-5)
    others = [c for c in range(PR.NUM_CH) if not (PR.CH_COLOR <= c < PR.CH_COLOR + 3
                                                  or PR.CH_DIFFUSE <= c < PR.CH_DIFFUSE + 3)]
    assert torch.equal(got[others].view(torch.int32), before[others].view(torch.int32))
    changed = (got[PR.CH_COLOR:PR.CH_COLOR + 3] != before[PR.CH_COLOR:PR.CH_COLOR + 3])
    changed = changed.any(0).reshape(-1).numpy()
    assert not changed[~mask].any() and changed[mask].any()


def test_caustics_delta_matches_jax(focus_map):
    """The delta through the K6 wrapper on CPU tensors (the plain in-place
    add, no launch) into zero colour and diffuse planes, so that the planes
    after it hold the delta itself: eligible pixels (a diffuse primary
    hit) get JAX's delta, the gather times spp, at JAX's tolerance;
    nothing else changes (_assert_caustic_added)."""
    acc, want, mask, spp = _caustic_planes(focus_map, lit_planes=False)
    before = acc.clone()
    launches = photon_kernels.add_caustics.launches
    got = photon_kernels.add_caustics(photon_map_from_numpy(focus_map), acc, spp)
    assert got is acc and photon_kernels.add_caustics.launches == launches
    _assert_caustic_added(acc, before, want, mask)


def test_k6_wrapper_adds_into_lit_planes_in_place(focus_map):
    """The K6 wrapper on CPU tensors into random colour and diffuse planes,
    as a frame's are: each eligible pixel's planes gain JAX's delta, every
    other plane and pixel keeps its bits (_assert_caustic_added)."""
    acc, want, mask, spp = _caustic_planes(focus_map)
    before = acc.clone()
    launches = photon_kernels.add_caustics.launches
    got = photon_kernels.add_caustics(photon_map_from_numpy(focus_map), acc, spp)
    assert got is acc and photon_kernels.add_caustics.launches == launches
    _assert_caustic_added(acc, before, want, mask)


def test_apply_caustics_cf_adds_into_the_planes_as_jax(focus_map, monkeypatch):
    """apply_caustics_cf on the CPU with the focus map as the frame's map:
    the caustic goes into the frame's own planes (no delta planes, no
    fold-in after it), equal to JAX's colour + delta."""
    from raytracevs_tpu_torch.ops.render_cf import apply_caustics_cf

    acc, want, mask, spp = _caustic_planes(focus_map)
    before = acc.clone()
    pmap = photon_map_from_numpy(focus_map)
    monkeypatch.setattr(PP, "emit_and_trace", lambda *a, **k: pmap)
    cfg = make_config(sanitize_scene(_scene(PD, "demo")), acc.shape[2], acc.shape[1],
                      samples_per_pixel=spp, enable_caustics=True)
    assert cfg.num_photons > 0
    assert apply_caustics_cf(None, cfg, acc) is acc
    _assert_caustic_added(acc, before, want, mask)


def test_gather_vs_pallas_interpret():
    """The plain gather against gather_pallas (interpret) on the 128x32
    receiver grid of tests/test_megakernel.py::test_pallas_photon_gather_
    matches_jnp, in its band."""
    from raytracevs_tpu.ops.pallas import photon_gather

    jf, _ = _flat_pair("config5_caustics_denoise")
    pm = JP.emit_and_trace(jf, 8192)
    h, w = 32, 128
    xs = np.linspace(-3, 3, w, dtype=np.float32)
    zs = np.linspace(-2, 4, h, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs)
    pos = np.stack([gx.ravel(), np.zeros(h * w, np.float32), gz.ravel()], -1)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (h * w, 1))
    pal = np.asarray(photon_gather.gather_pallas(pm, jnp.asarray(pos), jnp.asarray(nrm),
                                                 jnp.ones((h * w,), bool), h, w, interpret=True))
    got = PP.gather(photon_map_from_numpy(pm), _t(pos), _t(nrm)).numpy()
    assert got.mean() > 0
    assert abs(pal.mean() - got.mean()) / max(got.mean(), 1e-6) < 0.05
    rel = np.abs(got - pal).max(-1) / np.maximum(got.max(-1), 1e-3)
    assert (rel > 0.05).mean() < 0.02


def test_photon_map_from_numpy_keeps_leaves(focus_map):
    pm = photon_map_from_numpy(focus_map)
    assert pm._fields == JP.PhotonMap._fields
    for f in pm._fields:
        np.testing.assert_array_equal(getattr(pm, f).numpy(), np.asarray(getattr(focus_map, f)))
