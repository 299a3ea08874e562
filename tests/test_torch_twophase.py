"""The port's two-phase renderer (ops/twophase.py: phase A, the coherence
sort, phase B) on the CPU, where it runs the plain versions of kernels K7
and K8, at spp 1 on the demo scene (48x27, the first frame of the Engine
comparison below, whose JAX frame is render_rows(backend="jnp")'s), and at
32x32 on golden config 3 (glass, soft shadows), the mesh glass ball and
nine mesh instances.

Held against:
- the port's plain K1 (ops/render.py::render_accum): per-pixel rays and
  bounce counts, the primary plane and every record plane equal bit for
  bit; the colour within 2e-5 * max(1, |K1|), because phase A's term plus
  phase B's sum is K1's running sum added in another order;
- the JAX package's jnp path (render_rows(backend="jnp")), the plain
  reference of its "pallas2" backend, at tests/test_torch_megakernel.py's
  bands: regrouping does not change a pixel's ray tree;
- JAX's _coherence_key, bit for bit;
- itself over a shuffled lane order (per-pixel state is lane-local);
- the JAX Engine (backend "jnp") through Engine(two_phase=True), at
  tests/test_torch_engine.py's bands;
- nightly: JAX's render_accum_pallas_twophase in interpret mode, at
  tests/test_twophase.py's bands.
The kernels themselves are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu import Engine as JEngine
from raytracevs_tpu.io import mesh_cache as JMC
from raytracevs_tpu.ops.pallas import megakernel as JMK
from raytracevs_tpu.ops.render import render_rows as j_render_rows
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu.scene.flatten import flatten_scene as j_flatten
from raytracevs_tpu.scene.flatten import make_config as j_make_config
from raytracevs_tpu.scene.sanitize import sanitize_scene as j_sanitize
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.ops import render as R
from raytracevs_tpu_torch.ops import twophase as TP
from raytracevs_tpu_torch.ops.cuda import megakernel as MK
from raytracevs_tpu_torch.ops.render_cf import render_rows_cf
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import flatten_scene, make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

S.one_torch_thread()

W = H = 32
NAMES = ("demo", "config3_glass_soft", "glass_ball", "nine_balls")
GBUF_FIELDS = ("diffuse_hitdist", "specular_hitdist", "normal_roughness", "motion", "albedo",
               "shadow_data", "shadow_translucency", "motion_spec")
# the planes K1 and the two phases must agree on bit for bit: primary
# colour, the records, and (with rays and bounce) everything but the colour
RECORD_PLANES = list(range(R.CH_PRIMARY, R.CH_HITDIST + 1)) + list(range(R.CH_PRIM_HIT, R.NUM_CH))
_CACHE = {}


def _scene(D, MC, name):
    """(SceneData, config overrides at spp 1, mesh service or None)."""
    if name == "glass_ball":
        return (S.glass_ball_scene(D), {"max_soft_samples": 2, "samples_per_pixel": 1},
                S.mesh_service(MC, {"GlassBall": (9, 9, 0.7)}))
    if name == "nine_balls":
        return S.nine_ball_scene(D), {"samples_per_pixel": 1}, S.mesh_service(MC, {"Ball": (6, 8, 0.3)})
    scene, over = S.scene_and_overrides(D, name)
    return scene, dict(over, samples_per_pixel=1), None


def _setup(name, w=W, h=H):
    """(JAX flat, JAX config, port flat on the CPU, port config)."""
    js, jo, jms = _scene(JD, JMC, name)
    ps, po, pms = _scene(PD, PMC, name)
    jf = j_flatten(j_sanitize(js), aspect=w / h, frame_index=3, mesh_service=jms)
    pf = flatten_scene(sanitize_scene(ps), aspect=w / h, frame_index=3, mesh_service=pms)
    return jf, j_make_config(js, w, h, **jo), to_device(pf, "cpu"), make_config(ps, w, h, **po)


def _renders(name):
    """K1, the two phases and render_rows_cf of the port on the CPU, and the
    JAX jnp frame (lane form: color [N,3], rays, gbuffer) of one scene. The
    demo scene's JAX frame is the JAX Engine's first (_engine_frames), whose
    jitted pipeline runs render_rows(backend="jnp"): one compile of the
    demo scene's program, not two."""
    if name not in _CACHE:
        if name == "demo":
            e = _engine_frames()[0]
            pf, pc, aperture = e["scene"], e["cfg"], e["aperture"]
            jout = e["jout"]
        else:
            jf, jc, pf, pc = _setup(name)
            assert jc.samples_per_pixel == 1
            aperture = float(pf.aperture_size)
            jout = j_render_rows(jf, jc, jnp.int32(0), H, backend="jnp")
            jax.block_until_ready(jout.color)
        assert pc.samples_per_pixel == 1
        _CACHE[name] = dict(
            k1=R.render_accum(pf, pc), two=TP.render_accum_two_phase(pf, pc, aperture),
            jout=jout, pout=render_rows_cf(pf, pc, two_phase=True, aperture_size=aperture),
            scene=pf, cfg=pc)
    return _CACHE[name]


def _lanes(a):
    """[c,H,W] or [H,W] tensor -> [N,c] / [N] numpy (the JAX lane layout)."""
    if a.dim() == 2:
        return a.reshape(-1).numpy()
    return a.permute(1, 2, 0).reshape(-1, a.shape[0]).numpy()


def _key_inputs(case):
    """4,096 seeded continuations: ~30% invalid, ~10% of the direction
    components exactly 0 (some -0.0); "flat": every origin on one plane;
    "none": no valid lane."""
    rng = np.random.default_rng({"random": 1, "flat": 2, "none": 3}[case])
    n = 4096
    valid = rng.random(n) >= 0.3
    o = rng.uniform(-6.0, 6.0, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[rng.random((3, n)) < 0.1] = 0.0
    d[:, :16] = -0.0
    if case == "flat":
        o[1] = np.float32(0.75)
    if case == "none":
        valid[:] = False
    return valid, o, d


@pytest.mark.parametrize("case", ["random", "flat", "none"])
def test_coherence_key_matches_jax(case):
    assert "RTVS_TP_KEY" not in os.environ and JMK._TP_KEY_ORDER == "oct_pos"
    valid, o, d = _key_inputs(case)
    want = np.asarray(JMK._coherence_key(jnp.asarray(valid), tuple(jnp.asarray(o)),
                                         tuple(jnp.asarray(d))))
    got = TP.coherence_key(torch.from_numpy(valid), torch.from_numpy(o), torch.from_numpy(d))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[~valid] == TP.KEY_INVALID).all() and (want[valid] < 1 << 24).all()
    if case == "random":
        assert len(np.unique(want[valid] >> 21)) == 8  # every octant occurs


@pytest.mark.parametrize("name", NAMES)
def test_two_phase_plain_matches_k1_plain(name):
    r = _renders(name)
    k1, two = r["k1"], r["two"]
    assert two.shape == (R.NUM_CH, r["cfg"].height, r["cfg"].width)
    assert torch.equal(two[R.CH_RAYS], k1[R.CH_RAYS])
    assert torch.equal(two[R.CH_BOUNCE], k1[R.CH_BOUNCE])
    assert torch.equal(two[RECORD_PLANES], k1[RECORD_PLANES])
    c1, c2 = k1[R.CH_COLOR:R.CH_COLOR + 3], two[R.CH_COLOR:R.CH_COLOR + 3]
    assert bool(((c2 - c1).abs() <= 2e-5 * c1.abs().clamp(min=1.0)).all()), \
        float((c2 - c1).abs().max())
    # phase B resumed pixels and traced rays beyond phase A's
    a = R.render_accum_phase_a(r["scene"], r["cfg"])
    assert int(a[R.CH_SPAWN_VALID].sum()) > 20
    assert float(two[R.CH_RAYS].sum()) > float(a[R.CH_RAYS].sum())


@pytest.mark.parametrize("name", NAMES)
def test_two_phase_ray_count_and_obj_id_match_jax(name):
    r = _renders(name)
    jout, pout = r["jout"], r["pout"]
    assert int(pout.rays) == int(jout.rays)
    np.testing.assert_array_equal(_lanes(pout.gbuffer.obj_id), np.asarray(jout.gbuffer.obj_id))


@pytest.mark.parametrize("name", NAMES)
def test_two_phase_hdr_color_matches_jax(name):
    r = _renders(name)
    d = np.abs(_lanes(r["pout"].color) - np.asarray(r["jout"].color)).max(axis=-1)
    assert (d <= 2e-4).mean() >= 0.99, (d.max(), (d > 2e-4).mean())
    assert np.isfinite(_lanes(r["pout"].color)).all()


@pytest.mark.parametrize("name", NAMES)
def test_two_phase_gbuffer_matches_jax(name):
    jout, pout = _renders(name)["jout"], _renders(name)["pout"]
    for f in GBUF_FIELDS:
        got = _lanes(getattr(pout.gbuffer, f))
        want = np.asarray(getattr(jout.gbuffer, f))
        if f in ("diffuse_hitdist", "specular_hitdist"):
            # the radiance channels are shares of the HDR colour: its band
            d = np.abs(got[:, :3] - want[:, :3]).max(axis=-1)
            assert (d <= 2e-4).mean() >= 0.99, (f, d.max())
            got, want = got[:, 3], want[:, 3]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(_lanes(pout.gbuffer.view_z), np.asarray(jout.gbuffer.view_z),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ["demo", "glass_ball"])
def test_phase_b_lane_order_does_not_matter(name):
    """Phase B over a seeded shuffle of the resumed pixels gives the same
    planes, bit for bit, as over the coherence-sorted order."""
    r = _renders(name)
    sc, cfg = r["scene"], r["cfg"]
    a = R.render_accum_phase_a(sc, cfg)
    order, count = TP.coherence_order(a)
    valid = order[:int(count)]
    assert torch.equal(torch.sort(valid).values,
                       torch.nonzero(a[R.CH_SPAWN_VALID].reshape(-1) > 0.5)[:, 0].to(torch.int32))
    perm = torch.from_numpy(np.random.default_rng(7).permutation(valid.numel()))
    acc, hits = a[:R.NUM_CH], a[R.CH_HIT:]
    sorted_b = R.render_accum_phase_b(sc, cfg, valid, acc.clone(), hits)
    shuffled_b = R.render_accum_phase_b(sc, cfg, valid[perm], acc.clone(), hits)
    assert torch.equal(sorted_b, shuffled_b)
    assert torch.equal(sorted_b, r["two"])


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    """On CPU tensors render_phase_a and render_phase_b run the plain
    versions and count no launch."""
    r = _renders("demo")
    sc, cfg = r["scene"], r["cfg"]
    before = (MK.render_phase_a.launches, MK.render_phase_b.launches)
    a = MK.render_phase_a(sc, cfg)
    assert a.shape == (R.NUM_CH_A, cfg.height, cfg.width)
    order, count = TP.coherence_order(a)
    assert order.dtype == count.dtype == torch.int32 and count.shape == (1,)
    acc = MK.render_phase_b(sc, cfg, order, count, a[:R.NUM_CH], a[R.CH_HIT:])
    assert torch.equal(acc, r["two"])
    assert (MK.render_phase_a.launches, MK.render_phase_b.launches) == before


def test_two_phase_rejects_spp_and_aperture():
    r = _renders("config3_glass_soft")
    sc, cfg = r["scene"], r["cfg"]
    with pytest.raises(ValueError, match="samples_per_pixel"):
        TP.render_accum_two_phase(sc, cfg._replace(samples_per_pixel=2), 0.0)
    with pytest.raises(ValueError, match="aperture"):
        TP.render_accum_two_phase(sc, cfg, 0.1)
    with pytest.raises(ValueError, match="aperture"):
        render_rows_cf(sc, cfg, two_phase=True)  # no host aperture given
    with pytest.raises(ValueError, match="samples_per_pixel"):
        R.render_accum_phase_a(sc, cfg._replace(samples_per_pixel=2))


EW, EH = 48, 27


def _engine_frames():
    """Two orbiting frames of the demo scene at spp 1 through the port's
    Engine(two_phase=True) on the CPU and the JAX Engine (backend "jnp"),
    computed once. Each frame also keeps the port's device scene and
    configuration and the JAX frame's lane outputs (HDR colour, rays,
    G-buffer) as they were for that frame."""
    if "engine" not in _CACHE:
        over = dict(S.DEMO_OVERRIDES, samples_per_pixel=1)
        je = JEngine(EW, EH, backend="jnp", device_mesh=None)
        pe = Engine(EW, EH, device="cpu", two_phase=True)
        out = []
        for f in range(2):
            pe.update_scene(S.demo_scene(PD, f), **over)
            je.update_scene(S.demo_scene(JD, f), **over)
            fr = dict(scene=pe._scene_t, cfg=pe._cfg, aperture=float(pe._flat.aperture_size),
                      pimg=pe.render(), jimg=je.render(), prays=pe.last_rays,
                      jrays=je.last_rays, phdr=pe.last_hdr, jhdr=je.last_hdr)
            fr["jout"] = SimpleNamespace(color=fr["jhdr"].reshape(-1, 3), rays=je.last_rays,
                                         gbuffer=je._last_gbuffer)
            out.append(fr)
        _CACHE["engine"] = out
    return _CACHE["engine"]


@pytest.mark.parametrize("frame", [0, 1])
def test_two_phase_engine_frames_match_jax(frame):
    """tests/test_torch_engine.py's band: RGBA |d| <= 1 on >= 99.5% of the
    pixels, <= 4 except within 8 px of an HDR outlier (|d| > 2e-4), on at
    most 1% of the frame; the ray counts equal."""
    fr = _engine_frames()[frame]
    pimg, jimg = fr["pimg"], fr["jimg"]
    assert pimg.shape == (EH, EW, 4) and pimg.dtype == np.uint8
    assert fr["prays"] == fr["jrays"]
    d = np.abs(pimg.astype(np.int16) - jimg.astype(np.int16)).max(axis=-1)
    assert (d <= 1).mean() >= 0.995, (d.max(), (d > 1).mean())
    outliers = np.argwhere(np.abs(fr["phdr"] - fr["jhdr"]).max(axis=-1) > 2e-4)
    assert len(outliers) <= 0.005 * EW * EH
    assert (d > 4).mean() <= 0.01
    for y, x in np.argwhere(d > 4):
        assert any(abs(y - oy) <= 8 and abs(x - ox) <= 8 for oy, ox in outliers), (y, x, d[y, x])
    assert (pimg[..., 3] == 255).all() and pimg[..., :3].std() > 10


def test_two_phase_engine_update_scene_rejects_spp_and_aperture():
    """update_scene raises ValueError for spp 2 and for a lens aperture,
    and leaves the Engine as it was."""
    e = Engine(16, 8, device="cpu", two_phase=True)
    over = dict(S.DEMO_OVERRIDES, samples_per_pixel=1)
    e.update_scene(S.demo_scene(PD, 0), **over)
    flat = e._flat
    with pytest.raises(ValueError, match="samples_per_pixel"):
        e.update_scene(S.demo_scene(PD, 1), **dict(over, samples_per_pixel=2))
    s = S.demo_scene(PD, 1)
    s.camera.aperture_size = 0.1
    with pytest.raises(ValueError, match="aperture"):
        e.update_scene(s, **over)
    assert e._flat is flat
    assert e.render().shape == (8, 16, 4)
    with pytest.raises(ValueError, match="samples_per_pixel"):
        Engine(16, 8, device="cpu", two_phase=True).update_scene(S.demo_scene(PD, 0))


@pytest.mark.nightly
def test_two_phase_plain_matches_jax_pallas_two_phase():
    """The port's plain two-phase path against the JAX package's two-phase
    megakernel in interpret mode at 128x32 on config 3, at the bands of
    tests/test_twophase.py (pallas2 against pallas)."""
    w, h = 128, 32
    jf, jc, pf, pc = _setup("config3_glass_soft", w, h)
    two = j_render_rows(jf, jc, jnp.int32(0), h, backend="pallas2", interpret=True)
    pout = render_rows_cf(pf, pc, two_phase=True, aperture_size=float(pf.aperture_size))
    r_two, r_port = float(np.asarray(two.rays)), float(pout.rays)
    assert abs(r_port - r_two) / r_two < 2e-3
    cd = np.abs(_lanes(pout.color) - np.asarray(two.color)).max(axis=-1)
    assert (cd > 1e-3).mean() < 0.02
    assert np.median(cd) < 1e-5
    np.testing.assert_array_equal(_lanes(pout.gbuffer.obj_id), np.asarray(two.gbuffer.obj_id))
    np.testing.assert_allclose(_lanes(pout.gbuffer.normal_roughness),
                               np.asarray(two.gbuffer.normal_roughness), atol=2e-3)
    np.testing.assert_allclose(_lanes(pout.gbuffer.shadow_data),
                               np.asarray(two.gbuffer.shadow_data), atol=2e-3)


@pytest.mark.parametrize("name", ["config3_glass_soft", "glass_ball", "nine_balls"])
def test_phase_a_hit_planes_hold_the_traced_primary_hits(name, monkeypatch):
    """Phase A's CH_HIT planes hold each primary ray's closest hit as its
    one DFS iteration traced it: the hit that iteration's shade_and_spawn
    took (recorded inside phase A) equals, field by field, the
    intersect.Hit that phase B rebuilds from the planes (so phase B's
    children are those of that hit), and the int fields survive as their
    bits."""
    from raytracevs_tpu_torch.ops import wavefront

    _, _, sc, cfg = _setup(name, 24, 16)
    calls = []
    hit_context = wavefront._hit_context

    def recording(scene, cfg, state, traced, hit=None):
        out = hit_context(scene, cfg, state, traced, hit)
        calls.append((state.depth.clone(), traced.clone(), out[1]["hit"]))
        return out

    monkeypatch.setattr(wavefront, "_hit_context", recording)
    a = R.render_accum_phase_a(sc, cfg)
    monkeypatch.undo()
    assert a.shape == (R.NUM_CH_A, 16, 24) and R.CH_HIT + R.NUM_CH_HIT == R.NUM_CH_A
    n = cfg.width * cfg.height
    depth, traced, want = calls[0]  # the iteration's: every pixel's primary ray, in pixel order
    assert depth.shape == (n,) and bool((depth == 0).all()) and bool(traced.all())
    got = R.hit_from_planes(sc, a[R.CH_HIT:].reshape(R.NUM_CH_HIT, n))
    for f, g, w in zip(want._fields, got, want):
        assert (g is None) == (w is None), f
        if w is not None:
            assert torch.equal(g, w), f
    assert bool(want.hit.any()) and not bool(want.hit.all())
    if sc.mesh is not None:
        assert bool((want.obj_type == 3).any())  # a mesh hit rides the planes
