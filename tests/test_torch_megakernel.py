"""Plain K1 (render_rows_cf on the CPU) vs raytracevs_tpu render_rows
(backend="jnp") at 32x32, on the demo scene and golden configs 2, 3, 6, and
on mesh scenes: the glass ball of tests/test_shadow_fuse.py (absorbing
glass and opaque) and nine mesh instances (the multiply-per-crossing shadow
walk).

Bands: the ray count and object ids exact; HDR colour, and the radiance
planes of the G-buffer that split it, atol 2e-4 on >= 99% of pixels (the
two libraries' sin/cos/exp differ in the last bit, which moves a few glass
paths further); the geometric G-buffer planes atol 1e-4, plus rtol 1e-5
for the hit distances and view depths of grazing floor hits 10^3-10^4
units away, where float32 resolves only ~1e-3 and the plane division's
rounding is carried into view_z. The mesh scenes hold the same bands: XLA
contracts the walk's multiply-adds into FMAs (ROADMAP C5), which moves
triangle t, u and v by ~1e-6 and the colour by < 1e-4 at 32x32, and no
decision flips there.
The CUDA kernel is held against this plain version on the card
(tests/test_torch_gpu.py)."""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu.io import mesh_cache as JMC
from raytracevs_tpu.ops.render import render_rows as j_render_rows
from raytracevs_tpu.ops.render_cf import assemble_frame_cf as j_assemble_cf
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu.scene.flatten import flatten_scene as j_flatten
from raytracevs_tpu.scene.flatten import make_config as j_make_config
from raytracevs_tpu.scene.sanitize import sanitize_scene as j_sanitize
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.ops import render as R
from raytracevs_tpu_torch.ops.cuda import _build
from raytracevs_tpu_torch.ops.cuda import megakernel as mk
from raytracevs_tpu_torch.ops.render_cf import accum_dict, assemble_frame_cf, render_rows_cf
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import flatten_scene, make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

S.one_torch_thread()

W = H = 32
NAMES = ("demo", "config2_obb_mirror", "config3_glass_soft", "config6_soft_shadows")
MESH_NAMES = ("glass_ball", "opaque_ball", "nine_balls")
GBUF_FIELDS = ("diffuse_hitdist", "specular_hitdist", "normal_roughness", "motion", "albedo",
               "shadow_data", "shadow_translucency", "motion_spec")
_CACHE = {}


def _mesh_scene(D, MC, name):
    """(SceneData, overrides, mesh service) of a mesh scene."""
    if name == "nine_balls":
        return S.nine_ball_scene(D), {}, S.mesh_service(MC, {"Ball": (6, 8, 0.3)})
    return (S.glass_ball_scene(D, opaque=name == "opaque_ball"), {"max_soft_samples": 2},
            S.mesh_service(MC, {"GlassBall": (9, 9, 0.7)}))


def _setup(name):
    if name in MESH_NAMES:
        js, jo, jms = _mesh_scene(JD, JMC, name)
        ps, po, pms = _mesh_scene(PD, PMC, name)
        jf = j_flatten(j_sanitize(js), aspect=1.0, frame_index=3, mesh_service=jms)
        pf = flatten_scene(sanitize_scene(ps), aspect=1.0, frame_index=3, mesh_service=pms)
        return jf, j_make_config(js, W, H, **jo), to_device(pf, "cpu"), make_config(ps, W, H, **po)
    js, jo = S.scene_and_overrides(JD, name)
    ps, po = S.scene_and_overrides(PD, name)
    prev = None
    if name == "demo":  # a moving camera, so the motion vectors are not zero
        prev = j_flatten(j_sanitize(S.demo_scene(JD, 1)), aspect=1.0).view_proj
    jf = j_flatten(j_sanitize(js), aspect=1.0, frame_index=3, prev_view_proj=prev)
    pf = flatten_scene(sanitize_scene(ps), aspect=1.0, frame_index=3,
                       prev_view_proj=None if prev is None else np.asarray(prev))
    return jf, j_make_config(js, W, H, **jo), to_device(pf, "cpu"), make_config(ps, W, H, **po)


def _frames(name):
    if name not in _CACHE:
        jf, jc, pf, pc = _setup(name)
        jout = j_render_rows(jf, jc, jnp.int32(0), H, backend="jnp")
        jax.block_until_ready(jout.color)
        _CACHE[name] = (jout, render_rows_cf(pf, pc))
    return _CACHE[name]


def _lanes(a):
    """[c,H,W] or [H,W] tensor -> [N,c] / [N] numpy (the JAX lane layout)."""
    if a.dim() == 2:
        return a.reshape(-1).numpy()
    return a.permute(1, 2, 0).reshape(-1, a.shape[0]).numpy()


@pytest.mark.parametrize("name", NAMES + MESH_NAMES)
def test_k1_plain_ray_count_and_obj_id_exact(name):
    jout, pout = _frames(name)
    assert int(pout.rays) == int(jout.rays)
    np.testing.assert_array_equal(_lanes(pout.gbuffer.obj_id), np.asarray(jout.gbuffer.obj_id))


@pytest.mark.parametrize("name", NAMES + MESH_NAMES)
def test_k1_plain_hdr_color(name):
    jout, pout = _frames(name)
    d = np.abs(_lanes(pout.color) - np.asarray(jout.color)).max(axis=-1)
    assert (d <= 2e-4).mean() >= 0.99, (d.max(), (d > 2e-4).mean())
    assert np.isfinite(_lanes(pout.color)).all()


@pytest.mark.parametrize("name", NAMES)
def test_k1_plain_gbuffer(name):
    jout, pout = _frames(name)
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
    d = np.abs(_lanes(pout.raw_specular) - np.asarray(jout.raw_specular)).max(axis=-1)
    assert (d <= 2e-4).mean() >= 0.99


def test_assemble_frame_cf_matches_jax_on_same_accumulators():
    jf, jc, pf, pc = _setup("demo")
    acc = R.render_accum(pf, pc)
    assert acc.shape == (R.NUM_CH, H, W)
    pd = accum_dict(acc)
    jd = {k: (jnp.asarray(v.numpy()) if k != "rays" else jnp.float32(float(v)))
          for k, v in pd.items()}
    jout = j_assemble_cf(jf, jc, jd)
    pout = assemble_frame_cf(pf, pc, pd)
    np.testing.assert_allclose(pout.color.numpy(), np.asarray(jout.color), atol=1e-6)
    for f in GBUF_FIELDS + ("view_z",):
        np.testing.assert_allclose(getattr(pout.gbuffer, f).numpy(),
                                   np.asarray(getattr(jout.gbuffer, f)),
                                   atol=1e-5, rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(pout.gbuffer.obj_id.numpy(), np.asarray(jout.gbuffer.obj_id))


def test_k1_plain_without_dfs_iterations_matches_jax():
    """max_queue_iters 0: no sample is traced, so the planes hold the
    records of no sample (the kernels write the same, tests/test_torch_gpu.py),
    and the frame equals the JAX package's."""
    js, jo = S.scene_and_overrides(JD, "demo")
    ps, po = S.scene_and_overrides(PD, "demo")
    jf = j_flatten(j_sanitize(js), aspect=1.0, frame_index=3)
    pf = to_device(flatten_scene(sanitize_scene(ps), aspect=1.0, frame_index=3), "cpu")
    w = h = 16
    jout = j_render_rows(jf, j_make_config(js, w, h, **dict(jo, max_queue_iters=0)),
                         jnp.int32(0), h, backend="jnp")
    pc = make_config(ps, w, h, **dict(po, max_queue_iters=0))
    acc = R.render_accum(pf, pc)
    for ch, v in ((R.CH_COLOR, 0.0), (R.CH_RAYS, 0.0), (R.CH_PRIM_HIT, 0.0),
                  (R.CH_SHADOW_VIS, 1.0), (R.CH_OBJ_ID, -1.0)):
        assert bool((acc[ch] == v).all()), ch
    pout = render_rows_cf(pf, pc)
    assert int(pout.rays) == int(jout.rays) == 0
    np.testing.assert_array_equal(_lanes(pout.color), np.asarray(jout.color))
    for f in GBUF_FIELDS + ("view_z", "obj_id"):
        np.testing.assert_array_equal(_lanes(getattr(pout.gbuffer, f)),
                                      np.asarray(getattr(jout.gbuffer, f)), err_msg=f)


@pytest.mark.parametrize("width,height,limit,bands", [
    (1920, 1080, mk.PLANE_LIMIT, 1), (7680, 4320, mk.PLANE_LIMIT, 1),
    (8192, 8192, mk.PLANE_LIMIT, 2), (8192, 8200, mk.PLANE_LIMIT, 2),
    (16384, 16384, mk.PLANE_LIMIT, None), (64, 32, 46 * 64 * 5, None), (17, 9, 46 * 17 + 1, 9)])
def test_row_bands_cover_frames_past_the_plane_index(width, height, limit, bands):
    """K1's 32 and K7's 46 planes are indexed in 32 bits (csrc/render.cuh::
    Planes): a frame under the limit is one band, the whole frame; past it
    (8192x8200, C10's size, and beyond, or a small limit) the bands, in
    order, cover every row once, each band's planes under the limit. Pure
    arithmetic: nothing is allocated."""
    for channels in (R.NUM_CH, R.NUM_CH_A):
        got = mk.row_bands(width, height, channels, limit)
        if bands is not None and channels == R.NUM_CH_A:
            assert len(got) == bands
        assert [r for row0, rows in got for r in range(row0, row0 + rows)] == list(range(height))
        assert all(channels * rows * width < limit for _, rows in got)
        if channels * width * height < limit:
            assert got == [(0, height)]
        else:
            assert len(got) > 1
            assert max(rows for _, rows in got) - min(rows for _, rows in got) <= 1


def test_check_size_refuses_frames_past_the_plane_index():
    """Only a frame one row of whose planes reaches the limit is refused:
    8192x8200 (C10) bands without a raise; a row of 2**31 / 32 pixels
    cannot be banded."""
    assert len(mk.row_bands(8192, 8200, R.NUM_CH)) == 2
    with pytest.raises(ValueError, match="row"):
        mk.row_bands(2**26, 2, R.NUM_CH)
    with pytest.raises(ValueError, match="row"):
        mk.row_bands(64, 32, R.NUM_CH_A, limit=46 * 64)


@pytest.mark.parametrize("name", ["config2_obb_mirror", "glass_ball"])
def test_render_accum_cpu_runs_plain_version_without_launch(name):
    _, _, pf, pc = _setup(name)
    before = mk.render_accum.launches
    out = mk.render_accum(pf, pc._replace(height=8, width=8))
    assert out.shape == (R.NUM_CH, 8, 8)
    assert mk.render_accum.launches == before


def _port_scene(name):
    """(FlatScene on the CPU, config) of the port alone: the demo scene (no
    mesh), the glass ball (the wide walks) or the deep forest (the
    threaded walks)."""
    if name == "deep_forest":
        scene, over = S.deep_forest_scene(PD), {"max_soft_samples": 2}
        ms = S.deep_forest_service(PMC)
    elif name in MESH_NAMES:
        scene, over, ms = _mesh_scene(PD, PMC, name)
    else:
        (scene, over), ms = S.scene_and_overrides(PD, name), None
    flat = flatten_scene(sanitize_scene(scene), aspect=W / H, frame_index=3, mesh_service=ms)
    return to_device(flat, "cpu"), make_config(scene, W, H, **over)


_SIG_CACHE = {}  # the scenes' packed tables, shared by the cases


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("name", ["demo", "glass_ball", "deep_forest"])
@pytest.mark.parametrize("entry", ["rtvs_render_accum", "rtvs_render_phase_a",
                                   "rtvs_render_phase_b"])
def test_launch_args_match_the_entry_signatures(entry, name, counted):
    """The arguments the wrappers pass a render entry (launch_args on
    pack_tables' RenderTables, then the stream) against its C signature
    (_build.SIGNATURES): the same length, an int in each int slot, a float
    in each float slot, and in each pointer slot a packed table's, a lead
    tensor's or the counts' data pointer, or null: the mesh tables without
    a mesh, counts in the plain build. threaded follows check_mesh."""
    if name not in _SIG_CACHE:
        _SIG_CACHE[name] = _port_scene(name)
    if (name, counted) not in _SIG_CACHE:
        sc, cfg = _SIG_CACHE[name]
        counts = torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64) if counted else None
        _SIG_CACHE[name, counted] = mk.pack_tables(sc), cfg._replace(samples_per_pixel=1), counts
    tables, cfg, counts = _SIG_CACHE[name, counted]
    out = torch.empty((R.NUM_CH_A, H, W))
    if entry == "rtvs_render_phase_b":
        order, count = torch.arange(H * W, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
        acc, hits = out[:R.NUM_CH].clone(), out[R.CH_HIT:].clone()
        lead_tensors = [order, count, acc, hits]
        lead = [t.data_ptr() for t in lead_tensors] + [order.numel()]
    else:
        lead_tensors = [out]
        lead = [out.data_ptr()]
    args = mk.launch_args(tables, cfg, 0, lead, counts) + [0]  # the stream
    sig = _build.SIGNATURES[entry]
    assert len(args) == len(sig)
    ptrs = {t.data_ptr() for t in [*tables, *lead_tensors, counts] if torch.is_tensor(t)}
    for i, (a, kind) in enumerate(zip(args, sig)):
        if kind is ctypes.c_float:
            assert type(a) is float, (i, a)
        elif kind is ctypes.c_int:
            assert type(a) is int, (i, a)
        else:
            assert kind is ctypes.c_void_p and type(a) is int and (a == 0 or a in ptrs), (i, a)
    assert args[2:2 + len(lead)] == lead
    # nodes .. inst_tbl, then T, I, Nn, threaded, counts, stream
    mesh, sizes, threaded, counts_ptr = args[-15:-6], args[-6:-3], args[-3], args[-2]
    if name == "demo":
        assert mesh == [0] * 9 and sizes == [0, 0, 0]
    else:
        assert 0 not in mesh and sizes == [tables.T, tables.I, tables.Nn] and min(sizes) > 0
        assert mesh[0] == tables.nodes.data_ptr()
    assert threaded == int(name == "deep_forest")
    assert counts_ptr == (0 if counts is None else counts.data_ptr())


def test_k1_plain_mesh_scenes_hit_the_meshes():
    """Each mesh scene's frame shows its instances (object id 3*65536+i)."""
    for name, count in (("glass_ball", 1), ("opaque_ball", 1), ("nine_balls", 9)):
        ids = np.unique(_frames(name)[1].gbuffer.obj_id.numpy())
        assert {3 * 65536 + i for i in range(count)} <= set(ids.tolist()), (name, ids)


@pytest.mark.parametrize("name", ["demo", "config1_hard_shadows", "nine_balls"])
def test_pack_scene_layout(name):
    """The float table K1 reads: rows of 5/7/16/16/12 floats (one material
    row per primitive slot and mesh instance), 32 params, then the
    blue-noise tile; scene scalars in the int table."""
    _, _, pf, _ = _setup(name)
    ftab, itab = mk.pack_scene(pf)
    s, p, b, l = pf.sphere_capacity, pf.plane_capacity, pf.box_capacity, pf.light_capacity
    m = pf.mat_color.shape[0]
    assert ftab.dtype == torch.float32 and ftab.dim() == 1
    assert ftab.numel() == 5 * s + 7 * p + 16 * b + 16 * m + 12 * l + 32 + 16 * 16 * 4
    mat = ftab[5 * s + 7 * p + 16 * b:][:16 * m].reshape(m, 16)
    np.testing.assert_array_equal(mat[:, 5].numpy(), pf.mat_transmission.numpy())
    np.testing.assert_array_equal(mat[:, 12:15].numpy(), pf.mat_absorption.numpy())
    par = ftab[5 * s + 7 * p + 16 * b + 16 * m + 12 * l:][:32]
    np.testing.assert_array_equal(par[0:3].numpy(), pf.cam_pos.numpy())
    assert itab.tolist() == [int(pf.num_lights), int(pf.max_shadow_lights), 3]
    # a material table that does not match the primitive slots would shift
    # every later table the kernel reads
    with pytest.raises(ValueError, match="material rows"):
        mk.pack_scene(pf._replace(mat_color=pf.mat_color[:-1]))
    if pf.mesh is not None:
        assert m == s + p + b + pf.mesh.num_inst
        inst_tbl = mk.pack_mesh(pf.mesh)
        np.testing.assert_array_equal(inst_tbl[:, 4:7].numpy(), pf.mesh.inst_beer.numpy())
        # the wide nodes the walks read: 32 words a node, slot boxes from
        # the fine boxes, child words after them
        wide = pf.mesh.wide
        topo = pf.mesh.wide_topology
        assert wide.shape == (topo.child.shape[0], 32) and wide.is_contiguous()
        assert torch.equal(wide[:, 24:28].view(torch.int32), torch.from_numpy(topo.child))
        src = torch.from_numpy(topo.src[:, 0]).long()
        own = src >= 0
        np.testing.assert_array_equal(wide[own][:, [12, 16, 20]].numpy(),
                                      pf.mesh.bbox_max[src[own]].numpy())
