"""The wrappers of K9 (ops/cuda/gbuffer_kernels.py::assemble) and K10
(ops/cuda/denoise_kernels.py::reblur_prepass) on the CPU, where each runs
its plain version: equal to assemble_frame_cf and reblur_prepass bit for
bit on whole frames and row slabs, no launch counted. The denoiser reads
the diffuse and specular planes in place where they lie adjacent in one
buffer (K9's layout), with the same result as joined copies; the sharded
denoise over four CPU slabs equals the whole frame's. The kernels
themselves are held to these plain versions on the card
(tests/test_torch_gpu.py)."""
import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu_torch.ops import render as R
from raytracevs_tpu_torch.ops.cuda import denoise_kernels as K
from raytracevs_tpu_torch.ops.cuda import gbuffer_kernels as G
from raytracevs_tpu_torch.ops.render_cf import GBufferCF, accum_dict, assemble_frame_cf
from raytracevs_tpu_torch.post import denoise as PD_
from raytracevs_tpu_torch.scene import data as D
from raytracevs_tpu_torch.scene.flatten import flatten_scene, make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

S.one_torch_thread()

W, H = 40, 24


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.fixture(scope="module")
def frame():
    """The demo scene's second orbiting frame at W x H on the CPU: the
    scene tensors (the previous frame's view-projection, so motion is not
    zero), the configuration and K1's plain accumulator planes."""
    prev = flatten_scene(sanitize_scene(S.demo_scene(D, 0)), aspect=W / H).view_proj
    scene = S.demo_scene(D, 1)
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=W / H, frame_index=1,
                                 prev_view_proj=prev), "cpu")
    cfg = make_config(scene, W, H, **S.DEMO_OVERRIDES)
    return sc, cfg, R.render_accum(sc, cfg)


def _gbuffer_fields(out):
    return [out.color, out.raw_specular, out.rays] + [
        v for v in out.gbuffer if v is not None]


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("part", ["frame", "slab"])
def test_assemble_wrapper_on_cpu_is_the_plain_version(frame, part, mode):
    sc, cfg, acc = frame
    cfg = cfg._replace(photon_debug_mode=mode)
    if part == "slab":
        acc = acc[:, 5:17].contiguous()
    before = G.assemble.launches
    got = G.assemble(sc, cfg, acc)
    want = assemble_frame_cf(sc, cfg, accum_dict(acc))
    assert G.assemble.launches == before
    for a, b in zip(_gbuffer_fields(got), _gbuffer_fields(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) if a.dtype != torch.float32 else _same_bits(a, b)


def _prepass_inputs(sc, cfg, acc):
    """(curr [8,H,W], view_z, sqrt_rough) of the frame's G-buffer, with some
    hit distances cleared so that the reconstruction has work."""
    g = assemble_frame_cf(sc, cfg, accum_dict(acc)).gbuffer
    curr = torch.cat([g.diffuse_hitdist, g.specular_hitdist])
    curr[3, ::3, ::2] = 0.0
    curr[7, 1::4, ::3] = 0.0
    return curr, g.view_z, g.normal_roughness[3].contiguous()


@pytest.mark.parametrize("part", ["frame", "slab"])
def test_prepass_wrapper_on_cpu_is_the_plain_version(frame, part):
    curr, view_z, sqrt_rough = _prepass_inputs(*frame)
    if part == "slab":  # a slab of 6 rows extended by PREPASS_HALO rows of the frame
        lo, hi = 9 - PD_.PREPASS_HALO, 15 + PD_.PREPASS_HALO
        curr, view_z, sqrt_rough = (t[..., lo:hi, :].contiguous()
                                    for t in (curr, view_z, sqrt_rough))
    before = K.reblur_prepass.launches
    got = K.reblur_prepass(curr, view_z, sqrt_rough)
    assert K.reblur_prepass.launches == before
    assert _same_bits(got, PD_.reblur_prepass(curr, view_z, sqrt_rough))
    assert not torch.equal(got[3], curr[3]) and not torch.equal(got[4:7], curr[4:7])


def test_denoise_reads_adjacent_hitdist_planes_in_place(frame):
    sc, cfg, acc = frame
    g = assemble_frame_cf(sc, cfg, accum_dict(acc)).gbuffer
    buf = torch.cat([g.diffuse_hitdist, g.specular_hitdist])
    adjacent = g._replace(diffuse_hitdist=buf[0:4], specular_hitdist=buf[4:8])
    planes = PD_._hitdist_planes(adjacent)
    assert planes.data_ptr() == buf.data_ptr() and planes.shape == buf.shape
    joined = PD_._hitdist_planes(g)
    assert joined.data_ptr() not in (g.diffuse_hitdist.data_ptr(), g.specular_hitdist.data_ptr())
    assert torch.equal(joined, buf)
    # two tensors of one storage, not adjacent: joined
    apart = g._replace(diffuse_hitdist=buf[4:8], specular_hitdist=buf[0:4])
    assert torch.equal(PD_._hitdist_planes(apart), torch.cat([buf[4:8], buf[0:4]]))
    state = PD_.init_state_cf(H, W, "cpu")
    for a, b in zip(PD_.denoise_frame_cf(adjacent, state)[:3], PD_.denoise_frame_cf(g, state)[:3]):
        assert _same_bits(a, b)


def test_sharded_cpu_denoise_equals_whole_frame(frame):
    """denoise_frame_sharded_cf over four 6-row slabs of a frame's G-buffer,
    two frames from an empty history: each slab's planes and state bit-equal
    to those rows of denoise_frame_cf's."""
    sc, cfg, acc = frame
    rng = np.random.default_rng(3)
    n, rows = 4, H // 4
    state = PD_.init_state_cf(H, W, "cpu")
    states = [PD_.init_state_cf(rows, W, "cpu") for _ in range(n)]
    for f in range(2):
        g = assemble_frame_cf(sc, cfg, accum_dict(acc)).gbuffer
        if f:  # a moved frame: other colours, the same surfaces
            g = g._replace(diffuse_hitdist=g.diffuse_hitdist * torch.from_numpy(
                rng.uniform(0.5, 1.5, (4, H, W)).astype(np.float32)))
        whole = PD_.denoise_frame_cf(g, state)
        slabs = [GBufferCF(*(None if v is None else v[..., i * rows:(i + 1) * rows, :].contiguous()
                             for v in g)) for i in range(n)]
        sharded = PD_.denoise_frame_sharded_cf(slabs, states, H)
        for i in range(n):
            sl = slice(i * rows, (i + 1) * rows)
            for k in range(3):
                assert _same_bits(sharded[k][i], whole[k][:, sl])
            assert _same_bits(sharded[3][i].packed, whole[3].packed[:, sl])
        state, states = whole[3], sharded[3]
