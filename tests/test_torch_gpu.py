"""The port's CUDA kernels K1-K4 vs their plain PyTorch versions, on the
card. Every test needs a CUDA device and skips without one. This file
imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Bands: K1 ray count and object ids exact, HDR colour atol 2e-4 on >= 99%
of pixels; K2-K4 atol 1e-5 (the kernels round like the plain ops; they
are built with --fmad=false)."""
import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.ops import render as R
from raytracevs_tpu_torch.ops.cuda import denoise_kernels as K
from raytracevs_tpu_torch.ops.cuda import megakernel as MK
from raytracevs_tpu_torch.post import denoise as PD_
from raytracevs_tpu_torch.scene import data as D
from raytracevs_tpu_torch.scene.flatten import flatten_scene, make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

pytestmark = pytest.mark.gpu


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.parametrize("name", ["demo"] + list(S.GOLDEN))
def test_k1_cuda_matches_plain(name):
    _need_cuda()
    scene, over = S.scene_and_overrides(D, name)
    w, h = 72, 40  # ragged against the 16x16 blocks
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=w / h, frame_index=3), "cuda")
    cfg = make_config(scene, w, h, **over)
    before = MK.render_accum.launches
    got = MK.render_accum(sc, cfg)
    assert MK.render_accum.launches == before + 1
    want = R.render_accum(sc, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got[R.CH_RAYS], want[R.CH_RAYS])
    assert torch.equal(got[R.CH_OBJ_ID], want[R.CH_OBJ_ID])
    d = (got[0:3] - want[0:3]).abs().amax(0)
    assert float((d <= 2e-4).float().mean()) >= 0.99, float(d.max())
    assert torch.isfinite(got).all()


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


def test_k3_cuda_matches_plain():
    _need_cuda()
    x = _inputs(72, 136, 2)
    normal = PD_.decode_oct_cf(x["nr"])
    got = K.atrous(x["img6"], x["view_z"], normal, x["guide"])
    want = PD_.atrous(x["img6"], x["view_z"], normal, x["guide"])
    assert float((got - want).abs().max()) <= 1e-5


def test_k4_cuda_matches_plain():
    _need_cuda()
    x = _inputs(72, 136, 3)
    normal = PD_.decode_oct_cf(x["nr"])
    got = K.shadow_denoise(x["shadow"], x["obj_id"], x["view_z"], normal)
    want = PD_.shadow_denoise(x["shadow"], x["obj_id"], x["view_z"], normal)
    assert float((got - want).abs().max()) <= 1e-5


def test_engine_cuda_matches_cpu_and_launches_every_kernel():
    _need_cuda()
    w, h = 64, 36
    gpu, cpu = Engine(w, h, device="cuda"), Engine(w, h, device="cpu")
    counts = [MK.render_accum.launches, K.reproject_accumulate.launches, K.atrous.launches,
              K.shadow_denoise.launches]
    for f in range(2):
        for e in (gpu, cpu):
            e.update_scene(S.demo_scene(D, f), **S.DEMO_OVERRIDES)
        a, b = gpu.render(), cpu.render()
        assert gpu.last_rays == cpu.last_rays
        d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
        assert (d <= 1).mean() >= 0.995
    after = [MK.render_accum.launches, K.reproject_accumulate.launches, K.atrous.launches,
             K.shadow_denoise.launches]
    assert [y - x for x, y in zip(counts, after)] == [2, 2, 6, 2]


def test_wrappers_reject_bad_inputs():
    _need_cuda()
    x = _inputs(16, 16, 4)
    with pytest.raises(ValueError, match="contiguous"):
        K.atrous(x["img6"].transpose(1, 2).contiguous().transpose(1, 2), x["view_z"],
                 PD_.decode_oct_cf(x["nr"]), x["guide"])
    with pytest.raises(ValueError, match="dtype"):
        K.shadow_denoise(x["shadow"], x["obj_id"].to(torch.int64), x["view_z"],
                         PD_.decode_oct_cf(x["nr"]))
