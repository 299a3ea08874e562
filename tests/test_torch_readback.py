"""The frame's readback on the CPU (runtime/readback.py): a CPU Engine's
render() returns a writable, C-contiguous np.uint8 [H, W, 4] array of its
own, which later frames never change, and reads nothing back through
pinned host blocks (Engine.readback_stats stays at zero); read_back on CPU
tensors is .numpy() of the frame tensor itself. The pinned path on the card
is in tests/test_torch_gpu.py."""
import numpy as np
import torch

import _torch_scenes as S
from raytracevs_tpu_torch import Engine
from raytracevs_tpu_torch.runtime import readback as RB
from raytracevs_tpu_torch.scene import data as D

S.one_torch_thread()


def test_cpu_engine_frames_are_the_callers():
    w, h = 32, 16
    eng = Engine(w, h, device="cpu")
    kept = []
    for f in range(3):
        eng.update_scene(S.demo_scene(D, f), **S.DEMO_OVERRIDES)
        img = eng.render()
        assert img.dtype == np.uint8 and img.shape == (h, w, 4)
        assert img.flags.c_contiguous and img.flags.writeable
        assert eng.last_rays > w * h
        kept.append((img, img.copy()))
    for img, copy in kept:
        np.testing.assert_array_equal(img, copy)
    frames = [img for img, _ in kept]
    assert not any(np.may_share_memory(a, b)
                   for i, a in enumerate(frames) for b in frames[i + 1:])
    assert not np.array_equal(frames[0], frames[2])  # the camera moved
    stats = eng.readback_stats
    assert (stats.pinned, stats.new_blocks) == (0, 0)


def test_cpu_read_back_shares_the_frame_tensor():
    rgba_t = torch.arange(2 * 3 * 4, dtype=torch.uint8).reshape(2, 3, 4)
    rays_t = torch.tensor(12345.0, dtype=torch.float64)
    stats = RB.ReadbackStats()
    img, rays = RB.read_back(rgba_t, rays_t, stats)
    assert np.shares_memory(img, rgba_t.numpy())
    np.testing.assert_array_equal(img, rgba_t.numpy())
    assert rays == 12345 and isinstance(rays, int)
    assert (stats.pinned, stats.new_blocks) == (0, 0)
