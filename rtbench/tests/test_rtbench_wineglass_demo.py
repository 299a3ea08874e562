"""The configuration wineglass_demo: its glass is a closed, outward-wound
shell of WineGlass.fbx's size, and the frozen reference equals the port's
plain CPU path on it, frame by frame at 64x32 under the orbit."""
import json
import os

import numpy as np
import torch

from rtbench.core import check, spec, window
from rtbench.core.traffic import Traffic
from rtbench.reference import frame as ref_frame

BASE = os.path.join(spec.ROOT, "rtbench")


def config():
    return spec.load_module(os.path.join(BASE, "configs", "wineglass_demo.py"),
                            "test_wineglass_demo")


def test_the_glass_is_a_closed_outward_shell_of_the_sources_size():
    verts, idx, lo, hi = config().meshes()["WineGlass"]
    v = verts.reshape(-1, 8)
    p, n, t = v[:, :3].astype(np.float64), v[:, 4:7], idx.reshape(-1, 3).astype(np.int64)
    assert len(t) == 5888  # WineGlass.fbx: about 5.9k (bench.py:19)
    np.testing.assert_allclose(hi[1], 3.015)
    face = np.cross(p[t[:, 1]] - p[t[:, 0]], p[t[:, 2]] - p[t[:, 0]])
    assert np.linalg.norm(face, axis=1).min() > 1e-6
    assert (np.sum(face * n[t[:, 0]], 1) > 0).all()  # front faces face out
    # closed: by position, every edge is two triangles', once each way
    key = {tuple(np.round(q, 5)): k for k, q in enumerate(p)}
    vid = np.array([key[tuple(np.round(q, 5))] for q in p])[t]
    edges = {}
    for a, b in np.concatenate([vid[:, [0, 1]], vid[:, [1, 2]], vid[:, [2, 0]]]):
        edges[(a, b)] = edges.get((a, b), 0) + 1
    assert all(c == 1 and edges.get((b, a)) == 1 for (a, b), c in edges.items())
    # the divergence theorem: the enclosed volume is positive (outward shell)
    assert np.einsum("ij,ij->", p[t[:, 0]], face) / 6.0 > 0.05


def test_reference_equals_the_ports_plain_path_under_the_orbit():
    cfg = config()
    with open(os.path.join(BASE, "traffic", "orbit.json")) as f:
        traffic = Traffic(json.load(f), 2**31 + 11)
    prog = window.Program(cfg, traffic, 64, 32, "cpu")
    rep = ref_frame.Replay(64, 32, "cpu", check.reference_meshes(cfg))
    for i in range(3):
        prog.engine.update_scene(prog.scene(i), **cfg.OVERRIDES)
        rep.update_scene(check.reference_scene(cfg, traffic, i), **cfg.OVERRIDES)
        got = prog.engine.render()
        want = rep.render()
        assert np.array_equal(got, want.rgba.numpy())
        assert prog.engine.last_rays == want.rays
        assert torch.equal(prog.engine._denoise_state.packed, want.history)
        assert torch.equal(prog.engine._last_denoised[2], want.shadow)
        for a, b in zip(prog.engine._flat[:-1], rep.flat[:-1]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
