"""The frozen photon pass (reference/ops/photon.py) against the port's
plain CPU path at 64x32, on the demo configuration with caustics on: a
drift of the freeze, or a frame loop that skips the photon pass, shows
here."""
import json
import os

import numpy as np
import pytest
import torch

from rtbench.core import check, spec, window
from rtbench.core.traffic import Traffic
from rtbench.reference import frame as ref_frame
from rtbench.reference.ops import photon as ref_photon


def sides(cfg, mix):
    """The port's Engine (window.Program) and the reference's Replay at
    64x32 under traffic `mix`."""
    with open(os.path.join(spec.ROOT, "rtbench", "traffic", f"{mix}.json")) as f:
        traffic = Traffic(json.load(f), 2**31 + 5)
    prog = window.Program(cfg, traffic, 64, 32, "cpu")
    rep = ref_frame.Replay(64, 32, "cpu", check.reference_meshes(cfg))
    return traffic, prog, rep


@pytest.mark.parametrize("mix", ["orbit", "still"])
def test_reference_with_caustics_equals_the_ports_plain_path(mix, caustics_config):
    cfg = caustics_config
    traffic, prog, rep = sides(cfg, mix)
    for i in range(2):
        if traffic.updates(i):
            prog.engine.update_scene(prog.scene(i), **cfg.OVERRIDES)
            rep.update_scene(check.reference_scene(cfg, traffic, i), **cfg.OVERRIDES)
        assert rep.cfg.num_photons == 16384
        assert tuple(prog.engine._cfg) == tuple(rep.cfg)
        got = prog.engine.render()
        want = rep.render()
        assert np.array_equal(got, want.rgba.numpy())
        assert prog.engine.last_rays == want.rays
        assert torch.equal(prog.engine._denoise_state.packed, want.history)
        assert torch.equal(prog.engine._last_denoised[2], want.shadow)
        for a, b in zip(prog.engine._flat[:-1], rep.flat[:-1]):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_reference_photon_map_equals_the_ports(caustics_config):
    """emit_and_trace on one flattened scene, bit for bit in every field
    of the photon map."""
    from raytracevs_tpu_torch.ops import photon as port_photon

    cfg = caustics_config
    traffic, prog, rep = sides(cfg, "orbit")
    prog.engine.update_scene(prog.scene(0), **cfg.OVERRIDES)
    rep.update_scene(check.reference_scene(cfg, traffic, 0), **cfg.OVERRIDES)
    n = rep.cfg.num_photons
    got = port_photon.emit_and_trace(prog.engine._scene_t, n)
    want = ref_photon.emit_and_trace(rep.scene_t, n)
    assert int(want.count) > 0
    assert got._fields == want._fields
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
