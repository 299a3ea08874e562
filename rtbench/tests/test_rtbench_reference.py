"""The frozen reference against the port's plain CPU path, frame by frame
at 64x32, for each configuration: a drift of the freeze shows here."""
import json
import os

import numpy as np
import pytest
import torch

from rtbench.core import check, spec, window
from rtbench.core.traffic import Traffic
from rtbench.reference import frame as ref_frame


@pytest.mark.parametrize("config, mix", [("demo", "orbit"), ("mesh_demo", "orbit"),
                                         ("mesh_demo", "still")])
def test_reference_equals_the_ports_plain_path(config, mix):
    """Each configuration under each mix in rtbench/."""
    base = os.path.join(spec.ROOT, "rtbench")
    cfg = spec.load_module(os.path.join(base, "configs", f"{config}.py"), f"test_ref_{config}")
    with open(os.path.join(base, "traffic", f"{mix}.json")) as f:
        traffic = Traffic(json.load(f), 2**31 + 3)
    prog = window.Program(cfg, traffic, 64, 32, "cpu")
    rep = ref_frame.Replay(64, 32, "cpu", check.reference_meshes(cfg))
    for i in range(2):
        if traffic.updates(i):
            prog.engine.update_scene(prog.scene(i), **cfg.OVERRIDES)
            rep.update_scene(check.reference_scene(cfg, traffic, i), **cfg.OVERRIDES)
        got = prog.engine.render()
        want = rep.render()
        assert np.array_equal(got, want.rgba.numpy())
        assert prog.engine.last_rays == want.rays
        assert torch.equal(prog.engine._denoise_state.packed, want.history)
        assert torch.equal(prog.engine._last_denoised[2], want.shadow)
        # the flattened tables the two sides built, leaf by leaf
        for a, b in zip(prog.engine._flat[:-1], rep.flat[:-1]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
