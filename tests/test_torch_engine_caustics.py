"""The port's Engine with caustics on the CPU vs raytracevs_tpu's Engine
(backend "jnp", no device mesh): three orbiting frames of the demo scene
with caustics on and of golden config 5, with the denoiser on, in the band
of test_torch_engine.py; the JAX Engine reads the port's photon map of each
frame, and the maps themselves are held photon by photon."""
import numpy as np
import pytest

import _torch_scenes as S
from raytracevs_tpu.ops import photon as JP
from raytracevs_tpu_torch.ops import photon as PP
from test_torch_engine import (HDR_ATOL, _assert_frame_matches, _hdr_outliers, _pixel_op_by_op,
                               _render_pair)

S.one_torch_thread()

CAUSTICS = {
    "demo": (S.demo_scene, dict(S.DEMO_OVERRIDES, enable_caustics=True)),
    "config5": (S.caustics_golden_scene, {}),
}


@pytest.fixture(scope="module", params=list(CAUSTICS))
def caustics_frames(request):
    """The demo scene with caustics on and golden config 5, three orbiting
    frames each."""
    build, over = CAUSTICS[request.param]
    return _render_pair(build, overrides=over)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_caustics_engine_frames_match_jax(caustics_frames, frame):
    """Caustics frames (the photon pass through the K5 and K6 wrappers, on
    the CPU their plain versions) in test_torch_engine.py's band, the |d| <= 1 share
    taken beyond the reach of the HDR outliers (ROADMAP C8); the caustic is
    in the frame."""
    fr = caustics_frames[frame]
    _assert_frame_matches(fr, far_only=True)
    assert int(fr["pmap"].count) > 0
    assert fr["engine"]._cfg.num_photons == fr["jcfg"].num_photons > 0


def test_caustics_outliers_are_xla_whole_frame_rounding(caustics_frames):
    """Every HDR outlier of the caustics frames, rendered alone by the JAX
    package one operation at a time with the gather on the same photon
    map, matches the port: XLA's fused frame rounds a first-hit position
    differently, and at a caustic that moves photons across the gather
    radius or the 32-photon cap (ROADMAP C8)."""
    for fr in caustics_frames:
        for y, x in _hdr_outliers(fr):
            np.testing.assert_allclose(fr["phdr"][y, x], _pixel_op_by_op(fr, y, x), atol=HDR_ATOL)


def test_caustics_photon_maps_match_jax(caustics_frames):
    """The JAX Engine's own photon pass (emission and the bounce loop
    compiled by XLA) against the port's, photon by photon: fates equal,
    store fields within the bands of tests/test_megakernel.py:190-197."""
    import jax

    fr = caustics_frames[0]
    n = fr["jcfg"].num_photons
    want = [np.asarray(a) for a in jax.jit(
        lambda s: JP.trace_photon_slice(s, n, 0, n))(fr["jflat"])]
    scene = fr["engine"]._scene_t
    got = [a.numpy() for a in PP.trace_photon_slice(scene, n, 0, n)]
    np.testing.assert_array_equal(got[4], want[4])
    both = got[4]
    assert both.sum() > 10
    for c, atol in enumerate((5e-3, 1e-4, 1e-5, 1e-4)):
        np.testing.assert_allclose(got[c][both], want[c][both], atol=atol, rtol=1e-3)
