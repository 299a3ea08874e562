"""Port RNG and samplers vs raytracevs_tpu/ops/sampling.py: the integer
hashes, RNG stream and blue-noise lookups bit-exact; the float samplers
(disk, sphere, cosine, perturb, spherical light) within atol 1e-6 — the
two libraries' sin/cos/sqrt may differ in the last bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracevs_tpu.ops import sampling as J
from raytracevs_tpu_torch.ops import sampling as P

RNG = np.random.default_rng(1234)
U32 = RNG.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _f(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("fn", ["pcg_hash", "wang_hash"])
def test_hashes_bit_exact(fn):
    got = getattr(P, fn)(_t(U32)).numpy()
    want = np.asarray(getattr(J, fn)(jnp.asarray(U32))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_rng_init_and_stream_bit_exact():
    px = RNG.integers(0, 4096, 512)
    py = RNG.integers(0, 2160, 512)
    frame = np.uint32(4294967290)  # near the u32 wrap
    sample = RNG.integers(0, 64, 512)
    for salt in (1, 6, 8):
        js = J.rng_init(jnp.asarray(px), jnp.asarray(py), jnp.uint32(frame),
                        jnp.asarray(sample), salt)
        ps = P.rng_init(_t(px), _t(py), torch.tensor(int(frame)), _t(sample), salt)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
        for _ in range(4):
            js, jv = J.rng_next(js)
            ps, pv = P.rng_next(ps)
            np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
            assert pv.dtype == torch.float32
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_u24_to_float_bit_exact():
    v = _t(U32)
    want = (np.asarray(U32) >> 8).astype(np.float32) * np.float32(1.0 / 16777216.0)
    np.testing.assert_array_equal(P.u24_to_float(v).numpy(), want)


def test_blue_noise_tile_and_lookup_bit_exact():
    tile_p = P.blue_noise_tile("cpu")
    tile_j = J.blue_noise_tile()
    np.testing.assert_array_equal(tile_p.numpy(), np.asarray(tile_j))
    px = RNG.integers(0, 1920, 1000)
    py = RNG.integers(0, 1080, 1000)
    for frame, s in ((0, 0), (17, 1), (2**32 - 3, 5)):
        got = P.sample_blue_noise(tile_p, _t(px), _t(py), torch.tensor(frame), s)
        want = J.sample_blue_noise(tile_j, jnp.asarray(px), jnp.asarray(py), jnp.uint32(frame), s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_float_samplers_atol_1e6():
    seeds = _t(U32[:1024])
    jseeds = jnp.asarray(U32[:1024])
    for fn in ("random_on_disk", "random_on_sphere"):
        ps, pv = getattr(P, fn)(seeds)
        js, jv = getattr(J, fn)(jseeds)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)
    n = _unit(1024, 5)
    ps, pv = P.cosine_sample_hemisphere(_f(n), seeds)
    js, jv = J.cosine_sample_hemisphere(jnp.asarray(n), jseeds)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)
    t_p, b_p = P.build_orthonormal_basis(_f(n))
    t_j, b_j = J.build_orthonormal_basis(jnp.asarray(n))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), atol=1e-6)
    np.testing.assert_allclose(b_p.numpy(), np.asarray(b_j), atol=1e-6)


@pytest.mark.parametrize("rough", [0.0, 0.005, 0.2, 0.9])
def test_perturb_reflection_atol_1e6(rough):
    refl = _unit(1024, 7)
    n = _unit(1024, 8)
    r = np.full(1024, rough, np.float32)
    seeds = U32[1024:2048]
    _, pv = P.perturb_reflection(_f(refl), _f(n), _f(r), _t(seeds))
    _, jv = J.perturb_reflection(jnp.asarray(refl), jnp.asarray(n), jnp.asarray(r),
                                 jnp.asarray(seeds))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)


def test_sample_spherical_light_atol_1e6():
    rng = np.random.default_rng(9)
    center = rng.normal(size=(512, 3)).astype(np.float32) * 5
    hit = rng.normal(size=(512, 3)).astype(np.float32)
    radius = rng.uniform(0.1, 1.0, 512).astype(np.float32)
    seeds = U32[:512]
    _, pv = P.sample_spherical_light(_f(center), _f(radius), _f(hit), _t(seeds))
    _, jv = J.sample_spherical_light(jnp.asarray(center), jnp.asarray(radius), jnp.asarray(hit),
                                     jnp.asarray(seeds))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-6)
