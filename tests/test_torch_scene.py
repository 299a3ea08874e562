"""Port host layer vs the JAX package: constants, sanitize, flatten,
make_config, checksums and the FlatScene bridge, exact leaf by leaf."""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu import constants as JC
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu.scene.flatten import flatten_scene as j_flatten
from raytracevs_tpu.scene.flatten import make_config as j_make_config
from raytracevs_tpu.scene.sanitize import sanitize_scene as j_sanitize
from raytracevs_tpu.utils import checksum as j_checksum
from raytracevs_tpu_torch import constants as PC
from raytracevs_tpu_torch.bridge import flat_from_numpy
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import FlatScene, flatten_scene, make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene
from raytracevs_tpu_torch.utils import checksum as p_checksum

SCENES = ("demo",) + S.GOLDEN


def _pair(name, frame_aspect=16 / 9):
    js, jo = S.scene_and_overrides(JD, name)
    ps, po = S.scene_and_overrides(PD, name)
    return js, ps, jo, po


def _assert_leaves_equal(port_flat, jax_flat):
    jl = S.jax_leaves(jax_flat)
    assert jl.pop("mesh") is None
    assert list(jl) == list(FlatScene._fields)
    for name, pv in zip(FlatScene._fields, port_flat):
        jv = jl[name]
        assert pv.dtype == jv.dtype, name
        assert pv.shape == jv.shape, name
        np.testing.assert_array_equal(pv, jv, err_msg=name)


def test_constants_match():
    names = [n for n in dir(JC) if n.isupper()]
    assert names == [n for n in dir(PC) if n.isupper()]
    for n in names:
        assert getattr(JC, n) == getattr(PC, n), n


@pytest.mark.parametrize("name", SCENES)
def test_flatten_matches_jax_leaf_by_leaf(name):
    js, ps, _, _ = _pair(name)
    prev = np.arange(16, dtype=np.float32).reshape(4, 4) * 0.1
    jf = j_flatten(j_sanitize(js), frame_index=7, aspect=2.0, prev_view_proj=prev)
    pf = flatten_scene(sanitize_scene(ps), frame_index=7, aspect=2.0, prev_view_proj=prev)
    _assert_leaves_equal(pf, jf)


@pytest.mark.parametrize("name", SCENES)
def test_make_config_matches_jax(name):
    js, ps, jo, po = _pair(name)
    assert make_config(ps, 64, 32, **po)._asdict() == j_make_config(js, 64, 32, **jo)._asdict()


@pytest.mark.parametrize("name", SCENES)
def test_content_checksum_matches_jax(name):
    js, ps, _, _ = _pair(name)
    assert p_checksum.scene_content_checksum(ps) == j_checksum.scene_content_checksum(js)
    ps.objects[1].position = ps.objects[1].position + 0.5
    assert p_checksum.scene_content_checksum(ps) != j_checksum.scene_content_checksum(js)


def test_sanitize_matches_jax_on_bad_inputs():
    def build(D):
        s = D.SceneData()
        s.camera.field_of_view = float("nan")
        s.objects += [
            D.SphereData(position=np.array([np.inf, 1.0, 2e5]), radius=-1.0,
                         material=D.MaterialData(base_color=np.array([2.0, np.nan, 0.5, 1.0]),
                                                 ior=9.0, absorption=np.array([-1.0, 200.0, 3.0]))),
            D.PlaneData(normal=np.array([0.0, 0.0, 0.0])),
            D.BoxData(size=np.array([0.0, 5.0, np.nan])),
        ]
        s.lights += [D.LightData(intensity=5000.0, radius=np.nan, soft_shadow_samples=40.0)]
        return s

    def flat(x):
        if dataclasses.is_dataclass(x):
            return [flat(getattr(x, f.name)) for f in dataclasses.fields(x)]
        if isinstance(x, list):
            return [flat(v) for v in x]
        return np.asarray(x, dtype=np.float64).tolist() if not isinstance(x, str) else x

    assert flat(sanitize_scene(build(PD))) == flat(j_sanitize(build(JD)))


@pytest.mark.parametrize("name", SCENES)
def test_flat_from_numpy_matches_port_flatten(name):
    js, ps, _, _ = _pair(name)
    jf = j_flatten(j_sanitize(js), frame_index=2)
    bridged = flat_from_numpy(S.jax_leaves(jf))
    own = flatten_scene(sanitize_scene(ps), frame_index=2)
    for name_, a, b in zip(FlatScene._fields, bridged, own):
        assert a.dtype == b.dtype, name_
        np.testing.assert_array_equal(a, b, err_msg=name_)


def test_flat_from_numpy_rejects_mesh_and_missing_leaves():
    leaves = S.jax_leaves(j_flatten(j_sanitize(S.demo_scene(JD))))
    with pytest.raises(NotImplementedError):
        flat_from_numpy(dict(leaves, mesh=np.zeros(3)))
    leaves.pop("cam_pos")
    with pytest.raises(ValueError):
        flat_from_numpy(leaves)


def test_to_device_keeps_values():
    pf = flatten_scene(sanitize_scene(S.demo_scene(PD)), frame_index=2**32 - 1)
    t = to_device(pf, "cpu")
    for name, a, b in zip(FlatScene._fields, pf, t):
        assert torch.is_tensor(b), name
        assert tuple(b.shape) == np.asarray(a).shape, name
        np.testing.assert_array_equal(np.asarray(a).astype(b.numpy().dtype), b.numpy(), err_msg=name)
    assert t.frame_index.dtype == torch.int64 and int(t.frame_index) == 2**32 - 1


def test_mesh_instance_raises_in_flatten_and_make_config_rejects_caustics():
    s = S.demo_scene(PD)
    s.objects.append(PD.MeshObjectData(mesh_name="WineGlass"))
    with pytest.raises(NotImplementedError, match="mesh"):
        flatten_scene(s)
    c = S.demo_scene(PD)
    with pytest.raises(NotImplementedError, match="caustics"):
        make_config(c, 8, 8, enable_caustics=True)
