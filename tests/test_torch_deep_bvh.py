"""A wide table deeper than the kernels' walk stack (ROADMAP C9).

The kernels walk the wide nodes with a per-thread stack of
csrc/closest.cuh::WALK_STACK entries. A mesh whose wide table needs more
(`MeshArrays.wide_stack`) goes to the kernels' threaded instantiations,
which follow the fine tree's hit/miss links and need no stack. The deep
forest of tests/_torch_scenes.py needs 70. Here, on the CPU: the wrapper's
check sends it to the threaded walks and its node table holds the fine
tree; and its plain render equals the JAX package's at 48x24 (ray counts and
object ids exact, HDR colour atol 2e-4 on >= 99% of pixels, the bands of
tests/test_torch_megakernel.py). tests/test_torch_gpu.py holds the threaded
kernels against this plain render on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_scenes as S
from raytracevs_tpu.io import mesh_cache as JMC
from raytracevs_tpu.ops.render import render_rows as j_render_rows
from raytracevs_tpu.scene import data as JD
from raytracevs_tpu.scene.flatten import flatten_scene as j_flatten
from raytracevs_tpu.scene.flatten import make_config as j_make_config
from raytracevs_tpu.scene.sanitize import sanitize_scene as j_sanitize
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.ops import bvh as B
from raytracevs_tpu_torch.ops.cuda import megakernel as MK
from raytracevs_tpu_torch.ops.render_cf import render_rows_cf
from raytracevs_tpu_torch.scene import data as PD
from raytracevs_tpu_torch.scene.flatten import flatten_scene, make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

S.one_torch_thread()

W, H = 48, 24
OVERRIDES = {"max_soft_samples": 2}


def _port_scene():
    scene = S.deep_forest_scene(PD)
    flat = flatten_scene(sanitize_scene(scene), aspect=W / H, frame_index=3,
                         mesh_service=S.deep_forest_service(PMC))
    return scene, to_device(flat, "cpu")


def test_deep_forest_goes_to_the_threaded_walks():
    """The forest needs more stack than the kernels hold; the wrapper's
    check accepts it (it raised before) and picks the threaded walks, whose
    node table is the fine tree's: boxes, then a node's hit link (a leaf's
    triangle range) and miss link."""
    _, sc = _port_scene()
    mesh = sc.mesh
    assert mesh.wide_stack > B.WALK_STACK, mesh.wide_stack
    assert MK.check_mesh(mesh, "test") is True
    nodes, threaded = MK.walk_nodes(mesh, "test")
    assert threaded and nodes.shape == (mesh.num_nodes, 8) and nodes.is_contiguous()
    assert torch.equal(nodes[:, 0:3], mesh.bbox_min) and torch.equal(nodes[:, 3:6], mesh.bbox_max)
    words = nodes[:, 6:8].view(torch.int32)
    leaf = mesh.tri_count > 0
    assert torch.equal(words[:, 1], mesh.miss_next)
    assert torch.equal(words[~leaf, 0], mesh.hit_next[~leaf])
    assert bool((words[leaf, 0] < -1).all())
    assert torch.equal(~words[leaf, 0] >> 3, mesh.tri_start[leaf])
    assert torch.equal(~words[leaf, 0] & 7, mesh.tri_count[leaf])
    tables = MK.pack_tables(sc)
    assert tables.threaded is True and tables.nodes.shape == nodes.shape
    # the mesh demo scene keeps the wide walks
    demo = to_device(flatten_scene(sanitize_scene(S.mesh_demo_scene(PD)), aspect=W / H,
                                   mesh_service=S.mesh_service(PMC, S.MESH_DEMO_SMALL)), "cpu")
    assert MK.check_mesh(demo.mesh, "test") is False
    assert MK.walk_nodes(demo.mesh, "test")[0] is demo.mesh.wide


def test_deep_forest_plain_render_matches_jax():
    scene, sc = _port_scene()
    js = S.deep_forest_scene(JD)
    jf = j_flatten(j_sanitize(js), aspect=W / H, frame_index=3,
                   mesh_service=S.deep_forest_service(JMC))
    jout = j_render_rows(jf, j_make_config(js, W, H, **OVERRIDES), jnp.int32(0), H,
                         backend="jnp")
    jax.block_until_ready(jout.color)
    pout = render_rows_cf(sc, make_config(scene, W, H, **OVERRIDES))
    assert int(pout.rays) == int(jout.rays)
    ids = pout.gbuffer.obj_id.reshape(-1).numpy()
    np.testing.assert_array_equal(ids, np.asarray(jout.gbuffer.obj_id))
    assert (ids >= 3 * 65536).mean() > 0.1  # the forest's triangles fill the frame
    color = pout.color.permute(1, 2, 0).reshape(-1, 3).numpy()
    d = np.abs(color - np.asarray(jout.color)).max(axis=-1)
    assert (d <= 2e-4).mean() >= 0.99, (d.max(), (d > 2e-4).mean())
    assert np.isfinite(color).all()
