"""The plain render's counts (ops/render.py::COUNT_ROWS), which the
kernels' counting build must equal on the card (tests/test_torch_gpu.py).

Each scene renders at 24x16 with counts=, while the test counts the same
things itself from what the plain DFS hands to the shading call and the
shadow walks: every lane iteration, items capped at the depth limit or
killed by their throughput, shade calls at depth 0 and deeper, shadow rays
(the lanes each shadow trace is given), misses, glass and other hits, and
the lights that shade an opaque hit by their BRDF (recomputed from the
hit's position and normal). The rays of the CH_RAYS plane are the shade
calls, the shadow rays and the thickness rays. On mesh scenes every shade
call walks the mesh once (as a primary ray at depth 0) and every shadow ray
once.
"""
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu_torch import constants as C
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.ops import intersect, wavefront
from raytracevs_tpu_torch.ops import render as R
from raytracevs_tpu_torch.scene import data as D
from raytracevs_tpu_torch.scene.flatten import flatten_scene, make_config, to_device
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

S.one_torch_thread()

W, H = 24, 16


def _scene(name):
    ms = None
    if name == "glass_ball":
        scene, over = S.glass_ball_scene(D), {"max_soft_samples": 2}
        ms = S.mesh_service(PMC, {"GlassBall": (9, 9, 0.7)})
    elif name == "demo_capped":  # glass paths run into the depth limit
        scene, over = S.demo_scene(D), dict(S.DEMO_OVERRIDES)
        scene.settings.max_bounces = 2
    elif name == "no_lights":  # the legacy light and its shadow ray at depth 0
        scene, over = S.golden_scene(D, "config1_hard_shadows")
        scene.lights.clear()
    else:
        scene, over = S.scene_and_overrides(D, name)
    sc = to_device(flatten_scene(sanitize_scene(scene), aspect=W / H, frame_index=3,
                                 mesh_service=ms), "cpu")
    return sc, make_config(scene, W, H, **over)


def _lit_lights(sc, cfg, rec, depth):
    """Lights that shade each lane's hit by the BRDF, from its position and
    normal: valid, not ambient, facing it; the legacy light at depth 0
    when the scene has none."""
    pos, nrm = rec["position"], rec["normal"]
    if not cfg.has_lights:
        to_l = torch.tensor([3.0, 5.0, -3.0])[None, :] - pos
        fb_l = to_l / torch.clamp(torch.linalg.vector_norm(to_l, dim=-1), min=1e-12)[:, None]
        return ((torch.sum(nrm * fb_l, dim=-1) > 0.0) & (depth == 0)).to(torch.int64)
    lit = torch.zeros(pos.shape[0], dtype=torch.int64)
    for li in range(sc.light_capacity):
        valid = bool((li < sc.num_lights) & sc.lt_valid[li])
        lt = sc.lt_type[li]
        if not valid or int(lt) == C.LIGHT_TYPE_AMBIENT:
            continue
        _, _, ndotl = wavefront._light_geom(sc, pos, nrm, lt, sc.lt_position[li][None, :])
        lit = lit + (ndotl > 0.0).to(torch.int64)
    return lit


@pytest.mark.parametrize("name", ["demo", "demo_capped", "config6_soft_shadows", "no_lights",
                                  "glass_ball"])
def test_plain_counts_equal_a_direct_count(name, monkeypatch):
    sc, cfg = _scene(name)
    direct = torch.zeros((3, 4), dtype=torch.int64)
    shade_and_spawn, trace_shadow = wavefront.shade_and_spawn, intersect.trace_shadow

    def counting_shade(scene, cfg_, px, py, s, cur, traced):
        out = shade_and_spawn(scene, cfg_, px, py, s, cur, traced)
        rec = out[1]
        active = cur.valid
        capped = active & (cur.depth >= cfg_.max_bounces)
        hit = traced & rec["hit_mask"]
        glass = hit & (rec["transmission"] > 0.01)
        opaque = hit & ~glass
        lit = torch.where(opaque, _lit_lights(sc, cfg_, rec, cur.depth), 0)
        direct[0] += torch.stack([active.sum(), torch.tensor(0), capped.sum(),
                                  (active & ~capped & ~traced).sum()])
        direct[1, :2] += torch.stack([(traced & (cur.depth == 0)).sum(),
                                      (traced & (cur.depth != 0)).sum()])
        direct[2] += torch.stack([(traced & ~rec["hit_mask"]).sum(), glass.sum(), opaque.sum(),
                                  lit.sum()])
        return out

    def counting_shadow(scene, o, d, max_dist, active=None):
        direct[1, 2] += int(o.shape[0] if active is None else active.sum())
        return trace_shadow(scene, o, d, max_dist, active=active)

    monkeypatch.setattr(wavefront, "shade_and_spawn", counting_shade)
    monkeypatch.setattr(intersect, "trace_shadow", counting_shadow)
    counts = torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64)
    acc = R.render_accum(sc, cfg, counts=counts)
    rays = int(acc[R.CH_RAYS].double().sum())
    direct[1, 3] = rays - int(direct[1, :3].sum())  # what the plane holds besides
    dfs, ray_row, hits = (counts[R.COUNT_ROWS.index(k)] for k in ("dfs", "rays", "hits"))
    assert torch.equal(torch.stack([dfs, ray_row, hits]), direct), (counts, direct)
    assert int(ray_row.sum()) == rays and int(ray_row[2]) > 0
    if name == "demo_capped":
        assert int(dfs[2]) > 0
    if name in ("demo", "glass_ball"):
        assert int(ray_row[3]) > 0 and int(hits[1]) > 0
    walks = counts[:4]
    if sc.mesh is None:
        assert not bool(walks.any())
    else:
        assert int(walks[:3, 0].sum()) == int(ray_row[:2].sum())
        assert int(walks[0, 0]) == int(ray_row[0]) and int(walks[3, 0]) == int(ray_row[2])
    # the counts do not change the frame
    assert torch.equal(acc, R.render_accum(sc, cfg))


def test_plain_phase_counts_add_up_to_k1s():
    """Phase A's and phase B's counts at spp 1 add up to K1's (the two
    phases run K1's DFS split after iteration 0; phase B re-derives
    iteration 0 without counting it again)."""
    from raytracevs_tpu_torch.ops import twophase as TP

    sc, cfg = _scene("glass_ball")
    k1, ka, kb = (torch.zeros((len(R.COUNT_ROWS), 4), dtype=torch.int64) for _ in range(3))
    R.render_accum(sc, cfg, counts=k1)
    a = R.render_accum_phase_a(sc, cfg, counts=ka)
    order, count = TP.coherence_order(a)
    R.render_accum_phase_b(sc, cfg, order[:int(count)], a[:R.NUM_CH].clone(), a[R.CH_HIT:],
                           counts=kb)
    nw = 4
    assert torch.equal(ka[nw:] + kb[nw:], k1[nw:])
    assert torch.equal((ka[:nw] + kb[:nw])[:, [0, 3]], k1[:nw][:, [0, 3]])
