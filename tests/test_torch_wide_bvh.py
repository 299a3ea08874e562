"""The wide BVH of the port's mesh walks (raytracevs_tpu_torch/ops/bvh.py::
collapse, combine_blas, wide_table) on the CPU.

The render kernels walk 4-wide nodes collapsed from the fine threaded tree,
with a stack, in the fine tree's preorder. Here a per-ray numpy walker does
what the kernels' walks (csrc/closest.cuh) do over the same table, and must
return what the plain threaded walks (traverse_closest, traverse_shadow)
return, bit for bit. The argument it rests on is checked too: the collapse
keeps every fine leaf once and in preorder, leaves' tri_start increases
along the preorder, a child's box lies inside its parent's (so a wide node's
grandchild fails wherever the binary node the collapse skipped fails), and
the stack bound covers every path. A popped child is re-tested against the
current bound by its entry distance, which decides as the slab test does.

Nearest child first, with ties going to the lower triangle index, is not
exact: a box's slab distance and a triangle's plane distance round apart,
so culling by a nearer bound than the threaded walk's drops triangles it
would find (shown below on rays through shared edges)."""
import numpy as np
import pytest
import torch

import _torch_scenes as S
from raytracevs_tpu_torch.io import mesh_cache as PMC
from raytracevs_tpu_torch.ops import bvh as P
from raytracevs_tpu_torch.scene import data as D
from raytracevs_tpu_torch.scene.flatten import flatten_scene
from raytracevs_tpu_torch.scene.sanitize import sanitize_scene

S.one_torch_thread()

N_RAYS = 1500
F32 = np.float32
BIG = F32(1e30)
FP16_MAX = F32(65504.0)
TMIN, TMAX = F32(1e-3), F32(1e4)
# two instances, one opaque and one absorbing glass (count-mode shadows),
# and nine (multiply mode beyond 8)
FORESTS = {"two": (lambda: S.mesh_demo_scene(D), S.MESH_DEMO_SMALL),
           "nine": (lambda: S.nine_ball_scene(D), {"Ball": (6, 8, 0.3)})}


def _flat(name, frame=0):
    build, meshes = FORESTS[name]
    scene = build()
    if frame:
        for o in scene.objects:
            if isinstance(o, D.MeshObjectData):
                o.transform.position = o.transform.position + np.array([0.1, 0.05, -0.2]) * frame
    return flatten_scene(sanitize_scene(scene), mesh_service=S.mesh_service(PMC, meshes))


def _mesh(name):
    flat = _flat(name)
    return flat.mesh, P.to_device(flat.mesh, "cpu", flat.shadow_absorption_scale)


class Walker:
    """One ray at a time over the wide table, as csrc/closest.cuh walks it:
    a stack of (child word, entry distance); an inner node tests its four
    child boxes, takes the first hit child in visit order and pushes the
    others last-first; a popped entry is re-tested against the current
    bound by its entry distance. Counts node fetches, box and triangle
    tests and the deepest stack."""

    def __init__(self, dm):
        w = dm.wide.numpy()
        self.lo = w[:, 0:12].reshape(-1, 3, 4)
        self.hi = w[:, 12:24].reshape(-1, 3, 4)
        self.child = np.ascontiguousarray(w[:, 24:28]).view(np.int32)
        self.plane = dm.plane.numpy()
        self.inst = dm.inst.numpy()
        self.trans = dm.inst_transmission.numpy()
        self.beer = dm.inst_beer.numpy()
        self.fetches = self.boxes = self.tris = self.deepest = 0

    def _slabs(self, node, o, inv, bound):
        t0 = (self.lo[node] - o[:, None]) * inv[:, None]
        t1 = (self.hi[node] - o[:, None]) * inv[:, None]
        lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
        tn = np.maximum(np.maximum(np.maximum(lo[0], lo[1]), lo[2]), TMIN)
        tf = np.minimum(np.minimum(np.minimum(hi[0], hi[1]), hi[2]), bound)
        live = self.child[node] != P.CHILD_EMPTY
        self.fetches += 1
        self.boxes += int(live.sum())
        return live & (tn <= tf), tn

    def _tris(self, word, o, d, tmin):
        v = ~int(word)
        ti = np.clip((v >> 3) + np.arange(v & 7), 0, len(self.inst) - 1)
        r = self.plane[ti]
        nd = r[:, 0] * d[0] + r[:, 1] * d[1] + r[:, 2] * d[2]
        no = r[:, 0] * o[0] + r[:, 1] * o[1] + r[:, 2] * o[2]
        ok = np.abs(nd) > F32(1e-9)
        t = (r[:, 3] - no) / np.where(ok, nd, F32(1.0))
        hx = [o[i] + t * d[i] for i in range(3)]
        u = r[:, 4] * hx[0] + r[:, 5] * hx[1] + r[:, 6] * hx[2] + r[:, 7]
        vv = r[:, 8] * hx[0] + r[:, 9] * hx[1] + r[:, 10] * hx[2] + r[:, 11]
        base = ok & (u >= 0) & (vv >= 0) & (u + vv <= F32(1.0)) & (t >= tmin)
        self.tris += len(ti)
        return ti, t, u, vv, base

    def _walk(self, o, d, nearest, bound, leaf):
        """Visit the leaves: `bound()` is the current box bound, `leaf(word)`
        tests a leaf and returns True to end the walk."""
        if not (np.isfinite(o).all() and np.isfinite(d).all()):
            return
        inv = F32(1.0) / np.where(np.abs(d) < F32(1e-12),
                                  np.where(d < 0, F32(-1e-12), F32(1e-12)), d)
        stack, node = [], 0

        def pop():
            while stack:
                c, t = stack.pop()
                if t <= bound():
                    return c
            return P.CHILD_EMPTY

        while node != P.CHILD_EMPTY:
            if node >= 0:
                hit, tn = self._slabs(node, o, inv, bound())
                ks = [k for k in range(4) if hit[k]]
                if nearest:
                    ks.sort(key=lambda k: tn[k])
                for k in reversed(ks[1:]):
                    stack.append((self.child[node, k], tn[k]))
                self.deepest = max(self.deepest, len(stack))
                node = self.child[node, ks[0]] if ks else pop()
            else:
                if leaf(node):
                    return
                node = pop()

    def closest(self, o, d, skip_active, skip_inst, thick_inst, nearest=False):
        """The kernels' closest walk; with nearest, lanes without a
        pending thickness query go nearest child first instead."""
        r = dict(t=TMAX, u=F32(0), v=F32(0), tri=0, thick_t=BIG, thick_hit=False)
        def bound():
            return BIG if thick_inst >= 0 and not r["thick_hit"] else r["t"]

        def leaf(word):
            pend = thick_inst >= 0 and not r["thick_hit"]
            ti, t, u, v, base = self._tris(word, o, d, TMIN)
            for k in range(len(ti)):
                tt = t[k]
                if not (base[k] and tt <= (BIG if pend else r["t"])):
                    continue
                it = self.inst[ti[k]]
                if it == thick_inst and tt < r["thick_t"]:
                    r["thick_t"], r["thick_hit"] = tt, True
                if skip_active and it == skip_inst:
                    continue
                if tt < r["t"] or (tt == r["t"] and ti[k] < r["tri"]):  # the tie rule
                    r.update(t=tt, tri=int(ti[k]), u=u[k], v=v[k])
            return False

        self._walk(o, d, nearest and thick_inst < 0, bound, leaf)
        return r

    def shadow(self, o, d, max_dist, blocked):
        n_inst = len(self.trans)
        count_mode = n_inst <= 8
        r = dict(blocked=bool(blocked), occ=FP16_MAX, vis=F32(1), color=np.ones(3, F32),
                 cnt=np.zeros(n_inst, np.int64))

        def leaf(word):
            ti, t, _, _, base = self._tris(word, o, d, TMIN)
            for k in range(len(ti)):
                tt = t[k]
                if not (base[k] and tt <= max_dist):
                    continue
                it = self.inst[ti[k]]
                tr = self.trans[it]
                if tr < F32(0.01):
                    r["blocked"] = True
                r["occ"] = min(r["occ"], tt)
                if count_mode:
                    r["cnt"][it] += 1
                elif tr >= F32(0.01):
                    r["vis"] = r["vis"] * tr
                    r["color"] = r["color"] * self.beer[it]
            return r["blocked"]

        if not blocked:
            self._walk(o, d, False, lambda: max_dist, leaf)
        if count_mode:
            vis, col = F32(1), np.ones(3, F32)
            for i in range(n_inst):
                n_i = 0 if self.trans[i] < F32(0.01) else int(r["cnt"][i])
                vis = vis * _pow_u8(self.trans[i], n_i)
                col = col * np.array([_pow_u8(b, n_i) for b in self.beer[i]], F32)
            r["vis"], r["color"] = vis, col
        if r["blocked"]:
            r["vis"], r["color"] = F32(0), np.zeros(3, F32)
        return r


def _pow_u8(base, n):
    r, b = F32(1), F32(base)
    for bit in range(8):
        if (n >> bit) & 1:
            r = r * b
        if bit < 7:
            b = b * b
    return r


def _rays(mesh, seed, n=N_RAYS):
    """Rays from outside toward points near random triangles, rays from
    inside the instances in random directions, and rays aimed at the middle
    of a triangle's edge, where two triangles tie."""
    rng = np.random.RandomState(seed)
    tri = rng.randint(0, mesh.num_tris, n)
    v0, e1, e2 = mesh.v0[tri], mesh.edge1[tri], mesh.edge2[tri]
    k = n // 3
    target = v0 + 0.3 * e1 + 0.3 * e2 + rng.randn(n, 3).astype(F32) * 0.1
    edge = rng.randint(0, 3, n)
    mid = np.where((edge == 0)[:, None], v0 + 0.5 * e1,
                   np.where((edge == 1)[:, None], v0 + 0.5 * e2, v0 + 0.5 * (e1 + e2)))
    target[2 * k:] = mid[2 * k:]
    o = target + rng.randn(n, 3) * 0.5 + np.array([0.0, 0.5, -2.5])
    o[k:2 * k] = v0[k:2 * k] + rng.randn(k, 3) * 0.02
    d = target - o
    d[k:2 * k] = rng.randn(k, 3)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(F32), d.astype(F32)


def _leaves_in_preorder(child, node=0):
    for c in child[node]:
        if c >= 0:
            yield from _leaves_in_preorder(child, c)
        elif c != P.CHILD_EMPTY:
            yield ~int(c)


def _path_need(child, node=0):
    """The deepest stack over root-to-leaf paths, by enumeration."""
    kids = [c for c in child[node] if c != P.CHILD_EMPTY]
    return len(kids) - 1 + max([_path_need(child, c) for c in kids if c >= 0], default=0)


@pytest.mark.parametrize("name", list(FORESTS))
def test_collapse_keeps_every_leaf_in_preorder(name):
    """Every fine leaf once, in the fine preorder; child boxes are the fine
    boxes bit for bit (top slots bound their instances' roots); tri_start
    increases along the preorder; a child box lies inside its parent's; the
    stack bound is the deepest path's."""
    mesh, dm = _mesh(name)
    leaf = np.nonzero(mesh.tri_count > 0)[0]
    want = [int(s) << 3 | int(c) for s, c in zip(mesh.tri_start[leaf], mesh.tri_count[leaf])]
    topo = mesh.wide_topology
    assert list(_leaves_in_preorder(topo.child)) == want
    assert (np.diff(mesh.tri_start[leaf]) > 0).all()
    assert int(mesh.tri_count.max()) <= P.LEAF_SIZE and int(mesh.tri_count[leaf].min()) >= 1

    w = dm.wide.numpy()
    lo, hi = w[:, 0:12].reshape(-1, 3, 4), w[:, 12:24].reshape(-1, 3, 4)
    src = topo.src
    for k in range(4):
        m = src[:, k] >= 0
        np.testing.assert_array_equal(lo[m, :, k], mesh.bbox_min[src[m, k]])
        np.testing.assert_array_equal(hi[m, :, k], mesh.bbox_max[src[m, k]])
    n_inst = mesh.num_inst
    assert len(topo.union) == (0 if n_inst <= 4 else 2)
    for row in topo.union:
        wk, roots = divmod(int(row[0]), 4), row[1:]
        np.testing.assert_array_equal(lo[wk[0], :, wk[1]], mesh.bbox_min[roots].min(0))
        np.testing.assert_array_equal(hi[wk[0], :, wk[1]], mesh.bbox_max[roots].max(0))
    assert mesh.wide_stack == topo.need == _path_need(topo.child) <= P.WALK_STACK

    # containment along the fine tree: a child box inside its parent's, so a
    # wide node's grandchild fails wherever the skipped binary node fails
    inner = np.nonzero(mesh.tri_count == 0)[0]
    end = np.where(mesh.miss_next >= 0, mesh.miss_next, len(mesh.miss_next))
    for kid in (inner + 1, end[inner + 1]):
        assert (mesh.bbox_min[kid] >= mesh.bbox_min[inner]).all()
        assert (mesh.bbox_max[kid] <= mesh.bbox_max[inner]).all()


def test_blas_cache_keeps_the_topology_across_a_transform_edit():
    """A transform edit retransforms without an SAH build; the combined
    table equals a fresh collapse of the new forest, and so do the gathered
    boxes, also for a mesh without the wide fields (the bridge's)."""
    build, meshes = FORESTS["two"]
    svc = S.mesh_service(PMC, meshes)
    cache = P.BLASCache()
    scenes = [build(), build()]
    scenes[1].objects[-1].transform.position = np.array([-0.9, 0.8, -1.5])
    flats = [flatten_scene(sanitize_scene(s), mesh_service=svc, blas_cache=cache) for s in scenes]
    assert cache.build_count == 2  # two meshes, each built once
    a, b = flats[0].mesh, flats[1].mesh
    assert not np.array_equal(a.bbox_min, b.bbox_min)
    fresh = P.collapse(b.tri_start, b.tri_count, b.miss_next)
    assert a.wide_topology is b.wide_topology  # kept, with its device upload
    for f in ("child", "src", "union"):
        np.testing.assert_array_equal(getattr(b.wide_topology, f), getattr(fresh, f))
    assert b.wide_stack == fresh.need
    scale = flats[1].shadow_absorption_scale
    dm = P.to_device(b, "cpu", scale)
    bare = b._replace(wide_topology=None)
    bits = dm.wide.view(torch.int32)  # child words as floats may be NaNs
    assert torch.equal(P.to_device(bare, "cpu", scale).wide.view(torch.int32), bits)
    want = P.wide_table(*(torch.from_numpy(x) for x in (
        np.concatenate([fresh.child, fresh.src], axis=1), fresh.union, b.bbox_min, b.bbox_max)))
    assert torch.equal(want.view(torch.int32), bits)


def _closest_args(mesh, seed):
    o, d = _rays(mesh, seed)
    rng = np.random.RandomState(seed + 100)
    skip = rng.rand(N_RAYS) < 0.3
    inst = rng.randint(0, mesh.num_inst, N_RAYS).astype(np.int32)
    thick = np.where(rng.rand(N_RAYS) < 0.3, rng.randint(0, mesh.num_inst, N_RAYS),
                     -1).astype(np.int32)
    return o, d, skip, inst, thick


@pytest.mark.parametrize("name", list(FORESTS))
def test_wide_closest_walk_equals_traverse_closest(name):
    """The preorder walk over the wide table against the threaded walk:
    t, tri, u, v, inst, thick_hit, thick_t bit for bit, with skip-self
    lanes, pending thickness queries and rays through shared edges; the
    wide walk fetches fewer nodes and tests the same triangles."""
    mesh, dm = _mesh(name)
    o, d, skip, inst, thick = _closest_args(mesh, seed=11)
    counts = torch.zeros((4, 4), dtype=torch.int64)
    want = P.traverse_closest(dm._replace(walk_counts=counts), torch.from_numpy(o),
                              torch.from_numpy(d), torch.full((N_RAYS,), float(TMIN)),
                              torch.full((N_RAYS,), float(TMAX)),
                              skip_active=torch.from_numpy(skip), skip_inst=torch.from_numpy(inst),
                              thick_inst=torch.from_numpy(thick))
    w = Walker(dm)
    got = [w.closest(o[i], d[i], skip[i], inst[i], thick[i]) for i in range(N_RAYS)]
    t = torch.tensor(np.array([g["t"] for g in got], F32))
    tri = torch.tensor([g["tri"] for g in got], dtype=torch.int32)
    assert torch.equal(t, want.t)
    assert torch.equal(tri, want.tri)
    assert torch.equal(torch.tensor(np.array([g["u"] for g in got], F32)), want.u)
    assert torch.equal(torch.tensor(np.array([g["v"] for g in got], F32)), want.v)
    assert torch.equal(dm.inst[tri.long()], want.inst)
    assert torch.equal(torch.tensor([g["thick_hit"] for g in got]), want.thick_hit)
    assert torch.equal(torch.tensor(np.array([g["thick_t"] for g in got], F32)), want.thick_t)
    assert torch.equal(t < TMAX * F32(0.9999), want.hit)
    assert 0.3 < float(want.hit.float().mean()) < 1.0 and bool(want.thick_hit.any())
    assert w.deepest <= mesh.wide_stack
    assert w.fetches < int(counts[:, 1].sum())  # threaded: one node a step
    assert w.tris == int(counts[:, 3].sum())


def test_nearest_first_order_is_not_exact():
    """Why the kernels keep the preorder for closest hits: nearest child
    first with ties to the lower triangle index returns another triangle
    than the threaded walk on some rays through shared edges, though it
    fetches fewer nodes."""
    mesh, dm = _mesh("two")
    o, d, skip, inst, thick = _closest_args(mesh, seed=11)
    want = P.traverse_closest(dm, torch.from_numpy(o), torch.from_numpy(d),
                              torch.full((N_RAYS,), float(TMIN)),
                              torch.full((N_RAYS,), float(TMAX)),
                              skip_active=torch.from_numpy(skip), skip_inst=torch.from_numpy(inst),
                              thick_inst=torch.from_numpy(thick))
    near, pre = Walker(dm), Walker(dm)
    got = [near.closest(o[i], d[i], skip[i], inst[i], thick[i], nearest=True)
           for i in range(N_RAYS)]
    for i in range(N_RAYS):
        pre.closest(o[i], d[i], skip[i], inst[i], thick[i])
    tri = np.array([g["tri"] for g in got])
    wrong = tri != want.tri.numpy()
    assert 0 < int(wrong.sum()) < 10 and (thick[wrong] < 0).all()
    assert near.fetches < pre.fetches


@pytest.mark.parametrize("name,blocked_share", [("two", 0.1), ("nine", 0.1), ("nine", 0.0)])
def test_wide_shadow_walk_equals_traverse_shadow(name, blocked_share):
    """Preorder shadow walks against the threaded walk: count mode (two
    instances, one opaque) and multiply mode (nine), blocked seeds and
    none; visibility, colour and occluder distance bit for bit."""
    mesh, dm = _mesh(name)
    o, d = _rays(mesh, seed=21)
    rng = np.random.RandomState(22)
    max_dist = (rng.rand(N_RAYS) * 6.0 + 0.2).astype(F32)
    blocked = rng.rand(N_RAYS) < blocked_share
    vis, col, occ = P.traverse_shadow(dm, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(max_dist),
                                      blocked0=torch.from_numpy(blocked))
    w = Walker(dm)
    got = [w.shadow(o[i], d[i], max_dist[i], blocked[i]) for i in range(N_RAYS)]
    assert torch.equal(torch.tensor(np.array([g["vis"] for g in got], F32)), vis)
    assert torch.equal(torch.tensor(np.array([g["color"] for g in got], F32)), col)
    assert torch.equal(torch.tensor(np.array([g["occ"] for g in got], F32)), occ)
    v, c = vis.numpy(), col.numpy()
    assert (v == 0.0).any() and (v == 1.0).any()
    assert ((v > 0.0) & (c.min(axis=1) < 1.0)).any()  # translucent, absorbing crossings
    assert w.deepest <= mesh.wide_stack


def test_walk_counts_classes_and_default_output():
    """A mesh with walk_counts gets per class what the walks did, and the
    walks' output is the same as without them."""
    mesh, dm = _mesh("two")
    o, d, skip, inst, thick = _closest_args(mesh, seed=31)
    rays = (torch.from_numpy(o), torch.from_numpy(d))
    lims = (torch.full((N_RAYS,), float(TMIN)), torch.full((N_RAYS,), float(TMAX)))
    kw = dict(skip_active=torch.from_numpy(skip), skip_inst=torch.from_numpy(inst),
              thick_inst=torch.from_numpy(thick))
    plain = P.traverse_closest(dm, *rays, *lims, **kw)
    cls = torch.from_numpy((np.arange(N_RAYS) % 2).astype(np.int64))
    counts = torch.zeros((4, 4), dtype=torch.int64)
    cm = dm._replace(walk_counts=counts)
    counted = P.traverse_closest(cm, *rays, *lims, **kw, count_class=cls)
    P.traverse_shadow(cm, *rays, torch.full((N_RAYS,), 3.0))
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    pend = thick >= 0
    walks = [int(((np.arange(N_RAYS) % 2 == c) & ~pend).sum()) for c in (0, 1)]
    assert counts[:, 0].tolist() == walks + [int(pend.sum()), N_RAYS]
    assert (counts[:, 1] == counts[:, 2]).all() and (counts[:, 1:] > 0).all()
