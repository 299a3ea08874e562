"""Triangle-mesh BVH: the host build and the plain PyTorch walks.

Restates raytracevs_tpu/ops/bvh.py. The host half builds one object-space
BLAS per mesh with the native binned-SAH builder (io/native.py), retransforms
it per instance and chains the instances into one threaded forest (the
reference's BLAS cache and combined TLAS, AccelerationStructure.cpp:560-848).
The device half walks the fine LEAF_SIZE-4 tree stacklessly through its
`hit_next`/`miss_next` links: closest hit with skip-self and the fused
same-instance thickness, the shadow walks (per-instance crossing counts for
up to 8 instances, a product per crossing beyond), the standalone thickness
walk and the shading normal. These walks are the plain versions of the
mesh walks of the render kernels (csrc/closest.cuh), which return what they
return bit for bit; both read the triangle plane table and the per-instance
shadow factors that `to_device` computes on the device, once per change of
the mesh tables (BLASCache.device_tables).

The kernels walk a wide form of the same tree: `collapse` turns each BLAS's
binary tree into nodes of up to four children (topology only, once per
BLAS, kept in the BLASCache entry), `combine_blas` puts the instances' wide
roots under top nodes in chain order, and `to_device` gathers each child's
box from the retransformed fine boxes, bit for bit, whenever it runs.

The JAX package's fat-leaf tree (`mk_*`, `collapse_leaves`, 8-per-row
packing) and the RTVS_PRESPLIT builder are TPU layout devices and are not
part of the port.

Each walk here runs on the lanes still walking only: every few steps the
finished lanes are written back and dropped (`_walk`), so a 1080p frame's
late steps touch a few thousand lanes instead of two million. Per lane the
arithmetic and the visit order are those of the JAX walk. Given a
MeshArrays with `walk_counts`, the walks also add up their node fetches and
triangle tests there by ray class (`WALK_CLASSES`), as the kernels'
counting build does into its Mesh::counts.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as C
from . import vec

LEAF_SIZE = 4
_END = -1
_BIG = 1e30
_COMPACT_EVERY = 4  # walk steps between two compactions of the live lanes
WIDE = 4  # children of a wide node
WALK_STACK = 64  # entries of the kernels' walk stack (csrc/closest.cuh::WALK_STACK)
CHILD_EMPTY = -1  # the child word of an empty slot
# ray classes of the walk counts (csrc/closest.cuh::WC_*): closest walks of
# primary rays, of other rays, of rays with a pending thickness query; shadow
WALK_CLASSES = ("primary", "secondary", "thickness", "shadow")


@dataclass
class WideTopology:
    """Wide nodes of a tree or forest, topology only (`collapse`). Node 0
    is the root. A child word is a wide node index (>= 0), a leaf
    ~(tri_start << 3 | tri_count), or CHILD_EMPTY."""

    child: np.ndarray  # [W,4] i32 child words, in the fine tree's left-to-right order
    src: np.ndarray  # [W,4] i32 the fine node whose box each slot takes (-1: empty or union)
    union: np.ndarray  # [U,1+K] i32 per top slot: its flat slot index w*4+k, then the fine
    #                    roots whose boxes it bounds (padded by repeating the last)
    need: int  # the deepest stack a walk can need: over root-to-leaf paths, the sum of
    #            (children - 1) of the wide nodes on the path
    _on: dict = field(default_factory=dict, repr=False, compare=False)

    def on(self, device):
        """(topology [W,8] i32: child, then src; union) as tensors on
        `device`, uploaded at the first call for that device."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = (
                torch.from_numpy(np.concatenate([self.child, self.src], axis=1)).to(device),
                torch.from_numpy(self.union).to(device))
        return self._on[key]


@dataclass
class BuiltBVH:
    """Host-side build result (numpy), nodes in DFS preorder."""

    bbox_min: np.ndarray  # [Nn,3]
    bbox_max: np.ndarray  # [Nn,3]
    hit_next: np.ndarray  # [Nn] next node if the AABB is hit (leaf: == miss_next)
    miss_next: np.ndarray  # [Nn] next node if missed (-1 = done)
    tri_start: np.ndarray  # [Nn] leaf triangle range start (internal: 0)
    tri_count: np.ndarray  # [Nn] leaf triangle count (internal: 0)
    v0: np.ndarray  # [T,3] leaf-ordered triangle soup
    edge1: np.ndarray  # [T,3]
    edge2: np.ndarray  # [T,3]
    n0: np.ndarray  # [T,3] smooth vertex normals
    n1: np.ndarray
    n2: np.ndarray
    inst: np.ndarray  # [T] instance index (material lookup)
    wide: WideTopology  # the wide nodes of the kernels' walks


def _collapse_trees(tri_start, tri_count, miss_next, roots):
    """The wide nodes of the fine trees at `roots`, one per root, built by
    the host library (io/native.py::collapse_bvh_native): each wide node
    holds its binary node's two children, then opens the inner child with
    the most triangles (the leftmost on ties) in place until it has WIDE
    children or only leaves. Topology only, so every retransform of a tree
    shares it. Returns [(child [W,4], src [W,4], need)] with each tree's own
    wide indices and the fine arrays' node and triangle indices."""
    from ..io import native

    return [native.collapse_bvh_native(tri_start, tri_count, miss_next, r, WIDE)
            for r in roots]


def _assemble(trees, fine_roots) -> WideTopology:
    """One wide table of per-instance trees (`_collapse_trees`' form, node
    and triangle indices already the forest's): top nodes over the
    instances' wide roots in chain order, up to WIDE a node, each top slot
    bounding its instances' fine root boxes; then instance 0's nodes,
    instance 1's, ..."""
    if len(trees) == 1:
        child, src, need = trees[0]
        return WideTopology(child=child, src=src, union=np.zeros((0, 2), np.int32), need=need)
    top = []  # per top node: [(kind, value, first instance, end instance)]

    def build(a, b):
        t = len(top)
        top.append(None)
        part = 1
        while part * WIDE < b - a:
            part *= WIDE
        top[t] = [("inst", s, s, s + 1) if min(s + part, b) - s == 1
                  else ("top", build(s, min(s + part, b)), s, min(s + part, b))
                  for s in range(a, b, part)]
        return t

    build(0, len(trees))
    offsets = np.cumsum([len(top)] + [len(c) for c, _, _ in trees]).tolist()
    child = np.full((len(top), WIDE), CHILD_EMPTY, np.int32)
    src = np.full((len(top), WIDE), -1, np.int32)
    union, top_need = [], [0] * len(top)
    for t in reversed(range(len(top))):
        needs = []
        for k, (kind, v, a, b) in enumerate(top[t]):
            if kind == "inst":
                child[t, k], src[t, k] = offsets[v], fine_roots[v]
                needs.append(trees[v][2])
            else:
                child[t, k] = v
                union.append([t * WIDE + k] + list(fine_roots[a:b]))
                needs.append(top_need[v])
        top_need[t] = len(top[t]) - 1 + max(needs)
    k_max = max((len(u) for u in union), default=2)
    union = np.asarray([u + [u[-1]] * (k_max - len(u)) for u in union],
                       np.int32).reshape(-1, k_max)
    inst_child = [np.where(c >= 0, c + off, c).astype(np.int32)
                  for (c, _, _), off in zip(trees, offsets)]
    return WideTopology(child=np.concatenate([child] + inst_child),
                        src=np.concatenate([src] + [s for _, s, _ in trees]),
                        union=union, need=top_need[0])


def _forest_roots(miss_next):
    """The instance roots of a chained forest: node 0, then each root's
    miss link, which combine_blas points at the next instance's root."""
    roots, r = [], 0
    while 0 <= r < len(miss_next):
        roots.append(r)
        r = int(miss_next[r])
    return roots


def collapse(tri_start, tri_count, miss_next) -> WideTopology:
    """The wide table of a fine tree or chained forest (`combine_blas`
    builds the same table from its BLASes' cached trees)."""
    roots = _forest_roots(miss_next)
    return _assemble(_collapse_trees(tri_start, tri_count, miss_next, roots), roots)


def build_bvh(v0, v1, v2, n0, n1, n2, inst) -> BuiltBVH:
    """Threaded BVH over world-space triangles, built by the native
    binned-SAH builder (raytracevs_tpu/ops/bvh.py::build_bvh, native path),
    with its wide nodes (`collapse`)."""
    from ..io import native

    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    if len(v0) == 0:
        raise ValueError("empty triangle list")
    bbox_min, bbox_max, hit_next, miss_next, tri_start, tri_count, order = (
        native.build_bvh_native(v0, v1, v2, LEAF_SIZE))
    o = order.astype(np.int64)
    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)
    return BuiltBVH(
        bbox_min=bbox_min, bbox_max=bbox_max, hit_next=hit_next, miss_next=miss_next,
        tri_start=tri_start, tri_count=tri_count,
        v0=v0[o], edge1=e1[o], edge2=e2[o],
        n0=np.asarray(n0, np.float32)[o], n1=np.asarray(n1, np.float32)[o],
        n2=np.asarray(n2, np.float32)[o], inst=np.asarray(inst, np.int32)[o],
        wide=collapse(tri_start, tri_count, miss_next))


def _same_memory(held, arrays) -> bool:
    """Whether each array of `arrays` views the memory of its `held` array
    the same way. The held arrays keep their memory alive, so no new array
    can reuse its address."""
    def key(a):
        return a.__array_interface__["data"][0], a.shape, a.strides, a.dtype

    return all(key(a) == key(b) for a, b in zip(held, arrays))


class BLASCache:
    """An Engine's mesh caches, each bounded (an entry per mesh name, per
    instance slot, or the last one): object-space BLASes by mesh name (the
    reference's name-keyed BLAS cache, AccelerationStructure.cpp:560-663),
    world-space instances by slot, the last forest with its MeshArrays, and
    the last device tables. The SAH build runs once per mesh; only a moved
    instance is retransformed (`transform_blas`); an update that moves no
    instance reuses the forest, and one that changes nothing of the mesh
    tables reuses their device copy, with no upload.

    A content fingerprint (crc32) rebuilds a name whose geometry changed.
    It runs once per array object that the mesh service hands out: the
    cache holds the arrays and knows them again by their memory, so a new
    CachedMesh, or a new array assigned to one, is fingerprinted again. A
    write into a mesh's arrays in place is not seen; no caller writes so."""

    def __init__(self):
        self._cache: dict = {}  # name -> (fingerprint, object-space BLAS)
        self._seen: dict = {}  # name -> the arrays fingerprinted last
        self._world: list = []  # per instance slot: (BLAS, transform key, world BLAS)
        self._arrays = ((), None, None)  # (world BLASes, material key, their MeshArrays)
        self._device = (None, None, None)  # (host MeshArrays, device key, device tables)
        self._combined = ((), None)  # (the BLASes' wide trees, their combine_wide)
        self.build_count = 0  # SAH builds performed
        self.retransform_count = 0  # instances retransformed
        self.combine_count = 0  # forests combined
        self.upload_count = 0  # device mesh tables built (uploads)

    def get(self, name: str, cached_mesh) -> BuiltBVH:
        arrays = tuple(np.asarray(a) for a in (cached_mesh.positions, cached_mesh.normals,
                                                cached_mesh.indices))
        seen = self._seen.get(name)
        if name in self._cache and seen is not None and _same_memory(seen, arrays):
            return self._cache[name][1]
        pos_a, nrm_a, idx = (np.ascontiguousarray(a) for a in arrays)
        fp = (pos_a.size, idx.size, zlib.crc32(pos_a.tobytes()), zlib.crc32(nrm_a.tobytes()),
              zlib.crc32(idx.tobytes()))
        self._seen[name] = arrays
        entry = self._cache.get(name)
        if entry is None or entry[0] != fp:
            pos = np.asarray(cached_mesh.positions, np.float32)
            nrm = np.asarray(cached_mesh.normals, np.float32)
            tris = np.asarray(cached_mesh.indices).reshape(-1, 3).astype(np.int64)
            blas = build_bvh(pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]],
                             nrm[tris[:, 0]], nrm[tris[:, 1]], nrm[tris[:, 2]],
                             np.zeros(len(tris), np.int32))
            self.build_count += 1
            self._cache[name] = (fp, blas)  # one entry per name: bounded
        return self._cache[name][1]

    def instances(self, blas_list, matrices) -> list:
        """[transform_blas(blas, m4, slot)] of the instance slots, each
        computed again only when its object-space BLAS or its transform's
        bytes changed since the last call; the others are the same objects."""
        del self._world[len(blas_list):]
        worlds = []
        for slot, (blas, m4) in enumerate(zip(blas_list, matrices)):
            m4 = np.asarray(m4)
            key = (m4.dtype.str, m4.shape, m4.tobytes())
            if slot == len(self._world):
                self._world.append(None)
            entry = self._world[slot]
            if entry is None or entry[0] is not blas or entry[1] != key:
                entry = (blas, key, transform_blas(blas, m4, slot))
                self._world[slot] = entry
                self.retransform_count += 1
            worlds.append(entry[2])
        return worlds

    def mesh_arrays(self, worlds, inst_transmission, inst_absorption) -> MeshArrays:
        """mesh_arrays(combine_blas(worlds), ...), made again only when a
        world BLAS is not the last call's or the materials changed."""
        trans = np.asarray(inst_transmission, np.float32)
        absorb = np.asarray(inst_absorption, np.float32)
        key = (trans.shape, trans.tobytes(), absorb.shape, absorb.tobytes())
        last, last_key, arrays = self._arrays
        if (len(last) != len(worlds) or any(a is not b for a, b in zip(last, worlds))
                or last_key != key):
            forest = combine_blas(worlds, wide=self.combined_wide(worlds))
            arrays = mesh_arrays(forest, trans, absorb)
            self._arrays = (tuple(worlds), key, arrays)
            self.combine_count += 1
        return arrays

    def device_tables(self, mesh: MeshArrays, device, shadow_absorption_scale) -> MeshArrays:
        """to_device(mesh, device, shadow_absorption_scale), built again
        only when the host MeshArrays is not the last call's or the device
        or scale changed. The render reads the device tables and writes
        none of them, so frames may share them."""
        key = (str(torch.device(device)),
               np.asarray(shadow_absorption_scale, np.float32).tobytes())
        if self._device[0] is not mesh or self._device[1] != key:
            self._device = (mesh, key, to_device(mesh, device, shadow_absorption_scale))
            self.upload_count += 1
        return self._device[2]

    def release(self):
        """Drop the instances, the forest and its device tables (a scene
        update with no mesh instance); the object-space BLASes stay."""
        self._world.clear()
        self._arrays = ((), None, None)
        self._device = (None, None, None)
        self._combined = ((), None)

    def combined_wide(self, blas_list) -> WideTopology:
        """combine_wide(blas_list), computed again only when the BLASes'
        wide trees differ from the last call's (a retransform keeps them),
        so its device upload (WideTopology.on) is kept too."""
        trees = tuple(b.wide for b in blas_list)
        last, wide = self._combined
        if len(last) != len(trees) or any(a is not b for a, b in zip(last, trees)):
            wide = combine_wide(blas_list)
            self._combined = (trees, wide)
        return wide


def transform_blas(b: BuiltBVH, m4: np.ndarray, inst_index: int) -> BuiltBVH:
    """World-space copy of an object-space BLAS under a row-vector TRS m4:
    triangles map linearly, normals by the inverse transpose, node AABBs by
    bounding their 8 transformed corners; the topology is untouched, so a
    transform edit costs no SAH rebuild."""
    M = np.asarray(m4[:3, :3], np.float64)
    t = np.asarray(m4[3, :3], np.float64)
    nmat = np.linalg.inv(M).T

    v0 = (b.v0.astype(np.float64) @ M + t).astype(np.float32)
    e1 = (b.edge1.astype(np.float64) @ M).astype(np.float32)
    e2 = (b.edge2.astype(np.float64) @ M).astype(np.float32)

    def xn(n):
        w = n.astype(np.float64) @ nmat
        ln = np.linalg.norm(w, axis=1, keepdims=True)
        return (w / np.where(ln < 1e-12, 1.0, ln)).astype(np.float32)

    lo, hi = b.bbox_min.astype(np.float64), b.bbox_max.astype(np.float64)
    new_lo = np.full_like(lo, np.inf)
    new_hi = np.full_like(hi, -np.inf)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                corner = np.stack([hi[:, 0] if cx else lo[:, 0], hi[:, 1] if cy else lo[:, 1],
                                   hi[:, 2] if cz else lo[:, 2]], axis=1)
                w = corner @ M + t
                new_lo = np.minimum(new_lo, w)
                new_hi = np.maximum(new_hi, w)

    return BuiltBVH(
        bbox_min=new_lo.astype(np.float32), bbox_max=new_hi.astype(np.float32),
        hit_next=b.hit_next, miss_next=b.miss_next, tri_start=b.tri_start,
        tri_count=b.tri_count, v0=v0, edge1=e1, edge2=e2,
        n0=xn(b.n0), n1=xn(b.n1), n2=xn(b.n2), inst=np.full(len(b.v0), inst_index, np.int32),
        wide=b.wide)


def combine_wide(blas_list) -> WideTopology:
    """The wide table of combine_blas(blas_list)'s forest from its BLASes'
    cached wide trees: each tree's node and triangle indices moved to the
    forest's, the instances under top nodes in chain order."""
    if len(blas_list) == 1:
        return blas_list[0].wide
    node_off = np.cumsum([0] + [len(b.bbox_min) for b in blas_list])
    tri_off = np.cumsum([0] + [len(b.v0) for b in blas_list])

    def tree(b, i):
        c = b.wide.child
        c = np.where(c < CHILD_EMPTY, ~((~c) + (int(tri_off[i]) << 3)), c).astype(np.int32)
        return c, np.where(b.wide.src >= 0, b.wide.src + node_off[i], -1).astype(np.int32), \
            b.wide.need

    return _assemble([tree(b, i) for i, b in enumerate(blas_list)],
                     [int(x) for x in node_off[:-1]])


def combine_blas(blas_list, wide=None) -> BuiltBVH:
    """Chain world-space BLASes into one traversable forest: instance i's
    exit links retarget to instance i+1's root (a linear TLAS, the
    reference's combined TLAS analog, AccelerationStructure.cpp:665-848).
    Its wide table is `wide` when given (BLASCache.combined_wide), else
    combine_wide(blas_list)."""
    if len(blas_list) == 1:
        return blas_list[0]
    node_off = np.cumsum([0] + [len(b.bbox_min) for b in blas_list])
    tri_off = np.cumsum([0] + [len(b.v0) for b in blas_list])

    def links(b, i):
        nxt = node_off[i + 1] if i + 1 < len(blas_list) else _END
        hit = np.where(b.hit_next == _END, nxt, b.hit_next + node_off[i])
        miss = np.where(b.miss_next == _END, nxt, b.miss_next + node_off[i])
        return hit.astype(np.int32), miss.astype(np.int32)

    hits, misses = zip(*(links(b, i) for i, b in enumerate(blas_list)))

    def cat(field):
        return np.concatenate([getattr(b, field) for b in blas_list])

    return BuiltBVH(
        bbox_min=cat("bbox_min"), bbox_max=cat("bbox_max"),
        hit_next=np.concatenate(hits), miss_next=np.concatenate(misses),
        tri_start=np.concatenate(
            [b.tri_start + tri_off[i] for i, b in enumerate(blas_list)]).astype(np.int32),
        tri_count=cat("tri_count"), v0=cat("v0"), edge1=cat("edge1"), edge2=cat("edge2"),
        n0=cat("n0"), n1=cat("n1"), n2=cat("n2"), inst=cat("inst"),
        wide=combine_wide(blas_list) if wide is None else wide)


class MeshArrays(NamedTuple):
    """The fine-tree mesh tables and the wide topology: numpy after
    `mesh_arrays`, tensors after `to_device` (which adds the derived
    tables). A MeshArrays of the fine-tree fields alone (the bridge's) gets
    its wide topology in `to_device`."""

    bbox_min: object  # [Nn,3] f32
    bbox_max: object  # [Nn,3] f32
    hit_next: object  # [Nn] i32
    miss_next: object  # [Nn] i32
    tri_start: object  # [Nn] i32
    tri_count: object  # [Nn] i32
    v0: object  # [T,3] f32
    edge1: object  # [T,3]
    edge2: object  # [T,3]
    n0: object  # [T,3]
    n1: object
    n2: object
    inst: object  # [T] i32 instance index
    inst_transmission: object  # [I] f32
    inst_absorption: object  # [I,3] f32
    wide_topology: object = None  # the WideTopology of the wide nodes (host, also on device)
    plane: object = None  # [T,12] f32 plane rows (`plane_table`), device only
    inst_beer: object = None  # [I,3] f32 shadow Beer factor per crossing, device only
    wide: object = None  # [W,32] f32 the walks' wide nodes (`wide_table`), device only
    # [4,4] i64 on the walks' device, or None: the plain walks add to it per
    # WALK_CLASSES row their walks, node fetches, box tests, triangle tests
    # (the threaded walk fetches and tests one node a step); a closest walk's
    # lanes are primary or secondary by its count_class argument, thickness
    # when a thickness query is pending; the thickness walk is not counted
    walk_counts: object = None

    @property
    def num_nodes(self) -> int:
        return self.bbox_min.shape[0]

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def num_inst(self) -> int:
        return self.inst_transmission.shape[0]

    @property
    def wide_stack(self) -> int:
        """The deepest stack a walk of the wide nodes needs."""
        return self.wide_topology.need


FINE_FIELDS = MeshArrays._fields[:15]


def mesh_arrays(b: BuiltBVH, inst_transmission, inst_absorption) -> MeshArrays:
    """Numpy MeshArrays of a built forest and its per-instance materials."""
    return MeshArrays(
        bbox_min=b.bbox_min, bbox_max=b.bbox_max, hit_next=b.hit_next, miss_next=b.miss_next,
        tri_start=b.tri_start, tri_count=b.tri_count, v0=b.v0, edge1=b.edge1, edge2=b.edge2,
        n0=b.n0, n1=b.n1, n2=b.n2, inst=b.inst,
        inst_transmission=np.asarray(inst_transmission, np.float32),
        inst_absorption=np.asarray(inst_absorption, np.float32), wide_topology=b.wide)


def plane_table(v0, e1, e2):
    """[T,12] plane rows n(0:3) d0(3) pu(4:7) pu0(7) pv(8:11) pv0(11)
    (raytracevs_tpu/ops/bvh.py::plane_repr/_plane_table). For x on the
    triangle's plane u = pu.x + pu0 and v = pv.x + pv0; n = e1 x e2 is the
    unnormalised geometric normal."""
    n = vec.cross(e1, e2)
    nn = vec.dot(n, n)
    safe = nn > 1e-24
    inv = torch.where(safe, 1.0 / torch.where(safe, nn, 1.0), 0.0)[:, None]
    pu = vec.cross(e2, n) * inv
    pv = vec.cross(n, e1) * inv
    d0 = vec.dot(n, v0)
    pu0 = -vec.dot(pu, v0)
    pv0 = -vec.dot(pv, v0)
    return torch.cat([n, d0[:, None], pu, pu0[:, None], pv, pv0[:, None]], dim=-1).contiguous()


def wide_table(topo, union, bbox_min, bbox_max):
    """[W,32] f32 wide nodes, 128 bytes each: the min x, min y, min z, max
    x, max y, max z of the four child slots (4 floats each), then `topo`
    ([W,8] i32: the four child words, the four slots' fine nodes) as its
    bits; the walks read the child words and not the fine nodes. A slot's
    box is its fine node's box bit for bit, a top slot's the elementwise
    min/max of its fine roots' boxes (`union`, WideTopology.union); an
    empty slot's is fine node 0's, never read."""
    w = topo.shape[0]
    fine = torch.cat([bbox_min, bbox_max], dim=1)
    boxes = fine[torch.clamp(topo[:, 4:], min=0)]  # [W,4,6]
    if union.shape[0]:
        roots = union[:, 1:].long()
        boxes.view(-1, 6)[union[:, 0].long()] = torch.cat(
            [torch.amin(bbox_min[roots], dim=1), torch.amax(bbox_max[roots], dim=1)], dim=1)
    return torch.cat([boxes.transpose(1, 2).reshape(w, 24), topo.view(torch.float32)], dim=1)


def to_device(mesh: MeshArrays, device, shadow_absorption_scale) -> MeshArrays:
    """The tables as tensors on `device`, plus the plane table, the
    per-instance shadow Beer factor exp(-absorption * SHADOW_ABSORPTION_
    THICKNESS * shadow_absorption_scale) (1 where the instance does not
    absorb) and the kernels' wide nodes (`wide_table`), computed here by
    torch on the device; the wide topology's upload is kept with it
    (WideTopology.on)."""
    if mesh.wide_topology is None:
        mesh = mesh._replace(wide_topology=collapse(mesh.tri_start, mesh.tri_count,
                                                    mesh.miss_next))
    t = {f: torch.from_numpy(np.ascontiguousarray(getattr(mesh, f))).to(device)
         for f in FINE_FIELDS}
    topo, union = mesh.wide_topology.on(device)
    scale = torch.as_tensor(shadow_absorption_scale, dtype=torch.float32).to(device)
    ab = t["inst_absorption"]
    beer = torch.exp(-ab * (C.SHADOW_ABSORPTION_THICKNESS * scale))
    beer = torch.where(torch.any(ab > 0.0, dim=-1)[:, None], beer, 1.0)
    return MeshArrays(**t, wide_topology=mesh.wide_topology,
                      plane=plane_table(t["v0"], t["edge1"], t["edge2"]),
                      inst_beer=beer.contiguous(),
                      wide=wide_table(topo, union, t["bbox_min"], t["bbox_max"]))


# ---- device half: the plain walks ------------------------------------------

class TriHit(NamedTuple):
    hit: torch.Tensor  # [N] bool
    t: torch.Tensor  # [N]
    tri: torch.Tensor  # [N] i32 triangle index
    u: torch.Tensor  # [N] barycentric
    v: torch.Tensor  # [N]
    inst: torch.Tensor  # [N] i32 instance index
    thick_hit: Optional[torch.Tensor] = None  # [N] fused same-instance thickness found
    thick_t: Optional[torch.Tensor] = None  # [N] its distance


def _lanes(x, n, dtype, device):
    """A scalar or [N] argument as an [N] tensor."""
    return torch.as_tensor(x, dtype=dtype, device=device).expand(n).contiguous()


def _safe_inv(d):
    """1 / d with |d| < 1e-12 replaced by +-1e-12 (sign of d; -0 counts as +)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)


def _max3(a):
    return torch.maximum(torch.maximum(a[:, 0], a[:, 1]), a[:, 2])


def _min3(a):
    return torch.minimum(torch.minimum(a[:, 0], a[:, 1]), a[:, 2])


def _ray_aabb(o, inv_d, bb_min, bb_max, tmin, tmax):
    """Slab test of [N] rays against [N] boxes; NaN propagates like jnp."""
    t0 = (bb_min - o) * inv_d
    t1 = (bb_max - o) * inv_d
    t_near = torch.maximum(_max3(torch.minimum(t0, t1)), tmin)
    t_far = torch.minimum(_min3(torch.maximum(t0, t1)), tmax)
    return t_near <= t_far


def _leaf(mesh, s, node_idx, box_hit):
    """The plane test of a leaf's LEAF_SIZE triangle slots, for every lane
    at once. Returns (ti [N,K] i32, t, u, v [N,K], hit [N,K] without its
    t <= tmax part, which the caller applies per slot in order)."""
    count = mesh.tri_count[node_idx]
    start = mesh.tri_start[node_idx]
    k = torch.arange(LEAF_SIZE, device=count.device, dtype=count.dtype)
    ti = torch.clamp(start[:, None] + k, 0, mesh.num_tris - 1)
    valid = (box_hit & (count > 0))[:, None] & (k < count[:, None])
    if "ntri" in s:  # counted walk: the triangle slots tested
        s["ntri"] = s["ntri"] + valid.sum(dim=1)
    row = mesh.plane[ti]  # [N,K,12]
    o, d = s["o"][:, None, :], s["d"][:, None, :]
    nd = vec.dot(row[..., 0:3], d)
    no = vec.dot(row[..., 0:3], o)
    ok = torch.abs(nd) > 1e-9  # both windings hit (TRIANGLE_CULL_DISABLE)
    t = (row[..., 3] - no) / torch.where(ok, nd, 1.0)
    hx = o + t[..., None] * d
    u = vec.dot(row[..., 4:7], hx) + row[..., 7]
    v = vec.dot(row[..., 8:11], hx) + row[..., 11]
    hit = valid & ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= s["tmin"][:, None])
    return ti, t, u, v, hit


def _next(mesh, s, node_idx, box_hit):
    live = s["node"] != _END
    nxt = torch.where(box_hit, mesh.hit_next[node_idx], mesh.miss_next[node_idx])
    return torch.where(live, nxt, s["node"])


def _walk(lanes: dict, step, max_steps: int, results, count=False) -> dict:
    """Advance every lane through `step` until its node is _END or it has
    taken max_steps steps (the JAX walk's while-loop, lane by lane). `lanes`
    holds [N, ...] walk state with "node"; `step` maps such a dict, for any
    subset of lanes, to its next state and leaves _END lanes unchanged.
    Every _COMPACT_EVERY steps the finished lanes' `results` keys are
    written back and those lanes dropped from the working set. With count,
    the result also holds each lane's steps ("nstep": one node fetched and
    one box tested a step) and triangle slots tested ("ntri")."""
    if count:
        zero = torch.zeros(lanes["node"].shape, dtype=torch.int64, device=lanes["node"].device)
        lanes = dict(lanes, nstep=zero, ntri=zero)
        results = list(results) + ["nstep", "ntri"]
    out = {k: lanes[k] for k in results}
    idx = torch.nonzero(lanes["node"] != _END).squeeze(1)
    cur = {k: v[idx] for k, v in lanes.items()}
    steps = 0
    while idx.numel() > 0 and steps < max_steps:
        for _ in range(min(_COMPACT_EVERY, max_steps - steps)):
            if count:
                cur["nstep"] = cur["nstep"] + (cur["node"] != _END)
            cur = step(cur)
            steps += 1
        live = cur["node"] != _END
        if steps < max_steps and bool(live.all()):
            continue
        for k in out:
            out[k] = out[k].index_copy(0, idx, cur[k])
        idx = idx[live]
        cur = {k: v[live] for k, v in cur.items()}
    return out


def _add_counts(counts, cls, walking, r):
    """Add the walking lanes' counts (`_walk`'s nstep and ntri) by class."""
    rows = torch.stack([torch.ones_like(r["nstep"]), r["nstep"], r["nstep"], r["ntri"]], 1)
    counts.index_add_(0, cls[walking].long(), rows[walking])


def _start(mesh, o, d, active, n, dev, tmin):
    node = torch.zeros((n,), dtype=torch.int32, device=dev)
    if active is not None:
        node = torch.where(active, node, _END)
    return {"node": node, "o": o, "d": d, "inv_d": _safe_inv(d),
            "tmin": _lanes(tmin, n, torch.float32, dev)}


def traverse_closest(mesh: MeshArrays, o, d, tmin, tmax, skip_active=None, skip_inst=None,
                     thick_inst=None, active=None, count_class=None) -> TriHit:
    """Stackless closest-hit walk (raytracevs_tpu/ops/bvh.py::traverse_closest).

    skip_active/skip_inst: RAYFLAG_SKIP_SELF for mesh instances (masks by
    instance, AnyHit_SkipSelf.hlsl). thick_inst ([N] i32, -1 = none): lanes
    with a pending same-instance thickness query resolve it in this walk;
    their interval stays open until the first same-instance hit
    (AnyHit_Thickness_Triangle's AcceptHitAndEndSearch). `active` ([N] bool)
    limits the walk to those lanes; the others report a miss. count_class
    ([N] int, 0 primary or 1 secondary; default 1) classes the lanes for
    mesh.walk_counts."""
    n, dev = o.shape[0], o.device
    f32, i32 = torch.float32, torch.int32
    tmax_l = _lanes(tmax, n, f32, dev)
    track = thick_inst is not None
    s = _start(mesh, o, d, active, n, dev, tmin)
    s.update(best_t=tmax_l.clone(), best_tri=torch.zeros((n,), dtype=i32, device=dev),
             best_u=torch.zeros((n,), dtype=f32, device=dev),
             best_v=torch.zeros((n,), dtype=f32, device=dev),
             skip_active=(torch.zeros((n,), dtype=torch.bool, device=dev)
                          if skip_active is None else skip_active),
             skip_inst=(torch.zeros((n,), dtype=i32, device=dev)
                        if skip_inst is None else skip_inst.to(i32)))
    if track:
        s.update(thick_inst=thick_inst.to(i32),
                 thick_t=torch.full((n,), _BIG, dtype=f32, device=dev),
                 thick_f=torch.zeros((n,), dtype=torch.bool, device=dev))

    def step(s):
        s = dict(s)
        ni = torch.clamp(s["node"], 0, mesh.num_nodes - 1)
        best_t = s["best_t"]
        if track:
            pend = (s["thick_inst"] >= 0) & ~s["thick_f"]
            bound = torch.where(pend, _BIG, best_t)
        else:
            bound = best_t
        box_hit = (s["node"] != _END) & _ray_aabb(s["o"], s["inv_d"], mesh.bbox_min[ni],
                                                  mesh.bbox_max[ni], s["tmin"], bound)
        ti, t, u, v, base = _leaf(mesh, s, ni, box_hit)
        tinst = mesh.inst[ti]
        skip = s["skip_active"][:, None] & (tinst == s["skip_inst"][:, None])
        best_tri, best_u, best_v = s["best_tri"], s["best_u"], s["best_v"]
        for k in range(LEAF_SIZE):
            tt = t[:, k]
            bnd = torch.where(pend, _BIG, best_t) if track else best_t
            th = base[:, k] & (tt <= bnd)
            if track:
                tm = th & (tinst[:, k] == s["thick_inst"]) & (tt < s["thick_t"])
                s["thick_t"] = torch.where(tm, tt, s["thick_t"])
                s["thick_f"] = s["thick_f"] | tm
            better = th & ~skip[:, k] & (tt < best_t)
            best_t = torch.where(better, tt, best_t)
            best_tri = torch.where(better, ti[:, k], best_tri)
            best_u = torch.where(better, u[:, k], best_u)
            best_v = torch.where(better, v[:, k], best_v)
        s.update(best_t=best_t, best_tri=best_tri, best_u=best_u, best_v=best_v,
                 node=_next(mesh, s, ni, box_hit))
        return s

    keep = ["best_t", "best_tri", "best_u", "best_v"] + (["thick_t", "thick_f"] if track else [])
    r = _walk(s, step, mesh.num_nodes + 1, keep, count=mesh.walk_counts is not None)
    if mesh.walk_counts is not None:
        cls = torch.ones((n,), dtype=torch.int64, device=dev) if count_class is None \
            else count_class.to(torch.int64)
        if track:
            cls = torch.where(thick_inst >= 0, 2, cls)
        _add_counts(mesh.walk_counts, cls, torch.ones((n,), dtype=torch.bool, device=dev)
                    if active is None else active, r)
    hit = r["best_t"] < tmax_l * 0.9999
    return TriHit(hit=hit, t=r["best_t"], tri=r["best_tri"], u=r["best_u"], v=r["best_v"],
                  inst=mesh.inst[r["best_tri"]], thick_hit=r.get("thick_f"),
                  thick_t=r.get("thick_t"))


def pow_u8(base, n_vec, one):
    """base ** n for integer n in [0, 255] by repeated squaring: multiplies
    only, in the JAX package's order (bvh.py::_pow_u8)."""
    r = one
    b = base
    for bit in range(8):
        r = torch.where(((n_vec >> bit) & 1) != 0, r * b, r)
        if bit < 7:
            b = b * b
    return r


def traverse_shadow(mesh: MeshArrays, o, d, max_dist, blocked0=None, active=None):
    """Shadow walk: transmission over every triangle crossed
    (AnyHit_Shadow_Triangle, AnyHit_Shadow.hlsl:60-88; raytracevs_tpu/ops/
    bvh.py::traverse_shadow with its default count mode).

    Up to 8 instances the walk counts crossings per instance (8 bits each,
    in one or two int32 words) and evaluates trans^n and beer^n once at the
    end; beyond 8 it multiplies per crossing in walk order. An opaque
    (transmission < 0.01) crossing ends the walk after its leaf
    (AcceptHitAndEndSearch); blocked0 ([N] bool) lanes ended on an opaque
    analytic hit and do not walk. Returns (visibility [N], colour [N,3],
    occluder distance [N])."""
    n, dev = o.shape[0], o.device
    f32 = torch.float32
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev) if blocked0 is None else blocked0
    s = _start(mesh, o, d, active, n, dev, C.RAY_TMIN)
    s.update(tmax=_lanes(max_dist, n, f32, dev), blocked=blocked,
             occ=torch.full((n,), C.NRD_FP16_MAX, dtype=f32, device=dev))
    s["node"] = torch.where(blocked, _END, s["node"])
    trans_i = mesh.inst_transmission
    opq = trans_i < 0.01
    num_inst = mesh.num_inst
    count_mode = num_inst <= 8
    if count_mode:
        n_words = (num_inst + 3) // 4
        for w in range(n_words):
            s[f"cnt{w}"] = torch.zeros((n,), dtype=torch.int32, device=dev)
    else:
        s.update(vis=torch.ones((n,), dtype=f32, device=dev),
                 color=torch.ones((n, 3), dtype=f32, device=dev))

    def step(s):
        s = dict(s)
        ni = torch.clamp(s["node"], 0, mesh.num_nodes - 1)
        box_hit = (s["node"] != _END) & _ray_aabb(s["o"], s["inv_d"], mesh.bbox_min[ni],
                                                  mesh.bbox_max[ni], s["tmin"], s["tmax"])
        ti, t, _, _, base = _leaf(mesh, s, ni, box_hit)
        th = base & (t <= s["tmax"][:, None])
        tinst = mesh.inst[ti]
        blocked = s["blocked"] | torch.any(th & opq[tinst], dim=1)
        occ = torch.minimum(s["occ"], torch.amin(torch.where(th, t, C.NRD_FP16_MAX), dim=1))
        if count_mode:
            inc = th.to(torch.int32) << ((tinst & 3) * 8)
            if n_words == 1:
                s["cnt0"] = s["cnt0"] + inc.sum(dim=1, dtype=torch.int32)
            else:
                hi = tinst >= 4
                s["cnt0"] = s["cnt0"] + torch.where(hi, 0, inc).sum(dim=1, dtype=torch.int32)
                s["cnt1"] = s["cnt1"] + torch.where(hi, inc, 0).sum(dim=1, dtype=torch.int32)
        else:
            vis, color = s["vis"], s["color"]
            for k in range(LEAF_SIZE):
                translucent = th[:, k] & (trans_i[tinst[:, k]] >= 0.01)
                vis = torch.where(translucent, vis * trans_i[tinst[:, k]], vis)
                color = vec.where3(translucent, color * mesh.inst_beer[tinst[:, k]], color)
            s.update(vis=vis, color=color)
        nxt = _next(mesh, s, ni, box_hit)
        # an opaque crossing ends the search (AnyHit_Shadow.hlsl:44-49, 76-81)
        s.update(blocked=blocked, occ=occ, node=torch.where(blocked, _END, nxt))
        return s

    keep = ["blocked", "occ"] + ([f"cnt{w}" for w in range(n_words)] if count_mode
                                 else ["vis", "color"])
    r = _walk(s, step, mesh.num_nodes + 1, keep, count=mesh.walk_counts is not None)
    if mesh.walk_counts is not None:
        _add_counts(mesh.walk_counts, torch.full((n,), 3, dtype=torch.int64, device=dev),
                    torch.ones((n,), dtype=torch.bool, device=dev) if active is None else active,
                    r)
    blocked = r["blocked"]
    if count_mode:
        one = torch.ones((n,), dtype=f32, device=dev)
        vis, cr, cg, cb = one, one, one, one
        beer = mesh.inst_beer
        for i in range(num_inst):
            n_i = (r[f"cnt{i // 4}"] >> ((i & 3) * 8)) & 255
            # opaque instances act through `blocked` only
            n_i = torch.where(opq[i], 0, n_i)
            vis = vis * pow_u8(trans_i[i], n_i, one)
            cr = cr * pow_u8(beer[i, 0], n_i, one)
            cg = cg * pow_u8(beer[i, 1], n_i, one)
            cb = cb * pow_u8(beer[i, 2], n_i, one)
        color = torch.stack([cr, cg, cb], dim=-1)
    else:
        vis, color = r["vis"], r["color"]
    vis = torch.where(blocked, 0.0, vis)
    color = vec.where3(blocked, torch.zeros_like(color), color)
    return vis, color, r["occ"]


def traverse_thickness(mesh: MeshArrays, o, d, inst_id, active=None):
    """Same-instance thickness walk (AnyHit_Thickness_Triangle.hlsl:111-129;
    raytracevs_tpu/ops/bvh.py::traverse_thickness): the walk stops at the
    first threaded-order leaf with a same-instance hit and returns the
    nearest hit within it. Returns (hit [N] bool, t [N]).

    The render resolves mesh-glass thickness inside the refract child's
    closest walk instead (`traverse_closest`'s thick_inst), as the JAX
    package's render does."""
    n, dev = o.shape[0], o.device
    big = C.NRD_FP16_MAX
    s = _start(mesh, o, d, active, n, dev, C.RAY_TMIN)
    s.update(inst_id=inst_id.to(torch.int32),
             best_t=torch.full((n,), big, dtype=torch.float32, device=dev))

    def step(s):
        s = dict(s)
        ni = torch.clamp(s["node"], 0, mesh.num_nodes - 1)
        best_t = s["best_t"]
        box_hit = (s["node"] != _END) & _ray_aabb(s["o"], s["inv_d"], mesh.bbox_min[ni],
                                                  mesh.bbox_max[ni], s["tmin"], best_t)
        ti, t, _, _, base = _leaf(mesh, s, ni, box_hit)
        base = base & (mesh.inst[ti] == s["inst_id"][:, None])
        hit_leaf = torch.zeros_like(box_hit)
        for k in range(LEAF_SIZE):
            th = base[:, k] & (t[:, k] <= best_t)
            best_t = torch.where(th & (t[:, k] < best_t), t[:, k], best_t)
            hit_leaf = hit_leaf | th
        nxt = _next(mesh, s, ni, box_hit)
        s.update(best_t=best_t, node=torch.where(hit_leaf, _END, nxt))
        return s

    best_t = _walk(s, step, mesh.num_nodes + 1, ["best_t"])["best_t"]
    hit = best_t < big * 0.999
    return hit, torch.where(hit, best_t, big)


def shading_normal(mesh: MeshArrays, hit: TriHit, direction):
    """Triangle shading normal (ClosestHit_Triangle.hlsl:14-136): the
    barycentric smooth normal, and the front-face flag decided by the
    geometric normal (thin shells). Returns (normal [N,3], front [N])."""
    ti = hit.tri
    w = 1.0 - hit.u - hit.v
    n = mesh.n0[ti] * w[:, None] + mesh.n1[ti] * hit.u[:, None] + mesh.n2[ti] * hit.v[:, None]
    n = vec.normalize(n)
    geo = vec.normalize(vec.cross(mesh.edge1[ti], mesh.edge2[ti]))
    front = vec.dot(direction, geo) < 0.0
    return n, front
