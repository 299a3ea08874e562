// The scene as the kernels of K1 (render.cuh) and K5 (photon.cu) read it:
// the table layout of ops/cuda/megakernel.py::pack_scene, the RNG, the mesh
// walks and the closest analytic hit. nvcc compiles each .cu on its own (no
// -rdc), so both files include these definitions; each instantiates only
// what it calls.
#pragma once

#include "common.cuh"

namespace {

constexpr int STACK_DEPTH = 8;
constexpr int INVALID = 0x7FFFFFFF;
constexpr int TYPE_SPHERE = 0, TYPE_PLANE = 1, TYPE_BOX = 2, TYPE_MESH = 3;
constexpr int LEAF_SIZE = 4, NODE_END = -1;
constexpr int LIGHT_AMBIENT = 0, LIGHT_POINT = 1, LIGHT_DIRECTIONAL = 2;
constexpr int PATH_FLAG_INSIDE = 1, PATH_FLAG_SPECULAR = 2;
constexpr uint32_t SALT_SHADOW = 6, SALT_REFLECT = 7, SALT_REFRACT = 8;
constexpr float BIG = 1e30f;
#define RAY_TMIN F(0.001)
#define RAY_TMAX F(10000.0)
#define FP16_MAX F(65504.0)

// Table strides (floats per row), shared with ops/cuda/megakernel.py::pack_scene
constexpr int SPH_W = 5, PLN_W = 7, BOX_W = 16, MAT_W = 16, LT_W = 12;
// param slots
constexpr int P_CAMPOS = 0, P_FWD = 3, P_RIGHT = 6, P_UP = 9, P_TANFOV = 12, P_APERTURE = 13,
              P_FOCUS = 14, P_SHADOW_STRENGTH = 15, P_ABSORB_SCALE = 16, P_ATTEN_C = 17,
              P_ATTEN_L = 18, P_ATTEN_Q = 19;

// width and height are the frame's (the camera rays and the RNG keys use
// them); row0 and rows the row band a launch renders (ops/cuda/
// megakernel.py::row_bands), whose planes it writes: the whole frame, or
// one band of a frame whose planes pass a 32-bit index.
struct Cfg {
  int width, height;
  int row0, rows;
  int S, P, B, L;
  int spp, max_bounces, max_iters, max_soft;
  bool has_lights, any_glass, any_metal, any_absorption;
  // photon debug modes 3/4 at depth-0 hits: 0 off, 1 transmission, 2 metallic
  int debug;
  float aspect;
};

// What an instantiation of the render kernels and of the walks traces
// (template MODE, bits): MODE_MESH the mesh walks, over the wide nodes, or
// with MODE_THREADED along the fine tree's threaded links (a wide table
// whose walks need more than WALK_STACK entries); MODE_COUNT the counting
// build, which adds its work to Scene::counts.
constexpr int MODE_MESH = 1, MODE_THREADED = 2, MODE_COUNT = 4;

// The mesh tables (ops/cuda/megakernel.py::pack_mesh). nodes: the wide
// nodes [W][8] float4 of ops/bvh.py::wide_table (per child slot 0..3 its
// box's min x, min y, min z, max x, max y, max z, then the four child words
// as an int4, then the slots' fine nodes, not read: 128 bytes a node), or
// with MODE_THREADED the fine nodes [Nn][2] float4 of ops/cuda/
// megakernel.py::fine_nodes (min x, min y, min z, max x; max y, max z, the
// hit word, the miss link; the hit word of a leaf is ~(start << 3 | count),
// 32 bytes a node); plane [T][3] float4 = the 12 floats of
// ops/bvh.py::plane_table; n0/n1/n2/e1/e2 [T,3]; inst [T]; inst_tbl [I][8] =
// (transmission, absorption xyz, shadow Beer factor xyz, 0). counts: the
// counting build's [4][4] walk counts (WC_* rows; walks, node fetches, box
// tests, triangle tests), else null.
struct Mesh {
  const float4* nodes;
  const float4* plane;
  const float *n0, *n1, *n2, *e1, *e2;
  const int* inst;
  const float* inst_tbl;
  unsigned long long* counts;
  int num_tris, num_inst, num_nodes;
};

// counts: the counting build's [COUNT_ROWS][4] table (ops/cuda/
// megakernel.py::COUNT_ROWS: the walk counts' four rows, then the DFS's),
// else null; mesh.counts points at its first row.
struct Scene {
  const float *sph, *pln, *box, *mat, *lts, *par, *bn;
  int num_lights, max_shadow_lights;
  uint32_t frame;
  unsigned long long* counts;
  Mesh mesh;
};

struct Hit {
  bool hit;
  float t;
  int type, index, slot;
  // mesh hits: triangle and barycentrics; the fused thickness query
  int tri;
  float u, v;
  bool thick_hit;
  float thick_t;
};

__device__ __forceinline__ float par(const Scene& sc, int i) { return __ldg(sc.par + i); }
__device__ __forceinline__ V3 par3(const Scene& sc, int i) { return ld3(sc.par + i); }

// ---- mesh walks (raytracevs_tpu_torch/ops/bvh.py) ---------------------------
// They replace the TPU kernels' mesh walks (raytracevs_tpu/ops/pallas/
// megakernel.py: mesh_closest_k, mesh_shadow_count_k, mesh_shadow_k, and
// mesh_thickness_k through the closest walk's fused thickness) and return
// what the plain threaded walks (ops/bvh.py::traverse_closest,
// traverse_shadow) return, bit for bit.
//
// What bounds them: dependent loads. A walk is a chain of node fetches,
// each an L2 gather (~4.5 MB of wide nodes and ~11 MB of plane rows for the
// mesh demo scene's 237k triangles stay in the 50 MB L2, not in L1), so
// latency and the warps that hide it decide the time, plus divergence
// between rays that walk a few nodes and rays that walk hundreds. The
// threaded walk fetched one fine node (3 dependent 16-byte loads) per box
// test: 9.4 a primary ray, 7.6 a shadow ray, 16.6 a secondary ray and 54
// a ray with a pending thickness query on the mesh demo scene; these walks
// fetch 2.9, 2.5, 4.8 and 14.8 wide nodes for the same box and triangle
// tests (PERF.md). Alone they walk 2,073,600 camera rays in 0.33 ms; in
// the render kernels the megakernel around them (one block an SM, the
// caller's state saved around each call) costs more than their loads.
//
// Design: one ray per thread walks wide nodes (ops/bvh.py::collapse: the
// fine tree's binary nodes merged into up to four children, leaves as they
// are, LEAF_SIZE 4): one 128-byte node, seven independent 16-byte __ldg,
// gives four box tests. The slab test is _ray_aabb's arithmetic on the
// fine boxes bit for bit, and a child box lies inside its parent's, so a
// grandchild fails wherever the binary node the collapse skipped fails.
// The walk keeps the fine tree's preorder (hit children pushed right to
// left on a per-thread stack of (child, entry distance), Aila and Laine's
// while-while loop: inner nodes until a leaf is due, then leaves), so it
// tests the threaded walk's leaves in its order. A popped child is
// re-tested as entry <= the current bound, which is the slab test at that
// bound (the entry passed at a larger one). The order matters for every
// walk: the closest hit's ties and its box culls, the pending thickness
// (open to BIG until the first same-instance hit), the shadow walk's
// occluder distance before an opaque leaf ends it and the multiply mode's
// product. Nearest child first is not exact (a box's slab distance and a
// triangle's plane distance round apart; tests/test_torch_wide_bvh.py).
// Tensor cores and TMA have no use here: every load is a per-ray gather.
// The stack is per-thread local memory (cached in L1): a per-thread slice
// of shared memory measured slower, K1-mesh at spp 2 by 4.6% and K7-mesh
// by 46% (PERF.md). It holds WALK_STACK entries; a table whose deepest walk
// needs more (ops/bvh.py::WideTopology.need) is walked along the fine
// tree's threaded links instead (walk_threaded, the MODE_THREADED
// instantiations), which need no stack: no table is refused.
constexpr int WALK_STACK = 64;  // ops/bvh.py::WALK_STACK
constexpr int CHILD_EMPTY = -1;
// walk classes of the counting build (ops/bvh.py::WALK_CLASSES)
constexpr int WC_PRIMARY = 0, WC_SECONDARY = 1, WC_THICK = 2, WC_SHADOW = 3;

__device__ __forceinline__ float safe_inv1(float x) {
  return 1.0f / (fabsf(x) < F(1e-12) ? (x < 0.0f ? F(-1e-12) : F(1e-12)) : x);
}

struct Wide {
  float4 lx, ly, lz, hx, hy, hz;
  int4 c;
};

__device__ __forceinline__ Wide load_wide(const float4* w, int n) {
  const float4* p = w + 8 * n;
  Wide r;
  r.lx = __ldg(p);
  r.ly = __ldg(p + 1);
  r.lz = __ldg(p + 2);
  r.hx = __ldg(p + 3);
  r.hy = __ldg(p + 4);
  r.hz = __ldg(p + 5);
  r.c = __ldg(reinterpret_cast<const int4*>(p + 6));
  return r;
}

// slab test of one child box (ops/bvh.py::_ray_aabb) for a finite ray, whose
// t values hold no NaN: fminf/fmaxf then decide as the NaN-propagating
// forms do. tn: the entry distance, t_near clamped to tmin.
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx, float hy, float hz,
                                     V3 o, V3 inv, float tmin, float tmax, float& tn) {
  float t0x = (lx - o.x) * inv.x, t1x = (hx - o.x) * inv.x;
  float t0y = (ly - o.y) * inv.y, t1y = (hy - o.y) * inv.y;
  float t0z = (lz - o.z) * inv.z, t1z = (hz - o.z) * inv.z;
  tn = fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)), tmin);
  float tf = fminf(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)), tmax);
  return tn <= tf;
}

__device__ __forceinline__ int pop(const int* stk_c, const float* stk_t, int& sp, float bound) {
  while (sp > 0) {
    --sp;
    if (stk_t[sp] <= bound) return stk_c[sp];
  }
  return CHILD_EMPTY;
}

// The preorder walk of the wide table. bound() is the current box bound;
// leaf(word) tests a leaf and returns true to end the walk. A ray with a
// non-finite origin or direction fails every slab test of the threaded walk
// (a NaN, or an infinite t on both sides of the slab, or a zero inverse
// whose slab ends at t <= 0 < tmin), so it visits nothing here either.
template <typename Bound, typename Leaf>
__device__ __forceinline__ void walk_wide(const float4* wide, V3 o, V3 d, float tmin,
                                          Bound bound, Leaf leaf, uint32_t& fetches,
                                          uint32_t& boxes) {
  if (!(finite3(o) && finite3(d))) return;
  V3 inv = v3(safe_inv1(d.x), safe_inv1(d.y), safe_inv1(d.z));
  int stk_c[WALK_STACK];
  float stk_t[WALK_STACK];
  int sp = 0;
  int node = 0;
  while (node != CHILD_EMPTY) {
    while (node >= 0) {  // inner nodes until a leaf is due
      Wide nd = load_wide(wide, node);
      float b = bound();
      float t0, t1, t2, t3;
      bool h0 = nd.c.x != CHILD_EMPTY &&
                slab(nd.lx.x, nd.ly.x, nd.lz.x, nd.hx.x, nd.hy.x, nd.hz.x, o, inv, tmin, b, t0);
      bool h1 = nd.c.y != CHILD_EMPTY &&
                slab(nd.lx.y, nd.ly.y, nd.lz.y, nd.hx.y, nd.hy.y, nd.hz.y, o, inv, tmin, b, t1);
      bool h2 = nd.c.z != CHILD_EMPTY &&
                slab(nd.lx.z, nd.ly.z, nd.lz.z, nd.hx.z, nd.hy.z, nd.hz.z, o, inv, tmin, b, t2);
      bool h3 = nd.c.w != CHILD_EMPTY &&
                slab(nd.lx.w, nd.ly.w, nd.lz.w, nd.hx.w, nd.hy.w, nd.hz.w, o, inv, tmin, b, t3);
      fetches += 1;
      boxes += (nd.c.x != CHILD_EMPTY) + (nd.c.y != CHILD_EMPTY) + (nd.c.z != CHILD_EMPTY) +
               (nd.c.w != CHILD_EMPTY);
      // hit children right to left: each later one waits on the stack
      int next = CHILD_EMPTY;
      float nt = 0.0f;
      if (h3) { next = nd.c.w; nt = t3; }
      if (h2) {
        if (next != CHILD_EMPTY) { stk_c[sp] = next; stk_t[sp] = nt; ++sp; }
        next = nd.c.z; nt = t2;
      }
      if (h1) {
        if (next != CHILD_EMPTY) { stk_c[sp] = next; stk_t[sp] = nt; ++sp; }
        next = nd.c.y; nt = t1;
      }
      if (h0) {
        if (next != CHILD_EMPTY) { stk_c[sp] = next; stk_t[sp] = nt; ++sp; }
        next = nd.c.x;
      }
      node = next != CHILD_EMPTY ? next : pop(stk_c, stk_t, sp, b);
    }
    while (node < CHILD_EMPTY) {  // leaves until an inner node is due
      if (leaf(node)) return;
      node = pop(stk_c, stk_t, sp, bound());
    }
  }
}

// slab test of a fine node's box (ops/bvh.py::_ray_aabb), NaN-propagating
// as the plain walk's
__device__ __forceinline__ bool ray_aabb(V3 o, V3 inv, float4 a, float4 b, float tmin,
                                         float tmax) {
  float t0x = (a.x - o.x) * inv.x, t1x = (a.w - o.x) * inv.x;
  float t0y = (a.y - o.y) * inv.y, t1y = (b.x - o.y) * inv.y;
  float t0z = (a.z - o.z) * inv.z, t1z = (b.y - o.z) * inv.z;
  float t_near = maxn(maxn(maxn(minn(t0x, t1x), minn(t0y, t1y)), minn(t0z, t1z)), tmin);
  float t_far = minn(minn(minn(maxn(t0x, t1x), maxn(t0y, t1y)), maxn(t0z, t1z)), tmax);
  return t_near <= t_far;
}

// The stackless walk of the fine tree's threaded links (ops/bvh.py::_walk,
// the plain walks' order, step bound and box test): a node's box hit leads
// to its hit link, a miss, and every leaf, to its miss link. It has no
// stack, so no table is too deep for it; it fetches one 32-byte node per
// box test where the wide walk fetches one 128-byte node per four. bound()
// and leaf() as walk_wide's.
template <typename Bound, typename Leaf>
__device__ __forceinline__ void walk_threaded(const float4* fine, int num_nodes, V3 o, V3 d,
                                              float tmin, Bound bound, Leaf leaf,
                                              uint32_t& fetches, uint32_t& boxes) {
  V3 inv = v3(safe_inv1(d.x), safe_inv1(d.y), safe_inv1(d.z));
  int node = 0;
  for (int step = 0; node != NODE_END && step <= num_nodes; ++step) {
    float4 a = __ldg(fine + 2 * node), b = __ldg(fine + 2 * node + 1);
    int word = __float_as_int(b.z), miss = __float_as_int(b.w);
    bool box_hit = ray_aabb(o, inv, a, b, tmin, bound());
    fetches += 1;
    boxes += 1;
    if (word < 0) {  // a leaf: its hit link is its miss link
      if (box_hit && leaf(word)) return;
      node = miss;
    } else {
      node = box_hit ? word : miss;
    }
  }
}

template <int MODE, typename Bound, typename Leaf>
__device__ __forceinline__ void walk(const Mesh& m, V3 o, V3 d, float tmin, Bound bound, Leaf leaf,
                                     uint32_t& fetches, uint32_t& boxes) {
  if constexpr ((MODE & MODE_THREADED) != 0)
    walk_threaded(m.nodes, m.num_nodes, o, d, tmin, bound, leaf, fetches, boxes);
  else
    walk_wide(m.nodes, o, d, tmin, bound, leaf, fetches, boxes);
}

// the triangle range of a leaf's child word
__device__ __forceinline__ int leaf_start(int word) { return (int)((uint32_t)~word >> 3); }
__device__ __forceinline__ int leaf_count(int word) { return (int)((uint32_t)~word & 7u); }

template <int MODE>
__device__ __forceinline__ void add_counts(const Mesh& m, int cls, uint32_t fetches,
                                           uint32_t boxes, uint32_t tris) {
  if constexpr ((MODE & MODE_COUNT) != 0) {
    unsigned long long* c = m.counts + 4 * cls;
    atomicAdd(c, 1ull);
    atomicAdd(c + 1, (unsigned long long)fetches);
    atomicAdd(c + 2, (unsigned long long)boxes);
    atomicAdd(c + 3, (unsigned long long)tris);
  }
}

// plane-row triangle test (ops/bvh.py::_leaf): `base` is the hit without
// its t <= tmax part, which the walks apply in slot order
__device__ __forceinline__ bool tri_plane(const float4* row, V3 o, V3 d, float tmin, float& t,
                                          float& u, float& v) {
  float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2);
  float nd = r0.x * d.x + r0.y * d.y + r0.z * d.z;
  float no = r0.x * o.x + r0.y * o.y + r0.z * o.z;
  bool ok = fabsf(nd) > F(1e-9);
  t = (r0.w - no) / (ok ? nd : 1.0f);
  V3 hx = v3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
  u = r1.x * hx.x + r1.y * hx.y + r1.z * hx.z + r1.w;
  v = r2.x * hx.x + r2.y * hx.y + r2.z * hx.z + r2.w;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin;
}

struct MeshHit {
  bool hit, thick_hit;
  float t, u, v, thick_t;
  int tri, inst;
};

// closest triangle with skip-self by instance and the fused same-instance
// thickness (ops/bvh.py::traverse_closest); cls: the counting build's class
template <int MODE>
__device__ __noinline__ MeshHit mesh_closest(Mesh m, V3 o, V3 d, float tmin, float tmax,
                                             bool skip_active, int skip_inst, int thick_inst,
                                             int cls) {
  MeshHit r;
  r.t = tmax;
  r.u = r.v = 0.0f;
  r.tri = 0;
  r.thick_t = BIG;
  r.thick_hit = false;
  uint32_t fetches = 0, boxes = 0, tris = 0;
  // a pending thickness query keeps the interval open to BIG until the
  // first same-instance hit
  auto bound = [&]() { return (thick_inst >= 0 && !r.thick_hit) ? BIG : r.t; };
  auto leaf = [&](int word) {
    bool pend = thick_inst >= 0 && !r.thick_hit;  // fixed for the leaf
    int start = leaf_start(word), count = leaf_count(word);
    for (int k = 0; k < LEAF_SIZE && k < count; ++k) {
      int ti = min(max(start + k, 0), m.num_tris - 1);
      float tt, tu, tv;
      bool base = tri_plane(m.plane + 3 * ti, o, d, tmin, tt, tu, tv);
      tris += 1;
      if (!(base && tt <= (pend ? BIG : r.t))) continue;
      int it = __ldg(m.inst + ti);
      if (it == thick_inst && tt < r.thick_t) {
        r.thick_t = tt;
        r.thick_hit = true;
      }
      if (!(skip_active && it == skip_inst) && tt < r.t) {
        r.t = tt;
        r.tri = ti;
        r.u = tu;
        r.v = tv;
      }
    }
    return false;
  };
  walk<MODE>(m, o, d, tmin, bound, leaf, fetches, boxes);
  r.hit = r.t < tmax * F(0.9999);
  r.inst = __ldg(m.inst + r.tri);
  add_counts<MODE>(m, thick_inst >= 0 ? WC_THICK : cls, fetches, boxes, tris);
  return r;
}

// base ** n for n in [0, 255] by repeated squaring (ops/bvh.py::pow_u8)
__device__ __forceinline__ float pow_u8(float base, uint32_t n) {
  float r = 1.0f, b = base;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    if ((n >> bit) & 1u) r = r * b;
    if (bit < 7) b = b * b;
  }
  return r;
}

// shadow transmission over every triangle crossed (ops/bvh.py::
// traverse_shadow): per-instance 8-bit crossing counts in two words for up
// to 8 instances, a product per crossing in walk order beyond
template <int MODE>
__device__ __noinline__ void mesh_shadow(Mesh m, V3 o, V3 d, float max_dist, bool blocked,
                                         float& vis, V3& color, float& occ) {
  bool count_mode = m.num_inst <= 8;
  uint32_t c0 = 0u, c1 = 0u;
  vis = 1.0f;
  color = v3(1.0f, 1.0f, 1.0f);
  occ = FP16_MAX;
  uint32_t fetches = 0, boxes = 0, tris = 0;
  auto bound = [&]() { return max_dist; };
  auto leaf = [&](int word) {
    int start = leaf_start(word), count = leaf_count(word);
    for (int k = 0; k < LEAF_SIZE && k < count; ++k) {
      int ti = min(max(start + k, 0), m.num_tris - 1);
      float tt, tu, tv;
      bool base = tri_plane(m.plane + 3 * ti, o, d, RAY_TMIN, tt, tu, tv);
      tris += 1;
      if (!(base && tt <= max_dist)) continue;
      int it = __ldg(m.inst + ti);
      const float* row = m.inst_tbl + 8 * it;
      float tr = __ldg(row);
      if (tr < F(0.01)) blocked = true;  // opaque: the search ends after this leaf
      occ = minn(occ, tt);
      if (count_mode) {
        uint32_t inc = 1u << ((it & 3) * 8);
        if (it >= 4) c1 += inc;
        else c0 += inc;
      } else if (tr >= F(0.01)) {
        vis = vis * tr;
        color = mul(color, ld3(row + 4));
      }
    }
    return blocked;
  };
  if (!blocked) walk<MODE>(m, o, d, RAY_TMIN, bound, leaf, fetches, boxes);
  if (count_mode) {
    float cr = 1.0f, cg = 1.0f, cb = 1.0f;
    for (int i = 0; i < m.num_inst; ++i) {
      const float* row = m.inst_tbl + 8 * i;
      float tr = __ldg(row);
      uint32_t n_i = ((i >= 4 ? c1 : c0) >> ((i & 3) * 8)) & 255u;
      if (tr < F(0.01)) n_i = 0u;  // opaque instances act through `blocked` only
      vis = vis * pow_u8(tr, n_i);
      cr = cr * pow_u8(__ldg(row + 4), n_i);
      cg = cg * pow_u8(__ldg(row + 5), n_i);
      cb = cb * pow_u8(__ldg(row + 6), n_i);
    }
    color = v3(cr, cg, cb);
  }
  if (blocked) {
    vis = 0.0f;
    color = v3(0.0f, 0.0f, 0.0f);
  }
  add_counts<MODE>(m, WC_SHADOW, fetches, boxes, tris);
}

// ---- RNG (Common.hlsli:761-797) ---------------------------------------------
__device__ __forceinline__ uint32_t pcg_hash(uint32_t v) {
  v = v * 747796405u + 2891336453u;
  uint32_t word = ((v >> ((v >> 28u) + 4u)) ^ v) * 277803737u;
  return (word >> 22u) ^ word;
}
__device__ __forceinline__ uint32_t rng_init(uint32_t px, uint32_t py, uint32_t frame,
                                             uint32_t sample, uint32_t salt) {
  return pcg_hash(px * 1973u + py * 9277u + frame * 26699u + sample * 31837u + salt * 911u);
}
__device__ __forceinline__ float u24f(uint32_t s) {
  return (float)(s >> 8) * F(1.0 / 16777216.0);
}

// ---- intersection (Intersection.hlsl:17-198) --------------------------------
__device__ float isect_sphere(V3 o, V3 d, float tmin, float tmax, const float* s) {
  V3 oc = sub(o, ld3(s));
  float r = __ldg(s + 3);
  float a = dot(d, d);
  float b = 2.0f * dot(oc, d);
  float c = dot(oc, oc) - r * r;
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(maxn(disc, 0.0f));
  float t1 = (-b - sq) / (2.0f * a);
  float t2 = (-b + sq) / (2.0f * a);
  float t = t1 < tmin ? t2 : t1;
  bool ok = disc >= 0.0f && t >= tmin && t <= tmax && __ldg(s + 4) > 0.5f;
  return ok ? t : BIG;
}

__device__ float isect_plane(V3 o, V3 d, float tmin, float tmax, const float* p) {
  V3 n = normalize(ld3(p + 3));
  float denom = dot(d, n);
  V3 p0 = sub(ld3(p), o);
  bool big = fabsf(denom) > F(1e-4);
  float t = dot(p0, n) / (big ? denom : 1.0f);
  bool ok = big && t >= tmin && t <= tmax && __ldg(p + 6) > 0.5f;
  return ok ? t : BIG;
}

__device__ float isect_box(V3 o, V3 d, float tmin, float tmax, const float* b) {
  V3 delta = sub(o, ld3(b));
  float h[3] = {__ldg(b + 3), __ldg(b + 4), __ldg(b + 5)};
  float t_near = 0.0f, t_far = 0.0f;
  bool par_miss = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    V3 ax = ld3(b + 6 + 3 * k);
    float lo = dot(delta, ax);
    float ld = dot(d, ax);
    bool par = fabsf(ld) < F(1e-6);
    par_miss = par_miss || (par && (lo < -h[k] || lo > h[k]));
    float inv = 1.0f / (par ? 1.0f : ld);
    float t0 = par ? F(-1e20) : (-h[k] - lo) * inv;
    float t1 = par ? F(1e20) : (h[k] - lo) * inv;
    float smin = minn(t0, t1), smax = maxn(t0, t1);
    t_near = k == 0 ? smin : maxn(t_near, smin);
    t_far = k == 0 ? smax : minn(t_far, smax);
  }
  bool hit_any = t_near <= t_far && t_far >= tmin && !par_miss;
  float t = t_near >= tmin ? t_near : t_far;
  bool ok = hit_any && t >= tmin && t <= tmax && __ldg(b + 15) > 0.5f;
  return ok ? t : BIG;
}

// closest hit over spheres ++ planes ++ boxes; ties keep the first primitive;
// then, with MODE_MESH, the mesh walk, whose hit wins only when strictly
// nearer (the counting build counts it under class cls, WC_*).
template <int MODE>
__device__ Hit trace_closest(const Cfg& c, const Scene& sc, V3 o, V3 d, int skip_type,
                             int skip_index, int thick_inst, int cls = WC_SECONDARY) {
  float best_t = BIG;
  int best = 0, g = 0;
  for (int i = 0; i < c.S; ++i, ++g) {
    float t = isect_sphere(o, d, RAY_TMIN, RAY_TMAX, sc.sph + SPH_W * i);
    if (skip_type == TYPE_SPHERE && skip_index == i) t = BIG;
    if (t < best_t) { best_t = t; best = g; }
  }
  for (int i = 0; i < c.P; ++i, ++g) {
    float t = isect_plane(o, d, RAY_TMIN, RAY_TMAX, sc.pln + PLN_W * i);
    if (skip_type == TYPE_PLANE && skip_index == i) t = BIG;
    if (t < best_t) { best_t = t; best = g; }
  }
  for (int i = 0; i < c.B; ++i, ++g) {
    float t = isect_box(o, d, RAY_TMIN, RAY_TMAX, sc.box + BOX_W * i);
    if (skip_type == TYPE_BOX && skip_index == i) t = BIG;
    if (t < best_t) { best_t = t; best = g; }
  }
  Hit h;
  h.hit = best_t < F(1e30 * 0.5);
  h.t = best_t;
  h.slot = best;
  if (best >= c.S + c.P) { h.type = TYPE_BOX; h.index = best - c.S - c.P; }
  else if (best >= c.S) { h.type = TYPE_PLANE; h.index = best - c.S; }
  else { h.type = TYPE_SPHERE; h.index = best; }
  if (!h.hit) h.type = INVALID;
  h.tri = 0;
  h.u = h.v = 0.0f;
  h.thick_hit = false;
  h.thick_t = BIG;
  if constexpr ((MODE & MODE_MESH) != 0) {
    MeshHit mh = mesh_closest<MODE>(sc.mesh, o, d, RAY_TMIN, RAY_TMAX, skip_type == TYPE_MESH,
                                    skip_index, thick_inst, cls);
    h.thick_hit = mh.thick_hit;
    h.thick_t = mh.thick_t;
    if (mh.hit && mh.t < best_t) {
      h.hit = true;
      h.t = mh.t;
      h.type = TYPE_MESH;
      h.index = mh.inst;
      h.slot = c.S + c.P + c.B + mh.inst;
      h.tri = mh.tri;
      h.u = mh.u;
      h.v = mh.v;
    }
  }
  return h;
}

__device__ V3 box_face_normal(V3 pos, const float* b) {
  V3 c = ld3(b);
  float h[3] = {maxn(__ldg(b + 3), F(1e-4)), maxn(__ldg(b + 4), F(1e-4)),
                maxn(__ldg(b + 5), F(1e-4))};
  V3 axn[3];
  float local[3], scaled[3], sgn[3];
  V3 rel = sub(pos, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    axn[k] = normalize(ld3(b + 6 + 3 * k));
    local[k] = dot(rel, axn[k]);
    scaled[k] = fabsf(local[k] / h[k]);
    sgn[k] = local[k] >= 0.0f ? 1.0f : -1.0f;
  }
  bool x_wins = scaled[0] >= scaled[1] && scaled[0] >= scaled[2];
  bool y_wins = !x_wins && scaled[1] >= scaled[2];
  float l0 = x_wins ? sgn[0] : 0.0f;
  float l1 = y_wins ? sgn[1] : 0.0f;
  float l2 = (!x_wins && !y_wins) ? sgn[2] : 0.0f;
  V3 world = add(add(scale(axn[0], l0), scale(axn[1], l1)), scale(axn[2], l2));
  return normalize(world);
}

// Fill the launch configuration from the C arguments (see the entry points).
Cfg make_cfg(int width, int height, int S, int P, int B, int L, int spp, int max_bounces,
             int max_iters, int max_soft, int flags, float aspect) {
  Cfg c;
  c.width = width;
  c.height = height;
  c.row0 = 0;
  c.rows = height;
  c.S = S;
  c.P = P;
  c.B = B;
  c.L = L;
  c.spp = spp;
  c.max_bounces = max_bounces;
  c.max_iters = max_iters;
  c.max_soft = max_soft;
  c.has_lights = flags & 1;
  c.any_glass = flags & 2;
  c.any_metal = flags & 4;
  c.any_absorption = flags & 8;
  c.debug = (flags >> 4) & 3;
  c.aspect = aspect;
  return c;
}

// c with the row band [row0, row0 + rows) of its frame
Cfg band_cfg(Cfg c, int row0, int rows) {
  c.row0 = row0;
  c.rows = rows;
  return c;
}

// Point the scene at ftab's tables; M material rows (S+P+B, plus one per
// mesh instance, at least 1).
Scene make_scene(const float* ftab, int S, int P, int B, int M, int L) {
  Scene sc = {};
  sc.sph = ftab;
  sc.pln = sc.sph + SPH_W * S;
  sc.box = sc.pln + PLN_W * P;
  sc.mat = sc.box + BOX_W * B;
  sc.lts = sc.mat + MAT_W * M;
  sc.par = sc.lts + LT_W * L;
  sc.bn = sc.par + 32;
  return sc;
}
}  // namespace
