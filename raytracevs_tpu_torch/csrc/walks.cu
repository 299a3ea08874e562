// The mesh walks alone (closest.cuh) for n given rays, one thread a ray:
// the walk-only entry points, which tests/test_torch_gpu.py and
// chip_smoke.py hold bit for bit against the plain walks
// (ops/bvh.py::traverse_closest, traverse_shadow) on the render's tables.
// Each runs the wide walks, or, given threaded != 0, the walks of the fine
// tree's threaded links (the render kernels' MODE_THREADED, for a table
// deeper than WALK_STACK). Wrapped by ops/cuda/mesh_walks.py; each returns
// the launch's cudaError_t.

#include "closest.cuh"

namespace {

Mesh walk_mesh(const float* nodes, const float* plane, const int* inst, const float* inst_tbl,
               int num_tris, int num_inst, int num_nodes) {
  Mesh m = {};
  m.nodes = reinterpret_cast<const float4*>(nodes);
  m.plane = reinterpret_cast<const float4*>(plane);
  m.inst = inst;
  m.inst_tbl = inst_tbl;
  m.num_tris = num_tris;
  m.num_inst = num_inst;
  m.num_nodes = num_nodes;
  return m;
}

template <int MODE>
__global__ void __launch_bounds__(256)
    walk_closest_kernel(Mesh m, int n, const float* __restrict__ o, const float* __restrict__ d,
                        float tmin, float tmax, const uint8_t* __restrict__ skip_active,
                        const int* __restrict__ skip_inst, const int* __restrict__ thick_inst,
                        float* t, int* tri, float* u, float* v, int* inst, uint8_t* hit,
                        uint8_t* thick_hit, float* thick_t) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  MeshHit h = mesh_closest<MODE>(m, ld3(o + 3 * i), ld3(d + 3 * i), tmin, tmax,
                                  __ldg(skip_active + i) != 0, __ldg(skip_inst + i),
                                  __ldg(thick_inst + i), WC_SECONDARY);
  t[i] = h.t;
  tri[i] = h.tri;
  u[i] = h.u;
  v[i] = h.v;
  inst[i] = h.inst;
  hit[i] = h.hit;
  thick_hit[i] = h.thick_hit;
  thick_t[i] = h.thick_t;
}

template <int MODE>
__global__ void __launch_bounds__(256)
    walk_shadow_kernel(Mesh m, int n, const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ max_dist, const uint8_t* __restrict__ blocked,
                       float* vis, float* color, float* occ) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sv, so;
  V3 sc;
  mesh_shadow<MODE>(m, ld3(o + 3 * i), ld3(d + 3 * i), __ldg(max_dist + i),
                     __ldg(blocked + i) != 0, sv, sc, so);
  vis[i] = sv;
  color[3 * i] = sc.x;
  color[3 * i + 1] = sc.y;
  color[3 * i + 2] = sc.z;
  occ[i] = so;
}

}  // namespace

// nodes: the wide nodes [W,32], or given threaded the fine nodes [Nn,8]
// (fine_nodes) of num_nodes; plane [T,12], inst [T] int32, inst_tbl [I,8]
// (pack_mesh); n rays: o, d [n,3]; tmin, tmax; skip_active [n] uint8, skip_inst and
// thick_inst [n] int32. Out [n]: t, tri (int32), u, v, inst (int32), hit
// (uint8), thick_hit (uint8), thick_t.
extern "C" int rtvs_mesh_closest(const float* nodes, const float* plane, const int* inst,
                                 const float* inst_tbl, int num_tris, int num_inst,
                                 int num_nodes, int threaded, int n,
                                 const float* o, const float* d, float tmin, float tmax,
                                 const uint8_t* skip_active, const int* skip_inst,
                                 const int* thick_inst, float* t, int* tri, float* u, float* v,
                                 int* inst_out, uint8_t* hit, uint8_t* thick_hit,
                                 float* thick_t, void* stream) {
  if (n <= 0) return 0;
  Mesh m = walk_mesh(nodes, plane, inst, inst_tbl, num_tris, num_inst, num_nodes);
  int blocks = (n + 255) / 256;
  if (threaded)
    walk_closest_kernel<MODE_MESH | MODE_THREADED><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        m, n, o, d, tmin, tmax, skip_active, skip_inst, thick_inst, t, tri, u, v, inst_out, hit,
        thick_hit, thick_t);
  else
    walk_closest_kernel<MODE_MESH><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        m, n, o, d, tmin, tmax, skip_active, skip_inst, thick_inst, t, tri, u, v, inst_out, hit,
        thick_hit, thick_t);
  return (int)cudaGetLastError();
}

// The tables as rtvs_mesh_closest's; n rays: o, d [n,3], max_dist [n],
// blocked [n] uint8 (an opaque analytic hit ended the search). Out: vis
// [n], color [n,3], occ [n].
extern "C" int rtvs_mesh_shadow(const float* nodes, const float* plane, const int* inst,
                                const float* inst_tbl, int num_tris, int num_inst, int num_nodes,
                                int threaded, int n,
                                const float* o, const float* d, const float* max_dist,
                                const uint8_t* blocked, float* vis, float* color, float* occ,
                                void* stream) {
  if (n <= 0) return 0;
  Mesh m = walk_mesh(nodes, plane, inst, inst_tbl, num_tris, num_inst, num_nodes);
  int blocks = (n + 255) / 256;
  if (threaded)
    walk_shadow_kernel<MODE_MESH | MODE_THREADED><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        m, n, o, d, max_dist, blocked, vis, color, occ);
  else
    walk_shadow_kernel<MODE_MESH><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        m, n, o, d, max_dist, blocked, vis, color, occ);
  return (int)cudaGetLastError();
}
