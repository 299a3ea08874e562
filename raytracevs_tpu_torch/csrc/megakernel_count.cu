// The counting build of the mesh render kernels (render.cuh, MESH=2):
// K1-mesh, K7-mesh and K8-mesh, each adding its mesh walks' work to a
// [4][4] uint64 table: per ray class (closest.cuh WC_*: primary,
// secondary, pending thickness, shadow) the walks, node fetches, box tests
// and triangle tests. It renders what the plain instantiation renders; the
// atomics make it slower, so it measures work, not time. The counterpart of
// the JAX package's RTVS_MK_STATS node and leaf counts (megakernel.py:78).
// Its own file so that nvcc builds it beside megakernel.cu.

#include "render.cuh"

// rtvs_render_accum_mesh's arguments, then counts [4][4] uint64 (added to)
extern "C" int rtvs_render_accum_mesh_count(const float* ftab, const int* itab, float* out,
                                            int width, int height, int S, int P, int B, int L,
                                            int spp, int max_bounces, int max_iters,
                                            int max_soft, int flags, float aspect, MESH_PARAMS,
                                            unsigned long long* counts, void* stream) {
  Cfg c = make_cfg(width, height, S, P, B, L, spp, max_bounces, max_iters, max_soft, flags,
                   aspect);
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  return launch_accum<2, false>(c, sc, itab, out, stream);
}

// rtvs_render_phase_a_mesh's arguments, then counts
extern "C" int rtvs_render_phase_a_mesh_count(const float* ftab, const int* itab, float* out,
                                              int width, int height, int S, int P, int B, int L,
                                              int spp, int max_bounces, int max_iters,
                                              int max_soft, int flags, float aspect,
                                              MESH_PARAMS, unsigned long long* counts,
                                              void* stream) {
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = make_cfg(width, height, S, P, B, L, spp, max_bounces, max_iters, max_soft, flags,
                   aspect);
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  return launch_accum<2, true>(c, sc, itab, out, stream);
}

// rtvs_render_phase_b_mesh's arguments, then counts
extern "C" int rtvs_render_phase_b_mesh_count(const float* ftab, const int* itab,
                                              const int* order, const int* count, float* acc,
                                              const float* hits, int lanes, int width,
                                              int height, int S, int P, int B, int L, int spp,
                                              int max_bounces,
                                              int max_iters, int max_soft, int flags,
                                              float aspect, MESH_PARAMS,
                                              unsigned long long* counts, void* stream) {
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = make_cfg(width, height, S, P, B, L, spp, max_bounces, max_iters, max_soft, flags,
                   aspect);
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  return launch_phase_b<2>(c, sc, itab, order, count, hits, lanes, acc, stream);
}
