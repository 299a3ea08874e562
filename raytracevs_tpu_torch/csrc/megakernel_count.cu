// The counting build of the render kernels (render.cuh, MODE_COUNT): K1,
// K7 and K8, without and with meshes, each adding its work to a [COUNT_ROWS][4]
// uint64 table (ops/cuda/megakernel.py::COUNT_ROWS): per ray class of its
// mesh walks (closest.cuh WC_*: primary, secondary, pending thickness,
// shadow) the walks, node fetches, box tests and triangle tests; then its
// DFS's lane iterations, warp iterations x 32 (their ratio is the loop's
// SIMT share), items capped at the depth limit and items killed by their
// throughput; shade calls at depth 0 and deeper, shadow rays and thickness
// rays. It renders what the plain instantiation renders; the atomics make
// it slower, so it measures work, not time. The counterpart of the JAX
// package's RTVS_MK_STATS node and leaf counts (megakernel.py:78). Its own
// file so that nvcc builds it beside megakernel.cu; the threaded walks'
// counting build is in megakernel_threaded.cu.

#include "render.cuh"

// rtvs_render_accum's arguments, then counts [COUNT_ROWS][4] uint64 (added to)
extern "C" int rtvs_render_accum_count(ACCUM_PARAMS, unsigned long long* counts, void* stream) {
  Cfg c = ENTRY_CFG;
  Scene sc = make_scene(ftab, S, P, B, S + P + B > 0 ? S + P + B : 1, L);
  sc.counts = counts;
  return launch_accum<MODE_COUNT, false>(c, sc, itab, out, stream);
}

// rtvs_render_phase_a's arguments, then counts
extern "C" int rtvs_render_phase_a_count(ACCUM_PARAMS, unsigned long long* counts,
                                         void* stream) {
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_scene(ftab, S, P, B, S + P + B > 0 ? S + P + B : 1, L);
  sc.counts = counts;
  return launch_accum<MODE_COUNT, true>(c, sc, itab, out, stream);
}

// rtvs_render_phase_b's arguments, then counts
extern "C" int rtvs_render_phase_b_count(PHASE_B_PARAMS, unsigned long long* counts,
                                         void* stream) {
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_scene(ftab, S, P, B, S + P + B > 0 ? S + P + B : 1, L);
  sc.counts = counts;
  return launch_phase_b<MODE_COUNT>(c, sc, itab, order, count, hits, lanes, acc, stream);
}

// rtvs_render_accum_mesh's arguments, then counts
extern "C" int rtvs_render_accum_mesh_count(ACCUM_PARAMS, MESH_PARAMS, int threaded,
                                            unsigned long long* counts, void* stream) {
  if (threaded) return render_accum_threaded(false, ACCUM_ARGS, MESH_ARGS, counts, stream);
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  return launch_accum<MODE_MESH | MODE_COUNT, false>(c, sc, itab, out, stream);
}

// rtvs_render_phase_a_mesh's arguments, then counts
extern "C" int rtvs_render_phase_a_mesh_count(ACCUM_PARAMS, MESH_PARAMS, int threaded,
                                              unsigned long long* counts, void* stream) {
  if (threaded) return render_accum_threaded(true, ACCUM_ARGS, MESH_ARGS, counts, stream);
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  return launch_accum<MODE_MESH | MODE_COUNT, true>(c, sc, itab, out, stream);
}

// rtvs_render_phase_b_mesh's arguments, then counts
extern "C" int rtvs_render_phase_b_mesh_count(PHASE_B_PARAMS, MESH_PARAMS, int threaded,
                                              unsigned long long* counts, void* stream) {
  if (threaded) return render_phase_b_threaded(PHASE_B_ARGS, MESH_ARGS, counts, stream);
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  return launch_phase_b<MODE_MESH | MODE_COUNT>(c, sc, itab, order, count, hits, lanes, acc,
                                                stream);
}
