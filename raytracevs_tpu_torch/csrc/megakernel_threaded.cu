// The render kernels' mesh instantiations whose walks follow the fine
// tree's threaded links (render.cuh with MODE_THREADED; closest.cuh::
// walk_threaded): K1-mesh, K7-mesh and K8-mesh for a wide table whose walks
// need more stack than WALK_STACK, and their counting build. The _mesh
// entries of megakernel.cu and megakernel_count.cu call them given
// threaded != 0 (ops/cuda/megakernel.py::check_mesh's choice), nodes being
// the fine nodes [Nn,8] of ops/cuda/megakernel.py::fine_nodes. Their own
// file so that nvcc builds them beside megakernel.cu.

#include "render.cuh"

namespace {
constexpr int THREADED = MODE_MESH | MODE_THREADED;
}  // namespace

int render_accum_threaded(bool phase_a, ACCUM_PARAMS, MESH_PARAMS, unsigned long long* counts,
                          void* stream) {
  if (phase_a && spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  if (counts != nullptr)
    return phase_a ? launch_accum<THREADED | MODE_COUNT, true>(c, sc, itab, out, stream)
                   : launch_accum<THREADED | MODE_COUNT, false>(c, sc, itab, out, stream);
  return phase_a ? launch_accum<THREADED, true>(c, sc, itab, out, stream)
                 : launch_accum<THREADED, false>(c, sc, itab, out, stream);
}

int render_phase_b_threaded(PHASE_B_PARAMS, MESH_PARAMS, unsigned long long* counts,
                            void* stream) {
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  if (counts != nullptr)
    return launch_phase_b<THREADED | MODE_COUNT>(c, sc, itab, order, count, hits, lanes, acc,
                                                 stream);
  return launch_phase_b<THREADED>(c, sc, itab, order, count, hits, lanes, acc, stream);
}
