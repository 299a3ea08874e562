// The render kernels' mesh instantiations whose walks follow the fine
// tree's threaded links (render.cuh with MODE_THREADED; closest.cuh::
// walk_threaded): K1-mesh, K7-mesh and K8-mesh for a wide table whose walks
// need more stack than WALK_STACK, and their counting build given counts.
// The entries of megakernel.cu call them given threaded != 0
// (ops/cuda/megakernel.py::check_mesh's choice), nodes being the fine
// nodes [Nn,8] of ops/cuda/megakernel.py::fine_nodes. Their own file so
// that nvcc builds them beside megakernel.cu.

#include "render.cuh"

namespace {
constexpr int THREADED = MODE_MESH | MODE_THREADED;
}  // namespace

int render_accum_threaded(bool phase_a, ACCUM_PARAMS, MESH_PARAMS, unsigned long long* counts,
                          void* stream) {
  if (counts != nullptr)
    return accum_as<THREADED | MODE_COUNT>(phase_a, ACCUM_ARGS, MESH_ARGS, counts, stream);
  return accum_as<THREADED>(phase_a, ACCUM_ARGS, MESH_ARGS, nullptr, stream);
}

int render_phase_b_threaded(PHASE_B_PARAMS, MESH_PARAMS, unsigned long long* counts,
                            void* stream) {
  if (counts != nullptr)
    return phase_b_as<THREADED | MODE_COUNT>(PHASE_B_ARGS, MESH_ARGS, counts, stream);
  return phase_b_as<THREADED>(PHASE_B_ARGS, MESH_ARGS, nullptr, stream);
}
