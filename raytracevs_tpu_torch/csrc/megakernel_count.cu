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
// package's RTVS_MK_STATS node and leaf counts (megakernel.py:78). The
// entries of megakernel.cu call it given counts; its own file so that nvcc
// builds it beside megakernel.cu. The threaded walks' counting build is in
// megakernel_threaded.cu.

#include "render.cuh"

int render_accum_count(bool phase_a, ACCUM_PARAMS, MESH_PARAMS, unsigned long long* counts,
                       void* stream) {
  if (nodes != nullptr)
    return accum_as<MODE_MESH | MODE_COUNT>(phase_a, ACCUM_ARGS, MESH_ARGS, counts, stream);
  return accum_as<MODE_COUNT>(phase_a, ACCUM_ARGS, MESH_ARGS, counts, stream);
}

int render_phase_b_count(PHASE_B_PARAMS, MESH_PARAMS, unsigned long long* counts, void* stream) {
  if (nodes != nullptr)
    return phase_b_as<MODE_MESH | MODE_COUNT>(PHASE_B_ARGS, MESH_ARGS, counts, stream);
  return phase_b_as<MODE_COUNT>(PHASE_B_ARGS, MESH_ARGS, counts, stream);
}
