// Entry points of the render kernels K1, K7 and K8 (render.cuh) for Hopper
// (sm_90a), one each. Each chooses its instantiation: given threaded != 0
// (a mesh whose wide table is deeper than WALK_STACK) the walks of the fine
// tree's threaded links (megakernel_threaded.cu), else given counts the
// counting build (megakernel_count.cu), else MODE_MESH for a scene with
// meshes and MODE 0 without. Plain C interface, called through ctypes by
// ops/cuda/megakernel.py; each returns the launch's cudaError_t.

#include "render.cuh"

namespace {
// K1, or K7 given phase_a
int accum(bool phase_a, ACCUM_PARAMS, MESH_PARAMS, int threaded, unsigned long long* counts,
          void* stream) {
  if (nodes != nullptr && threaded)
    return render_accum_threaded(phase_a, ACCUM_ARGS, MESH_ARGS, counts, stream);
  if (counts != nullptr) return render_accum_count(phase_a, ACCUM_ARGS, MESH_ARGS, counts, stream);
  if (nodes != nullptr) return accum_as<MODE_MESH>(phase_a, ACCUM_ARGS, MESH_ARGS, nullptr, stream);
  return accum_as<0>(phase_a, ACCUM_ARGS, MESH_ARGS, nullptr, stream);
}
}  // namespace

// K1. ftab: the float tables of pack_scene (spheres, planes, boxes,
// materials, lights, 32 params, the 16x16x4 blue-noise tile); itab:
// [num_lights, max_shadow_lights, frame]; width x height: the frame; out:
// [32, rows, width], the planes of its rows [row0, row0 + rows), 32 * rows
// * width < 2**31 (a 32-bit plane index). flags: bit 0 has_lights, 1
// any_glass, 2 any_metal, 3 any_absorption; bits 4-5 the photon debug
// shading at depth-0 hits (0 off, 1 transmission as grey: mode 3, 2
// metallic: mode 4). Then the mesh tables of make_mesh_scene, I mesh
// instances having material rows S+P+B+i (nodes: the wide table, or given
// threaded the fine nodes; nodes null: a scene without meshes, the other
// mesh pointers null and T = I = Nn = 0), threaded, and counts: the
// counting build's [COUNT_ROWS][4] uint64 table, added to (null: the plain
// build).
extern "C" int rtvs_render_accum(ACCUM_PARAMS, MESH_PARAMS, int threaded,
                                 unsigned long long* counts, void* stream) {
  return accum(false, ACCUM_ARGS, MESH_ARGS, threaded, counts, stream);
}

// K7: as rtvs_render_accum with spp 1 (anything else is refused), out
// [46, rows, width]: the 32 planes of one iteration, the spawned
// continuation (valid, origin xyz, direction xyz), then the primary ray's
// closest hit (hit, t, type, index, triangle, u, v; ints as their bits).
extern "C" int rtvs_render_phase_a(ACCUM_PARAMS, MESH_PARAMS, int threaded,
                                   unsigned long long* counts, void* stream) {
  if (spp != 1) return (int)cudaErrorInvalidValue;
  return accum(true, ACCUM_ARGS, MESH_ARGS, threaded, counts, stream);
}

// K8: order [lanes] int32 pixel ids in the band (row0 + id / width is the
// frame's row), count [1] int32 (lanes past it exit), acc [32, rows, width]
// (K7's first 32 planes of the band), updated in place, hits [7, rows,
// width] (K7's hit planes); the rest as rtvs_render_accum, spp 1.
extern "C" int rtvs_render_phase_b(PHASE_B_PARAMS, MESH_PARAMS, int threaded,
                                   unsigned long long* counts, void* stream) {
  if (spp != 1) return (int)cudaErrorInvalidValue;
  if (nodes != nullptr && threaded)
    return render_phase_b_threaded(PHASE_B_ARGS, MESH_ARGS, counts, stream);
  if (counts != nullptr) return render_phase_b_count(PHASE_B_ARGS, MESH_ARGS, counts, stream);
  if (nodes != nullptr) return phase_b_as<MODE_MESH>(PHASE_B_ARGS, MESH_ARGS, nullptr, stream);
  return phase_b_as<0>(PHASE_B_ARGS, MESH_ARGS, nullptr, stream);
}
