// Entry points of the render kernels K1, K7 and K8 (render.cuh) for Hopper
// (sm_90a), each instantiated without meshes and with them (the wide-node
// walks of closest.cuh, or given threaded != 0 the walks of the fine tree's
// threaded links, instantiated in megakernel_threaded.cu, for a wide table
// deeper than WALK_STACK); their counting build is megakernel_count.cu.
// Plain C interface, called through ctypes by ops/cuda/megakernel.py; each
// returns the launch's cudaError_t.

#include "render.cuh"

// ftab: the float tables of pack_scene (spheres, planes, boxes, materials,
// lights, 32 params, the 16x16x4 blue-noise tile); itab: [num_lights,
// max_shadow_lights, frame]; width x height: the frame; out: [32, rows,
// width], the planes of its rows [row0, row0 + rows), 32 * rows * width <
// 2**31 (a 32-bit plane index). flags: bit 0 has_lights, 1 any_glass, 2
// any_metal, 3 any_absorption; bits 4-5 the photon debug shading at depth-0
// hits (0 off, 1 transmission as grey: mode 3, 2 metallic: mode 4).
extern "C" int rtvs_render_accum(ACCUM_PARAMS, void* stream) {
  Cfg c = ENTRY_CFG;
  Scene sc = make_scene(ftab, S, P, B, S + P + B > 0 ? S + P + B : 1, L);
  return launch_accum<0, false>(c, sc, itab, out, stream);
}

// K1-mesh: as rtvs_render_accum, with I mesh instances (material rows
// S+P+B+i) and the mesh tables of make_mesh_scene (nodes: the wide table,
// or given threaded the fine nodes).
extern "C" int rtvs_render_accum_mesh(ACCUM_PARAMS, MESH_PARAMS, int threaded, void* stream) {
  if (threaded) return render_accum_threaded(false, ACCUM_ARGS, MESH_ARGS, nullptr, stream);
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, nullptr);
  return launch_accum<MODE_MESH, false>(c, sc, itab, out, stream);
}

// K7: as rtvs_render_accum with spp 1 (anything else is refused), out
// [46, rows, width]: the 32 planes of one iteration, the spawned
// continuation (valid, origin xyz, direction xyz), then the primary ray's
// closest hit (hit, t, type, index, triangle, u, v; ints as their bits).
extern "C" int rtvs_render_phase_a(ACCUM_PARAMS, void* stream) {
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_scene(ftab, S, P, B, S + P + B > 0 ? S + P + B : 1, L);
  return launch_accum<0, true>(c, sc, itab, out, stream);
}

// K7 with meshes: the arguments of rtvs_render_accum_mesh, out as K7's.
extern "C" int rtvs_render_phase_a_mesh(ACCUM_PARAMS, MESH_PARAMS, int threaded, void* stream) {
  if (threaded) return render_accum_threaded(true, ACCUM_ARGS, MESH_ARGS, nullptr, stream);
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, nullptr);
  return launch_accum<MODE_MESH, true>(c, sc, itab, out, stream);
}

// K8: order [lanes] int32 pixel ids in the band (row0 + id / width is the
// frame's row), count [1] int32 (lanes past it exit), acc [32, rows, width]
// (K7's first 32 planes of the band), updated in place, hits [7, rows,
// width] (K7's hit planes); the rest as rtvs_render_accum, spp 1.
extern "C" int rtvs_render_phase_b(PHASE_B_PARAMS, void* stream) {
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_scene(ftab, S, P, B, S + P + B > 0 ? S + P + B : 1, L);
  return launch_phase_b<0>(c, sc, itab, order, count, hits, lanes, acc, stream);
}

// K8 with meshes: rtvs_render_phase_b's arguments, then the mesh tables
// and threaded as rtvs_render_accum_mesh's.
extern "C" int rtvs_render_phase_b_mesh(PHASE_B_PARAMS, MESH_PARAMS, int threaded,
                                        void* stream) {
  if (threaded) return render_phase_b_threaded(PHASE_B_ARGS, MESH_ARGS, nullptr, stream);
  if (spp != 1) return (int)cudaErrorInvalidValue;
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, nullptr);
  return launch_phase_b<MODE_MESH>(c, sc, itab, order, count, hits, lanes, acc, stream);
}
