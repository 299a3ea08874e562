// K9 rtvs_assemble: the frame's G-buffer assembly for Hopper (sm_90a),
// from the render kernels' accumulator planes to the HDR colour and the
// NRD G-buffer, the plain version ops/render_cf.py::assemble_frame_cf
// (RayGen.hlsl:850-1044, NRDEncoding.hlsli:302-376) operation for
// operation (see common.cuh), so bit-equal to it on the card.
//
// It replaces no TPU kernel: the JAX package leaves this chain of
// elementwise planes to XLA, which fuses it. It was added because the port
// ran it as ~250 PyTorch launches a frame (the host issuing them left the
// device idle ~4.8 ms of a 20-ms 1080p frame) and because it reads every
// plane once: one thread a pixel reads the 28 accumulator planes it
// needs and writes the 30 float planes and the int32 object ids, coalesced
// by row. Bound: device memory, 489 MB at 1080p in photon debug mode 0
// (0.146 ms at 3.35 TB/s). The camera's vectors and matrices are read from
// the scene's device tensors in the kernel, so the host reads nothing of
// the device.
//
// The arithmetic is PyTorch's on CUDA: a tensor times a Python number
// multiplies by that number as a float32; vec.div_const and tensor over
// tensor are true divisions; torch.clamp and torch.maximum are common.cuh's
// tclamp, tclamp_lo and tmaximum.

#include "common.cuh"

namespace {

// the accumulator's channels (ops/render.py)
constexpr int CH_COLOR = 0, CH_PRIMARY = 3, CH_DIFFUSE = 6, CH_SPECULAR = 9, CH_HITDIST = 12,
              CH_BOUNCE = 13, CH_PRIM_HIT = 15, CH_NORMAL = 16, CH_ROUGH = 19, CH_ALBEDO = 20,
              CH_METALLIC = 23, CH_TRANSMISSION = 24, CH_POS = 25, CH_SHADOW_VIS = 28,
              CH_SHADOW_PEN = 29, CH_SHADOW_DIST = 30, CH_OBJ_ID = 31;
// the output's planes (ops/cuda/gbuffer_kernels.py::PLANES)
constexpr int G_DIFFUSE = 0, G_SPECULAR = 4, G_COLOR = 8, G_NORMAL_ROUGH = 11, G_VIEW_Z = 15,
              G_MOTION = 16, G_MOTION_SPEC = 18, G_ALBEDO = 20, G_SHADOW = 24,
              G_TRANSLUCENCY = 26, G_PLANES = 30;
constexpr int AS_THREADS = 256;

#define VIEWZ_MIN F(0.01)
#define VIEWZ_SKY F(10000.0)
#define MV_CLAMP F(64.0)
#define NRD_FP16_MAX F(65504.0)

// NDC x, y of world point p under the row-vector matrix vp [4,4]
// (render_cf.py::_clip_xy)
__device__ __forceinline__ void clip_xy(const float* __restrict__ vp, V3 p, float& x, float& y) {
  float cx = p.x * __ldg(vp + 0) + p.y * __ldg(vp + 4) + p.z * __ldg(vp + 8) + __ldg(vp + 12);
  float cy = p.x * __ldg(vp + 1) + p.y * __ldg(vp + 5) + p.z * __ldg(vp + 9) + __ldg(vp + 13);
  float cw = p.x * __ldg(vp + 3) + p.y * __ldg(vp + 7) + p.z * __ldg(vp + 11) + __ldg(vp + 15);
  float safe_w = fabsf(cw) < F(1e-9) ? 1.0f : cw;
  x = cx / safe_w;
  y = cy / safe_w;
}

// the clamped pixel-space motion of p, zero off hits (render_cf.py::_motion)
__device__ __forceinline__ void motion(const float* __restrict__ vp, const float* __restrict__ pvp,
                                       V3 p, bool hit, float half_w, float half_h, float& mx,
                                       float& my) {
  float cx, cy, px, py;
  clip_xy(vp, p, cx, cy);
  clip_xy(pvp, p, px, py);
  float mvx = tclamp((cx - px) * half_w, -MV_CLAMP, MV_CLAMP);
  float mvy = tclamp((cy - py) * half_h, -MV_CLAMP, MV_CLAMP);
  mx = hit ? mvx : 0.0f;
  my = hit ? mvy : 0.0f;
}

// One thread a pixel of n: acc's channels at plane stride n, out's G_PLANES
// planes and obj_id likewise. mode: the photon debug mode (1 or 2; 0 for
// any other); inv: 1 / spp as a float32; max_b: max(max_bounces, 1);
// half_w, half_h: the frame's width and height times 0.5.
__global__ void __launch_bounds__(AS_THREADS)
    assemble_kernel(const float* __restrict__ acc, const float* __restrict__ cam_right,
                    const float* __restrict__ cam_up, const float* __restrict__ cam_forward,
                    const float* __restrict__ cam_pos, const float* __restrict__ vp,
                    const float* __restrict__ pvp, float* __restrict__ out,
                    int* __restrict__ obj_id, size_t n, int mode, float inv, float max_b,
                    float half_w, float half_h) {
  const size_t i = (size_t)blockIdx.x * AS_THREADS + threadIdx.x;
  if (i >= n) return;
  const float* a = acc + i;
  auto ch = [&](int c) { return __ldg(a + (size_t)c * n); };
  auto ch3 = [&](int c) { return v3(ch(c), ch(c + 1), ch(c + 2)); };
  auto put = [&](int k, float v) { out[(size_t)k * n + i] = v; };

  V3 fc;  // final_color
  if (mode == 2) {  // the bounce count over the budget as grey
    float ratio = tclamp(ch(CH_BOUNCE) * inv / max_b, 0.0f, 1.0f);
    fc = v3(ratio, ratio, ratio);
  } else if (mode == 1) {  // the colour without its depth-0 contribution
    V3 d = sub(ch3(CH_COLOR), ch3(CH_PRIMARY));
    fc = v3(tclamp_lo(d.x * inv, 0.0f), tclamp_lo(d.y * inv, 0.0f), tclamp_lo(d.z * inv, 0.0f));
  } else {
    fc = scale(ch3(CH_COLOR), inv);
  }
  const bool hit = ch(CH_PRIM_HIT) > F(0.5);
  const V3 wn = hit ? ch3(CH_NORMAL) : v3(0.0f, 1.0f, 0.0f);
  const float rough = hit ? ch(CH_ROUGH) : 1.0f;
  const V3 albedo = hit ? ch3(CH_ALBEDO) : v3(1.0f, 1.0f, 1.0f);

  // material classification (RayGen.hlsl:913-963)
  const float spec_dom = tmaximum(ch(CH_TRANSMISSION), ch(CH_METALLIC));
  float t = tclamp((spec_dom - F(0.3)) / F(0.7 - 0.3), 0.0f, 1.0f);
  const float blend = 1.0f - t * t * (F(3.0) - t * F(2.0));
  const V3 dmod = scale(ch3(CH_DIFFUSE), inv);
  const V3 dspec = scale(ch3(CH_SPECULAR), inv);
  const V3 d0 = sub(sub(fc, dmod), dspec);
  const V3 secondary = v3(tclamp_lo(d0.x, 0.0f), tclamp_lo(d0.y, 0.0f), tclamp_lo(d0.z, 0.0f));
  const V3 demod = v3(dmod.x / tclamp_lo(albedo.x, F(0.04)), dmod.y / tclamp_lo(albedo.y, F(0.04)),
                      dmod.z / tclamp_lo(albedo.z, F(0.04)));
  const bool mirror = spec_dom > F(0.7), mixed = spec_dom > F(0.3);
  const V3 dsum = add(dspec, secondary);
  const V3 spec_mid = add(fc, scale(sub(dsum, fc), blend));
  const V3 diffuse_nrd =
      hit ? (mirror ? v3(0.0f, 0.0f, 0.0f) : (mixed ? scale(demod, blend) : demod)) : fc;
  const V3 specular_nrd = hit ? (mirror ? fc : (mixed ? spec_mid : dsum)) : v3(0.0f, 0.0f, 0.0f);
  const float mean_hd = ch(CH_HITDIST) * inv;

  // NRD inputs (NRDEncoding.hlsli:302-376)
  const V3 f = ld3(cam_forward);
  V3 vn = v3(dot(wn, ld3(cam_right)), dot(wn, ld3(cam_up)), dot(wn, f));
  const float m = tclamp_lo(sqrtf(dot(vn, vn)), F(1e-12));
  vn = v3(vn.x / m, vn.y / m, vn.z / m);
  const V3 pos = ch3(CH_POS);
  const V3 rel = sub(pos, ld3(cam_pos));
  const float view_z = hit ? tclamp_lo(dot(rel, f), VIEWZ_MIN) : VIEWZ_SKY;
  // the octahedral encoding (NRDEncoding.hlsli:73-79)
  const float s = tclamp_lo(fabsf(vn.x) + fabsf(vn.y) + fabsf(vn.z), F(1e-12));
  const float ex = vn.x / s, ey = vn.y / s, ez = vn.z / s;
  const bool up = ez >= 0.0f;
  const float ox = up ? ex : (1.0f - fabsf(ey)) * (ex >= 0.0f ? 1.0f : -1.0f);
  const float oy = up ? ey : (1.0f - fabsf(ex)) * (ey >= 0.0f ? 1.0f : -1.0f);

  // motion, and the specular virtual motion: X + V hitDist (1 - roughness)
  float mx, my, sx, sy;
  motion(vp, pvp, pos, hit, half_w, half_h, mx, my);
  const float vlen = sqrtf(tclamp_lo(dot(rel, rel), F(1e-18)));
  const float v_amount = tclamp(1.0f - rough, 0.0f, 1.0f);
  const float vd = tclamp_lo(mean_hd, 0.0f) * v_amount / vlen;
  motion(vp, pvp, add(pos, scale(rel, vd)), hit, half_w, half_h, sx, sy);

  // SIGMA shadow inputs from the raw first sample (RayGen.hlsl:1002-1039)
  const float vis = ch(CH_SHADOW_VIS);
  float sigma_pen = vis > F(0.99) ? NRD_FP16_MAX : tclamp(ch(CH_SHADOW_PEN), F(0.1), F(100.0));
  float vis_clean = tclamp(vis, 0.0f, 1.0f);
  vis_clean = isfinite(vis_clean) ? vis_clean : 1.0f;
  sigma_pen = isfinite(sigma_pen) ? sigma_pen : NRD_FP16_MAX;

  put(G_DIFFUSE + 0, diffuse_nrd.x);
  put(G_DIFFUSE + 1, diffuse_nrd.y);
  put(G_DIFFUSE + 2, diffuse_nrd.z);
  put(G_DIFFUSE + 3, mean_hd);
  put(G_SPECULAR + 0, specular_nrd.x);
  put(G_SPECULAR + 1, specular_nrd.y);
  put(G_SPECULAR + 2, specular_nrd.z);
  put(G_SPECULAR + 3, mean_hd);
  put(G_COLOR + 0, fc.x);
  put(G_COLOR + 1, fc.y);
  put(G_COLOR + 2, fc.z);
  put(G_NORMAL_ROUGH + 0, ox * 0.5f + 0.5f);
  put(G_NORMAL_ROUGH + 1, oy * 0.5f + 0.5f);
  put(G_NORMAL_ROUGH + 2, vn.z >= 0.0f ? 1.0f : 0.0f);
  put(G_NORMAL_ROUGH + 3, sqrtf(tclamp(rough, 0.0f, 1.0f)));
  put(G_VIEW_Z, view_z);
  put(G_MOTION + 0, mx);
  put(G_MOTION + 1, my);
  put(G_MOTION_SPEC + 0, sx);
  put(G_MOTION_SPEC + 1, sy);
  put(G_ALBEDO + 0, albedo.x);
  put(G_ALBEDO + 1, albedo.y);
  put(G_ALBEDO + 2, albedo.z);
  put(G_ALBEDO + 3, hit ? (spec_dom > F(0.5) ? 0.5f : blend * F(1.0 - 0.75) + F(0.75)) : 0.0f);
  put(G_SHADOW + 0, sigma_pen);
  put(G_SHADOW + 1, vis_clean);
  put(G_TRANSLUCENCY + 0, ch(CH_SHADOW_DIST) >= NRD_FP16_MAX ? 1.0f : 0.0f);
  put(G_TRANSLUCENCY + 1, 0.0f);
  put(G_TRANSLUCENCY + 2, 0.0f);
  put(G_TRANSLUCENCY + 3, 0.0f);
  obj_id[i] = (int)ch(CH_OBJ_ID);
}

}  // namespace

// K9 on the h x w pixels of acc [C >= 32, h, w] (a frame or a row slab's
// planes, contiguous): out [30, h, w] (the planes of PLANES), obj_id [h, w].
extern "C" int rtvs_assemble(const float* acc, const float* cam_right, const float* cam_up,
                             const float* cam_forward, const float* cam_pos,
                             const float* view_proj, const float* prev_view_proj, float* out,
                             int* obj_id, int h, int w, int mode, float inv_spp, float max_bounces,
                             float half_w, float half_h, void* stream) {
  const size_t n = (size_t)h * w;
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + AS_THREADS - 1) / AS_THREADS);
  assemble_kernel<<<blocks, AS_THREADS, 0, (cudaStream_t)stream>>>(
      acc, cam_right, cam_up, cam_forward, cam_pos, view_proj, prev_view_proj, out, obj_id, n,
      mode, inv_spp, max_bounces, half_w, half_h);
  return (int)cudaGetLastError();
}
