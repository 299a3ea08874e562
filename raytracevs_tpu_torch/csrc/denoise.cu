// K2-K4: the denoiser's stencil kernels for Hopper (sm_90a), one thread per
// pixel, edge-clamped reads. Each follows its plain PyTorch version in
// raytracevs_tpu_torch/post/denoise.py operation for operation (see
// common.cuh).
//
// K2 rtvs_reproject_accumulate replaces the Pallas TPU kernel
//   raytracevs_tpu/ops/pallas/denoise_kernels.py::_reproject_kernel.
//   The TPU kernel quantizes motion per tile to fetch 2x2 block windows by
//   DMA; here each pixel gathers its own four bilinear taps, which is the
//   jnp oracle's semantics (post/denoise.py::temporal_accumulate), so under
//   non-uniform motion this port keeps history the TPU kernel drops.
//   Bound: memory. Per pixel 16 channels x 4 taps of history (+ 7 x 4 for
//   virtual-motion specular), 8 + 2 + 2 + 2 current planes, 16 written:
//   about 110 words, 440 bytes. Taps of neighbouring threads overlap, so
//   L1/L2 absorb most of the gather; the state is read and written
//   ping-pong (never in place).
//
// K3 rtvs_atrous_pass (+ rtvs_anti_firefly) replaces
//   denoise_kernels.py::_atrous_fused_kernel (and _atrous_pass_kernel): one
//   edge-stopping pass with a stride argument, launched once per pass
//   between two buffers. The anti-firefly 3x3 luminance clamp is a separate
//   small kernel on the pass-0 input. Bound: memory, 9 taps x 10-12
//   channels per pixel per pass, mostly cache hits; fusing the passes in
//   shared memory (as the TPU kernel fused them in VMEM) is later work.
//
// K4 rtvs_shadow_denoise replaces denoise_kernels.py::_shadow_kernel: the
//   ShadowDenoise.hlsl 5x5 filter with an exact int32 object-id match.
//   Bound: memory and the 25 expf per pixel.

#include "common.cuh"

namespace {

#define VIEWZ_MIN F(0.01)
#define NOT_SKY_Z F(10000.0 * 0.99)
// ShadowDenoise.hlsl's filter: 5x5 taps, Gaussian softness 1, depth threshold 0.1
constexpr int SHADOW_RADIUS = 2;
#define SHADOW_SOFTNESS 1.0
#define SHADOW_DEPTH_THRESHOLD F(0.1)

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// bilinear taps of `nch` planes (channel list `chans`) at (xf, yf)
__device__ __forceinline__ void bilinear(const float* __restrict__ img, const int* chans, int nch,
                                         int H, int W, float xf, float yf, float* outv) {
  float x0f = floorf(xf), y0f = floorf(yf);
  float fx = xf - x0f, fy = yf - y0f;
  int x0 = (int)x0f, y0 = (int)y0f;
  int xa = clampi(x0, 0, W - 1), xb = clampi(x0 + 1, 0, W - 1);
  int ya = clampi(y0, 0, H - 1), yb = clampi(y0 + 1, 0, H - 1);
  size_t plane = (size_t)H * W;
  size_t i00 = (size_t)ya * W + xa, i01 = (size_t)ya * W + xb;
  size_t i10 = (size_t)yb * W + xa, i11 = (size_t)yb * W + xb;
  float ofx = 1.0f - fx, ofy = 1.0f - fy;
  for (int k = 0; k < nch; ++k) {
    const float* p = img + (size_t)chans[k] * plane;
    outv[k] = __ldg(p + i00) * ofx * ofy + __ldg(p + i01) * fx * ofy +
              __ldg(p + i10) * ofx * fy + __ldg(p + i11) * fx * fy;
  }
}

__device__ __forceinline__ float clamp_to_fast(float slow, float fast) {
  float lo = fast * 0.5f;
  float hi = fast * 2.0f + F(1e-3);
  return minn(maxn(slow, minn(lo, hi)), maxn(lo, hi));
}

__global__ void reproject_kernel(const float* __restrict__ state, const float* __restrict__ curr,
                                 const float* __restrict__ motion,
                                 const float* __restrict__ motion_spec,
                                 const float* __restrict__ view_z,
                                 const float* __restrict__ roughness, float* __restrict__ out,
                                 int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  size_t plane = (size_t)H * W, i = (size_t)y * W + x;
  float xs = (float)x, ys = (float)y;
  float prev_x = xs - __ldg(motion + i), prev_y = ys - __ldg(motion + plane + i);
  const int all[16] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
  float hist[16];
  bilinear(state, all, 16, H, W, prev_x, prev_y, hist);
  // specular history by virtual motion, where that lands inside the frame
  float pvx = xs - __ldg(motion_spec + i), pvy = ys - __ldg(motion_spec + plane + i);
  const int spec[7] = {4, 5, 6, 7, 11, 12, 13};
  float vh[7];
  bilinear(state, spec, 7, H, W, pvx, pvy, vh);
  bool virt_in = pvx >= 0.0f && pvx <= (float)(W - 1) && pvy >= 0.0f && pvy <= (float)(H - 1);
  if (virt_in)
    for (int k = 0; k < 7; ++k) hist[spec[k]] = vh[k];
  float vz = __ldg(view_z + i);
  bool in_bounds =
      prev_x >= 0.0f && prev_x <= (float)(W - 1) && prev_y >= 0.0f && prev_y <= (float)(H - 1);
  bool depth_ok = fabsf(hist[15] - vz) <= F(0.1) * maxn(vz, VIEWZ_MIN);
  bool valid = in_bounds && depth_ok && vz < NOT_SKY_Z;
  float frames = valid ? minn(hist[14] + 1.0f, F(16.0)) : 0.0f;
  float alpha = 1.0f / (1.0f + frames);
  float fast_frames = minn(frames, F(4.0));
  float fast_alpha = 1.0f / (1.0f + fast_frames);
  // responsive accumulation: near-mirror specular keeps only the fast history
  float frames_s = __ldg(roughness + i) < F(0.05) ? fast_frames : frames;
  float alpha_s = 1.0f / (1.0f + frames_s);
  float c[8];
  for (int k = 0; k < 8; ++k) c[k] = __ldg(curr + k * plane + i);
  float res[16];
  for (int k = 0; k < 3; ++k) {
    float fd = hist[8 + k] + (c[k] - hist[8 + k]) * fast_alpha;
    float fs = hist[11 + k] + (c[4 + k] - hist[11 + k]) * fast_alpha;
    res[8 + k] = fd;
    res[11 + k] = fs;
    res[k] = clamp_to_fast(hist[k] + (c[k] - hist[k]) * alpha, fd);
    res[4 + k] = clamp_to_fast(hist[4 + k] + (c[4 + k] - hist[4 + k]) * alpha_s, fs);
  }
  res[3] = hist[3] + (c[3] - hist[3]) * alpha;
  res[7] = hist[7] + (c[7] - hist[7]) * alpha_s;
  res[14] = frames;
  res[15] = vz;
  for (int k = 0; k < 16; ++k) out[k * plane + i] = res[k];
}

__device__ __forceinline__ float lum(const float* p, size_t plane, size_t i) {
  return __ldg(p + i) * F(0.2126) + __ldg(p + plane + i) * F(0.7152) +
         __ldg(p + 2 * plane + i) * F(0.0722);
}

__global__ void anti_firefly_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
                                    int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  size_t plane = (size_t)H * W, i = (size_t)y * W + x;
  for (int g = 0; g < 6; g += 3) {
    const float* grp = img + g * plane;
    float m = 0.0f;
    bool first = true;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        size_t q = (size_t)clampi(y + dy, 0, H - 1) * W + clampi(x + dx, 0, W - 1);
        float l = lum(grp, plane, q);
        m = first ? l : maxn(m, l);
        first = false;
      }
    float s = minn(m / maxn(lum(grp, plane, i), F(1e-6)), 1.0f);
    for (int k = 0; k < 3; ++k) out[(g + k) * plane + i] = __ldg(grp + k * plane + i) * s;
  }
}

__global__ void atrous_pass_kernel(const float* __restrict__ img, const float* __restrict__ view_z,
                                   const float* __restrict__ normal,
                                   const float* __restrict__ guide, float* __restrict__ out,
                                   int H, int W, int stride) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  size_t plane = (size_t)H * W, i = (size_t)y * W + x;
  float vz = __ldg(view_z + i);
  float n0 = __ldg(normal + i), n1 = __ldg(normal + plane + i), n2 = __ldg(normal + 2 * plane + i);
  float zc = F(0.05) * maxn(vz, VIEWZ_MIN);
  float s2 = (float)(stride * stride);
  float rd = maxn(__ldg(guide + i), F(1e-3)), rs = maxn(__ldg(guide + plane + i), F(1e-3));
  float g_d = expf(-s2 / (rd * rd));
  float g_s = expf(-s2 / (rs * rs));
  float acc[6];
  for (int k = 0; k < 6; ++k) acc[k] = __ldg(img + k * plane + i);
  float wsum_d = 1.0f, wsum_s = 1.0f;
  const int offs[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1}, {0, 1}, {1, -1}, {1, 0}, {1, 1}};
  for (int t = 0; t < 8; ++t) {
    size_t q = (size_t)clampi(y + offs[t][0] * stride, 0, H - 1) * W +
               clampi(x + offs[t][1] * stride, 0, W - 1);
    float w_depth = expf(-fabsf(__ldg(view_z + q) - vz) / zc);
    float ndot = __ldg(normal + q) * n0 + __ldg(normal + plane + q) * n1 +
                 __ldg(normal + 2 * plane + q) * n2;
    float wt = w_depth * pow8(maxn(ndot, 0.0f)) * F(2.0 / 3.0);
    float w_d = wt * g_d, w_s = wt * g_s;
    for (int k = 0; k < 3; ++k) acc[k] = acc[k] + __ldg(img + k * plane + q) * w_d;
    for (int k = 3; k < 6; ++k) acc[k] = acc[k] + __ldg(img + k * plane + q) * w_s;
    wsum_d = wsum_d + w_d;
    wsum_s = wsum_s + w_s;
  }
  for (int k = 0; k < 3; ++k) out[k * plane + i] = acc[k] / wsum_d;
  for (int k = 3; k < 6; ++k) out[k * plane + i] = acc[k] / wsum_s;
}

__global__ void shadow_kernel(const float* __restrict__ shadow, const int* __restrict__ obj_id,
                              const float* __restrict__ view_z, const float* __restrict__ normal,
                              float* __restrict__ out, int H, int W) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  size_t plane = (size_t)H * W, i = (size_t)y * W + x;
  int oid = __ldg(obj_id + i);
  float vz = __ldg(view_z + i);
  float n0 = __ldg(normal + i), n1 = __ldg(normal + plane + i), n2 = __ldg(normal + 2 * plane + i);
  float dz = maxn(SHADOW_DEPTH_THRESHOLD * vz, F(0.001));
  float wsum = 0.0f, vis_sum = 0.0f, pen_sum = 0.0f;
  for (int dy = -SHADOW_RADIUS; dy <= SHADOW_RADIUS; ++dy)
    for (int dx = -SHADOW_RADIUS; dx <= SHADOW_RADIUS; ++dx) {
      size_t q = (size_t)clampi(y + dy, 0, H - 1) * W + clampi(x + dx, 0, W - 1);
      float w_depth = expf(-fabsf(vz - __ldg(view_z + q)) / dz);
      float ndot = __ldg(normal + q) * n0 + __ldg(normal + plane + q) * n1 +
                   __ldg(normal + 2 * plane + q) * n2;
      float w_spatial = expf((float)(-(double)(dx * dx + dy * dy) /
                                     (2.0 * SHADOW_SOFTNESS * SHADOW_SOFTNESS + 0.01)));
      float wt = __ldg(obj_id + q) == oid ? w_depth * pow8(maxn(ndot, 0.0f)) * w_spatial : 0.0f;
      vis_sum = vis_sum + __ldg(shadow + plane + q) * wt;
      pen_sum = pen_sum + __ldg(shadow + q) * wt;
      wsum = wsum + wt;
    }
  float c0 = __ldg(shadow + i), c1 = __ldg(shadow + plane + i);
  bool ok = wsum > F(0.001);
  float pen = ok ? pen_sum / maxn(wsum, F(1e-6)) : c0;
  float vis = ok ? vis_sum / maxn(wsum, F(1e-6)) : c1;
  out[i] = oid < 0 ? c0 : pen;
  out[plane + i] = oid < 0 ? c1 : vis;
}

inline dim3 grid_for(int H, int W) { return dim3((W + 15) / 16, (H + 15) / 16); }

}  // namespace

// Every entry point launches on `stream`, allocates nothing and returns the
// launch's cudaError_t. Every input pointer is required.
extern "C" int rtvs_reproject_accumulate(const float* state, const float* curr,
                                         const float* motion, const float* motion_spec,
                                         const float* view_z, const float* roughness, float* out,
                                         int H, int W, void* stream) {
  reproject_kernel<<<grid_for(H, W), dim3(16, 16), 0, (cudaStream_t)stream>>>(
      state, curr, motion, motion_spec, view_z, roughness, out, H, W);
  return (int)cudaGetLastError();
}

extern "C" int rtvs_anti_firefly(const float* img, float* out, int H, int W, void* stream) {
  anti_firefly_kernel<<<grid_for(H, W), dim3(16, 16), 0, (cudaStream_t)stream>>>(img, out, H, W);
  return (int)cudaGetLastError();
}

extern "C" int rtvs_atrous_pass(const float* img, const float* view_z, const float* normal,
                                const float* guide, float* out, int H, int W, int stride,
                                void* stream) {
  atrous_pass_kernel<<<grid_for(H, W), dim3(16, 16), 0, (cudaStream_t)stream>>>(
      img, view_z, normal, guide, out, H, W, stride);
  return (int)cudaGetLastError();
}

extern "C" int rtvs_shadow_denoise(const float* shadow, const int* obj_id, const float* view_z,
                                   const float* normal, float* out, int H, int W, void* stream) {
  shadow_kernel<<<grid_for(H, W), dim3(16, 16), 0, (cudaStream_t)stream>>>(
      shadow, obj_id, view_z, normal, out, H, W);
  return (int)cudaGetLastError();
}
