// K2-K4: the denoiser's stencil kernels for Hopper (sm_90a), edge-clamped
// reads. Each follows its plain PyTorch version in
// raytracevs_tpu_torch/post/denoise.py operation for operation (see
// common.cuh), so each is bit-equal to it on the card.
//
// K2 rtvs_reproject_accumulate replaces the Pallas TPU kernel
//   raytracevs_tpu/ops/pallas/denoise_kernels.py::_reproject_kernel, one
//   thread per pixel.
//   The TPU kernel quantizes motion per tile to fetch 2x2 block windows by
//   DMA; here each pixel gathers its own four bilinear taps, which is the
//   jnp oracle's semantics (post/denoise.py::temporal_accumulate), so under
//   non-uniform motion this port keeps history the TPU kernel drops.
//   Bound: memory. Per pixel 16 channels x 4 taps of history (+ 7 x 4 for
//   virtual-motion specular), 8 + 2 + 2 + 2 current planes, 16 written:
//   about 110 words, 440 bytes. Taps of neighbouring threads overlap, so
//   L1/L2 absorb most of the gather; the state is read and written
//   ping-pong (never in place).
//   It takes the slab form (the TPU kernel's row_offset/global_h, which the
//   row-sharded denoise runs): a slab's rows from frame row row0, the
//   history extended by a halo of rows on each side, each tap's weights
//   from the global row coordinate and its row shifted by halo - row0, so a
//   slab equals the whole frame's rows bit for bit; a whole frame is the
//   slab with no halo at row 0.
//
// K3 rtvs_atrous replaces denoise_kernels.py::_atrous_fused_kernel: the
//   anti-firefly 3x3 luminance clamp and the
//   three guided edge-stopping passes (strides 1, 2, 4) in one launch. A
//   block owns an AT_W x AT_H tile of output pixels and runs the chain
//   over shrinking windows in shared memory: luminance on the tile +- 8,
//   the clamp, view_z and the normal on +- 7, pass 0 on +- 6, pass 1 on
//   +- 4, pass 2 on the tile, written to device memory. Device memory sees
//   the 6 input planes, z, normal and guide once (plus the halo's
//   re-reads) and the 6 output planes once: the fused function's bytes
//   (149 MB at 1080p, 0.045 ms at 3.35 TB/s), where one launch a pass
//   moved about 550 MB. What bounds it then is the instruction stream on
//   the SM: 4.73 pixel-passes an output pixel (the halo's recompute) of 8
//   taps, each a division and an expf kept exact (the fast intrinsics
//   would save about a fifth, and change bits) and ~40 float operations;
//   a zero dividend skips the exact division's slow path (div0).
//   So a tap reads its neighbour with three vector loads from per-pixel
//   interleaved windows, and a tile whose reach stays inside the frame
//   (most of them) reads at constant offsets, without clamps. The stages
//   stay exact at the frame's edges: each stage is stored by frame
//   coordinate, computed for in-frame pixels only, and every read clamps
//   its frame coordinate before it maps into the window, as the plain
//   version's edge padding of each pass's output does. The depth divide
//   stays a division at every tap (a hoisted reciprocal would change
//   bits).
//
// K3-pass rtvs_atrous_pass replaces denoise_kernels.py::_atrous_pass_kernel
//   (atrous_single_pass): one guided pass at stride 1, 2 or 4, the
//   anti-firefly clamp first when asked, which the row-sharded denoise
//   runs between its halo exchanges. A block loads a 32x8 tile and its
//   halo (the stride, one row and column more for the clamp's luminance)
//   of the 6 image planes and of z and normal into shared memory once,
//   clamps there in place, and runs the 8 taps from there. Bound: device
//   memory (the 12 input and 6 output planes once; 0.011 ms for a 274-row
//   slab at 1920) and the exact expf and division at every tap, as K3's.
//
// K4 rtvs_shadow_denoise replaces denoise_kernels.py::_shadow_kernel: the
//   ShadowDenoise.hlsl 5x5 filter with an exact int32 object-id match.
//   A block loads its SH_W x SH_H tile and a 2-pixel halo of the 7 input
//   planes (2 shadow, the id, z, 3 normal; edge-clamped, per pixel in two
//   float4s) into shared memory once and runs the 25 taps from there; the
//   25 spatial weights are computed once a block. Bound: the instruction
//   stream of the 25 taps, each an exact expf and division (div0; device
//   memory: 74.6 MB at 1080p, 0.022 ms); the tile shape and occupancy
//   moved nothing.

#include <atomic>

#include "common.cuh"

namespace {

#define VIEWZ_MIN F(0.01)
#define NOT_SKY_Z F(10000.0 * 0.99)
// ShadowDenoise.hlsl's filter: 5x5 taps, Gaussian softness 1, depth threshold 0.1
constexpr int SHADOW_RADIUS = 2;
#define SHADOW_SOFTNESS 1.0
#define SHADOW_DEPTH_THRESHOLD F(0.1)

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// a / b, bit for bit. The exact division takes a slow path (a call) for a
// zero dividend; a zero over a positive divisor is that signed zero, so it
// skips the division. Depth taps within a surface of one depth (the sky's
// every tap) and black pixels give zero dividends: on the demo scene's
// 1080p G-buffer this took K3 from 0.407 to 0.360 ms and K4 from 0.176 to
// 0.160 ms (scripts/torch_k1_ab.py, this file with and without it).
__device__ __forceinline__ float div0(float a, float b) {
  const bool zero = a == 0.0f && b > 0.0f;
  float n = zero ? 1.0f : a;
#ifdef __CUDA_ARCH__
  asm("" : "+f"(n));  // an opaque dividend, or the compiler divides a itself
#endif
  const float q = n / b;
  return zero ? a : q;
}

// bilinear taps of `nch` planes (channel list `chans`) at (xf, yf); row y
// of the coordinates is row y + row_shift of img
__device__ __forceinline__ void bilinear(const float* __restrict__ img, const int* chans, int nch,
                                         int H, int W, float xf, float yf, float* outv,
                                         int row_shift) {
  float x0f = floorf(xf), y0f = floorf(yf);
  float fx = xf - x0f, fy = yf - y0f;
  int x0 = (int)x0f, y0 = (int)y0f + row_shift;
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

// A row slab of H rows from frame row row0 of a global_h-row frame; the
// state holds the slab's history extended by `halo` rows on each side
// (H + 2 halo rows), the current planes and the output the slab's rows.
// Rows are global: the tap at global row y reads state row y - row0 +
// halo, its weights from the global coordinate, and the predicates test
// global_h - 1 (the jnp oracle's sharded form, without its rounding of
// prev_y - row0 + halo). The whole frame is the slab with halo 0, row0 0
// and global_h H, where this arithmetic is the whole frame's own.
__global__ void reproject_kernel(const float* __restrict__ state, const float* __restrict__ curr,
                                 const float* __restrict__ motion,
                                 const float* __restrict__ motion_spec,
                                 const float* __restrict__ view_z,
                                 const float* __restrict__ roughness, float* __restrict__ out,
                                 int H, int W, int halo, int row0, int global_h) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  size_t plane = (size_t)H * W, i = (size_t)y * W + x;
  const int HS = H + 2 * halo;  // the state's rows
  const int shift = halo - row0;
  const float last_y = (float)(global_h - 1);
  float xs = (float)x, ys = (float)(y + row0);
  float prev_x = xs - __ldg(motion + i), prev_y = ys - __ldg(motion + plane + i);
  const int all[16] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
  float hist[16];
  bilinear(state, all, 16, HS, W, prev_x, prev_y, hist, shift);
  // specular history by virtual motion, where that lands inside the frame
  float pvx = xs - __ldg(motion_spec + i), pvy = ys - __ldg(motion_spec + plane + i);
  const int spec[7] = {4, 5, 6, 7, 11, 12, 13};
  float vh[7];
  bilinear(state, spec, 7, HS, W, pvx, pvy, vh, shift);
  bool virt_in = pvx >= 0.0f && pvx <= (float)(W - 1) && pvy >= 0.0f && pvy <= last_y;
  if (virt_in)
    for (int k = 0; k < 7; ++k) hist[spec[k]] = vh[k];
  float vz = __ldg(view_z + i);
  bool in_bounds =
      prev_x >= 0.0f && prev_x <= (float)(W - 1) && prev_y >= 0.0f && prev_y <= last_y;
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

// K3's tile: AT_W x AT_H output pixels a block, AT_THREADS threads, two
// blocks an SM: 107,936 bytes of shared memory a block, the largest tile
// of 32-pixel rows of which two fit the SM's 228 KB. Its halo costs 4.73
// pixel-passes an output pixel (5.28 at 32x16, 4.45 at 32x32, which fits
// one block an SM and ran slower); the thread count moved nothing. A block
// marching down a 32-column strip with a ring of rows for each stage (3.8
// pixel-passes) ran 8% slower at two blocks an SM and level at three: its
// steps leave each thread one pixel or two between barriers.
constexpr int AT_W = 32, AT_H = 24, AT_THREADS = 512, AT_BLOCKS = 2;
// the halo each stage is computed over, from the strides 1, 2, 4 inwards
constexpr int HALO_LUM = 8, HALO_FF = 7, HALO_P0 = 6, HALO_P1 = 4;

// A window of the tile +- HALO, row-major, by frame coordinate.
template <int HALO>
struct Win {
  static constexpr int P = AT_W + 2 * HALO, N = P * (AT_H + 2 * HALO);
  // the slot of in-window frame pixel (x, y) of the tile at (x0, y0)
  static __device__ __forceinline__ int at(int x, int y, int x0, int y0) {
    return (y - y0 + HALO) * P + (x - x0 + HALO);
  }
  // the slot of the edge-clamped neighbour (x + dx, y + dy) of the pixel
  // in slot c; inside the frame (EDGE false) a constant offset
  template <bool EDGE>
  static __device__ __forceinline__ int tap(int c, int x, int y, int dx, int dy, int x0, int y0,
                                            int H, int W) {
    if (EDGE) return at(clampi(x + dx, 0, W - 1), clampi(y + dy, 0, H - 1), x0, y0);
    return c + dy * P + dx;
  }
};
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// Shared memory, per pixel interleaved so that a tap is three vector loads:
// the clamped image (channels 0-3 as float4, 4-5 as float2; then pass 1's
// output), z and normal (a float4), luminance (a float2 of the two groups;
// then pass 0's output, as the image)
constexpr int AT_FF = 6 * Win<HALO_FF>::N, AT_ZN = 4 * Win<HALO_FF>::N;
constexpr int AT_TMP = cmax(2 * Win<HALO_LUM>::N, 6 * Win<HALO_P0>::N);
constexpr int AT_SMEM_BYTES = (AT_FF + AT_ZN + AT_TMP) * (int)sizeof(float);
static_assert(6 * Win<HALO_P1>::N <= AT_FF, "pass 1's output must fit the clamp's slots");
static_assert(Win<HALO_FF>::N % 2 == 0 && Win<HALO_P0>::N % 2 == 0 && Win<HALO_P1>::N % 2 == 0,
              "float4 parts must stay 16-byte aligned");

// 6 channels of a window of n pixels at p: a float4 part, then a float2 part
struct Six {
  float4* a;
  float2* b;
  __device__ __forceinline__ Six(float* p, int n)
      : a(reinterpret_cast<float4*>(p)), b(reinterpret_cast<float2*>(p + 4 * n)) {}
};

// fn(slot, x, y) for each in-frame pixel of the window, the block's
// threads over its slots
template <int HALO, bool EDGE, typename Fn>
__device__ __forceinline__ void for_window(int x0, int y0, int H, int W, Fn fn) {
  for (int k = threadIdx.x; k < Win<HALO>::N; k += AT_THREADS) {
    int ly = k / Win<HALO>::P;
    int x = x0 - HALO + (k - ly * Win<HALO>::P), y = y0 - HALO + ly;
    if (!EDGE || (x >= 0 && x < W && y >= 0 && y < H)) fn(k, x, y);
  }
}

// One guided a-trous pass at in-frame pixel (x, y), reading the previous
// stage's 6 channels `in` (a Win<HIN>) and z/normal `zn` (a Win<HALO_FF>);
// rd, rs: the pixel's guide radii. The plain version's atrous_pass.
template <int S, int HIN, bool EDGE>
__device__ __forceinline__ void atrous_px(Six in, const float4* __restrict__ zn, float rd,
                                          float rs, int x, int y, int x0, int y0, int H, int W,
                                          float res[6]) {
  using WI = Win<HIN>;
  using WZ = Win<HALO_FF>;
  const int cz = WZ::at(x, y, x0, y0), ci = WI::at(x, y, x0, y0);
  const float4 zc4 = zn[cz];
  const float vz = zc4.x, n0 = zc4.y, n1 = zc4.z, n2 = zc4.w;
  float zc = F(0.05) * maxn(vz, VIEWZ_MIN);
  float s2 = (float)(S * S);
  rd = maxn(rd, F(1e-3));
  rs = maxn(rs, F(1e-3));
  float g_d = expf(-s2 / (rd * rd));
  float g_s = expf(-s2 / (rs * rs));
  const float4 ca = in.a[ci];
  const float2 cb = in.b[ci];
  float acc[6] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y};
  float wsum_d = 1.0f, wsum_s = 1.0f;
  const int offs[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1}, {0, 1}, {1, -1}, {1, 0}, {1, 1}};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int dx = offs[t][1] * S, dy = offs[t][0] * S;
    const float4 q = zn[WZ::template tap<EDGE>(cz, x, y, dx, dy, x0, y0, H, W)];
    const int qi = WI::template tap<EDGE>(ci, x, y, dx, dy, x0, y0, H, W);
    const float4 qa = in.a[qi];
    const float2 qb = in.b[qi];
    float w_depth = expf(div0(-fabsf(q.x - vz), zc));
    float ndot = q.y * n0 + q.z * n1 + q.w * n2;
    float wt = w_depth * pow8(maxn(ndot, 0.0f)) * F(2.0 / 3.0);
    float w_d = wt * g_d, w_s = wt * g_s;
    acc[0] = acc[0] + qa.x * w_d;
    acc[1] = acc[1] + qa.y * w_d;
    acc[2] = acc[2] + qa.z * w_d;
    acc[3] = acc[3] + qa.w * w_s;
    acc[4] = acc[4] + qb.x * w_s;
    acc[5] = acc[5] + qb.y * w_s;
    wsum_d = wsum_d + w_d;
    wsum_s = wsum_s + w_s;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) res[k] = div0(acc[k], wsum_d);
#pragma unroll
  for (int k = 3; k < 6; ++k) res[k] = div0(acc[k], wsum_s);
}

__device__ __forceinline__ void put6(Six out, int k, const float r[6]) {
  out.a[k] = make_float4(r[0], r[1], r[2], r[3]);
  out.b[k] = make_float2(r[4], r[5]);
}

// The chain on one tile. EDGE: the tile +- HALO_LUM reaches past the
// frame, so reads clamp; else every read is a constant offset.
template <bool EDGE>
__device__ __forceinline__ void atrous_tile(float* smem, const float* __restrict__ img,
                                            const float* __restrict__ view_z,
                                            const float* __restrict__ normal,
                                            const float* __restrict__ guide,
                                            float* __restrict__ out, int H, int W, int x0,
                                            int y0) {
  using WL = Win<HALO_LUM>;
  using WF = Win<HALO_FF>;
  const size_t plane = (size_t)H * W;
  float4* zn = reinterpret_cast<float4*>(smem + AT_FF);  // Win<HALO_FF>: view_z, normal
  float2* lum2 = reinterpret_cast<float2*>(smem + AT_FF + AT_ZN);  // Win<HALO_LUM>
  Six ff(smem, WF::N);                                  // the clamped image
  Six p0(smem + AT_FF + AT_ZN, Win<HALO_P0>::N);        // pass 0, over the luminance
  Six p1(smem, Win<HALO_P1>::N);                        // pass 1, over the clamped image

  // each group's luminance on the tile +- 8
  for_window<HALO_LUM, EDGE>(x0, y0, H, W, [&](int k, int x, int y) {
    size_t i = (size_t)y * W + x;
    lum2[k] = make_float2(lum(img, plane, i), lum(img + 3 * plane, plane, i));
  });
  __syncthreads();
  // the anti-firefly clamp, z and normal on +- 7
  for_window<HALO_FF, EDGE>(x0, y0, H, W, [&](int k, int x, int y) {
    size_t i = (size_t)y * W + x;
    zn[k] = make_float4(__ldg(view_z + i), __ldg(normal + i), __ldg(normal + plane + i),
                        __ldg(normal + 2 * plane + i));
    const int cl = WL::at(x, y, x0, y0);
    float2 m = make_float2(0.0f, 0.0f);
    bool first = true;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        float2 l = lum2[WL::template tap<EDGE>(cl, x, y, dx, dy, x0, y0, H, W)];
        m.x = first ? l.x : maxn(m.x, l.x);
        m.y = first ? l.y : maxn(m.y, l.y);
        first = false;
      }
    const float2 lc = lum2[cl];
    float s_d = minn(div0(m.x, maxn(lc.x, F(1e-6))), 1.0f);
    float s_s = minn(div0(m.y, maxn(lc.y, F(1e-6))), 1.0f);
    float r[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) r[c] = __ldg(img + c * plane + i) * (c < 3 ? s_d : s_s);
    put6(ff, k, r);
  });
  __syncthreads();
  // pass 0 (stride 1) on +- 6, into the luminance's slots
  for_window<HALO_P0, EDGE>(x0, y0, H, W, [&](int k, int x, int y) {
    size_t i = (size_t)y * W + x;
    float r[6];
    atrous_px<1, HALO_FF, EDGE>(ff, zn, __ldg(guide + i), __ldg(guide + plane + i), x, y, x0,
                                y0, H, W, r);
    put6(p0, k, r);
  });
  __syncthreads();
  // pass 1 (stride 2) on +- 4, into the clamped image's slots
  for_window<HALO_P1, EDGE>(x0, y0, H, W, [&](int k, int x, int y) {
    size_t i = (size_t)y * W + x;
    float r[6];
    atrous_px<2, HALO_P0, EDGE>(p0, zn, __ldg(guide + i), __ldg(guide + plane + i), x, y, x0,
                                y0, H, W, r);
    put6(p1, k, r);
  });
  __syncthreads();
  // pass 2 (stride 4) on the tile, to device memory
  for_window<0, EDGE>(x0, y0, H, W, [&](int, int x, int y) {
    size_t i = (size_t)y * W + x;
    float r[6];
    atrous_px<4, HALO_P1, EDGE>(p1, zn, __ldg(guide + i), __ldg(guide + plane + i), x, y, x0,
                                y0, H, W, r);
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c * plane + i] = r[c];
  });
}

__global__ void __launch_bounds__(AT_THREADS, AT_BLOCKS)
    atrous_kernel(const float* __restrict__ img, const float* __restrict__ view_z,
                  const float* __restrict__ normal, const float* __restrict__ guide,
                  float* __restrict__ out, int H, int W) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int x0 = blockIdx.x * AT_W, y0 = blockIdx.y * AT_H;
  if (x0 >= HALO_LUM && y0 >= HALO_LUM && x0 + AT_W + HALO_LUM <= W &&
      y0 + AT_H + HALO_LUM <= H)
    atrous_tile<false>(smem, img, view_z, normal, guide, out, H, W, x0, y0);
  else
    atrous_tile<true>(smem, img, view_z, normal, guide, out, H, W, x0, y0);
}

// The per-pass a-trous kernel: one guided pass at stride S over a
// PW_W x PW_H output tile, with AF the anti-firefly clamp applied to the
// pass's input first. The tile's window of the image (+- S, and + 1 for
// the clamp's luminance) and of z and normal (+- S) is loaded once into
// shared memory, by frame coordinate and for in-frame pixels only; every
// read clamps its frame coordinate first, so the clamp's output at the
// frame's edge is the edge pixel's own, as the plain version pads it.
constexpr int PW_W = 32, PW_H = 8;

template <int R>
struct PassWin {
  static constexpr int P = PW_W + 2 * R, N = P * (PW_H + 2 * R);
  // the slot of frame pixel (x, y), clamped into the frame, of the tile at (x0, y0)
  static __device__ __forceinline__ int at(int x, int y, int x0, int y0, int H, int W) {
    return (clampi(y, 0, H - 1) - y0 + R) * P + (clampi(x, 0, W - 1) - x0 + R);
  }
};

template <int S, bool AF>
__global__ void __launch_bounds__(PW_W * PW_H)
    atrous_pass_kernel(const float* __restrict__ img, const float* __restrict__ view_z,
                       const float* __restrict__ normal, const float* __restrict__ guide,
                       float* __restrict__ out, int H, int W) {
  constexpr int R = S + (AF ? 1 : 0);
  using WI = PassWin<R>;
  using WZ = PassWin<S>;
  __shared__ float4 s_a[WI::N];  // channels 0-3; the clamp writes its output here
  __shared__ float2 s_b[WI::N];  // channels 4-5
  __shared__ float2 s_lum[AF ? WI::N : 1];  // each group's luminance
  __shared__ float4 s_zn[WZ::N];  // view_z, normal
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * PW_W, y0 = blockIdx.y * PW_H;
  const size_t plane = (size_t)H * W;
  for (int k = tid; k < WI::N; k += PW_W * PW_H) {
    int ly = k / WI::P;
    int x = x0 - R + (k - ly * WI::P), y = y0 - R + ly;
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    size_t q = (size_t)y * W + x;
    float c[6];
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) c[ch] = __ldg(img + ch * plane + q);
    s_a[k] = make_float4(c[0], c[1], c[2], c[3]);
    s_b[k] = make_float2(c[4], c[5]);
    if (AF)
      s_lum[k] = make_float2(c[0] * F(0.2126) + c[1] * F(0.7152) + c[2] * F(0.0722),
                             c[3] * F(0.2126) + c[4] * F(0.7152) + c[5] * F(0.0722));
  }
  for (int k = tid; k < WZ::N; k += PW_W * PW_H) {
    int ly = k / WZ::P;
    int x = x0 - S + (k - ly * WZ::P), y = y0 - S + ly;
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    size_t q = (size_t)y * W + x;
    s_zn[k] = make_float4(__ldg(view_z + q), __ldg(normal + q), __ldg(normal + plane + q),
                          __ldg(normal + 2 * plane + q));
  }
  __syncthreads();
  if (AF) {
    // the clamp on the in-frame pixels of the tile +- S, in place: a
    // pixel's own slots are the only image slots this stage writes or reads
    for (int k = tid; k < WZ::N; k += PW_W * PW_H) {
      int ly = k / WZ::P;
      int x = x0 - S + (k - ly * WZ::P), y = y0 - S + ly;
      if (x < 0 || x >= W || y < 0 || y >= H) continue;
      float2 m = make_float2(0.0f, 0.0f);
      bool first = true;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          float2 l = s_lum[WI::at(x + dx, y + dy, x0, y0, H, W)];
          m.x = first ? l.x : maxn(m.x, l.x);
          m.y = first ? l.y : maxn(m.y, l.y);
          first = false;
        }
      const int c = WI::at(x, y, x0, y0, H, W);
      const float2 lc = s_lum[c];
      float s_d = minn(div0(m.x, maxn(lc.x, F(1e-6))), 1.0f);
      float s_s = minn(div0(m.y, maxn(lc.y, F(1e-6))), 1.0f);
      const float4 a = s_a[c];
      const float2 b = s_b[c];
      s_a[c] = make_float4(a.x * s_d, a.y * s_d, a.z * s_d, a.w * s_s);
      s_b[c] = make_float2(b.x * s_s, b.y * s_s);
    }
    __syncthreads();
  }
  const int x = x0 + tid % PW_W, y = y0 + tid / PW_W;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;
  // the pass: atrous_px's arithmetic, the taps by clamped frame coordinate
  const float4 zc4 = s_zn[WZ::at(x, y, x0, y0, H, W)];
  const float vz = zc4.x, n0 = zc4.y, n1 = zc4.z, n2 = zc4.w;
  float zc = F(0.05) * maxn(vz, VIEWZ_MIN);
  float s2 = (float)(S * S);
  float rd = maxn(__ldg(guide + i), F(1e-3));
  float rs = maxn(__ldg(guide + plane + i), F(1e-3));
  float g_d = expf(-s2 / (rd * rd));
  float g_s = expf(-s2 / (rs * rs));
  const int ci = WI::at(x, y, x0, y0, H, W);
  const float4 ca = s_a[ci];
  const float2 cb = s_b[ci];
  float acc[6] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y};
  float wsum_d = 1.0f, wsum_s = 1.0f;
  const int offs[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1}, {0, 1}, {1, -1}, {1, 0}, {1, 1}};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int dx = offs[t][1] * S, dy = offs[t][0] * S;
    const float4 q = s_zn[WZ::at(x + dx, y + dy, x0, y0, H, W)];
    const int qi = WI::at(x + dx, y + dy, x0, y0, H, W);
    const float4 qa = s_a[qi];
    const float2 qb = s_b[qi];
    float w_depth = expf(div0(-fabsf(q.x - vz), zc));
    float ndot = q.y * n0 + q.z * n1 + q.w * n2;
    float wt = w_depth * pow8(maxn(ndot, 0.0f)) * F(2.0 / 3.0);
    float w_d = wt * g_d, w_s = wt * g_s;
    acc[0] = acc[0] + qa.x * w_d;
    acc[1] = acc[1] + qa.y * w_d;
    acc[2] = acc[2] + qa.z * w_d;
    acc[3] = acc[3] + qa.w * w_s;
    acc[4] = acc[4] + qb.x * w_s;
    acc[5] = acc[5] + qb.y * w_s;
    wsum_d = wsum_d + w_d;
    wsum_s = wsum_s + w_s;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k * plane + i] = div0(acc[k], wsum_d);
#pragma unroll
  for (int k = 3; k < 6; ++k) out[k * plane + i] = div0(acc[k], wsum_s);
}

// K4's tile: one thread per output pixel, SH_W x SH_H a block
constexpr int SH_W = 32, SH_H = 16;
constexpr int SH_P = SH_W + 2 * SHADOW_RADIUS, SH_N = SH_P * (SH_H + 2 * SHADOW_RADIUS);
constexpr int SH_TAPS = (2 * SHADOW_RADIUS + 1) * (2 * SHADOW_RADIUS + 1);

__global__ void __launch_bounds__(SH_W * SH_H)
    shadow_kernel(const float* __restrict__ shadow, const int* __restrict__ obj_id,
                  const float* __restrict__ view_z, const float* __restrict__ normal,
                  float* __restrict__ out, int H, int W) {
  // per pixel: z and normal; penumbra, visibility and the id's bits
  __shared__ float4 s_zn[SH_N], s_sh[SH_N];
  __shared__ float s_w[SH_TAPS];
  const int tid = threadIdx.y * SH_W + threadIdx.x;
  const int x0 = blockIdx.x * SH_W, y0 = blockIdx.y * SH_H;
  const size_t plane = (size_t)H * W;
  // the Gaussian: a float32 of the double quotient, then expf, as the
  // plain version's torch.exp of a float32 tensor
  if (tid < SH_TAPS) {
    int dy = tid / (2 * SHADOW_RADIUS + 1) - SHADOW_RADIUS;
    int dx = tid % (2 * SHADOW_RADIUS + 1) - SHADOW_RADIUS;
    s_w[tid] = expf((float)(-(double)(dx * dx + dy * dy) /
                            (2.0 * SHADOW_SOFTNESS * SHADOW_SOFTNESS + 0.01)));
  }
  // the tile and its halo, each slot the edge-clamped pixel
  for (int k = tid; k < SH_N; k += SH_W * SH_H) {
    int ly = k / SH_P;
    int gx = clampi(x0 - SHADOW_RADIUS + (k - ly * SH_P), 0, W - 1);
    int gy = clampi(y0 - SHADOW_RADIUS + ly, 0, H - 1);
    size_t q = (size_t)gy * W + gx;
    s_zn[k] = make_float4(__ldg(view_z + q), __ldg(normal + q), __ldg(normal + plane + q),
                          __ldg(normal + 2 * plane + q));
    s_sh[k] = make_float4(__ldg(shadow + q), __ldg(shadow + plane + q),
                          __int_as_float(__ldg(obj_id + q)), 0.0f);
  }
  __syncthreads();
  int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int c = (threadIdx.y + SHADOW_RADIUS) * SH_P + threadIdx.x + SHADOW_RADIUS;
  const float4 zc4 = s_zn[c], sc4 = s_sh[c];
  const int oid = __float_as_int(sc4.z);
  const float vz = zc4.x, n0 = zc4.y, n1 = zc4.z, n2 = zc4.w;
  float dz = maxn(SHADOW_DEPTH_THRESHOLD * vz, F(0.001));
  float wsum = 0.0f, vis_sum = 0.0f, pen_sum = 0.0f;
#pragma unroll
  for (int dy = -SHADOW_RADIUS; dy <= SHADOW_RADIUS; ++dy)
#pragma unroll
    for (int dx = -SHADOW_RADIUS; dx <= SHADOW_RADIUS; ++dx) {
      const float4 qz = s_zn[c + dy * SH_P + dx], qs = s_sh[c + dy * SH_P + dx];
      float w_depth = expf(div0(-fabsf(vz - qz.x), dz));
      float ndot = qz.y * n0 + qz.z * n1 + qz.w * n2;
      float w_spatial = s_w[(dy + SHADOW_RADIUS) * (2 * SHADOW_RADIUS + 1) + dx + SHADOW_RADIUS];
      float wt = __float_as_int(qs.z) == oid ? w_depth * pow8(maxn(ndot, 0.0f)) * w_spatial
                                             : 0.0f;
      vis_sum = vis_sum + qs.y * wt;
      pen_sum = pen_sum + qs.x * wt;
      wsum = wsum + wt;
    }
  float c0 = sc4.x, c1 = sc4.y;
  bool ok = wsum > F(0.001);
  float pen = ok ? div0(pen_sum, maxn(wsum, F(1e-6))) : c0;
  float vis = ok ? div0(vis_sum, maxn(wsum, F(1e-6))) : c1;
  size_t i = (size_t)y * W + x;
  out[i] = oid < 0 ? c0 : pen;
  out[plane + i] = oid < 0 ? c1 : vis;
}

inline dim3 grid_for(int H, int W) { return dim3((W + 15) / 16, (H + 15) / 16); }

}  // namespace

// Every entry point launches on `stream`, allocates nothing and returns the
// launch's cudaError_t. Every input pointer is required.
// H: the current planes' rows; the state has H + 2 halo. A whole frame
// passes halo 0, row0 0, global_h H.
extern "C" int rtvs_reproject_accumulate(const float* state, const float* curr,
                                         const float* motion, const float* motion_spec,
                                         const float* view_z, const float* roughness, float* out,
                                         int H, int W, int halo, int row0, int global_h,
                                         void* stream) {
  reproject_kernel<<<grid_for(H, W), dim3(16, 16), 0, (cudaStream_t)stream>>>(
      state, curr, motion, motion_spec, view_z, roughness, out, H, W, halo, row0, global_h);
  return (int)cudaGetLastError();
}

namespace {
// Above 48 KB a block's dynamic shared memory needs the kernel's attribute
// set, once for each device.
cudaError_t atrous_smem_attribute() {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> done[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev].load())) return err;
  err = cudaFuncSetAttribute(atrous_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             AT_SMEM_BYTES);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true);
  return err;
}
}  // namespace

extern "C" int rtvs_atrous(const float* img, const float* view_z, const float* normal,
                           const float* guide, float* out, int H, int W, void* stream) {
  cudaError_t err = atrous_smem_attribute();
  if (err != cudaSuccess) return (int)err;
  atrous_kernel<<<dim3((W + AT_W - 1) / AT_W, (H + AT_H - 1) / AT_H), AT_THREADS, AT_SMEM_BYTES,
                  (cudaStream_t)stream>>>(img, view_z, normal, guide, out, H, W);
  return (int)cudaGetLastError();
}

// One a-trous pass at stride 1, 2 or 4, the anti-firefly clamp first when
// anti_firefly is nonzero; another stride returns cudaErrorInvalidValue.
extern "C" int rtvs_atrous_pass(const float* img, const float* view_z, const float* normal,
                                const float* guide, float* out, int H, int W, int stride,
                                int anti_firefly, void* stream) {
  const dim3 grid((W + PW_W - 1) / PW_W, (H + PW_H - 1) / PW_H), block(PW_W * PW_H);
  cudaStream_t st = (cudaStream_t)stream;
#define RTVS_PASS(S, AF) atrous_pass_kernel<S, AF><<<grid, block, 0, st>>>(img, view_z, normal, \
                                                                           guide, out, H, W)
  switch (stride * 2 + (anti_firefly ? 1 : 0)) {
    case 2: RTVS_PASS(1, false); break;
    case 3: RTVS_PASS(1, true); break;
    case 4: RTVS_PASS(2, false); break;
    case 5: RTVS_PASS(2, true); break;
    case 8: RTVS_PASS(4, false); break;
    case 9: RTVS_PASS(4, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RTVS_PASS
  return (int)cudaGetLastError();
}

extern "C" int rtvs_shadow_denoise(const float* shadow, const int* obj_id, const float* view_z,
                                   const float* normal, float* out, int H, int W, void* stream) {
  shadow_kernel<<<dim3((W + SH_W - 1) / SH_W, (H + SH_H - 1) / SH_H), dim3(SH_W, SH_H), 0,
                  (cudaStream_t)stream>>>(shadow, obj_id, view_z, normal, out, H, W);
  return (int)cudaGetLastError();
}

// For the record: out[0] K3's dynamic shared memory a block in bytes,
// out[1] K3's and out[2] K4's resident blocks an SM.
extern "C" int rtvs_denoise_occupancy(int* out) {
  cudaError_t err = atrous_smem_attribute();
  if (err != cudaSuccess) return (int)err;
  out[0] = AT_SMEM_BYTES;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, atrous_kernel, AT_THREADS,
                                                      AT_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, shadow_kernel, SH_W * SH_H,
                                                            0);
}
