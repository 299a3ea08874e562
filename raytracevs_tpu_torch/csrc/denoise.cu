// K2-K4 and K10: the denoiser's stencil kernels for Hopper (sm_90a), edge-clamped
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
//   runs pass by pass. One body for whole frames and row slabs: a slab is
//   read where it lies, its neighbours' rows above and below it from
//   arrays of their own (views of the neighbour slabs on one card), z,
//   normal and guide from one array the denoise extends once a frame; a
//   frame row maps to its array after it is clamped into the frame (the
//   frame's own edge padding), and only the slab's rows are computed. A
//   block loads a 32x16 tile's windows into shared memory (the image on the
//   tile +- the stride, one more for the clamp's luminance; z and normal on
//   the tile +- the stride), per pixel interleaved, clamps there in place
//   and runs the 8 taps from there, K3's arithmetic; a tile whose window
//   stays inside the frame (most of them) reads at constant offsets. The
//   passes without the clamp load by cp.async, one tile ahead, on a
//   persistent grid. Bound: device memory (a 270-row slab at 1920, its
//   halo rows and 6 planes out: 37.5-37.9 MB, 0.011 ms) and, as K3, the
//   exact expf and division at every tap: with the loads taken away the
//   three passes still take 0.020 ms a launch (PERF.md), the rest is the
//   first tile's load on each block and the cp.async instructions.
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
//
// K10 rtvs_reblur_prepass: post/denoise.py::reblur_prepass, the REBLUR
//   input conditioning before K2 (the 3x3 hit-distance reconstruction of
//   channels 3 and 7, then the 16-tap specular prepass blur). It replaces
//   no TPU kernel: the JAX package leaves it to XLA's fusion. It was added
//   because the port ran it as ~290 PyTorch launches a frame, the device
//   idle while the host issued them. A block stages its 32x16 tile's
//   specular colour and view_z with a 7-pixel halo, and the two hit
//   distances times their validity with the 1-pixel halo, in shared memory
//   (edge replication as clamped coordinates) and runs the taps from there,
//   in the plain version's order: the eight neighbours by dy, dx, the taps
//   in _SPEC_PREPASS_TAPS order, each tap's Gaussian as r2.reciprocal()
//   times -d2 (torch's Python number over a tensor) and an exact expf.
//   Bound: device memory, 10 planes read and 8 written, 149 MB at 1080p
//   (0.0446 ms at 3.35 TB/s); then the exact expf: the taps lie at four
//   distances, so four Gaussians a pixel, and a depth weight's expf only
//   where the tap's depth differs (expf(-0) is 1). Any height: a row slab
//   extended by PREPASS_HALO rows is a frame of its own.

#include <algorithm>
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

// K3-pass: one guided pass at stride S, with AF the anti-firefly clamp
// applied to the pass's input first, over 32x16 output tiles of a row
// slab; a whole frame is the slab with no rows above or below. The rows
// are read where they lie (PassSrc): the slab's image, its neighbours'
// rows above and below it, and z, normal and guide, each array with a
// plane stride of its own; a frame row maps to its array after it is
// clamped into the frame, which is the frame's own edge padding. Only the
// slab's rows are computed.
//
// A pass without the clamp loads by cp.async on a persistent grid of
// 512-thread blocks, the next tile's windows landing while the block
// filters this one; the clamp's pass loads through registers, its
// luminance computed on the way, one tile a 256-thread block. Either way
// at most 64 registers a thread and 1024 threads an SM.
template <bool AF>
struct PassCfg {
  static constexpr bool ASYNC = !AF;  // the clamp needs the luminance, computed as it loads
  static constexpr int THREADS = AF ? 256 : 512, MIN_BLOCKS = 65536 / (64 * THREADS);
  static constexpr int TW = 32, TH = 16;
};

struct PassSrc {
  const float* img;    // [6, rows, W]: frame rows [row0, row0 + rows)
  const float* above;  // [6, n_above, W]: frame rows [row0 - n_above, row0)
  const float* below;  // [6, n_below, W]: from frame row row0 + rows
  size_t img_plane, above_plane, below_plane;
  const float* view_z;  // z [R, W], normal [3, R, W], guide [2, R, W]: from frame row aux_row0
  const float* normal;
  const float* guide;
  size_t normal_plane, guide_plane;
  int rows, W, row0, H, aux_row0, n_above, n_below, tiles_x, tiles;
};

// The image row of frame row y, held rows only: its first pixel; plane, its plane stride
__device__ __forceinline__ const float* pass_row(const PassSrc& s, int y, size_t& plane) {
  if (y < s.row0) {
    plane = s.above_plane;
    return s.above + (size_t)(y - s.row0 + s.n_above) * s.W;
  }
  if (y >= s.row0 + s.rows) {
    plane = s.below_plane;
    return s.below + (size_t)(y - s.row0 - s.rows) * s.W;
  }
  plane = s.img_plane;
  return s.img + (size_t)(y - s.row0) * s.W;
}

// A tile's windows: the image on the tile +- R, z and normal on the tile +- S
template <int S, bool AF>
struct PassGeom {
  using C = PassCfg<AF>;
  static constexpr int TW = C::TW, TH = C::TH, R = S + (AF ? 1 : 0), THREADS = C::THREADS;
  static constexpr int PI = TW + 2 * R, NI = PI * (TH + 2 * R);
  static constexpr int PZ = TW + 2 * S, NZ = PZ * (TH + 2 * S);
  // per pixel interleaved, so that a tap is three vector loads: the image
  // (channels 0-3 a float4, then z and normal a float4, channels 4-5 a
  // float2) and the luminance of each group (a float2), 16-byte aligned
  static constexpr int BYTES = ((NI * 16 + NZ * 16 + NI * 8 + (AF ? NI * 8 : 0)) + 15) / 16 * 16;
  static constexpr int BUFFERS = C::ASYNC ? 2 : 1;
  static_assert(THREADS % TW == 0 && TW * TH % THREADS == 0, "whole rows a thread");
  // the slot of in-window frame pixel (x, y) of the tile at (x0, y0)
  static __device__ __forceinline__ int ati(int x, int y, int x0, int y0) {
    return (y - y0 + R) * PI + (x - x0 + R);
  }
  static __device__ __forceinline__ int atz(int x, int y, int x0, int y0) {
    return (y - y0 + S) * PZ + (x - x0 + S);
  }
};

struct PassBuf {
  float4* a;
  float4* zn;
  float2* b;
  float2* lum;
};

template <int S, bool AF>
__device__ __forceinline__ PassBuf pass_buf(char* base) {
  using G = PassGeom<S, AF>;
  PassBuf w;
  w.a = reinterpret_cast<float4*>(base);
  w.zn = reinterpret_cast<float4*>(base + G::NI * 16);
  w.b = reinterpret_cast<float2*>(base + (G::NI + G::NZ) * 16);
  w.lum = reinterpret_cast<float2*>(base + (G::NI + G::NZ) * 16 + G::NI * 8);
  return w;
}

__device__ __forceinline__ void cp_async4(void* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest n complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float2 max2(float2 a, float2 b) {
  return make_float2(maxn(a.x, b.x), maxn(a.y, b.y));
}

__device__ __forceinline__ float2 lum2(float4 a, float2 b) {
  return make_float2(a.x * F(0.2126) + a.y * F(0.7152) + a.z * F(0.0722),
                     a.w * F(0.2126) + b.x * F(0.7152) + b.y * F(0.0722));
}

// The tile at (x0, y0) whose output rows end at frame row y_end: its
// windows, the held pixels only (in the frame, rows the slab and its
// neighbours hold, within reach of an output row). By cp.async each float
// is a 4-byte copy (the window interleaves the planes, so a wider copy has
// no contiguous destination, and any width of frame loads alike); through
// registers the clamp's luminance is computed on the way.
template <int S, bool AF>
__device__ __forceinline__ void pass_load(const PassSrc& s, PassBuf w, int x0, int y0, int y_end) {
  using G = PassGeom<S, AF>;
  const int ylo = s.row0 - s.n_above, yhi = min(s.row0 + s.rows + s.n_below, y_end + G::R);
  for (int k = threadIdx.x; k < G::NI; k += G::THREADS) {
    const int ly = k / G::PI;
    const int x = x0 - G::R + (k - ly * G::PI), y = y0 - G::R + ly;
    if (x < 0 || x >= s.W || y < ylo || y >= yhi) continue;
    size_t plane;
    const float* p = pass_row(s, y, plane) + x;
    if constexpr (G::C::ASYNC) {
      float* a = &w.a[k].x;
      float* b = &w.b[k].x;
#pragma unroll
      for (int c = 0; c < 4; ++c) cp_async4(a + c, p + c * plane);
      cp_async4(b, p + 4 * plane);
      cp_async4(b + 1, p + 5 * plane);
    } else {
      const float4 a = make_float4(__ldg(p), __ldg(p + plane), __ldg(p + 2 * plane),
                                   __ldg(p + 3 * plane));
      const float2 b = make_float2(__ldg(p + 4 * plane), __ldg(p + 5 * plane));
      w.a[k] = a;
      w.b[k] = b;
      if (AF) w.lum[k] = lum2(a, b);
    }
  }
  const int zlo = max(s.row0 - S, 0), zhi = min(min(s.row0 + s.rows + S, s.H), y_end + S);
  for (int k = threadIdx.x; k < G::NZ; k += G::THREADS) {
    const int ly = k / G::PZ;
    const int x = x0 - S + (k - ly * G::PZ), y = y0 - S + ly;
    if (x < 0 || x >= s.W || y < zlo || y >= zhi) continue;
    const size_t q = (size_t)(y - s.aux_row0) * s.W + x;
    if constexpr (G::C::ASYNC) {
      float* z = &w.zn[k].x;
      cp_async4(z, s.view_z + q);
#pragma unroll
      for (int c = 0; c < 3; ++c) cp_async4(z + 1 + c, s.normal + c * s.normal_plane + q);
    } else {
      w.zn[k] = make_float4(__ldg(s.view_z + q), __ldg(s.normal + q),
                            __ldg(s.normal + s.normal_plane + q),
                            __ldg(s.normal + 2 * s.normal_plane + q));
    }
  }
}

// The tile's clamp (AF) and pass, its windows loaded (by cp.async: each
// thread's own copies landed, the block's not yet seen). EDGE: the image
// window reaches past the frame, so each read clamps its frame coordinate
// first (the frame's edge padding, of the clamp's output too); else every
// neighbour is a constant slot offset.
template <int S, bool AF, bool EDGE>
__device__ __forceinline__ void pass_compute(const PassSrc& s, PassBuf w, float* __restrict__ out,
                                             int x0, int y0, int y_end) {
  using G = PassGeom<S, AF>;
  const int W = s.W, H = s.H;
  if constexpr (G::C::ASYNC) __syncthreads();
  if (AF) {
    // the clamp on the in-frame pixels of the tile +- S within reach of an
    // output row, in place: a pixel's own slots are the only image slots
    // this stage writes or reads
    const int ylo = max(y0 - S, 0), yhi = min(y_end + S, H);
    for (int k = threadIdx.x; k < G::NZ; k += G::THREADS) {
      const int ly = k / G::PZ;
      const int x = x0 - S + (k - ly * G::PZ), y = y0 - S + ly;
      if (x < 0 || x >= W || y < ylo || y >= yhi) continue;
      const int c = G::ati(x, y, x0, y0);
      float2 l[8];
      int t = 0;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          const int q = EDGE ? G::ati(clampi(x + dx, 0, W - 1), clampi(y + dy, 0, H - 1), x0, y0)
                             : c + dy * G::PI + dx;
          l[t++] = w.lum[q];
        }
      // the plain version's chain of maxima, as a tree three deep: maxn
      // keeps the later of two equal values and any NaN, so a tree that
      // keeps the neighbours' order gives the chain's bits
      const float2 m = max2(max2(max2(l[0], l[1]), max2(l[2], l[3])),
                            max2(max2(l[4], l[5]), max2(l[6], l[7])));
      const float2 lc = w.lum[c];
      float s_d = minn(div0(m.x, maxn(lc.x, F(1e-6))), 1.0f);
      float s_s = minn(div0(m.y, maxn(lc.y, F(1e-6))), 1.0f);
      const float4 a = w.a[c];
      const float2 b = w.b[c];
      w.a[c] = make_float4(a.x * s_d, a.y * s_d, a.z * s_d, a.w * s_s);
      w.b[c] = make_float2(b.x * s_s, b.y * s_s);
    }
    __syncthreads();
  }
  const size_t plane = (size_t)s.rows * W;
  const float s2 = (float)(S * S);
  const int offs[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1}, {0, 1}, {1, -1}, {1, 0}, {1, 1}};
#pragma unroll 1
  for (int j = 0; j < G::TW * G::TH / G::THREADS; ++j) {
    const int x = x0 + threadIdx.x % G::TW;
    const int y = y0 + threadIdx.x / G::TW + j * (G::THREADS / G::TW);
    if (x >= W || y >= y_end) continue;
    // the pass: K3's atrous_px arithmetic
    const int cz = G::atz(x, y, x0, y0), ci = G::ati(x, y, x0, y0);
    const float4 zc4 = w.zn[cz];
    const float vz = zc4.x, n0 = zc4.y, n1 = zc4.z, n2 = zc4.w;
    float zc = F(0.05) * maxn(vz, VIEWZ_MIN);
    const size_t g = (size_t)(y - s.aux_row0) * W + x;
    float rd = maxn(__ldg(s.guide + g), F(1e-3));
    float rs = maxn(__ldg(s.guide + s.guide_plane + g), F(1e-3));
    float g_d = expf(-s2 / (rd * rd));
    float g_s = expf(-s2 / (rs * rs));
    const float4 ca = w.a[ci];
    const float2 cb = w.b[ci];
    float acc[6] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y};
    float wsum_d = 1.0f, wsum_s = 1.0f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int dx = offs[t][1] * S, dy = offs[t][0] * S;
      int qz, qi;
      if (EDGE) {
        const int xq = clampi(x + dx, 0, W - 1), yq = clampi(y + dy, 0, H - 1);
        qz = G::atz(xq, yq, x0, y0);
        qi = G::ati(xq, yq, x0, y0);
      } else {
        qz = cz + dy * G::PZ + dx;
        qi = ci + dy * G::PI + dx;
      }
      const float4 q = w.zn[qz];
      const float4 qa = w.a[qi];
      const float2 qb = w.b[qi];
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
    const size_t i = (size_t)(y - s.row0) * W + x;
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k * plane + i] = div0(acc[k], wsum_d);
#pragma unroll
    for (int k = 3; k < 6; ++k) out[k * plane + i] = div0(acc[k], wsum_s);
  }
}

// Tile t's origin and the end of its output rows; whether its image window
// stays inside the frame (then it reads at constant offsets)
template <int S, bool AF>
__device__ __forceinline__ bool pass_tile(const PassSrc& s, int t, int& x0, int& y0, int& y_end) {
  using G = PassGeom<S, AF>;
  x0 = (t % s.tiles_x) * G::TW;
  y0 = s.row0 + (t / s.tiles_x) * G::TH;
  y_end = min(y0 + G::TH, s.row0 + s.rows);
  return x0 >= G::R && x0 + G::TW + G::R <= s.W && y0 >= G::R && y_end + G::R <= s.H;
}

template <int S, bool AF>
__device__ __forceinline__ void pass_run(const PassSrc& s, PassBuf w, float* __restrict__ out,
                                         int t) {
  int x0, y0, y_end;
  if (pass_tile<S, AF>(s, t, x0, y0, y_end))
    pass_compute<S, AF, false>(s, w, out, x0, y0, y_end);
  else
    pass_compute<S, AF, true>(s, w, out, x0, y0, y_end);
}

template <int S, bool AF>
__global__ void __launch_bounds__(PassCfg<AF>::THREADS, PassCfg<AF>::MIN_BLOCKS)
    atrous_pass_kernel(const PassSrc s, float* __restrict__ out) {
  extern __shared__ float4 pass_smem[];
  using G = PassGeom<S, AF>;
  char* base = reinterpret_cast<char*>(pass_smem);
  int x0, y0, y_end;
  if constexpr (!G::C::ASYNC) {
    const PassBuf w = pass_buf<S, AF>(base);
    pass_tile<S, AF>(s, blockIdx.x, x0, y0, y_end);
    pass_load<S, AF>(s, w, x0, y0, y_end);
    __syncthreads();
    pass_run<S, AF>(s, w, out, blockIdx.x);
  } else {
    // a persistent grid: each block walks tiles blockIdx.x + i gridDim.x,
    // loading tile i + 1 into one window while it filters tile i in the
    // other
    int t = blockIdx.x;
    if (t < s.tiles) {
      pass_tile<S, AF>(s, t, x0, y0, y_end);
      pass_load<S, AF>(s, pass_buf<S, AF>(base), x0, y0, y_end);
    }
    cp_async_commit();
    for (int i = 0; t < s.tiles; ++i, t += gridDim.x) {
      const int next = t + gridDim.x;
      if (next < s.tiles) {
        pass_tile<S, AF>(s, next, x0, y0, y_end);
        pass_load<S, AF>(s, pass_buf<S, AF>(base + ((i + 1) & 1) * G::BYTES), x0, y0, y_end);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of tile t have landed
      pass_run<S, AF>(s, pass_buf<S, AF>(base + (i & 1) * G::BYTES), out, t);
      __syncthreads();  // its window is free for tile t + 2 gridDim.x
    }
  }
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

// K10's tile: one thread per output pixel, PP_W x PP_H a block. Windows of
// the tile, edge-clamped: the specular colour and view_z +- PP_REACH (the
// prepass's outer ring), the two hit distances times their validity +- 1
// (the reconstruction's 3x3).
constexpr int PP_W = 32, PP_H = 16, PP_REACH = 7;
constexpr int PP_P = PP_W + 2 * PP_REACH, PP_N = PP_P * (PP_H + 2 * PP_REACH);
constexpr int PP_HP = PP_W + 2, PP_HN = PP_HP * (PP_H + 2);
// _SPEC_PREPASS_TAPS (post/denoise.py), (dy, dx), in its order
__constant__ int PP_TAPS[16][2] = {{0, 3}, {0, -3}, {3, 0}, {-3, 0}, {2, 2}, {2, -2},
                                   {-2, 2}, {-2, -2}, {0, 7}, {0, -7}, {7, 0}, {-7, 0},
                                   {5, 5}, {5, -5}, {-5, 5}, {-5, -5}};

__global__ void __launch_bounds__(PP_W * PP_H)
    prepass_kernel(const float* __restrict__ curr, const float* __restrict__ view_z,
                   const float* __restrict__ sqrt_rough, float* __restrict__ out, int H, int W) {
  __shared__ float4 s_sz[PP_N];   // specular rgb, view_z
  __shared__ float2 s_hv[PP_HN];  // hit distance x validity, channels 3 and 7
  const int tid = threadIdx.y * PP_W + threadIdx.x;
  const int x0 = blockIdx.x * PP_W, y0 = blockIdx.y * PP_H;
  const size_t plane = (size_t)H * W;
  for (int k = tid; k < PP_N; k += PP_W * PP_H) {
    int ly = k / PP_P;
    int gx = clampi(x0 - PP_REACH + (k - ly * PP_P), 0, W - 1);
    int gy = clampi(y0 - PP_REACH + ly, 0, H - 1);
    size_t q = (size_t)gy * W + gx;
    s_sz[k] = make_float4(__ldg(curr + 4 * plane + q), __ldg(curr + 5 * plane + q),
                          __ldg(curr + 6 * plane + q), __ldg(view_z + q));
  }
  // hd * vf, vf = (hd > 0) & not_sky as 0 or 1: vf is then (hd * vf > 0)
  for (int k = tid; k < PP_HN; k += PP_W * PP_H) {
    int ly = k / PP_HP;
    int gx = clampi(x0 - 1 + (k - ly * PP_HP), 0, W - 1);
    int gy = clampi(y0 - 1 + ly, 0, H - 1);
    size_t q = (size_t)gy * W + gx;
    bool not_sky = __ldg(view_z + q) < NOT_SKY_Z;
    float h3 = __ldg(curr + 3 * plane + q), h7 = __ldg(curr + 7 * plane + q);
    s_hv[k] = make_float2(h3 * (h3 > 0.0f && not_sky ? 1.0f : 0.0f),
                          h7 * (h7 > 0.0f && not_sky ? 1.0f : 0.0f));
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)y * W + x;
  const int c = (threadIdx.y + PP_REACH) * PP_P + threadIdx.x + PP_REACH;
  const int ch = (threadIdx.y + 1) * PP_HP + threadIdx.x + 1;
  const float4 cz = s_sz[c];
  const float vz = cz.w;
  const bool not_sky = vz < NOT_SKY_Z;
  // the hit-distance reconstruction: the mean of the valid 3x3 neighbours
  float hd[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    float s = 0.0f, cnt = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const float2 q = s_hv[ch + dy * PP_HP + dx];
        const float v = g ? q.y : q.x;
        s = s + v;
        cnt = cnt + (v > 0.0f ? 1.0f : 0.0f);
      }
    const float h = __ldg(curr + (3 + 4 * g) * plane + i);
    const bool need = h <= 0.0f && not_sky && cnt > 0.0f;
    hd[g] = need ? s / tclamp_lo(cnt, 1.0f) : h;
  }
  // the specular prepass blur: 16 taps, radius from the reconstructed hd
  const float hs = tclamp_lo(hd[1], 0.0f);
  const float zc = tclamp_lo(vz, VIEWZ_MIN);
  const float hd_factor = hs / (hs + zc * F(0.2) + F(1e-6));
  const float radius = tclamp(__ldg(sqrt_rough + i), 0.0f, 1.0f) * F(10.0) * hd_factor;
  const float rc = tclamp_lo(radius, F(1e-3));
  const float r2inv = 1.0f / (rc * rc);  // torch: -d2 / r2 is r2.reciprocal() * -d2
  const float zs = zc * F(0.05);
  // the taps' Gaussians: each run of four taps lies at one distance, so four
  // expf a pixel give all sixteen
  float gauss[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = PP_TAPS[4 * k][0], dx = PP_TAPS[4 * k][1];
    gauss[k] = expf(r2inv * (float)(-(dy * dy + dx * dx)));
  }
  float a0 = cz.x, a1 = cz.y, a2 = cz.z, wsum = 1.0f;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int dy = PP_TAPS[t][0], dx = PP_TAPS[t][1];
    const float4 q = s_sz[c + dy * PP_P + dx];
    // a tap at the pixel's own depth: expf(-0) is 1
    const float dz = -fabsf(q.w - vz);
    const float wt = gauss[t / 4] * (dz == 0.0f ? 1.0f : expf(div0(dz, zs)));
    a0 = a0 + q.x * wt;
    a1 = a1 + q.y * wt;
    a2 = a2 + q.z * wt;
    wsum = wsum + wt;
  }
  out[i] = __ldg(curr + i);
  out[plane + i] = __ldg(curr + plane + i);
  out[2 * plane + i] = __ldg(curr + 2 * plane + i);
  out[3 * plane + i] = hd[0];
  out[4 * plane + i] = a0 / wsum;
  out[5 * plane + i] = a1 / wsum;
  out[6 * plane + i] = a2 / wsum;
  out[7 * plane + i] = hd[1];
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
constexpr int MAX_DEVICES = 64;

// Above 48 KB a block's dynamic shared memory needs the kernel's attribute
// set, once for each device.
cudaError_t atrous_smem_attribute() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev].load())) return err;
  err = cudaFuncSetAttribute(atrous_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             AT_SMEM_BYTES);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true);
  return err;
}

// A K3-pass instantiation's shared memory a block, its attribute set once
// for each device; blocks: the blocks an SM holds at once.
template <int S, bool AF>
cudaError_t pass_occupancy(int& bytes, int& blocks) {
  static std::atomic<int> known[MAX_DEVICES];  // blocks an SM, 0 until set
  using G = PassGeom<S, AF>;
  bytes = G::BYTES * G::BUFFERS;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  blocks = dev < MAX_DEVICES ? known[dev].load() : 0;
  if (blocks > 0) return cudaSuccess;
  err = cudaFuncSetAttribute(atrous_pass_kernel<S, AF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, atrous_pass_kernel<S, AF>,
                                                        G::THREADS, bytes);
  if (err == cudaSuccess && blocks < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess && dev < MAX_DEVICES) known[dev].store(blocks);
  return err;
}

// One launch of K3-pass<S, AF> on slab s: a block a tile, or (ASYNC) as
// many blocks as the card holds at once, each walking the tiles.
template <int S, bool AF>
cudaError_t pass_launch(PassSrc s, float* out, cudaStream_t st) {
  using G = PassGeom<S, AF>;
  s.tiles_x = (s.W + G::TW - 1) / G::TW;
  s.tiles = s.tiles_x * ((s.rows + G::TH - 1) / G::TH);
  int bytes, blocks, dev, sms;
  cudaError_t err = pass_occupancy<S, AF>(bytes, blocks);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = G::C::ASYNC ? std::min(s.tiles, blocks * sms) : s.tiles;
  atrous_pass_kernel<S, AF><<<grid, G::THREADS, bytes, st>>>(s, out);
  return cudaGetLastError();
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
// anti_firefly is nonzero (another stride returns cudaErrorInvalidValue),
// on the slab of `rows` rows from frame row row0 of a global_h-row frame:
// img [6, rows, W], the frame rows above and below it (min(reach, the
// rows to the frame's edge) each, reach = stride + anti_firefly), and
// view_z, normal and guide from frame row aux_row0; each [.., n, W] array
// has rows of W floats and planes *_plane floats apart. out [6, rows, W].
// A whole frame is the slab with row0 0 and global_h rows.
extern "C" int rtvs_atrous_pass(const float* img, int img_plane, const float* above,
                                int above_plane, const float* below, int below_plane,
                                const float* view_z, const float* normal, int normal_plane,
                                const float* guide, int guide_plane, float* out, int rows, int W,
                                int row0, int global_h, int aux_row0, int stride,
                                int anti_firefly, void* stream) {
  if (rows <= 0 || W <= 0) return (int)cudaSuccess;
  const int reach = stride + (anti_firefly ? 1 : 0);
  PassSrc s;
  s.img = img;
  s.above = above;
  s.below = below;
  s.img_plane = (size_t)img_plane;
  s.above_plane = (size_t)above_plane;
  s.below_plane = (size_t)below_plane;
  s.view_z = view_z;
  s.normal = normal;
  s.guide = guide;
  s.normal_plane = (size_t)normal_plane;
  s.guide_plane = (size_t)guide_plane;
  s.rows = rows;
  s.W = W;
  s.row0 = row0;
  s.H = global_h;
  s.aux_row0 = aux_row0;
  s.n_above = std::min(reach, row0);
  s.n_below = std::min(reach, global_h - row0 - rows);
  cudaStream_t st = (cudaStream_t)stream;
  switch (stride * 2 + (anti_firefly ? 1 : 0)) {
    case 2: return (int)pass_launch<1, false>(s, out, st);
    case 3: return (int)pass_launch<1, true>(s, out, st);
    case 4: return (int)pass_launch<2, false>(s, out, st);
    case 5: return (int)pass_launch<2, true>(s, out, st);
    case 8: return (int)pass_launch<4, false>(s, out, st);
    case 9: return (int)pass_launch<4, true>(s, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rtvs_shadow_denoise(const float* shadow, const int* obj_id, const float* view_z,
                                   const float* normal, float* out, int H, int W, void* stream) {
  shadow_kernel<<<dim3((W + SH_W - 1) / SH_W, (H + SH_H - 1) / SH_H), dim3(SH_W, SH_H), 0,
                  (cudaStream_t)stream>>>(shadow, obj_id, view_z, normal, out, H, W);
  return (int)cudaGetLastError();
}

// K10 on curr [8, H, W] (diffuse rgb + hit distance, specular rgb + hit
// distance), view_z and sqrt_rough [H, W]: out [8, H, W]. A row slab
// extended by its neighbours' rows is a frame of its own rows.
extern "C" int rtvs_reblur_prepass(const float* curr, const float* view_z,
                                   const float* sqrt_rough, float* out, int H, int W,
                                   void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  prepass_kernel<<<dim3((W + PP_W - 1) / PP_W, (H + PP_H - 1) / PP_H), dim3(PP_W, PP_H), 0,
                   (cudaStream_t)stream>>>(curr, view_z, sqrt_rough, out, H, W);
  return (int)cudaGetLastError();
}

// For the record: out[0] K3's dynamic shared memory a block in bytes,
// out[1] K3's and out[2] K4's resident blocks an SM; then K3-pass's
// shared memory a block and blocks an SM, two ints for each of strides 1,
// 2, 4, each without and with the clamp (out[3] to out[14]).
extern "C" int rtvs_denoise_occupancy(int* out) {
  cudaError_t err = atrous_smem_attribute();
  if (err != cudaSuccess) return (int)err;
  out[0] = AT_SMEM_BYTES;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, atrous_kernel, AT_THREADS,
                                                      AT_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, shadow_kernel, SH_W * SH_H, 0);
  if (err == cudaSuccess) err = pass_occupancy<1, false>(out[3], out[4]);
  if (err == cudaSuccess) err = pass_occupancy<1, true>(out[5], out[6]);
  if (err == cudaSuccess) err = pass_occupancy<2, false>(out[7], out[8]);
  if (err == cudaSuccess) err = pass_occupancy<2, true>(out[9], out[10]);
  if (err == cudaSuccess) err = pass_occupancy<4, false>(out[11], out[12]);
  if (err == cudaSuccess) err = pass_occupancy<4, true>(out[13], out[14]);
  return (int)err;
}
