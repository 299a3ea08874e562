// K5 and K6: the photon-mapped caustics kernels for Hopper (sm_90a).
//
// K5 (rtvs_photon_trace) replaces the Pallas TPU kernel raytracevs_tpu/ops/
// pallas/photon_trace.py::_photon_kernel (launched by trace_photons_pallas):
// the 4-bounce photon loop over the analytic primitives with Russian
// roulette, the Fresnel glass choice, roughness-lerped metal and the store
// at the first diffuse hit after a specular one. Its plain version is
// raytracevs_tpu_torch/ops/photon.py::_trace_photons; the closest hit is
// K1's own (closest.cuh: trace_closest<0>, the isect_* tests and
// box_face_normal), so photons and camera rays see the same surfaces.
// Design: one thread per photon, the loop in registers, the thread retires
// when its photon dies. On the TPU the photons were [32,128] tiles walked
// in lockstep. What bounds it: the 45 bytes a photon reads and the 41 it
// writes (the scene tables stay in L1); the intersection arithmetic per
// bounce is a few hundred operations, far below the card's rate at 16k to
// 131k photons. At these counts a launch fills the card only partly
// (16,384 threads = 64 blocks of 256 on 132 SMs), so latency rules.
//
// K6 (rtvs_photon_gather) replaces raytracevs_tpu/ops/pallas/photon_gather.py
// ::_make_kernel (launched by gather_pallas) but follows the reference
// semantics of raytracevs_tpu/ops/photon.py::gather: per eligible pixel,
// the 19 hash cells around its cell in (z, y, x) order with the corners
// culled, at most 64 photons scanned per cell, the 32-accept early-out, the
// Gaussian exp(-d^2/(2 r^2 0.5)) * dot(-dir, n), / (pi r^2) * intensity,
// and a photon counted again when two neighbour cells share a hash slot.
// Its plain version is ops/photon.py::caustics_delta. The Morton sort,
// dense 8-per-row packing and two-level box walk of pack_photons existed
// for the TPU's VMEM and scalar unit and are not ported. Design: one thread
// per pixel in 16x16 blocks, reading the channel-first accumulator planes
// (primary position, normal, hit, metallic, transmission) directly and
// writing delta [3,H,W], zero off eligible pixels. What bounds it: the 12
// bytes a pixel writes and the up to 36 it reads (the hit flag everywhere;
// metallic, transmission, position and normal only as far as the
// eligibility test gets); the photon table (16,384 x 41 bytes plus 512 KB
// of cell ranges) stays in L2, and pixels near a caustic scan up to 19 x 64
// photons while the rest scan none, so divergence is the cost beyond the
// bytes.

#include "closest.cuh"

namespace {

// WangHash (Common.hlsli:762-770)
__device__ __forceinline__ uint32_t wang_hash(uint32_t seed) {
  seed = (seed ^ 61u) ^ (seed >> 16);
  seed = seed * 9u;
  seed = seed ^ (seed >> 4);
  seed = seed * 0x27D4EB2Du;
  seed = seed ^ (seed >> 15);
  return seed;
}

// RandomFloat (Common.hlsli:833-837): advance the state, top 24 bits
__device__ __forceinline__ float random_float(uint32_t& seed) {
  seed = pcg_hash(seed);
  return u24f(seed);
}

constexpr int MAX_PHOTON_BOUNCES = 4;

__global__ void __launch_bounds__(256)
    photon_trace_kernel(Cfg c, Scene sc, int n, const float* __restrict__ origin,
                        const float* __restrict__ direction, const float* __restrict__ color,
                        const float* __restrict__ power, const uint8_t* __restrict__ alive,
                        const int* __restrict__ idx, float* __restrict__ store_pos,
                        float* __restrict__ store_dir, float* __restrict__ store_color,
                        float* __restrict__ store_power, uint8_t* __restrict__ store_mask) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  V3 o = ld3(origin + 3 * i), d = ld3(direction + 3 * i), col = ld3(color + 3 * i);
  float pw = __ldg(power + i);
  bool live = __ldg(alive + i) != 0;
  uint32_t gidx = (uint32_t)__ldg(idx + i);
  bool stored = false, caustic = false;
  V3 s_pos = v3(0.0f, 0.0f, 0.0f), s_dir = s_pos, s_col = s_pos;
  float s_pow = 0.0f;
  for (int depth = 0; depth < MAX_PHOTON_BOUNCES && live; ++depth) {
    Hit h = trace_closest<0>(c, sc, o, d, INVALID, 0, -1);
    if (!h.hit) break;
    V3 pos = add(o, scale(d, h.t));
    // the outward geometric normal (ops/photon.py flips the ray-faced
    // normal back, which gives this one)
    V3 n;
    if (h.type == TYPE_SPHERE) n = normalize(sub(pos, ld3(sc.sph + SPH_W * h.index)));
    else if (h.type == TYPE_PLANE) n = normalize(ld3(sc.pln + PLN_W * h.index + 3));
    else n = box_face_normal(pos, sc.box + BOX_W * h.index);
    const float* mt = sc.mat + MAT_W * h.slot;
    V3 rgb = ld3(mt);
    float metallic = __ldg(mt + 3), roughness = __ldg(mt + 4), transmission = __ldg(mt + 5);
    float ior = __ldg(mt + 6);

    // Russian roulette per (photon, depth)
    uint32_t seed = wang_hash((gidx * 9781u) ^ ((uint32_t)depth * 0x9E3779B9u));
    float rr = random_float(seed);
    float survival = clampn(maxn(maxn(rgb.x, rgb.y), rgb.z), F(0.1), F(0.95));
    pw = pw / survival;
    col = mul(col, rgb);
    live = rr <= survival;

    bool is_glass = transmission > F(0.5);
    bool is_metal = !is_glass && metallic > F(0.5);
    if (!is_glass && !is_metal) {
      // diffuse: store if caustic, terminate (PhotonTrace.hlsl:117-128)
      if (live && caustic && !stored) {
        stored = true;
        s_pos = pos;
        s_dir = d;
        s_col = col;
        s_pow = pw;
      }
      break;
    }
    if (!live) break;
    caustic = true;
    float choice = random_float(seed);
    if (is_glass) {
      // probabilistic Fresnel reflect/refract (PhotonTrace.hlsl:129-190)
      V3 view = neg(d);
      bool front2 = dot(view, n) > 0.0f;
      V3 outward = front2 ? n : neg(n);
      float cos_theta = fabsf(dot(view, outward));
      float f0 = (1.0f - ior) / (1.0f + ior);
      f0 = f0 * f0;
      float om = 1.0f - cos_theta;
      float om2 = om * om;
      float fresnel = f0 + (1.0f - f0) * (om2 * om2 * om);
      bool refracting = choice > fresnel;
      float eta = front2 ? 1.0f / ior : ior;
      float cosi = -dot(d, outward);
      float sin2t = eta * eta * (1.0f - cosi * cosi);
      bool thru = refracting && !(sin2t > 1.0f);
      float cost = sqrtf(maxn(1.0f - sin2t, 0.0f));
      float k = eta * cosi - cost;
      V3 refr = v3(eta * d.x + k * outward.x, eta * d.y + k * outward.y, eta * d.z + k * outward.z);
      V3 refl = sub(d, scale(outward, 2.0f * dot(d, outward)));
      o = thru ? sub(pos, scale(outward, F(0.01))) : add(pos, scale(outward, F(0.01)));
      d = thru ? normalize(refr) : refl;
    } else {
      // metal: roughness-lerped reflection (PhotonTrace.hlsl:191-223)
      V3 refl_m = sub(d, scale(n, 2.0f * dot(d, n)));
      float hz = random_float(seed);
      float hphi = random_float(seed);
      float hz2 = hz * 2.0f - 1.0f;
      float hr = sqrtf(maxn(0.0f, 1.0f - hz2 * hz2));
      float ang = hphi * F(6.28318530718);
      V3 hemi = v3(hr * cosf(ang), hr * sinf(ang), hz2);
      if (!(dot(hemi, n) > 0.0f)) hemi = neg(hemi);
      float rough2 = roughness * roughness;
      V3 m = add(refl_m, scale(sub(hemi, refl_m), rough2));
      o = add(pos, scale(n, F(0.01)));
      d = roughness > F(0.01) ? normalize(m) : refl_m;
    }
  }
  float* sp = store_pos + 3 * i;
  float* sd = store_dir + 3 * i;
  float* sc3 = store_color + 3 * i;
  sp[0] = s_pos.x; sp[1] = s_pos.y; sp[2] = s_pos.z;
  sd[0] = s_dir.x; sd[1] = s_dir.y; sd[2] = s_dir.z;
  sc3[0] = s_col.x; sc3[1] = s_col.y; sc3[2] = s_col.z;
  store_power[i] = s_pow;
  store_mask[i] = stored ? 1 : 0;
}

constexpr uint32_t HASH_SIZE = 65536u;  // PHOTON_HASH_TABLE_SIZE
constexpr int CELL_SCAN_CAP = 64;       // MAX_PHOTONS_PER_CELL
constexpr int MAX_GATHER = 32;          // MAX_GATHER_PHOTONS_THRESHOLD

// HashPhotonCell (Common.hlsli:877-883)
__device__ __forceinline__ int hash_cell(int x, int y, int z) {
  uint32_t h = ((uint32_t)x * 73856093u) ^ ((uint32_t)y * 19349663u) ^ ((uint32_t)z * 83492791u);
  return (int)(h % HASH_SIZE);
}

struct PhotonTable {
  const float *pos, *dir, *col, *pow;
  const uint8_t* valid;
  const int *cell_start, *cell_count, *count;
  const float *radius, *intensity;
  int n;
};

__global__ void __launch_bounds__(256)
    photon_gather_kernel(int width, int height, const float* __restrict__ ppos,
                         const float* __restrict__ pnrm, const float* __restrict__ phit,
                         const float* __restrict__ pmetal, const float* __restrict__ ptrans,
                         PhotonTable pt, float spp, float* __restrict__ out) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  size_t plane = (size_t)width * height, p = (size_t)y * width + x;
  V3 delta = v3(0.0f, 0.0f, 0.0f);
  bool eligible = __ldg(phit + p) > F(0.5) && __ldg(pmetal + p) < F(0.5) &&
                  __ldg(ptrans + p) <= F(0.01);
  if (eligible) {
    V3 pos = v3(__ldg(ppos + p), __ldg(ppos + plane + p), __ldg(ppos + 2 * plane + p));
    V3 nrm = v3(__ldg(pnrm + p), __ldg(pnrm + plane + p), __ldg(pnrm + 2 * plane + p));
    float radius = __ldg(pt.radius);
    float radius_sq = radius * radius;
    float cell_size = maxn(radius * 2.0f, F(1e-4));
    float den = 2.0f * radius_sq * F(0.5);
    int count = __ldg(pt.count);
    int bx = (int)floorf(pos.x / cell_size), by = (int)floorf(pos.y / cell_size),
        bz = (int)floorf(pos.z / cell_size);
    V3 caustic = v3(0.0f, 0.0f, 0.0f);
    float weight = 0.0f;
    int gathered = 0;
    for (int oz = -1; oz <= 1 && gathered < MAX_GATHER; ++oz)
      for (int oy = -1; oy <= 1 && gathered < MAX_GATHER; ++oy)
        for (int ox = -1; ox <= 1 && gathered < MAX_GATHER; ++ox) {
          if (ox * ox + oy * oy + oz * oz > 2) continue;  // corner cells
          int h = hash_cell(bx + ox, by + oy, bz + oz);
          int st = __ldg(pt.cell_start + h);
          int cnt = min(__ldg(pt.cell_count + h), CELL_SCAN_CAP);
          for (int off = 0; off < cnt && gathered < MAX_GATHER; ++off) {
            int pi = min(max(st + off, 0), pt.n - 1);
            if (!(__ldg(pt.valid + pi) != 0 && pi < count)) continue;
            V3 diff = sub(pos, ld3(pt.pos + 3 * pi));
            float dist_sq = dot(diff, diff);
            float dot_n = dot(neg(ld3(pt.dir + 3 * pi)), nrm);
            if (!(dist_sq < radius_sq && dot_n > 0.0f)) continue;
            float w = expf(-dist_sq / den) * dot_n;
            float pw = __ldg(pt.pow + pi) * w;
            V3 pc = ld3(pt.col + 3 * pi);
            caustic = add(caustic, v3(pc.x * pw, pc.y * pw, pc.z * pw));
            weight = weight + w;
            gathered += 1;
          }
        }
    if (weight > 0.0f) {
      float area = F(3.14159265) * radius_sq;
      float k = __ldg(pt.intensity);
      delta = v3(caustic.x / area * k * spp, caustic.y / area * k * spp,
                 caustic.z / area * k * spp);
    }
  }
  out[p] = delta.x;
  out[plane + p] = delta.y;
  out[2 * plane + p] = delta.z;
}

}  // namespace

// K5: origin/direction/color [n,3], power [n] f32, alive [n] u8, idx [n]
// int32 (global photon index); the scene tables of pack_scene (M material
// rows; only the analytic primitives are traced). Writes store_pos/dir/
// color [n,3], store_power [n], store_mask [n] u8. Returns the launch's
// cudaError_t.
extern "C" int rtvs_photon_trace(const float* ftab, int S, int P, int B, int M, int L, int n,
                                 const float* origin, const float* direction, const float* color,
                                 const float* power, const uint8_t* alive, const int* idx,
                                 float* store_pos, float* store_dir, float* store_color,
                                 float* store_power, uint8_t* store_mask, void* stream) {
  Cfg c = make_cfg(0, 0, S, P, B, L, 0, 0, 0, 0, 0, 0.0f);
  Scene sc = make_scene(ftab, S, P, B, M, L);
  int blocks = (n + 255) / 256;
  if (blocks > 0)
    photon_trace_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        c, sc, n, origin, direction, color, power, alive, idx, store_pos, store_dir, store_color,
        store_power, store_mask);
  return (int)cudaGetLastError();
}

// K6: the accumulator planes pos/nrm [3,H,W], hit/metal/trans [H,W]; the
// sorted photon map (pos/dir/col [n,3], pow [n], valid [n] u8, cell_start/
// cell_count [65536] int32, count/radius/intensity 0-d on the device).
// Writes delta [3,H,W]. Returns the launch's cudaError_t.
extern "C" int rtvs_photon_gather(int width, int height, const float* pos, const float* nrm,
                                  const float* hit, const float* metal, const float* trans,
                                  const float* ph_pos, const float* ph_dir, const float* ph_col,
                                  const float* ph_pow, const uint8_t* ph_valid, int n,
                                  const int* cell_start, const int* cell_count, const int* count,
                                  const float* radius, const float* intensity, float spp,
                                  float* out, void* stream) {
  PhotonTable pt = {ph_pos, ph_dir, ph_col, ph_pow, ph_valid, cell_start, cell_count,
                    count, radius, intensity, n};
  dim3 block(16, 16);
  dim3 grid((width + 15) / 16, (height + 15) / 16);
  photon_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(width, height, pos, nrm, hit,
                                                                 metal, trans, pt, spp, out);
  return (int)cudaGetLastError();
}
