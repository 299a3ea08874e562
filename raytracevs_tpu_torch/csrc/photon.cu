// K5 and K6: the photon-mapped caustics kernels for Hopper (sm_90a).
//
// K5 (rtvs_photon_trace) replaces the Pallas TPU kernel raytracevs_tpu/ops/
// pallas/photon_trace.py::_photon_kernel (launched by trace_photons_pallas)
// and the jnp emission in front of it (raytracevs_tpu/ops/photon.py::
// _emit_photons): each thread emits its photon from the lights in
// registers (the light chosen by its global index, the two randoms, a point
// light's sphere direction and 4 pi power, a directional light's emitter
// plane 50 units back) and runs the 4-bounce loop over the analytic
// primitives with Russian roulette, the Fresnel glass choice,
// roughness-lerped metal and the store at the first diffuse hit after a
// specular one. Its plain version is raytracevs_tpu_torch/ops/photon.py::
// _emit_photons followed by _trace_photons, operation for operation; the
// closest hit is K1's own (closest.cuh: trace_closest<0>, the isect_* tests
// and box_face_normal), so photons and camera rays see the same surfaces.
// It reads the scene from the frame's one table pack (pack_tables, which
// K1 uses too): the light count from itab, no host sync. On the TPU the
// photons were [32,128] tiles walked in lockstep, and emission was ~60
// elementwise ops over the batch; here emission is a few hundred
// instructions in front of the loop, and a slice [offset, offset + n) of a
// batch equals the same rows of the whole.
// What bounds it: latency. At 16,384 photons the work is ~0.1 us of the
// card's float rate and the bytes ~0.2 us of its memory rate, while the
// launch takes ~0.017 ms on the device: one thread's chain (emission, then
// up to 4 closest hits, each a dependent test of every primitive) and the
// launch itself. The launch puts a block on every SM (PHOTON_THREADS, 64
// a block: 256 blocks on 132 SMs at 16,384 photons); 256-thread blocks
// measured the same (PERF.md). At 131,072 photons the card is full (2,048
// blocks of 64) and the chains overlap: ~0.021 ms. The scene tables stay
// in L1.
//
// K6 (rtvs_photon_gather) replaces raytracevs_tpu/ops/pallas/photon_gather.py
// ::_make_kernel (launched by gather_pallas) but follows the reference
// semantics of raytracevs_tpu/ops/photon.py::gather: per eligible pixel,
// the 19 hash cells around its cell in (z, y, x) order with the corners
// culled, at most 64 photons scanned per cell, the 32-accept early-out, the
// Gaussian exp(-d^2/(2 r^2 0.5)) * dot(-dir, n), / (pi r^2) * intensity,
// and a photon counted again when two neighbour cells share a hash slot.
// It adds the caustic, times spp, into the accumulator's colour and diffuse
// planes in place, at the pixels whose gather found weight (RayGen.hlsl:
// 505-533); every other pixel and plane keeps its bits. In a photon debug
// mode (replace, an instantiation of its own) it instead replaces the
// depth-0 contribution at every eligible pixel with the caustic times the
// debug scale, as raytracevs_tpu/ops/render_cf.py::_apply_caustics_cf
// folds it in: colour - primary + d, primary and diffuse d, specular 0 and
// the SIGMA record lit. Its plain version is ops/photon.py::add_caustics.
// The Morton sort, dense 8-per-row packing
// and two-level box walk of pack_photons existed for the TPU's VMEM and
// scalar unit and are not ported. Design: one thread per pixel in 32x8
// blocks, so a warp reads whole 128-byte rows of each plane (16x16 ran
// 3.5% slower); the eligibility test reads the hit flag everywhere and
// metallic and transmission only as far as it gets; a scanned photon's
// position is tested against the radius before its other fields are read.
// What bounds it: the scans, the photon visits of the pixels near a
// caustic (up to 19 x 64 a pixel; 11.2M at 16,384 photons at 1080p), each
// a chain of dependent L1 loads and tests in the warp's slowest lane; of
// its ~0.07 ms at 1080p, the eligibility sweep alone takes ~0.009 and the
// cell ranges ~0.018 more (PERF.md). Measured slower there, so not kept:
// the 19 ranges loaded before the first scan (in registers or local
// memory), and the stored photons' positions staged in shared memory.

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

// A photon's first ray (PhotonEmit.hlsl:44-117): ops/photon.py::_emit_photons
// for global index idx of a `total`-photon batch
struct Photon {
  V3 o, d, col;
  float pw;
  bool live;
};

__device__ __forceinline__ Photon emit_photon(const Cfg& c, const Scene& sc, int total, int idx) {
  uint32_t seed = wang_hash((uint32_t)idx * 1973u + 9277u);
  // photons split evenly over the non-ambient lights in light order
  int non_ambient = 0;
  for (int li = 0; li < c.L; ++li) {
    const float* lt = sc.lts + LT_W * li;
    bool lv = li < sc.num_lights && __ldg(lt + 10) > 0.5f;
    non_ambient += (lv && (int)__ldg(lt) != LIGHT_AMBIENT) ? 1 : 0;
  }
  int per_light = max(total / max(non_ambient, 1), 1);
  int ordinal = min(idx / per_light, max(non_ambient - 1, 0));
  // the ordinal-th non-ambient light; none: an ambient type, not emitted
  int type = LIGHT_AMBIENT;
  V3 lpos = v3(0.0f, 0.0f, 0.0f), lcol = v3(1.0f, 1.0f, 1.0f);
  float lint = 1.0f;
  int running = 0;
  for (int li = 0; li < c.L; ++li) {
    const float* lt = sc.lts + LT_W * li;
    bool lv = li < sc.num_lights && __ldg(lt + 10) > 0.5f;
    bool na = lv && (int)__ldg(lt) != LIGHT_AMBIENT;
    if (na && ordinal == running) {
      type = (int)__ldg(lt);
      lpos = ld3(lt + 1);
      lcol = ld3(lt + 4);
      lint = __ldg(lt + 7);
    }
    running += na ? 1 : 0;
  }
  Photon ph;
  ph.col = scale(lcol, lint);
  ph.pw = lint / (float)per_light;

  // point: from the position over the sphere, power *= 4 pi (PhotonEmit.hlsl:90-98)
  float z0 = random_float(seed);
  float p0 = random_float(seed);
  float z = z0 * 2.0f - 1.0f;
  float phi = p0 * F(6.28318530718);
  float r = sqrtf(maxn(1.0f - z * z, 0.0f));
  V3 sphere_dir = v3(r * cosf(phi), r * sinf(phi), z);
  bool is_point = type == LIGHT_POINT, is_dir = type == LIGHT_DIRECTIONAL;
  if (is_point) ph.pw = ph.pw * F(4.0 * 3.14159265);

  // directional: a virtual emitter plane 20 units wide, 50 back
  // (PhotonEmit.hlsl:99-117), from the same two randoms
  V3 ldir = normalize(neg(lpos));
  V3 up = fabsf(ldir.y) < F(0.999) ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  V3 right = normalize(cross(up, ldir));
  V3 real_up = cross(ldir, right);
  float off_x = (z0 * 2.0f - 1.0f) * 20.0f;
  float off_y = (p0 * 2.0f - 1.0f) * 20.0f;
  V3 plane_origin = sub(add(scale(right, off_x), scale(real_up, off_y)), scale(ldir, 50.0f));
  ph.o = is_point ? lpos : plane_origin;
  ph.d = is_point ? sphere_dir : ldir;
  ph.live = is_point || is_dir;
  return ph;
}

// K5's block: 64 threads, so that 16,384 photons give every SM work
constexpr int PHOTON_THREADS = 64;

// thread i: photon offset + i of a `total`-photon batch, emitted and traced
__global__ void __launch_bounds__(PHOTON_THREADS)
    photon_trace_kernel(Cfg c, Scene sc, const int* __restrict__ itab, int total, int offset,
                        int n, float* __restrict__ store_pos, float* __restrict__ store_dir,
                        float* __restrict__ store_color, float* __restrict__ store_power,
                        uint8_t* __restrict__ store_mask) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sc.num_lights = __ldg(itab);  // on the device: no host sync to launch
  Photon ph = emit_photon(c, sc, total, offset + i);
  V3 o = ph.o, d = ph.d, col = ph.col;
  float pw = ph.pw;
  bool live = ph.live;
  uint32_t gidx = (uint32_t)(offset + i);
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

// Threads a block of K6: 32 x 8 pixels, a warp one 128-byte row of a plane
constexpr int GATHER_BX = 32, GATHER_BY = 8;

// REPLACE: a photon debug mode's replacement fold-in instead of the add (an
// instantiation of its own, so the add's code stays as it was)
template <bool REPLACE>
__global__ void __launch_bounds__(GATHER_BX * GATHER_BY)
    photon_gather_kernel(int width, int height, const float* __restrict__ ppos,
                         const float* __restrict__ pnrm, const float* __restrict__ phit,
                         const float* __restrict__ pmetal, const float* __restrict__ ptrans,
                         PhotonTable pt, float spp, float dbg_scale, float* __restrict__ color,
                         float* __restrict__ primary, float* __restrict__ diffuse,
                         float* __restrict__ specular, float* __restrict__ shadow) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;
  size_t plane = (size_t)width * height, p = (size_t)y * width + x;
  bool eligible = __ldg(phit + p) > F(0.5) && __ldg(pmetal + p) < F(0.5) &&
                  __ldg(ptrans + p) <= F(0.01);
  if (!eligible) return;
  V3 pos = v3(__ldg(ppos + p), __ldg(ppos + plane + p), __ldg(ppos + 2 * plane + p));
  V3 nrm = v3(__ldg(pnrm + p), __ldg(pnrm + plane + p), __ldg(pnrm + 2 * plane + p));
  float radius = __ldg(pt.radius);
  float radius_sq = radius * radius;
  float cell_size = maxn(radius * 2.0f, F(1e-4));
  float den = 2.0f * radius_sq * F(0.5);
  int count = __ldg(pt.count);
  int bx = (int)floorf(pos.x / cell_size), by = (int)floorf(pos.y / cell_size),
      bz = (int)floorf(pos.z / cell_size);
  // the 19 cells in order, each cell's range loaded before its scan; a
  // photon is tested for the radius before its other fields are loaded
  // (most photons of the neighbour cells lie beyond it), which accepts the
  // photons the plain version accepts, in its order
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
          V3 diff = sub(pos, ld3(pt.pos + 3 * pi));
          float dist_sq = dot(diff, diff);
          if (!(dist_sq < radius_sq)) continue;
          if (!(__ldg(pt.valid + pi) != 0 && pi < count)) continue;
          float dot_n = dot(neg(ld3(pt.dir + 3 * pi)), nrm);
          if (!(dot_n > 0.0f)) continue;
          float w = expf(-dist_sq / den) * dot_n;
          float pw = __ldg(pt.pow + pi) * w;
          V3 pc = ld3(pt.col + 3 * pi);
          caustic = add(caustic, v3(pc.x * pw, pc.y * pw, pc.z * pw));
          weight = weight + w;
          gathered += 1;
        }
      }
  if (!(weight > 0.0f) && !REPLACE) return;
  float area = F(3.14159265) * radius_sq;
  float kc = __ldg(pt.intensity);
  V3 delta = v3(0.0f, 0.0f, 0.0f);
  if (weight > 0.0f)
    delta = v3(caustic.x / area * kc * spp, caustic.y / area * kc * spp,
               caustic.z / area * kc * spp);
  if constexpr (REPLACE) {
    // a photon debug mode (RayGen.hlsl:509-518): the caustic times the
    // debug scale replaces the depth-0 contribution at every eligible
    // pixel, lit or not; the specular record is cleared, the SIGMA record lit
    V3 d = scale(delta, dbg_scale);
    color[p] = color[p] - primary[p] + d.x;
    color[plane + p] = color[plane + p] - primary[plane + p] + d.y;
    color[2 * plane + p] = color[2 * plane + p] - primary[2 * plane + p] + d.z;
    primary[p] = d.x;
    primary[plane + p] = d.y;
    primary[2 * plane + p] = d.z;
    diffuse[p] = d.x;
    diffuse[plane + p] = d.y;
    diffuse[2 * plane + p] = d.z;
    specular[p] = 0.0f;
    specular[plane + p] = 0.0f;
    specular[2 * plane + p] = 0.0f;
    shadow[p] = 1.0f;
    shadow[plane + p] = 0.0f;
    shadow[2 * plane + p] = FP16_MAX;
  } else {
    color[p] = color[p] + delta.x;
    color[plane + p] = color[plane + p] + delta.y;
    color[2 * plane + p] = color[2 * plane + p] + delta.z;
    diffuse[p] = diffuse[p] + delta.x;
    diffuse[plane + p] = diffuse[plane + p] + delta.y;
    diffuse[2 * plane + p] = diffuse[2 * plane + p] + delta.z;
  }
}

}  // namespace

// K5: photons [offset, offset + n) of a `total`-photon batch, emitted from
// the lights and traced; ftab and itab: the tables of pack_scene (M material
// rows; only the analytic primitives are traced; itab[0] the light count).
// Writes store_pos/dir/color [n,3], store_power [n], store_mask [n] u8.
// Returns the launch's cudaError_t.
extern "C" int rtvs_photon_trace(const float* ftab, const int* itab, int S, int P, int B, int M,
                                 int L, int total, int offset, int n, float* store_pos,
                                 float* store_dir, float* store_color, float* store_power,
                                 uint8_t* store_mask, void* stream) {
  Cfg c = make_cfg(0, 0, S, P, B, L, 0, 0, 0, 0, 0, 0.0f);
  Scene sc = make_scene(ftab, S, P, B, M, L);
  int blocks = (n + PHOTON_THREADS - 1) / PHOTON_THREADS;
  if (blocks > 0)
    photon_trace_kernel<<<blocks, PHOTON_THREADS, 0, (cudaStream_t)stream>>>(
        c, sc, itab, total, offset, n, store_pos, store_dir, store_color, store_power,
        store_mask);
  return (int)cudaGetLastError();
}

// K6: the accumulator planes pos/nrm [3,H,W], hit/metal/trans [H,W]; the
// sorted photon map (pos/dir/col [n,3], pow [n], valid [n] u8, cell_start/
// cell_count [65536] int32, count/radius/intensity 0-d on the device). Adds
// the caustic times spp into color and diffuse [3,H,W] (the accumulator's
// planes) where the gather found weight; given replace (a photon debug
// mode), at every eligible pixel it instead sets color to color - primary +
// the caustic times spp times scale, primary and diffuse to that term,
// specular [3,H,W] to 0 and the shadow planes [3,H,W] (visibility,
// penumbra, distance) to 1, 0, FP16_MAX. Returns the launch's cudaError_t.
extern "C" int rtvs_photon_gather(int width, int height, const float* pos, const float* nrm,
                                  const float* hit, const float* metal, const float* trans,
                                  const float* ph_pos, const float* ph_dir, const float* ph_col,
                                  const float* ph_pow, const uint8_t* ph_valid, int n,
                                  const int* cell_start, const int* cell_count, const int* count,
                                  const float* radius, const float* intensity, float spp,
                                  int replace, float dbg_scale, float* color, float* primary,
                                  float* diffuse, float* specular, float* shadow, void* stream) {
  PhotonTable pt = {ph_pos, ph_dir, ph_col, ph_pow, ph_valid, cell_start, cell_count,
                    count, radius, intensity, n};
  dim3 block(GATHER_BX, GATHER_BY);
  dim3 grid((width + GATHER_BX - 1) / GATHER_BX, (height + GATHER_BY - 1) / GATHER_BY);
  if (replace)
    photon_gather_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        width, height, pos, nrm, hit, metal, trans, pt, spp, dbg_scale, color, primary, diffuse,
        specular, shadow);
  else
    photon_gather_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        width, height, pos, nrm, hit, metal, trans, pt, spp, dbg_scale, color, primary, diffuse,
        specular, shadow);
  return (int)cudaGetLastError();
}
