// The render kernels K1, K7 and K8 for Hopper (sm_90a), launched by the
// entry points of megakernel.cu and instantiated there, in
// megakernel_threaded.cu and, in their counting build, megakernel_count.cu.
// nvcc compiles each .cu on its own (no -rdc), so the device code lives in
// this header.
//
// K1 replaces the Pallas TPU kernel raytracevs_tpu/ops/pallas/megakernel.py::
// make_kernel (launched by _launch_megakernel): per pixel and per sample a
// blue-noise-jittered thin-lens primary ray, a DFS over an 8-deep LIFO work
// stack, the closest hit, shading with two dominant lights, soft and
// coloured shadows, thickness rays and sky, glass reflect/refract and metal
// children, and the 32 accumulator planes of megakernel.py:118-136. Its
// plain version is raytracevs_tpu_torch/ops/render.py::render_accum; this
// file follows it operation for operation (see common.cuh). The scene
// layout, the RNG, the mesh walks and the closest hit are in closest.cuh,
// which the photon trace K5 (photon.cu) shares. One thread per pixel in
// 16-wide blocks, samples loop inside the thread, the DFS stack is a
// per-thread local array; on the TPU the stack and the tile's rays were
// VMEM planes walked in lockstep.
//
// What bounds the analytic K1: per-thread chains of dependent float work
// (sqrt, sin/cos, tan, exp and divisions among them) and their latency,
// not bytes (the scene tables stay in L1; each pixel writes 32 floats).
// So the design buys warps to hide that latency: two 256-thread blocks an
// SM, which caps ptxas at 128 registers, with no spill. What made the body
// fit (PERF.md): the sums over samples and the depth-0 records go
// through to the planes as each sample makes them (Planes) instead of
// living in registers across the DFS; the shading call decides the
// continuation and pushes the sibling itself, so no child ray outlives it
// but those two; a WorkItem is 11 words (Item), its depth, flags, boost,
// skip-self and skip type packed in one; the shadow rays' disc basis is
// built for the light that needs it. The DFS loop keeps its warps' lanes
// busy (a SIMT share of 0.965 on the demo scene at spp 2, counted by the
// counting build), so lanes are not refilled across pixels.
//
// K1-mesh (MODE_MESH, rtvs_render_accum given meshes) adds the triangle
// meshes: the wide-node preorder walks of closest.cuh replace make_kernel's
// mesh walks and cover make_kernel(mesh_hbm=True), since every table is
// read from device memory whatever its size; a wide table deeper than the
// walks' stack takes the threaded walks instead (MODE_THREADED, built in
// megakernel_threaded.cu). What bounds K1-mesh: its 23M walks a 1080p frame
// of the mesh demo scene at spp 2 (70% of them shadow rays) and the kernel
// around them: one 256-thread block an SM (two spill around the walk
// calls, which save the caller's state) and divergence; the split into
// trace and shade kernels is the next step.
//
// K7 and K8, the two-phase renderer (spp 1), replace make_kernel(phase_a=
// True) and make_kernel_b of megakernel.py (render_accum_pallas_twophase),
// each instantiated without and with meshes. K1, K7 and K8 run the same
// per-iteration body (dfs_iteration: shade, records, continuation, stack).
// K7 is K1's kernel stopped after one iteration: the primary ray shaded,
// its records, and the continuation it spawned in 7 more planes. Between
// the two, torch sorts the continuations by direction octant and origin
// Morton code (ops/twophase.py). K8 runs one thread per sorted lane; it
// re-derives iteration 0 without lighting (the children only), resumes
// the DFS from iteration 1 and adds the subtree into its own pixel's
// planes. K7 also writes the primary ray's closest hit in 7 planes, which
// K8 reads instead of walking each resumed pixel's primary ray again (18%
// of its node fetches on the mesh demo scene, PERF.md). What bounds K7 and
// K8 is what bounds K1 and K1-mesh; K8 adds scattered reads of 7 and
// read-modify-writes of 5 floats a resumed pixel.
//
// The photon debug modes 3 and 4 (make_kernel's cfg.photon_debug_mode, the
// plain ops/wavefront.py::shade_and_spawn) come in the entries' flags word,
// bits 4-5, as Cfg::debug: at a depth-0 hit the colour and the diffuse
// record become the clipped transmission (mode 3) or metallic (mode 4) as
// grey and the specular record 0. A warp-uniform test of a parameter, so
// mode 0 keeps its instantiation and its registers (PERF.md, PR 9).
//
// MODE (closest.cuh): MODE_MESH the mesh walks, MODE_THREADED along the
// threaded links, MODE_COUNT the counting build, which adds the walks'
// node fetches, box and triangle tests by ray class and the DFS's
// iterations, shade calls, rays, hits and lit lights to Scene::counts
// (flush_tally); the pixels it renders are the plain instantiation's.
#pragma once

#include "common.cuh"
#include "closest.cuh"

// Threads a block of the render kernels (PERF.md: 128-thread blocks measured
// slower for K1, K7 and K8)
constexpr int RENDER_THREADS = 256;

namespace {

__device__ __forceinline__ float smoothstep(float e0, float e1_minus_e0, float x) {
  float t = clampn((x - e0) / e1_minus_e0, 0.0f, 1.0f);
  return t * t * (3.0f - 2.0f * t);
}
__device__ __forceinline__ V3 lerp3(V3 a, V3 b, float t) { return add(a, scale(sub(b, a), t)); }

// ---- sky, checker, BRDF (Common.hlsli:598-755, ClosestHit.hlsl:77-95) -------
__device__ V3 sky_color(V3 d) {
  V3 dn = normalize(d);
  float e = dn.y;
  float t = clampn(e, 0.0f, 1.0f);
  float tb = clampn(-e, 0.0f, 1.0f);
  V3 zenith = v3(F(0.15), F(0.35), F(0.75));
  V3 sky_mid = v3(F(0.35), F(0.55), F(0.90));
  V3 horizon = v3(F(0.70), F(0.80), F(0.95));
  V3 glow = v3(F(0.95), F(0.85), F(0.70));
  V3 ground = v3(F(0.25), F(0.28), F(0.35));
  float horizon_fade = smoothstep(0.0f, F(0.15 - 0.0), t);
  float zenith_fade = smoothstep(F(0.4), F(1.0 - 0.4), t);
  float glow_i = 1.0f - smoothstep(0.0f, F(0.08 - 0.0), t);
  V3 above = horizon;
  above = lerp3(above, glow, glow_i * F(0.4));
  above = lerp3(above, sky_mid, horizon_fade);
  above = lerp3(above, zenith, zenith_fade);
  float haze = expf(-t * 8.0f) * F(0.3);
  above = lerp3(above, horizon, haze);
  float ground_fade = smoothstep(0.0f, F(0.3 - 0.0), tb);
  V3 below = lerp3(horizon, ground, ground_fade);
  below = scale(below, F(0.8) + F(0.4 - 0.8) * ground_fade);
  return e >= 0.0f ? above : below;
}

__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}
__device__ __forceinline__ float fresnel_schlick(float cos_theta, float f0) {
  return f0 + (1.0f - f0) * pow5(1.0f - cos_theta);
}
__device__ __forceinline__ V3 fresnel_schlick3(float vdoth, V3 f0) {
  float p = pow5(clampn(1.0f - vdoth, 0.0f, 1.0f));
  return v3(f0.x + (1.0f - f0.x) * p, f0.y + (1.0f - f0.y) * p, f0.z + (1.0f - f0.z) * p);
}
__device__ __forceinline__ float ggx_d(float ndoth, float r) {
  float a = r * r;
  float a2 = a * a;
  float denom = ndoth * ndoth * (a2 - 1.0f) + 1.0f;
  return a2 / (F(3.14159265359) * denom * denom + F(1e-4));
}
__device__ __forceinline__ float smith_g1(float ndotv, float k) {
  return ndotv / (ndotv * (1.0f - k) + k);
}
__device__ __forceinline__ float smith_g(float ndotv, float ndotl, float roughness) {
  float r = roughness + 1.0f;
  float k = (r * r) / 8.0f;
  return smith_g1(ndotv, k) * smith_g1(ndotl, k);
}
__device__ __forceinline__ float attenuation(const Scene& sc, float dist) {
  return 1.0f / maxn(par(sc, P_ATTEN_C) + par(sc, P_ATTEN_L) * dist +
                         par(sc, P_ATTEN_Q) * dist * dist,
                     F(1e-4));
}

// shadow transmission along a segment (AnyHit_Shadow.hlsl:10-57), the mesh
// walk seeded blocked where an opaque analytic hit ended the search
template <int MODE>
__device__ void trace_shadow(const Cfg& c, const Scene& sc, V3 o, V3 d, float max_dist,
                             float& vis, V3& color, float& occ) {
  vis = 1.0f;
  color = v3(1.0f, 1.0f, 1.0f);
  occ = FP16_MAX;
  bool blocked = false;
  float scale_ab = par(sc, P_ABSORB_SCALE);
  int m = c.S + c.P + c.B;
  for (int g = 0; g < m; ++g) {
    float t;
    if (g < c.S) t = isect_sphere(o, d, RAY_TMIN, max_dist, sc.sph + SPH_W * g);
    else if (g < c.S + c.P) t = isect_plane(o, d, RAY_TMIN, max_dist, sc.pln + PLN_W * (g - c.S));
    else t = isect_box(o, d, RAY_TMIN, max_dist, sc.box + BOX_W * (g - c.S - c.P));
    if (!(t < F(1e30 * 0.5))) continue;
    const float* mt = sc.mat + MAT_W * g;
    float tr = __ldg(mt + 5);
    if (tr < F(0.01)) {
      blocked = true;
    } else {
      V3 ab = ld3(mt + 12);
      vis = vis * tr;
      if (ab.x > 0.0f || ab.y > 0.0f || ab.z > 0.0f) {
        V3 beer = v3(expf(-ab.x * F(1.0) * scale_ab), expf(-ab.y * F(1.0) * scale_ab),
                     expf(-ab.z * F(1.0) * scale_ab));
        color = mul(color, beer);
      }
    }
    occ = minn(occ, t);
  }
  if (blocked) {
    vis = 0.0f;
    color = v3(0.0f, 0.0f, 0.0f);
  }
  if constexpr ((MODE & MODE_MESH) != 0) {
    float mvis, mocc;
    V3 mcol;
    mesh_shadow<MODE>(sc.mesh, o, d, max_dist, blocked, mvis, mcol, mocc);
    vis = vis * mvis;
    color = mul(color, mcol);
    occ = minn(occ, mocc);
  }
}

// same-object thickness (RayGen.hlsl:646-672)
__device__ bool trace_thickness(const Cfg& c, const Scene& sc, V3 o, V3 d, int type, int index,
                                float& t_out) {
  float t = BIG;
  if (type == TYPE_SPHERE && c.S > 0) {
    int i = min(max(index, 0), c.S - 1);
    t = isect_sphere(o, d, RAY_TMIN, FP16_MAX, sc.sph + SPH_W * i);
  } else if (type == TYPE_BOX && c.B > 0) {
    int i = min(max(index, 0), c.B - 1);
    t = isect_box(o, d, RAY_TMIN, FP16_MAX, sc.box + BOX_W * i);
  }
  bool hit = t < F(1e30 * 0.5) && (type == TYPE_SPHERE || type == TYPE_BOX);
  t_out = hit ? t : FP16_MAX;
  return hit;
}

// ---- sampling (Common.hlsli:804-830, 1094-1099) -----------------------------
__device__ __forceinline__ void ortho_basis(V3 d, V3& t, V3& b) {
  V3 up = fabsf(d.y) < F(0.999) ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  t = normalize(cross(up, d));
  b = cross(d, t);
}

__device__ V3 perturb_reflection(V3 refl, V3 n, float roughness, uint32_t state) {
  state = pcg_hash(state);
  float r1 = u24f(state);
  state = pcg_hash(state);
  float r2 = u24f(state);
  V3 t0 = fabsf(n.x) > F(0.9) ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  V3 tangent = normalize(cross(n, t0));
  V3 bitangent = cross(n, tangent);
  float angle = r1 * F(6.28318);
  float radius = roughness * roughness * r2;
  float ca = cosf(angle), sa = sinf(angle);
  V3 offset = v3((ca * tangent.x + sa * bitangent.x) * radius,
                 (ca * tangent.y + sa * bitangent.y) * radius,
                 (ca * tangent.z + sa * bitangent.z) * radius);
  V3 pert = normalize(add(refl, offset));
  float pdn = dot(pert, n);
  V3 reflected = sub(pert, scale(n, 2.0f * pdn));
  pert = pdn < 0.0f ? reflected : pert;
  return roughness < F(0.01) ? refl : pert;
}

// ---- lights (Common.hlsli:982-1079, 1199-1357) ------------------------------
struct LightGeom {
  V3 l;
  float atten, ndotl;
};

__device__ LightGeom light_geom(const Scene& sc, V3 pos, V3 nrm, int lt, V3 lpos) {
  LightGeom g;
  bool is_dir = lt == LIGHT_DIRECTIONAL;
  V3 to_l = sub(lpos, pos);
  float dist = length(to_l);
  V3 ldn = divs(lpos, maxn(length(lpos), F(1e-12)));
  g.l = is_dir ? neg(ldn) : divs(to_l, maxn(dist, F(1e-12)));
  g.atten = is_dir ? 1.0f : attenuation(sc, dist);
  g.ndotl = maxn(dot(nrm, g.l), 0.0f);
  return g;
}

__device__ float estimate_light(const Scene& sc, V3 pos, V3 nrm, int li) {
  const float* lt = sc.lts + LT_W * li;
  V3 lpos = ld3(lt + 1);
  bool is_dir = (int)__ldg(lt) == LIGHT_DIRECTIONAL;
  V3 to_light = sub(lpos, pos);
  float dist = length(to_light);
  V3 l = is_dir ? normalize(neg(lpos)) : divs(to_light, maxn(dist, F(0.001)));
  float atten = is_dir ? 1.0f : attenuation(sc, dist);
  float ndotl = maxn(dot(nrm, l), 0.0f);
  float lum = __ldg(lt + 4) * F(0.2126) + __ldg(lt + 5) * F(0.7152) + __ldg(lt + 6) * F(0.0722);
  return ndotl * atten * __ldg(lt + 7) * lum;
}

struct Shadow {
  float vis, pen, occ;
  V3 color;
  int rays;
};

__device__ __forceinline__ float pen_local(float d_occ, float d_light, float light_size) {
  float size = light_size * d_occ / maxn(d_light - d_occ, F(1e-6));
  float radius = size * 0.5f;
  return d_occ >= FP16_MAX ? FP16_MAX : minn(radius, F(32768.0));
}
__device__ __forceinline__ float pen_directional(float d_occ, float tan_ang) {
  float radius = d_occ * tan_ang * 0.5f;
  return d_occ >= FP16_MAX ? FP16_MAX : minn(radius, F(32768.0));
}

template <int MODE>
__device__ Shadow soft_shadow(const Cfg& c, const Scene& sc, V3 pos, V3 nrm, bool active, int lt,
                              V3 lpos, float radius, float samples, uint32_t& seed) {
  Shadow r;
  r.vis = 1.0f;
  r.pen = 0.0f;
  r.occ = FP16_MAX;
  r.color = v3(1.0f, 1.0f, 1.0f);
  r.rays = 0;
  bool is_dir = lt == LIGHT_DIRECTIONAL;
  if (!active || lt == LIGHT_AMBIENT) return r;  // lit; no randoms drawn
  bool soft = radius > F(0.001);
  V3 origin = add(pos, scale(nrm, F(0.001)));
  V3 dir_point = sub(lpos, pos);
  float dist_point = length(dir_point);
  V3 l_point = divs(dir_point, maxn(dist_point, F(1e-12)));
  V3 l_dir = normalize(neg(lpos));
  V3 hard_dir = is_dir ? l_dir : l_point;
  float hard_dist = is_dir ? F(10000.0) : dist_point;
  int num_samples = min(max((int)samples, 1), 16);
  float light_size = radius * 2.0f;
  float tan_ang = tanf(radius);
  // the sample disc's basis: around the light direction, or around the
  // direction to the point light (the plain version builds both and picks)
  V3 t_b, b_b;
  ortho_basis(is_dir ? l_dir : normalize(dir_point), t_b, b_b);

  float vis_sum = 0.0f, pen_sum = 0.0f, min_occ = FP16_MAX;
  int occluded = 0, valid = 0;
  V3 color_sum = v3(0.0f, 0.0f, 0.0f);
  for (int s = 0; s < c.max_soft; ++s) {
    bool iter_soft = soft && s < num_samples;
    bool iter_hard = !soft && s == 0;
    if (!iter_soft && !iter_hard) continue;
    V3 trace_dir = hard_dir;
    float trace_max = hard_dist;
    bool above = false;
    if (iter_soft) {
      seed = pcg_hash(seed);
      float u1 = u24f(seed);
      seed = pcg_hash(seed);
      float u2 = u24f(seed);
      float rr = sqrtf(u1);
      float theta = u2 * F(6.28318530718);
      float dx = rr * cosf(theta), dy = rr * sinf(theta);
      V3 samp_dir;
      float samp_max;
      V3 off = v3((t_b.x * dx + b_b.x * dy) * radius, (t_b.y * dx + b_b.y * dy) * radius,
                  (t_b.z * dx + b_b.z * dy) * radius);
      if (is_dir) {
        samp_dir = normalize(add(l_dir, off));
        samp_max = F(10000.0);
      } else {
        V3 samp_vec = sub(add(lpos, off), pos);
        float samp_dist = length(samp_vec);
        samp_dir = divs(samp_vec, maxn(samp_dist, F(1e-12)));
        samp_max = samp_dist;
      }
      trace_dir = samp_dir;
      trace_max = samp_max;
      above = dot(samp_dir, nrm) > 0.0f;
      if (!above) continue;
    }
    float sv, so;
    V3 scol;
    trace_shadow<MODE>(c, sc, origin, trace_dir, trace_max, sv, scol, so);
    r.rays += 1;
    if (iter_hard) {
      r.vis = sv;
      r.color = scol;
      if (sv < F(0.99)) r.occ = so;
    } else {
      vis_sum = vis_sum + sv;
      color_sum = add(color_sum, scale(scol, sv));
      valid += 1;
      if (sv < F(0.99)) {
        occluded += 1;
        min_occ = minn(min_occ, so);
        pen_sum = pen_sum + (is_dir ? pen_directional(so, tan_ang)
                                    : pen_local(so, dist_point, light_size));
      }
    }
  }
  if (soft) {
    r.vis = valid > 0 ? vis_sum / (float)max(valid, 1) : 1.0f;
    r.occ = occluded > 0 ? min_occ : FP16_MAX;
    r.pen = occluded > 0 ? pen_sum / (float)max(occluded, 1) : 0.0f;
    r.color = vis_sum > F(0.01) ? divs(color_sum, maxn(vis_sum, F(1e-12))) : v3(0.0f, 0.0f, 0.0f);
  }
  return r;
}

__device__ __forceinline__ int shadow_samples(float base_samples, int t0i, float t0c, int t1i,
                                              float t1c, int li) {
  int base = min(max((int)base_samples, 1), 16);
  float ratio = t1c / maxn(t0c, F(0.001));
  int reduced = max((int)((float)base * ratio), 1);
  int secondary = min(reduced, base / 2 + 1);
  return t0i == li ? base : (t1i == li ? secondary : 1);
}

__device__ __forceinline__ void brdf_terms(V3 nrm, V3 view, V3 l, float ndotl, V3 f0,
                                           float roughness, float metallic, V3 dc, V3& diff,
                                           V3& spec) {
  V3 half = normalize(add(view, l));
  float ndotv = maxn(dot(nrm, view), F(0.001));
  float ndoth = maxn(dot(nrm, half), 0.0f);
  float vdoth = maxn(dot(view, half), 0.0f);
  V3 fr = fresnel_schlick3(vdoth, f0);
  float d = ggx_d(ndoth, maxn(roughness, F(0.04)));
  float g = smith_g(ndotv, ndotl, roughness);
  float den = 4.0f * ndotv * ndotl + F(0.001);
  float dg = d * g;
  spec = v3(dg * fr.x / den, dg * fr.y / den, dg * fr.z / den);
  float om = 1.0f - metallic;
  diff = v3((1.0f - fr.x) * om * dc.x / F(3.14159265359),
            (1.0f - fr.y) * om * dc.y / F(3.14159265359),
            (1.0f - fr.z) * om * dc.z / F(3.14159265359));
}

// ---- the DFS, shared by K1, K7 and K8 ---------------------------------------
// Accumulator planes of a pixel (ops/render.py::CH_*)
constexpr int CH_COLOR = 0, CH_PRIMARY = 3, CH_DIFFUSE = 6, CH_SPECULAR = 9, CH_HITDIST = 12,
              CH_BOUNCE = 13, CH_RAYS = 14, CH_PRIM_HIT = 15, CH_NORMAL = 16, CH_ROUGH = 19,
              CH_ALBEDO = 20, CH_METALLIC = 23, CH_TRANSMISSION = 24, CH_POS = 25,
              CH_SHADOW_VIS = 28, CH_SHADOW_PEN = 29, CH_SHADOW_DIST = 30, CH_OBJ_ID = 31,
              CH_SPAWN = 32, CH_HIT = 39;

// One pixel's planes. The sums over samples and the depth-0 records go
// through to them as each sample makes them, instead of living in
// registers across the pixel's DFS: the thread owns its pixel, and each
// plane takes the plain version's float additions in its order (the first
// sample adds to 0, later ones to what the plane holds).
struct Planes {
  float* o;
  int plane;
  __device__ __forceinline__ float get(int ch) const { return o[ch * plane]; }
  __device__ __forceinline__ void set(int ch, float v) const { o[ch * plane] = v; }
  __device__ __forceinline__ void add(int ch, float v, bool first) const {
    set(ch, (first ? 0.0f : get(ch)) + v);
  }
  __device__ __forceinline__ void add3(int ch, V3 v, bool first) const {
    add(ch, v.x, first);
    add(ch + 1, v.y, first);
    add(ch + 2, v.z, first);
  }
  __device__ __forceinline__ void set3(int ch, V3 v) const {
    set(ch, v.x);
    set(ch + 1, v.y);
    set(ch + 2, v.z);
  }
};

// the primary record of a pixel whose samples all miss (RayGen.hlsl:560-589)
__device__ __forceinline__ void record_no_primary(const Planes& px) {
  px.set(CH_PRIM_HIT, 0.0f);
  px.set3(CH_NORMAL, v3(0.0f, 1.0f, 0.0f));
  px.set(CH_ROUGH, 1.0f);
  px.set3(CH_ALBEDO, v3(0.0f, 0.0f, 0.0f));
  px.set(CH_METALLIC, 0.0f);
  px.set(CH_TRANSMISSION, 0.0f);
  px.set3(CH_POS, v3(0.0f, 0.0f, 0.0f));
  px.set(CH_OBJ_ID, -1.0f);
}

// a sample's depth-0 records: the radiance records summed over samples,
// SIGMA's shadow record from the first sample
__device__ __forceinline__ void record(const Planes& px, bool first, V3 diffuse, V3 specular,
                                       float hitdist, float svis, float spen, float sdist) {
  px.add3(CH_DIFFUSE, diffuse, first);
  px.add3(CH_SPECULAR, specular, first);
  px.add(CH_HITDIST, hitdist, first);
  if (first) {
    px.set(CH_SHADOW_VIS, svis);
    px.set(CH_SHADOW_PEN, spen);
    px.set(CH_SHADOW_DIST, sdist);
  }
}

// The counting build's tally of a thread's DFS (MODE_COUNT), added to the
// "dfs", "rays" and "hits" rows of Scene::counts once at its end
// (flush_tally; ops/render.py::COUNT_ROWS).
struct Tally {
  uint32_t lane_iters, warp_iters, capped, killed;  // warp_iters: x 32
  uint32_t shade0, shade1, shadow, thick;           // shade calls at depth 0 and >= 1
  uint32_t misses, glass, opaque, lit;              // lit: lights shaded by the BRDF
};
constexpr int TALLY_WORDS = 12;

__device__ __forceinline__ uint32_t lane_id() {
  uint32_t l;
  asm("mov.u32 %0, %%laneid;" : "=r"(l));
  return l;
}

template <int MODE>
__device__ __forceinline__ void flush_tally(const Scene& sc, const Tally& t) {
  if constexpr ((MODE & MODE_COUNT) != 0) {
    uint32_t v[TALLY_WORDS] = {t.lane_iters, t.warp_iters, t.capped, t.killed,
                               t.shade0,     t.shade1,     t.shadow, t.thick,
                               t.misses,     t.glass,      t.opaque, t.lit};
    // an atomic a word a thread: a warp-wide sum would need the warp's
    // lanes converged here, which nothing guarantees after the DFS
#pragma unroll
    for (int k = 0; k < TALLY_WORDS; ++k)
      if (v[k]) atomicAdd(sc.counts + 16 + k, (unsigned long long)v[k]);
  }
}

// A DFS WorkItem (Common.hlsli:194-212) in 11 words: origin, direction,
// throughput, then `meta` = depth | flags << 16 | boost code << 18 |
// skip-self << 20 | skip type << 21, and `aux`: the skip index of an item
// that skips itself, else its pending mesh thickness (instance + 1, 0 for
// none; only a refract child has one, and it never skips itself).
constexpr int BOOST_ONE = 0, BOOST_GLASS = 1, BOOST_METAL = 2;  // 1, 1.2, 1.1
__device__ __forceinline__ int item_meta(int depth, int flags, int boost, bool skip, int stype) {
  return depth | flags << 16 | boost << 18 | (skip ? 1 : 0) << 20 | (skip ? stype : 0) << 21;
}
struct Item {
  V3 o, d, tp;
  int meta, aux;
  __device__ __forceinline__ int depth() const { return meta & 0xFFFF; }
  __device__ __forceinline__ int flags() const { return (meta >> 16) & 3; }
  __device__ __forceinline__ float boost() const {
    int b = (meta >> 18) & 3;
    return b == BOOST_ONE ? 1.0f : (b == BOOST_GLASS ? F(1.2) : F(1.1));
  }
  __device__ __forceinline__ bool skip() const { return (meta >> 20) & 1; }
  __device__ __forceinline__ int skip_type() const { return skip() ? (meta >> 21) & 7 : INVALID; }
  __device__ __forceinline__ int skip_index() const { return skip() ? aux : 0; }
  __device__ __forceinline__ int thick_inst() const { return skip() ? -1 : aux - 1; }
};

// One sample's DFS state besides its stack: the current WorkItem, whether
// there is one, the stack's entry count, and the sample's running sums.
struct Path {
  Item cur;
  bool valid;
  int count;
  V3 color;
  int bounce, rays;
};

// The 8-deep LIFO of deferred siblings, in local memory (only a glass
// hit's reflect child waits on it).
struct Stack {
  float f[STACK_DEPTH][9];
  int i[STACK_DEPTH][2];
  __device__ __forceinline__ void push(int k, const Item& r) {
    float* e = f[k];
    e[0] = r.o.x; e[1] = r.o.y; e[2] = r.o.z;
    e[3] = r.d.x; e[4] = r.d.y; e[5] = r.d.z;
    e[6] = r.tp.x; e[7] = r.tp.y; e[8] = r.tp.z;
    i[k][0] = r.meta;
    i[k][1] = r.aux;
  }
  __device__ __forceinline__ void pop(int k, Item& r) const {
    const float* e = f[k];
    r.o = v3(e[0], e[1], e[2]);
    r.d = v3(e[3], e[4], e[5]);
    r.tp = v3(e[6], e[7], e[8]);
    r.meta = i[k][0];
    r.aux = i[k][1];
  }
};

// ---- one WorkItem: trace, shade, records, children (RayGen.hlsl:174-848) ----
// Traces and shades p.cur: its radiance into p.color and p.rays and, at
// depth 0, its records into the pixel's planes; then decides its
// continuation (RayGen.hlsl:697-846: refract > unpushed reflect > metal),
// which replaces p.cur, and pushes the reflect child when the refract child
// continues (against the full STACK_DEPTH capacity). Returns whether there
// is a continuation. So no child ray outlives this call but the one that
// continues and the one pushed. SHADE=false computes the children alone:
// no lighting, radiance, records or rays (phase B's re-derivation of
// iteration 0, megakernel.py::_children_only_k; ops/wavefront.py::
// children_only), from the closest hit `given` that phase A traced. The
// children are the same bit for bit: the hit, material, RNG and spawn
// arithmetic is shared. `hit`, when given, gets the traced closest hit.
template <int MODE, bool SHADE = true>
__device__ bool shade_and_spawn(const Cfg& c, const Scene& sc, uint32_t px, uint32_t py, int s,
                                Path& p, Stack& st, const Planes& pl, bool& prim_hit, Tally& tl,
                                Hit* hit = nullptr, const Hit* given = nullptr) {
  const Item& ray = p.cur;  // read until the continuation replaces it
  int skip_t = ray.skip_type(), skip_i = ray.skip_index();
  // a refract child tagged with its mesh instance resolves its mesh-glass
  // thickness in this closest walk; the Beer factor the reference applied
  // at spawn multiplies the throughput here and the colour at the end
  // (ops/wavefront.py::shade_and_spawn)
  int thick_inst = ray.thick_inst();
  Hit h;
  if constexpr (SHADE)
    h = trace_closest<MODE>(c, sc, ray.o, ray.d, skip_t, skip_i, thick_inst,
                            ray.depth() == 0 ? WC_PRIMARY : WC_SECONDARY);
  else
    h = *given;
  if (hit) *hit = h;
  V3 tp = ray.tp;
  V3 beer = v3(1.0f, 1.0f, 1.0f);
  bool fused = (MODE & MODE_MESH) != 0 && c.any_absorption;
  if (fused) {
    float t_th = (thick_inst >= 0 && h.thick_hit) ? h.thick_t : 0.0f;
    float tscale = t_th * F(0.6);
    V3 ab = ld3(sc.mesh.inst_tbl + 8 * min(max(thick_inst, 0), sc.mesh.num_inst - 1) + 1);
    if (t_th > 0.0f)
      beer = v3(expf(-ab.x * tscale), expf(-ab.y * tscale), expf(-ab.z * tscale));
    tp = mul(tp, beer);
  }
  bool depth0 = ray.depth() == 0, first = s == 0;
  if constexpr (SHADE) {
    if constexpr ((MODE & MODE_COUNT) != 0) {
      if (depth0) tl.shade0 += 1;
      else tl.shade1 += 1;
    }
  }
  if (!h.hit) {
    if constexpr (SHADE) {
      if constexpr ((MODE & MODE_COUNT) != 0) tl.misses += 1;
      V3 sky = sky_color(ray.d);
      V3 col = scale(sky, ray.boost());
      if (!finite3(col)) col = mul(tp, sky);
      if (fused) col = mul(col, beer);
      V3 contrib = mul(ray.tp, col);
      p.color = add(p.color, contrib);
      p.rays += 1;
      if (depth0) {
        pl.add3(CH_PRIMARY, add(v3(0.0f, 0.0f, 0.0f), contrib), first);
        record(pl, first, scale(sky, ray.boost()), v3(0.0f, 0.0f, 0.0f), F(10000.0), 1.0f, 0.0f,
               FP16_MAX);
        if (first) record_no_primary(pl);
      }
    }
    return false;
  }
  V3 pos = add(ray.o, scale(ray.d, h.t));
  V3 n;
  bool front;
  if (h.type == TYPE_SPHERE) {
    n = normalize(sub(pos, ld3(sc.sph + SPH_W * min(max(h.index, 0), c.S - 1))));
  } else if (h.type == TYPE_PLANE) {
    n = normalize(ld3(sc.pln + PLN_W * min(max(h.index, 0), c.P - 1) + 3));
  } else if ((MODE & MODE_MESH) == 0 || h.type == TYPE_BOX) {
    n = box_face_normal(pos, sc.box + BOX_W * min(max(h.index, 0), c.B - 1));
  }
  V3 nrm;
  if ((MODE & MODE_MESH) != 0 && h.type == TYPE_MESH) {
    // barycentric smooth normal; the geometric normal decides the face
    // (ClosestHit_Triangle.hlsl:14-136, ops/bvh.py::shading_normal)
    int ti = h.tri;
    float w = 1.0f - h.u - h.v;
    V3 a = ld3(sc.mesh.n0 + 3 * ti), b = ld3(sc.mesh.n1 + 3 * ti), cc = ld3(sc.mesh.n2 + 3 * ti);
    V3 sm = normalize(v3(a.x * w + b.x * h.u + cc.x * h.v, a.y * w + b.y * h.u + cc.y * h.v,
                         a.z * w + b.z * h.u + cc.z * h.v));
    V3 geo = normalize(cross(ld3(sc.mesh.e1 + 3 * ti), ld3(sc.mesh.e2 + 3 * ti)));
    front = dot(ray.d, geo) < 0.0f;
    nrm = front ? sm : neg(sm);
  } else {
    front = dot(ray.d, n) < 0.0f;
    nrm = front ? n : neg(n);
  }

  // material fetch (ClosestHit.hlsl:54-125); emission and absorption are
  // read where they are used
  const float* mt = sc.mat + MAT_W * h.slot;
  V3 albedo = ld3(mt);
  float metallic = __ldg(mt + 3), roughness = __ldg(mt + 4), transmission = __ldg(mt + 5);
  float ior = __ldg(mt + 6), specular = __ldg(mt + 7);
  if (h.type == TYPE_PLANE) {
    V3 cam_pos = par3(sc, P_CAMPOS), cam_fwd = par3(sc, P_FWD);
    float vz = maxn(dot(sub(pos, cam_pos), cam_fwd), 0.0f);
    float fade = expf(-vz / F(50.0));
    float contrast = F(0.3) + F(1.0 - 0.3) * fade;
    int ix = (int)floorf(pos.x), iy = (int)floorf(pos.z);
    float checker = (float)((ix + iy) & 1);
    float value = 0.5f + (checker - 0.5f) * contrast;
    float span = F(0.9) - F(0.1);
    albedo = v3(F(0.1) + span * value, F(0.1) + span * value, F(0.1) + span * value);
    transmission = 0.0f;
    ior = F(1.5);
  }
  bool is_glass = transmission > F(0.01);
  uint32_t sample_rng = (uint32_t)s + (uint32_t)ray.depth() * 4096u;
  int shadow_rays = 0;
  if constexpr (SHADE) {
    if constexpr ((MODE & MODE_COUNT) != 0) {
      if (is_glass) tl.glass += 1;
      else tl.opaque += 1;
    }
    V3 view = neg(ray.d);
    float spec_blend = clampn(specular, 0.0f, 1.0f);
    V3 highlight = v3(0.0f, 0.0f, 0.0f);
    if (is_glass && c.any_glass && c.has_lights) {
      // glass: specular highlights only (RayGen.hlsl:283-334)
      float f0_from_ior = (ior - 1.0f) / (ior + 1.0f);
      f0_from_ior = f0_from_ior * f0_from_ior;
      float f0_glass = f0_from_ior + (spec_blend - f0_from_ior) * spec_blend;
      for (int li = 0; li < c.L; ++li) {
        const float* lt = sc.lts + LT_W * li;
        int type = (int)__ldg(lt);
        bool lv = li < sc.num_lights && __ldg(lt + 10) > 0.5f;
        LightGeom g = light_geom(sc, pos, nrm, type, ld3(lt + 1));
        if (!(lv && type != LIGHT_AMBIENT && g.ndotl > 0.0f)) continue;
        V3 half = normalize(add(g.l, view));
        float shininess = maxn(F(512.0) * (1.0f - roughness), F(64.0));
        float spec = powf(maxn(dot(nrm, half), 0.0f), shininess);
        float sf = fresnel_schlick(maxn(dot(half, view), 0.0f), f0_glass);
        float k = __ldg(lt + 7) * spec * sf * g.atten;
        highlight = add(highlight, v3(__ldg(lt + 4) * k, __ldg(lt + 5) * k, __ldg(lt + 6) * k));
      }
      highlight = scale(highlight, spec_blend * (1.0f - roughness));
      if (!(specular > F(0.01))) highlight = v3(0.0f, 0.0f, 0.0f);
    }

    // non-glass: PBR direct lighting (RayGen.hlsl:336-539)
    V3 ambient = v3(0.0f, 0.0f, 0.0f), ddiff = ambient, dspec = ambient;
    float best_vis = 1.0f, best_pen = 0.0f, best_dist = FP16_MAX;
    if (!is_glass && c.has_lights) {
      uint32_t seed = rng_init(px, py, sc.frame, sample_rng, SALT_SHADOW);
      int max_shadow = min(sc.max_shadow_lights, 2);
      if (max_shadow == 0) max_shadow = 2;
      int t0i = 0, t1i = 0, count = 0;
      float t0c = -1.0f, t1c = -1.0f;
      int lcap8 = min(c.L, 8);
      for (int li = 0; li < lcap8; ++li) {
        const float* lt = sc.lts + LT_W * li;
        bool in_range = li < sc.num_lights && __ldg(lt + 10) > 0.5f;
        bool skip = (int)__ldg(lt) == LIGHT_AMBIENT || !in_range;
        float contrib = estimate_light(sc, pos, nrm, li);
        bool beats0 = !skip && contrib > t0c;
        bool beats1 = !skip && !beats0 && contrib > t1c && max_shadow > 1;
        if (beats0) { t1i = t0i; t1c = t0c; t0i = li; t0c = contrib; }
        else if (beats1) { t1i = li; t1c = contrib; }
        if (beats0 || beats1) count = min(count + 1, max_shadow);
      }
      bool sel0 = count > 0 && t0c > 0.0f;
      bool sel1 = count > 1 && t1c > 0.0f;
      int a_idx = (sel0 && sel1) ? min(t0i, t1i) : (sel0 ? t0i : t1i);
      int b_idx = (sel0 && sel1) ? max(t0i, t1i) : a_idx;
      bool a_sel = sel0 || sel1, b_sel = sel0 && sel1;
      Shadow res[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        int idx = w == 0 ? a_idx : b_idx;
        bool selm = w == 0 ? a_sel : b_sel;
        const float* lt = sc.lts + LT_W * idx;
        int type = (int)__ldg(lt);
        V3 lpos = ld3(lt + 1);
        LightGeom g = light_geom(sc, pos, nrm, type, lpos);
        int samples = shadow_samples(__ldg(lt + 9), t0i, t0c, t1i, t1c, idx);
        bool active = selm && g.ndotl > 0.0f;
        res[w] = soft_shadow<MODE>(c, sc, pos, nrm, active, type, lpos, __ldg(lt + 8),
                                   (float)samples, seed);
        if (active) shadow_rays += res[w].rays;
      }
      V3 dc = scale(albedo, 1.0f - metallic);
      V3 f0 = v3(F(0.04) + (albedo.x - F(0.04)) * metallic,
                 F(0.04) + (albedo.y - F(0.04)) * metallic,
                 F(0.04) + (albedo.z - F(0.04)) * metallic);
      float best_w = -1.0f;
      float strength = par(sc, P_SHADOW_STRENGTH);
      for (int li = 0; li < c.L; ++li) {
        const float* lt = sc.lts + LT_W * li;
        int type = (int)__ldg(lt);
        bool lv = li < sc.num_lights && __ldg(lt + 10) > 0.5f;
        LightGeom g = light_geom(sc, pos, nrm, type, ld3(lt + 1));
        bool is_amb = type == LIGHT_AMBIENT;
        V3 lcol = ld3(lt + 4);
        float lint = __ldg(lt + 7);
        if (lv && is_amb) {
          V3 lc = scale(lcol, lint);
          V3 base = v3(dc.x + (albedo.x * F(0.3) - dc.x) * metallic,
                       dc.y + (albedo.y * F(0.3) - dc.y) * metallic,
                       dc.z + (albedo.z * F(0.3) - dc.z) * metallic);
          ambient = add(ambient, mul(lc, base));
        }
        bool lit = lv && !is_amb && g.ndotl > 0.0f;
        if (!lit) continue;
        if constexpr ((MODE & MODE_COUNT) != 0) tl.lit += 1;
        bool use_a = a_idx == li && a_sel, use_b = b_idx == li && b_sel;
        const Shadow& rs = res[use_a ? 0 : 1];
        bool use = use_a || use_b;
        float vis = use ? rs.vis : 1.0f;
        V3 scol = use ? rs.color : v3(1.0f, 1.0f, 1.0f);
        float w = g.ndotl * g.atten * lint;
        if (depth0 && w > best_w) {
          best_w = w;
          best_vis = vis;
          best_pen = use ? rs.pen : 0.0f;
          best_dist = use ? rs.occ : FP16_MAX;
        }
        float adj_vis = 1.0f - clampn((1.0f - vis) * strength, 0.0f, 1.0f);
        float k = lint * g.atten * adj_vis;
        V3 radiance = v3(lcol.x * k * scol.x, lcol.y * k * scol.y, lcol.z * k * scol.z);
        V3 db, sb;
        brdf_terms(nrm, view, g.l, g.ndotl, f0, roughness, metallic, dc, db, sb);
        ddiff = add(ddiff, scale(mul(db, radiance), g.ndotl));
        dspec = add(dspec, scale(mul(sb, radiance), g.ndotl));
      }
    } else if (!is_glass && depth0) {
      // no-light fallback (RayGen.hlsl:452-501): legacy point light + flat
      // ambient, only at depth 0
      V3 to_l = sub(v3(3.0f, 5.0f, -3.0f), pos);
      float fb_dist = length(to_l);
      V3 fb_l = divs(to_l, maxn(fb_dist, F(1e-12)));
      float fb_atten = attenuation(sc, fb_dist);
      float fb_ndotl = maxn(dot(nrm, fb_l), 0.0f);
      float fb_vis, fb_occ;
      V3 fb_scol;
      trace_shadow<MODE>(c, sc, add(pos, scale(nrm, F(0.001))), fb_l, fb_dist, fb_vis, fb_scol,
                         fb_occ);
      shadow_rays += 1;
      V3 dc = scale(albedo, 1.0f - metallic);
      V3 f0 = v3(F(0.04) + (albedo.x - F(0.04)) * metallic,
                 F(0.04) + (albedo.y - F(0.04)) * metallic,
                 F(0.04) + (albedo.z - F(0.04)) * metallic);
      float fb_amount = clampn((1.0f - fb_vis) * par(sc, P_SHADOW_STRENGTH), 0.0f, 1.0f);
      float k = F(1.5) * fb_atten * (1.0f - fb_amount);
      V3 fb_rad = v3(k * fb_scol.x, k * fb_scol.y, k * fb_scol.z);
      if (fb_ndotl > 0.0f) {
        if constexpr ((MODE & MODE_COUNT) != 0) tl.lit += 1;
        V3 db, sb;
        brdf_terms(nrm, view, fb_l, fb_ndotl, f0, roughness, metallic, dc, db, sb);
        ddiff = scale(mul(db, fb_rad), fb_ndotl);
        dspec = scale(mul(sb, fb_rad), fb_ndotl);
      }
      ambient = scale(v3(dc.x + (albedo.x * F(0.3) - dc.x) * metallic,
                         dc.y + (albedo.y * F(0.3) - dc.y) * metallic,
                         dc.z + (albedo.z * F(0.3) - dc.z) * metallic),
                      F(0.2));
      best_vis = fb_vis;
      best_dist = fb_vis < F(0.99) ? fb_occ : FP16_MAX;
    }

    V3 emission = ld3(mt + 9);
    float reflection_weight = metallic * (1.0f - roughness * 0.5f);
    float direct_weight = 1.0f - reflection_weight * 0.5f;
    V3 diff_lit = add(ambient, scale(ddiff, direct_weight));
    V3 col = is_glass ? add(highlight, emission)
                      : clamp3(add(add(diff_lit, dspec), emission), 0.0f, INFINITY);
    // photon debug modes 3/4 (ClosestHit.hlsl:141-157): transmission or
    // metallic as grey at depth-0 hits, also as the diffuse record, with no
    // specular record; deeper bounces still contribute
    bool dbg = depth0 && c.debug != 0;
    if (dbg) {
      float v = clampn(c.debug == 1 ? transmission : metallic, 0.0f, 1.0f);
      col = v3(v, v, v);
    }
    if (!finite3(col)) col = mul(tp, sky_color(ray.d));  // NaN/Inf guard (RayGen.hlsl:250-260)
    if (fused) col = mul(col, beer);
    V3 contrib = mul(ray.tp, col);
    p.color = add(p.color, contrib);
    if (depth0) {
      // depth-0 records (RayGen.hlsl:560-589): each sample records once;
      // SIGMA takes the first sample's, the primary record the first hit
      pl.add3(CH_PRIMARY, add(v3(0.0f, 0.0f, 0.0f), contrib), first);
      record(pl, first, dbg ? col : (is_glass ? v3(0.0f, 0.0f, 0.0f) : add(diff_lit, emission)),
             dbg ? v3(0.0f, 0.0f, 0.0f) : (is_glass ? highlight : dspec), h.t, is_glass ? 1.0f : best_vis,
             is_glass ? 0.0f : best_pen, is_glass ? FP16_MAX : best_dist);
      if (!prim_hit) {
        prim_hit = true;
        pl.set(CH_PRIM_HIT, 1.0f);
        pl.set3(CH_NORMAL, nrm);
        pl.set(CH_ROUGH, roughness);
        pl.set3(CH_ALBEDO, albedo);
        pl.set(CH_METALLIC, metallic);
        pl.set(CH_TRANSMISSION, transmission);
        pl.set3(CH_POS, pos);
        pl.set(CH_OBJ_ID, (float)(h.type * 65536 + h.index));
      }
    }
  }

  // ---- children and the continuation (RayGen.hlsl:591-847) ----
  int next_depth = ray.depth() + 1;
  int spec_flags = ray.flags() | PATH_FLAG_SPECULAR;
  int thick_rays = 0;
  bool cont = false;
  if (c.any_glass && is_glass) {
    float f0_from_ior = (ior - 1.0f) / (ior + 1.0f);
    f0_from_ior = f0_from_ior * f0_from_ior;
    float spec_blend = clampn(specular, 0.0f, 1.0f);
    float f0_glass = f0_from_ior + (spec_blend - f0_from_ior) * spec_blend;
    float eta = front ? 1.0f / ior : ior;
    V3 reflect0 = normalize(sub(ray.d, scale(nrm, 2.0f * dot(ray.d, nrm))));
    float cosi = dot(nrm, ray.d);
    float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
    bool tir = k < 0.0f;
    float kk = sqrtf(maxn(k, 0.0f));
    float m = eta * cosi + kk;
    V3 refract_dir = v3(eta * ray.d.x - m * nrm.x, eta * ray.d.y - m * nrm.y,
                        eta * ray.d.z - m * nrm.z);
    refract_dir = tir ? v3(0.0f, 0.0f, 0.0f) : normalize(refract_dir);
    V3 g_reflect = reflect0, g_refract = refract_dir;
    if (roughness > F(0.01) && depth0) {
      // roughness perturbation at depth 0 (RayGen.hlsl:613-623)
      g_reflect = perturb_reflection(reflect0, nrm, roughness,
                                     rng_init(px, py, sc.frame, sample_rng, SALT_REFLECT));
      if (!tir)
        g_refract = perturb_reflection(refract_dir, neg(nrm), roughness,
                                       rng_init(px, py, sc.frame, sample_rng, SALT_REFRACT));
    }
    float cos_theta = clampn(dot(neg(ray.d), nrm), 0.0f, 1.0f);
    float fresnel = tir ? 1.0f : fresnel_schlick(cos_theta, f0_glass);
    float rtp = clampn(fresnel, 0.0f, 1.0f);
    V3 tint = front ? v3(1.0f + (albedo.x - 1.0f) * F(0.85), 1.0f + (albedo.y - 1.0f) * F(0.85),
                         1.0f + (albedo.z - 1.0f) * F(0.85))
                    : v3(1.0f, 1.0f, 1.0f);
    float ft = (1.0f - fresnel) * clampn(transmission, 0.0f, 1.0f);
    V3 refract_tp = clamp3(v3(ft * tint.x, ft * tint.y, ft * tint.z), 0.0f, 1.0f);
    V3 absorb = v3(1.0f, 1.0f, 1.0f);
    int thick_tag = 0;  // the refract child's pending mesh thickness: instance + 1
    if (c.any_absorption && !tir) {
      // thickness ray for Beer-Lambert absorption (RayGen.hlsl:646-678);
      // on a mesh it finds nothing here: the refract child's closest walk
      // resolves it (tagged)
      V3 absorption = ld3(mt + 12);
      if ((MODE & MODE_MESH) != 0 && h.type == TYPE_MESH &&
          (absorption.x > 0.0f || absorption.y > 0.0f || absorption.z > 0.0f))
        thick_tag = h.index + 1;
      float th_t;
      bool th_hit = trace_thickness(c, sc, add(pos, scale(g_refract, F(0.002))), g_refract,
                                    h.type, h.index, th_t);
      thick_rays += 1;
      float thickness = th_hit ? th_t : 0.0f;
      if (thickness > 0.0f) {
        float ts = thickness * F(0.6);
        absorb = v3(expf(-absorption.x * ts), expf(-absorption.y * ts), expf(-absorption.z * ts));
      }
    }
    V3 reflect_tp = v3(rtp * tp.x, rtp * tp.y, rtp * tp.z);
    bool push_reflect = p.count < STACK_DEPTH;
    bool refract_ok = !tir && p.count + (push_reflect ? 1 : 0) < STACK_DEPTH;
    Item refl;
    refl.o = add(pos, scale(nrm, F(0.002)));
    refl.d = g_reflect;
    refl.tp = reflect_tp;
    refl.meta = item_meta(next_depth, spec_flags, BOOST_GLASS, true, h.type);
    refl.aux = h.index;
    if (push_reflect && refract_ok) {
      st.push(p.count, refl);
      p.count += 1;
    }
    if (refract_ok) {
      V3 next_tp = mul(mul(refract_tp, absorb), tp);
      int flags = front ? (spec_flags | PATH_FLAG_INSIDE) : (spec_flags & ~PATH_FLAG_INSIDE);
      p.cur.o = add(pos, scale(g_refract, F(0.002)));
      p.cur.d = g_refract;
      p.cur.tp = next_tp;
      p.cur.meta = item_meta(next_depth, flags, BOOST_GLASS, false, 0);
      p.cur.aux = thick_tag;
      cont = true;
    } else if (push_reflect) {
      p.cur = refl;
      cont = true;
    }
  } else if (c.any_metal && !is_glass && metallic > F(0.1)) {
    // metal child (RayGen.hlsl:806-846)
    V3 reflect_m = sub(ray.d, scale(nrm, 2.0f * dot(ray.d, nrm)));
    V3 metal_dir = perturb_reflection(reflect_m, nrm, roughness,
                                      rng_init(px, py, sc.frame, sample_rng, SALT_REFLECT));
    float ndotv_m = clampn(dot(nrm, neg(ray.d)), 0.0f, 1.0f);
    V3 f0 = v3(F(0.04) + (albedo.x - F(0.04)) * metallic,
               F(0.04) + (albedo.y - F(0.04)) * metallic,
               F(0.04) + (albedo.z - F(0.04)) * metallic);
    V3 f_metal = fresnel_schlick3(ndotv_m, f0);
    float reflect_scale = 1.0f - roughness * 0.5f;
    float boost = ray.depth() > 0 ? F(1.5) : 1.0f;
    V3 metal_tp = mul(scale(f_metal, reflect_scale * boost), tp);
    bool inside = (spec_flags & PATH_FLAG_INSIDE) != 0;
    p.cur.o = add(pos, scale(nrm, F(0.002)));
    p.cur.d = metal_dir;
    p.cur.tp = metal_tp;
    p.cur.meta = item_meta(next_depth, spec_flags, BOOST_METAL, !inside, h.type);
    p.cur.aux = inside ? 0 : h.index;
    cont = true;
  }
  if constexpr (SHADE) {
    p.rays += 1 + shadow_rays + thick_rays;
    if constexpr ((MODE & MODE_COUNT) != 0) {
      tl.shadow += shadow_rays;
      tl.thick += thick_rays;
    }
  }
  return cont;
}

// sample s's primary ray (RayGen.hlsl:107-172): blue-noise AA + thin-lens
// DoF, offsets 0.5 at spp 1; a fresh path
__device__ __forceinline__ void start_path(const Cfg& c, const Scene& sc, uint32_t px,
                                           uint32_t py, int s, Path& p) {
  V3 cam_pos = par3(sc, P_CAMPOS), fwd = par3(sc, P_FWD), right = par3(sc, P_RIGHT),
     up = par3(sc, P_UP);
  float tanfov = par(sc, P_TANFOV), aperture = par(sc, P_APERTURE);
  uint32_t bx = (px + sc.frame * 3u + (uint32_t)s * 11u) & 15u;
  uint32_t by = (py + sc.frame * 5u + (uint32_t)s * 7u) & 15u;
  const float* bn = sc.bn + (by * 16u + bx) * 4u;
  float offx = c.spp > 1 ? __ldg(bn) : 0.5f;
  float offy = c.spp > 1 ? __ldg(bn + 1) : 0.5f;
  float ndc_x = ((float)px + offx) / (float)c.width * 2.0f - 1.0f;
  float ndc_y = -(((float)py + offy) / (float)c.height * 2.0f - 1.0f);
  float kx = ndc_x * tanfov * c.aspect, ky = ndc_y * tanfov;
  V3 d = normalize(v3(fwd.x + right.x * kx + up.x * ky, fwd.y + right.y * kx + up.y * ky,
                      fwd.z + right.z * kx + up.z * ky));
  V3 o = cam_pos;
  if (aperture > F(0.001)) {
    V3 focus = add(cam_pos, scale(d, par(sc, P_FOCUS)));
    float r = sqrtf(__ldg(bn + 2));
    float theta = __ldg(bn + 3) * F(6.28318530718);
    float disk_x = r * cosf(theta) * aperture, disk_y = r * sinf(theta) * aperture;
    o = add(add(cam_pos, scale(right, disk_x)), scale(up, disk_y));
    d = normalize(sub(focus, o));
  }
  p.cur.o = o;
  p.cur.d = d;
  p.cur.tp = v3(1.0f, 1.0f, 1.0f);
  p.cur.meta = item_meta(0, 0, BOOST_ONE, false, 0);
  p.cur.aux = 0;
  p.valid = true;
  p.count = 0;
  p.color = v3(0.0f, 0.0f, 0.0f);
  p.bounce = p.rays = 0;
}

// the next WorkItem: the continuation (already in p.cur), else the
// deferred sibling popped, else none
__device__ __forceinline__ void next_item(Path& p, bool has_cont, const Stack& st) {
  if (has_cont) {
    p.valid = true;
  } else if (p.count > 0) {
    p.count -= 1;
    st.pop(p.count, p.cur);
    p.valid = true;
  } else {
    p.valid = false;
  }
}

// one DFS iteration of sample s (RayGen.hlsl:174-846) on a current
// WorkItem: capped at the depth limit, killed by its throughput, or traced
// and shaded; then the next WorkItem. `hit`, when given, gets the traced
// WorkItem's closest hit.
template <int MODE>
__device__ __forceinline__ void dfs_iteration(const Cfg& c, const Scene& sc, uint32_t px,
                                              uint32_t py, int s, Path& p, Stack& st,
                                              const Planes& pl, bool& prim_hit, Tally& tl,
                                              Hit* hit = nullptr) {
  if constexpr ((MODE & MODE_COUNT) != 0) {
    // the loop's SIMT share: lane iterations against the warp's
    uint32_t active = __activemask();
    tl.lane_iters += 1;
    if (lane_id() == (uint32_t)(__ffs(active) - 1)) tl.warp_iters += 32;
  }
  int depth = p.cur.depth();
  p.bounce = max(p.bounce, depth + 1);
  bool has_cont = false;
  if (depth >= c.max_bounces) {
    // depth cap -> sky fallback without boost (RayGen.hlsl:184-193)
    V3 cap = mul(p.cur.tp, sky_color(p.cur.d));
    p.color = add(p.color, cap);
    if (depth == 0) pl.add3(CH_PRIMARY, add(v3(0.0f, 0.0f, 0.0f), cap), s == 0);
    if constexpr ((MODE & MODE_COUNT) != 0) tl.capped += 1;
  } else if (!(maxn(maxn(p.cur.tp.x, p.cur.tp.y), p.cur.tp.z) < F(0.01) &&
               (p.cur.flags() & PATH_FLAG_SPECULAR) == 0)) {
    has_cont = shade_and_spawn<MODE>(c, sc, px, py, s, p, st, pl, prim_hit, tl, hit);
  } else if constexpr ((MODE & MODE_COUNT) != 0) {
    tl.killed += 1;
  }
  next_item(p, has_cont, st);
}

// a sample's sums into the pixel's planes (after its DFS)
__device__ __forceinline__ void finish_sample(const Planes& pl, bool first, const Path& p) {
  pl.add3(CH_COLOR, p.color, first);
  pl.add(CH_BOUNCE, (float)p.bounce, first);
  pl.add(CH_RAYS, (float)p.rays, first);
}

// Blocks an SM each render kernel asks ptxas to fit (__launch_bounds__'
// second argument, which caps its registers at 65536 / (RENDER_THREADS x
// blocks)), each the shape measured fastest (PERF.md): K1-mesh and the
// mesh K8 one, whose mesh walks spill at two; K1, K7 and the analytic K8
// two (K1 at two: 0.76x its time at one, 0.89x at three).
constexpr int MESH_BLOCKS = 1, SLIM_BLOCKS = 2;

// ---- K1 and K7: one thread per pixel ----------------------------------------
// PHASE_A (K7, spp 1): exactly one iteration, then the continuation it
// spawned in 7 more planes (megakernel.py:2557-2564), then the primary ray's
// closest hit in 7 more (ops/render.py::CH_HIT: hit, t, type, index and
// triangle as int bits, u, v; no hit where the primary is not traced).
// BAND: the launch renders the row band c.row0, c.rows of a frame whose
// planes pass the 32-bit plane index, into the band's planes; a whole
// frame's launch runs the instantiation without it, whose code is the
// whole frame's alone (ptxas gave the mesh instantiations 4 more
// registers or spill bytes when one body served both, PERF.md).
template <int MODE, bool PHASE_A, bool BAND>
__global__ void __launch_bounds__(RENDER_THREADS,
                                  (MODE & MODE_MESH) != 0 && !PHASE_A ? MESH_BLOCKS : SLIM_BLOCKS)
    render_accum_kernel(Cfg c, Scene sc, const int* __restrict__ itab, float* __restrict__ out) {
  // y: the row in the launch's planes; the pixel's row in the frame is py
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= c.width || y >= (BAND ? c.rows : c.height)) return;
  // scene scalars stay on the device: no host sync to launch
  sc.num_lights = __ldg(itab);
  sc.max_shadow_lights = __ldg(itab + 1);
  sc.frame = (uint32_t)__ldg(itab + 2);
  uint32_t px = (uint32_t)x, py = BAND ? (uint32_t)(c.row0 + y) : (uint32_t)y;
  Planes pl = {out + (size_t)y * c.width + x, (BAND ? c.rows : c.height) * c.width};
  Tally tl = {};
  bool prim_hit = false;
  Path p;
  Stack st;
  int max_iters = PHASE_A ? 1 : c.max_iters;
  Hit prim;
  prim.hit = false;
  prim.t = BIG;
  prim.type = INVALID;
  prim.index = prim.tri = 0;
  prim.u = prim.v = 0.0f;
  for (int s = 0; s < c.spp; ++s) {
    start_path(c, sc, px, py, s, p);
    for (int it = 0; it < max_iters && p.valid; ++it)
      dfs_iteration<MODE>(c, sc, px, py, s, p, st, pl, prim_hit, tl, PHASE_A ? &prim : nullptr);
    finish_sample(pl, s == 0, p);
  }
  if (c.max_bounces <= 0 || max_iters <= 0) {
    // every primary was capped, or no iteration ran: no sample recorded
    if (max_iters <= 0) pl.set3(CH_PRIMARY, v3(0.0f, 0.0f, 0.0f));
    record(pl, true, v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f), 0.0f, 1.0f, 0.0f, FP16_MAX);
    record_no_primary(pl);
  }
  if constexpr (PHASE_A) {
    // no continuation: origin 0 and direction +z, as the plain version's
    pl.set(CH_SPAWN, p.valid ? 1.0f : 0.0f);
    pl.set3(CH_SPAWN + 1, p.valid ? p.cur.o : v3(0.0f, 0.0f, 0.0f));
    pl.set3(CH_SPAWN + 4, p.valid ? p.cur.d : v3(0.0f, 0.0f, 1.0f));
    pl.set(CH_HIT, prim.hit ? 1.0f : 0.0f);
    pl.set(CH_HIT + 1, prim.t);
    pl.set(CH_HIT + 2, __int_as_float(prim.type));
    pl.set(CH_HIT + 3, __int_as_float(prim.index));
    pl.set(CH_HIT + 4, __int_as_float(prim.tri));
    pl.set(CH_HIT + 5, prim.u);
    pl.set(CH_HIT + 6, prim.v);
  }
  flush_tally<MODE>(sc, tl);
}

// the material row of a hit (trace_closest's slot)
__device__ __forceinline__ int hit_slot(const Cfg& c, int type, int index) {
  int base = type == TYPE_SPHERE ? 0
           : type == TYPE_PLANE  ? c.S
           : type == TYPE_BOX    ? c.S + c.P
           : type == TYPE_MESH   ? c.S + c.P + c.B
                                 : -1;
  return base < 0 ? 0 : base + index;
}

// ---- K8: one thread per sorted continuation ---------------------------------
// Lane i resumes pixel order[i] for i < *count (the count stays on the
// device). It re-derives the pixel's iteration-0 state without lighting
// (the same primary ray, children, continuation and stack as K7's one
// iteration) from the closest hit K7 traced (`hits`, K7's 7 hit planes),
// so it walks no primary ray again; it runs the DFS from iteration 1 and
// folds the subtree into the pixel's accumulator planes: colour +=, rays
// +=, bounce = max. Pixel ids are unique, so the read-modify-write needs
// no atomics.
template <int MODE>
__global__ void __launch_bounds__(RENDER_THREADS,
                                  (MODE & MODE_MESH) != 0 ? MESH_BLOCKS : SLIM_BLOCKS)
    render_phase_b_kernel(Cfg c, Scene sc, const int* __restrict__ itab,
                          const int* __restrict__ order, const int* __restrict__ count,
                          const float* __restrict__ hits, int lanes, float* __restrict__ acc) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes || lane >= __ldg(count)) return;
  int pix = __ldg(order + lane);
  sc.num_lights = __ldg(itab);
  sc.max_shadow_lights = __ldg(itab + 1);
  sc.frame = (uint32_t)__ldg(itab + 2);
  uint32_t px = (uint32_t)(pix % c.width), py = (uint32_t)(c.row0 + pix / c.width);

  // the subtree is at depth >= 1: it records nothing, so it has no planes
  Planes none = {nullptr, 0};
  Tally tl = {};
  bool prim_hit = true;
  Path p;
  Stack st;
  start_path(c, sc, px, py, 0, p);
  size_t plane = (size_t)c.rows * c.width;
  const float* hp = hits + pix;
  Hit h;
  h.hit = __ldg(hp) > 0.5f;
  h.t = __ldg(hp + plane);
  h.type = __float_as_int(__ldg(hp + 2 * plane));
  h.index = __float_as_int(__ldg(hp + 3 * plane));
  h.tri = __float_as_int(__ldg(hp + 4 * plane));
  h.u = __ldg(hp + 5 * plane);
  h.v = __ldg(hp + 6 * plane);
  h.slot = hit_slot(c, h.type, h.index);
  h.thick_hit = false;  // a primary ray asks no thickness query
  h.thick_t = BIG;
  bool has_cont = shade_and_spawn<MODE, false>(c, sc, px, py, 0, p, st, none, prim_hit, tl,
                                               nullptr, &h);
  next_item(p, has_cont, st);
  for (int it = 1; it < c.max_iters && p.valid; ++it)
    dfs_iteration<MODE>(c, sc, px, py, 0, p, st, none, prim_hit, tl);

  float* a = acc + pix;
  a[0] = a[0] + p.color.x;
  a[plane] = a[plane] + p.color.y;
  a[2 * plane] = a[2 * plane] + p.color.z;
  a[13 * plane] = maxn(a[13 * plane], (float)p.bounce);
  a[14 * plane] = a[14 * plane] + (float)p.rays;
  flush_tally<MODE>(sc, tl);
}

template <int MODE, bool PHASE_A>
int launch_accum(const Cfg& c, const Scene& sc, const int* itab, float* out, void* stream) {
  constexpr int rows = RENDER_THREADS / 16;
  dim3 block(16, rows);
  dim3 grid((c.width + 15) / 16, (c.rows + rows - 1) / rows);
  if (c.row0 != 0 || c.rows != c.height)
    render_accum_kernel<MODE, PHASE_A, true><<<grid, block, 0, (cudaStream_t)stream>>>(c, sc, itab,
                                                                                         out);
  else
    render_accum_kernel<MODE, PHASE_A, false><<<grid, block, 0, (cudaStream_t)stream>>>(c, sc, itab,
                                                                                          out);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_phase_b(const Cfg& c, const Scene& sc, const int* itab, const int* order,
                   const int* count, const float* hits, int lanes, float* acc, void* stream) {
  if (lanes <= 0) return 0;
  constexpr int threads = RENDER_THREADS;
  render_phase_b_kernel<MODE><<<(lanes + threads - 1) / threads, threads, 0,
                                (cudaStream_t)stream>>>(c, sc, itab, order, count, hits, lanes,
                                                        acc);
  return (int)cudaGetLastError();
}

// The scene of an entry point: ftab's tables and the mesh tables of
// ops/cuda/megakernel.py::pack_tables (nodes: wide [W,32], or for the
// threaded instantiations fine [Nn,8]; plane [T,12]; n0/n1/n2/e1/e2 [T,3];
// inst [T] int32; inst_tbl [I,8]), the material table holding S+P+B+I
// rows; without meshes every mesh pointer null and T = I = Nn = 0. counts:
// the counting build's [COUNT_ROWS][4] counts, or null.
Scene make_mesh_scene(const float* ftab, int S, int P, int B, int L, const float* nodes,
                      const float* plane, const float* n0, const float* n1, const float* n2,
                      const float* e1, const float* e2, const int* inst, const float* inst_tbl,
                      int num_tris, int num_inst, int num_nodes, unsigned long long* counts) {
  Scene sc = make_scene(ftab, S, P, B, S + P + B + num_inst > 0 ? S + P + B + num_inst : 1, L);
  sc.counts = counts;
  sc.mesh.nodes = reinterpret_cast<const float4*>(nodes);
  sc.mesh.plane = reinterpret_cast<const float4*>(plane);
  sc.mesh.n0 = n0;
  sc.mesh.n1 = n1;
  sc.mesh.n2 = n2;
  sc.mesh.e1 = e1;
  sc.mesh.e2 = e2;
  sc.mesh.inst = inst;
  sc.mesh.inst_tbl = inst_tbl;
  sc.mesh.counts = counts;
  sc.mesh.num_tris = num_tris;
  sc.mesh.num_inst = num_inst;
  sc.mesh.num_nodes = num_nodes;
  return sc;
}

}  // namespace

// The entry points' arguments (megakernel.cu documents them): K1's and
// K7's, K8's, and the mesh tables as make_mesh_scene takes them.
#define ACCUM_PARAMS                                                                        \
  const float *ftab, const int *itab, float *out, int width, int height, int row0, int rows, \
      int S, int P, int B, int L, int spp, int max_bounces, int max_iters, int max_soft,      \
      int flags, float aspect
#define ACCUM_ARGS                                                                          \
  ftab, itab, out, width, height, row0, rows, S, P, B, L, spp, max_bounces, max_iters, max_soft, \
      flags, aspect
#define PHASE_B_PARAMS                                                                         \
  const float *ftab, const int *itab, const int *order, const int *count, float *acc,           \
      const float *hits, int lanes, int width, int height, int row0, int rows, int S, int P,    \
      int B, int L, int spp, int max_bounces, int max_iters, int max_soft, int flags, float aspect
#define PHASE_B_ARGS                                                                            \
  ftab, itab, order, count, acc, hits, lanes, width, height, row0, rows, S, P, B, L, spp,        \
      max_bounces, max_iters, max_soft, flags, aspect
// The configuration of an entry point, from its ACCUM_PARAMS or PHASE_B_PARAMS
#define ENTRY_CFG                                                                              \
  band_cfg(make_cfg(width, height, S, P, B, L, spp, max_bounces, max_iters, max_soft, flags,  \
                    aspect),                                                                   \
           row0, rows)
#define MESH_PARAMS                                                                    \
  const float *nodes, const float *plane, const float *n0, const float *n1,           \
      const float *n2, const float *e1, const float *e2, const int *inst,             \
      const float *inst_tbl, int num_tris, int num_inst, int num_nodes
#define MESH_ARGS nodes, plane, n0, n1, n2, e1, e2, inst, inst_tbl, num_tris, num_inst, num_nodes

namespace {
// K1 (K7 given phase_a), and K8, in the instantiation MODE, on an entry's
// arguments
template <int MODE>
int accum_as(bool phase_a, ACCUM_PARAMS, MESH_PARAMS, unsigned long long* counts, void* stream) {
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  return phase_a ? launch_accum<MODE, true>(c, sc, itab, out, stream)
                 : launch_accum<MODE, false>(c, sc, itab, out, stream);
}

template <int MODE>
int phase_b_as(PHASE_B_PARAMS, MESH_PARAMS, unsigned long long* counts, void* stream) {
  Cfg c = ENTRY_CFG;
  Scene sc = make_mesh_scene(ftab, S, P, B, L, MESH_ARGS, counts);
  return launch_phase_b<MODE>(c, sc, itab, order, count, hits, lanes, acc, stream);
}
}  // namespace

// The instantiations that the entries of megakernel.cu reach in the other
// files, so that nvcc compiles them beside it: the counting build
// (megakernel_count.cu; MODE_COUNT, with MODE_MESH given nodes) and the
// threaded walks' (megakernel_threaded.cu; MODE_MESH | MODE_THREADED, with
// MODE_COUNT given counts). K1, or K7 given phase_a, and K8.
int render_accum_count(bool phase_a, ACCUM_PARAMS, MESH_PARAMS, unsigned long long* counts,
                       void* stream);
int render_phase_b_count(PHASE_B_PARAMS, MESH_PARAMS, unsigned long long* counts, void* stream);
int render_accum_threaded(bool phase_a, ACCUM_PARAMS, MESH_PARAMS, unsigned long long* counts,
                          void* stream);
int render_phase_b_threaded(PHASE_B_PARAMS, MESH_PARAMS, unsigned long long* counts,
                            void* stream);
