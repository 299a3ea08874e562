// K1: the render megakernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel raytracevs_tpu/ops/pallas/megakernel.py::
// make_kernel (launched by _launch_megakernel), analytic part: per pixel and
// per sample a blue-noise-jittered thin-lens primary ray, a DFS over an
// 8-deep LIFO work stack, the closest analytic hit, shading with two
// dominant lights, soft and coloured shadows, thickness rays and sky, glass
// reflect/refract and metal children, and the 32 accumulator planes of
// megakernel.py:118-136. The plain version is
// raytracevs_tpu_torch/ops/render.py::render_accum; this file follows it
// operation for operation (see common.cuh).
//
// What bounds it on the H100: per-thread control flow and latency, not
// bytes. The scene tables are a few hundred floats read through __ldg (they
// stay in L1); each pixel writes 32 floats once. The per-thread ray state
// and the 8-deep stack (8 x 15 words) live in registers and local memory,
// so register pressure and local-memory spills are the cost (see the
// -Xptxas -v report the build writes), plus warp divergence between sky
// pixels that retire after one ray and glass pixels that run the stack deep.
//
// Design: one thread per pixel in 16x16 blocks (the ragged edge is masked),
// samples loop inside the thread, the stack is a per-thread local array.
// On the TPU the stack and the tile's rays were VMEM planes walked in
// lockstep; here each thread retires on its own. Divergence is left as is.

#include "common.cuh"

namespace {

constexpr int STACK_DEPTH = 8;
constexpr int INVALID = 0x7FFFFFFF;
constexpr int TYPE_SPHERE = 0, TYPE_PLANE = 1, TYPE_BOX = 2;
constexpr int LIGHT_AMBIENT = 0, LIGHT_DIRECTIONAL = 2;
constexpr int PATH_FLAG_INSIDE = 1, PATH_FLAG_SPECULAR = 2, RAYFLAG_SKIP_SELF = 1;
constexpr uint32_t SALT_SHADOW = 6, SALT_REFLECT = 7, SALT_REFRACT = 8;
constexpr float BIG = 1e30f;
#define RAY_TMIN F(0.001)
#define RAY_TMAX F(10000.0)
#define FP16_MAX F(65504.0)

// Table strides (floats per row), shared with ops/cuda/megakernel.py::pack_scene
constexpr int SPH_W = 5, PLN_W = 7, BOX_W = 16, MAT_W = 16, LT_W = 12;
// param slots
constexpr int P_CAMPOS = 0, P_FWD = 3, P_RIGHT = 6, P_UP = 9, P_TANFOV = 12, P_APERTURE = 13,
              P_FOCUS = 14, P_SHADOW_STRENGTH = 15, P_ABSORB_SCALE = 16, P_ATTEN_C = 17,
              P_ATTEN_L = 18, P_ATTEN_Q = 19;

struct Cfg {
  int width, height;
  int S, P, B, L;
  int spp, max_bounces, max_iters, max_soft;
  bool has_lights, any_glass, any_metal, any_absorption;
  float aspect;
};

struct Scene {
  const float *sph, *pln, *box, *mat, *lts, *par, *bn;
  int num_lights, max_shadow_lights;
  uint32_t frame;
};

struct Ray {
  V3 o, d, tp;
  float boost;
  int depth, flags, rflags, stype, sidx;
};

struct Hit {
  bool hit;
  float t;
  int type, index, slot;
};

__device__ __forceinline__ float par(const Scene& sc, int i) { return __ldg(sc.par + i); }
__device__ __forceinline__ V3 par3(const Scene& sc, int i) { return ld3(sc.par + i); }

// ---- RNG (Common.hlsli:761-797) ---------------------------------------------
__device__ __forceinline__ uint32_t pcg_hash(uint32_t v) {
  v = v * 747796405u + 2891336453u;
  uint32_t word = ((v >> ((v >> 28u) + 4u)) ^ v) * 277803737u;
  return (word >> 22u) ^ word;
}
__device__ __forceinline__ uint32_t rng_init(uint32_t px, uint32_t py, uint32_t frame,
                                             uint32_t sample, uint32_t salt) {
  return pcg_hash(px * 1973u + py * 9277u + frame * 26699u + sample * 31837u + salt * 911u);
}
__device__ __forceinline__ float u24f(uint32_t s) {
  return (float)(s >> 8) * F(1.0 / 16777216.0);
}

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

// ---- intersection (Intersection.hlsl:17-198) --------------------------------
__device__ float isect_sphere(V3 o, V3 d, float tmin, float tmax, const float* s) {
  V3 oc = sub(o, ld3(s));
  float r = __ldg(s + 3);
  float a = dot(d, d);
  float b = 2.0f * dot(oc, d);
  float c = dot(oc, oc) - r * r;
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(maxn(disc, 0.0f));
  float t1 = (-b - sq) / (2.0f * a);
  float t2 = (-b + sq) / (2.0f * a);
  float t = t1 < tmin ? t2 : t1;
  bool ok = disc >= 0.0f && t >= tmin && t <= tmax && __ldg(s + 4) > 0.5f;
  return ok ? t : BIG;
}

__device__ float isect_plane(V3 o, V3 d, float tmin, float tmax, const float* p) {
  V3 n = normalize(ld3(p + 3));
  float denom = dot(d, n);
  V3 p0 = sub(ld3(p), o);
  bool big = fabsf(denom) > F(1e-4);
  float t = dot(p0, n) / (big ? denom : 1.0f);
  bool ok = big && t >= tmin && t <= tmax && __ldg(p + 6) > 0.5f;
  return ok ? t : BIG;
}

__device__ float isect_box(V3 o, V3 d, float tmin, float tmax, const float* b) {
  V3 delta = sub(o, ld3(b));
  float h[3] = {__ldg(b + 3), __ldg(b + 4), __ldg(b + 5)};
  float t_near = 0.0f, t_far = 0.0f;
  bool par_miss = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    V3 ax = ld3(b + 6 + 3 * k);
    float lo = dot(delta, ax);
    float ld = dot(d, ax);
    bool par = fabsf(ld) < F(1e-6);
    par_miss = par_miss || (par && (lo < -h[k] || lo > h[k]));
    float inv = 1.0f / (par ? 1.0f : ld);
    float t0 = par ? F(-1e20) : (-h[k] - lo) * inv;
    float t1 = par ? F(1e20) : (h[k] - lo) * inv;
    float smin = minn(t0, t1), smax = maxn(t0, t1);
    t_near = k == 0 ? smin : maxn(t_near, smin);
    t_far = k == 0 ? smax : minn(t_far, smax);
  }
  bool hit_any = t_near <= t_far && t_far >= tmin && !par_miss;
  float t = t_near >= tmin ? t_near : t_far;
  bool ok = hit_any && t >= tmin && t <= tmax && __ldg(b + 15) > 0.5f;
  return ok ? t : BIG;
}

// closest hit over spheres ++ planes ++ boxes; ties keep the first primitive
__device__ Hit trace_closest(const Cfg& c, const Scene& sc, V3 o, V3 d, int skip_type,
                             int skip_index) {
  float best_t = BIG;
  int best = 0, g = 0;
  for (int i = 0; i < c.S; ++i, ++g) {
    float t = isect_sphere(o, d, RAY_TMIN, RAY_TMAX, sc.sph + SPH_W * i);
    if (skip_type == TYPE_SPHERE && skip_index == i) t = BIG;
    if (t < best_t) { best_t = t; best = g; }
  }
  for (int i = 0; i < c.P; ++i, ++g) {
    float t = isect_plane(o, d, RAY_TMIN, RAY_TMAX, sc.pln + PLN_W * i);
    if (skip_type == TYPE_PLANE && skip_index == i) t = BIG;
    if (t < best_t) { best_t = t; best = g; }
  }
  for (int i = 0; i < c.B; ++i, ++g) {
    float t = isect_box(o, d, RAY_TMIN, RAY_TMAX, sc.box + BOX_W * i);
    if (skip_type == TYPE_BOX && skip_index == i) t = BIG;
    if (t < best_t) { best_t = t; best = g; }
  }
  Hit h;
  h.hit = best_t < F(1e30 * 0.5);
  h.t = best_t;
  h.slot = best;
  if (best >= c.S + c.P) { h.type = TYPE_BOX; h.index = best - c.S - c.P; }
  else if (best >= c.S) { h.type = TYPE_PLANE; h.index = best - c.S; }
  else { h.type = TYPE_SPHERE; h.index = best; }
  if (!h.hit) h.type = INVALID;
  return h;
}

__device__ V3 box_face_normal(V3 pos, const float* b) {
  V3 c = ld3(b);
  float h[3] = {maxn(__ldg(b + 3), F(1e-4)), maxn(__ldg(b + 4), F(1e-4)),
                maxn(__ldg(b + 5), F(1e-4))};
  V3 axn[3];
  float local[3], scaled[3], sgn[3];
  V3 rel = sub(pos, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    axn[k] = normalize(ld3(b + 6 + 3 * k));
    local[k] = dot(rel, axn[k]);
    scaled[k] = fabsf(local[k] / h[k]);
    sgn[k] = local[k] >= 0.0f ? 1.0f : -1.0f;
  }
  bool x_wins = scaled[0] >= scaled[1] && scaled[0] >= scaled[2];
  bool y_wins = !x_wins && scaled[1] >= scaled[2];
  float l0 = x_wins ? sgn[0] : 0.0f;
  float l1 = y_wins ? sgn[1] : 0.0f;
  float l2 = (!x_wins && !y_wins) ? sgn[2] : 0.0f;
  V3 world = add(add(scale(axn[0], l0), scale(axn[1], l1)), scale(axn[2], l2));
  return normalize(world);
}

// shadow transmission along a segment (AnyHit_Shadow.hlsl:10-57)
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
  V3 t_p, b_p, t_d, b_d;
  ortho_basis(normalize(dir_point), t_p, b_p);
  ortho_basis(l_dir, t_d, b_d);

  float vis_sum = 0.0f, pen_sum = 0.0f, min_occ = FP16_MAX;
  int occluded = 0, valid = 0;
  V3 color_sum = v3(0.0f, 0.0f, 0.0f);
  float vis_h = 1.0f, occ_h = FP16_MAX;
  V3 color_h = v3(1.0f, 1.0f, 1.0f);
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
      if (is_dir) {
        V3 off = v3((t_d.x * dx + b_d.x * dy) * radius, (t_d.y * dx + b_d.y * dy) * radius,
                    (t_d.z * dx + b_d.z * dy) * radius);
        samp_dir = normalize(add(l_dir, off));
        samp_max = F(10000.0);
      } else {
        V3 off = v3((t_p.x * dx + b_p.x * dy) * radius, (t_p.y * dx + b_p.y * dy) * radius,
                    (t_p.z * dx + b_p.z * dy) * radius);
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
    trace_shadow(c, sc, origin, trace_dir, trace_max, sv, scol, so);
    r.rays += 1;
    if (iter_hard) {
      vis_h = sv;
      color_h = scol;
      if (sv < F(0.99)) occ_h = so;
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
  } else {
    r.vis = vis_h;
    r.occ = occ_h;
    r.pen = 0.0f;
    r.color = color_h;
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

// ---- one WorkItem: trace, shade, records, children (RayGen.hlsl:174-848) ----
struct Shaded {
  V3 color, diffuse, specular;
  float hit_distance, svis, spen, sdist;
  bool hit;
  V3 normal, albedo, pos;
  float roughness, metallic, transmission;
  int obj_id, rays;
  // children
  bool glass_spawn, metal_spawn, tir, entering;
  V3 reflect_dir, refract_dir, metal_dir, reflect_tp, refract_tp, metal_tp;
  int hit_type, hit_index;
};

__device__ void shade_and_spawn(const Cfg& c, const Scene& sc, uint32_t px, uint32_t py,
                                uint32_t sample, const Ray& ray, Shaded& out) {
  int skip_t = (ray.rflags & RAYFLAG_SKIP_SELF) ? ray.stype : INVALID;
  int skip_i = (ray.rflags & RAYFLAG_SKIP_SELF) ? ray.sidx : 0;
  Hit h = trace_closest(c, sc, ray.o, ray.d, skip_t, skip_i);
  out.hit = h.hit;
  out.rays = 0;
  out.glass_spawn = out.metal_spawn = out.tir = false;
  out.hit_type = h.type;
  out.hit_index = h.index;
  if (!h.hit) {
    V3 sky = sky_color(ray.d);
    V3 col = scale(sky, ray.boost);
    if (!finite3(col)) col = mul(ray.tp, sky);
    out.color = col;
    out.diffuse = scale(sky, ray.boost);
    out.specular = v3(0.0f, 0.0f, 0.0f);
    out.hit_distance = F(10000.0);
    out.svis = 1.0f;
    out.spen = 0.0f;
    out.sdist = FP16_MAX;
    out.obj_id = -1;
    return;
  }
  V3 pos = add(ray.o, scale(ray.d, h.t));
  V3 n;
  if (h.type == TYPE_SPHERE) {
    n = normalize(sub(pos, ld3(sc.sph + SPH_W * min(max(h.index, 0), c.S - 1))));
  } else if (h.type == TYPE_PLANE) {
    n = normalize(ld3(sc.pln + PLN_W * min(max(h.index, 0), c.P - 1) + 3));
  } else {
    n = box_face_normal(pos, sc.box + BOX_W * min(max(h.index, 0), c.B - 1));
  }
  bool front = dot(ray.d, n) < 0.0f;
  V3 nrm = front ? n : neg(n);

  // material fetch (ClosestHit.hlsl:54-125)
  const float* mt = sc.mat + MAT_W * h.slot;
  V3 albedo = ld3(mt);
  float metallic = __ldg(mt + 3), roughness = __ldg(mt + 4), transmission = __ldg(mt + 5);
  float ior = __ldg(mt + 6), specular = __ldg(mt + 7);
  V3 emission = ld3(mt + 9), absorption = ld3(mt + 12);
  V3 cam_pos = par3(sc, P_CAMPOS), cam_fwd = par3(sc, P_FWD);
  if (h.type == TYPE_PLANE) {
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
  V3 view = neg(ray.d);
  bool is_glass = transmission > F(0.01);

  float f0_from_ior = (ior - 1.0f) / (ior + 1.0f);
  f0_from_ior = f0_from_ior * f0_from_ior;
  float spec_blend = clampn(specular, 0.0f, 1.0f);
  float f0_glass = f0_from_ior + (spec_blend - f0_from_ior) * spec_blend;
  V3 highlight = v3(0.0f, 0.0f, 0.0f);
  if (is_glass && c.any_glass && c.has_lights) {
    // glass: specular highlights only (RayGen.hlsl:283-334)
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
  V3 f0 = v3(F(0.04) + (albedo.x - F(0.04)) * metallic, F(0.04) + (albedo.y - F(0.04)) * metallic,
             F(0.04) + (albedo.z - F(0.04)) * metallic);
  V3 dc = scale(albedo, 1.0f - metallic);
  uint32_t sample_rng = sample + (uint32_t)ray.depth * 4096u;
  V3 ambient = v3(0.0f, 0.0f, 0.0f), ddiff = ambient, dspec = ambient;
  float best_vis = 1.0f, best_pen = 0.0f, best_dist = FP16_MAX;
  int rays = 0;
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
      res[w] = soft_shadow(c, sc, pos, nrm, active, type, lpos, __ldg(lt + 8), (float)samples,
                           seed);
      if (active) rays += res[w].rays;
    }
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
      bool use_a = a_idx == li && a_sel, use_b = b_idx == li && b_sel;
      const Shadow& rs = res[use_a ? 0 : 1];
      bool use = use_a || use_b;
      float vis = use ? rs.vis : 1.0f;
      V3 scol = use ? rs.color : v3(1.0f, 1.0f, 1.0f);
      float w = g.ndotl * g.atten * lint;
      if (ray.depth == 0 && w > best_w) {
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
  } else if (!is_glass && ray.depth == 0) {
    // no-light fallback (RayGen.hlsl:452-501): legacy point light + flat
    // ambient, only at depth 0
    V3 to_l = sub(v3(3.0f, 5.0f, -3.0f), pos);
    float fb_dist = length(to_l);
    V3 fb_l = divs(to_l, maxn(fb_dist, F(1e-12)));
    float fb_atten = attenuation(sc, fb_dist);
    float fb_ndotl = maxn(dot(nrm, fb_l), 0.0f);
    float fb_vis, fb_occ;
    V3 fb_scol;
    trace_shadow(c, sc, add(pos, scale(nrm, F(0.001))), fb_l, fb_dist, fb_vis, fb_scol, fb_occ);
    rays += 1;
    float fb_amount = clampn((1.0f - fb_vis) * par(sc, P_SHADOW_STRENGTH), 0.0f, 1.0f);
    float k = F(1.5) * fb_atten * (1.0f - fb_amount);
    V3 fb_rad = v3(k * fb_scol.x, k * fb_scol.y, k * fb_scol.z);
    if (fb_ndotl > 0.0f) {
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

  float reflection_weight = metallic * (1.0f - roughness * 0.5f);
  float direct_weight = 1.0f - reflection_weight * 0.5f;
  V3 diff_lit = add(ambient, scale(ddiff, direct_weight));
  V3 col = is_glass ? add(highlight, emission)
                    : clamp3(add(add(diff_lit, dspec), emission), 0.0f, INFINITY);
  if (!finite3(col)) col = mul(ray.tp, sky_color(ray.d));  // NaN/Inf guard (RayGen.hlsl:250-260)
  out.color = col;
  out.diffuse = is_glass ? v3(0.0f, 0.0f, 0.0f) : add(diff_lit, emission);
  out.specular = is_glass ? highlight : dspec;
  out.hit_distance = h.t;
  out.svis = is_glass ? 1.0f : best_vis;
  out.spen = is_glass ? 0.0f : best_pen;
  out.sdist = is_glass ? FP16_MAX : best_dist;
  out.normal = nrm;
  out.albedo = albedo;
  out.pos = pos;
  out.roughness = roughness;
  out.metallic = metallic;
  out.transmission = transmission;
  out.obj_id = h.type * 65536 + h.index;
  out.entering = front;

  // ---- children (RayGen.hlsl:591-847) ----
  if (c.any_glass && is_glass) {
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
    if (roughness > F(0.01) && ray.depth == 0) {
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
    if (c.any_absorption && !tir) {
      // thickness ray for Beer-Lambert absorption (RayGen.hlsl:646-678)
      float th_t;
      bool th_hit = trace_thickness(c, sc, add(pos, scale(g_refract, F(0.002))), g_refract,
                                    h.type, h.index, th_t);
      rays += 1;
      float thickness = th_hit ? th_t : 0.0f;
      if (thickness > 0.0f) {
        float ts = thickness * F(0.6);
        absorb = v3(expf(-absorption.x * ts), expf(-absorption.y * ts), expf(-absorption.z * ts));
      }
    }
    out.glass_spawn = true;
    out.tir = tir;
    out.reflect_dir = g_reflect;
    out.refract_dir = g_refract;
    out.reflect_tp = v3(rtp * ray.tp.x, rtp * ray.tp.y, rtp * ray.tp.z);
    out.refract_tp = mul(mul(refract_tp, absorb), ray.tp);
  }
  if (c.any_metal && !is_glass && metallic > F(0.1)) {
    // metal child (RayGen.hlsl:806-846)
    V3 reflect_m = sub(ray.d, scale(nrm, 2.0f * dot(ray.d, nrm)));
    out.metal_dir = perturb_reflection(reflect_m, nrm, roughness,
                                       rng_init(px, py, sc.frame, sample_rng, SALT_REFLECT));
    float ndotv_m = clampn(dot(nrm, neg(ray.d)), 0.0f, 1.0f);
    V3 f_metal = fresnel_schlick3(ndotv_m, f0);
    float reflect_scale = 1.0f - roughness * 0.5f;
    float boost = ray.depth > 0 ? F(1.5) : 1.0f;
    out.metal_tp = mul(scale(f_metal, reflect_scale * boost), ray.tp);
    out.metal_spawn = true;
  }
  out.rays = rays;
}

__global__ void __launch_bounds__(256)
    render_accum_kernel(Cfg c, Scene sc, const int* __restrict__ itab, float* __restrict__ out) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= c.width || y >= c.height) return;
  // scene scalars stay on the device: no host sync to launch
  sc.num_lights = __ldg(itab);
  sc.max_shadow_lights = __ldg(itab + 1);
  sc.frame = (uint32_t)__ldg(itab + 2);
  uint32_t px = (uint32_t)x, py = (uint32_t)y;

  V3 color = v3(0.0f, 0.0f, 0.0f), primary = color, diffuse = color, specular = color;
  float hitdist = 0.0f, bounce_f = 0.0f, rays_f = 0.0f;
  float svis = 1.0f, spen = 0.0f, sdist = FP16_MAX;
  bool prim_hit = false;
  V3 pnormal = v3(0.0f, 1.0f, 0.0f), palbedo = v3(0.0f, 0.0f, 0.0f), ppos = palbedo;
  float prough = 1.0f, pmetal = 0.0f, ptrans = 0.0f;
  int pobj = -1;

  V3 cam_pos = par3(sc, P_CAMPOS), fwd = par3(sc, P_FWD), right = par3(sc, P_RIGHT),
     up = par3(sc, P_UP);
  float tanfov = par(sc, P_TANFOV), aperture = par(sc, P_APERTURE);

  float sf[STACK_DEPTH][10];
  int si[STACK_DEPTH][5];

  for (int s = 0; s < c.spp; ++s) {
    // primary ray (RayGen.hlsl:107-172): blue-noise AA + thin-lens DoF
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
    Ray cur;
    cur.o = o;
    cur.d = d;
    cur.tp = v3(1.0f, 1.0f, 1.0f);
    cur.boost = 1.0f;
    cur.depth = cur.flags = cur.rflags = cur.sidx = 0;
    cur.stype = INVALID;
    bool valid = true;
    int count = 0;

    V3 s_color = v3(0.0f, 0.0f, 0.0f), s_primary = s_color;
    int s_bounce = 0, s_rays = 0;
    for (int it = 0; it < c.max_iters && (valid || count > 0); ++it) {
      if (valid) s_bounce = max(s_bounce, cur.depth + 1);
      bool has_cont = false;
      Ray next;
      if (valid && cur.depth >= c.max_bounces) {
        // depth cap -> sky fallback without boost (RayGen.hlsl:184-193)
        V3 cap = mul(cur.tp, sky_color(cur.d));
        s_color = add(s_color, cap);
        if (cur.depth == 0) s_primary = add(s_primary, cap);
      } else if (valid && !(maxn(maxn(cur.tp.x, cur.tp.y), cur.tp.z) < F(0.01) &&
                            (cur.flags & PATH_FLAG_SPECULAR) == 0)) {
        Shaded sh;
        shade_and_spawn(c, sc, px, py, (uint32_t)s, cur, sh);
        s_rays += 1 + sh.rays;
        V3 contrib = mul(cur.tp, sh.color);
        s_color = add(s_color, contrib);
        if (cur.depth == 0) {
          s_primary = add(s_primary, contrib);
          // depth-0 records (RayGen.hlsl:560-589): each sample records once;
          // SIGMA takes the first sample's, the primary record the first hit
          diffuse = add(diffuse, sh.diffuse);
          specular = add(specular, sh.specular);
          hitdist = hitdist + sh.hit_distance;
          if (s == 0) {
            svis = sh.svis;
            spen = sh.spen;
            sdist = sh.sdist;
          }
          if (sh.hit && !prim_hit) {
            prim_hit = true;
            pnormal = sh.normal;
            prough = sh.roughness;
            palbedo = sh.albedo;
            pmetal = sh.metallic;
            ptrans = sh.transmission;
            ppos = sh.pos;
            pobj = sh.obj_id;
          }
        }
        // continuation (RayGen.hlsl:697-846): refract > unpushed reflect > metal > pop
        int next_depth = cur.depth + 1;
        int spec_flags = cur.flags | PATH_FLAG_SPECULAR;
        bool push_reflect = sh.glass_spawn && count < STACK_DEPTH;
        bool refract_ok =
            sh.glass_spawn && !sh.tir && count + (push_reflect ? 1 : 0) < STACK_DEPTH;
        Ray refl;
        refl.o = add(sh.pos, scale(sh.normal, F(0.002)));
        refl.d = sh.reflect_dir;
        refl.tp = sh.reflect_tp;
        refl.boost = F(1.2);
        refl.depth = next_depth;
        refl.flags = spec_flags;
        refl.rflags = RAYFLAG_SKIP_SELF;
        refl.stype = sh.hit_type;
        refl.sidx = sh.hit_index;
        if (push_reflect && refract_ok) {
          float* f = sf[count];
          f[0] = refl.o.x; f[1] = refl.o.y; f[2] = refl.o.z;
          f[3] = refl.d.x; f[4] = refl.d.y; f[5] = refl.d.z;
          f[6] = refl.tp.x; f[7] = refl.tp.y; f[8] = refl.tp.z;
          f[9] = refl.boost;
          int* iv = si[count];
          iv[0] = refl.depth; iv[1] = refl.flags; iv[2] = refl.rflags;
          iv[3] = refl.stype; iv[4] = refl.sidx;
          count += 1;
        }
        if (refract_ok) {
          next.o = add(sh.pos, scale(sh.refract_dir, F(0.002)));
          next.d = sh.refract_dir;
          next.tp = sh.refract_tp;
          next.boost = F(1.2);
          next.depth = next_depth;
          next.flags = sh.entering ? (spec_flags | PATH_FLAG_INSIDE)
                                   : (spec_flags & ~PATH_FLAG_INSIDE);
          next.rflags = 0;
          next.stype = INVALID;
          next.sidx = 0;
          has_cont = true;
        } else if (push_reflect) {
          next = refl;
          has_cont = true;
        } else if (sh.metal_spawn) {
          bool inside = (spec_flags & PATH_FLAG_INSIDE) != 0;
          next.o = add(sh.pos, scale(sh.normal, F(0.002)));
          next.d = sh.metal_dir;
          next.tp = sh.metal_tp;
          next.boost = F(1.1);
          next.depth = next_depth;
          next.flags = spec_flags;
          next.rflags = inside ? 0 : RAYFLAG_SKIP_SELF;
          next.stype = inside ? INVALID : sh.hit_type;
          next.sidx = inside ? 0 : sh.hit_index;
          has_cont = true;
        }
      }
      if (has_cont) {
        cur = next;
        valid = true;
      } else if (count > 0) {
        // terminal lanes pop the deferred sibling
        count -= 1;
        const float* f = sf[count];
        const int* iv = si[count];
        cur.o = v3(f[0], f[1], f[2]);
        cur.d = v3(f[3], f[4], f[5]);
        cur.tp = v3(f[6], f[7], f[8]);
        cur.boost = f[9];
        cur.depth = iv[0]; cur.flags = iv[1]; cur.rflags = iv[2];
        cur.stype = iv[3]; cur.sidx = iv[4];
        valid = true;
      } else {
        valid = false;
      }
    }
    color = add(color, s_color);
    primary = add(primary, s_primary);
    bounce_f = bounce_f + (float)s_bounce;
    rays_f = rays_f + (float)s_rays;
  }

  size_t plane = (size_t)c.height * c.width;
  float* o = out + (size_t)y * c.width + x;
  float vals[32] = {color.x, color.y, color.z, primary.x, primary.y, primary.z,
                    diffuse.x, diffuse.y, diffuse.z, specular.x, specular.y, specular.z,
                    hitdist, bounce_f, rays_f, prim_hit ? 1.0f : 0.0f,
                    pnormal.x, pnormal.y, pnormal.z, prough,
                    palbedo.x, palbedo.y, palbedo.z, pmetal, ptrans,
                    ppos.x, ppos.y, ppos.z, svis, spen, sdist, (float)pobj};
#pragma unroll
  for (int ch = 0; ch < 32; ++ch) o[ch * plane] = vals[ch];
}

}  // namespace

// ftab: the float tables of pack_scene (spheres, planes, boxes, materials,
// lights, 32 params, the 16x16x4 blue-noise tile); itab: [num_lights,
// max_shadow_lights, frame]; out: [32, height, width]. flags: bit 0 has_lights,
// 1 any_glass, 2 any_metal, 3 any_absorption. Returns the launch's cudaError_t.
extern "C" int rtvs_render_accum(const float* ftab, const int* itab, float* out, int width,
                                 int height, int S, int P, int B, int L,
                                 int spp, int max_bounces, int max_iters, int max_soft,
                                 int flags, float aspect, void* stream) {
  Cfg c;
  c.width = width;
  c.height = height;
  c.S = S;
  c.P = P;
  c.B = B;
  c.L = L;
  c.spp = spp;
  c.max_bounces = max_bounces;
  c.max_iters = max_iters;
  c.max_soft = max_soft;
  c.has_lights = flags & 1;
  c.any_glass = flags & 2;
  c.any_metal = flags & 4;
  c.any_absorption = flags & 8;
  c.aspect = aspect;
  int M = S + P + B > 0 ? S + P + B : 1;
  Scene sc;
  sc.sph = ftab;
  sc.pln = sc.sph + SPH_W * S;
  sc.box = sc.pln + PLN_W * P;
  sc.mat = sc.box + BOX_W * B;
  sc.lts = sc.mat + MAT_W * M;
  sc.par = sc.lts + LT_W * L;
  sc.bn = sc.par + 32;
  sc.num_lights = sc.max_shadow_lights = 0;
  sc.frame = 0u;
  dim3 block(16, 16);
  dim3 grid((width + 15) / 16, (height + 15) / 16);
  render_accum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(c, sc, itab, out);
  return (int)cudaGetLastError();
}
