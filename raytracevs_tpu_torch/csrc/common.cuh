// Shared device helpers for the port's kernels.
//
// Arithmetic rule of this directory: every expression is written in the
// same order, with the same constants, as the plain PyTorch version in the
// Python package, and the files are compiled with --fmad=false, so a
// kernel and its plain version round alike on the card. Float constants
// go through F(), which rounds the decimal to double first and then to
// float, exactly as a Python float constant reaches a float32 tensor.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define F(x) ((float)(x))

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 divs(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

// NaN-propagating max/min/clamp, as torch.clamp / torch.maximum behave.
__device__ __forceinline__ float maxn(float a, float b) {
  return (a != a || b != b) ? NAN : (a > b ? a : b);
}
__device__ __forceinline__ float minn(float a, float b) {
  return (a != a || b != b) ? NAN : (a < b ? a : b);
}
__device__ __forceinline__ float clampn(float x, float lo, float hi) {
  return minn(maxn(x, lo), hi);
}
__device__ __forceinline__ V3 clamp3(V3 a, float lo, float hi) {
  return v3(clampn(a.x, lo, hi), clampn(a.y, lo, hi), clampn(a.z, lo, hi));
}
__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }
// a / max(|a|, eps): a division per component, as in the plain version
__device__ __forceinline__ V3 normalize(V3 a, float eps = F(1e-12)) {
  return divs(a, maxn(length(a), eps));
}
__device__ __forceinline__ bool finite3(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}
__device__ __forceinline__ V3 ld3(const float* p) {
  return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}
// x ** 8 by repeated squaring (jax.lax.integer_pow's form)
__device__ __forceinline__ float pow8(float x) {
  float x2 = x * x;
  float x4 = x2 * x2;
  return x4 * x4;
}
