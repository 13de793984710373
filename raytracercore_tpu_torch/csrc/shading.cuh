// Shading pieces shared by the megakernel (fused.cu) and the replay kernels
// (replay.cu): the bounce codes and PathTape flag bits, luminance and the
// cone sampler CreateHorizon.  Plain torch counterparts: render/integrator.py
// (BounceType, PathTape), core/color.py (LUM_*), core/vecmath.py
// (create_horizontal3, create_horizon3_cs).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "kernel_body.cuh"

namespace rtc {

// BounceType codes and PathTape flag bits (render/integrator.py).
enum Code : int {
  SKIPPED = 0,
  DIFFUSE = 1,
  SPECULAR = 2,
  SPECULAR_FAIL = 3,
  TRANSMITTED = 4,
  EMISSION = 5,
  PURE_BLACK = 6,
  RECURSION_COMPLETE = 7,
  MISSED = 8,
};
constexpr int CODE_MASK = 0xF;
constexpr int FLAG_INSIDE = 1 << 4;
constexpr int FLAG_FLIVE = 1 << 5;

constexpr float LUM_R = 0.299f, LUM_G = 0.587f, LUM_B = 0.114f;

__device__ __forceinline__ float lum(float r, float g, float b) {
  return LUM_R * r + LUM_G * g + LUM_B * b;
}

// CreateHorizontal (Vec4D.cs:33-43): p x (0,0,1) normalized, x-hat when
// that is degenerate.
__device__ __forceinline__ V3 create_horizontal(V3 p) {
  float cx = p.y, cy = -p.x;
  float sq = cx * cx + cy * cy;
  bool good = sq > F32_TINY;
  float inv = 1.f / sqrtf(good ? sq : 1.f);
  return {good ? cx * inv : 1.f, good ? cy * inv : 0.f, 0.f};
}

// Rodrigues rotation of b about the unit axis p by the angle whose cos/sin
// are ct/st.
__device__ __forceinline__ V3 rotate_cs(V3 b, V3 p, float ct, float st) {
  V3 kxv = {p.y * b.z - p.z * b.y, p.z * b.x - p.x * b.z,
            p.x * b.y - p.y * b.x};
  float kd = (p.x * b.x + p.y * b.y + p.z * b.z) * (1.f - ct);
  return {b.x * ct + kxv.x * st + p.x * kd, b.y * ct + kxv.y * st + p.y * kd,
          b.z * ct + kxv.z * st + p.z * kd};
}

// CreateHorizon (Vec4D.cs:52-58) with precomputed azimuth cos/sin: a point
// on the cone of height z around the unit pole, rotated by the azimuth.
__device__ __forceinline__ V3 create_horizon_cs(V3 p, float z, float ct,
                                                float st) {
  V3 h = create_horizontal(p);
  float s = sqrtf(fmaxf(1.f - z * z, 1e-20f));
  V3 b = {p.x * z + h.x * s, p.y * z + h.y * s, p.z * z + h.z * s};
  return rotate_cs(b, p, ct, st);
}

}  // namespace rtc
