// The channel transforms of preprocess_uniforms (render/integrator.py), as
// device functions of one raw uniform each: the uniforms kernel
// (uniforms.cu) writes all seven channels with them; the megakernel's
// whole-pass form (fused.cu) and the shading kernel's (shade.cu) compute,
// at the point of use, the channels a bounce reads from the raw [B, 5, R]
// draws.
//
//   ch0 = ln(clamp(u0, 1e-20, 1))     shine_log
//   ch1, ch2 = cos/sin(2 pi u1)       cos_2pi, sin_2pi
//   ch3 = u2
//   ch4 = 2 acos(clamp(u3, 0, 1)) / pi
//   ch5, ch6 = cos/sin(2 pi u4)       cos_2pi, sin_2pi
//
// Floating point: built without fast math, so logf/cosf/sinf/acosf are the
// accurate CUDA versions, the functions torch calls on the card.  torch
// multiplies a tensor by a Python float as that float rounded to f32
// (TWO_PI_F), and divides by one as a product with its f32 reciprocal
// (INV_PI_F); the uniforms kernel keeps its true division by PI_F.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rtc {

constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float PI_F = 3.141592653589793f;
constexpr float INV_PI_F = 1.f / PI_F;

__device__ __forceinline__ float shine_log(float u0) {
  return logf(fminf(fmaxf(u0, 1e-20f), 1.f));
}

__device__ __forceinline__ float cos_2pi(float u) { return cosf(u * TWO_PI_F); }

__device__ __forceinline__ float sin_2pi(float u) { return sinf(u * TWO_PI_F); }

// 2 acos(clamp(u3, 0, 1)): ch4 before its division by pi.
__device__ __forceinline__ float two_acos(float u3) {
  return 2.f * acosf(fminf(fmaxf(u3, 0.f), 1.f));
}

}  // namespace rtc
