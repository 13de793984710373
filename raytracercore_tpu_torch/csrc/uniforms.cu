// Train-path uniforms: [bounces, 7, n] preprocessed channels from a
// counter-based generator, one thread per (path, bounce).
//
// Replaces the TPU kernel raytracercore_tpu/render/uniforms_kernel.py:
// _make_kernel (pl.pallas_call in prepare_uniforms_kernel), which drew from
// the TPU's hardware generator.  Here the generator is Philox4x32-10,
// written out below and again in the plain torch version
// (render/uniforms_kernel.py: prepare_uniforms_reference), so kernel and
// plain version draw the same bits:
//   key = the 64-bit seed as (lo, hi); counter (r, b, 0, 0) gives u0..u3,
//   counter (r, b, 1, 0) word 0 gives u4; a word w becomes (w >> 8) * 2^-24.
// Then the channel transforms of preprocess_uniforms: ln(clip(u0)),
// cos/sin(2 pi u1), u2, 2 acos(u3) / pi, cos/sin(2 pi u4).
//
// What bounds it on Hopper: the 28 bytes it writes per (path, bounce); the
// two Philox calls (20 rounds of two 32x32 multiplies) and five
// transcendentals are arithmetic on registers.  The design writes each
// channel plane with neighbouring threads on neighbouring addresses (r
// fastest) and reads nothing.  The TPU kernel's (64,128) output blocks and
// its per-block reseeding are not carried over: a counter-based generator
// needs no per-block state.
//
// Floating point: built without fast math, so logf/cosf/sinf/acosf are the
// accurate CUDA versions, the functions torch calls on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtc {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float PI_F = 3.141592653589793f;
constexpr int UNIFORMS_BLOCK = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int rnd = 0; rnd < 10; ++rnd) {
    if (rnd) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_unit(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(UNIFORMS_BLOCK)
    uniforms_kernel(float* out, int n, int bounces, uint32_t k0, uint32_t k1) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * bounces) return;
  const uint32_t r = (uint32_t)(idx % n);
  const uint32_t b = (uint32_t)(idx / n);
  uint4 w = philox4x32_10(make_uint4(r, b, 0u, 0u), k0, k1);
  uint4 w4 = philox4x32_10(make_uint4(r, b, 1u, 0u), k0, k1);
  float u0 = to_unit(w.x), u1 = to_unit(w.y), u2 = to_unit(w.z);
  float u3 = to_unit(w.w), u4 = to_unit(w4.x);
  float t1 = u1 * TWO_PI_F;
  float t2 = u4 * TWO_PI_F;
  float* o = out + (size_t)b * 7 * n + r;  // channel c at o[c * n]
  o[0] = logf(fminf(fmaxf(u0, 1e-20f), 1.f));
  o[(size_t)n] = cosf(t1);
  o[2 * (size_t)n] = sinf(t1);
  o[3 * (size_t)n] = u2;
  o[4 * (size_t)n] = 2.f * acosf(fminf(fmaxf(u3, 0.f), 1.f)) / PI_F;
  o[5 * (size_t)n] = cosf(t2);
  o[6 * (size_t)n] = sinf(t2);
}

}  // namespace rtc

// C entry point, loaded with ctypes.  Launches on `stream` and returns the
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rtc_uniforms(float* out, int n, int bounces, uint32_t k0,
                            uint32_t k1, void* stream) {
  long long total = (long long)n * bounces;
  if (total <= 0) return 0;
  dim3 grid((unsigned)((total + rtc::UNIFORMS_BLOCK - 1) /
                       rtc::UNIFORMS_BLOCK));
  rtc::uniforms_kernel<<<grid, rtc::UNIFORMS_BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(out, n, bounces,
                                                              k0, k1);
  return static_cast<int>(cudaGetLastError());
}
