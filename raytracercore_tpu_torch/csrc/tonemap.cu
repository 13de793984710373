// A viewer frame's tonemap and pack: the film's colour sum, sample and miss
// counts (and Neumaier compensation, where the film keeps one) to the RGBA
// uint8 image, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this to XLA
// (raytracercore_tpu/render/renderer.py Renderer.image, film.to_uint8).
// Eager in the port it was the chain of raytracercore_tpu_torch/core/color.py
// tonemap and to_uint8 (Film.to_uint8): 36 aten ops, ~32 of them elementwise
// kernels each with its own allocation, then a pageable copy to the host.
// Renderer.step ends in a synchronize, so the card sits idle for all of
// image()'s host time, every frame; the device work itself is small.  The
// Python wrapper (render/tonemap_kernel.py, Packer) launches this kernel from
// Renderer.image on a CUDA float32 film; every other film keeps the chain,
// its plain version.
//
// What bounds it on Hopper: the store to host memory.  A pixel reads 20
// bytes of film (32 with the compensation), ~3 us for a 700x700 film at
// 3.35 TB/s, and writes 4 bytes across PCIe: 1.96 MB of a 700x700 frame, at
// ~48 GB/s some 41 us.  Into device memory the same kernel takes ~9 us, and
// the copy engine then needs ~38 us for the frame: storing straight into
// pinned memory costs the copy alone, without its launch.
//
// What the design does about it: one thread a pixel, every value read once,
// no intermediate in device memory, one coalesced uchar4 store a pixel,
// straight to the caller's pinned host buffer (its device address under
// unified addressing), so the frame needs one launch and the host waits for
// one kernel.  Background colour and alpha are read from device memory, so
// no host read of a device value stands before the launch.
//
// Floating point: core/color.py's operations in its order, each rounded once
// (built with -fmad=false like every source here), as torch's CUDA kernels
// compute them: `exposure / clamp(samples, 1)` is Tensor.__rdiv__, a
// reciprocal times the exposure; the miss share a true division; the sum
// corrected by its compensation first; torch.clamp passes a NaN through
// (fmaxf alone would drop it); torch.pow with a float exponent is powf with
// the float32 of 1 / 2.2; Tensor.to(torch.uint8) truncates through int64.
// Bit-equal to Film.to_uint8 on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtc {

constexpr int TONEMAP_BLOCK = 256;

// torch.clamp on CUDA (a NaN passes through).
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// Tensor.to(torch.uint8): c10's cast through int64.
__device__ __forceinline__ unsigned char to_u8(float v) {
  return static_cast<unsigned char>(static_cast<long long>(v));
}

// `v` [0, 1] after the gamma, as to_uint8 packs it.
__device__ __forceinline__ unsigned char pack(float v) {
  return to_u8(clamp_nan(v * 255.0f, 0.0f, 255.0f));
}

__global__ void __launch_bounds__(TONEMAP_BLOCK) tonemap_pack_kernel(
    const float* __restrict__ color_sum, const float* __restrict__ samples,
    const float* __restrict__ misses, const float* __restrict__ color_c,
    const float* __restrict__ background_rgb,
    const float* __restrict__ background_alpha, uchar4* __restrict__ out,
    int n, float exposure) {
  const int p = blockIdx.x * TONEMAP_BLOCK + threadIdx.x;
  if (p >= n) return;
  const float s = samples[p];
  const float m = misses[p];
  const float ba = __ldg(background_alpha);
  const float total = s + m;
  const bool no_samples = s == 0.0f;
  const float color_mult = (1.0f / clamp_min_nan(s, 1.0f)) * exposure;
  const float back_alpha_amt =
      total > 0.0f ? m / clamp_min_nan(total, 1.0f) : 0.0f;
  const float back_amt = back_alpha_amt * ba;
  const float gamma = static_cast<float>(1.0 / 2.2);
  unsigned char c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float sum = color_sum[3 * p + k];
    if (color_c != nullptr) sum = sum + color_c[3 * p + k];
    const float bg = __ldg(background_rgb + k);
    float v = sum * color_mult;
    v = v + (bg - v) * back_amt;
    if (no_samples) v = bg * exposure;
    c[k] = pack(clamp_nan(powf(clamp_min_nan(v, 0.0f), gamma), 0.0f, 1.0f));
  }
  const float alpha = no_samples ? ba : 1.0f + (ba - 1.0f) * back_alpha_amt;
  out[p] = make_uchar4(c[0], c[1], c[2], pack(clamp_nan(alpha, 0.0f, 1.0f)));
}

}  // namespace rtc

// The RGBA uint8 image [n] of a film of n pixels: color_sum [n,3], samples
// [n], misses [n], color_c [n,3] (null: no compensation), background_rgb
// [3], background_alpha [1], all float32 on the device; `out` [n] uchar4 in
// pinned host memory, written through its device address.  Returns a
// cudaError_t.
extern "C" int rtc_tonemap_pack(const float* color_sum, const float* samples,
                                const float* misses, const float* color_c,
                                const float* background_rgb,
                                const float* background_alpha, void* out,
                                int n, float exposure, void* stream) {
  if (n <= 0) return 0;
  void* dst = nullptr;
  const cudaError_t err = cudaHostGetDevicePointer(&dst, out, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((n + rtc::TONEMAP_BLOCK - 1) /
                             rtc::TONEMAP_BLOCK));
  rtc::tonemap_pack_kernel<<<grid, rtc::TONEMAP_BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      color_sum, samples, misses, color_c, background_rgb, background_alpha,
      static_cast<uchar4*>(dst), n, exposure);
  return static_cast<int>(cudaGetLastError());
}
