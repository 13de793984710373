// Issue-rate probe: how many fp32 operations a second one card sustains on
// register-resident chains, under the port's build (-fmad=false: every
// multiply and add issued apart; correctly rounded division and sqrtf).
//
// Replaces the TPU kernel scripts/vpu_issue_bench.py (its pl.pallas_call:
// a microbenchmark of the TPU's VPU issue rate).  Its plain version is
// probe_reference in raytracercore_tpu_torch/tools/issue_probe.py; the
// wrapper issue_probe there launches this kernel.  It lies on no path of
// the renderer: chip_smoke.py runs it to measure the ceiling that the
// megakernel and the select kernel are held against beside the card's
// 67 TFLOP/s (which counts a fused multiply-add as two operations).
//
// Each thread runs NS = 8 independent chains (enough to hide the latency
// of each operation), so the time is set by the issue rate.  A mix is a
// group of operation entries applied in turn to the chains (entry j to
// chain j % 8), UNROLL groups per trip; the chains stay bounded (the
// multipliers are below 1, additions alternate in sign, the division,
// sqrt and exp entries are contractions), so the plain version can check
// them.  Entries:
//   mul     a = a * b                       (1 operation)
//   add     a = a + c, a - c in turn        (1)
//   cmpsel  a = a > b ? c : a               (2: compare, select)
//   div     a = 1 / (a * a + 1.5)           (3: multiply, add, divide)
//   sqrt    a = sqrt(a * 0.5 + 0.25)        (3)
//   exp     a = exp(a * -0.25)              (2)
// Bound: none; it measures the bound's denominator.

#include <cuda_runtime.h>
#include <math.h>

namespace rtc {

constexpr int PROBE_NS = 8;
constexpr int PROBE_UNROLL = 4;
constexpr int PROBE_THREADS = 256;

// A mix: entries per group of mul, add, cmpsel, div, sqrt, exp.
template <int MUL, int ADD, int CMPSEL, int DIV, int SQRT, int EXP>
__device__ __forceinline__ void group(float (&a)[PROBE_NS],
                                      const float (&b)[PROBE_NS],
                                      const float (&c)[PROBE_NS]) {
  int j = 0;
#pragma unroll
  for (int k = 0; k < MUL; ++k, ++j) a[j % PROBE_NS] *= b[j % PROBE_NS];
#pragma unroll
  for (int k = 0; k < ADD; ++k, ++j)
    a[j % PROBE_NS] = (k & 1) ? a[j % PROBE_NS] - c[j % PROBE_NS]
                              : a[j % PROBE_NS] + c[j % PROBE_NS];
#pragma unroll
  for (int k = 0; k < CMPSEL; ++k, ++j)
    a[j % PROBE_NS] =
        a[j % PROBE_NS] > b[j % PROBE_NS] ? c[j % PROBE_NS] : a[j % PROBE_NS];
#pragma unroll
  for (int k = 0; k < DIV; ++k, ++j)
    a[j % PROBE_NS] = 1.f / (a[j % PROBE_NS] * a[j % PROBE_NS] + 1.5f);
#pragma unroll
  for (int k = 0; k < SQRT; ++k, ++j)
    a[j % PROBE_NS] = sqrtf(a[j % PROBE_NS] * 0.5f + 0.25f);
#pragma unroll
  for (int k = 0; k < EXP; ++k, ++j)
    a[j % PROBE_NS] = expf(a[j % PROBE_NS] * -0.25f);
}

// abc: [3, NS, n] chain starts, multipliers and addends; out: [NS, n].
template <int... MIX>
__global__ void __launch_bounds__(PROBE_THREADS)
    issue_probe_kernel(const float* abc, float* out, int n, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float a[PROBE_NS], b[PROBE_NS], c[PROBE_NS];
#pragma unroll
  for (int s = 0; s < PROBE_NS; ++s) {
    a[s] = abc[(size_t)s * n + t];
    b[s] = abc[(size_t)(PROBE_NS + s) * n + t];
    c[s] = abc[(size_t)(2 * PROBE_NS + s) * n + t];
  }
  for (int k = 0; k < iters; ++k) {
    if constexpr ((MIX + ...) > 64) {
      // A long group (the megakernel's mix, one bounce's operations) is
      // its own straight-line code: not unrolled further.
#pragma unroll 1
      for (int g = 0; g < PROBE_UNROLL; ++g) group<MIX...>(a, b, c);
    } else {
#pragma unroll
      for (int g = 0; g < PROBE_UNROLL; ++g) group<MIX...>(a, b, c);
    }
  }
#pragma unroll
  for (int s = 0; s < PROBE_NS; ++s) out[(size_t)s * n + t] = a[s];
}

template <int... MIX>
int launch_probe(const float* abc, float* out, int n, int iters,
                 cudaStream_t st) {
  const int blocks = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  issue_probe_kernel<MIX...><<<blocks, PROBE_THREADS, 0, st>>>(abc, out, n,
                                                              iters);
  return (int)cudaGetLastError();
}

}  // namespace rtc

// C entry point, loaded with ctypes: mix `mix` (rtc::MIXES) over n threads
// for `iters` trips on `stream`; returns the CUDA error of the launch.
extern "C" int rtc_issue_probe(const float* abc, float* out, int n,
                               int iters, int mix, void* stream) {
  if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The mixes of tools/issue_probe.py MIXES, in its order.
  switch (mix) {
    case 0: return rtc::launch_probe<8, 0, 0, 0, 0, 0>(abc, out, n, iters, st);
    case 1: return rtc::launch_probe<0, 8, 0, 0, 0, 0>(abc, out, n, iters, st);
    case 2: return rtc::launch_probe<0, 0, 8, 0, 0, 0>(abc, out, n, iters, st);
    case 3: return rtc::launch_probe<0, 0, 0, 8, 0, 0>(abc, out, n, iters, st);
    case 4: return rtc::launch_probe<0, 0, 0, 0, 8, 0>(abc, out, n, iters, st);
    case 5: return rtc::launch_probe<0, 0, 0, 0, 0, 8>(abc, out, n, iters, st);
    case 6:
      return rtc::launch_probe<430, 250, 90, 11, 6, 1>(abc, out, n, iters,
                                                       st);
  }
  return (int)cudaErrorInvalidValue;
}
