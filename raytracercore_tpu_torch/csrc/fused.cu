// Whole-path megakernel: one thread traces one camera path through every
// bounce and writes its final colour (and, optionally, its PathTape).
//
// Replaces the TPU kernel raytracercore_tpu/render/fused.py:_make_kernel
// (launched by _run through pl.pallas_call, public trace_fused).  Its plain
// version is trace_fused_reference in raytracercore_tpu_torch/render/
// fused.py; the Python wrapper trace_fused launches this kernel.
//
// What bounds it on Hopper: not memory.  A path reads 6 floats of ray and
// 7 floats of uniforms per bounce and writes 4 numbers (20 more per bounce
// with the tape); everything else is arithmetic on registers over the
// scene's table rows: about rows x 60 flops of intersection plus ~150 of
// shading per bounce.  So by these counts the kernel is bound by fp32
// issue rate and by warp divergence (paths in one warp end at different
// bounces and take different branches: refract / reflect / diffuse); no
// hardware counter has confirmed which of the two dominates.
//
// What the design does about it:
//   * the packed tables and the [N,14] material table are copied into
//     shared memory once per block (at most 64 rows, a few KB), so every row
//     read in the intersection loops is a broadcast from shared memory;
//   * ray state lives in registers for the whole path; nothing goes to
//     device memory between bounces;
//   * the bounce loop runs at run time and a finished path leaves it at
//     once (a warp runs until its longest path ends), and candidates that
//     cannot win (already rejected, or not closer) skip the rest of their
//     row's work;
//   * materials are fetched by direct index, mf[prim * 14 + k];
//   * the static choices (tape, ambient-miss mode, smooth normals, coplanar
//     triangle branch) are template parameters, so a scene pays only for
//     the code it uses.
// The TPU kernel's (8,128) tiles, its N-way select gather and its unrolled
// bounce loop are TPU artefacts and are not carried over.
//
// Floating point: fp32 throughout, built with -fmad=false and without fast
// math, and 1.0f / sqrtf where JAX has rsqrt, so that the comparison with
// the plain torch version measures the algorithm and not contraction.

#include <cuda_runtime.h>
#include <math.h>

#include "kernel_body.cuh"

namespace rtc {

constexpr int MAT_F = 14;  // emission(3) diffuse(3) specular(3) refraction(3) ior shin
constexpr int SC_F = 4;    // air_ior, ambient r g b
constexpr int BLOCK = 128;

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
constexpr int FLAG_INSIDE = 1 << 4;
constexpr int FLAG_FLIVE = 1 << 5;

constexpr float LUM_R = 0.299f, LUM_G = 0.587f, LUM_B = 0.114f;

struct Params {
  const float* ray_o;  // [R,3]
  const float* ray_d;  // [R,3]
  const float* u;      // [B,7,R]
  const float* tf;     // [T,21]
  const int* ti;       // [T,4]
  const float* sf;     // [S,28]
  const int* si;       // [S,4]
  const float* pf;     // [P,4]
  const int* pi;       // [P,4]
  const float* mf;     // [N,14]
  const float* scf;    // [4]
  float* color;        // [R,3]
  int* miss;           // [R]
  int* tape_prim;      // [B,R] (want_tape only)
  int* tape_flags;     // [B,R]
  float* tape_nx;      // [B,R]
  float* tape_ny;
  float* tape_nz;
  int R, T, S, P, N, n_bounces, recursion;
  float eps_behind, eps2;
};

__device__ __forceinline__ float lum(float r, float g, float b) {
  return LUM_R * r + LUM_G * g + LUM_B * b;
}

// CreateHorizon (Vec4D.cs:52-58) with precomputed azimuth cos/sin: a point
// on the cone of height z around the unit pole, rotated by the azimuth.
__device__ __forceinline__ V3 create_horizon_cs(V3 p, float z, float ct,
                                                float st) {
  float cx = p.y, cy = -p.x;  // p x (0,0,1)
  float sq = cx * cx + cy * cy;
  bool good = sq > F32_TINY;
  float inv = 1.f / sqrtf(good ? sq : 1.f);
  float hx = good ? cx * inv : 1.f;
  float hy = good ? cy * inv : 0.f;
  float hz = 0.f;
  float s = sqrtf(fmaxf(1.f - z * z, 1e-20f));
  V3 b = {p.x * z + hx * s, p.y * z + hy * s, p.z * z + hz * s};
  // Rodrigues rotation of b about p.
  V3 kxv = {p.y * b.z - p.z * b.y, p.z * b.x - p.x * b.z,
            p.x * b.y - p.y * b.x};
  float kd = (p.x * b.x + p.y * b.y + p.z * b.z) * (1.f - ct);
  return {b.x * ct + kxv.x * st + p.x * kd, b.y * ct + kxv.y * st + p.y * kd,
          b.z * ct + kxv.z * st + p.z * kd};
}

template <bool WANT_TAPE>
__device__ __forceinline__ void write_tape(const Params& p, int i, int r,
                                           int prim, int flags, V3 n) {
  if (!WANT_TAPE) return;
  size_t at = (size_t)i * p.R + r;
  p.tape_prim[at] = prim;
  p.tape_flags[at] = flags;
  p.tape_nx[at] = n.x;
  p.tape_ny[at] = n.y;
  p.tape_nz[at] = n.z;
}

template <bool WANT_TAPE, bool AMBIENT_IS_MISS, bool ANY_SMOOTH, bool COPLANAR>
__global__ void __launch_bounds__(BLOCK) trace_fused_kernel(Params p) {
  // --- scene tables into shared memory ------------------------------------
  extern __shared__ float smem[];
  float* s_tf = smem;
  float* s_sf = s_tf + p.T * TRI_F;
  float* s_pf = s_sf + p.S * SPH_F;
  float* s_mf = s_pf + p.P * PL_F;
  float* s_sc = s_mf + p.N * MAT_F;
  int* s_ti = reinterpret_cast<int*>(s_sc + SC_F);
  int* s_si = s_ti + p.T * INT_F;
  int* s_pi = s_si + p.S * INT_F;
  for (int k = threadIdx.x; k < p.T * TRI_F; k += blockDim.x) s_tf[k] = p.tf[k];
  for (int k = threadIdx.x; k < p.S * SPH_F; k += blockDim.x) s_sf[k] = p.sf[k];
  for (int k = threadIdx.x; k < p.P * PL_F; k += blockDim.x) s_pf[k] = p.pf[k];
  for (int k = threadIdx.x; k < p.N * MAT_F; k += blockDim.x) s_mf[k] = p.mf[k];
  for (int k = threadIdx.x; k < SC_F; k += blockDim.x) s_sc[k] = p.scf[k];
  for (int k = threadIdx.x; k < p.T * INT_F; k += blockDim.x) s_ti[k] = p.ti[k];
  for (int k = threadIdx.x; k < p.S * INT_F; k += blockDim.x) s_si[k] = p.si[k];
  for (int k = threadIdx.x; k < p.P * INT_F; k += blockDim.x) s_pi[k] = p.pi[k];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.R) return;

  const float air = s_sc[0];
  V3 o = {p.ray_o[3 * r], p.ray_o[3 * r + 1], p.ray_o[3 * r + 2]};
  V3 d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
  V3 tint = {1.f, 1.f, 1.f};
  V3 result = {0.f, 0.f, 0.f};
  int miss = 0;
  // Previous hit (skip record); none for camera rays.
  int pv_prim = -1;
  V3 pv_pos = {0.f, 0.f, 0.f};
  V3 pv_nrm = {0.f, 0.f, 1.f};
  bool pv_in = false;

  const V3 zero = {0.f, 0.f, 0.f};
  int i = 0;
  while (i < p.n_bounces) {
    // Periodic renormalization (Raytracer.cs:74-75); camera rays are unit.
    if (i % 3 == 0 && i > 0) {
      float inv = 1.f / sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
      d = {d.x * inv, d.y * inv, d.z * inv};
    }

    // --- closest hit across all tables (triangles -> spheres -> planes) ---
    const Skip k = make_skip(pv_prim, pv_pos, pv_nrm, pv_in, d);
    Best best = no_hit();
    triangle_pass<COPLANAR, ANY_SMOOTH>(p.T, s_tf, s_ti, o, d, p.eps_behind,
                                        k, p.eps2, best);
    sphere_pass(p.S, s_sf, s_si, o, d, k, p.eps2, best);
    plane_pass(p.P, s_pf, s_pi, o, d, p.eps_behind, k, p.eps2, best);

    // --- miss (Raytracer.cs:81-91) ------------------------------------------
    if (best.prim < 0) {
      // A primary miss is a miss sample; a secondary miss returns the
      // ambient colour, untinted, unless the scene says `ambient miss`.
      if (i == 0 || AMBIENT_IS_MISS) {
        miss = 1;
      } else {
        result = {s_sc[1], s_sc[2], s_sc[3]};
      }
      write_tape<WANT_TAPE>(p, i, r, -1, MISSED, zero);
      ++i;
      break;
    }

    // --- material fetch (row = global prim id) ------------------------------
    const float* mat = s_mf + best.prim * MAT_F;
    const int in_bit = best.inside ? FLAG_INSIDE : 0;
    V3 te = {tint.x * mat[0], tint.y * mat[1], tint.z * mat[2]};

    // --- recursion complete (Raytracer.cs:100-104): emission only ---------
    if (i >= p.recursion) {
      result = te;
      write_tape<WANT_TAPE>(p, i, r, best.prim, RECURSION_COMPLETE | in_bit,
                            best.nrm);
      ++i;
      break;
    }

    const float* u = p.u + (size_t)i * 7 * p.R + r;  // channel c at u[c * R]
    const float ior = mat[12];
    const float shin = mat[13];
    float l_e = lum(mat[0], mat[1], mat[2]);
    float l_d = lum(mat[3], mat[4], mat[5]);
    float l_s = lum(mat[6], mat[7], mat[8]);
    float l_r = lum(mat[9], mat[10], mat[11]);

    // RandomShine (Raytracer.cs:51-56): z = exp(ln U / shininess).
    float z_shine = isinf(shin) ? 1.f : expf(u[0] / shin);
    V3 rn = create_horizon_cs(best.nrm, z_shine, u[p.R], u[2 * p.R]);
    float cos_i = -(rn.x * d.x + rn.y * d.y + rn.z * d.z);

    // Fresnel split (Raytracer.cs:120-157).
    bool can_refract = (l_r > 0.f || l_s > 0.f) && ior != 0.f && cos_i >= 0.f;
    float ior_in = best.inside ? ior : air;
    float ior_out = best.inside ? air : ior;
    float safe_out = ior_out == 0.f ? 1.f : ior_out;
    float ratio = ior_in / safe_out;
    float sin_out = ratio * sqrtf(fmaxf(1.f - cos_i * cos_i, 1e-20f));
    bool tir = sin_out >= 1.f;
    float cos_out = sqrtf(fmaxf(1.f - sin_out * sin_out, 1e-20f));
    bool f_live = can_refract && !tir;
    float cos_f = f_live ? cos_i : 1.f;
    float cos_out_f = f_live ? cos_out : 1.f;
    float rs = ((ior_out * cos_f) - (ior_in * cos_out_f)) /
               ((ior_out * cos_f) + (ior_in * cos_out_f));
    float rp = ((ior_in * cos_f) - (ior_out * cos_out_f)) /
               ((ior_in * cos_f) + (ior_out * cos_out_f));
    float fresnel = (rs * rs + rp * rp) / 2.f;
    float spec_lum = f_live ? l_s * fresnel : l_s;
    float refr_lum = f_live ? l_r * (1.f - fresnel) : 0.f;
    float total = l_d + spec_lum + refr_lum + l_e;
    const int bits = in_bit | (f_live ? FLAG_FLIVE : 0);

    int code;
    V3 out_dir, new_tint;
    if (total <= 0.f) {
      code = PURE_BLACK;  // Raytracer.cs:165-169
    } else {
      // Stochastic branch selection (Raytracer.cs:177-229).
      float ray_rand = u[3 * p.R] * total;
      bool pick_refr = refr_lum != 0.f && (ray_rand - refr_lum <= 0.f);
      float r2 = ray_rand - refr_lum;
      bool pick_spec =
          !pick_refr && spec_lum != 0.f && (r2 - spec_lum <= 0.f);
      float r3 = r2 - spec_lum;
      bool pick_diff =
          !pick_refr && !pick_spec && l_d != 0.f && (r3 - l_d <= 0.f);
      if (pick_refr) {
        // Transmission (Raytracer.cs:181-193).
        code = TRANSMITTED;
        out_dir = {rn.x * (-cos_out) + (d.x + rn.x * cos_i) * ratio,
                   rn.y * (-cos_out) + (d.y + rn.y * cos_i) * ratio,
                   rn.z * (-cos_out) + (d.z + rn.z * cos_i) * ratio};
        new_tint = best.inside ? V3{1.f, 1.f, 1.f}
                               : V3{mat[9], mat[10], mat[11]};
      } else if (pick_spec) {
        // Specular with rough-normal fail (Raytracer.cs:194-209).
        float k2 = 2.f * cos_i;
        out_dir = {d.x + rn.x * k2, d.y + rn.y * k2, d.z + rn.z * k2};
        bool spec_ok = (out_dir.x * best.nrm.x + out_dir.y * best.nrm.y +
                        out_dir.z * best.nrm.z) > 0.f;
        code = spec_ok ? SPECULAR : SPECULAR_FAIL;
        new_tint = {mat[6], mat[7], mat[8]};
      } else if (pick_diff) {
        // Diffuse (Raytracer.cs:210-219) around the TRUE normal.
        code = DIFFUSE;
        out_dir = create_horizon_cs(best.nrm, u[4 * p.R], u[5 * p.R],
                                    u[6 * p.R]);
        new_tint = {mat[3], mat[4], mat[5]};
      } else {
        code = EMISSION;
      }
    }
    write_tape<WANT_TAPE>(p, i, r, best.prim, code | bits, best.nrm);
    ++i;
    if (code != TRANSMITTED && code != SPECULAR && code != DIFFUSE) {
      result = te;  // terminal: black, emission pick or failed specular
      break;
    }

    // Energy compensation (Raytracer.cs:238-240), then the next ray.
    float comp = fmaxf(total, 1.f);
    tint = {tint.x * (new_tint.x * comp), tint.y * (new_tint.y * comp),
            tint.z * (new_tint.z * comp)};
    o = best.pos;
    d = out_dir;
    pv_prim = best.prim;
    pv_pos = best.pos;
    pv_nrm = best.nrm;
    pv_in = best.inside;
  }

  // Bounces this path never reached: prim -1, flags 0, zero normals.
  if (WANT_TAPE)
    for (; i < p.n_bounces; ++i) write_tape<WANT_TAPE>(p, i, r, -1, 0, zero);

  p.color[3 * r] = result.x;
  p.color[3 * r + 1] = result.y;
  p.color[3 * r + 2] = result.z;
  p.miss[r] = miss;
}

template <bool W, bool A, bool S, bool C>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  dim3 grid((p.R + BLOCK - 1) / BLOCK);
  trace_fused_kernel<W, A, S, C><<<grid, BLOCK, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool W, bool A, bool S>
cudaError_t pick_c(const Params& p, size_t smem, cudaStream_t st, bool c) {
  return c ? launch<W, A, S, true>(p, smem, st)
           : launch<W, A, S, false>(p, smem, st);
}

template <bool W, bool A>
cudaError_t pick_s(const Params& p, size_t smem, cudaStream_t st, bool s,
                   bool c) {
  return s ? pick_c<W, A, true>(p, smem, st, c)
           : pick_c<W, A, false>(p, smem, st, c);
}

template <bool W>
cudaError_t pick_a(const Params& p, size_t smem, cudaStream_t st, bool a,
                   bool s, bool c) {
  return a ? pick_s<W, true>(p, smem, st, s, c)
           : pick_s<W, false>(p, smem, st, s, c);
}

}  // namespace rtc

// C entry point, loaded with ctypes.  Launches on `stream` and returns the
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rtc_trace_fused(
    const float* ray_o, const float* ray_d, const float* u, const float* tf,
    const int* ti, const float* sf, const int* si, const float* pf,
    const int* pi, const float* mf, const float* scf, float* color, int* miss,
    int* tape_prim, int* tape_flags, float* tape_nx, float* tape_ny,
    float* tape_nz, int R, int T, int S, int P, int N, int n_bounces,
    int recursion, float eps_behind, float eps2, int ambient_is_miss,
    int want_tape, int any_smooth, int coplanar, void* stream) {
  if (R <= 0) return 0;
  rtc::Params p{ray_o, ray_d, u, tf, ti, sf, si, pf, pi, mf, scf,
                color, miss, tape_prim, tape_flags, tape_nx, tape_ny, tape_nz,
                R, T, S, P, N, n_bounces, recursion, eps_behind, eps2};
  size_t n_float = (size_t)T * rtc::TRI_F + (size_t)S * rtc::SPH_F +
                   (size_t)P * rtc::PL_F + (size_t)N * rtc::MAT_F + rtc::SC_F;
  size_t n_int = (size_t)(T + S + P) * rtc::INT_F;
  size_t smem = (n_float + n_int) * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool a = ambient_is_miss != 0, s = any_smooth != 0, c = coplanar != 0;
  return static_cast<int>(want_tape ? rtc::pick_a<true>(p, smem, st, a, s, c)
                                    : rtc::pick_a<false>(p, smem, st, a, s, c));
}
