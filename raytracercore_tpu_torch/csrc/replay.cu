// Replay kernels of the train path: a recorded path's shading, forward and
// backward, one thread per path.
//
// Replace the TPU kernels raytracercore_tpu/render/replay_kernel.py:
// _make_fwd_kernel (pl.pallas_call in _run_fwd) and _make_bwd_kernel
// (pl.pallas_call in _run_bwd) together with the one-hot scatter of
// _bwd_core.  Their plain versions are replay_fwd_reference and
// replay_bwd_reference in raytracercore_tpu_torch/render/replay_kernel.py;
// the wrappers replay_fwd and replay_bwd there launch these kernels.
//
// Per bounce i the tape gives the branch code, the inside/Fresnel-live
// bits, the winning primitive (its material row) and the hit normal; with
// the uniforms and the [N,14] material table the path's colour is a
// closed-form function of the material table.  shade() and advance() are
// _bounce_fwd (renormalize at i % 3 == 0 including bounce 0);
// bounce_adjoint() transcribes the hand-written adjoint _bounce_bwd line
// for line.
//
// What bounds them on Hopper: per bounce a path reads 7 floats of
// uniforms and 5 words of tape (48 bytes) and does ~150 flops of shading
// (~3x that for the adjoint), so by these counts the forward sits near the
// memory side and the backward on fp32 issue and divergence; no hardware
// counter has confirmed it.  What the design does about it:
//   * the material table sits in shared memory (N <= 64 rows) and is read
//     by row, max(prim, 0) * 14 + c;
//   * the path state lives in registers; bounces the path never reached
//     (code Skipped) only renormalize;
//   * the backward keeps each bounce's entry (direction, tint) in a
//     per-thread array of MAX_REPLAY_BOUNCES entries (the wrapper raises
//     beyond it), sweeps back through the adjoint and adds dL/dg straight
//     into a per-block [N,14] shared accumulator (shared-memory atomics;
//     threads past R never touch it), which the block writes to its slice
//     of a [blocks,N,14] buffer that torch sums.  The TPU's [B*14,R]
//     cotangent tensor (302 MB at 700^2 rec10) never exists.
// The TPU kernels' (8,128) tiles, padding to BLOCK, unrolled N-way select
// gather and one-hot matmul scatter are not carried over.
//
// Floating point: fp32, built with -fmad=false and no fast math, in the
// plain version's operation order.  The backward's sums run in atomic
// order, so its last bits vary from run to run.

#include <cuda_runtime.h>
#include <math.h>

#include "shading.cuh"

namespace rtc {

constexpr int RP_MAT_F = 14;  // emission(3) diffuse(3) specular(3) refraction(3) ior shin
constexpr int REPLAY_BLOCK = 128;
constexpr int MAX_REPLAY_MATS = 64;
constexpr int MAX_REPLAY_BOUNCES = 32;
constexpr float SQRT_FLOOR = 1e-20f;  // vecmath.safe_sqrt

struct ReplayParams {
  const float* ray_d;  // [R,3]
  const float* u;      // [B,7,R]
  const int* prim;     // [B,R]
  const int* flags;    // [B,R]
  const float* nx;     // [B,R]
  const float* ny;
  const float* nz;
  const float* matf;   // [N,14]
  const float* scf;    // [4] air ior, ambient rgb
  int R, N, n_bounces;
};

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 renorm(V3 d) {
  float len = sqrtf(dot(d, d));
  return {d.x / len, d.y / len, d.z / len};
}

// What one bounce's shading computes before the path update, kept for the
// adjoint.
struct Shade {
  int code;
  bool inside, f_live, shin_special;
  float u0, ct, st;
  V3 nrm, horiz, rough;
  float den, q, ez, z, m1, s, cos_i;
  float l_s0, l_r0;
  float ior_in, ior_out, safe_out, ratio, m2, sq1, sin_out, m3, cos_out;
  float cos_f, cos_out_f, b_s, rs, b_p, rp, fres, total;
};

// _bounce_fwd up to total_lum.  d is the direction after renormalization.
__device__ __forceinline__ void shade(const ReplayParams& p, int i, int r,
                                      V3 d, const float* g, int flags,
                                      float air, Shade& sh) {
  const float* u = p.u + (size_t)i * 7 * p.R + r;  // channel c at u[c * R]
  const size_t at = (size_t)i * p.R + r;
  sh.code = flags & CODE_MASK;
  sh.inside = (flags & FLAG_INSIDE) != 0;
  sh.f_live = (flags & FLAG_FLIVE) != 0;
  sh.u0 = u[0];
  sh.ct = u[p.R];
  sh.st = u[2 * p.R];
  sh.nrm = {p.nx[at], p.ny[at], p.nz[at]};
  const float ior = g[12], shin = g[13];

  // RandomShine (Raytracer.cs:51-56): z = exp(ln U / shininess); 1 for
  // infinite shininess, 0 (the limit, ln U < 0) for shininess 0.
  sh.shin_special = isinf(shin) || shin == 0.f;
  sh.den = shin == 0.f ? 1.f : shin;
  sh.q = sh.u0 / sh.den;
  sh.ez = expf(sh.q);
  sh.z = isinf(shin) ? 1.f : (shin == 0.f ? 0.f : sh.ez);
  sh.horiz = create_horizontal(sh.nrm);
  sh.m1 = 1.f - sh.z * sh.z;
  sh.s = sqrtf(fmaxf(sh.m1, SQRT_FLOOR));
  V3 base = {sh.nrm.x * sh.z + sh.horiz.x * sh.s,
             sh.nrm.y * sh.z + sh.horiz.y * sh.s,
             sh.nrm.z * sh.z + sh.horiz.z * sh.s};
  sh.rough = rotate_cs(base, sh.nrm, sh.ct, sh.st);
  sh.cos_i = -dot(sh.rough, d);

  const float l_d = lum(g[3], g[4], g[5]);
  sh.l_s0 = lum(g[6], g[7], g[8]);
  sh.l_r0 = lum(g[9], g[10], g[11]);
  const float l_e = lum(g[0], g[1], g[2]);

  // Fresnel (Raytracer.cs:120-157), the branch decisions from the tape.
  sh.ior_in = sh.inside ? ior : air;
  sh.ior_out = sh.inside ? air : ior;
  sh.safe_out = sh.ior_out == 0.f ? 1.f : sh.ior_out;
  sh.ratio = sh.ior_in / sh.safe_out;
  sh.m2 = 1.f - sh.cos_i * sh.cos_i;
  sh.sq1 = sqrtf(fmaxf(sh.m2, SQRT_FLOOR));
  sh.sin_out = sh.ratio * sh.sq1;
  sh.m3 = 1.f - sh.sin_out * sh.sin_out;
  sh.cos_out = sqrtf(fmaxf(sh.m3, SQRT_FLOOR));
  sh.cos_f = sh.f_live ? sh.cos_i : 1.f;
  sh.cos_out_f = sh.f_live ? sh.cos_out : 1.f;
  sh.b_s = (sh.ior_out * sh.cos_f) + (sh.ior_in * sh.cos_out_f);
  sh.rs = ((sh.ior_out * sh.cos_f) - (sh.ior_in * sh.cos_out_f)) / sh.b_s;
  sh.b_p = (sh.ior_in * sh.cos_f) + (sh.ior_out * sh.cos_out_f);
  sh.rp = ((sh.ior_in * sh.cos_f) - (sh.ior_out * sh.cos_out_f)) / sh.b_p;
  sh.fres = (sh.rs * sh.rs + sh.rp * sh.rp) / 2.f;
  const float spec_lum = sh.f_live ? sh.l_s0 * sh.fres : sh.l_s0;
  const float refr_lum = sh.f_live ? sh.l_r0 * (1.f - sh.fres) : 0.f;
  sh.total = l_d + spec_lum + refr_lum + l_e;
}

__device__ __forceinline__ bool is_terminal(int code) {
  return code == EMISSION || code == SPECULAR_FAIL || code == PURE_BLACK ||
         code == RECURSION_COMPLETE;
}

// The rest of _bounce_fwd: result, direction and tint updates.
template <bool AIM>
__device__ __forceinline__ void advance(const ReplayParams& p, int i, int r,
                                        const Shade& sh, const float* g,
                                        V3 ambient, V3& d, V3& tint,
                                        V3& result) {
  const int code = sh.code;
  if (is_terminal(code))
    result = {tint.x * g[0], tint.y * g[1], tint.z * g[2]};
  if (!AIM && i != 0 && code == MISSED) result = ambient;
  if (code != TRANSMITTED && code != SPECULAR && code != DIFFUSE) return;
  V3 out, nt0;
  const V3 rn = sh.rough;
  if (code == TRANSMITTED) {
    out = {rn.x * (-sh.cos_out) + (d.x + rn.x * sh.cos_i) * sh.ratio,
           rn.y * (-sh.cos_out) + (d.y + rn.y * sh.cos_i) * sh.ratio,
           rn.z * (-sh.cos_out) + (d.z + rn.z * sh.cos_i) * sh.ratio};
    nt0 = sh.inside ? V3{1.f, 1.f, 1.f} : V3{g[9], g[10], g[11]};
  } else if (code == SPECULAR) {
    const float k2 = 2.f * sh.cos_i;
    out = {d.x + rn.x * k2, d.y + rn.y * k2, d.z + rn.z * k2};
    nt0 = {g[6], g[7], g[8]};
  } else {
    const float* u = p.u + (size_t)i * 7 * p.R + r;
    out = create_horizon_cs(sh.nrm, u[4 * p.R], u[5 * p.R], u[6 * p.R]);
    nt0 = {g[3], g[4], g[5]};
  }
  // Energy compensation (Raytracer.cs:238-240).
  const float comp = fmaxf(sh.total, 1.f);
  tint = {tint.x * (nt0.x * comp), tint.y * (nt0.y * comp),
          tint.z * (nt0.z * comp)};
  d = out;
}

// sqrt(max(x, floor))'s derivative times y_ct: 0 below the floor, half of
// it at the floor (maximum's tie rule).
__device__ __forceinline__ float safe_sqrt_bwd(float x, float y, float y_ct) {
  const float gate = x > SQRT_FLOOR ? 1.f : (x == SQRT_FLOOR ? 0.5f : 0.f);
  return y_ct * (0.5f / y) * gate;
}

// _bounce_bwd for a bounce that is not Skipped.  In: the cotangents of
// (d', tint', result') in d_ct, t_ct, r_ct; d is the renormalized entry
// direction, tint the entry tint.  Out: the cotangents of (d, tint,
// result) in the same variables, and of the 14 material channels in gct.
template <bool AIM>
__device__ __forceinline__ void bounce_adjoint(int i, const Shade& sh, V3 d,
                                               V3 tint, const float* g,
                                               V3& d_ct, V3& t_ct, V3& r_ct,
                                               float* gct) {
  const int code = sh.code;
  const V3 E = {g[0], g[1], g[2]}, D = {g[3], g[4], g[5]};
  const V3 S = {g[6], g[7], g[8]}, T = {g[9], g[10], g[11]};
  const V3 rn = sh.rough;
  const bool pick_refr = code == TRANSMITTED;
  const bool pick_spec = code == SPECULAR;
  const bool bounced = pick_refr || pick_spec || code == DIFFUSE;
  const bool terminal = is_terminal(code);
  const V3 nt0 = pick_refr ? (sh.inside ? V3{1.f, 1.f, 1.f} : T)
                           : (pick_spec ? S : D);
  const float comp = fmaxf(sh.total, 1.f);
  const V3 nt = {nt0.x * comp, nt0.y * comp, nt0.z * comp};
  const V3 zero = {0.f, 0.f, 0.f};
  V3 E_ct = zero, D_ct = zero, S_ct = zero, T_ct = zero;

  // d' = bounced ? out_dir : d;  tint' = bounced ? tint * new_tint : tint
  const V3 out_ct = bounced ? d_ct : zero;
  V3 dn_ct = bounced ? zero : d_ct;
  V3 tint_ct = bounced ? V3{t_ct.x * nt.x, t_ct.y * nt.y, t_ct.z * nt.z}
                       : t_ct;
  const V3 nt_ct = bounced
                       ? V3{t_ct.x * tint.x, t_ct.y * tint.y, t_ct.z * tint.z}
                       : zero;

  // new_tint = new_tint0 * comp;  comp = maximum(total, 1)
  const V3 nt0_ct = {nt_ct.x * comp, nt_ct.y * comp, nt_ct.z * comp};
  const float comp_ct = dot(nt_ct, nt0);
  const float total_ct =
      comp_ct * (sh.total > 1.f ? 1.f : (sh.total == 1.f ? 0.5f : 0.f));

  // new_tint0 = pick_refr ? (inside ? 1 : T) : pick_spec ? S : D
  if (pick_refr) {
    if (!sh.inside) T_ct = nt0_ct;
  } else if (pick_spec) {
    S_ct = nt0_ct;
  } else {
    D_ct = nt0_ct;
  }

  // out_dir = pick_refr ? refr_dir : pick_spec ? spec_dir : diff_dir
  const V3 refr_ct = pick_refr ? out_ct : zero;
  const V3 spec_ct = pick_spec ? out_ct : zero;

  // spec_dir = d + rough * (2 cos)
  const float k2 = 2.f * sh.cos_i;
  V3 rough_ct = {spec_ct.x * k2, spec_ct.y * k2, spec_ct.z * k2};
  dn_ct = {dn_ct.x + spec_ct.x, dn_ct.y + spec_ct.y, dn_ct.z + spec_ct.z};
  float cos_ct = 2.f * dot(spec_ct, rn);

  // refr_dir = rough * (-cos_out) + (d + rough * cos) * ratio
  float cos_out_ct = 0.f, ratio_ct = 0.f;
  {
    const float rc[3] = {refr_ct.x, refr_ct.y, refr_ct.z};
    const float rr[3] = {rn.x, rn.y, rn.z};
    const float dd[3] = {d.x, d.y, d.z};
    float ro[3] = {rough_ct.x, rough_ct.y, rough_ct.z};
    float dc[3] = {dn_ct.x, dn_ct.y, dn_ct.z};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float inner_ct = rc[k] * sh.ratio;
      ro[k] = ro[k] + rc[k] * (-sh.cos_out) + inner_ct * sh.cos_i;
      cos_out_ct = cos_out_ct - rc[k] * rr[k];
      ratio_ct = ratio_ct + rc[k] * (dd[k] + rr[k] * sh.cos_i);
      dc[k] = dc[k] + inner_ct;
      cos_ct = cos_ct + inner_ct * rr[k];
    }
    rough_ct = {ro[0], ro[1], ro[2]};
    dn_ct = {dc[0], dc[1], dc[2]};
  }

  // result' = ambient-miss ? ambient : terminal ? tint * E : result
  if (!AIM && i != 0 && code == MISSED) r_ct = zero;
  const V3 te_ct = terminal ? r_ct : zero;
  const V3 r_in = terminal ? zero : r_ct;
  tint_ct = {tint_ct.x + te_ct.x * E.x, tint_ct.y + te_ct.y * E.y,
             tint_ct.z + te_ct.z * E.z};
  E_ct = {E_ct.x + te_ct.x * tint.x, E_ct.y + te_ct.y * tint.y,
          E_ct.z + te_ct.z * tint.z};

  // total = diff_lum + spec_lum + refr_lum + emis_lum
  const float l_r0_ct = sh.f_live ? total_ct * (1.f - sh.fres) : 0.f;
  const float l_s0_ct = sh.f_live ? total_ct * sh.fres : total_ct;
  const float fres_ct =
      sh.f_live ? total_ct * sh.l_s0 - total_ct * sh.l_r0 : 0.f;
  const float lw[3] = {LUM_R, LUM_G, LUM_B};
  float e3[3] = {E_ct.x, E_ct.y, E_ct.z}, d3[3] = {D_ct.x, D_ct.y, D_ct.z};
  float s3[3] = {S_ct.x, S_ct.y, S_ct.z}, t3[3] = {T_ct.x, T_ct.y, T_ct.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d3[k] = d3[k] + total_ct * lw[k];
    e3[k] = e3[k] + total_ct * lw[k];
    s3[k] = s3[k] + l_s0_ct * lw[k];
    t3[k] = t3[k] + l_r0_ct * lw[k];
  }

  // fresnel = (rs^2 + rp^2) / 2;  rs = a_s / b_s;  rp = a_p / b_p
  const float rs_ct = fres_ct * sh.rs;
  const float rp_ct = fres_ct * sh.rp;
  const float a_s_ct = rs_ct / sh.b_s;
  const float b_s_ct = -rs_ct * sh.rs / sh.b_s;
  const float a_p_ct = rp_ct / sh.b_p;
  const float b_p_ct = -rp_ct * sh.rp / sh.b_p;
  float ior_out_ct =
      (a_s_ct + b_s_ct) * sh.cos_f + (b_p_ct - a_p_ct) * sh.cos_out_f;
  float ior_in_ct =
      (b_s_ct - a_s_ct) * sh.cos_out_f + (a_p_ct + b_p_ct) * sh.cos_f;
  const float cos_f_ct =
      (a_s_ct + b_s_ct) * sh.ior_out + (a_p_ct + b_p_ct) * sh.ior_in;
  const float cos_out_f_ct =
      (b_s_ct - a_s_ct) * sh.ior_in + (b_p_ct - a_p_ct) * sh.ior_out;
  cos_ct = cos_ct + (sh.f_live ? cos_f_ct : 0.f);
  cos_out_ct = cos_out_ct + (sh.f_live ? cos_out_f_ct : 0.f);

  // cos_out = safe_sqrt(1 - sin_out^2);  sin_out = ratio * safe_sqrt(1 - cos^2)
  const float sin_out_ct =
      -2.f * sh.sin_out * safe_sqrt_bwd(sh.m3, sh.cos_out, cos_out_ct);
  ratio_ct = ratio_ct + sin_out_ct * sh.sq1;
  cos_ct = cos_ct -
           2.f * sh.cos_i * safe_sqrt_bwd(sh.m2, sh.sq1, sin_out_ct * sh.ratio);

  // ratio = ior_in / safe_out;  safe_out = ior_out == 0 ? 1 : ior_out
  ior_in_ct = ior_in_ct + ratio_ct / sh.safe_out;
  ior_out_ct = ior_out_ct +
               (sh.ior_out == 0.f ? 0.f : -ratio_ct * sh.ratio / sh.safe_out);
  const float ior_ct = sh.inside ? ior_in_ct : ior_out_ct;

  // cos = -(rough . d)
  rough_ct = {rough_ct.x - cos_ct * d.x, rough_ct.y - cos_ct * d.y,
              rough_ct.z - cos_ct * d.z};
  dn_ct = {dn_ct.x - cos_ct * rn.x, dn_ct.y - cos_ct * rn.y,
           dn_ct.z - cos_ct * rn.z};

  // rough = base ct + (n x base) st + n ((n . base)(1 - ct))
  const V3 n = sh.nrm;
  const V3 cxn = {rough_ct.y * n.z - rough_ct.z * n.y,
                  rough_ct.z * n.x - rough_ct.x * n.z,
                  rough_ct.x * n.y - rough_ct.y * n.x};
  const float kd_ct = dot(rough_ct, n) * (1.f - sh.ct);
  const V3 base_ct = {rough_ct.x * sh.ct + cxn.x * sh.st + n.x * kd_ct,
                      rough_ct.y * sh.ct + cxn.y * sh.st + n.y * kd_ct,
                      rough_ct.z * sh.ct + cxn.z * sh.st + n.z * kd_ct};
  // base = n z + horiz s;  s = safe_sqrt(1 - z^2)
  float z_ct = dot(base_ct, n);
  z_ct = z_ct - 2.f * sh.z * safe_sqrt_bwd(sh.m1, sh.s, dot(base_ct, sh.horiz));
  // z = exp(u0 / shininess) unless shininess is +inf or 0
  const float q_ct = sh.shin_special ? 0.f : z_ct * sh.ez;
  const float shin_ct = -(q_ct * sh.q) / sh.den;

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gct[k] = e3[k];
    gct[3 + k] = d3[k];
    gct[6 + k] = s3[k];
    gct[9 + k] = t3[k];
  }
  gct[12] = ior_ct;
  gct[13] = shin_ct;
  d_ct = dn_ct;
  t_ct = tint_ct;
  r_ct = r_in;
}

// Adjoint of d = d_in / |d_in|.
__device__ __forceinline__ V3 renorm_adjoint(V3 d_in, V3 dn_ct) {
  const float len = sqrtf(dot(d_in, d_in));
  const float dot_ct = dot(dn_ct, d_in);
  const float l2_ct = (-dot_ct / (len * len)) * (0.5f / len);
  return {dn_ct.x / len + 2.f * d_in.x * l2_ct,
          dn_ct.y / len + 2.f * d_in.y * l2_ct,
          dn_ct.z / len + 2.f * d_in.z * l2_ct};
}

__device__ __forceinline__ void load_table(const ReplayParams& p,
                                           float* s_mf) {
  for (int k = threadIdx.x; k < p.N * RP_MAT_F; k += blockDim.x)
    s_mf[k] = p.matf[k];
}

template <bool AIM>
__global__ void __launch_bounds__(REPLAY_BLOCK)
    replay_fwd_kernel(ReplayParams p, float* color, int* miss) {
  __shared__ float s_mf[MAX_REPLAY_MATS * RP_MAT_F];
  load_table(p, s_mf);
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.R) return;

  const float air = p.scf[0];
  const V3 ambient = {p.scf[1], p.scf[2], p.scf[3]};
  V3 d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
  V3 tint = {1.f, 1.f, 1.f};
  V3 result = {0.f, 0.f, 0.f};
  int m = 0;
  for (int i = 0; i < p.n_bounces; ++i) {
    if (i % 3 == 0) d = renorm(d);  // Raytracer.cs:74-75
    const size_t at = (size_t)i * p.R + r;
    const int flags = p.flags[at];
    if ((flags & CODE_MASK) == SKIPPED) continue;
    const float* g = s_mf + max(p.prim[at], 0) * RP_MAT_F;
    Shade sh;
    shade(p, i, r, d, g, flags, air, sh);
    advance<AIM>(p, i, r, sh, g, ambient, d, tint, result);
    if ((AIM || i == 0) && sh.code == MISSED) m = 1;
  }
  color[3 * r] = result.x;
  color[3 * r + 1] = result.y;
  color[3 * r + 2] = result.z;
  miss[r] = m;
}

template <bool AIM>
__global__ void __launch_bounds__(REPLAY_BLOCK)
    replay_bwd_kernel(ReplayParams p, const float* ct, float* partial) {
  __shared__ float s_mf[MAX_REPLAY_MATS * RP_MAT_F];
  __shared__ float s_acc[MAX_REPLAY_MATS * RP_MAT_F];
  load_table(p, s_mf);
  for (int k = threadIdx.x; k < p.N * RP_MAT_F; k += blockDim.x)
    s_acc[k] = 0.f;
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < p.R) {
    const float air = p.scf[0];
    const V3 ambient = {p.scf[1], p.scf[2], p.scf[3]};
    V3 d_st[MAX_REPLAY_BOUNCES], t_st[MAX_REPLAY_BOUNCES];

    // Forward sweep: keep each bounce's entry (direction, tint).
    V3 d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
    V3 tint = {1.f, 1.f, 1.f};
    V3 result = {0.f, 0.f, 0.f};
    for (int i = 0; i < p.n_bounces; ++i) {
      d_st[i] = d;
      t_st[i] = tint;
      if (i % 3 == 0) d = renorm(d);
      const size_t at = (size_t)i * p.R + r;
      const int flags = p.flags[at];
      if ((flags & CODE_MASK) == SKIPPED) continue;
      const float* g = s_mf + max(p.prim[at], 0) * RP_MAT_F;
      Shade sh;
      shade(p, i, r, d, g, flags, air, sh);
      advance<AIM>(p, i, r, sh, g, ambient, d, tint, result);
    }

    // Reverse sweep through the adjoint, adding dL/dg into the block's
    // [N,14] accumulator.
    V3 d_ct = {0.f, 0.f, 0.f}, t_ct = {0.f, 0.f, 0.f};
    V3 r_ct = {ct[3 * r], ct[3 * r + 1], ct[3 * r + 2]};
    for (int i = p.n_bounces - 1; i >= 0; --i) {
      const V3 d_in = d_st[i];
      const bool rn = i % 3 == 0;
      const size_t at = (size_t)i * p.R + r;
      const int flags = p.flags[at];
      if ((flags & CODE_MASK) != SKIPPED) {
        const int row = max(p.prim[at], 0);
        const float* g = s_mf + row * RP_MAT_F;
        const V3 dn = rn ? renorm(d_in) : d_in;
        Shade sh;
        shade(p, i, r, dn, g, flags, air, sh);
        float gct[RP_MAT_F];
        bounce_adjoint<AIM>(i, sh, dn, t_st[i], g, d_ct, t_ct, r_ct, gct);
        float* acc = s_acc + row * RP_MAT_F;
#pragma unroll
        for (int c = 0; c < RP_MAT_F; ++c)
          if (gct[c] != 0.f) atomicAdd(acc + c, gct[c]);
      }
      if (rn) d_ct = renorm_adjoint(d_in, d_ct);
    }
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * p.N * RP_MAT_F;
  for (int k = threadIdx.x; k < p.N * RP_MAT_F; k += blockDim.x)
    out[k] = s_acc[k];
}

}  // namespace rtc

namespace {

bool bad_sizes(int R, int N, int n_bounces) {
  return R <= 0 || N <= 0 || N > rtc::MAX_REPLAY_MATS || n_bounces <= 0 ||
         n_bounces > rtc::MAX_REPLAY_BOUNCES;
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches on `stream` and
// returns the cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for sizes the kernels do not take.
extern "C" int rtc_replay_fwd(const float* ray_d, const float* u,
                              const int* prim, const int* flags,
                              const float* nx, const float* ny,
                              const float* nz, const float* matf,
                              const float* scf, float* color, int* miss,
                              int R, int N, int n_bounces,
                              int ambient_is_miss, void* stream) {
  if (bad_sizes(R, N, n_bounces)) return (int)cudaErrorInvalidValue;
  rtc::ReplayParams p{ray_d, u, prim, flags, nx, ny, nz, matf, scf,
                      R, N, n_bounces};
  dim3 grid((R + rtc::REPLAY_BLOCK - 1) / rtc::REPLAY_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ambient_is_miss)
    rtc::replay_fwd_kernel<true><<<grid, rtc::REPLAY_BLOCK, 0, st>>>(
        p, color, miss);
  else
    rtc::replay_fwd_kernel<false><<<grid, rtc::REPLAY_BLOCK, 0, st>>>(
        p, color, miss);
  return (int)cudaGetLastError();
}

extern "C" int rtc_replay_bwd(const float* ray_d, const float* u,
                              const int* prim, const int* flags,
                              const float* nx, const float* ny,
                              const float* nz, const float* matf,
                              const float* scf, const float* ct,
                              float* partial, int R, int N, int n_bounces,
                              int n_blocks, int ambient_is_miss,
                              void* stream) {
  if (bad_sizes(R, N, n_bounces) ||
      n_blocks != (R + rtc::REPLAY_BLOCK - 1) / rtc::REPLAY_BLOCK)
    return (int)cudaErrorInvalidValue;
  rtc::ReplayParams p{ray_d, u, prim, flags, nx, ny, nz, matf, scf,
                      R, N, n_bounces};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ambient_is_miss)
    rtc::replay_bwd_kernel<true><<<n_blocks, rtc::REPLAY_BLOCK, 0, st>>>(
        p, ct, partial);
  else
    rtc::replay_bwd_kernel<false><<<n_blocks, rtc::REPLAY_BLOCK, 0, st>>>(
        p, ct, partial);
  return (int)cudaGetLastError();
}
