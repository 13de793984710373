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
// uniforms and 5 words of tape (48 bytes; the forward needs 44 of them:
// uniform channel 3 was spent by the recorder) and does ~150 flops of
// shading (~3x that for the adjoint), so by these counts the forward sits
// on the memory side and the backward on fp32 issue and divergence.  Paths
// end after 1 to n_bounces bounces (5.93 of 11 on average on the Cornell
// scene of chip_smoke.py), and a warp runs until its longest path ends.
// One thread per path with a chain of dependent loads per bounce (the code,
// then the rest, then the material row) keeps few bytes in flight: the
// forward was latency-bound.  What the design does about it:
//   * the forward stops a path after its end code (every recorder writes
//     Skipped on each bounce after it) and so reads only the bounces a
//     path reaches; it reads bounce i + 1's tape and uniforms (none of it
//     depends on the path's state) before it shades bounce i, so two
//     bounces' loads are in flight per thread; it reads the material rows
//     from device memory through L1 at every table size (a row is 56
//     bytes, the table at most 2.6 MB on the main paths) and launches one
//     block per 128 paths, which leaves the resident blocks to the card
//     (6 per SM by its registers);
//   * the backward keeps the material table in dynamic shared memory
//     (N <= 768 rows, with its accumulator 86 KB, above the 48 KB default,
//     hence cudaFuncSetAttribute below) and reads it by row,
//     max(prim, 0) * 14 + c;
//   * a larger table (a mesh has one material row per triangle: 46,082
//     rows are 2.6 MB) fits no shared memory: in the backward's
//     global-table mode the rows are read from device memory, one block
//     per 128 paths, and dL/dg goes with atomics into ONE [N,14]
//     accumulator in device memory, in double (native on sm_90): an f32
//     atomic sum over 10^6 paths is ~2e-5 off, more than the gradient gate
//     of 1e-5;
//   * a block walks the paths in strides of the grid, so the caller picks
//     the grid: for the backward one block per 128 paths for a small
//     table, and for a large one only as many blocks as stay resident, so
//     that the table is copied (and the accumulator written out) once per
//     resident block and not once per 128 paths;
//   * the path state lives in registers; in the backward, bounces the path
//     never reached (code Skipped) only renormalize;
//   * the backward keeps each bounce's entry (direction, tint) in shared
//     memory, [bounce][6][thread] (33.8 KB a block at 11 bounces), where
//     that leaves as many blocks resident as a stash in local memory (the
//     wrapper asks rtc_replay_bwd_blocks_per_sm for both), else in local
//     memory (up to MAX_REPLAY_BOUNCES, which the wrapper enforces; deeper
//     shared stashes cost blocks and time), sweeps back through
//     the adjoint and adds dL/dg straight into a per-block [N,14] shared
//     accumulator (shared-memory atomics; threads past R never touch it),
//     which the block writes to its slice of a [blocks,N,14] buffer that
//     torch sums.  The TPU's [B*14,R] cotangent tensor (302 MB at 700^2
//     rec10) never exists;
//   * for 65-768 material rows, where at most two blocks of 128 threads
//     fit on an SM beside their table, accumulator and stash (one above
//     ~730 rows at 11 bounces), the backward regenerates paths
//     (replay_bwd_regen_kernel): a lane that finishes its path's reverse
//     sweep takes the next path index from a counter, so the few resident
//     warps do not idle on short paths.  Its persistent grid has as many
//     blocks per SM as rtc_replay_bwd_blocks_per_sm reports.  With a small
//     table, or the global one, more warps are resident and the plain
//     kernel is faster (PERF.md section 6).
// Tried and not kept (PERF.md section 6): in the backward, the lanes of a
// warp on one row summed with shuffles before one atomic, per-warp private
// accumulators, a persistent grid for a small table, path regeneration at
// every table size; in the forward, the table in shared memory (on a
// persistent grid of the card's resident blocks or one block per 128
// paths), a persistent grid with the table in device memory, a staging
// ring of 1-D bulk copies (TMA) on mbarriers, and register caps of 72 and
// 64 (7 and 8 blocks per SM).
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
constexpr int MAX_REPLAY_MATS = 768;
constexpr size_t DEFAULT_SMEM = 48 * 1024;  // dynamic shared memory allowed unasked
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

// What one bounce of one path reads of the tape and the uniforms: none of it
// depends on the path's state, so it can be read ahead of the shading.
struct BounceIn {
  int flags, prim;
  V3 nrm;
  float u0, ct, st;  // uniform channels 0-2 (shine, azimuth cos and sin)
  V3 du;             // channels 4-6 (the diffuse direction's z, cos, sin)
};

__device__ __forceinline__ BounceIn load_bounce(const ReplayParams& p, int i,
                                                int r) {
  const float* u = p.u + (size_t)i * 7 * p.R + r;  // channel c at u[c * R]
  const size_t at = (size_t)i * p.R + r;
  BounceIn b;
  b.flags = p.flags[at];
  b.prim = p.prim[at];
  b.nrm = {p.nx[at], p.ny[at], p.nz[at]};
  b.u0 = u[0];
  b.ct = u[p.R];
  b.st = u[2 * p.R];
  b.du = {u[4 * p.R], u[5 * p.R], u[6 * p.R]};
  return b;
}

// _bounce_fwd up to total_lum.  d is the direction after renormalization;
// (u0, ct, st) are the bounce's uniform channels 0-2, nrm its hit normal.
__device__ __forceinline__ void shade_v(V3 d, const float* g, int flags,
                                        float u0, float ct, float st, V3 nrm,
                                        float air, Shade& sh) {
  sh.code = flags & CODE_MASK;
  sh.inside = (flags & FLAG_INSIDE) != 0;
  sh.f_live = (flags & FLAG_FLIVE) != 0;
  sh.u0 = u0;
  sh.ct = ct;
  sh.st = st;
  sh.nrm = nrm;
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

// shade_v on bounce i of path r, its inputs read from the tape and uniforms.
__device__ __forceinline__ void shade(const ReplayParams& p, int i, int r,
                                      V3 d, const float* g, int flags,
                                      float air, Shade& sh) {
  const float* u = p.u + (size_t)i * 7 * p.R + r;
  const size_t at = (size_t)i * p.R + r;
  shade_v(d, g, flags, u[0], u[p.R], u[2 * p.R],
          V3{p.nx[at], p.ny[at], p.nz[at]}, air, sh);
}

__device__ __forceinline__ bool is_terminal(int code) {
  return code == EMISSION || code == SPECULAR_FAIL || code == PURE_BLACK ||
         code == RECURSION_COMPLETE;
}

// The codes after which a path goes on to the next bounce.
__device__ __forceinline__ bool is_bounce(int code) {
  return code == TRANSMITTED || code == SPECULAR || code == DIFFUSE;
}

// The rest of _bounce_fwd: result, direction and tint updates.  diff_u()
// gives uniform channels 4-6, read only on a Diffuse bounce.
template <bool AIM, typename DiffU>
__device__ __forceinline__ void advance_with(int i, const Shade& sh,
                                             const float* g, V3 ambient,
                                             V3& d, V3& tint, V3& result,
                                             DiffU diff_u) {
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
    const V3 du = diff_u();
    out = create_horizon_cs(sh.nrm, du.x, du.y, du.z);
    nt0 = {g[3], g[4], g[5]};
  }
  // Energy compensation (Raytracer.cs:238-240).
  const float comp = fmaxf(sh.total, 1.f);
  tint = {tint.x * (nt0.x * comp), tint.y * (nt0.y * comp),
          tint.z * (nt0.z * comp)};
  d = out;
}

// advance_with on bounce i of path r, channels 4-6 read from the uniforms.
template <bool AIM>
__device__ __forceinline__ void advance(const ReplayParams& p, int i, int r,
                                        const Shade& sh, const float* g,
                                        V3 ambient, V3& d, V3& tint,
                                        V3& result) {
  advance_with<AIM>(i, sh, g, ambient, d, tint, result, [&]() {
    const float* u = p.u + (size_t)i * 7 * p.R + r;
    return V3{u[4 * p.R], u[5 * p.R], u[6 * p.R]};
  });
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

// The forward of path r, the material rows read from device memory
// (through L1; the table is at most 2.6 MB on the main paths and stays in
// L2).  The path stops after its first code that does not bounce
// (Emission, SpecularFail, PureBlack, RecursionComplete, Missed): every
// recorder writes Skipped on each bounce after it
// (tests/test_torch_replay_fwd.py), so no code past the path's end is
// read.  Bounce i + 1's inputs (BounceIn) are loaded before bounce i is
// shaded, where bounce i's code says the path goes on.
template <bool AIM>
__device__ __forceinline__ void fwd_path(const ReplayParams& p, int r,
                                         float air, V3 ambient, float* color,
                                         int* miss) {
  V3 d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
  V3 tint = {1.f, 1.f, 1.f};
  V3 result = {0.f, 0.f, 0.f};
  int m = 0;
  BounceIn cur = load_bounce(p, 0, r);
  for (int i = 0;; ++i) {
    const int code = cur.flags & CODE_MASK;
    if (code == SKIPPED) break;
    const bool more = is_bounce(code) && i + 1 < p.n_bounces;
    BounceIn nxt = cur;
    if (more) nxt = load_bounce(p, i + 1, r);  // in flight while we shade
    if (i % 3 == 0) d = renorm(d);             // Raytracer.cs:74-75
    const float* g = p.matf + max(cur.prim, 0) * RP_MAT_F;
    Shade sh;
    shade_v(d, g, cur.flags, cur.u0, cur.ct, cur.st, cur.nrm, air, sh);
    advance_with<AIM>(i, sh, g, ambient, d, tint, result,
                      [&]() { return cur.du; });
    if ((AIM || i == 0) && code == MISSED) m = 1;
    if (!more) break;
    cur = nxt;
  }
  color[3 * r] = result.x;
  color[3 * r + 1] = result.y;
  color[3 * r + 2] = result.z;
  miss[r] = m;
}

template <bool AIM>
__global__ void __launch_bounds__(REPLAY_BLOCK)
    replay_fwd_kernel(ReplayParams p, float* color, int* miss) {
  const float air = p.scf[0];
  const V3 ambient = {p.scf[1], p.scf[2], p.scf[3]};
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < p.R;
       r += gridDim.x * blockDim.x)
    fwd_path<AIM>(p, r, air, ambient, color, miss);
}

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int STASH_F = 6;  // a bounce's entry direction and tint

// A bounce's entry (direction, tint) in the thread's stash `my`, and
// back: SH, the thread's column of the shared stash [bounce][6][thread]
// (stride REPLAY_BLOCK); else the thread's own array in local memory
// (stride 1).
template <bool SH>
__device__ __forceinline__ void stash_entry(float* my, int i, V3 d, V3 t) {
  constexpr int S = SH ? REPLAY_BLOCK : 1;
  float* e = my + STASH_F * i * S;
  e[0] = d.x;
  e[S] = d.y;
  e[2 * S] = d.z;
  e[3 * S] = t.x;
  e[4 * S] = t.y;
  e[5 * S] = t.z;
}

template <bool SH>
__device__ __forceinline__ void stashed_entry(const float* my, int i, V3& d,
                                              V3& t) {
  constexpr int S = SH ? REPLAY_BLOCK : 1;
  const float* e = my + STASH_F * i * S;
  d = {e[0], e[S], e[2 * S]};
  t = {e[3 * S], e[4 * S], e[5 * S]};
}
// `partial`: [blocks,N,14] floats, one slice per block; GLOBAL: one [N,14]
// accumulator of doubles, zeroed by the caller, that every block adds into.
// SH: the bounce entries (direction, tint) live in shared memory,
// [bounce][6][thread]; else in local memory.
template <bool AIM, bool GLOBAL, bool SH>
__global__ void __launch_bounds__(REPLAY_BLOCK)
    replay_bwd_kernel(ReplayParams p, const float* ct, void* partial) {
  // [N,14] table, then the [N,14] accumulator (both only without GLOBAL),
  // then the stash (SH).
  extern __shared__ float s_tab[];
  const float* s_mf = p.matf;
  float* s_acc = nullptr;
  float* stash = s_tab;
  double* g_acc = static_cast<double*>(partial);
  if (!GLOBAL) {
    s_acc = s_tab + p.N * RP_MAT_F;
    stash = s_acc + p.N * RP_MAT_F;
    load_table(p, s_tab);
    for (int k = threadIdx.x; k < p.N * RP_MAT_F; k += blockDim.x)
      s_acc[k] = 0.f;
    __syncthreads();
    s_mf = s_tab;
  }
  float loc[SH ? 1 : MAX_REPLAY_BOUNCES * STASH_F];
  float* my = SH ? stash + threadIdx.x : loc;

  const float air = p.scf[0];
  const V3 ambient = {p.scf[1], p.scf[2], p.scf[3]};
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < p.R;
       r += gridDim.x * blockDim.x) {
    // Forward sweep: keep each bounce's entry (direction, tint).
    V3 d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
    V3 tint = {1.f, 1.f, 1.f};
    V3 result = {0.f, 0.f, 0.f};
    for (int i = 0; i < p.n_bounces; ++i) {
      stash_entry<SH>(my, i, d, tint);
      if (i % 3 == 0) d = renorm(d);
      const size_t at = (size_t)i * p.R + r;
      const int flags = p.flags[at];
      if ((flags & CODE_MASK) == SKIPPED) continue;
      const float* g = s_mf + max(p.prim[at], 0) * RP_MAT_F;
      Shade sh;
      shade(p, i, r, d, g, flags, air, sh);
      advance<AIM>(p, i, r, sh, g, ambient, d, tint, result);
    }

    // Reverse sweep through the adjoint, adding dL/dg into the
    // accumulator.
    V3 d_ct = {0.f, 0.f, 0.f}, t_ct = {0.f, 0.f, 0.f};
    V3 r_ct = {ct[3 * r], ct[3 * r + 1], ct[3 * r + 2]};
    for (int i = p.n_bounces - 1; i >= 0; --i) {
      V3 d_in, t_in;
      stashed_entry<SH>(my, i, d_in, t_in);
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
        bounce_adjoint<AIM>(i, sh, dn, t_in, g, d_ct, t_ct, r_ct, gct);
#pragma unroll
        for (int c = 0; c < RP_MAT_F; ++c) {
          if (gct[c] == 0.f) continue;
          if (GLOBAL)
            atomicAdd(g_acc + (size_t)row * RP_MAT_F + c, (double)gct[c]);
          else
            atomicAdd(s_acc + row * RP_MAT_F + c, gct[c]);
        }
      }
      if (rn) d_ct = renorm_adjoint(d_in, d_ct);
    }
  }
  if (GLOBAL) return;
  __syncthreads();
  float* out =
      static_cast<float*>(partial) + (size_t)blockIdx.x * p.N * RP_MAT_F;
  for (int k = threadIdx.x; k < p.N * RP_MAT_F; k += blockDim.x)
    out[k] = s_acc[k];
}

// The backward with path regeneration: a lane runs its path's forward
// sweep up to the path's last live bounce, then the reverse sweep, then
// takes the next path index from a counter in device memory (one atomic
// per warp), so that a warp does not idle the lanes whose path is short
// while its longest path runs on.  The bounce entries live in shared
// memory ([bounce][6][thread]) with SH, else in local memory; every lane
// adds its own dL/dg.  The grid is persistent; `work` is one int32, zeroed
// by the caller on the stream.
template <bool AIM, bool GLOBAL, bool SH>
__global__ void __launch_bounds__(REPLAY_BLOCK)
    replay_bwd_regen_kernel(ReplayParams p, const float* ct, void* partial,
                            int* work) {
  extern __shared__ float s_tab[];
  const float* s_mf = p.matf;
  float* s_acc = nullptr;
  float* stash = s_tab;
  double* g_acc = static_cast<double*>(partial);
  if (!GLOBAL) {
    s_acc = s_tab + p.N * RP_MAT_F;
    stash = s_acc + p.N * RP_MAT_F;
    load_table(p, s_tab);
    for (int k = threadIdx.x; k < p.N * RP_MAT_F; k += blockDim.x)
      s_acc[k] = 0.f;
    __syncthreads();
    s_mf = s_tab;
  }
  float loc[SH ? 1 : MAX_REPLAY_BOUNCES * STASH_F];
  float* my = SH ? stash + threadIdx.x : loc;
  const float air = p.scf[0];
  const V3 ambient = {p.scf[1], p.scf[2], p.scf[3]};

  int r = -1, i = 0;
  bool fwd = true, more = true;
  V3 d = {0.f, 0.f, 1.f}, tint = {1.f, 1.f, 1.f}, result = {0.f, 0.f, 0.f};
  V3 d_ct = {0.f, 0.f, 0.f}, t_ct = {0.f, 0.f, 0.f}, r_ct = {0.f, 0.f, 0.f};
  while (true) {
    // Lanes without a path take the next one (warp-aggregated).
    const bool want = r < 0 && more;
    const unsigned m = __ballot_sync(FULL_MASK, want);
    if (m) {
      int base = 0;
      if ((threadIdx.x & 31) == 0) base = atomicAdd(work, __popc(m));
      base = __shfl_sync(FULL_MASK, base, 0);
      if (want) {
        r = base + __popc(m & ((1u << (threadIdx.x & 31)) - 1u));
        if (r >= p.R) {
          r = -1;
          more = false;
        } else {
          i = 0;
          fwd = true;
          d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
          tint = {1.f, 1.f, 1.f};
          result = {0.f, 0.f, 0.f};
        }
      }
    }
    if (!__any_sync(FULL_MASK, r >= 0)) break;
    if (r < 0) continue;

    if (fwd) {
      // Forward sweep: keep the entry (direction, tint) of bounce i; the
      // sweep ends at the first bounce the path never reached.
      int flags = 0;
      if (i < p.n_bounces) flags = p.flags[(size_t)i * p.R + r];
      if ((flags & CODE_MASK) == SKIPPED) {
        fwd = false;
        --i;
        d_ct = {0.f, 0.f, 0.f};
        t_ct = {0.f, 0.f, 0.f};
        r_ct = {ct[3 * r], ct[3 * r + 1], ct[3 * r + 2]};
        continue;
      }
      stash_entry<SH>(my, i, d, tint);
      if (i % 3 == 0) d = renorm(d);
      const float* g = s_mf + max(p.prim[(size_t)i * p.R + r], 0) * RP_MAT_F;
      Shade sh;
      shade(p, i, r, d, g, flags, air, sh);
      advance<AIM>(p, i, r, sh, g, ambient, d, tint, result);
      ++i;
      continue;
    }
    if (i < 0) {
      r = -1;  // the path is done
      continue;
    }
    // Reverse sweep, bounce i (live: the sweep starts at the last live one).
    V3 d_in, t_in;
    stashed_entry<SH>(my, i, d_in, t_in);
    const bool rn = i % 3 == 0;
    const size_t at = (size_t)i * p.R + r;
    const int flags = p.flags[at];
    const int row = max(p.prim[at], 0);
    const float* g = s_mf + row * RP_MAT_F;
    const V3 dn = rn ? renorm(d_in) : d_in;
    Shade sh;
    shade(p, i, r, dn, g, flags, air, sh);
    float gct[RP_MAT_F];
    bounce_adjoint<AIM>(i, sh, dn, t_in, g, d_ct, t_ct, r_ct, gct);
#pragma unroll
    for (int c = 0; c < RP_MAT_F; ++c) {
      if (gct[c] == 0.f) continue;
      if (GLOBAL)
        atomicAdd(g_acc + (size_t)row * RP_MAT_F + c, (double)gct[c]);
      else
        atomicAdd(s_acc + row * RP_MAT_F + c, gct[c]);
    }
    if (rn) d_ct = renorm_adjoint(d_in, d_ct);
    --i;
  }
  if (GLOBAL) return;
  __syncthreads();
  float* out =
      static_cast<float*>(partial) + (size_t)blockIdx.x * p.N * RP_MAT_F;
  for (int k = threadIdx.x; k < p.N * RP_MAT_F; k += blockDim.x)
    out[k] = s_acc[k];
}

}  // namespace rtc

namespace {

bool bad_sizes(int R, int N, int n_bounces, int n_blocks, int global_table) {
  return R <= 0 || N <= 0 || (!global_table && N > rtc::MAX_REPLAY_MATS) ||
         n_bounces <= 0 || n_bounces > rtc::MAX_REPLAY_BOUNCES ||
         n_blocks <= 0 ||
         n_blocks > (R + rtc::REPLAY_BLOCK - 1) / rtc::REPLAY_BLOCK;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, asking for
// more than the default first where needed.
template <typename... Args>
int launch(void (*kernel)(rtc::ReplayParams, Args...), int n_blocks,
           size_t smem, void* stream, rtc::ReplayParams p, Args... args) {
  if (smem > rtc::DEFAULT_SMEM) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_blocks, rtc::REPLAY_BLOCK, smem,
           static_cast<cudaStream_t>(stream)>>>(p, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

// The backward kernel of a table mode and stash; regeneration takes one
// more argument (the path counter).
template <bool AIM, bool GLOBAL>
auto bwd_kernel_of(bool sh) {
  return sh ? rtc::replay_bwd_kernel<AIM, GLOBAL, true>
            : rtc::replay_bwd_kernel<AIM, GLOBAL, false>;
}

auto bwd_kernel(bool aim, bool global_table, bool sh) {
  if (aim)
    return global_table ? bwd_kernel_of<true, true>(sh)
                        : bwd_kernel_of<true, false>(sh);
  return global_table ? bwd_kernel_of<false, true>(sh)
                      : bwd_kernel_of<false, false>(sh);
}

template <bool AIM, bool GLOBAL>
auto regen_kernel_of(bool sh) {
  return sh ? rtc::replay_bwd_regen_kernel<AIM, GLOBAL, true>
            : rtc::replay_bwd_regen_kernel<AIM, GLOBAL, false>;
}

auto regen_kernel(bool aim, bool global_table, bool sh) {
  if (aim)
    return global_table ? regen_kernel_of<true, true>(sh)
                        : regen_kernel_of<true, false>(sh);
  return global_table ? regen_kernel_of<false, true>(sh)
                      : regen_kernel_of<false, false>(sh);
}

// The table and its accumulator (without the global table) and the stash
// (with the shared stash).
size_t bwd_smem(int N, int n_bounces, int global_table, int shared_stash) {
  size_t floats = 0;
  if (shared_stash)
    floats += (size_t)n_bounces * rtc::STASH_F * rtc::REPLAY_BLOCK;
  if (!global_table) floats += 2 * (size_t)N * rtc::RP_MAT_F;
  return floats * sizeof(float);
}

// Blocks of `kernel` that stay resident on an SM with `smem` bytes of
// dynamic shared memory, as the card reports it.
template <typename K>
int blocks_per_sm(K kernel, size_t smem, int* out) {
  if (smem > rtc::DEFAULT_SMEM) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, rtc::REPLAY_BLOCK, smem);
}

}  // namespace

// C entry points, loaded with ctypes.  Each launches `n_blocks` blocks (at
// most one per REPLAY_BLOCK paths; fewer walk the paths in strides) on
// `stream` and returns the cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for sizes the kernels do not take.
// The forward reads the material rows from device memory at every N; the
// backward does so where `global_table` != 0 (any N), and its `partial` is
// then one zeroed [N,14] accumulator of doubles instead of [n_blocks,N,14]
// floats.
extern "C" int rtc_replay_fwd(const float* ray_d, const float* u,
                              const int* prim, const int* flags,
                              const float* nx, const float* ny,
                              const float* nz, const float* matf,
                              const float* scf, float* color, int* miss,
                              int R, int N, int n_bounces, int n_blocks,
                              int ambient_is_miss, void* stream) {
  if (bad_sizes(R, N, n_bounces, n_blocks, 1))
    return (int)cudaErrorInvalidValue;
  rtc::ReplayParams p{ray_d, u, prim, flags, nx, ny, nz, matf, scf,
                      R, N, n_bounces};
  return launch(ambient_is_miss ? rtc::replay_fwd_kernel<true>
                                : rtc::replay_fwd_kernel<false>,
                n_blocks, 0, stream, p, color, miss);
}

// `regen` != 0 launches the kernel with path regeneration (the grid is
// then persistent); `work` is one int32 of scratch, its path counter,
// zeroed here on the stream.  `shared_stash` != 0 keeps the bounce entries
// in shared memory, else in local memory.
extern "C" int rtc_replay_bwd(const float* ray_d, const float* u,
                              const int* prim, const int* flags,
                              const float* nx, const float* ny,
                              const float* nz, const float* matf,
                              const float* scf, const float* ct,
                              void* partial, int* work, int R, int N,
                              int n_bounces, int n_blocks,
                              int ambient_is_miss, int global_table,
                              int regen, int shared_stash, void* stream) {
  if (bad_sizes(R, N, n_bounces, n_blocks, global_table))
    return (int)cudaErrorInvalidValue;
  rtc::ReplayParams p{ray_d, u, prim, flags, nx, ny, nz, matf, scf,
                      R, N, n_bounces};
  const size_t smem = bwd_smem(N, n_bounces, global_table, shared_stash);
  const bool aim = ambient_is_miss != 0, gt = global_table != 0,
             sh = shared_stash != 0;
  if (regen) {
    cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int),
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return launch(regen_kernel(aim, gt, sh), n_blocks, smem, stream, p, ct,
                  partial, work);
  }
  return launch(bwd_kernel(aim, gt, sh), n_blocks, smem, stream, p, ct,
                partial);
}

// Resident blocks per SM of the backward kernel that rtc_replay_bwd
// launches with these arguments, at its shared memory (table, accumulator
// and stash): out[0].  A persistent (regenerating) grid has this many
// blocks on each SM.
extern "C" int rtc_replay_bwd_blocks_per_sm(int N, int n_bounces,
                                            int ambient_is_miss,
                                            int global_table, int regen,
                                            int shared_stash, int* out) {
  const size_t smem = bwd_smem(N, n_bounces, global_table, shared_stash);
  const bool aim = ambient_is_miss != 0, gt = global_table != 0,
             sh = shared_stash != 0;
  if (regen) return blocks_per_sm(regen_kernel(aim, gt, sh), smem, out);
  return blocks_per_sm(bwd_kernel(aim, gt, sh), smem, out);
}
