// Per-bounce closest-hit kernel (the select kernel): every live ray's query
// against every row of the three primitive tables.
//
// Replaces the TPU kernel raytracercore_tpu/intersect/pallas_select.py:
// _make_kernel (launched by _run through pl.pallas_call; public select_all
// and closest_hit_fused).  Its plain version is select_reference in
// raytracercore_tpu_torch/intersect/cuda_select.py; the Python wrappers
// select_all and closest_hit_fused there launch this kernel.
//
// It writes, per ray, each table's own winner (the closest surviving
// triangle row, sphere row with its near/far root, plane row; -1 for none)
// and the global record merged from the three (t, prim, inside, position,
// normal).  A table's winner does not depend on the other tables, so every
// table's scan keeps a winner of its own, and the three are merged with a
// strict t < in the order triangles -> spheres -> planes.  A ray whose
// origin is the integrator's parking point (config.PARKED_ORIGIN in all
// three coordinates) is a dead lane: it gets the no-hit record without a
// scan, in the kernel and in its plain version alike.
//
// What bounds it on Hopper: fp32 operations.  A live ray reads 53 B and
// writes 46 B, while every (ray, row) pair costs some 52 fp32 operations of
// Moller-Trumbore before its first exit: at 490,000 rays and 722 rows that
// is about 1.8e10 operations against 3e7 bytes.  The build keeps every
// multiply and add apart (-fmad=false: the plain version's rounding), so
// the card's 67 TFLOP/s, which counts a fused multiply-add as two
// operations, is at most half reachable here; the bound is stated against
// 67 TFLOP/s all the same.  Beside the arithmetic, each row costs its
// shared-memory loads and the correctly rounded 1/det.
//
// What the design does about it:
//   * dead lanes cost nothing: a small list kernel writes their records and
//     appends the live lanes to a list in device memory (one atomic per
//     warp); the main kernel reads the list's length on the device and
//     scans live rays only.  No count goes to the host;
//   * persistent blocks (as many as fit on the SMs; at two rays per thread
//     the registers are capped so that two blocks fit): a block copies the
//     tables into shared memory once, then its warps take work items from
//     a global atomic counter;
//   * an item is a batch of live rays and a slice of the rows: one slice
//     while the live rays fill the card, up to 32 when few rays are left
//     (late bounces), so that the rows of a few hundred rays are still
//     scanned by every SM instead of by a few warps one row after another.
//     A slice's winners meet in 64-bit (t, row) keys through atomicMin,
//     which keep what a scan of the rows in order keeps (smallest t, then
//     earliest row), and a finish kernel writes the records;
//   * a layout of its own (cuda_select.pack_select_tables): a triangle is
//     four float4 (v0 | prim, e1 | flags, e2, face normal), a sphere eight,
//     a plane two, so a row is read with 128-bit broadcast loads; the smooth
//     normals stay in device memory and are read for the winner only;
//   * two rays per thread (RPT): every row load serves both rays, and the
//     two independent chains hide the division's latency;
//   * a row that no ray of the warp can still hit (u, then v, out of range
//     for every ray, which the commit would discard) is left after a warp
//     vote; the vote on u is taken on a division-free pre-reject
//     (kernel_body.cuh surely_outside), before the correctly rounded 1/det;
//   * the scans keep only each table's (t, row); the winner's position and
//     normal are recomputed once, in the scans' own arithmetic.
// The TPU kernel's (8,128) ray tiles, its 128-lane padding and its unrolled
// table loops are TPU artefacts and are not carried over.
//
// Floating point: as the megakernel (fp32, -fmad=false, no fast math), in
// the plain version's operation order; rsqrt is written 1.0f / sqrtf.

#include <cuda_runtime.h>
#include <math.h>

#include "kernel_body.cuh"

namespace rtc {

constexpr int SELECT_WARPS = 8;
constexpr int SELECT_THREADS = 32 * SELECT_WARPS;
constexpr int LIST_THREADS = 256;
constexpr int RPT = 2;  // rays per thread
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
// Row widths of the select layout, in float4.
constexpr int TRI_Q = 4, COLD_Q = 3, SPH_Q = 8, PL_Q = 2;
// Flag bits of the select layout.
constexpr int SF_MIRROR = 1, SF_SMOOTH = 2, SF_INVERT = 4, SF_TWO_SIDED = 8;
constexpr float PARKED = 4e8f;  // config.PARKED_ORIGIN

struct SelectParams {
  const float* ray_o;             // [R,3]
  const float* ray_d;             // [R,3]
  const int* sk_prim;             // [R]   previous hit; null: no skip record
  const float* sk_pos;            // [R,3]
  const float* sk_nrm;            // [R,3]
  const unsigned char* sk_inside; // [R]   bool
  const float4* tri;              // [T,4]  v0|prim, e1|flags, e2|0, fn|0
  const float4* cold;             // [T,3]  n0|0, n1|0, n2|0
  const float4* sph;              // [S,8]  w2o(12) o2w(12) c r | prim flags
  const float4* pln;              // [P,2]  n dist | prim flags
  int* tri_idx;                   // [R]
  int* sph_idx;                   // [R]
  unsigned char* sph_near;        // [R]   bool
  int* pl_idx;                    // [R]
  float* t;                       // [R]
  int* prim;                      // [R]
  unsigned char* inside;          // [R]   bool
  float* pos;                     // [R,3]
  float* nrm;                     // [R,3]
  int* work;                      // [2+R] live count, fetch counter, list
  unsigned long long* keys;       // [R,3] winners' (t, row) keys, by slot
  int R, T, S, P;
  float eps_behind, eps2;
};

__device__ __forceinline__ bool is_parked(const float* o, int r) {
  return o[3 * r] == PARKED && o[3 * r + 1] == PARKED &&
         o[3 * r + 2] == PARKED;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__device__ __forceinline__ void write_no_hit(const SelectParams& p, int r) {
  p.tri_idx[r] = -1;
  p.sph_idx[r] = -1;
  p.sph_near[r] = 0;
  p.pl_idx[r] = -1;
  p.t[r] = 0.f;
  p.prim[r] = -1;
  p.inside[r] = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p.pos[3 * r + c] = 0.f;
    p.nrm[3 * r + c] = 0.f;
  }
}

// Dead lanes get their record, live lanes go to the list: one atomic per
// warp.  Every lane of the warp calls it.
__global__ void __launch_bounds__(LIST_THREADS)
    select_list_kernel(SelectParams p) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < p.R;
  const bool dead = valid && is_parked(p.ray_o, r);
  if (dead) write_no_hit(p, r);
  const bool live = valid && !dead;
  const unsigned mask = __ballot_sync(FULL_MASK, live);
  if (mask == 0) return;
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(p.work, __popc(mask));
  base = __shfl_sync(FULL_MASK, base, 0);
  if (live) {
    const int slot = base + __popc(mask & lanemask_lt());
    p.work[2 + slot] = r;
    unsigned long long* key = p.keys + 3 * (size_t)slot;
    key[0] = key[1] = key[2] = ~0ull;
  }
}

// One ray's query and its three running table winners (t, row).
struct SelRay {
  V3 o, d;
  Skip k;
  float tri_t, sph_t, pl_t;
  int tri_row, sph_row, pl_row;
};

__device__ __forceinline__ void load_ray(const SelectParams& p, int r,
                                         SelRay& s) {
  s.o = {p.ray_o[3 * r], p.ray_o[3 * r + 1], p.ray_o[3 * r + 2]};
  s.d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
  int pv_prim = -1;
  V3 pv_pos = {0.f, 0.f, 0.f};
  V3 pv_nrm = {0.f, 0.f, 1.f};
  bool pv_in = false;
  if (p.sk_prim != nullptr) {
    pv_prim = p.sk_prim[r];
    pv_pos = {p.sk_pos[3 * r], p.sk_pos[3 * r + 1], p.sk_pos[3 * r + 2]};
    pv_nrm = {p.sk_nrm[3 * r], p.sk_nrm[3 * r + 1], p.sk_nrm[3 * r + 2]};
    pv_in = p.sk_inside[r] != 0;
  }
  s.k = make_skip(pv_prim, pv_pos, pv_nrm, pv_in, s.d);
  s.tri_t = s.sph_t = s.pl_t = INFINITY;
  s.tri_row = s.sph_row = s.pl_row = -1;
}

// Moller-Trumbore of one triangle row (kernel_body.cuh triangle_pass with
// the coplanar branch), up to the commit test: true when the candidate
// survives (before the skip test); its t, u, v and inside flags.
__device__ __forceinline__ bool tri_candidate(float4 A, float4 B, float4 C,
                                              float4 N, V3 o, V3 d,
                                              float eps_behind, float& tt,
                                              float& u, float& v,
                                              bool& inside_geo,
                                              bool& inside) {
  const float v0x = A.x, v0y = A.y, v0z = A.z;
  const float e1x = B.x, e1y = B.y, e1z = B.z;
  const float e2x = C.x, e2y = C.y, e2z = C.z;
  const float fnx = N.x, fny = N.y, fnz = N.z;
  const int fl = __float_as_int(B.w);
  float sx = d.y * e2z - d.z * e2y;
  float sy = d.z * e2x - d.x * e2z;
  float sz = d.x * e2y - d.y * e2x;
  float det = e1x * sx + e1y * sy + e1z * sz;
  float fx = o.x - v0x, fy = o.y - v0y, fz = o.z - v0z;
  float inv = det != 0.f ? 1.f / det : 0.f;
  u = inv * (fx * sx + fy * sy + fz * sz);
  float ocx = fy * e1z - fz * e1y;
  float ocy = fz * e1x - fx * e1z;
  float ocz = fx * e1y - fy * e1x;
  v = inv * (d.x * ocx + d.y * ocy + d.z * ocz);
  tt = inv * (e2x * ocx + e2y * ocy + e2z * ocz);
  const bool on_plane = fabsf(fx * fnx + fy * fny + fz * fnz) <= eps_behind;
  const bool degen = det == 0.f && on_plane;
  if (degen) {
    u = e1x * fx + e1y * fy + e1z * fz;
    v = e2x * fx + e2y * fy + e2z * fz;
  }
  inside_geo = degen || inv < 0.f;
  const bool det_ok = det != 0.f || degen;
  const float uv_lim = (fl & SF_MIRROR) ? v : u + v;
  const bool ok = u >= 0.f && u <= 1.f && v >= 0.f && uv_lim <= 1.f &&
                  tt >= -eps_behind && det_ok;
  inside = inside_geo != ((fl & SF_INVERT) != 0);
  return ok && ((fl & SF_TWO_SIDED) != 0 || !inside);
}

// The triangle rows [lo, hi), RPT rays at a time: tri_candidate's
// arithmetic in three stages.  After u, and again after v, a row that no
// ray of the warp can still take is left (a warp vote): where det == 0 the
// coplanar branch may still replace u and v, so such a ray keeps its row.
// The first vote is on the division-free pre-reject of u (kernel_body.cuh
// surely_outside), so a row the warp leaves costs no division.
__device__ __forceinline__ void tri_scan(const float4* rows, int lo, int hi,
                                         SelRay (&s)[RPT], float eps_behind,
                                         float eps2) {
  for (int row = lo; row < hi; ++row) {
    const float4 A = rows[TRI_Q * row];
    const int prim = __float_as_int(A.w);
    if (prim < 0) continue;
    const float4 B = rows[TRI_Q * row + 1];
    const float4 C = rows[TRI_Q * row + 2];
    const float v0x = A.x, v0y = A.y, v0z = A.z;
    const float e1x = B.x, e1y = B.y, e1z = B.z;
    const float e2x = C.x, e2y = C.y, e2z = C.z;
    const int fl = __float_as_int(B.w);

    float det[RPT], fx[RPT], fy[RPT], fz[RPT], inv[RPT], u[RPT];
    bool go = false;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const V3 d = s[j].d, o = s[j].o;
      float sx = d.y * e2z - d.z * e2y;
      float sy = d.z * e2x - d.x * e2z;
      float sz = d.x * e2y - d.y * e2x;
      det[j] = e1x * sx + e1y * sy + e1z * sz;
      fx[j] = o.x - v0x;
      fy[j] = o.y - v0y;
      fz[j] = o.z - v0z;
      u[j] = fx[j] * sx + fy[j] * sy + fz[j] * sz;  // u's numerator
      go = go || det[j] == 0.f || !surely_outside(u[j], det[j]);
    }
    if (!__any_sync(FULL_MASK, go)) continue;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      inv[j] = det[j] != 0.f ? 1.f / det[j] : 0.f;
      u[j] = inv[j] * u[j];
    }

    const bool mirror = (fl & SF_MIRROR) != 0;
    float ocx[RPT], ocy[RPT], ocz[RPT], v[RPT];
    go = false;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const V3 d = s[j].d;
      ocx[j] = fy[j] * e1z - fz[j] * e1y;
      ocy[j] = fz[j] * e1x - fx[j] * e1z;
      ocz[j] = fx[j] * e1y - fy[j] * e1x;
      v[j] = inv[j] * (d.x * ocx[j] + d.y * ocy[j] + d.z * ocz[j]);
      const float uv_lim = mirror ? v[j] : u[j] + v[j];
      go = go || det[j] == 0.f ||
           (u[j] >= 0.f && u[j] <= 1.f && v[j] >= 0.f && uv_lim <= 1.f);
    }
    if (!__any_sync(FULL_MASK, go)) continue;

    const float4 N = rows[TRI_Q * row + 3];
    const float fnx = N.x, fny = N.y, fnz = N.z;
    const bool inv_f = (fl & SF_INVERT) != 0;
    const bool two_s = (fl & SF_TWO_SIDED) != 0;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float uu = u[j], vv = v[j];
      const float tt = inv[j] * (e2x * ocx[j] + e2y * ocy[j] + e2z * ocz[j]);
      const bool on_plane =
          fabsf(fx[j] * fnx + fy[j] * fny + fz[j] * fnz) <= eps_behind;
      const bool degen = det[j] == 0.f && on_plane;
      if (degen) {
        uu = e1x * fx[j] + e1y * fy[j] + e1z * fz[j];
        vv = e2x * fx[j] + e2y * fy[j] + e2z * fz[j];
      }
      const bool inside_geo = degen || inv[j] < 0.f;
      const bool det_ok = det[j] != 0.f || degen;
      const float uv_lim = mirror ? vv : uu + vv;
      bool ok = uu >= 0.f && uu <= 1.f && vv >= 0.f && uv_lim <= 1.f &&
                tt >= -eps_behind && det_ok;
      const bool inside = inside_geo != inv_f;
      ok = ok && (two_s || !inside);
      if (!ok || !(tt < s[j].tri_t)) continue;
      // Exact hit position (Triangle.cs:192), for the skip test.
      const float hx = v0x + e1x * uu + e2x * vv;
      const float hy = v0y + e1y * uu + e2y * vv;
      const float hz = v0z + e1z * uu + e2z * vv;
      if (skip_match(s[j].k, prim, hx, hy, hz, inside, eps2)) continue;
      s[j].tri_t = tt;
      s[j].tri_row = row;
    }
  }
}

// One root of a transformed sphere (kernel_body.cuh sphere_root): object
// point and world position.
__device__ __forceinline__ void sph_root_point(const float4* m, float t_obj,
                                               V3 oo, V3 dd, V3& pt, V3& w) {
  pt = {oo.x + dd.x * t_obj, oo.y + dd.y * t_obj, oo.z + dd.z * t_obj};
  const float4 a = m[3], b = m[4], c = m[5];
  w.x = a.x * pt.x + a.y * pt.y + a.z * pt.z + a.w;
  w.y = b.x * pt.x + b.y * pt.y + b.z * pt.z + b.w;
  w.z = c.x * pt.x + c.y * pt.y + c.z * pt.z + c.w;
}

__device__ __forceinline__ float world_t(V3 w, V3 o, V3 d) {
  return d.x * (w.x - o.x) + d.y * (w.y - o.y) + d.z * (w.z - o.z);
}

// The ray in a sphere's object space, re-normalized (Ray.Transform), and
// the quadratic's b and discriminant (kernel_body.cuh sphere_pass).
__device__ __forceinline__ void sph_quadratic(const float4* m, V3 o, V3 d,
                                              V3& oo, V3& dd, float& b,
                                              float& disc) {
  const float4 r0 = m[0], r1 = m[1], r2 = m[2], cr = m[6];
  oo = {r0.x * o.x + r0.y * o.y + r0.z * o.z + r0.w,
        r1.x * o.x + r1.y * o.y + r1.z * o.z + r1.w,
        r2.x * o.x + r2.y * o.y + r2.z * o.z + r2.w};
  dd = {r0.x * d.x + r0.y * d.y + r0.z * d.z,
        r1.x * d.x + r1.y * d.y + r1.z * d.z,
        r2.x * d.x + r2.y * d.y + r2.z * d.z};
  const float dlen =
      1.f / sqrtf(fmaxf(dd.x * dd.x + dd.y * dd.y + dd.z * dd.z, 1e-30f));
  dd = {dd.x * dlen, dd.y * dlen, dd.z * dlen};
  const float rad = cr.w;
  const float fx = oo.x - cr.x, fy = oo.y - cr.y, fz = oo.z - cr.z;
  b = -2.f * (fx * dd.x + fy * dd.y + fz * dd.z);
  const float c = fx * fx + fy * fy + fz * fz - rad * rad;
  disc = b * b - 4.f * c;
}

// The surviving root of a sphere row whose discriminant is >= 0: the near
// root where radix < b and it passes the two-sided and skip filters, else
// the far root where it passes them.  False when neither does.
__device__ __forceinline__ bool sph_root(const float4* m, int prim, int fl,
                                         V3 oo, V3 dd, float b, float radix,
                                         const SelRay& s, float eps2,
                                         bool& near_root, V3& pt, V3& w) {
  const bool inv_f = (fl & SF_INVERT) != 0;
  const bool two_s = (fl & SF_TWO_SIDED) != 0;
  if (radix < b) {
    sph_root_point(m, (b - radix) / 2.f, oo, dd, pt, w);
    near_root = (two_s || !inv_f) &&
                !skip_match(s.k, prim, w.x, w.y, w.z, inv_f, eps2);
    if (near_root) return true;
  }
  near_root = false;
  sph_root_point(m, (b + radix) / 2.f, oo, dd, pt, w);
  return (two_s || inv_f) &&
         !skip_match(s.k, prim, w.x, w.y, w.z, !inv_f, eps2);
}

// Two-root transformed spheres, rows [lo, hi).
__device__ __forceinline__ void sph_scan(const float4* rows, int lo, int hi,
                                         SelRay (&s)[RPT], float eps2) {
  for (int row = lo; row < hi; ++row) {
    const float4* m = rows + SPH_Q * row;
    const float4 tag = m[7];
    const int prim = __float_as_int(tag.x);
    if (prim < 0) continue;
    V3 oo[RPT], dd[RPT];
    float b[RPT], disc[RPT];
    bool go = false;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      sph_quadratic(m, s[j].o, s[j].d, oo[j], dd[j], b[j], disc[j]);
      go = go || disc[j] >= 0.f;
    }
    if (!__any_sync(FULL_MASK, go)) continue;
    const int fl = __float_as_int(tag.y);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (!(disc[j] >= 0.f)) continue;
      const float radix = sqrtf(disc[j]);
      if (!(radix >= -b[j])) continue;
      bool near_root;
      V3 pt, w;
      if (!sph_root(m, prim, fl, oo[j], dd[j], b[j], radix, s[j], eps2,
                    near_root, pt, w))
        continue;
      const float t_w = world_t(w, s[j].o, s[j].d);
      if (t_w < s[j].sph_t) {
        s[j].sph_t = t_w;
        s[j].sph_row = row;
      }
    }
  }
}

// The plane test up to the commit (kernel_body.cuh plane_pass): false
// where the plane is not a candidate; t_abs, inside and inside_geo else.
__device__ __forceinline__ bool plane_test(float4 n, int fl, V3 o, V3 d,
                                           float eps_behind, float& t_abs,
                                           bool& inside, bool& inside_geo) {
  const float dist0 = n.w;
  const float ray_dist = n.x * o.x + n.y * o.y + n.z * o.z;
  const float denom = n.x * d.x + n.y * d.y + n.z * d.z;
  const bool nz_den = denom != 0.f;
  const bool coplanar = !nz_den && fabsf(dist0 - ray_dist) <=
                                       eps_behind * (1.f + fabsf(dist0));
  const float tt = nz_den ? (dist0 - ray_dist) / denom : 0.f;
  const bool ahead = nz_den && tt >= -eps_behind;
  if (!(coplanar || ahead)) return false;
  t_abs = coplanar ? 0.f : fabsf(tt);
  inside_geo = coplanar || denom > 0.f;
  inside = inside_geo != ((fl & SF_INVERT) != 0);
  return (fl & SF_TWO_SIDED) != 0 || !inside;
}

__device__ __forceinline__ void pln_scan(const float4* rows, int lo, int hi,
                                         SelRay (&s)[RPT], float eps_behind,
                                         float eps2) {
  for (int row = lo; row < hi; ++row) {
    const float4 tag = rows[PL_Q * row + 1];
    const int prim = __float_as_int(tag.x);
    if (prim < 0) continue;
    const float4 n = rows[PL_Q * row];
    const int fl = __float_as_int(tag.y);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float t_abs;
      bool inside, inside_geo;
      if (!plane_test(n, fl, s[j].o, s[j].d, eps_behind, t_abs, inside,
                      inside_geo))
        continue;
      if (!(t_abs < s[j].pl_t)) continue;
      const V3 o = s[j].o, d = s[j].d;
      if (skip_match(s[j].k, prim, o.x + d.x * t_abs, o.y + d.y * t_abs,
                     o.z + d.z * t_abs, inside, eps2))
        continue;
      s[j].pl_t = t_abs;
      s[j].pl_row = row;
    }
  }
}

// The three winning rows' records, recomputed in the scans' arithmetic
// (position and normal as the plain version computes them at the commit),
// merged with a strict t <, written out.  Rows are read from device
// memory: three per ray.
__device__ __forceinline__ void finish_ray(const SelectParams& p, int r,
                                           const SelRay& s) {
  Best best = no_hit();
  if (s.tri_row >= 0) {
    const float4* m = p.tri + TRI_Q * s.tri_row;
    const float4 A = __ldg(m), B = __ldg(m + 1), C = __ldg(m + 2),
                 N = __ldg(m + 3);
    float tt, u, v;
    bool igeo, inside;
    tri_candidate(A, B, C, N, s.o, s.d, p.eps_behind, tt, u, v, igeo,
                  inside);
    best.t = tt;
    best.prim = __float_as_int(A.w);
    best.inside = inside;
    best.pos = {A.x + B.x * u + C.x * v, A.y + B.y * u + C.y * v,
                A.z + B.z * u + C.z * v};
    const float flip = igeo ? -1.f : 1.f;
    best.nrm = {N.x * flip, N.y * flip, N.z * flip};
    if (__float_as_int(B.w) & SF_SMOOTH) {
      const float4* cold = p.cold + COLD_Q * s.tri_row;
      const float4 n0 = __ldg(cold), n1 = __ldg(cold + 1),
                   n2 = __ldg(cold + 2);
      const float w2 = u + v;
      float ix = n0.x * u + n1.x * v + n2.x * w2;
      float iy = n0.y * u + n1.y * v + n2.y * w2;
      float iz = n0.z * u + n1.z * v + n2.z * w2;
      const float rl = 1.f / sqrtf(fmaxf(ix * ix + iy * iy + iz * iz, 1e-30f));
      ix = ix * rl;
      iy = iy * rl;
      iz = iz * rl;
      if (igeo) {
        // Reflect the interpolated normal through the face plane.
        const float dotf = ix * N.x + iy * N.y + iz * N.z;
        best.nrm = {ix - N.x * (2.f * dotf), iy - N.y * (2.f * dotf),
                    iz - N.z * (2.f * dotf)};
      } else {
        best.nrm = {ix, iy, iz};
      }
    }
  }
  bool near_root = false;
  if (s.sph_row >= 0) {
    float4 m[SPH_Q];
#pragma unroll
    for (int q = 0; q < SPH_Q; ++q) m[q] = __ldg(p.sph + SPH_Q * s.sph_row + q);
    const int prim = __float_as_int(m[7].x), fl = __float_as_int(m[7].y);
    V3 oo, dd, pt, w;
    float b, disc;
    sph_quadratic(m, s.o, s.d, oo, dd, b, disc);
    sph_root(m, prim, fl, oo, dd, b, sqrtf(disc), s, p.eps2, near_root, pt,
             w);
    const float t_w = world_t(w, s.o, s.d);
    if (t_w < best.t) {
      const float4 cr = m[6];
      const float inv_rad = 1.f / cr.w;
      const float qx = (pt.x - cr.x) * inv_rad;
      const float qy = (pt.y - cr.y) * inv_rad;
      const float qz = (pt.z - cr.z) * inv_rad;
      const float nwx = m[0].x * qx + m[1].x * qy + m[2].x * qz;
      const float nwy = m[0].y * qx + m[1].y * qy + m[2].y * qz;
      const float nwz = m[0].z * qx + m[1].z * qy + m[2].z * qz;
      const float nrl =
          1.f / sqrtf(fmaxf(nwx * nwx + nwy * nwy + nwz * nwz, 1e-30f));
      const float flip = near_root ? 1.f : -1.f;  // Sphere.cs:168-169
      const bool inv_f = (fl & SF_INVERT) != 0;
      best.t = t_w;
      best.prim = prim;
      best.inside = near_root ? inv_f : !inv_f;
      best.pos = w;
      best.nrm = {nwx * nrl * flip, nwy * nrl * flip, nwz * nrl * flip};
    }
  }
  if (s.pl_row >= 0) {
    const float4 n = __ldg(p.pln + PL_Q * s.pl_row);
    const float4 tag = __ldg(p.pln + PL_Q * s.pl_row + 1);
    float t_abs;
    bool inside, inside_geo;
    plane_test(n, __float_as_int(tag.y), s.o, s.d, p.eps_behind, t_abs,
               inside, inside_geo);
    if (t_abs < best.t) {
      const float flip = inside_geo ? -1.f : 1.f;
      best.t = t_abs;
      best.prim = __float_as_int(tag.x);
      best.inside = inside;
      best.pos = {s.o.x + s.d.x * t_abs, s.o.y + s.d.y * t_abs,
                  s.o.z + s.d.z * t_abs};
      best.nrm = {n.x * flip, n.y * flip, n.z * flip};
    }
  }
  p.tri_idx[r] = s.tri_row;
  p.sph_idx[r] = s.sph_row;
  p.sph_near[r] = near_root ? 1 : 0;
  p.pl_idx[r] = s.pl_row;
  p.t[r] = best.prim >= 0 ? best.t : 0.f;
  p.prim[r] = best.prim;
  p.inside[r] = best.inside ? 1 : 0;
  p.pos[3 * r] = best.pos.x;
  p.pos[3 * r + 1] = best.pos.y;
  p.pos[3 * r + 2] = best.pos.z;
  p.nrm[3 * r] = best.nrm.x;
  p.nrm[3 * r + 1] = best.nrm.y;
  p.nrm[3 * r + 2] = best.nrm.z;
}

// A table winner as one 64-bit key that orders like (t, row): the t bits
// made monotone (-0 read as +0, as t < reads it), the row below them.
// The smallest key is the winner a scan of the rows in order keeps.
__device__ __forceinline__ unsigned long long win_key(float t, int row) {
  unsigned bits = __float_as_uint(t == 0.f ? 0.f : t);
  bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((unsigned long long)bits << 32) | (unsigned)row;
}

__device__ __forceinline__ int key_row(unsigned long long key) {
  return key == ~0ull ? -1 : (int)(unsigned)(key & 0xffffffffull);
}

// Persistent blocks.  The tables go to shared memory once per block; then
// the warps take work items through a global atomic counter.  An item is a
// batch of 32 * RPT live rays (lane l holds rays l, l + 32) and one of K
// slices of every table's rows.  K grows as the live rays shrink, so that
// there are about twice as many items as warps on the card; each slice's
// winners go to the rays' keys with atomicMin, and select_finish_kernel
// writes the records.
__global__ void __launch_bounds__(SELECT_THREADS, 2)
    select_kernel(SelectParams p) {
  constexpr int BATCH = 32 * RPT;
  constexpr int MAX_SLICES = 32;
  extern __shared__ float4 smem4[];
  float4* s_tri = smem4;
  float4* s_sph = s_tri + TRI_Q * p.T;
  float4* s_pln = s_sph + SPH_Q * p.S;
  for (int q = threadIdx.x; q < TRI_Q * p.T; q += blockDim.x)
    s_tri[q] = p.tri[q];
  for (int q = threadIdx.x; q < SPH_Q * p.S; q += blockDim.x)
    s_sph[q] = p.sph[q];
  for (int q = threadIdx.x; q < PL_Q * p.P; q += blockDim.x)
    s_pln[q] = p.pln[q];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n_live = p.work[0];
  const int* list = p.work + 2;
  const int n_batches = (n_live + BATCH - 1) / BATCH;
  if (n_batches == 0) return;
  const int warps = gridDim.x * SELECT_WARPS;
  const int K =
      min(MAX_SLICES, max(1, (2 * warps + n_batches - 1) / n_batches));
  const int n_items = n_batches * K;
  while (true) {
    int item = 0;
    if (lane == 0) item = atomicAdd(p.work + 1, 1);
    item = __shfl_sync(FULL_MASK, item, 0);
    if (item >= n_items) break;
    const int b = item / K, c = item - b * K;
    int slot[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) slot[j] = b * BATCH + lane + 32 * j;
    // Empty slots scan the batch's first ray again and commit nothing.
    SelRay s[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      load_ray(p, list[slot[j] < n_live ? slot[j] : b * BATCH], s[j]);
    tri_scan(s_tri, p.T * c / K, p.T * (c + 1) / K, s, p.eps_behind, p.eps2);
    sph_scan(s_sph, p.S * c / K, p.S * (c + 1) / K, s, p.eps2);
    pln_scan(s_pln, p.P * c / K, p.P * (c + 1) / K, s, p.eps_behind, p.eps2);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (slot[j] >= n_live) continue;
      unsigned long long* key = p.keys + 3 * (size_t)slot[j];
      if (s[j].tri_row >= 0) atomicMin(key, win_key(s[j].tri_t, s[j].tri_row));
      if (s[j].sph_row >= 0)
        atomicMin(key + 1, win_key(s[j].sph_t, s[j].sph_row));
      if (s[j].pl_row >= 0) atomicMin(key + 2, win_key(s[j].pl_t, s[j].pl_row));
    }
  }
}

// The live rays' records from their three winning keys.
__global__ void __launch_bounds__(LIST_THREADS)
    select_finish_kernel(SelectParams p) {
  const int n_live = p.work[0];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_live;
       i += gridDim.x * blockDim.x) {
    const int r = p.work[2 + i];
    SelRay s;
    load_ray(p, r, s);
    const unsigned long long* key = p.keys + 3 * (size_t)i;
    s.tri_row = key_row(key[0]);
    s.sph_row = key_row(key[1]);
    s.pl_row = key_row(key[2]);
    finish_ray(p, r, s);
  }
}

// Blocks of the main kernel that fit on the card at once for `smem` bytes
// of tables, and the shared-memory opt-in above 48 KB.  Both are per
// device: the attribute applies to the current device only.  They are set
// once per device and table size.
int select_blocks(size_t smem, int& blocks) {
  constexpr int MAX_DEV = 64;
  static size_t opted_in[MAX_DEV];
  static size_t occ_smem[MAX_DEV];
  static int occ_blocks[MAX_DEV];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const bool cached = dev < MAX_DEV;
  if (smem > DEFAULT_SMEM && !(cached && smem <= opted_in[dev])) {
    err = (int)cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    if (cached) opted_in[dev] = smem;
  }
  if (cached && occ_smem[dev] == smem && occ_blocks[dev] > 0) {
    blocks = occ_blocks[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, select_kernel, SELECT_THREADS, smem);
  if (err) return err;
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (cached) {
    occ_smem[dev] = smem;
    occ_blocks[dev] = blocks;
  }
  return 0;
}

int launch_select(const SelectParams& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)(TRI_Q * p.T + SPH_Q * p.S + PL_Q * p.P) * sizeof(float4);
  int blocks = 0;
  const int err = select_blocks(smem, blocks);
  if (err) return err;
  const int list_blocks = (p.R + LIST_THREADS - 1) / LIST_THREADS;
  select_list_kernel<<<list_blocks, LIST_THREADS, 0, stream>>>(p);
  select_kernel<<<blocks, SELECT_THREADS, smem, stream>>>(p);
  select_finish_kernel<<<list_blocks, LIST_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace rtc

// C entry point, loaded with ctypes.  Zeroes the two counters of `work`
// ([2 + R] int32 scratch), launches the list kernel, the main kernel and
// the finish kernel on `stream`, and returns the first CUDA error met
// (0 = launched).  `keys` is [R, 3] 64-bit scratch.
extern "C" int rtc_select(
    const float* ray_o, const float* ray_d, const int* sk_prim,
    const float* sk_pos, const float* sk_nrm, const unsigned char* sk_inside,
    const float* tri, const float* cold, const float* sph, const float* pln,
    int* tri_idx, int* sph_idx, unsigned char* sph_near, int* pl_idx,
    float* t, int* prim, unsigned char* inside, float* pos, float* nrm,
    int* work, unsigned long long* keys, int R, int T, int S, int P,
    float eps_behind, float eps2, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rtc::SelectParams p{ray_o, ray_d, sk_prim, sk_pos, sk_nrm, sk_inside,
                      reinterpret_cast<const float4*>(tri),
                      reinterpret_cast<const float4*>(cold),
                      reinterpret_cast<const float4*>(sph),
                      reinterpret_cast<const float4*>(pln),
                      tri_idx, sph_idx, sph_near, pl_idx, t, prim, inside,
                      pos, nrm, work, keys, R, T, S, P, eps_behind, eps2};
  cudaError_t err = cudaMemsetAsync(work, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  return rtc::launch_select(p, s);
}
