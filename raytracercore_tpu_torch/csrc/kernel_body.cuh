// Per-row intersection passes as CUDA device functions, one ray per thread.
//
// Counterpart of raytracercore_tpu/intersect/kernel_body.py (triangle_pass,
// sphere_pass, plane_pass, make_skip_match, GlobalBest.commit) and of the
// plain torch passes in raytracercore_tpu_torch/intersect/kernel_body.py,
// which tests hold these against.  Every formula keeps the plain version's
// operation order (build with -fmad=false so no product is fused into an
// add), and rsqrt is written 1.0f / sqrtf.
//
// The passes walk table rows at run time in row order and commit a
// candidate only if it is strictly closer (t <), so on a tie the earliest
// row of the earliest table (triangles -> spheres -> planes) wins, as in
// the JAX commit.  Work a candidate cannot change (a row that already
// failed, or is not closer than the current best) is skipped: the commit
// would discard it anyway, so the result is the same.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rtc {

// Packed table column layouts (intersect/kernel_body.py: pack_tables).
constexpr int TRI_F = 21;  // v0(3) e1(3) e2(3) n(3) n0(3) n1(3) n2(3)
constexpr int SPH_F = 28;  // w2o rows (12), o2w rows (12), center(3), radius
constexpr int PL_F = 4;    // n(3), dist
constexpr int INT_F = 4;   // prim_id, flag (bit0 mirror, bit1 smooth), invert, two_sided

constexpr float F32_TINY = 1.17549435e-38f;  // smallest normal float

struct V3 {
  float x, y, z;
};

// Running closest hit (GlobalBest).  prim < 0 means no hit.  row is the
// winning row of the table the hit came from, near_root whether a sphere hit is
// its near root: the select kernel reports them, the megakernel does not
// read them.
struct Best {
  float t;
  int prim;
  bool inside;
  V3 pos;
  V3 nrm;
  int row;
  bool near_root;
};

__device__ __forceinline__ Best no_hit() {
  Best b;
  b.t = INFINITY;
  b.prim = -1;
  b.inside = false;
  b.pos = {0.f, 0.f, 0.f};
  b.nrm = {0.f, 0.f, 0.f};
  b.row = -1;
  b.near_root = false;
  return b;
}

// The previous bounce's hit, for the epsilon-free self-intersection skip
// (Util.RayHitMatches, Util.cs:179-192).  prim < 0 means none (camera rays).
struct Skip {
  int prim;
  V3 pos;
  bool leaving;  // current direction leaves through the previous normal
  bool inside;
  float scale;   // 1 + |pos|^2: the position test is relative
};

__device__ __forceinline__ Skip make_skip(int prim, V3 pos, V3 nrm,
                                          bool inside, V3 d) {
  Skip k;
  k.prim = prim;
  k.pos = pos;
  k.leaving = (d.x * nrm.x + d.y * nrm.y + d.z * nrm.z) > 0.f;
  k.inside = inside;
  k.scale = 1.f + pos.x * pos.x + pos.y * pos.y + pos.z * pos.z;
  return k;
}

// eps2 = eps_pos * eps_pos.
__device__ __forceinline__ bool skip_match(const Skip& k, int prim, float px,
                                           float py, float pz, bool inside,
                                           float eps2) {
  if (k.prim < 0 || k.prim != prim) return false;
  float dx = px - k.pos.x;
  float dy = py - k.pos.y;
  float dz = pz - k.pos.z;
  float d2 = dx * dx + dy * dy + dz * dz;
  bool pos_close = d2 <= eps2 * k.scale;
  bool parity = k.leaving != (inside == k.inside);
  return pos_close && parity;
}

// True only where fl(fl(1 / det) * num) is certain to lie outside [0, 1]
// (or to be NaN), so that the exact test rejects the row: below 0 where the
// signs differ and the quotient is too large to round to -0; above 1 where
// the signs agree and |num| exceeds |det| by more than the two roundings
// (2^-23 together) can take back.  det == 0 is never rejected here.  The
// select kernel's division-free pre-reject of u (select.cu tri_scan);
// intersect/kernel_body.py: surely_outside is the plain version the tests
// hold against the exact test.
__device__ __forceinline__ bool surely_outside(float num, float det) {
  const float an = fabsf(num), ad = fabsf(det);
  const bool opposite = (__float_as_int(num) ^ __float_as_int(det)) < 0;
  const bool below = opposite && an >= fmaxf(ad, 1.f) * 0x1p-100f;
  const bool above = !opposite && an > ad * (1.f + 0x1p-20f);
  return det != 0.f && (below || above);
}

// Moller-Trumbore over all triangle rows (Triangle.cs:148-224): mirrored-
// quad UV rule, optional coplanar ray-in-plane branch, optional smooth
// normals.  inv = det != 0 ? 1/det : 0 (the reference's AVX path scrubs
// 1/det the same way).
template <bool COPLANAR, bool ANY_SMOOTH>
__device__ __forceinline__ void triangle_pass(int T, const float* tf,
                                              const int* ti, V3 o, V3 d,
                                              float eps_behind, const Skip& k,
                                              float eps2, Best& best) {
  for (int t = 0; t < T; ++t) {
    const float* m = tf + t * TRI_F;
    const int* mi = ti + t * INT_F;
    const int prim = mi[0];
    if (prim < 0) continue;
    const float v0x = m[0], v0y = m[1], v0z = m[2];
    const float e1x = m[3], e1y = m[4], e1z = m[5];
    const float e2x = m[6], e2y = m[7], e2z = m[8];
    const float fnx = m[9], fny = m[10], fnz = m[11];
    const bool mirror = (mi[1] & 1) != 0;
    const bool smooth = (mi[1] & 2) != 0;
    const bool inv_f = mi[2] != 0;
    const bool two_s = mi[3] != 0;

    float sx = d.y * e2z - d.z * e2y;
    float sy = d.z * e2x - d.x * e2z;
    float sz = d.x * e2y - d.y * e2x;
    float det = e1x * sx + e1y * sy + e1z * sz;
    float fx = o.x - v0x, fy = o.y - v0y, fz = o.z - v0z;
    float inv = det != 0.f ? 1.f / det : 0.f;
    float u = inv * (fx * sx + fy * sy + fz * sz);
    float ocx = fy * e1z - fz * e1y;
    float ocy = fz * e1x - fx * e1z;
    float ocz = fx * e1y - fy * e1x;
    float v = inv * (d.x * ocx + d.y * ocy + d.z * ocz);
    float tt = inv * (e2x * ocx + e2y * ocy + e2z * ocz);

    bool inside_geo, det_ok;
    if (COPLANAR) {
      bool on_plane = fabsf(fx * fnx + fy * fny + fz * fnz) <= eps_behind;
      bool degen = det == 0.f && on_plane;
      if (degen) {
        u = e1x * fx + e1y * fy + e1z * fz;
        v = e2x * fx + e2y * fy + e2z * fz;
      }
      inside_geo = degen || inv < 0.f;
      det_ok = det != 0.f || degen;
    } else {
      inside_geo = inv < 0.f;
      det_ok = det != 0.f;
    }

    float uv_lim = mirror ? v : u + v;
    bool ok = u >= 0.f && u <= 1.f && v >= 0.f && uv_lim <= 1.f &&
              tt >= -eps_behind && det_ok;
    bool inside = inside_geo != inv_f;
    ok = ok && (two_s || !inside);
    if (!ok || !(tt < best.t)) continue;

    // Exact hit position (Triangle.cs:192).
    float hx = v0x + e1x * u + e2x * v;
    float hy = v0y + e1y * u + e2y * v;
    float hz = v0z + e1z * u + e2z * v;
    if (skip_match(k, prim, hx, hy, hz, inside, eps2)) continue;

    // Normal (Triangle.GetNormal, Triangle.cs:209-224).
    float flip = inside_geo ? -1.f : 1.f;
    V3 n = {fnx * flip, fny * flip, fnz * flip};
    if (ANY_SMOOTH && smooth) {
      float w2 = u + v;
      float ix = m[12] * u + m[15] * v + m[18] * w2;
      float iy = m[13] * u + m[16] * v + m[19] * w2;
      float iz = m[14] * u + m[17] * v + m[20] * w2;
      float rl = 1.f / sqrtf(fmaxf(ix * ix + iy * iy + iz * iz, 1e-30f));
      ix = ix * rl;
      iy = iy * rl;
      iz = iz * rl;
      if (inside_geo) {
        // Reflect the interpolated normal through the face plane.
        float dotf = ix * fnx + iy * fny + iz * fnz;
        n = {ix - fnx * (2.f * dotf), iy - fny * (2.f * dotf),
             iz - fnz * (2.f * dotf)};
      } else {
        n = {ix, iy, iz};
      }
    }
    best.t = tt;
    best.prim = prim;
    best.inside = inside;
    best.pos = {hx, hy, hz};
    best.nrm = n;
    best.row = t;
  }
}

// One root of a transformed sphere (Sphere.cs:156-209): world position via
// obj_to_world, normal via w2o^T, world-space t from the world position.
// Returns false when the root is filtered (two-sided rule, skip match).
// Fills the hit fields of cand; its row and near_root are the caller's.
__device__ __forceinline__ bool sphere_root(const float* m, int prim,
                                            bool inv_f, bool two_s,
                                            bool geo_inside, float t_obj,
                                            V3 oo, V3 dd, V3 o, V3 d,
                                            float inv_rad, const Skip& k,
                                            float eps2, Best& cand) {
  float px = oo.x + dd.x * t_obj;
  float py = oo.y + dd.y * t_obj;
  float pz = oo.z + dd.z * t_obj;
  float wx = m[12] * px + m[13] * py + m[14] * pz + m[15];
  float wy = m[16] * px + m[17] * py + m[18] * pz + m[19];
  float wz = m[20] * px + m[21] * py + m[22] * pz + m[23];
  bool inside = geo_inside ? !inv_f : inv_f;
  if (!(two_s || !inside)) return false;
  if (skip_match(k, prim, wx, wy, wz, inside, eps2)) return false;
  float qx = (px - m[24]) * inv_rad;
  float qy = (py - m[25]) * inv_rad;
  float qz = (pz - m[26]) * inv_rad;
  float nwx = m[0] * qx + m[4] * qy + m[8] * qz;
  float nwy = m[1] * qx + m[5] * qy + m[9] * qz;
  float nwz = m[2] * qx + m[6] * qy + m[10] * qz;
  float nrl = 1.f / sqrtf(fmaxf(nwx * nwx + nwy * nwy + nwz * nwz, 1e-30f));
  float flip = geo_inside ? -1.f : 1.f;  // Sphere.cs:168-169
  cand.t = d.x * (wx - o.x) + d.y * (wy - o.y) + d.z * (wz - o.z);
  cand.prim = prim;
  cand.inside = inside;
  cand.pos = {wx, wy, wz};
  cand.nrm = {nwx * nrl * flip, nwy * nrl * flip, nwz * nrl * flip};
  return true;
}

// Two-root transformed-sphere intersection; the near root is preferred
// (radix < b), the far root taken when the near one is absent or filtered.
__device__ __forceinline__ void sphere_pass(int S, const float* sf,
                                            const int* si, V3 o, V3 d,
                                            const Skip& k, float eps2,
                                            Best& best) {
  for (int s = 0; s < S; ++s) {
    const float* m = sf + s * SPH_F;
    const int* mi = si + s * INT_F;
    const int prim = mi[0];
    if (prim < 0) continue;
    V3 oo = {m[0] * o.x + m[1] * o.y + m[2] * o.z + m[3],
             m[4] * o.x + m[5] * o.y + m[6] * o.z + m[7],
             m[8] * o.x + m[9] * o.y + m[10] * o.z + m[11]};
    V3 dd = {m[0] * d.x + m[1] * d.y + m[2] * d.z,
             m[4] * d.x + m[5] * d.y + m[6] * d.z,
             m[8] * d.x + m[9] * d.y + m[10] * d.z};
    float dlen =
        1.f / sqrtf(fmaxf(dd.x * dd.x + dd.y * dd.y + dd.z * dd.z, 1e-30f));
    dd = {dd.x * dlen, dd.y * dlen, dd.z * dlen};

    const float rad = m[27];
    float fx = oo.x - m[24], fy = oo.y - m[25], fz = oo.z - m[26];
    float b = -2.f * (fx * dd.x + fy * dd.y + fz * dd.z);
    float c = fx * fx + fy * fy + fz * fz - rad * rad;
    float disc = b * b - 4.f * c;
    if (!(disc >= 0.f)) continue;
    float radix = sqrtf(disc);
    if (!(radix >= -b)) continue;
    const bool inv_f = mi[2] != 0;
    const bool two_s = mi[3] != 0;
    float inv_rad = 1.f / rad;

    Best cand;
    bool got = false;
    if (radix < b)
      got = sphere_root(m, prim, inv_f, two_s, false, (b - radix) / 2.f, oo,
                        dd, o, d, inv_rad, k, eps2, cand);
    const bool near_root = got;
    if (!got)
      got = sphere_root(m, prim, inv_f, two_s, true, (b + radix) / 2.f, oo,
                        dd, o, d, inv_rad, k, eps2, cand);
    if (got && cand.t < best.t) {
      best = cand;
      best.row = s;
      best.near_root = near_root;
    }
  }
}

// Infinite plane with the coplanar special case (Plane.cs:36-66).
__device__ __forceinline__ void plane_pass(int P, const float* pf,
                                           const int* pi, V3 o, V3 d,
                                           float eps_behind, const Skip& k,
                                           float eps2, Best& best) {
  for (int q = 0; q < P; ++q) {
    const float* m = pf + q * PL_F;
    const int* mi = pi + q * INT_F;
    const int prim = mi[0];
    if (prim < 0) continue;
    const float qnx = m[0], qny = m[1], qnz = m[2], dist0 = m[3];
    const bool inv_f = mi[2] != 0;
    const bool two_s = mi[3] != 0;
    float ray_dist = qnx * o.x + qny * o.y + qnz * o.z;
    float denom = qnx * d.x + qny * d.y + qnz * d.z;
    bool nz_den = denom != 0.f;
    bool coplanar = !nz_den && fabsf(dist0 - ray_dist) <=
                                   eps_behind * (1.f + fabsf(dist0));
    float tt = nz_den ? (dist0 - ray_dist) / denom : 0.f;
    bool ahead = nz_den && tt >= -eps_behind;
    if (!(coplanar || ahead)) continue;
    float t_abs = coplanar ? 0.f : fabsf(tt);
    bool inside_geo = coplanar || denom > 0.f;
    bool inside = inside_geo != inv_f;
    if (!(two_s || !inside)) continue;
    if (!(t_abs < best.t)) continue;
    float hx = o.x + d.x * t_abs;
    float hy = o.y + d.y * t_abs;
    float hz = o.z + d.z * t_abs;
    if (skip_match(k, prim, hx, hy, hz, inside, eps2)) continue;
    float flip = inside_geo ? -1.f : 1.f;
    best.t = t_abs;
    best.prim = prim;
    best.inside = inside;
    best.pos = {hx, hy, hz};
    best.nrm = {qnx * flip, qny * flip, qnz * flip};
    best.row = q;
  }
}

}  // namespace rtc
