// BVH traversal kernel: one thread walks one ray through a skip-link BVH
// and commits the closest surviving hit of its leaves; and the key kernel
// that orders the rays for it.
//
// Replaces the TPU kernel raytracercore_tpu/bvh/pallas_traverse.py:
// _traverse_kernel (with tri_test, sph_test, spht_test and flush; launched
// by _traverse_call through pl.pallas_call; public PallasBVH.select,
// PallasSphereBVH, PallasEllipsoidBVH).  Its plain version is
// traverse_reference in raytracercore_tpu_torch/bvh/cuda_traverse.py; the
// Python wrapper traverse there launches this kernel.  The key kernel is
// the counterpart of the XLA operations of PallasBVH._sort_key (no Pallas
// kernel); its plain version is sort_key_reference, its wrapper sort_key.
//
// What it computes: for every ray the winning row of the leaves' table and
// its t, plus the winner's detail (prim, position, flat normal, inside
// flags, u/v), committed in the kernel so that no caller gathers rows from
// the primitive tables.  The nodes are stored in preorder as [N,8] floats
// (bmin, bmax, skip link, leaf slot).  A ray visits node p: when the slab
// test fails (near <= far && far >= -eps_behind && near <= best t) it goes
// to skip[p]; when it enters an inner node it goes to p + 1; when it
// enters a leaf it tests the leaf's K records one after another and then
// goes to skip[p].  A candidate is committed only if it is strictly closer
// (t <), so leaves count in preorder and the earliest-preorder winner wins
// a tie.
//
// The three leaf tests:
//   * triangles (16 floats a record): Moller-Trumbore with the mirror rule,
//     the coplanar branch off as in production, invert / two-sided, the
//     skip match on the exact hit position.  The arithmetic is that of
//     triangle_pass<false, ...> in kernel_body.cuh, in its order; it is
//     written out here because that pass loops over the 21-float table rows
//     and evaluates smooth normals, while a leaf record has its own layout
//     and the kernel commits the flat normal with (u, v) and the smooth
//     flag (the caller re-interpolates the winner's normal).  V3, Skip,
//     make_skip and skip_match are kernel_body.cuh's.
//   * untransformed spheres (8 floats): the quadratic on the re-normalized
//     direction, both roots filtered on their own, the near root preferred,
//     t returned in the world metric |d| * t.
//   * transformed spheres (32 floats): the object-space quadratic with
//     per-root world position, world-metric t and world normal: the
//     arithmetic of sphere_pass / sphere_root in kernel_body.cuh.
// The skip record is matched by primitive id (skip_match), as everywhere
// else in this package.  A zero direction component gets the finite inverse
// 3.4e38, so no 0 * inf arises in the slab test.
//
// What bounds it on Hopper: the walk is a chain of dependent loads (a node
// is 32 bytes, a triangle record 64), each followed by ~25 (node) or ~50
// (triangle) fp32 operations, and neighbouring threads diverge after the
// first bounce.  By its own counts (some 40 nodes and 6 records a ray on a
// 184k-triangle mesh) the operations are few, and reading every array once
// sets the bound; what a thread really waits for is the latency of the
// dependent loads, and a warp for its longest lane.  What the design does
// about it: nodes are read as two float4 and
// records as float4 through the read-only path (__ldg), so the upper levels
// of the tree stay in L1/L2; the ray, the skip record and the running best
// live in registers; nothing is staged in shared memory, so occupancy is
// set by registers alone and many warps hide each other's loads; a parked
// ray (origin far outside, as the integrator parks finished paths) fails
// the root's slab test and ends after one node.  -fmad=false halves what
// the card's fp32 rate could give, but the operations are not what bounds
// the walk.  Schedules that settle the parked rays in a list kernel first,
// persistent warps that take new rays as theirs finish (one lane or a
// whole batch at a time) and postponed leaves all measured slower on the
// card than this one-ray-per-thread walk, and were not kept (PERF.md).
// The TPU kernel's 8-chain block beam, pending-leaf flush, two-node
// speculation, DMA path, bf16 node words and lane padding answer the TPU's
// lack of a per-lane gather and are not carried over.
//
// Ray coherence (the JAX package's sort=): a warp runs as long as its
// longest lane, so which rays share a warp matters after the first bounce,
// where neighbouring pixels' rays leave from far-apart points in unrelated
// directions and finished paths are parked among live ones.  The caller
// may pass `order` (int64, a permutation of the rays by the key that
// sort_key_kernel computes and torch.sort orders): thread t then walks ray
// order[t], reading that ray's inputs and writing its outputs at the ray's
// own index.  The reads and stores scatter, but no gather or scatter pass
// runs and the outputs stay in the caller's order; the walk is the same,
// so every output is bit-equal to the unordered launch's.  The key: the
// direction octant above an 8-bit-per-axis Morton code of the origin in
// the root box, in PallasBVH._sort_key's operations and order (correctly
// rounded division, no contraction, truncation to int as astype(int32)).
//
// Floating point: fp32, built with -fmad=false and no fast math, in the
// plain version's operation order; rsqrt is written 1.0f / sqrtf.

#include <cuda_runtime.h>
#include <math.h>

#include "kernel_body.cuh"

namespace rtc {

constexpr int TRAVERSE_BLOCK = 128;
constexpr float BIG_INV = 3.4e38f;  // inverse of a zero direction component
constexpr int KIND_TRI = 0, KIND_SPH = 1, KIND_SPHT = 2;
constexpr int FLAG_IN = 1, FLAG_IN_GEO = 2, FLAG_SMOOTH = 4;

struct TraverseParams {
  const float4* nodes;             // [N,2] bmin.xyz bmax.x | bmax.yz skip slot
  const float4* leaves;            // [L, K*F/4]
  const float* ray_o;              // [R,3]
  const float* ray_d;              // [R,3]
  const int* sk_prim;              // [R]   previous hit; null: no skip record
  const float* sk_pos;             // [R,3]
  const float* sk_nrm;             // [R,3]
  const unsigned char* sk_inside;  // [R]   bool
  const long long* order;          // [R]   ray of each thread; null: t
  int* row;                        // [R]
  float* t;                        // [R]
  int* prim;                       // [R]
  float* pos;                      // [R,3]
  float* nrm;                      // [R,3]
  int* flags;                      // [R]
  float* u;                        // [R]
  float* v;                        // [R]
  int* stats;                      // [R,2] or null
  int R, n_nodes, K;
  float eps_behind, eps2;
};

// The running winner with its detail.
struct Winner {
  float t;
  int row, prim, flags;
  V3 pos, nrm;
  float u, v;
};

// What a ray carries through the walk.
struct Ray {
  V3 o, d;
  V3 n;          // re-normalized direction (sphere leaves)
  float dn_len;  // |d|
};

__device__ __forceinline__ void tri_record(const float4* rec, const Ray& ray,
                                           float eps_behind, const Skip& k,
                                           float eps2, Winner& best,
                                           int& tested) {
  const float4 r3 = __ldg(rec + 3);  // row, flags, prim, -
  const int row = (int)r3.x;
  if (row < 0) return;
  ++tested;
  const float4 r0 = __ldg(rec), r1 = __ldg(rec + 1), r2 = __ldg(rec + 2);
  const float v0x = r0.x, v0y = r0.y, v0z = r0.z;
  const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
  const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
  const float fnx = r2.y, fny = r2.z, fnz = r2.w;
  const int flag_i = (int)r3.y;
  const bool mirror = (flag_i & 1) != 0;
  const bool inv_f = (flag_i & 2) != 0;
  const bool two_s = (flag_i & 4) != 0;
  const bool smooth = (flag_i & 8) != 0;
  const int prim = (int)r3.z;
  const V3 o = ray.o, d = ray.d;

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
  const bool inside_geo = inv < 0.f;

  float uv_lim = mirror ? v : u + v;
  bool ok = u >= 0.f && u <= 1.f && v >= 0.f && uv_lim <= 1.f &&
            tt >= -eps_behind && det != 0.f;
  const bool inside = inside_geo != inv_f;
  ok = ok && (two_s || !inside);
  if (!ok || !(tt < best.t)) return;

  // Exact hit position (Triangle.cs:192).
  float hx = v0x + e1x * u + e2x * v;
  float hy = v0y + e1y * u + e2y * v;
  float hz = v0z + e1z * u + e2z * v;
  if (skip_match(k, prim, hx, hy, hz, inside, eps2)) return;

  const float flip = inside_geo ? -1.f : 1.f;
  best.t = tt;
  best.row = row;
  best.prim = prim;
  best.flags = (inside ? FLAG_IN : 0) | (inside_geo ? FLAG_IN_GEO : 0) |
               (smooth ? FLAG_SMOOTH : 0);
  best.pos = {hx, hy, hz};
  best.nrm = {fnx * flip, fny * flip, fnz * flip};
  best.u = u;
  best.v = v;
}

__device__ __forceinline__ void sph_record(const float4* rec, const Ray& ray,
                                           const Skip& k, float eps2,
                                           Winner& best, int& tested) {
  const float4 r1 = __ldg(rec + 1);  // row, invert, two_sided, prim
  const int row = (int)r1.x;
  if (row < 0) return;
  ++tested;
  const float4 r0 = __ldg(rec);  // center, radius
  const float cx = r0.x, cy = r0.y, cz = r0.z, r = r0.w;
  const bool inv_f = r1.y != 0.f;
  const bool two_s = r1.z != 0.f;
  const int prim = (int)r1.w;
  const V3 o = ray.o, n = ray.n;

  float fx = o.x - cx, fy = o.y - cy, fz = o.z - cz;
  float b = -2.f * (fx * n.x + fy * n.y + fz * n.z);
  float cq = fx * fx + fy * fy + fz * fz - r * r;
  float disc = b * b - 4.f * cq;
  if (!(disc >= 0.f)) return;
  float radix = sqrtf(disc);
  if (!(radix >= -b)) return;
  const bool both = radix < b;
  const float t_near = (b - radix) * 0.5f;
  const float t_far = (b + radix) * 0.5f;
  const bool inside_near = inv_f, inside_far = !inv_f;

  bool near_ok = both && (two_s || !inside_near);
  if (near_ok)
    near_ok = !skip_match(k, prim, o.x + n.x * t_near, o.y + n.y * t_near,
                          o.z + n.z * t_near, inside_near, eps2);
  bool far_ok = two_s || !inside_far;
  if (far_ok && !near_ok)
    far_ok = !skip_match(k, prim, o.x + n.x * t_far, o.y + n.y * t_far,
                         o.z + n.z * t_far, inside_far, eps2);
  if (!(near_ok || far_ok)) return;
  const float t_pick = near_ok ? t_near : t_far;
  const float tt = t_pick * ray.dn_len;
  if (!(tt < best.t)) return;

  // Hit detail (Sphere.GetHit, Sphere.cs:156-173): position along the
  // normalized direction, normal (pos - c) / r, negated on the far root.
  float hx = o.x + n.x * t_pick;
  float hy = o.y + n.y * t_pick;
  float hz = o.z + n.z * t_pick;
  const float inv_r = 1.f / r;
  const float gflip = near_ok ? inv_r : -inv_r;
  best.t = tt;
  best.row = row;
  best.prim = prim;
  best.flags = ((near_ok ? inside_near : inside_far) ? FLAG_IN : 0) |
               (near_ok ? 0 : FLAG_IN_GEO);
  best.pos = {hx, hy, hz};
  best.nrm = {(hx - cx) * gflip, (hy - cy) * gflip, (hz - cz) * gflip};
  best.u = 0.f;
  best.v = 0.f;
}

// One root of a transformed sphere; false when the root is filtered.
__device__ __forceinline__ bool spht_root(const float* m, int prim,
                                          bool inv_f, bool two_s,
                                          bool far_root, float t_obj, V3 oo,
                                          V3 dd, const Ray& ray,
                                          float inv_rad, const Skip& k,
                                          float eps2, Winner& cand) {
  const V3 o = ray.o, d = ray.d;
  float px = oo.x + dd.x * t_obj;
  float py = oo.y + dd.y * t_obj;
  float pz = oo.z + dd.z * t_obj;
  float wx = m[12] * px + m[13] * py + m[14] * pz + m[15];
  float wy = m[16] * px + m[17] * py + m[18] * pz + m[19];
  float wz = m[20] * px + m[21] * py + m[22] * pz + m[23];
  const bool inside = far_root ? !inv_f : inv_f;
  if (!(two_s || !inside)) return false;
  if (skip_match(k, prim, wx, wy, wz, inside, eps2)) return false;
  float qx = (px - m[24]) * inv_rad;
  float qy = (py - m[25]) * inv_rad;
  float qz = (pz - m[26]) * inv_rad;
  float nwx = m[0] * qx + m[4] * qy + m[8] * qz;
  float nwy = m[1] * qx + m[5] * qy + m[9] * qz;
  float nwz = m[2] * qx + m[6] * qy + m[10] * qz;
  float nrl = 1.f / sqrtf(fmaxf(nwx * nwx + nwy * nwy + nwz * nwz, 1e-30f));
  const float flip = far_root ? -nrl : nrl;
  cand.t = d.x * (wx - o.x) + d.y * (wy - o.y) + d.z * (wz - o.z);
  cand.prim = prim;
  cand.flags = (inside ? FLAG_IN : 0) | (far_root ? FLAG_IN_GEO : 0);
  cand.pos = {wx, wy, wz};
  cand.nrm = {nwx * flip, nwy * flip, nwz * flip};
  cand.u = 0.f;
  cand.v = 0.f;
  return true;
}

__device__ __forceinline__ void spht_record(const float4* rec, const Ray& ray,
                                            const Skip& k, float eps2,
                                            Winner& best, int& tested) {
  const float4 r7 = __ldg(rec + 7);  // row, invert, two_sided, prim
  const int row = (int)r7.x;
  if (row < 0) return;
  ++tested;
  float m[28];
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    const float4 x = __ldg(rec + q);
    m[4 * q] = x.x;
    m[4 * q + 1] = x.y;
    m[4 * q + 2] = x.z;
    m[4 * q + 3] = x.w;
  }
  const bool inv_f = r7.y != 0.f;
  const bool two_s = r7.z != 0.f;
  const int prim = (int)r7.w;
  const V3 o = ray.o, d = ray.d;

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
  float cq = fx * fx + fy * fy + fz * fz - rad * rad;
  float disc = b * b - 4.f * cq;
  if (!(disc >= 0.f)) return;
  float radix = sqrtf(disc);
  if (!(radix >= -b)) return;
  const float inv_rad = 1.f / rad;

  Winner cand;
  bool got = false;
  if (radix < b)
    got = spht_root(m, prim, inv_f, two_s, false, (b - radix) * 0.5f, oo, dd,
                    ray, inv_rad, k, eps2, cand);
  if (!got)
    got = spht_root(m, prim, inv_f, two_s, true, (b + radix) * 0.5f, oo, dd,
                    ray, inv_rad, k, eps2, cand);
  if (got && cand.t < best.t) {
    best = cand;
    best.row = row;
  }
}

template <int KIND, bool STATS>
__global__ void __launch_bounds__(TRAVERSE_BLOCK)
    traverse_kernel(TraverseParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.R) return;
  const int r = p.order != nullptr ? (int)__ldg(p.order + lane) : lane;
  constexpr int REC4 = KIND == KIND_TRI ? 4 : (KIND == KIND_SPH ? 2 : 8);

  Ray ray;
  ray.o = {p.ray_o[3 * r], p.ray_o[3 * r + 1], p.ray_o[3 * r + 2]};
  ray.d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
  const V3 o = ray.o, d = ray.d;
  ray.n = d;
  ray.dn_len = 1.f;
  if (KIND != KIND_TRI) {
    // The dense path re-normalizes (Ray.Transform, Ray.cs:43-50), and on
    // tangent rays the discriminant's sign flips with sub-ulp |d|
    // deviations.
    ray.dn_len = sqrtf(fmaxf(d.x * d.x + d.y * d.y + d.z * d.z, 1e-30f));
    ray.n = {d.x / ray.dn_len, d.y / ray.dn_len, d.z / ray.dn_len};
  }
  const float ix = d.x != 0.f ? 1.f / d.x : BIG_INV;
  const float iy = d.y != 0.f ? 1.f / d.y : BIG_INV;
  const float iz = d.z != 0.f ? 1.f / d.z : BIG_INV;

  // Previous hit (skip record); none when the caller gave no record.
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
  const Skip k = make_skip(pv_prim, pv_pos, pv_nrm, pv_in, d);

  Winner best;
  best.t = INFINITY;
  best.row = -1;
  best.prim = -1;
  best.flags = 0;
  best.pos = {0.f, 0.f, 0.f};
  best.nrm = {0.f, 0.f, 0.f};
  best.u = 0.f;
  best.v = 0.f;

  int visited = 0, tested = 0;
  int node = 0;
  while (node < p.n_nodes) {
    const float4 a = __ldg(p.nodes + 2 * node);
    const float4 b = __ldg(p.nodes + 2 * node + 1);
    ++visited;
    const float tx0 = (a.x - o.x) * ix, tx1 = (a.w - o.x) * ix;
    const float ty0 = (a.y - o.y) * iy, ty1 = (b.x - o.y) * iy;
    const float tz0 = (a.z - o.z) * iz, tz1 = (b.y - o.z) * iz;
    const float near_t =
        fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    const float far_t =
        fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    const bool hit =
        near_t <= far_t && far_t >= -p.eps_behind && near_t <= best.t;
    const int slot = (int)b.w;
    if (hit && slot < 0) {
      node = node + 1;
      continue;
    }
    node = (int)b.z;
    if (!hit) continue;
    const float4* rec = p.leaves + (size_t)slot * p.K * REC4;
    for (int q = 0; q < p.K; ++q, rec += REC4) {
      if (KIND == KIND_TRI)
        tri_record(rec, ray, p.eps_behind, k, p.eps2, best, tested);
      else if (KIND == KIND_SPH)
        sph_record(rec, ray, k, p.eps2, best, tested);
      else
        spht_record(rec, ray, k, p.eps2, best, tested);
    }
  }

  p.row[r] = best.row;
  p.t[r] = best.t;
  p.prim[r] = best.prim;
  p.pos[3 * r] = best.pos.x;
  p.pos[3 * r + 1] = best.pos.y;
  p.pos[3 * r + 2] = best.pos.z;
  p.nrm[3 * r] = best.nrm.x;
  p.nrm[3 * r + 1] = best.nrm.y;
  p.nrm[3 * r + 2] = best.nrm.z;
  p.flags[r] = best.flags;
  p.u[r] = best.u;
  p.v[r] = best.v;
  if (STATS) {
    p.stats[2 * r] = visited;
    p.stats[2 * r + 1] = tested;
  }
}

template <int KIND>
int launch_traverse(const TraverseParams& p, cudaStream_t stream) {
  dim3 grid((p.R + TRAVERSE_BLOCK - 1) / TRAVERSE_BLOCK);
  if (p.stats != nullptr)
    traverse_kernel<KIND, true><<<grid, TRAVERSE_BLOCK, 0, stream>>>(p);
  else
    traverse_kernel<KIND, false><<<grid, TRAVERSE_BLOCK, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

constexpr int SORT_KEY_BLOCK = 256;

// Bit i of x (< 2^10) to bit 3i: the 3-D Morton interleave.
__device__ __forceinline__ int morton_spread(int x) {
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// One thread per ray: key = direction bin << 3*mb | Morton code of the
// origin, as sort_key_reference.  Bound by bytes: 24 read, 4 written.
__global__ void __launch_bounds__(SORT_KEY_BLOCK)
    sort_key_kernel(const float* ray_o, const float* ray_d,
                    const float* root_min, const float* root_max, int* key,
                    int R, int mb, int db) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float q_max = (float)((1 << mb) - 1);
  const int n_bins = 1 << (db + 1);
  int morton = 0, dir_bin = 0, scale = 1;
  for (int a = 0; a < 3; ++a) {
    const float lo = __ldg(root_min + a);
    const float ext = fmaxf(__ldg(root_max + a) - lo, 1e-30f);
    const float q = clip01((ray_o[3 * r + a] - lo) / ext);
    morton |= morton_spread((int)(q * q_max)) << a;
    const float dq = clip01(ray_d[3 * r + a] * 0.5f + 0.5f);
    dir_bin += scale * min(max((int)(dq * (float)n_bins), 0), n_bins - 1);
    scale *= n_bins;
  }
  key[r] = (dir_bin << (3 * mb)) | morton;
}

}  // namespace rtc

// C entry point, loaded with ctypes: the coherence key of every ray into
// `key` [R] int32, on `stream`.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a key that would not fit 31 bits.
extern "C" int rtc_sort_key(const float* ray_o, const float* ray_d,
                            const float* root_min, const float* root_max,
                            int* key, int R, int morton_bits, int dir_bits,
                            void* stream) {
  if (R <= 0) return 0;
  if (morton_bits < 1 || morton_bits > 10 || dir_bits < 0 ||
      3 * (morton_bits + dir_bits + 1) > 31)
    return (int)cudaErrorInvalidValue;
  const int blocks = (R + rtc::SORT_KEY_BLOCK - 1) / rtc::SORT_KEY_BLOCK;
  rtc::sort_key_kernel<<<blocks, rtc::SORT_KEY_BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ray_o, ray_d, root_min, root_max, key, R, morton_bits, dir_bits);
  return static_cast<int>(cudaGetLastError());
}

// C entry point, loaded with ctypes.  Launches on `stream` and returns the
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a leaf kind or sizes the kernel does not take.
// `kind`: 0 triangles (16 floats a record), 1 untransformed spheres (8),
// 2 transformed spheres (32); `stats` null: no counters; `order` null:
// thread t walks ray t.
extern "C" int rtc_traverse(
    const float* nodes, const float* leaves, const float* ray_o,
    const float* ray_d, const int* sk_prim, const float* sk_pos,
    const float* sk_nrm, const unsigned char* sk_inside,
    const long long* order, int* row, float* t,
    int* prim, float* pos, float* nrm, int* flags, float* u, float* v,
    int* stats, int R, int n_nodes, int K, int kind, float eps_behind,
    float eps2, void* stream) {
  if (R <= 0) return 0;
  if (n_nodes <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  rtc::TraverseParams p{reinterpret_cast<const float4*>(nodes),
                        reinterpret_cast<const float4*>(leaves),
                        ray_o, ray_d, sk_prim, sk_pos, sk_nrm, sk_inside,
                        order, row, t, prim, pos, nrm, flags, u, v, stats,
                        R, n_nodes, K, eps_behind, eps2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case rtc::KIND_TRI:
      return rtc::launch_traverse<rtc::KIND_TRI>(p, s);
    case rtc::KIND_SPH:
      return rtc::launch_traverse<rtc::KIND_SPH>(p, s);
    case rtc::KIND_SPHT:
      return rtc::launch_traverse<rtc::KIND_SPHT>(p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
