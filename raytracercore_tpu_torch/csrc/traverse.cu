// BVH traversal kernel: one thread walks one ray through a wide BVH (W
// children a node, collapsed from the binary skip-link tree) and commits
// the closest surviving hit of its leaves; and the key kernel that orders
// the rays for it.
//
// Replaces the TPU kernel raytracercore_tpu/bvh/pallas_traverse.py:
// _traverse_kernel (with tri_test, sph_test, spht_test and flush; launched
// by _traverse_call through pl.pallas_call; public PallasBVH.select,
// PallasSphereBVH, PallasEllipsoidBVH).  Its plain version is
// traverse_wide_reference in raytracercore_tpu_torch/bvh/cuda_traverse.py;
// the Python wrapper traverse there launches this kernel.  The key kernel is
// the counterpart of the XLA operations of PallasBVH._sort_key (no Pallas
// kernel); its plain version is sort_key_reference, its wrapper sort_key.
//
// What it computes: for every ray the winning row of the leaves' table and
// its t, plus the winner's detail (prim, position, flat normal, inside
// flags, u/v), committed in the kernel so that no caller gathers rows from
// the primitive tables.  The tree (pack_wide_nodes) is the binary preorder
// tree collapsed top down: a wide node takes an inner node's two children
// and splits its inner child of largest surface area until it has W
// children, which stay in binary preorder, each with its binary node's f32
// box bit for bit.  A node is 2W float4: the children's six box planes as
// structure of arrays, their references (inner node >= 1, leaf
// -(slot + 1), empty 0) and their binary indices (not read).  Node 0 holds
// the root's box alone, so a ray first tests the root, and a parked ray
// (origin far outside, as the integrator parks finished paths) ends after
// that one fetch.  At a node the ray slab-tests the W children (near <= far
// && far >= -eps_behind && near <= best t, the binary kernel's arithmetic),
// walks the first passing child next and pushes the others with their near
// on a stack, the last first; at a leaf it tests the leaf's K records one
// after another; then it pops until an entry's near is still <= best t.
// A candidate is committed only if it is strictly closer (t <), so the
// earliest-preorder winner wins a tie.
//
// Why it is bit-equal to the binary skip-link walk (traverse_reference):
// every box holds its subtree's boxes exactly (the builders take min/max,
// and f32 keeps them), and the rounded slab test is monotone under
// containment, so a collapsed ancestor passes wherever a descendant does,
// and a descendant's near is at least its ancestors'.  The one test that
// depends on time, near <= best t, is repeated with the child's own near
// when it is popped, at the point of the leaf sequence where the binary walk
// visits it; best t only falls.  So by induction over the leaves the wide
// walk tests the same leaves in the same order with the same best t: the
// 12 outputs and the records tested are the binary walk's.  The first
// counter is the root test plus the wide nodes fetched.
//
// The three leaf tests:
//   * triangles (16 floats a record): Moller-Trumbore with the mirror rule,
//     the coplanar branch off as in production, invert / two-sided, the
//     skip match on the exact hit position.  The arithmetic is that of
//     triangle_pass<false, ...> in kernel_body.cuh, in its order; it is
//     written out here because that pass loops over the 21-float table rows
//     and evaluates smooth normals, while a leaf record has its own layout
//     and the kernel commits the flat normal with (u, v) and the smooth
//     flag (the record epilogue, or the caller of the detail planes,
//     re-interpolates the winner's normal).  V3, Skip, make_skip and
//     skip_match are kernel_body.cuh's.
//   * untransformed spheres (8 floats): the arithmetic of sphere_pass /
//     sphere_root in kernel_body.cuh with the identity transform folded
//     away (under -fmad=false 1 * x + 0 * y + 0 * z + 0 is x, so the
//     folded form equals the general one bit for bit on finite inputs):
//     the direction times 1 / |d|, each root's position o + n * t_obj,
//     world t = d . (pos - o), both roots filtered on their own, the near
//     root preferred; the normal (pos - c) * (1 / r) normalized and
//     negated on the far root, made once for the winner after the walk.  Held to the dense scan bit for bit: at 500-
//     1,100 units the float32 quadratic keeps few digits, so any other
//     operation order moves t and the winner.  (The dense scan also keeps
//     the quadratic's false hits of rays that pass just outside a sphere;
//     where such a ray passes outside the sphere's box too, the walk never
//     reaches the leaf.)
//   * transformed spheres (32 floats): the object-space quadratic with
//     per-root world position, world-metric t and world normal: the
//     arithmetic of sphere_pass / sphere_root in kernel_body.cuh.
// The skip record is matched by primitive id (skip_match), as everywhere
// else in this package.  A zero direction component gets the finite inverse
// 3.4e38, so no 0 * inf arises in the slab test.
//
// What bounds it on Hopper: the walk is a chain of dependent loads, each
// followed by the work it decides.  By the binary walk's counts (some 40
// 32-byte nodes and 6 64-byte records a ray on a 184k-triangle mesh) the
// operations and the bytes are few against the card's rates; what a thread
// waits for is the latency of each load that names the next, and a warp
// for its longest lane.  What the design does about it: one 128-byte fetch
// (one line, read as float4 through the read-only path, __ldg) gives W = 4
// independent slab tests in registers, where the binary walk spent two or
// more dependent loads on the same boxes, so the chain is some 3x shorter
// for 4x the box tests (cheap fp32); the stack (WIDE_STACK int2 entries,
// reference and near) lives in local memory, so occupancy is set by
// registers alone and many warps hide each other's loads; the ray, the skip
// record and the running best stay in registers; the leaf tests are the
// binary kernel's.  -fmad=false halves what the card's fp32 rate could
// give, but the operations are not what bounds the walk.  Measured
// (PERF.md): 4x fewer dependent fetches than the binary walk's visits made
// the walk only 6-8 % faster, since both read the same bytes in about as
// many 16-byte loads a lane; 8-wide nodes (fewer fetches, more registers)
// and the top 256 nodes staged in shared memory per block (a 32 KB copy a
// block) were slower, as were the schedules of earlier trees (a list kernel
// for the parked rays, persistent warps that refill, postponed leaves).
// Front-to-back child order would settle ties in another order and is not
// bit-equal.  The TPU
// kernel's 8-chain block beam, pending-leaf flush, two-node speculation,
// DMA path, bf16 node words and lane padding answer the TPU's lack of a
// per-lane gather and are not carried over.
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
// The record epilogue (rtc_traverse_record; MODE_RECORD): in place of the
// detail planes, the thread writes the bounce's final hit record (prim, t,
// position, normal, inside) that dispatch.make_bvh_closest_fn returns, so
// that no eager op follows the launch.  It is the plain version's chain of
// torch ops on the detail (cuda_traverse.record_reference, which calls
// dispatch._tri_smooth_fixup, _rec_from_detail and _merge2) written for one
// ray, in that chain's operation order, and bit-equal to it:
//   * MODE_SMOOTH (the triangle table has smooth rows): a smooth winner's
//     normal is re-interpolated from its committed (u, v) and the three
//     vertex normals of its row, gathered once a ray after the walk; the
//     sum n0 u + n1 v + n2 (u + v) left to right, vm.normalize as
//     a / maximum(sqrt(dot(a, a)), 1e-30) with torch.maximum's NaN, the
//     face normal un-flipped by a multiply with +-1, reflected through the
//     face where the hit is inside the geometry;
//   * t is 0 where there is no hit or t is not finite (_fin);
//   * MODE_MERGE (a prior record is given: the triangle record before a
//     sphere BVH's, and so on): the prior record is kept unless this
//     walk's winner is strictly closer (_merge2: b.any & (~a.any | b.t <
//     a.t)), a record's hit being prim >= 0;
//   * prim is -1 where neither has a hit.
// The detail instantiations (MODE 0) are the walk and stores as before.
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

// Children a wide node, and entries of a thread's stack
// (cuda_traverse.WIDE_WIDTH, WIDE_STACK).  pack_wide_nodes gives the most
// entries a walk of its tree can need, and rtc_traverse (as the Python
// wrapper before it) refuses a tree that needs more: no builder bounds the
// depth.  The stack is local memory, so its size sets no occupancy.
constexpr int WIDE_WIDTH = 4;
constexpr int WIDE_STACK = 256;

struct TraverseParams {
  const float4* nodes;             // [M, 2W] wide nodes (pack_wide_nodes)
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
  int R, K;
  float eps_behind, eps2;
  // The record epilogue (MODE_RECORD): prim, t, pos and nrm above take the
  // record; row, flags, u, v and stats are null.
  const float* n0;                 // [N,3] vertex normals (MODE_SMOOTH)
  const float* n1;                 // [N,3]
  const float* n2;                 // [N,3]
  const int* pv_prim;              // [R]   prior record (MODE_MERGE)
  const float* pv_t;               // [R]
  const float* pv_pos;             // [R,3]
  const float* pv_nrm;             // [R,3]
  const unsigned char* pv_inside;  // [R]   bool
  unsigned char* inside;           // [R]   bool, the record's
};

// The epilogue of a launch: MODE 0 writes the detail planes; MODE_RECORD
// the final record, with MODE_SMOOTH and MODE_MERGE as above.
constexpr int MODE_RECORD = 1, MODE_SMOOTH = 2, MODE_MERGE = 4;

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
  V3 n;  // normalized direction (untransformed sphere leaves)
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
  const V3 o = ray.o, d = ray.d, n = ray.n;

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

  // sphere_root's filters on each root's position, the near root first.
  bool near_ok = both && (two_s || !inside_near);
  if (near_ok)
    near_ok = !skip_match(k, prim, o.x + n.x * t_near, o.y + n.y * t_near,
                          o.z + n.z * t_near, inside_near, eps2);
  bool far_ok = two_s || !inside_far;
  if (far_ok && !near_ok)
    far_ok = !skip_match(k, prim, o.x + n.x * t_far, o.y + n.y * t_far,
                         o.z + n.z * t_far, inside_far, eps2);
  if (!(near_ok || far_ok)) return;

  // The surviving root as sphere_root makes it: the position and world t
  // d . (pos - o).  Its normal is a function of the winner alone, made
  // once after the walk (sph_normal): until then the candidate's centre
  // rides in nrm and its radius in u.
  const float t_pick = near_ok ? t_near : t_far;
  float wx = o.x + n.x * t_pick;
  float wy = o.y + n.y * t_pick;
  float wz = o.z + n.z * t_pick;
  const float tt = d.x * (wx - o.x) + d.y * (wy - o.y) + d.z * (wz - o.z);
  if (!(tt < best.t)) return;
  best.t = tt;
  best.row = row;
  best.prim = prim;
  best.flags = ((near_ok ? inside_near : inside_far) ? FLAG_IN : 0) |
               (near_ok ? 0 : FLAG_IN_GEO);
  best.pos = {wx, wy, wz};
  best.nrm = {cx, cy, cz};
  best.u = r;
  best.v = 0.f;
}

// sphere_root's normal of the sphere leaves' winner, from its position and
// the centre and radius that sph_record left in nrm and u: (pos - c) *
// (1 / r), normalized, negated on the far root; u back to 0.
__device__ __forceinline__ void sph_normal(Winner& best) {
  const float inv_r = 1.f / best.u;
  float qx = (best.pos.x - best.nrm.x) * inv_r;
  float qy = (best.pos.y - best.nrm.y) * inv_r;
  float qz = (best.pos.z - best.nrm.z) * inv_r;
  float nrl = 1.f / sqrtf(fmaxf(qx * qx + qy * qy + qz * qz, 1e-30f));
  const float flip = (best.flags & FLAG_IN_GEO) != 0 ? -nrl : nrl;
  best.nrm = {qx * flip, qy * flip, qz * flip};
  best.u = 0.f;
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

// torch.maximum(x, c): NaN where x is NaN (fmaxf would return c).
__device__ __forceinline__ float nan_max(float x, float c) {
  return (x != x || x > c) ? x : c;
}

// _tri_smooth_fixup for one smooth winner: the normal interpolated from
// the vertex normals of its row at its (u, v), normalized, reflected
// through the face where the hit is inside the geometry.
__device__ __forceinline__ V3 smooth_normal(const TraverseParams& p,
                                            const Winner& best) {
  const float* a = p.n0 + 3 * (size_t)best.row;
  const float* b = p.n1 + 3 * (size_t)best.row;
  const float* c = p.n2 + 3 * (size_t)best.row;
  const float u = best.u, v = best.v, uv = u + v;
  V3 n = {__ldg(a) * u + __ldg(b) * v + __ldg(c) * uv,
          __ldg(a + 1) * u + __ldg(b + 1) * v + __ldg(c + 1) * uv,
          __ldg(a + 2) * u + __ldg(b + 2) * v + __ldg(c + 2) * uv};
  const float len = nan_max(sqrtf(n.x * n.x + n.y * n.y + n.z * n.z), 1e-30f);
  n = {n.x / len, n.y / len, n.z / len};
  if ((best.flags & FLAG_IN_GEO) == 0) return n;
  // The committed normal is the face normal times -1 here: un-flip it.
  const V3 fn = {best.nrm.x * -1.f, best.nrm.y * -1.f, best.nrm.z * -1.f};
  const float d2 = 2.f * (n.x * fn.x + n.y * fn.y + n.z * fn.z);
  return {n.x - fn.x * d2, n.y - fn.y * d2, n.z - fn.z * d2};
}

// The final record of ray r from the walk's winner (see the header).
template <int MODE>
__device__ __forceinline__ void write_record(const TraverseParams& p, int r,
                                             const Winner& best) {
  const bool any = best.row >= 0;
  V3 nrm = best.nrm;
  if constexpr ((MODE & MODE_SMOOTH) != 0) {
    if ((best.flags & FLAG_SMOOTH) != 0) nrm = smooth_normal(p, best);
  }
  float t = any ? best.t : 0.f;
  t = isfinite(t) ? t : 0.f;
  int prim = best.prim;
  V3 pos = best.pos;
  bool inside = (best.flags & FLAG_IN) != 0;
  bool hit = any;
  if constexpr ((MODE & MODE_MERGE) != 0) {
    const int a_prim = p.pv_prim[r];
    const float a_t = p.pv_t[r];
    const bool a_any = a_prim >= 0;
    if (!(any && (!a_any || t < a_t))) {
      prim = a_prim;
      t = a_t;
      pos = {p.pv_pos[3 * r], p.pv_pos[3 * r + 1], p.pv_pos[3 * r + 2]};
      nrm = {p.pv_nrm[3 * r], p.pv_nrm[3 * r + 1], p.pv_nrm[3 * r + 2]};
      inside = p.pv_inside[r] != 0;
    }
    hit = any || a_any;
  }
  p.prim[r] = hit ? prim : -1;
  p.t[r] = t;
  p.pos[3 * r] = pos.x;
  p.pos[3 * r + 1] = pos.y;
  p.pos[3 * r + 2] = pos.z;
  p.nrm[3 * r] = nrm.x;
  p.nrm[3 * r + 1] = nrm.y;
  p.nrm[3 * r + 2] = nrm.z;
  p.inside[r] = inside;
}

// The wide walk: node `ref` is 2W float4 = the W children's six box planes
// as structure of arrays (minx[W] miny[W] minz[W] maxx[W] maxy[W] maxz[W]),
// their references (inner wide node >= 1, leaf -(slot + 1), empty 0) and
// their binary preorder indices (not read).  One fetch, W independent slab
// tests; the passing children but the first go on the stack with their
// near, the last first, and the first is walked next without a second
// test (best.t has not moved since).  A popped entry is walked only if its
// near is still <= best.t.  MODE: the epilogue (MODE_RECORD and its flags,
// or 0 for the detail planes).
template <int KIND, bool STATS, int MODE>
__global__ void __launch_bounds__(TRAVERSE_BLOCK)
    traverse_kernel(TraverseParams p) {
  constexpr int W = WIDE_WIDTH;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.R) return;
  const int r = p.order != nullptr ? (int)__ldg(p.order + lane) : lane;
  constexpr int REC4 = KIND == KIND_TRI ? 4 : (KIND == KIND_SPH ? 2 : 8);

  Ray ray;
  ray.o = {p.ray_o[3 * r], p.ray_o[3 * r + 1], p.ray_o[3 * r + 2]};
  ray.d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
  const V3 o = ray.o, d = ray.d;
  ray.n = d;
  if (KIND != KIND_TRI) {
    const float len = sqrtf(fmaxf(d.x * d.x + d.y * d.y + d.z * d.z, 1e-30f));
    if (KIND == KIND_SPH) {
      // The dense test's normalized direction (sphere_pass: Ray.Transform,
      // Ray.cs:43-50), d times 1 / |d|: on tangent rays the discriminant's
      // sign flips with sub-ulp deviations of the direction.
      const float inv_len = 1.f / len;
      ray.n = {d.x * inv_len, d.y * inv_len, d.z * inv_len};
    } else {
      // Not read by the ellipsoid leaves, which normalize in object space;
      // kept, as the quotient, because without it the compiler allocates
      // the ellipsoid walk's registers otherwise (its SASS is the one that
      // was measured).
      ray.n = {d.x / len, d.y / len, d.z / len};
    }
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

  int2 stack[WIDE_STACK];  // (reference, near bits)
  int sp = 0;
  int fetched = 0, tested = 0;
  int ref = 0;  // node 0: the root's box alone
  for (;;) {
    if (ref >= 0) {
      const float4* nd = p.nodes + (size_t)ref * (2 * W);
      ++fetched;
      float pl[6 * W];
#pragma unroll
      for (int q = 0; q < 6 * W / 4; ++q) {
        const float4 x = __ldg(nd + q);
        pl[4 * q] = x.x;
        pl[4 * q + 1] = x.y;
        pl[4 * q + 2] = x.z;
        pl[4 * q + 3] = x.w;
      }
      int kid[W];
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const float4 x = __ldg(nd + 6 * W / 4 + q);
        kid[4 * q] = (int)x.x;
        kid[4 * q + 1] = (int)x.y;
        kid[4 * q + 2] = (int)x.z;
        kid[4 * q + 3] = (int)x.w;
      }
      int next = 0;
      float next_near = 0.f;
      bool have = false;
#pragma unroll
      for (int c = W - 1; c >= 0; --c) {
        const float tx0 = (pl[c] - o.x) * ix;
        const float tx1 = (pl[3 * W + c] - o.x) * ix;
        const float ty0 = (pl[W + c] - o.y) * iy;
        const float ty1 = (pl[4 * W + c] - o.y) * iy;
        const float tz0 = (pl[2 * W + c] - o.z) * iz;
        const float tz1 = (pl[5 * W + c] - o.z) * iz;
        const float near_t =
            fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        const float far_t =
            fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        const bool hit = kid[c] != 0 && near_t <= far_t &&
                         far_t >= -p.eps_behind && near_t <= best.t;
        if (hit) {
          if (have) stack[sp++] = make_int2(next, __float_as_int(next_near));
          next = kid[c];
          next_near = near_t;
          have = true;
        }
      }
      if (have) {
        ref = next;
        continue;
      }
    } else {
      const float4* rec = p.leaves + (size_t)(-ref - 1) * p.K * REC4;
      for (int q = 0; q < p.K; ++q, rec += REC4) {
        if (KIND == KIND_TRI)
          tri_record(rec, ray, p.eps_behind, k, p.eps2, best, tested);
        else if (KIND == KIND_SPH)
          sph_record(rec, ray, k, p.eps2, best, tested);
        else
          spht_record(rec, ray, k, p.eps2, best, tested);
      }
    }
    bool found = false;
    while (sp > 0) {
      const int2 e = stack[--sp];
      if (__int_as_float(e.y) <= best.t) {
        ref = e.x;
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  if constexpr (KIND == KIND_SPH) {
    if (best.row >= 0) sph_normal(best);
  }
  if constexpr ((MODE & MODE_RECORD) != 0) {
    write_record<MODE>(p, r, best);
    return;
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
    p.stats[2 * r] = fetched;
    p.stats[2 * r + 1] = tested;
  }
}

template <int KIND>
int launch_traverse(const TraverseParams& p, cudaStream_t stream) {
  dim3 grid((p.R + TRAVERSE_BLOCK - 1) / TRAVERSE_BLOCK);
  if (p.stats != nullptr)
    traverse_kernel<KIND, true, 0><<<grid, TRAVERSE_BLOCK, 0, stream>>>(p);
  else
    traverse_kernel<KIND, false, 0><<<grid, TRAVERSE_BLOCK, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int MODE>
int launch_record_mode(const TraverseParams& p, cudaStream_t stream) {
  dim3 grid((p.R + TRAVERSE_BLOCK - 1) / TRAVERSE_BLOCK);
  traverse_kernel<KIND, false, MODE><<<grid, TRAVERSE_BLOCK, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Smooth normals are a triangle table's: the sphere kinds take no
// MODE_SMOOTH.
template <int KIND>
int launch_record(const TraverseParams& p, bool smooth, cudaStream_t stream) {
  const bool merge = p.pv_prim != nullptr;
  if constexpr (KIND == KIND_TRI) {
    if (smooth)
      return merge ? launch_record_mode<KIND, MODE_RECORD | MODE_SMOOTH |
                                                  MODE_MERGE>(p, stream)
                   : launch_record_mode<KIND, MODE_RECORD | MODE_SMOOTH>(
                         p, stream);
  }
  return merge ? launch_record_mode<KIND, MODE_RECORD | MODE_MERGE>(p, stream)
               : launch_record_mode<KIND, MODE_RECORD>(p, stream);
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
// `wide`: [n_wide, 8 * WIDE_WIDTH] floats (pack_wide_nodes); `depth`: the
// most stack entries a walk of that tree can need; `kind`: 0 triangles (16
// floats a record), 1 untransformed spheres (8), 2 transformed spheres
// (32); `stats` null: no counters; `order` null: thread t walks ray t.
extern "C" int rtc_traverse(
    const float* wide, const float* leaves, const float* ray_o,
    const float* ray_d, const int* sk_prim, const float* sk_pos,
    const float* sk_nrm, const unsigned char* sk_inside,
    const long long* order, int* row, float* t,
    int* prim, float* pos, float* nrm, int* flags, float* u, float* v,
    int* stats, int R, int n_wide, int depth, int K, int kind,
    float eps_behind, float eps2, void* stream) {
  if (R <= 0) return 0;
  if (n_wide <= 0 || K <= 0 || depth < 0 || depth > rtc::WIDE_STACK)
    return (int)cudaErrorInvalidValue;
  rtc::TraverseParams p{reinterpret_cast<const float4*>(wide),
                        reinterpret_cast<const float4*>(leaves),
                        ray_o, ray_d, sk_prim, sk_pos, sk_nrm, sk_inside,
                        order, row, t, prim, pos, nrm, flags, u, v, stats,
                        R, K, eps_behind, eps2};
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

// C entry point, loaded with ctypes: the walk of rtc_traverse with the
// record epilogue.  Writes the final record `prim` [R] int32, `t` [R],
// `pos` [R,3], `nrm` [R,3], `inside` [R] bool.  `smooth` nonzero (triangle
// leaves only): re-interpolate smooth winners' normals from the vertex
// normals `n0`, `n1`, `n2` ([N,3] rows of the leaves' table).  `pv_prim`
// null: no prior record; else the prior record (`pv_*`, the same planes)
// is kept unless this walk's winner is strictly closer.  Returns as
// rtc_traverse does, and cudaErrorInvalidValue for smooth normals without
// their tables or on sphere leaves.
extern "C" int rtc_traverse_record(
    const float* wide, const float* leaves, const float* ray_o,
    const float* ray_d, const int* sk_prim, const float* sk_pos,
    const float* sk_nrm, const unsigned char* sk_inside,
    const long long* order, const float* n0, const float* n1,
    const float* n2, const int* pv_prim, const float* pv_t,
    const float* pv_pos, const float* pv_nrm,
    const unsigned char* pv_inside, int* prim, float* t, float* pos,
    float* nrm, unsigned char* inside, int R, int n_wide, int depth, int K,
    int kind, int smooth, float eps_behind, float eps2, void* stream) {
  if (R <= 0) return 0;
  if (n_wide <= 0 || K <= 0 || depth < 0 || depth > rtc::WIDE_STACK)
    return (int)cudaErrorInvalidValue;
  if (smooth && (kind != rtc::KIND_TRI || n0 == nullptr || n1 == nullptr ||
                 n2 == nullptr))
    return (int)cudaErrorInvalidValue;
  rtc::TraverseParams p{reinterpret_cast<const float4*>(wide),
                        reinterpret_cast<const float4*>(leaves),
                        ray_o, ray_d, sk_prim, sk_pos, sk_nrm, sk_inside,
                        order, nullptr, t, prim, pos, nrm, nullptr, nullptr,
                        nullptr, nullptr, R, K, eps_behind, eps2,
                        n0, n1, n2, pv_prim, pv_t, pv_pos, pv_nrm,
                        pv_inside, inside};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case rtc::KIND_TRI:
      return rtc::launch_record<rtc::KIND_TRI>(p, smooth != 0, s);
    case rtc::KIND_SPH:
      return rtc::launch_record<rtc::KIND_SPH>(p, false, s);
    case rtc::KIND_SPHT:
      return rtc::launch_record<rtc::KIND_SPHT>(p, false, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
