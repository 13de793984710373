// Per-bounce closest-hit kernel: one thread answers one ray's query against
// every row of the three packed primitive tables.
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
// normal).  A table's winner does not depend on the other tables: the
// triangle winner is the closest surviving triangle even when a sphere is
// closer.  So every table's pass runs against a Best of its own, and the
// three are merged with a strict t < in the order triangles -> spheres ->
// planes (the earliest table wins a tie, as the JAX commit does).
//
// What bounds it on Hopper: operations.  A ray reads 24 B (53 B with a skip
// record) and writes 46 B, while every (ray, row) pair costs some 50 fp32
// operations of Moller-Trumbore before its first exit: at 490,000 rays and
// 722 rows that is about 2e10 operations against 5e7 bytes.
//
// What the design does about it:
//   * the packed tables are copied into dynamic shared memory once per
//     block (up to 96 KB at the 768-row cap, above the 48 KB default, hence
//     cudaFuncSetAttribute below), so a row read in the loops is a
//     broadcast from shared memory;
//   * ray, skip record and the three running winners live in registers;
//   * the row loops run at run time, and a candidate that already failed,
//     or is not closer than its table's best, skips the rest of its row's
//     work (kernel_body.cuh);
//   * the triangle pass runs with the coplanar branch and smooth normals
//     on, as the JAX kernel does.
// The TPU kernel's (8,128) ray tiles, its 128-lane padding and its unrolled
// table loops are TPU artefacts and are not carried over.
//
// Floating point: as the megakernel (fp32, -fmad=false, no fast math).

#include <cuda_runtime.h>
#include <math.h>

#include "kernel_body.cuh"

namespace rtc {

constexpr int SELECT_BLOCK = 256;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

struct SelectParams {
  const float* ray_o;             // [R,3]
  const float* ray_d;             // [R,3]
  const int* sk_prim;             // [R]   previous hit; null: no skip record
  const float* sk_pos;            // [R,3]
  const float* sk_nrm;            // [R,3]
  const unsigned char* sk_inside; // [R]   bool
  const float* tf;                // [T,21]
  const int* ti;                  // [T,4]
  const float* sf;                // [S,28]
  const int* si;                  // [S,4]
  const float* pf;                // [P,4]
  const int* pi;                  // [P,4]
  int* tri_idx;                   // [R]
  int* sph_idx;                   // [R]
  unsigned char* sph_near;        // [R]   bool
  int* pl_idx;                    // [R]
  float* t;                       // [R]
  int* prim;                      // [R]
  unsigned char* inside;          // [R]   bool
  float* pos;                     // [R,3]
  float* nrm;                     // [R,3]
  int R, T, S, P;
  float eps_behind, eps2;
};

__global__ void __launch_bounds__(SELECT_BLOCK) select_kernel(SelectParams p) {
  // --- scene tables into shared memory ------------------------------------
  extern __shared__ float smem[];
  float* s_tf = smem;
  float* s_sf = s_tf + p.T * TRI_F;
  float* s_pf = s_sf + p.S * SPH_F;
  int* s_ti = reinterpret_cast<int*>(s_pf + p.P * PL_F);
  int* s_si = s_ti + p.T * INT_F;
  int* s_pi = s_si + p.S * INT_F;
  for (int k = threadIdx.x; k < p.T * TRI_F; k += blockDim.x) s_tf[k] = p.tf[k];
  for (int k = threadIdx.x; k < p.S * SPH_F; k += blockDim.x) s_sf[k] = p.sf[k];
  for (int k = threadIdx.x; k < p.P * PL_F; k += blockDim.x) s_pf[k] = p.pf[k];
  for (int k = threadIdx.x; k < p.T * INT_F; k += blockDim.x) s_ti[k] = p.ti[k];
  for (int k = threadIdx.x; k < p.S * INT_F; k += blockDim.x) s_si[k] = p.si[k];
  for (int k = threadIdx.x; k < p.P * INT_F; k += blockDim.x) s_pi[k] = p.pi[k];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.R) return;

  const V3 o = {p.ray_o[3 * r], p.ray_o[3 * r + 1], p.ray_o[3 * r + 2]};
  const V3 d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};

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

  // --- one pass per table, each against its own best ----------------------
  Best tri = no_hit();
  triangle_pass<true, true>(p.T, s_tf, s_ti, o, d, p.eps_behind, k, p.eps2,
                            tri);
  Best sph = no_hit();
  sphere_pass(p.S, s_sf, s_si, o, d, k, p.eps2, sph);
  Best pln = no_hit();
  plane_pass(p.P, s_pf, s_pi, o, d, p.eps_behind, k, p.eps2, pln);

  // --- global record: strict t <, triangles -> spheres -> planes ----------
  Best best = tri;
  if (sph.t < best.t) best = sph;
  if (pln.t < best.t) best = pln;

  p.tri_idx[r] = tri.row;
  p.sph_idx[r] = sph.row;
  p.sph_near[r] = sph.near_root ? 1 : 0;
  p.pl_idx[r] = pln.row;
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

}  // namespace rtc

// C entry point, loaded with ctypes.  Launches on `stream` and returns the
// first CUDA error met (0 = launched): that of the shared-memory opt-in
// when the tables need more than the 48 KB default, else that of the launch.
extern "C" int rtc_select(
    const float* ray_o, const float* ray_d, const int* sk_prim,
    const float* sk_pos, const float* sk_nrm, const unsigned char* sk_inside,
    const float* tf, const int* ti, const float* sf, const int* si,
    const float* pf, const int* pi, int* tri_idx, int* sph_idx,
    unsigned char* sph_near, int* pl_idx, float* t, int* prim,
    unsigned char* inside, float* pos, float* nrm, int R, int T, int S, int P,
    float eps_behind, float eps2, void* stream) {
  if (R <= 0) return 0;
  rtc::SelectParams p{ray_o, ray_d, sk_prim, sk_pos, sk_nrm, sk_inside,
                      tf, ti, sf, si, pf, pi,
                      tri_idx, sph_idx, sph_near, pl_idx, t, prim, inside,
                      pos, nrm, R, T, S, P, eps_behind, eps2};
  size_t n_float = (size_t)T * rtc::TRI_F + (size_t)S * rtc::SPH_F +
                   (size_t)P * rtc::PL_F;
  size_t n_int = (size_t)(T + S + P) * rtc::INT_F;
  size_t smem = (n_float + n_int) * 4;
  if (smem > rtc::DEFAULT_SMEM) {
    cudaError_t err = cudaFuncSetAttribute(
        rtc::select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((R + rtc::SELECT_BLOCK - 1) / rtc::SELECT_BLOCK);
  rtc::select_kernel<<<grid, rtc::SELECT_BLOCK, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
