// Whole-path megakernel: every camera path traced through every bounce,
// its final colour (and, optionally, its PathTape) written out; or, in its
// whole-pass form, one progressive pass: camera ray, path and film add.
//
// Replaces the TPU kernel raytracercore_tpu/render/fused.py:_make_kernel
// (launched by _run through pl.pallas_call, public trace_fused).  Its plain
// version is trace_fused_reference in raytracercore_tpu_torch/render/
// fused.py; the Python wrapper trace_fused launches this kernel.
//
// Two forms, a template flag (PASS) apart:
//   * rtc_trace_fused (trace_fused): a path reads its camera ray (6 floats)
//     and 7 floats of preprocessed uniforms ([B,7,R], preprocess_uniforms)
//     per bounce and writes colour and miss (4 numbers; 20 more per bounce
//     with the tape).  The tape-on recorder of the train step runs this
//     form, on the uniforms kernel's channels;
//   * rtc_trace_pass (trace_pass, PASS): the whole progressive pass of a
//     float32 film.  A path builds its camera ray from its 4 floats of
//     jitter (camera.cuh, render/camera.py camera_rays), computes the
//     uniform channels its bounce's branch reads from the 5 raw draws per
//     bounce ([B,5,R], uniform_channels.cuh), and adds its sample into the
//     film in place (Film.add_full_frame_: 20 bytes read and written a
//     pixel).  Each pixel has one path a pass, so the add needs no atomics,
//     and the sums follow the passes' launch order.  Same operations in the
//     same order as that chain (render_pass_ with trace_fused), so the
//     films are bit-equal.
//
// What bounds it on Hopper: fp32 issue, not memory.  Everything but those
// reads and writes is arithmetic on registers over the scene's table rows:
// about rows x 46-63 operations of intersection plus ~150 of shading per
// bounce (in the whole pass, ~60 more a path for its camera ray and up to
// four transcendentals a bounce for its uniform channels).  The build keeps every
// multiply and add apart (-fmad=false: the plain version's rounding), so
// the card's 67 TFLOP/s, which counts a fused multiply-add as two
// operations, is out of reach: the issue-rate probe (issue_probe.cu)
// measures the ceiling for this operation mix.  Paths end after 1 to
// recursion + 1 bounces (5.93 of 11 on average on the Cornell scene of
// chip_smoke.py), and a warp runs until its longest path ends.
//
// What the design does about it:
//   * path regeneration: a thread traces one path at a time and, when it
//     ends, takes the next path index from a counter in device memory (one
//     atomic per warp), so a warp no longer idles the lanes of its short
//     paths while its longest one runs on.  The grid is persistent (as many
//     blocks as stay resident) and the counter is zeroed on the stream: no
//     host sync, the launch can be captured in a CUDA graph.  Every output
//     stays indexed by path;
//   * the tape's rows that no path reaches (prim -1, flags 0, zero normals)
//     are written by memsets ahead of the kernel, so a path writes only the
//     bounces it reaches (regeneration scatters those writes over the
//     tape);
//   * the packed tables and the [N,14] material table (and, in the whole
//     pass, the camera's 19 floats) are copied into shared memory once per
//     block (at most 64 rows, a few KB), so every row read in the
//     intersection loops is a broadcast from shared memory;
//   * ray state lives in registers for the whole path; nothing goes to
//     device memory between bounces;
//   * candidates that cannot win (already rejected, or not closer) skip the
//     rest of their row's work (kernel_body.cuh);
//   * the static choices (tape, ambient-miss mode, smooth normals, coplanar
//     triangle branch, the whole pass) are template parameters, so a scene
//     pays only for the code it uses.
// Tried and not kept (PERF.md section 6): the select kernel's float4 rows
// and staged triangle test with warp votes, two paths per thread, the
// division-free pre-reject of u in the triangle pass, a minimum of 6 or 7
// resident blocks per SM asked of the compiler.  The TPU kernel's (8,128)
// tiles, its N-way select gather and its unrolled bounce loop are TPU
// artefacts and are not carried over.
//
// Floating point: fp32 throughout, built with -fmad=false and without fast
// math, and 1.0f / sqrtf where JAX has rsqrt, so that the comparison with
// the plain torch version measures the algorithm and not contraction.

#include <cuda_runtime.h>
#include <math.h>

#include "camera.cuh"
#include "kernel_body.cuh"
#include "shading.cuh"
#include "uniform_channels.cuh"

namespace rtc {

constexpr int MAT_F = 14;  // emission(3) diffuse(3) specular(3) refraction(3) ior shin
constexpr int SC_F = 4;    // air_ior, ambient r g b
constexpr int BLOCK = 128;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Params {
  const float* ray_o;  // [R,3]
  const float* ray_d;  // [R,3]
  const float* u;      // [B,7,R]; PASS: the raw draws [B,5,R]
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
  int* work;           // [1] path counter
  int R, T, S, P, N, n_bounces, recursion;
  float eps_behind, eps2;
  // PASS only.
  const float* jitter;             // [R,4]
  const float* cam[CAM_TENSORS];   // the CameraRT tensors (camera.cuh)
  float* film_sum;                 // [R,3]
  float* film_samples;             // [R]
  float* film_misses;              // [R]
  int width, cam_mode;             // mode 0 frustum, 1 ortho
};

// Bounce i's uniform channels of path r (preprocess_uniforms' order): read
// from the [B,7,R] planes, or (PASS) computed from the [B,5,R] raw draws
// where the bounce reads them.
template <bool PASS>
struct Uniforms {
  const float* u;  // channel (PASS: raw draw) c at u[c * R]
  int R;
  __device__ __forceinline__ Uniforms(const Params& p, int i, int r)
      : u(p.u + (size_t)i * (PASS ? 5 : 7) * p.R + r), R(p.R) {}
  __device__ __forceinline__ float shine_ln() const {
    return PASS ? shine_log(u[0]) : u[0];
  }
  __device__ __forceinline__ float shine_cos() const {
    return PASS ? cos_2pi(u[R]) : u[R];
  }
  __device__ __forceinline__ float shine_sin() const {
    return PASS ? sin_2pi(u[R]) : u[2 * R];
  }
  __device__ __forceinline__ float branch() const {
    return PASS ? u[2 * R] : u[3 * R];
  }
  __device__ __forceinline__ float diffuse_z() const {
    return PASS ? two_acos(u[3 * R]) * INV_PI_F : u[4 * R];
  }
  __device__ __forceinline__ float diffuse_cos() const {
    return PASS ? cos_2pi(u[4 * R]) : u[5 * R];
  }
  __device__ __forceinline__ float diffuse_sin() const {
    return PASS ? sin_2pi(u[4 * R]) : u[6 * R];
  }
};

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

// A thread's current path: its index (-1: none) and its state between
// bounces.
struct Path {
  int r, i;
  V3 o, d, tint, result;
  int miss;
  int pv_prim;  // previous hit (skip record); none for camera rays
  V3 pv_pos, pv_nrm;
  bool pv_in;
};

template <bool PASS>
__device__ __forceinline__ void start_path(const Params& p, const float* s_cam,
                                           int r, Path& s) {
  s.r = r < p.R ? r : -1;
  s.i = 0;
  s.o = {0.f, 0.f, 0.f};
  s.d = {0.f, 0.f, 1.f};
  if (s.r >= 0) {
    if constexpr (PASS) {
      camera_ray(p, s_cam, r, s.o, s.d);
    } else {
      s.o = {p.ray_o[3 * r], p.ray_o[3 * r + 1], p.ray_o[3 * r + 2]};
      s.d = {p.ray_d[3 * r], p.ray_d[3 * r + 1], p.ray_d[3 * r + 2]};
    }
  }
  s.tint = {1.f, 1.f, 1.f};
  s.result = {0.f, 0.f, 0.f};
  s.miss = 0;
  s.pv_prim = -1;
  s.pv_pos = {0.f, 0.f, 0.f};
  s.pv_nrm = {0.f, 0.f, 1.f};
  s.pv_in = false;
}

// The path's outputs: colour and miss (the tape rows of the bounces it
// never reached were written ahead of the kernel); or (PASS) its sample
// added into the film as Film.add_full_frame_ adds it: contrib = hit ?
// colour : 0 into the colour sum, hit into samples, miss into misses.
template <bool PASS>
__device__ __forceinline__ void end_path(const Params& p, Path& s) {
  if constexpr (PASS) {
    const int r = s.r;
    const bool hit = !s.miss;
    float* sum = p.film_sum + 3 * (size_t)r;
    sum[0] = sum[0] + (hit ? s.result.x : 0.f);
    sum[1] = sum[1] + (hit ? s.result.y : 0.f);
    sum[2] = sum[2] + (hit ? s.result.z : 0.f);
    p.film_samples[r] = p.film_samples[r] + (hit ? 1.f : 0.f);
    p.film_misses[r] = p.film_misses[r] + (hit ? 0.f : 1.f);
  } else {
    p.color[3 * s.r] = s.result.x;
    p.color[3 * s.r + 1] = s.result.y;
    p.color[3 * s.r + 2] = s.result.z;
    p.miss[s.r] = s.miss;
  }
  s.r = -1;
}

// Bounce s.i of a live path from its closest hit `best`: miss, material
// fetch, Fresnel split, branch pick and path update (Raytracer.cs:65-246).
// Returns false where the path ends at this bounce.
template <bool WANT_TAPE, bool AMBIENT_IS_MISS, bool PASS>
__device__ __forceinline__ bool bounce(const Params& p, const float* s_mf,
                                       const float* s_sc, const Best& best,
                                       Path& s) {
  const V3 zero = {0.f, 0.f, 0.f};
  const int i = s.i, r = s.r;
  const V3 d = s.d;
  ++s.i;
  // --- miss (Raytracer.cs:81-91) ------------------------------------------
  if (best.prim < 0) {
    // A primary miss is a miss sample; a secondary miss returns the
    // ambient colour, untinted, unless the scene says `ambient miss`.
    if (i == 0 || AMBIENT_IS_MISS) {
      s.miss = 1;
    } else {
      s.result = {s_sc[1], s_sc[2], s_sc[3]};
    }
    write_tape<WANT_TAPE>(p, i, r, -1, MISSED, zero);
    return false;
  }

  // --- material fetch (row = global prim id) ------------------------------
  const float* mat = s_mf + best.prim * MAT_F;
  const int in_bit = best.inside ? FLAG_INSIDE : 0;
  const V3 tint = s.tint;
  V3 te = {tint.x * mat[0], tint.y * mat[1], tint.z * mat[2]};

  // --- recursion complete (Raytracer.cs:100-104): emission only ---------
  if (i >= p.recursion) {
    s.result = te;
    write_tape<WANT_TAPE>(p, i, r, best.prim, RECURSION_COMPLETE | in_bit,
                          best.nrm);
    return false;
  }

  const float air = s_sc[0];
  const Uniforms<PASS> u(p, i, r);
  const float ior = mat[12];
  const float shin = mat[13];
  float l_e = lum(mat[0], mat[1], mat[2]);
  float l_d = lum(mat[3], mat[4], mat[5]);
  float l_s = lum(mat[6], mat[7], mat[8]);
  float l_r = lum(mat[9], mat[10], mat[11]);

  // RandomShine (Raytracer.cs:51-56): z = exp(ln U / shininess).
  float z_shine = isinf(shin) ? 1.f : expf(u.shine_ln() / shin);
  V3 rn = create_horizon_cs(best.nrm, z_shine, u.shine_cos(), u.shine_sin());
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
    float ray_rand = u.branch() * total;
    bool pick_refr = refr_lum != 0.f && (ray_rand - refr_lum <= 0.f);
    float r2 = ray_rand - refr_lum;
    bool pick_spec = !pick_refr && spec_lum != 0.f && (r2 - spec_lum <= 0.f);
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
      out_dir = create_horizon_cs(best.nrm, u.diffuse_z(), u.diffuse_cos(),
                                  u.diffuse_sin());
      new_tint = {mat[3], mat[4], mat[5]};
    } else {
      code = EMISSION;
    }
  }
  write_tape<WANT_TAPE>(p, i, r, best.prim, code | bits, best.nrm);
  if (code != TRANSMITTED && code != SPECULAR && code != DIFFUSE) {
    s.result = te;  // terminal: black, emission pick or failed specular
    return false;
  }

  // Energy compensation (Raytracer.cs:238-240), then the next ray.
  float comp = fmaxf(total, 1.f);
  s.tint = {tint.x * (new_tint.x * comp), tint.y * (new_tint.y * comp),
            tint.z * (new_tint.z * comp)};
  s.o = best.pos;
  s.d = out_dir;
  s.pv_prim = best.prim;
  s.pv_pos = best.pos;
  s.pv_nrm = best.nrm;
  s.pv_in = best.inside;
  return true;
}

__device__ __forceinline__ unsigned lane_mask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The next path index for every lane of the warp that asks (`want`), in
// lane order, from the counter in device memory: one atomic per warp.
// Every lane of the warp calls it.
__device__ __forceinline__ int fetch_path(int* counter, bool want) {
  const unsigned m = __ballot_sync(FULL_MASK, want);
  if (m == 0) return -1;
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(FULL_MASK, base, 0);
  return want ? base + __popc(m & lane_mask_lt()) : -1;
}

template <bool WANT_TAPE, bool AMBIENT_IS_MISS, bool ANY_SMOOTH,
          bool COPLANAR, bool PASS>
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
  float* s_cam = reinterpret_cast<float*>(s_pi + p.P * INT_F);
  if constexpr (PASS) {
    for (int k = threadIdx.x; k < CAM_F; k += blockDim.x)
      s_cam[k] = camera_float(p.cam, k);
  }
  __syncthreads();

  Path s;
  start_path<PASS>(p, s_cam, fetch_path(p.work, true), s);
  bool more = s.r >= 0;  // the counter may still hand this lane a path
  while (__any_sync(FULL_MASK, s.r >= 0)) {
    if (s.r >= 0) {
      // Periodic renormalization (Raytracer.cs:74-75); camera rays are
      // unit.
      if (s.i % 3 == 0 && s.i > 0) {
        const V3 d = s.d;
        float inv = 1.f / sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
        s.d = {d.x * inv, d.y * inv, d.z * inv};
      }
      // --- closest hit across all tables (triangles -> spheres -> planes)
      const Skip k = make_skip(s.pv_prim, s.pv_pos, s.pv_nrm, s.pv_in, s.d);
      Best best = no_hit();
      triangle_pass<COPLANAR, ANY_SMOOTH>(p.T, s_tf, s_ti, s.o, s.d,
                                          p.eps_behind, k, p.eps2, best);
      sphere_pass(p.S, s_sf, s_si, s.o, s.d, k, p.eps2, best);
      plane_pass(p.P, s_pf, s_pi, s.o, s.d, p.eps_behind, k, p.eps2, best);
      // --- shading; an ended path writes its outputs ----------------------
      if (!bounce<WANT_TAPE, AMBIENT_IS_MISS, PASS>(p, s_mf, s_sc, best, s))
        end_path<PASS>(p, s);
    }
    // Lanes whose path ended take the next one.
    const int r = fetch_path(p.work, more && s.r < 0);
    if (r >= 0) {
      start_path<PASS>(p, s_cam, r, s);
      more = s.r >= 0;
    }
  }
}

// Blocks that stay resident on the card for `smem` bytes of tables (the
// persistent grid), cached per device and kernel.
int resident_blocks(const void* kernel, size_t smem, int& blocks) {
  constexpr int CACHE = 64;
  static const void* key_kernel[CACHE];
  static size_t key_smem[CACHE];
  static int key_dev[CACHE], value[CACHE];
  static int used = 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  for (int k = 0; k < used; ++k)
    if (key_kernel[k] == kernel && key_smem[k] == smem && key_dev[k] == dev) {
      blocks = value[k];
      return 0;
    }
  int sms = 0, per_sm = 0;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           BLOCK, smem);
  if (err) return err;
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (used < CACHE) {
    key_kernel[used] = kernel;
    key_smem[used] = smem;
    key_dev[used] = dev;
    value[used++] = blocks;
  }
  return 0;
}

template <bool W, bool A, bool S, bool C, bool PASS>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = trace_fused_kernel<W, A, S, C, PASS>;
  int blocks = 0;
  int err = resident_blocks((const void*)kernel, smem, blocks);
  if (!err) err = (int)cudaMemsetAsync(p.work, 0, sizeof(int), stream);
  if (!err && W) {
    // The rows no path reaches: prim -1 (every bit set), flags 0, zero
    // normals, written ahead of the kernel.
    const size_t n = (size_t)p.n_bounces * p.R * sizeof(int);
    err = (int)cudaMemsetAsync(p.tape_prim, 0xff, n, stream);
    if (!err) err = (int)cudaMemsetAsync(p.tape_flags, 0, n, stream);
    if (!err) err = (int)cudaMemsetAsync(p.tape_nx, 0, n, stream);
    if (!err) err = (int)cudaMemsetAsync(p.tape_ny, 0, n, stream);
    if (!err) err = (int)cudaMemsetAsync(p.tape_nz, 0, n, stream);
  }
  if (err) return err;
  kernel<<<blocks, BLOCK, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool W, bool A, bool S, bool PASS>
int pick_c(const Params& p, size_t smem, cudaStream_t st, bool c) {
  return c ? launch<W, A, S, true, PASS>(p, smem, st)
           : launch<W, A, S, false, PASS>(p, smem, st);
}

template <bool W, bool A, bool PASS>
int pick_s(const Params& p, size_t smem, cudaStream_t st, bool s, bool c) {
  return s ? pick_c<W, A, true, PASS>(p, smem, st, c)
           : pick_c<W, A, false, PASS>(p, smem, st, c);
}

template <bool W, bool PASS>
int pick_a(const Params& p, size_t smem, cudaStream_t st, bool a, bool s,
           bool c) {
  return a ? pick_s<W, true, PASS>(p, smem, st, s, c)
           : pick_s<W, false, PASS>(p, smem, st, s, c);
}

size_t smem_bytes(int T, int S, int P, int N, bool pass) {
  return ((size_t)T * (TRI_F + INT_F) + (size_t)S * (SPH_F + INT_F) +
          (size_t)P * (PL_F + INT_F) + (size_t)N * MAT_F + SC_F +
          (pass ? CAM_F : 0)) *
         sizeof(float);
}

}  // namespace rtc

// C entry point, loaded with ctypes.  Launches on `stream` and returns the
// first CUDA error met (0 = launched).  `work` is one int32 of scratch (the
// path counter, zeroed here on the stream); with the tape, its rows are
// filled here ahead of the kernel.
extern "C" int rtc_trace_fused(
    const float* ray_o, const float* ray_d, const float* u, const float* tf,
    const int* ti, const float* sf, const int* si, const float* pf,
    const int* pi, const float* mf, const float* scf, float* color, int* miss,
    int* tape_prim, int* tape_flags, float* tape_nx, float* tape_ny,
    float* tape_nz, int* work, int R, int T, int S, int P, int N,
    int n_bounces, int recursion, float eps_behind, float eps2,
    int ambient_is_miss, int want_tape, int any_smooth, int coplanar,
    void* stream) {
  if (R <= 0) return 0;
  rtc::Params p{ray_o, ray_d, u, tf, ti, sf, si, pf, pi, mf, scf,
                color, miss, tape_prim, tape_flags, tape_nx, tape_ny, tape_nz,
                work, R, T, S, P, N, n_bounces, recursion, eps_behind, eps2};
  const size_t smem = rtc::smem_bytes(T, S, P, N, false);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a = ambient_is_miss != 0, s = any_smooth != 0, c = coplanar != 0;
  return want_tape ? rtc::pick_a<true, false>(p, smem, st, a, s, c)
                   : rtc::pick_a<false, false>(p, smem, st, a, s, c);
}

// C entry point of the whole pass, loaded with ctypes: one progressive pass
// of the R = height x width pixels (row-major, `width` a row) added into
// the float32 film (film_sum [R,3], film_samples [R], film_misses [R]) in
// place, from the jitter [R,4], the raw draws `raw` [n_bounces,5,R] and
// the camera's 11 tensors `cam` (position look side up, then the scalars
// w2 h2 ax ay image_plane dof_amount focal_length; `cam_mode` 0 frustum, 1
// ortho).  Scratch and return value as rtc_trace_fused.
extern "C" int rtc_trace_pass(
    const float* jitter, const float* raw, const float* const* cam,
    const float* tf, const int* ti, const float* sf, const int* si,
    const float* pf, const int* pi, const float* mf, const float* scf,
    float* film_sum, float* film_samples, float* film_misses, int* work,
    int R, int width, int cam_mode, int T, int S, int P, int N,
    int n_bounces, int recursion, float eps_behind, float eps2,
    int ambient_is_miss, int any_smooth, int coplanar, void* stream) {
  if (R <= 0) return 0;
  rtc::Params p{nullptr, nullptr, raw, tf, ti, sf, si, pf, pi, mf, scf,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, work, R, T, S, P, N, n_bounces, recursion,
                eps_behind, eps2, jitter};
  for (int k = 0; k < rtc::CAM_TENSORS; ++k) p.cam[k] = cam[k];
  p.film_sum = film_sum;
  p.film_samples = film_samples;
  p.film_misses = film_misses;
  p.width = width;
  p.cam_mode = cam_mode;
  const size_t smem = rtc::smem_bytes(T, S, P, N, true);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool a = ambient_is_miss != 0, s = any_smooth != 0, c = coplanar != 0;
  return rtc::pick_a<false, true>(p, smem, st, a, s, c);
}
