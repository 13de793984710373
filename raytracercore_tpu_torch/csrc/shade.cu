// One bounce of the integrator's shading, after the closest hit: miss
// handling, the recursion cap, the material fetch, the Fresnel split, pure
// black, the branch pick, the three directions, the terminal branches, the
// next ray and skip record, and the bounce's tape and record rows.
//
// Replaces the XLA fusions that the JAX package compiles the body of its
// bounce loop into (raytracercore_tpu/render/integrator.py:298-502, traced
// under jax.jit by render/renderer.py); that body has no Pallas kernel.
// Its plain version is shade_bounce_reference in
// raytracercore_tpu_torch/render/integrator.py; the Python wrapper
// shade_bounce (render/shade_kernel.py) launches this kernel once a bounce
// from render.integrator.trace.
//
// The trace route's glue-free pass (render.integrator.trace_pass, template
// flag PASS, float32) launches pass_rays_kernel once, then this kernel once
// a bounce after the closest hit (shade_bounce_pass):
//   * pass_rays_kernel builds each pixel's camera ray from the [R,4] jitter
//     (camera.cuh, render/camera.py camera_rays) and writes it with the
//     direction trace renormalizes at bounce 0;
//   * bounce 0 starts from trace's initial path state (tint 1, alive,
//     result 0, no miss, no skip record) instead of reading it;
//   * the bounce's uniform channels are computed from its raw draws [5,R]
//     (uniform_channels.cuh) where the [7,R] planes of preprocess_uniforms
//     are read otherwise;
//   * the bounce before a renormalizing one (3, 6, 9, ...) writes the next
//     direction normalized: trace reads the unnormalized one nowhere else;
//   * the last bounce adds its sample into the float32 film in place
//     (Film.add_full_frame_; one path a pixel, so no atomics) and writes no
//     state, which nothing reads.
// Same operations in the same order as the chain they replace (camera_rays,
// preprocess_uniforms, trace with this kernel, add_full_frame_), so the
// films are bit-equal.
//
// What bounds it on Hopper: memory.  A ray reads its hit record (33 bytes
// in f32), its direction, tint, alive, result and miss (38), the t of its
// hit where the path goes on or else its skip record (4 or 33), 7 uniforms
// (28; the pass form: 5 raw draws, 20, and up to six transcendentals) and
// one material row (56; the table itself, a few KB to a few MB, is
// shared by many rays), and writes its state and skip record (83), plus a
// 20-byte tape row or a 41-byte record row where asked: 190-260 bytes for
// ~250 floating point operations, far below the card's balance of ~20
// operations a byte in f32.
//
// What the design does about it: nothing clever, which is enough for a
// bounce body the eager version spread over ~300 kernels a bounce.  One
// thread per ray, one launch per bounce, every value read once and written
// once, no intermediate in device memory; the tape and record rows go
// straight into the [B, R] tape and [R, B] records that trace allocates for
// the whole loop.  The material table is read through the read-only cache
// (a mesh's table of up to 768 rows, 43 KB, stays in L1 and L2; a larger
// one is read from device memory, one row per ray).  The static choices
// (f32 or f64, tape, records) are template parameters.
//
// Floating point: the plain version's operation order, one rounding per
// operation (built with -fmad=false, no fast math), 1 / sqrt where it has
// one, constants rounded to T from their double values as PyTorch rounds
// a Python scalar, torch.maximum's NaN propagation (fmax drops a NaN), and
// torch's NaN bits for the record's "not evaluated" Fresnel: bit-equal to
// the plain version on every output and every lane, dead lanes included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"
#include "shading.cuh"
#include "uniform_channels.cuh"

namespace rtc {

constexpr int SHADE_BLOCK = 256;
// Material columns: emission, diffuse, specular, refraction (3 each), ior,
// shininess.
constexpr int SHADE_MAT_F = 14;
constexpr double PARKED = 4e8;   // config.PARKED_ORIGIN

template <typename T>
struct Vec {
  T x, y, z;
};

template <typename T>
struct ShadeParams {
  // Inputs: the hit record.
  const int* hit_prim;
  const T* hit_t;
  const T* hit_pos;  // [R,3]
  const T* hit_nrm;  // [R,3]
  const bool* hit_in;
  // The path state (its origin is never read: the next origin is the hit
  // or the parking point): the direction the query traced, tint, alive,
  // result, miss, and the skip record.
  const T* d;
  const T* tint;
  const bool* alive;
  const T* result;
  const bool* miss;
  const int* pv_prim;
  const T* pv_t;
  const T* pv_pos;
  const T* pv_nrm;
  const bool* pv_in;
  const T* u;        // [7,R]: channel c of ray r at u[c * R + r]
  const T* matf;     // [N,14]
  const T* ambient;  // [3]
  const T* air;      // [1]
  // Outputs: the new state and skip record.
  T* o_ray_o;
  T* o_ray_d;
  T* o_tint;
  bool* o_alive;
  T* o_result;
  bool* o_miss;
  int* o_pv_prim;
  T* o_pv_t;
  T* o_pv_pos;
  T* o_pv_nrm;
  bool* o_pv_in;
  // Tape [B,R] (row i written) and records [R,B] (column i written).
  int* tp_prim;
  int* tp_flags;
  T* tp_nx;
  T* tp_ny;
  T* tp_nz;
  int* rc_btype;
  int* rc_prim;
  T* rc_t;
  T* rc_pos;  // [R,B,3]
  T* rc_nrm;  // [R,B,3]
  bool* rc_in;
  T* rc_fr;
  int R, N, i, B, recursion, ambient_is_miss;
  // PASS only: u is bounce i's raw draws [5,R]; at bounce 0 the state
  // pointers are not read; renorm: the next direction is normalized; a
  // film (the last bounce): the sample is added into it and no state is
  // written.
  float* film_sum;      // [R,3]
  float* film_samples;  // [R]
  float* film_misses;   // [R]
  int renorm;
};

template <typename T>
__device__ __forceinline__ Vec<T> load3(const T* p, int r) {
  return {p[3 * (size_t)r], p[3 * (size_t)r + 1], p[3 * (size_t)r + 2]};
}

template <typename T>
__device__ __forceinline__ void store3(T* p, size_t at, Vec<T> v) {
  p[3 * at] = v.x;
  p[3 * at + 1] = v.y;
  p[3 * at + 2] = v.z;
}

template <typename T>
__device__ __forceinline__ Vec<T> pick3(bool c, Vec<T> a, Vec<T> b) {
  return c ? a : b;
}

template <typename T>
__device__ __forceinline__ Vec<T> mul3(Vec<T> a, Vec<T> b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}

// torch.maximum(x, c): NaN where x is NaN (fmax would return c).
template <typename T>
__device__ __forceinline__ T nan_max(T x, T c) {
  return (x != x || x > c) ? x : c;
}

// vecmath.safe_sqrt: sqrt(maximum(x, 1e-20)).
template <typename T>
__device__ __forceinline__ T safe_sqrt(T x) {
  return sqrt(nan_max(x, T(1e-20)));
}

// color.luminance: (0.299 r + 0.587 g) + 0.114 b.
template <typename T>
__device__ __forceinline__ T lum3(Vec<T> c) {
  return T(0.299) * c.x + T(0.587) * c.y + T(0.114) * c.z;
}

// vecmath.create_horizontal3 (Vec4D.cs:33-43).
template <typename T>
__device__ __forceinline__ Vec<T> horizontal(Vec<T> v) {
  T cx = v.y, cy = -v.x;
  T sq = cx * cx + cy * cy;
  bool good = sq > T(1.1754943508222875e-38);
  T inv = T(1) / sqrt(good ? sq : T(1));
  return {good ? cx * inv : T(1), good ? cy * inv : T(0), T(0)};
}

// vecmath.create_horizon3_cs (Vec4D.cs:52-58) with rotate_about_axis3_cs.
template <typename T>
__device__ __forceinline__ Vec<T> horizon(Vec<T> p, T z, T ct, T st) {
  Vec<T> h = horizontal(p);
  T s = safe_sqrt(T(1) - z * z);
  Vec<T> b = {p.x * z + h.x * s, p.y * z + h.y * s, p.z * z + h.z * s};
  Vec<T> k = {p.y * b.z - p.z * b.y, p.z * b.x - p.x * b.z,
              p.x * b.y - p.y * b.x};
  T kd = (p.x * b.x + p.y * b.y + p.z * b.z) * (T(1) - ct);
  return {b.x * ct + k.x * st + p.x * kd, b.y * ct + k.y * st + p.y * kd,
          b.z * ct + k.z * st + p.z * kd};
}

template <typename T>
__device__ __forceinline__ T torch_nan();
template <>
__device__ __forceinline__ float torch_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double torch_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T, bool TAPE, bool RECORD, bool PASS>
__global__ void __launch_bounds__(SHADE_BLOCK)
    shade_bounce_kernel(ShadeParams<T> p) {
  const int r = blockIdx.x * SHADE_BLOCK + threadIdx.x;
  if (r >= p.R) return;
  const T one = T(1), zero = T(0);
  const size_t R = p.R;
  const int i = p.i;
  // PASS, bounce 0: trace's initial path state, not read.
  const bool start = PASS && i == 0;

  const int prim = p.hit_prim[r];
  const bool inside = p.hit_in[r];
  const Vec<T> hpos = load3(p.hit_pos, r), hnrm = load3(p.hit_nrm, r);
  const Vec<T> d = load3(p.d, r);
  const Vec<T> tint = start ? Vec<T>{one, one, one} : load3(p.tint, r);
  Vec<T> result = start ? Vec<T>{zero, zero, zero} : load3(p.result, r);
  bool miss = start ? false : p.miss[r];
  const bool active = start ? true : p.alive[r];
  const bool found = prim >= 0;

  // --- miss handling (Raytracer.cs:81-91) ---------------------------------
  const bool was_missed = active && !found;
  if (i == 0 || p.ambient_is_miss) {
    miss = miss || was_missed;
  } else if (was_missed) {
    result = {p.ambient[0], p.ambient[1], p.ambient[2]};
  }
  bool alive = active && found;

  // --- material row (row 0 where nothing was hit) -------------------------
  const T* m = p.matf + (size_t)(found ? prim : 0) * SHADE_MAT_F;
  const Vec<T> emis = {__ldg(m), __ldg(m + 1), __ldg(m + 2)};
  const Vec<T> diff = {__ldg(m + 3), __ldg(m + 4), __ldg(m + 5)};
  const Vec<T> spec = {__ldg(m + 6), __ldg(m + 7), __ldg(m + 8)};
  const Vec<T> refr = {__ldg(m + 9), __ldg(m + 10), __ldg(m + 11)};
  const T ior = __ldg(m + 12), shin = __ldg(m + 13);
  const Vec<T> te = mul3(tint, emis);

  // --- recursion complete (Raytracer.cs:100-104) --------------------------
  bool done = false;
  if (i >= p.recursion) {
    done = alive;
    if (done) result = te;
    alive = false;
  }
  if constexpr (PASS) {
    if (p.film_sum != nullptr) {
      // The last bounce: result and miss are final (every lane is dead
      // now); Film.add_full_frame_: contrib = hit ? colour : 0 into the
      // colour sum, hit into samples, miss into misses.
      const bool hit = !miss;
      float* sum = p.film_sum + 3 * (size_t)r;
      sum[0] = sum[0] + (hit ? result.x : 0.f);
      sum[1] = sum[1] + (hit ? result.y : 0.f);
      sum[2] = sum[2] + (hit ? result.z : 0.f);
      p.film_samples[r] = p.film_samples[r] + (hit ? 1.f : 0.f);
      p.film_misses[r] = p.film_misses[r] + (hit ? 0.f : 1.f);
      return;
    }
  }

  // --- shading (computed on every lane, as the plain version does) --------
  const T* u = p.u + r;
  T u0, u1, u2, u3, u4, u5, u6;
  if constexpr (PASS) {
    // The channels of the raw draws (preprocess_uniforms; torch divides
    // by pi as a product with its f32 reciprocal).
    u0 = shine_log(u[0]);
    u1 = cos_2pi(u[R]);
    u2 = sin_2pi(u[R]);
    u3 = u[2 * R];
    u4 = two_acos(u[3 * R]) * INV_PI_F;
    u5 = cos_2pi(u[4 * R]);
    u6 = sin_2pi(u[4 * R]);
  } else {
    u0 = u[0], u1 = u[R], u2 = u[2 * R], u3 = u[3 * R];
    u4 = u[4 * R], u5 = u[5 * R], u6 = u[6 * R];
  }
  const T z_shine = isinf(shin) ? one : exp(u0 / shin);
  const Vec<T> rn = horizon(hnrm, z_shine, u1, u2);
  const T diff_lum = lum3(diff);
  T spec_lum = lum3(spec);
  T refr_lum = lum3(refr);
  const T emis_lum = lum3(emis);
  const T cos_i = -(rn.x * d.x + rn.y * d.y + rn.z * d.z);

  // Fresnel split (Raytracer.cs:120-157).
  const T air = p.air[0];
  const bool can_refract =
      (refr_lum > zero || spec_lum > zero) && ior != zero && cos_i >= zero;
  const T ior_in = inside ? ior : air;
  const T ior_out = inside ? air : ior;
  const T safe_out = ior_out == zero ? one : ior_out;
  const T ratio = ior_in / safe_out;
  const T sin_out = ratio * safe_sqrt(one - cos_i * cos_i);
  const bool tir = sin_out >= one;
  const T cos_out = safe_sqrt(one - sin_out * sin_out);
  const bool f_live = can_refract && !tir;
  const T cos_f = f_live ? cos_i : one;
  const T cos_out_f = f_live ? cos_out : one;
  const T rs = ((ior_out * cos_f) - (ior_in * cos_out_f)) /
               ((ior_out * cos_f) + (ior_in * cos_out_f));
  const T rp = ((ior_in * cos_f) - (ior_out * cos_out_f)) /
               ((ior_in * cos_f) + (ior_out * cos_out_f));
  const T fresnel = (rs * rs + rp * rp) / T(2);
  spec_lum = f_live ? spec_lum * fresnel : spec_lum;
  refr_lum = f_live ? refr_lum * (one - fresnel) : zero;
  const T total = diff_lum + spec_lum + refr_lum + emis_lum;

  // Pure black termination (Raytracer.cs:165-169).
  const bool black = alive && total <= zero;
  if (black) result = te;
  alive = alive && !black;

  // Stochastic branch selection (Raytracer.cs:177-229).
  const T ray_rand = u3 * total;
  const bool pick_refr = refr_lum != zero && (ray_rand - refr_lum <= zero);
  const T r2 = ray_rand - refr_lum;
  const bool pick_spec =
      !pick_refr && spec_lum != zero && (r2 - spec_lum <= zero);
  const T r3 = r2 - spec_lum;
  const bool pick_diff =
      !pick_refr && !pick_spec && diff_lum != zero && (r3 - diff_lum <= zero);
  const bool pick_emit = !pick_refr && !pick_spec && !pick_diff;

  // Transmission (Raytracer.cs:181-193).
  const Vec<T> refr_dir = {rn.x * (-cos_out) + (d.x + rn.x * cos_i) * ratio,
                           rn.y * (-cos_out) + (d.y + rn.y * cos_i) * ratio,
                           rn.z * (-cos_out) + (d.z + rn.z * cos_i) * ratio};
  const Vec<T> refr_tint = inside ? Vec<T>{one, one, one} : refr;
  // Specular with the rough-normal fail (Raytracer.cs:194-209).
  const T k2 = T(2) * cos_i;
  const Vec<T> spec_dir = {d.x + rn.x * k2, d.y + rn.y * k2, d.z + rn.z * k2};
  const bool spec_ok =
      (spec_dir.x * hnrm.x + spec_dir.y * hnrm.y + spec_dir.z * hnrm.z) > zero;
  // Diffuse (Raytracer.cs:210-219) around the true normal.
  const Vec<T> diff_dir = horizon(hnrm, u4, u5, u6);

  // Terminal branches: emission pick, or failed specular.
  const bool terminal = alive && (pick_emit || (pick_spec && !spec_ok));
  if (terminal) result = te;
  alive = alive && !terminal;

  const Vec<T> out_dir =
      pick3(pick_refr, refr_dir, pick3(pick_spec, spec_dir, diff_dir));
  Vec<T> new_tint = pick3(pick_refr, refr_tint, pick3(pick_spec, spec, diff));
  // Energy compensation (Raytracer.cs:238-240).
  const T comp = nan_max(total, one);
  new_tint = {new_tint.x * comp, new_tint.y * comp, new_tint.z * comp};

  // --- the next ray, parked where the path ended --------------------------
  const T parked = T(PARKED);
  store3(p.o_ray_o, r, alive ? hpos : Vec<T>{parked, parked, parked});
  Vec<T> next_d = alive ? out_dir : Vec<T>{one, zero, zero};
  if constexpr (PASS) {
    if (p.renorm) {  // vecmath.normalize: d / sqrt(d . d)
      const T n = sqrt(next_d.x * next_d.x + next_d.y * next_d.y +
                       next_d.z * next_d.z);
      next_d = {next_d.x / n, next_d.y / n, next_d.z / n};
    }
  }
  store3(p.o_ray_d, r, next_d);
  store3(p.o_tint, r, alive ? mul3(tint, new_tint) : tint);
  store3(p.o_result, r, result);
  p.o_alive[r] = alive;
  p.o_miss[r] = miss;
  if (alive) {
    p.o_pv_prim[r] = prim;
    p.o_pv_t[r] = p.hit_t[r];
    store3(p.o_pv_pos, r, hpos);
    store3(p.o_pv_nrm, r, hnrm);
    p.o_pv_in[r] = inside;
  } else if (start) {  // HitRecord.none
    p.o_pv_prim[r] = -1;
    p.o_pv_t[r] = zero;
    store3(p.o_pv_pos, r, Vec<T>{zero, zero, zero});
    store3(p.o_pv_nrm, r, Vec<T>{zero, zero, zero});
    p.o_pv_in[r] = false;
  } else {
    p.o_pv_prim[r] = p.pv_prim[r];
    p.o_pv_t[r] = p.pv_t[r];
    store3(p.o_pv_pos, r, load3(p.pv_pos, r));
    store3(p.o_pv_nrm, r, load3(p.pv_nrm, r));
    p.o_pv_in[r] = p.pv_in[r];
  }

  if (!TAPE && !RECORD) return;
  // The bounce's code; the masks are disjoint (the plain version applies
  // them in this order).
  int code = SKIPPED;
  if (was_missed) code = MISSED;
  if (done) code = RECURSION_COMPLETE;
  if (black) code = PURE_BLACK;
  if (terminal && pick_emit) code = EMISSION;
  if (terminal && pick_spec && !spec_ok) code = SPECULAR_FAIL;
  if (alive && pick_refr) code = TRANSMITTED;
  if (alive && pick_spec) code = SPECULAR;
  if (alive && pick_diff) code = DIFFUSE;
  if (TAPE) {
    const size_t at = (size_t)i * R + r;
    p.tp_prim[at] = prim;
    p.tp_flags[at] =
        code | (inside ? FLAG_INSIDE : 0) | (f_live ? FLAG_FLIVE : 0);
    p.tp_nx[at] = hnrm.x;
    p.tp_ny[at] = hnrm.y;
    p.tp_nz[at] = hnrm.z;
  }
  if (RECORD) {
    const size_t at = (size_t)r * p.B + i;
    const Vec<T> zero3 = {zero, zero, zero};
    p.rc_btype[at] = active ? code : 0;
    p.rc_prim[at] = active ? prim : -1;
    p.rc_t[at] = active ? p.hit_t[r] : zero;
    store3(p.rc_pos, at, active ? hpos : zero3);
    store3(p.rc_nrm, at, active ? hnrm : zero3);
    p.rc_in[at] = active && inside;
    p.rc_fr[at] = (active && can_refract) ? (tir ? one : fresnel)
                                          : torch_nan<T>();
  }
}

template <typename T>
int launch(const ShadeParams<T>& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.R + SHADE_BLOCK - 1) / SHADE_BLOCK));
  const bool tape = p.tp_prim != nullptr, rec = p.rc_btype != nullptr;
  if (tape && rec) {
    shade_bounce_kernel<T, true, true, false>
        <<<grid, SHADE_BLOCK, 0, stream>>>(p);
  } else if (tape) {
    shade_bounce_kernel<T, true, false, false>
        <<<grid, SHADE_BLOCK, 0, stream>>>(p);
  } else if (rec) {
    shade_bounce_kernel<T, false, true, false>
        <<<grid, SHADE_BLOCK, 0, stream>>>(p);
  } else {
    shade_bounce_kernel<T, false, false, false>
        <<<grid, SHADE_BLOCK, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The parameters from the 42 pointers of rtc_shade (19 inputs, 11 state
// outputs, 5 tape and 7 record outputs); no film, no renormalization.
template <typename T>
ShadeParams<T> shade_params(void* const* a, int R, int N, int i, int B,
                            int recursion, int ambient_is_miss) {
  ShadeParams<T> p;
  p.hit_prim = static_cast<const int*>(a[0]);
  p.hit_t = static_cast<const T*>(a[1]);
  p.hit_pos = static_cast<const T*>(a[2]);
  p.hit_nrm = static_cast<const T*>(a[3]);
  p.hit_in = static_cast<const bool*>(a[4]);
  p.d = static_cast<const T*>(a[5]);
  p.tint = static_cast<const T*>(a[6]);
  p.alive = static_cast<const bool*>(a[7]);
  p.result = static_cast<const T*>(a[8]);
  p.miss = static_cast<const bool*>(a[9]);
  p.pv_prim = static_cast<const int*>(a[10]);
  p.pv_t = static_cast<const T*>(a[11]);
  p.pv_pos = static_cast<const T*>(a[12]);
  p.pv_nrm = static_cast<const T*>(a[13]);
  p.pv_in = static_cast<const bool*>(a[14]);
  p.u = static_cast<const T*>(a[15]);
  p.matf = static_cast<const T*>(a[16]);
  p.ambient = static_cast<const T*>(a[17]);
  p.air = static_cast<const T*>(a[18]);
  p.o_ray_o = static_cast<T*>(a[19]);
  p.o_ray_d = static_cast<T*>(a[20]);
  p.o_tint = static_cast<T*>(a[21]);
  p.o_alive = static_cast<bool*>(a[22]);
  p.o_result = static_cast<T*>(a[23]);
  p.o_miss = static_cast<bool*>(a[24]);
  p.o_pv_prim = static_cast<int*>(a[25]);
  p.o_pv_t = static_cast<T*>(a[26]);
  p.o_pv_pos = static_cast<T*>(a[27]);
  p.o_pv_nrm = static_cast<T*>(a[28]);
  p.o_pv_in = static_cast<bool*>(a[29]);
  p.tp_prim = static_cast<int*>(a[30]);
  p.tp_flags = static_cast<int*>(a[31]);
  p.tp_nx = static_cast<T*>(a[32]);
  p.tp_ny = static_cast<T*>(a[33]);
  p.tp_nz = static_cast<T*>(a[34]);
  p.rc_btype = static_cast<int*>(a[35]);
  p.rc_prim = static_cast<int*>(a[36]);
  p.rc_t = static_cast<T*>(a[37]);
  p.rc_pos = static_cast<T*>(a[38]);
  p.rc_nrm = static_cast<T*>(a[39]);
  p.rc_in = static_cast<bool*>(a[40]);
  p.rc_fr = static_cast<T*>(a[41]);
  p.R = R;
  p.N = N;
  p.i = i;
  p.B = B;
  p.recursion = recursion;
  p.ambient_is_miss = ambient_is_miss;
  p.film_sum = p.film_samples = p.film_misses = nullptr;
  p.renorm = 0;
  return p;
}

// The CameraRT tensors (camera.cuh order), by value.
struct CameraPtrs {
  const float* t[CAM_TENSORS];
};

// What camera_ray reads of a launch: the jitter, the grid's width, the
// camera's mode.
struct RayGrid {
  const float* jitter;
  int width, cam_mode;
};

// Ray r's camera ray (camera.cuh camera_ray, pixel r of the row-major
// grid `width` wide) and the direction bounce 0 traces: trace's
// renormalization at bounce 0, vecmath.normalize (d / sqrt(d . d)).
__global__ void __launch_bounds__(SHADE_BLOCK)
    pass_rays_kernel(const float* jitter, CameraPtrs cam, float* ray_o,
                     float* ray_d, int R, int width, int mode) {
  __shared__ float c[CAM_F];
  for (int k = threadIdx.x; k < CAM_F; k += blockDim.x)
    c[k] = camera_float(cam.t, k);
  __syncthreads();
  const int r = blockIdx.x * SHADE_BLOCK + threadIdx.x;
  if (r >= R) return;
  V3 o, d;
  camera_ray(RayGrid{jitter, width, mode}, c, r, o, d);
  const float n = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  store3(ray_o, r, Vec<float>{o.x, o.y, o.z});
  store3(ray_d, r, Vec<float>{d.x / n, d.y / n, d.z / n});
}

}  // namespace rtc

#define RTC_SHADE_POINTERS                                                  \
  void *a0, void *a1, void *a2, void *a3, void *a4, void *a5, void *a6,     \
      void *a7, void *a8, void *a9, void *a10, void *a11, void *a12,        \
      void *a13, void *a14, void *a15, void *a16, void *a17, void *a18,     \
      void *a19, void *a20, void *a21, void *a22, void *a23, void *a24,     \
      void *a25, void *a26, void *a27, void *a28, void *a29

// The 42 pointers in the order of render/shade_kernel.py: 19 inputs, 11
// state outputs, 5 tape and 7 record outputs (a null tape or record pointer
// turns that output off).  Returns the launch's cudaGetLastError().
extern "C" int rtc_shade(
    RTC_SHADE_POINTERS, void* a30, void* a31, void* a32, void* a33,
    void* a34, void* a35, void* a36, void* a37, void* a38, void* a39,
    void* a40, void* a41, int R, int N, int i, int B, int recursion,
    int ambient_is_miss, int is_double, void* stream) {
  void* const a[42] = {a0,  a1,  a2,  a3,  a4,  a5,  a6,  a7,  a8,
                       a9,  a10, a11, a12, a13, a14, a15, a16, a17,
                       a18, a19, a20, a21, a22, a23, a24, a25, a26,
                       a27, a28, a29, a30, a31, a32, a33, a34, a35,
                       a36, a37, a38, a39, a40, a41};
  if (R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? rtc::launch(rtc::shade_params<double>(a, R, N, i, B, recursion,
                                                     ambient_is_miss),
                           s)
             : rtc::launch(rtc::shade_params<float>(a, R, N, i, B, recursion,
                                                    ambient_is_miss),
                           s);
}

// Bounce i of the trace route's glue-free pass (PASS, float32): the 19
// inputs and 11 state outputs of rtc_shade, with a15 bounce i's raw draws
// [5,R]; at bounce 0 the state inputs a6-a14 are not read; a nonzero
// `renorm` normalizes the next direction; a film (film_sum [R,3],
// film_samples [R], film_misses [R], the last bounce) takes the sample in
// place and no state output is written.  Returns cudaGetLastError().
extern "C" int rtc_shade_pass(RTC_SHADE_POINTERS, float* film_sum,
                              float* film_samples, float* film_misses, int R,
                              int N, int i, int B, int recursion,
                              int ambient_is_miss, int renorm, void* stream) {
  void* const a[42] = {a0,  a1,  a2,  a3,  a4,  a5,  a6,  a7,  a8,
                       a9,  a10, a11, a12, a13, a14, a15, a16, a17,
                       a18, a19, a20, a21, a22, a23, a24, a25, a26,
                       a27, a28, a29};
  if (R <= 0) return 0;
  rtc::ShadeParams<float> p =
      rtc::shade_params<float>(a, R, N, i, B, recursion, ambient_is_miss);
  p.film_sum = film_sum;
  p.film_samples = film_samples;
  p.film_misses = film_misses;
  p.renorm = renorm;
  const dim3 grid((unsigned)((R + rtc::SHADE_BLOCK - 1) / rtc::SHADE_BLOCK));
  rtc::shade_bounce_kernel<float, false, false, true>
      <<<grid, rtc::SHADE_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The camera rays of a pass of R = height x width pixels (row-major, `width`
// a row) from the jitter [R,4] and the camera's 11 tensors `cam` (position
// look side up, then w2 h2 ax ay image_plane dof_amount focal_length;
// `cam_mode` 0 frustum, 1 ortho): ray_o [R,3] and bounce 0's unit
// direction ray_d [R,3].  Returns cudaGetLastError().
extern "C" int rtc_pass_rays(const float* jitter, const float* const* cam,
                             float* ray_o, float* ray_d, int R, int width,
                             int cam_mode, void* stream) {
  if (R <= 0) return 0;
  rtc::CameraPtrs c;
  for (int k = 0; k < rtc::CAM_TENSORS; ++k) c.t[k] = cam[k];
  const dim3 grid((unsigned)((R + rtc::SHADE_BLOCK - 1) / rtc::SHADE_BLOCK));
  rtc::pass_rays_kernel<<<grid, rtc::SHADE_BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      jitter, c, ray_o, ray_d, R, width, cam_mode);
  return static_cast<int>(cudaGetLastError());
}
