// Camera rays (render/camera.py camera_rays) as device functions, shared by
// the megakernel's whole pass (fused.cu, PASS) and the trace route's camera
// kernel (shade.cu, pass_rays_kernel).  The camera is read as CAM_F floats:
// position look side up (3 each), w2 h2 ax ay image_plane dof_amount
// focal_length.
//
// Floating point: the plain version's operation order, one rounding per
// operation (built with -fmad=false, no fast math), d / |d| where it
// normalizes, so the rays are bit-equal to camera_rays on the card.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "kernel_body.cuh"
#include "uniform_channels.cuh"

namespace rtc {

constexpr int CAM_F = 19;
constexpr int CAM_TENSORS = 11;

// The camera's CAM_F floats from its CAM_TENSORS tensors (the [3] basis,
// then the scalars), element k of CAM_F order.
__device__ __forceinline__ float camera_float(const float* const* cam,
                                              int k) {
  return k < 12 ? cam[k / 3][k % 3] : cam[k - 8][0];
}

// Camera.GetRay (render/camera.py _get_ray) for fractional pixel
// coordinates, from the camera `c` (CAM_F order).
__device__ __forceinline__ void get_ray(const float* c, int mode, float x,
                                        float y, V3& o, V3& d) {
  const float w2 = c[12], h2 = c[13], ax = c[14], ay = c[15];
  if (mode == 0) {  // frustum: d = normalize(look + side off_x + up off_y)
    const float off_x = ax * ((x - w2) / w2);
    const float off_y = ay * ((y - h2) / h2);
    d = {(c[3] + c[6] * off_x) + c[9] * off_y,
         (c[4] + c[7] * off_x) + c[10] * off_y,
         (c[5] + c[8] * off_x) + c[11] * off_y};
    const float n = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
    d = {d.x / n, d.y / n, d.z / n};
    o = {c[0], c[1], c[2]};
  } else {  // ortho: o = position + side sx + up sy, d = look
    const float sx = (x - w2) * ax, sy = (y - h2) * ay;
    o = {(c[0] + c[6] * sx) + c[9] * sy, (c[1] + c[7] * sx) + c[10] * sy,
         (c[2] + c[8] * sx) + c[11] * sy};
    d = {c[3], c[4], c[5]};
  }
}

// The camera ray of ray r (render/camera.py camera_rays): pixel
// (r % p.width, r / p.width) jittered by p.jitter[r, 0:2], offset to the
// image plane, and with depth of field (dof_amount != 0, the same for every
// ray of a launch) re-traced through the lens sample p.jitter[r, 2:4] and
// aimed at the undisturbed ray's focus point (Raytracer.cs:262-282).  `p`
// is the launch's parameters: jitter [R,4], width, cam_mode (0 frustum, 1
// ortho).
template <typename P>
__device__ __forceinline__ void camera_ray(const P& p, const float* c,
                                           int r, V3& o, V3& d) {
  const float* j = p.jitter + 4 * (size_t)r;
  const float x = (float)(r % p.width) + j[0];
  const float y = (float)(r / p.width) + j[1];
  const float ip = c[16], dof = c[17];
  get_ray(c, p.cam_mode, x, y, o, d);
  o = {o.x + d.x * ip, o.y + d.y * ip, o.z + d.z * ip};
  if (dof != 0.f) {
    const float k = c[18] - ip;  // focal_length - image_plane
    const V3 focus = {o.x + d.x * k, o.y + d.y * k, o.z + d.z * k};
    const float dist = sqrtf(j[2]) * dof;
    const float angle = j[3] * TWO_PI_F;
    const float off_x = cosf(angle) * dist;
    const float off_y = sinf(angle) * dist;
    V3 o2, d2;
    get_ray(c, p.cam_mode, x + off_x, y + off_y, o2, d2);
    o = {o2.x + d2.x * ip, o2.y + d2.y * ip, o2.z + d2.z * ip};
    d = {focus.x - o.x, focus.y - o.y, focus.z - o.z};
    const float n = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
    d = {d.x / n, d.y / n, d.z / n};
  }
}

}  // namespace rtc
