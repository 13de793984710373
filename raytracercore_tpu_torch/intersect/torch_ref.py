"""Batched torch intersection functions (counterpart of
``raytracercore_tpu.intersect.jnp_ref``, which this module mirrors function
by function).

Every candidate function evaluates a dense ``[R rays × N primitives]`` grid
with masks; the hit-detail functions evaluate ``[R]`` chosen winners.  They
are the grid oracle of the closest-hit kernel and the differentiable winner
evaluation of :mod:`.dispatch`.

Conventions:
* rays: ``ray_o``, ``ray_d`` are ``[R, 3]``; directions unit length.
* miss sentinel: ``t = +inf`` with ``valid = False``.
* grids are kept as ``[R, N]`` component planes, never ``[R, N, 3]``:
  vector operands are split at entry (``unbind``), so a grid costs one
  plane per scalar.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..scene.types import Planes, Spheres, Triangles

INF = float("inf")


def moller_trumbore(o, d, v0, e1, e2, normal, mirror, table_ok, near_enough):
    """Möller–Trumbore core on broadcast-compatible operand shapes.

    Mirrors the scalar path Triangle.DoRayTrace (Triangle.cs:148-207)
    including the degenerate ray-in-plane branch (:161-171, with the
    "origin on the plane" check the reference's comment assumes), backface
    ``inside = det-reciprocal < 0`` (:179) and the behind-ray cull at
    ``-NearEnough`` (:189).  ``mirror`` widens the UV test from ``u+v ≤ 1``
    to ``v ≤ 1`` (parallelogram, :118/:167).

    Shapes: vector operands ``[..., 3]``; mirror/table_ok bool ``[...]``.
    Returns dict of ``[...]`` tensors: t, u, v, inside, valid.
    """
    o3, d3 = o.unbind(-1), d.unbind(-1)
    v03, e13, e23 = v0.unbind(-1), e1.unbind(-1), e2.unbind(-1)
    side = vm.cross3(d3, e23)
    det = vm.dot3(e13, side)                # Edge0to1 · (d × e2)
    offset = (o3[0] - v03[0], o3[1] - v03[1], o3[2] - v03[2])

    # Non-degenerate path
    nz_det = det != 0
    inv_det = torch.where(nz_det, 1.0 / torch.where(nz_det, det, 1.0), 0.0)
    u_n = inv_det * vm.dot3(offset, side)
    off_cross = vm.cross3(offset, e13)
    v_n = inv_det * vm.dot3(d3, off_cross)
    t_n = inv_det * vm.dot3(e23, off_cross)
    inside_n = inv_det < 0

    # Degenerate path: ray origin lies in the triangle plane (det == 0):
    # unprojected UVs and a t = 0 hit with inside = True.
    u_d = vm.dot3(e13, offset)
    v_d = vm.dot3(e23, offset)
    on_plane = torch.abs(vm.dot3(offset, normal.unbind(-1))) <= near_enough
    degenerate = ~nz_det & on_plane

    u = torch.where(degenerate, u_d, u_n)
    v = torch.where(degenerate, v_d, v_n)
    t = torch.where(degenerate, 0.0, t_n)
    inside = degenerate | inside_n

    uv_limit = torch.where(mirror, v, u + v)
    uv_ok = (u >= 0) & (u <= 1) & (v >= 0) & (uv_limit <= 1)
    ahead = degenerate | (t >= -near_enough)
    # det == 0 off-plane is a miss (the zeroed inv_det would otherwise make
    # u = v = t = 0 pass every test).
    solvable = nz_det | degenerate
    valid = uv_ok & ahead & solvable & table_ok

    t = torch.where(valid, t, INF)
    return {"t": t, "u": u, "v": v, "inside": inside, "valid": valid}


def triangle_candidates(tri: Triangles, ray_o, ray_d, near_enough):
    """Möller–Trumbore over all (ray, triangle) pairs → ``[R, T]`` grids."""
    return moller_trumbore(
        ray_o[:, None, :], ray_d[:, None, :],
        tri.v0[None, :, :], tri.e1[None, :, :], tri.e2[None, :, :],
        tri.normal[None, :, :], tri.mirror[None, :],
        (tri.prim_id >= 0)[None, :], near_enough)


def triangle_hit_detail(tri: Triangles, idx, u, v, inside):
    """Exact position/normal for chosen triangle hits.

    Args: idx [R] triangle-table index, u/v [R], inside [R].  Position =
    v0 + e1·u + e2·v (Triangle.cs:192).  Normal per Triangle.GetNormal
    (Triangle.cs:209-224), with the reference's interpolation weights
    ``(u, v, u+v)``.
    """
    position = tri.v0[idx] + tri.e1[idx] * u[:, None] + tri.e2[idx] * v[:, None]

    face_n = tri.normal[idx]
    smooth = tri.smooth[idx]

    n_interp = (tri.n0[idx] * u[:, None] + tri.n1[idx] * v[:, None]
                + tri.n2[idx] * (u + v)[:, None])
    n_interp = vm.normalize(n_interp, eps=1e-30)
    # Inside: reflect the interpolated normal through the face plane
    # (Triangle.cs:216-218); for flat shading just negate.
    n_interp_in = n_interp - face_n * (
        2.0 * vm.dot(n_interp, face_n) / vm.dot(face_n, face_n))[:, None]
    n_smooth = torch.where(inside[:, None], n_interp_in, n_interp)
    n_flat = torch.where(inside[:, None], -face_n, face_n)

    normal = torch.where(smooth[:, None], n_smooth, n_flat)
    return position, normal


def rows3(m, x, y, z, offset=True):
    """Rows 0-2 of the ``[S, 4, 4]`` matrices applied to ``[R, 1]`` planes:
    three ``[R, S]`` planes."""
    out = []
    for i in range(3):
        r = m[None, :, i, 0] * x + m[None, :, i, 1] * y + m[None, :, i, 2] * z
        out.append(r + m[None, :, i, 3] if offset else r)
    return tuple(out)


def sphere_candidates(sph: Spheres, ray_o, ray_d):
    """Quadratic sphere test over all (ray, sphere) pairs, transformed
    spheres included (Sphere.DoRayTrace, Sphere.cs:175-209): the ray goes
    to object space, ``t² - b·t + c = 0`` with ``b = -2·offset·dir``, the
    near root (inside=False) valid only when ``radix < b``, the far root
    (inside=True) on every intersection.

    Returns dict of ``[R, S]`` planes: t_near_obj, t_far_obj, valid_near,
    valid_far, and the object-space rays ``o_obj``/``d_obj`` as 3-tuples of
    planes.
    """
    w2o = sph.world_to_obj                     # [S, 4, 4]
    ox, oy, oz = (ray_o[:, k, None] for k in range(3))
    dx, dy, dz = (ray_d[:, k, None] for k in range(3))
    o_obj = rows3(w2o, ox, oy, oz)
    d_obj = rows3(w2o, dx, dy, dz, offset=False)
    # Ray.Transform re-normalizes the direction (Ray.cs:43-50).
    d_len = torch.sqrt(vm.dot3(d_obj, d_obj))
    d_obj = (d_obj[0] / d_len, d_obj[1] / d_len, d_obj[2] / d_len)

    offset = tuple(o_obj[k] - sph.center[None, :, k] for k in range(3))
    b = -2.0 * vm.dot3(offset, d_obj)
    c = vm.dot3(offset, offset) - (sph.radius ** 2)[None, :]
    disc = b * b - 4.0 * c
    # The reference's NaN radix miss signal (`!(radix >= -b)`,
    # Sphere.cs:196) as an explicit discriminant test.
    has_root = disc >= 0
    radix = vm.safe_sqrt(torch.where(has_root, disc, 1.0))

    table_ok = (sph.prim_id >= 0)[None, :]
    any_hit = has_root & (radix >= -b) & table_ok
    both = radix < b

    valid_near = any_hit & both
    valid_far = any_hit
    return {
        "o_obj": o_obj, "d_obj": d_obj,
        "t_near_obj": torch.where(valid_near, (b - radix) / 2.0, INF),
        "t_far_obj": torch.where(valid_far, (b + radix) / 2.0, INF),
        "valid_near": valid_near, "valid_far": valid_far,
    }


def sphere_hit_detail(sph: Spheres, idx, ray_o, ray_d, o_obj, d_obj, t_obj,
                      inside):
    """World position/normal/distance for chosen sphere hits
    (Sphere.GetHit, Sphere.cs:156-173).

    Args: idx [R] sphere-table index; o_obj/d_obj/t_obj [R, 3]/[R] selected
    object-space ray and root; inside [R].
    Returns (position, normal, t_world).
    """
    center, radius = sph.center[idx], sph.radius[idx]
    o2w, nmat = sph.obj_to_world[idx], sph.normal_mat[idx]
    transformed = sph.transformed[idx]

    pos_obj = o_obj + d_obj * t_obj[:, None]
    n_obj = (pos_obj - center) / radius[:, None]

    pos_w = vm.transform_point(o2w, pos_obj)
    n_w = vm.normalize(vm.transform_dir(nmat, n_obj), eps=1e-30)
    t_w = vm.dot(ray_d, pos_w - ray_o)

    position = torch.where(transformed[:, None], pos_w, pos_obj)
    normal = torch.where(transformed[:, None], n_w, n_obj)
    t = torch.where(transformed, t_w, t_obj)

    normal = torch.where(inside[:, None], -normal, normal)
    return position, normal, t


def plane_candidates(pl: Planes, ray_o, ray_d, near_enough):
    """Infinite-plane test (Plane.DoRayTrace, Plane.cs:36-66) with the
    coplanar special case (denom == 0 and the origin on the plane → t = 0
    hit with inside = True, :40-41).

    Returns dict of ``[R, P]``: t, inside, valid.
    """
    n3 = tuple(pl.normal[None, :, k] for k in range(3))
    ray_dist = vm.dot3(tuple(ray_o[:, k, None] for k in range(3)), n3)
    denom = vm.dot3(tuple(ray_d[:, k, None] for k in range(3)), n3)
    dist0 = pl.origin_dist[None, :]

    table_ok = (pl.prim_id >= 0)[None, :]

    nz_den = denom != 0
    coplanar = ~nz_den & (torch.abs(dist0 - ray_dist)
                          <= near_enough * (1.0 + torch.abs(dist0)))
    t = torch.where(nz_den, (dist0 - ray_dist) / torch.where(nz_den, denom, 1.0), 0.0)
    ahead = nz_den & (t >= -near_enough)
    # The reference recomputes the distance as |hitPos - origin|
    # (Plane.cs:61): for a unit direction that is |t|.
    t = torch.abs(t)

    inside = coplanar | (denom > 0)
    valid = (coplanar | ahead) & table_ok
    t = torch.where(valid, torch.where(coplanar, 0.0, t), INF)
    return {"t": t, "inside": inside, "valid": valid}


def plane_hit_detail(pl: Planes, idx, ray_o, ray_d, t, inside):
    """Position/normal for chosen plane hits."""
    n = pl.normal[idx]
    position = ray_o + ray_d * t[:, None]
    normal = torch.where(inside[:, None], -n, n)
    return position, normal


def aabb_slab(box_min, box_max, ray_o, ray_d):
    """AABB slab test over all (ray, box) pairs (AABB.Intersect,
    AABB.cs:107-142 AVX / :154-197 scalar).

    Zero direction components map to ±inf slab distances (the AVX blend at
    AABB.cs:116-123).  Returns (near [R, B], far [R, B]); miss ⇔ empty
    interval — callers test ``near <= far``.
    """
    near = far = None
    for k in range(3):
        o, d = ray_o[:, k, None], ray_d[:, k, None]
        lo_b, hi_b = box_min[None, :, k], box_max[None, :, k]
        zero_d = d == 0
        inv = 1.0 / torch.where(zero_d, 1.0, d)
        t0 = (lo_b - o) * inv
        t1 = (hi_b - o) * inv
        # When d == 0: inside the slab ⇒ (-inf, +inf); outside ⇒ empty.
        inside_slab = (o >= lo_b) & (o <= hi_b)
        lo = torch.where(zero_d, torch.where(inside_slab, -INF, INF),
                         torch.minimum(t0, t1))
        hi = torch.where(zero_d, torch.where(inside_slab, INF, -INF),
                         torch.maximum(t0, t1))
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    return near, far
