"""Per-row intersection passes (counterpart of
``raytracercore_tpu.intersect.kernel_body``).

The reference's intersection math (Triangle.cs:76-146, Sphere.cs:50-155,
Plane.cs:36-66, filtered through Primitive.RayTrace's invert/two-sided/skip
rules, Primitive.cs:46-75), written once as plain torch over ``[R]`` ray
tensors.  Tables are packed dense matrices (:func:`pack_tables`); each pass
walks its rows in order and reports every candidate through
``emit(row, ok, t, prim, inside_i32, pos3, nrm3, extra)``; the caller owns
the commit policy (:class:`GlobalBest`).

``csrc/kernel_body.cuh`` holds the same passes as CUDA ``__device__``
functions, one ray per thread; this module is their plain version.
"""

from __future__ import annotations

import torch

# Packed float-table column layouts.
TRI_F = 21       # v0(3) e1(3) e2(3) n(3) n0(3) n1(3) n2(3)
SPH_F = 28       # w2o rows (12), o2w rows (12), center(3), radius
PL_F = 4         # n(3), dist
# int columns: prim_id, flag (bit0 mirror, bit1 smooth), invert, two_sided
INT_F = 4


def pack_tables(scene):
    """SceneArrays → dense (float, int) matrices per primitive table:
    ``tf [T,21] ti [T,4] sf [S,28] si [S,4] pf [P,4] pi [P,4]``."""
    mats = scene.materials

    def icols(prim_id, flag):
        safe = torch.clamp(prim_id, min=0).long()
        return torch.stack(
            [prim_id, flag.to(torch.int32),
             mats.invert[safe].to(torch.int32),
             mats.two_sided[safe].to(torch.int32)], dim=1)

    tri = scene.triangles
    tf = torch.cat([tri.v0, tri.e1, tri.e2, tri.normal,
                    tri.n0, tri.n1, tri.n2], dim=1)
    tflag = tri.mirror.to(torch.int32) + 2 * tri.smooth.to(torch.int32)
    ti = icols(tri.prim_id, tflag)

    sph = scene.spheres
    w2o = sph.world_to_obj[:, :3, :].reshape(-1, 12)
    o2w = sph.obj_to_world[:, :3, :].reshape(-1, 12)
    sf = torch.cat([w2o, o2w, sph.center, sph.radius[:, None]], dim=1)
    si = icols(sph.prim_id, torch.zeros_like(sph.prim_id))

    pln = scene.planes
    pf = torch.cat([pln.normal, pln.origin_dist[:, None]], dim=1)
    pi = icols(pln.prim_id, torch.zeros_like(pln.prim_id))
    return tf, ti, sf, si, pf, pi


def make_skip_match(d3, skip, eps_pos):
    """Batched Util.RayHitMatches (Util.cs:179-192).

    ``skip`` is None (no previous hit: camera rays) or a dict with keys
    ``prim`` (i32), ``px py pz`` (f32), ``nx ny nz`` (f32), ``inside``
    (i32 0/1).  Returns ``match(prim_id, px, py, pz, inside) → bool [R]``.
    The position test is relative: ``|p - k|² ≤ eps² · (1 + |k|²)``.
    """
    if skip is None:
        return None

    d_x, d_y, d_z = d3
    k_prim = skip["prim"]
    k_px, k_py, k_pz = skip["px"], skip["py"], skip["pz"]
    k_leaving = (d_x * skip["nx"] + d_y * skip["ny"]
                 + d_z * skip["nz"]) > 0
    k_inside = skip["inside"] != 0
    k_scale = 1.0 + k_px * k_px + k_py * k_py + k_pz * k_pz
    eps2 = eps_pos * eps_pos

    def match(prim_id, px, py, pz, inside):
        dx, dy, dz = px - k_px, py - k_py, pz - k_pz
        d2 = dx * dx + dy * dy + dz * dz
        pos_close = d2 <= eps2 * k_scale
        parity = k_leaving ^ (inside == k_inside)
        return (k_prim == prim_id) & (k_prim >= 0) & pos_close & parity

    return match


def _not_skipped(skip_match, ok, prim, px, py, pz, inside):
    if skip_match is None:
        return ok
    return ok & ~skip_match(prim, px, py, pz, inside)


def surely_outside(num, det):
    """The division-free pre-reject of the select kernel's triangle scan
    (``csrc/kernel_body.cuh`` ``surely_outside``), f32: True only where the
    exact test's ``u = inv * num`` (or ``v``), with ``inv = 1 / det``
    correctly rounded, is certain to fall outside ``[0, 1]`` or to be NaN,
    so that :func:`triangle_pass` rejects the row.

    Below 0: the signs differ and ``|num| >= max(|det|, 1) * 2^-100``, so
    the product cannot round to -0 (for ``|det| <= 1``, ``|inv| >= 1``
    keeps any nonzero ``num`` nonzero; above, the quotient is at least
    2^-100).  Above 1: the signs agree and ``|num| > |det| * (1 + 2^-20)``,
    more than the two roundings (2^-23 together) can take back.  ``det ==
    0`` is never rejected here (the coplanar branch may keep the row)."""
    an, ad = torch.abs(num), torch.abs(det)
    opposite = torch.signbit(num) != torch.signbit(det)
    below = opposite & (an >= torch.fmax(ad, torch.ones_like(ad))
                        * 2.0 ** -100)
    above = ~opposite & (an > ad * (1.0 + 2.0 ** -20))
    return (det != 0) & (below | above)


def triangle_pass(tf, ti, o3, d3, eps_behind, skip_match, emit,
                  coplanar=True, any_smooth=True):
    """Möller–Trumbore over all triangle rows (Triangle.cs:148-224,
    including the mirrored-quad UV rule and, with ``coplanar``, the
    degenerate ray-in-plane branch).  ``any_smooth=False`` folds the
    smooth-normal interpolation to the face-normal flip, which is exact
    when no row is smooth."""
    o_x, o_y, o_z = o3
    d_x, d_y, d_z = d3
    for t in range(tf.shape[0]):
        v0x, v0y, v0z = tf[t, 0], tf[t, 1], tf[t, 2]
        e1x, e1y, e1z = tf[t, 3], tf[t, 4], tf[t, 5]
        e2x, e2y, e2z = tf[t, 6], tf[t, 7], tf[t, 8]
        fnx, fny, fnz = tf[t, 9], tf[t, 10], tf[t, 11]
        prim = ti[t, 0]
        mirror = (ti[t, 1] & 1) != 0
        smooth = (ti[t, 1] & 2) != 0
        inv_f = ti[t, 2] != 0
        two_s = ti[t, 3] != 0

        sx = d_y * e2z - d_z * e2y
        sy = d_z * e2x - d_x * e2z
        sz = d_x * e2y - d_y * e2x
        det = e1x * sx + e1y * sy + e1z * sz
        fx, fy, fz = o_x - v0x, o_y - v0y, o_z - v0z
        nz_det = det != 0
        inv = torch.where(nz_det,
                          1.0 / torch.where(nz_det, det, torch.ones_like(det)),
                          torch.zeros_like(det))
        u_n = inv * (fx * sx + fy * sy + fz * sz)
        ocx = fy * e1z - fz * e1y
        ocy = fz * e1x - fx * e1z
        ocz = fx * e1y - fy * e1x
        v_n = inv * (d_x * ocx + d_y * ocy + d_z * ocz)
        t_n = inv * (e2x * ocx + e2y * ocy + e2z * ocz)

        if coplanar:
            on_plane = torch.abs(fx * fnx + fy * fny + fz * fnz) <= eps_behind
            degen = ~nz_det & on_plane
            u = torch.where(degen, e1x * fx + e1y * fy + e1z * fz, u_n)
            v = torch.where(degen, e2x * fx + e2y * fy + e2z * fz, v_n)
            tt = t_n  # already 0 where det == 0, the coplanar distance
            inside_geo = degen | (inv < 0)
            det_ok = nz_det | degen
        else:
            u, v, tt = u_n, v_n, t_n
            inside_geo = inv < 0
            det_ok = nz_det

        uv_lim = torch.where(mirror, v, u + v)
        ok = ((u >= 0) & (u <= 1) & (v >= 0) & (uv_lim <= 1)
              & (tt >= -eps_behind) & det_ok & (prim >= 0))
        inside = inside_geo ^ inv_f
        ok = ok & (two_s | ~inside)

        # Exact hit position (Triangle.cs:192).
        hx = v0x + e1x * u + e2x * v
        hy = v0y + e1y * u + e2y * v
        hz = v0z + e1z * u + e2z * v
        ok = _not_skipped(skip_match, ok, prim, hx, hy, hz, inside)

        # Normal (Triangle.GetNormal, Triangle.cs:209-224).
        flip = torch.where(inside_geo, -1.0, 1.0)
        flx, fly, flz = fnx * flip, fny * flip, fnz * flip
        if any_smooth:
            n0x, n0y, n0z = tf[t, 12], tf[t, 13], tf[t, 14]
            n1x, n1y, n1z = tf[t, 15], tf[t, 16], tf[t, 17]
            n2x, n2y, n2z = tf[t, 18], tf[t, 19], tf[t, 20]
            w2 = u + v
            ix = n0x * u + n1x * v + n2x * w2
            iy = n0y * u + n1y * v + n2y * w2
            iz = n0z * u + n1z * v + n2z * w2
            rl = 1.0 / torch.sqrt(
                torch.clamp(ix * ix + iy * iy + iz * iz, min=1e-30))
            ix, iy, iz = ix * rl, iy * rl, iz * rl
            dotf = ix * fnx + iy * fny + iz * fnz
            # inside: reflect the interpolated normal through the face plane
            rx = ix - fnx * (2.0 * dotf)
            ry = iy - fny * (2.0 * dotf)
            rz = iz - fnz * (2.0 * dotf)
            nx = torch.where(smooth, torch.where(inside_geo, rx, ix), flx)
            ny = torch.where(smooth, torch.where(inside_geo, ry, iy), fly)
            nz = torch.where(smooth, torch.where(inside_geo, rz, iz), flz)
        else:
            nx, ny, nz = flx, fly, flz

        emit(t, ok, tt, prim, inside.to(torch.int32),
             (hx, hy, hz), (nx, ny, nz), {})


def sphere_pass(sf, si, o3, d3, skip_match, emit):
    """Two-root transformed-sphere intersection (Sphere.cs:156-209).  Emits
    the merged near-preferred candidate per row with
    ``extra={"v_near": i32}``; ``t`` is recomputed in world space from the
    world-space hit position."""
    o_x, o_y, o_z = o3
    d_x, d_y, d_z = d3
    for s in range(sf.shape[0]):
        def m(k):
            return sf[s, k]
        oox = m(0) * o_x + m(1) * o_y + m(2) * o_z + m(3)
        ooy = m(4) * o_x + m(5) * o_y + m(6) * o_z + m(7)
        ooz = m(8) * o_x + m(9) * o_y + m(10) * o_z + m(11)
        ddx = m(0) * d_x + m(1) * d_y + m(2) * d_z
        ddy = m(4) * d_x + m(5) * d_y + m(6) * d_z
        ddz = m(8) * d_x + m(9) * d_y + m(10) * d_z
        dlen = 1.0 / torch.sqrt(
            torch.clamp(ddx * ddx + ddy * ddy + ddz * ddz, min=1e-30))
        ddx, ddy, ddz = ddx * dlen, ddy * dlen, ddz * dlen

        cx, cy, cz, rad = m(24), m(25), m(26), m(27)
        fx, fy, fz = oox - cx, ooy - cy, ooz - cz
        b = -2.0 * (fx * ddx + fy * ddy + fz * ddz)
        c = fx * fx + fy * fy + fz * fz - rad * rad
        disc = b * b - 4.0 * c
        has_root = disc >= 0
        radix = torch.sqrt(torch.where(has_root, disc, torch.zeros_like(disc)))
        prim = si[s, 0]
        inv_f = si[s, 2] != 0
        two_s = si[s, 3] != 0
        any_hit = has_root & (radix >= -b) & (prim >= 0)
        v_near = any_hit & (radix < b)
        v_far = any_hit
        inv_rad = 1.0 / rad

        def eval_root(t_obj, valid, geo_inside: bool):
            ts = torch.where(valid, t_obj, torch.zeros_like(t_obj))
            px = oox + ddx * ts
            py = ooy + ddy * ts
            pz = ooz + ddz * ts
            # World position via obj_to_world (Sphere.cs:158-166).
            wx = m(12) * px + m(13) * py + m(14) * pz + m(15)
            wy = m(16) * px + m(17) * py + m(18) * pz + m(19)
            wz = m(20) * px + m(21) * py + m(22) * pz + m(23)
            # Object normal, then MatrixToNormal = w2o^T (Sphere.cs:36).
            qx = (px - cx) * inv_rad
            qy = (py - cy) * inv_rad
            qz = (pz - cz) * inv_rad
            nwx = m(0) * qx + m(4) * qy + m(8) * qz
            nwy = m(1) * qx + m(5) * qy + m(9) * qz
            nwz = m(2) * qx + m(6) * qy + m(10) * qz
            nrl = 1.0 / torch.sqrt(
                torch.clamp(nwx * nwx + nwy * nwy + nwz * nwz, min=1e-30))
            nwx, nwy, nwz = nwx * nrl, nwy * nrl, nwz * nrl
            inside = (~inv_f if geo_inside else inv_f).expand(valid.shape)
            valid = valid & (two_s | ~inside)
            valid = _not_skipped(skip_match, valid, prim, wx, wy, wz, inside)
            tw = d_x * (wx - o_x) + d_y * (wy - o_y) + d_z * (wz - o_z)
            # Geometric-inside hits negate the normal (Sphere.cs:168-169).
            flip = -1.0 if geo_inside else 1.0
            return (tw, valid, inside.to(torch.int32), wx, wy, wz,
                    nwx * flip, nwy * flip, nwz * flip)

        rn = eval_root((b - radix) / 2.0, v_near, False)
        rf = eval_root((b + radix) / 2.0, v_far, True)
        v_near = rn[1]
        valid = v_near | rf[1]

        def pick(k):
            return torch.where(v_near, rn[k], rf[k])
        emit(s, valid, pick(0), prim, pick(2),
             (pick(3), pick(4), pick(5)), (pick(6), pick(7), pick(8)),
             {"v_near": v_near.to(torch.int32)})


def plane_pass(pf, pi, o3, d3, eps_behind, skip_match, emit):
    """Infinite-plane intersection with the coplanar special case
    (Plane.cs:36-66)."""
    o_x, o_y, o_z = o3
    d_x, d_y, d_z = d3
    for q in range(pf.shape[0]):
        qnx, qny, qnz, dist0 = pf[q, 0], pf[q, 1], pf[q, 2], pf[q, 3]
        prim = pi[q, 0]
        inv_f = pi[q, 2] != 0
        two_s = pi[q, 3] != 0
        ray_dist = qnx * o_x + qny * o_y + qnz * o_z
        denom = qnx * d_x + qny * d_y + qnz * d_z
        nz_den = denom != 0
        coplanar = ~nz_den & (
            torch.abs(dist0 - ray_dist)
            <= eps_behind * (1.0 + torch.abs(dist0)))
        tt = torch.where(
            nz_den,
            (dist0 - ray_dist) / torch.where(nz_den, denom,
                                             torch.ones_like(denom)),
            torch.zeros_like(denom))
        ahead = nz_den & (tt >= -eps_behind)
        t_abs = torch.where(coplanar, torch.zeros_like(tt), torch.abs(tt))
        inside_geo = coplanar | (denom > 0)
        ok = (coplanar | ahead) & (prim >= 0)
        inside = inside_geo ^ inv_f
        ok = ok & (two_s | ~inside)
        hx = o_x + d_x * t_abs
        hy = o_y + d_y * t_abs
        hz = o_z + d_z * t_abs
        ok = _not_skipped(skip_match, ok, prim, hx, hy, hz, inside)
        flip = torch.where(inside_geo, -1.0, 1.0)

        emit(q, ok, t_abs, prim, inside.to(torch.int32),
             (hx, hy, hz), (qnx * flip, qny * flip, qnz * flip), {})


class GlobalBest:
    """Running closest-hit record across tables.  The strict ``t <`` keeps
    the earliest committed candidate on a tie, so visiting triangles →
    spheres → planes in row order fixes the winner."""

    def __init__(self, like):
        self.t = torch.full_like(like, float("inf"))
        self.prim = torch.full(like.shape, -1, dtype=torch.int32,
                               device=like.device)
        self.inside = torch.zeros(like.shape, dtype=torch.int32,
                                  device=like.device)
        zero = torch.zeros_like(like)
        self.pos = (zero, zero, zero)
        self.nrm = (zero, zero, zero)

    def commit(self, ok, tt, prim, inside_i32, pos3, nrm3):
        better = ok & (tt < self.t)

        def w(a, b):
            return torch.where(better, a, b)
        self.t = w(tt, self.t)
        self.prim = w(prim, self.prim)
        self.inside = w(inside_i32, self.inside)
        self.pos = tuple(w(a, b) for a, b in zip(pos3, self.pos))
        self.nrm = tuple(w(a, b) for a, b in zip(nrm3, self.nrm))
        return better
