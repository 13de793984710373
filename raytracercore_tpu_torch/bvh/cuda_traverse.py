"""The BVH traversal kernel (counterpart of
``raytracercore_tpu.bvh.pallas_traverse``): the at-scale closest hit.

One launch answers one bounce's closest-hit query of every ray against one
skip-link BVH (:mod:`.builder`) whose leaves hold triangles, untransformed
spheres or transformed spheres (ellipsoids).  Each ray walks the preorder
node list through its skip links; a leaf's records are tested one after
another and a candidate is committed only if it is strictly closer
(``t <``), so leaves count in preorder and the earliest-preorder winner
wins a tie.  The kernel commits the winner's whole detail (prim, position,
flat normal, inside flags, u/v), so the dispatch layer gathers nothing from
the primitive tables.

* :func:`pack_nodes`, :func:`pack_leaf_tris`, :func:`pack_leaf_spheres`,
  :func:`pack_leaf_ellipsoids` — the arrays the kernel reads (the JAX
  package's record layouts, without its lane padding and its bf16 node
  words);
* :func:`traverse` — the wrapper: on CUDA tensors it launches
  ``csrc/traverse.cu`` (counted in ``traverse.launches``) or raises, on CPU
  tensors it runs the plain version;
* :func:`traverse_reference` — the plain version: a lockstep torch walk
  over the packed arrays with the kernel's leaf tests in the kernel's
  operation order, all 12 outputs and the optional counters;
* :class:`CudaBVH`, :class:`CudaSphereBVH`, :class:`CudaEllipsoidBVH` — the
  packed tree of one table with the ``select`` entry that
  ``dispatch.make_bvh_closest_fn`` calls.

Two choices where the JAX package's two walks differ.  A zero direction
component gets the finite inverse ``3.4e38`` (the TPU kernel's; the XLA
walk, and :mod:`.traverse` here, use ``inf`` and scrub the NaN of ``0 ·
inf``), in the kernel and in its plain version alike.  The skip record is
matched by primitive id, as :mod:`.traverse`, the dense scan and the
select kernel do; the TPU kernel matches by the previous winner's own-table
row through ``prim_to_row``, which is the same rule while every primitive
owns one row — true of every scene the loader and ``meshgen`` make
(``prim_to_row`` is kept so that a test can show it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import check_tensor as _check
from .builder import BVHArrays

TRI_F = 16   # packed floats per leaf triangle (see pack_leaf_tris)
SPH_F = 8    # packed floats per leaf sphere (see pack_leaf_spheres)
SPT_F = 32   # packed floats per leaf ellipsoid (transformed sphere)
LEAF_KINDS = {"tri": (0, TRI_F), "sph": (1, SPH_F), "spht": (2, SPT_F)}
BIG_INV = 3.4e38   # inverse of a zero direction component
INF = float("inf")
# flags plane bits
FLAG_INSIDE, FLAG_INSIDE_GEO, FLAG_SMOOTH = 1, 2, 4


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def pack_nodes(bvh: BVHArrays) -> np.ndarray:
    """[N, 8] f32: bmin(3), bmax(3), skip, leaf_slot (exact in f32 below
    2^24 nodes)."""
    n = bvh.n_nodes
    if n >= 1 << 24:
        raise ValueError(f"pack_nodes: {n} nodes do not fit f32 links")
    out = np.zeros((n, 8), np.float32)
    out[:, 0:3] = _np(bvh.bmin)
    out[:, 3:6] = _np(bvh.bmax)
    out[:, 6] = _np(bvh.skip).astype(np.float32)
    out[:, 7] = _np(bvh.leaf_slot).astype(np.float32)
    return out


def _leaf_flags(leaf_prims, prim_id, mats):
    rows = np.maximum(leaf_prims, 0)
    valid = leaf_prims >= 0
    pid = np.maximum(prim_id[rows], 0)
    invert = _np(mats.invert)[pid] & valid
    two_sided = _np(mats.two_sided)[pid] | ~valid
    return rows, valid, invert, two_sided


def pack_leaf_tris(bvh: BVHArrays, tri, mats) -> np.ndarray:
    """[L, K*TRI_F] f32 leaf-triangle blocks.

    Per-triangle layout (TRI_F floats):
      v0(3), e1(3), e2(3), fn(3) face normal, row,
      flags (mirror | invert<<1 | two_sided<<2 | smooth<<3), prim_id, 0
    Empty slots have row = prim = -1.  prim_id rides in the record so the
    kernel can emit the full winner hit detail without any [R]-row gathers
    from the primitive tables.
    """
    leaf_prims = _np(bvh.leaf_prims)
    L, K = leaf_prims.shape
    prim_id = _np(tri.prim_id)
    rows, valid, invert, two_sided = _leaf_flags(leaf_prims, prim_id, mats)
    out = np.zeros((L, K, TRI_F), np.float32)
    out[..., 0:3] = _np(tri.v0).astype(np.float32)[rows]
    out[..., 3:6] = _np(tri.e1).astype(np.float32)[rows]
    out[..., 6:9] = _np(tri.e2).astype(np.float32)[rows]
    out[..., 9:12] = _np(tri.normal).astype(np.float32)[rows]
    out[..., 12] = np.where(valid, leaf_prims, -1).astype(np.float32)
    out[..., 13] = (_np(tri.mirror)[rows].astype(np.int32)
                    + 2 * invert.astype(np.int32)
                    + 4 * two_sided.astype(np.int32)
                    + 8 * (_np(tri.smooth)[rows] & valid).astype(np.int32)
                    ).astype(np.float32)
    out[..., 14] = np.where(valid, prim_id[rows], -1).astype(np.float32)
    return out.reshape(L, K * TRI_F)


def pack_leaf_spheres(bvh: BVHArrays, sph, mats) -> np.ndarray:
    """[L, K*SPH_F] f32 leaf-sphere blocks.

    Per-sphere layout (SPH_F floats):
      center(3), radius, row, invert, two_sided, prim_id
    Empty slots have row = prim = -1.  Only untransformed spheres belong
    here (build_sphere_bvh); the kernel test is the plain quadratic.
    """
    leaf_prims = _np(bvh.leaf_prims)
    L, K = leaf_prims.shape
    prim_id = _np(sph.prim_id)
    rows, valid, invert, two_sided = _leaf_flags(leaf_prims, prim_id, mats)
    out = np.zeros((L, K, SPH_F), np.float32)
    out[..., 0:3] = _np(sph.center).astype(np.float32)[rows]
    out[..., 3] = _np(sph.radius).astype(np.float32)[rows]
    out[..., 4] = np.where(valid, leaf_prims, -1).astype(np.float32)
    out[..., 5] = invert.astype(np.float32)
    out[..., 6] = two_sided.astype(np.float32)
    out[..., 7] = np.where(valid, prim_id[rows], -1).astype(np.float32)
    return out.reshape(L, K * SPH_F)


def pack_leaf_ellipsoids(bvh: BVHArrays, sph, mats) -> np.ndarray:
    """[L, K*SPT_F] f32 leaf-ellipsoid blocks (TRANSFORMED spheres).

    Per-record layout (SPT_F floats):
      w2o rows (12), o2w rows (12), center(3), radius, row, invert,
      two_sided, prim_id.  Empty slots have row = prim = -1.  The kernel
    leaf test runs the object-space quadratic with per-root world mapping
    (Sphere.cs:156-209 via kernel_body.sphere_pass semantics).
    """
    leaf_prims = _np(bvh.leaf_prims)
    L, K = leaf_prims.shape
    prim_id = _np(sph.prim_id)
    rows, valid, invert, two_sided = _leaf_flags(leaf_prims, prim_id, mats)
    w2o = _np(sph.world_to_obj).astype(np.float32)[:, :3, :].reshape(-1, 12)
    o2w = _np(sph.obj_to_world).astype(np.float32)[:, :3, :].reshape(-1, 12)
    out = np.zeros((L, K, SPT_F), np.float32)
    out[..., 0:12] = w2o[rows]
    out[..., 12:24] = o2w[rows]
    out[..., 24:27] = _np(sph.center).astype(np.float32)[rows]
    out[..., 27] = _np(sph.radius).astype(np.float32)[rows]
    out[..., 28] = np.where(valid, leaf_prims, -1).astype(np.float32)
    out[..., 29] = invert.astype(np.float32)
    out[..., 30] = two_sided.astype(np.float32)
    out[..., 31] = np.where(valid, prim_id[rows], -1).astype(np.float32)
    return out.reshape(L, K * SPT_F)


def prim_to_row(prim_id, n_prims: int) -> np.ndarray:
    """[n_prims] int32: primitive id → its row of the table whose
    ``prim_id`` column is given, -1 for a primitive of another table (where
    a primitive owned several rows, the last)."""
    prim_id = _np(prim_id)
    inv = np.full(max(n_prims, 1), -1, np.int32)
    ok = prim_id >= 0
    inv[prim_id[ok]] = np.nonzero(ok)[0].astype(np.int32)
    return inv


class TraverseOut(NamedTuple):
    """The kernel's 12 output planes (position and normal as ``[R, 3]``)
    and its optional counters.  Where a ray hits nothing: ``row`` and
    ``prim`` -1, ``t`` inf, the others zero."""

    row: torch.Tensor        # [R] int32 winning row of the leaves' table
    t: torch.Tensor          # [R] f32, world metric
    prim: torch.Tensor       # [R] int32
    position: torch.Tensor   # [R, 3] f32
    normal: torch.Tensor     # [R, 3] f32 (FLAT normal for triangles)
    flags: torch.Tensor      # [R] int32: inside | inside_geo<<1 | smooth<<2
    u: torch.Tensor          # [R] f32 (triangles; 0 for spheres)
    v: torch.Tensor          # [R] f32
    stats: torch.Tensor | None  # [R, 2] int32: nodes visited, records tested


# ---------------------------------------------------------------------------
# The plain version: the kernel's leaf tests over [A] planes
# ---------------------------------------------------------------------------

def _skip_match(sk, prim, hx, hy, hz, inside, eps2):
    """csrc/kernel_body.cuh skip_match on planes; ``sk`` None: no record."""
    if sk is None:
        return torch.zeros_like(inside)
    dx, dy, dz = hx - sk["px"], hy - sk["py"], hz - sk["pz"]
    d2 = dx * dx + dy * dy + dz * dz
    pos_close = d2 <= eps2 * sk["scale"]
    parity = sk["leaving"] ^ (inside == sk["inside"])
    return (sk["prim"] >= 0) & (sk["prim"] == prim) & pos_close & parity


def _tri_test(m, ray, sk, eps_behind, eps2):
    """One packed triangle per ray (``m(c)``: column ``c`` of the record):
    Möller–Trumbore with the mirror rule, the coplanar branch off as in
    production, invert / two-sided, the skip match on the exact hit
    position.  Returns ``(ok, t, row, detail)``; the normal is the flat
    one (smooth scenes re-interpolate the winner's from the committed
    u/v)."""
    ox, oy, oz, dx, dy, dz = ray[:6]
    v0x, v0y, v0z = m(0), m(1), m(2)
    e1x, e1y, e1z = m(3), m(4), m(5)
    e2x, e2y, e2z = m(6), m(7), m(8)
    fnx, fny, fnz = m(9), m(10), m(11)
    row = m(12).to(torch.int32)
    flag_i = m(13).to(torch.int32)
    mirror = (flag_i & 1) != 0
    inv_f = (flag_i & 2) != 0
    two_s = (flag_i & 4) != 0
    smooth = (flag_i & 8) != 0
    prim = m(14).to(torch.int32)

    sx = dy * e2z - dz * e2y
    sy = dz * e2x - dx * e2z
    sz = dx * e2y - dy * e2x
    det = e1x * sx + e1y * sy + e1z * sz
    fx, fy, fz = ox - v0x, oy - v0y, oz - v0z
    nz_det = det != 0
    inv = torch.where(nz_det, 1.0 / torch.where(nz_det, det, 1.0), 0.0)
    u = inv * (fx * sx + fy * sy + fz * sz)
    ocx = fy * e1z - fz * e1y
    ocy = fz * e1x - fx * e1z
    ocz = fx * e1y - fy * e1x
    v = inv * (dx * ocx + dy * ocy + dz * ocz)
    tt = inv * (e2x * ocx + e2y * ocy + e2z * ocz)
    inside_geo = inv < 0

    uv_lim = torch.where(mirror, v, u + v)
    ok = ((u >= 0) & (u <= 1) & (v >= 0) & (uv_lim <= 1)
          & (tt >= -eps_behind) & nz_det & (row >= 0))
    inside = inside_geo ^ inv_f
    ok = ok & (two_s | ~inside)

    hx = v0x + e1x * u + e2x * v
    hy = v0y + e1y * u + e2y * v
    hz = v0z + e1z * u + e2z * v
    ok = ok & ~_skip_match(sk, prim, hx, hy, hz, inside, eps2)
    flip = torch.where(inside_geo, -1.0, 1.0)
    ifl = (inside.to(torch.int32) * FLAG_INSIDE
           + inside_geo.to(torch.int32) * FLAG_INSIDE_GEO
           + smooth.to(torch.int32) * FLAG_SMOOTH)
    return ok, tt, row, (prim, hx, hy, hz, fnx * flip, fny * flip,
                         fnz * flip, ifl, u, v)


def _sph_test(m, ray, sk, eps_behind, eps2):
    """One packed untransformed sphere per ray: the quadratic of
    Sphere.DoRayTrace (Sphere.cs:175-209) on the RE-NORMALIZED direction,
    both roots with two-sided / invert filtering and the skip rule per
    root, the near root preferred; t comes back in the world metric
    ``|d| · t_n̂``."""
    ox, oy, oz = ray[:3]
    nx, ny, nz, dn_len = ray[6:10]
    cx, cy, cz, r = m(0), m(1), m(2), m(3)
    row = m(4).to(torch.int32)
    inv_f = m(5) != 0
    two_s = m(6) != 0
    prim = m(7).to(torch.int32)

    fx, fy, fz = ox - cx, oy - cy, oz - cz
    b = -2.0 * (fx * nx + fy * ny + fz * nz)
    cq = fx * fx + fy * fy + fz * fz - r * r
    disc = b * b - 4.0 * cq
    has = disc >= 0
    radix = torch.sqrt(torch.where(has, disc, 0.0))
    any_hit = has & (radix >= -b) & (row >= 0)
    both = radix < b
    t_near = (b - radix) * 0.5
    t_far = (b + radix) * 0.5
    inside_near, inside_far = inv_f, ~inv_f

    def skipm(t, inside):
        return _skip_match(sk, prim, ox + nx * t, oy + ny * t, oz + nz * t,
                           inside, eps2)

    near_ok = (any_hit & both & (two_s | ~inside_near)
               & ~skipm(t_near, inside_near))
    far_ok = any_hit & (two_s | ~inside_far) & ~skipm(t_far, inside_far)
    ok = near_ok | far_ok
    t_pick = torch.where(near_ok, t_near, t_far)
    tt = t_pick * dn_len
    hx = ox + nx * t_pick
    hy = oy + ny * t_pick
    hz = oz + nz * t_pick
    inv_r = 1.0 / r
    gflip = torch.where(near_ok, inv_r, -inv_r)
    ifl = (torch.where(near_ok, inside_near, inside_far).to(torch.int32)
           * FLAG_INSIDE + (~near_ok).to(torch.int32) * FLAG_INSIDE_GEO)
    zero = torch.zeros_like(tt)
    return ok, tt, row, (prim, hx, hy, hz, (hx - cx) * gflip,
                         (hy - cy) * gflip, (hz - cz) * gflip, ifl, zero,
                         zero)


def _spht_test(m, ray, sk, eps_behind, eps2):
    """One packed TRANSFORMED sphere (ellipsoid) per ray: the object-space
    quadratic of Sphere.DoRayTrace (Sphere.cs:156-209) as in
    ``csrc/kernel_body.cuh`` ``sphere_pass`` — ray into object space with
    re-normalized direction, both roots, per-root world position via
    obj_to_world, world-metric ``t = d·(pos_w - o)``, two-sided / invert
    and skip-hit filtering per root, near root preferred."""
    ox, oy, oz, dx, dy, dz = ray[:6]
    row = m(28).to(torch.int32)
    inv_f = m(29) != 0
    two_s = m(30) != 0
    prim = m(31).to(torch.int32)

    oox = m(0) * ox + m(1) * oy + m(2) * oz + m(3)
    ooy = m(4) * ox + m(5) * oy + m(6) * oz + m(7)
    ooz = m(8) * ox + m(9) * oy + m(10) * oz + m(11)
    ddx = m(0) * dx + m(1) * dy + m(2) * dz
    ddy = m(4) * dx + m(5) * dy + m(6) * dz
    ddz = m(8) * dx + m(9) * dy + m(10) * dz
    dlen = 1.0 / torch.sqrt(torch.clamp(
        ddx * ddx + ddy * ddy + ddz * ddz, min=1e-30))
    ddx, ddy, ddz = ddx * dlen, ddy * dlen, ddz * dlen

    cx, cy, cz, rad = m(24), m(25), m(26), m(27)
    fx, fy, fz = oox - cx, ooy - cy, ooz - cz
    b = -2.0 * (fx * ddx + fy * ddy + fz * ddz)
    cq = fx * fx + fy * fy + fz * fz - rad * rad
    disc = b * b - 4.0 * cq
    has = disc >= 0
    radix = torch.sqrt(torch.where(has, disc, 0.0))
    any_hit = has & (radix >= -b) & (row >= 0)
    both = radix < b
    inv_rad = 1.0 / rad

    def eval_root(t_obj, valid, far_root: bool):
        px = oox + ddx * t_obj
        py = ooy + ddy * t_obj
        pz = ooz + ddz * t_obj
        wx = m(12) * px + m(13) * py + m(14) * pz + m(15)
        wy = m(16) * px + m(17) * py + m(18) * pz + m(19)
        wz = m(20) * px + m(21) * py + m(22) * pz + m(23)
        tw = dx * (wx - ox) + dy * (wy - oy) + dz * (wz - oz)
        inside = ~inv_f if far_root else inv_f
        valid = (valid & (two_s | ~inside)
                 & ~_skip_match(sk, prim, wx, wy, wz, inside, eps2))
        # World normal (Sphere.GetHit, Sphere.cs:156-173): w2o^T applied to
        # the object normal, normalized, negated on the far root.
        qx = (px - cx) * inv_rad
        qy = (py - cy) * inv_rad
        qz = (pz - cz) * inv_rad
        nwx = m(0) * qx + m(4) * qy + m(8) * qz
        nwy = m(1) * qx + m(5) * qy + m(9) * qz
        nwz = m(2) * qx + m(6) * qy + m(10) * qz
        nrl = 1.0 / torch.sqrt(torch.clamp(
            nwx * nwx + nwy * nwy + nwz * nwz, min=1e-30))
        flip = -nrl if far_root else nrl
        return tw, valid, (wx, wy, wz), (nwx * flip, nwy * flip,
                                         nwz * flip), inside

    t_n, near_ok, pos_n, nrm_n, in_n = eval_root((b - radix) * 0.5,
                                                 any_hit & both, False)
    t_f, far_ok, pos_f, nrm_f, in_f = eval_root((b + radix) * 0.5, any_hit,
                                                True)
    ok = near_ok | far_ok

    def pk(a, b2):
        return torch.where(near_ok, a, b2)
    tt = pk(t_n, t_f)
    ifl = (pk(in_n, in_f).to(torch.int32) * FLAG_INSIDE
           + (~near_ok).to(torch.int32) * FLAG_INSIDE_GEO)
    zero = torch.zeros_like(tt)
    return ok, tt, row, (prim, pk(pos_n[0], pos_f[0]), pk(pos_n[1], pos_f[1]),
                         pk(pos_n[2], pos_f[2]), pk(nrm_n[0], nrm_f[0]),
                         pk(nrm_n[1], nrm_f[1]), pk(nrm_n[2], nrm_f[2]),
                         ifl, zero, zero)


_LEAF_TESTS = {"tri": _tri_test, "sph": _sph_test, "spht": _spht_test}


@torch.no_grad()
def traverse_reference(nodes, leaves, leaf_kind: str, ray_o, ray_d, skip,
                       eps_behind: float, eps_pos: float,
                       want_stats: bool = False) -> TraverseOut:
    """Plain torch version of the traversal kernel (any device), f32.

    ``nodes`` [N, 8] and ``leaves`` [L, K·F] are the packed arrays; ``skip``
    is the previous hit (a ``HitRecord``) or None.  All rays advance one
    node per iteration; the rays still walking are gathered each iteration,
    the rays at a leaf test its K records one after another and commit with
    a strict ``t <``.  Per ray this is the kernel's walk and the kernel's
    arithmetic in the kernel's order, so the outputs are held bit-equal on
    the card."""
    f32, i32 = torch.float32, torch.int32
    _, F = LEAF_KINDS[leaf_kind]
    leaf_test = _LEAF_TESTS[leaf_kind]
    device = ray_o.device
    R = ray_o.shape[0]
    n_nodes = nodes.shape[0]
    K = leaves.shape[1] // F
    eps2 = eps_pos * eps_pos

    o = ray_o.to(f32)
    d = ray_d.to(f32)
    ray = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
    inv = [torch.where(c != 0, 1.0 / torch.where(c == 0, 1.0, c), BIG_INV)
           for c in ray[3:6]]
    if leaf_kind != "tri":
        # Normalized direction for the sphere test: on tangent rays the
        # discriminant's sign flips with sub-ulp |d| deviations.
        dn_len = torch.sqrt(torch.clamp(
            ray[3] * ray[3] + ray[4] * ray[4] + ray[5] * ray[5], min=1e-30))
        ray += [ray[3] / dn_len, ray[4] / dn_len, ray[5] / dn_len, dn_len]
    sk = None
    if skip is not None:
        pos, nrm = skip.position.to(f32), skip.normal.to(f32)
        px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
        sk = {"prim": skip.prim, "px": px, "py": py, "pz": pz,
              "leaving": (ray[3] * nrm[:, 0] + ray[4] * nrm[:, 1]
                          + ray[5] * nrm[:, 2]) > 0,
              "inside": skip.inside,
              "scale": 1.0 + px * px + py * py + pz * pz}

    best_t = torch.full((R,), INF, dtype=f32, device=device)
    best_row = torch.full((R,), -1, dtype=i32, device=device)
    # prim, px, py, pz, nx, ny, nz, flags, u, v
    detail = [torch.full((R,), -1, dtype=i32, device=device)] + [
        torch.zeros((R,), dtype=(i32 if j == 7 else f32), device=device)
        for j in range(1, 10)]
    stats = torch.zeros((R, 2), dtype=i32, device=device)
    ptr = torch.zeros((R,), dtype=torch.int64, device=device)
    skip_link = nodes[:, 6].to(torch.int64)
    leaf_slot = nodes[:, 7].to(torch.int64)

    while True:
        at = torch.nonzero(ptr < n_nodes)[:, 0]   # the rays still walking
        if at.numel() == 0:
            break
        p = ptr[at]
        box = nodes[p]
        lo_hi = []
        for k in range(3):
            t0 = (box[:, k] - ray[k][at]) * inv[k][at]
            t1 = (box[:, 3 + k] - ray[k][at]) * inv[k][at]
            lo_hi.append((torch.minimum(t0, t1), torch.maximum(t0, t1)))
        near = torch.maximum(torch.maximum(lo_hi[0][0], lo_hi[1][0]),
                             lo_hi[2][0])
        far = torch.minimum(torch.minimum(lo_hi[0][1], lo_hi[1][1]),
                            lo_hi[2][1])
        hit = (near <= far) & (far >= -eps_behind) & (near <= best_t[at])
        slot = leaf_slot[p]
        is_leaf = slot >= 0
        stats[at, 0] += 1
        ptr[at] = torch.where(hit & ~is_leaf, p + 1, skip_link[p])

        do_leaf = hit & is_leaf
        if not bool(do_leaf.any()):
            continue
        sub = at[do_leaf]
        recs = leaves[slot[do_leaf]]
        sub_ray = [c[sub] for c in ray]
        sub_sk = None if sk is None else {k: v[sub] for k, v in sk.items()}
        b_t, b_row = best_t[sub], best_row[sub]
        b_det = [c[sub] for c in detail]
        tested = torch.zeros_like(b_row)
        for k in range(K):
            ok, tt, row, det = leaf_test(
                lambda c, k=k: recs[:, k * F + c], sub_ray, sub_sk,
                eps_behind, eps2)
            tested += (row >= 0).to(i32)
            better = ok & (tt < b_t)
            b_t = torch.where(better, tt, b_t)
            b_row = torch.where(better, row, b_row)
            b_det = [torch.where(better, new, old)
                     for new, old in zip(det, b_det)]
        best_t[sub], best_row[sub] = b_t, b_row
        for c, new in zip(detail, b_det):
            c[sub] = new
        stats[sub, 1] += tested

    return TraverseOut(
        row=best_row, t=best_t, prim=detail[0],
        position=torch.stack(detail[1:4], dim=1),
        normal=torch.stack(detail[4:7], dim=1), flags=detail[7],
        u=detail[8], v=detail[9], stats=stats if want_stats else None)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _launch(nodes, leaves, leaf_kind, ray_o, ray_d, skip, eps_behind,
            eps_pos, want_stats) -> TraverseOut:
    from .. import kernels

    kind, F = LEAF_KINDS[leaf_kind]
    dev = ray_o.device
    R = ray_o.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("nodes", nodes, (nodes.shape[0], 8), f32, dev)
    if leaves.shape[1] % F:
        raise ValueError(f"leaves: {leaves.shape[1]} floats a row is not a "
                         f"multiple of the record's {F}")
    _check("leaves", leaves, tuple(leaves.shape), f32, dev)
    _check("ray_o", ray_o, (R, 3), f32, dev)
    _check("ray_d", ray_d, (R, 3), f32, dev)
    if skip is None:
        skip_ptrs = [None] * 4
    else:
        _check("skip.prim", skip.prim, (R,), i32, dev)
        _check("skip.position", skip.position, (R, 3), f32, dev)
        _check("skip.normal", skip.normal, (R, 3), f32, dev)
        _check("skip.inside", skip.inside, (R,), torch.bool, dev)
        skip_ptrs = [t.data_ptr() for t in (skip.prim, skip.position,
                                            skip.normal, skip.inside)]

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = TraverseOut(
        row=empty((R,), i32), t=empty((R,), f32), prim=empty((R,), i32),
        position=empty((R, 3), f32), normal=empty((R, 3), f32),
        flags=empty((R,), i32), u=empty((R,), f32), v=empty((R,), f32),
        stats=empty((R, 2), i32) if want_stats else None)
    err = kernels.load().rtc_traverse(
        nodes.data_ptr(), leaves.data_ptr(), ray_o.data_ptr(),
        ray_d.data_ptr(), *skip_ptrs,
        *(None if t is None else t.data_ptr() for t in out),
        R, nodes.shape[0], leaves.shape[1] // F, kind, eps_behind,
        eps_pos * eps_pos, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"traversal kernel launch failed: CUDA error {err}")
    traverse.launches += 1
    return out


def traverse(nodes, leaves, leaf_kind: str, ray_o, ray_d, skip,
             eps_behind: float, eps_pos: float, want_stats: bool = False
             ) -> TraverseOut:
    """Closest hit of every ray in one packed BVH.  On CUDA tensors this
    launches ``csrc/traverse.cu`` (counted in ``traverse.launches``) or
    raises; on CPU tensors it runs :func:`traverse_reference`.  Rays and
    the skip record are f32 and contiguous."""
    if leaf_kind not in LEAF_KINDS:
        raise ValueError(f"traverse: unknown leaf kind {leaf_kind!r}")
    if ray_o.device.type == "cuda":
        return _launch(nodes, leaves, leaf_kind, ray_o, ray_d, skip,
                       eps_behind, eps_pos, want_stats)
    if ray_o.device.type == "cpu":
        return traverse_reference(nodes, leaves, leaf_kind, ray_o, ray_d,
                                  skip, eps_behind, eps_pos, want_stats)
    raise ValueError(f"traverse: unsupported device {ray_o.device}")


# Launches of the traversal kernel (set it to 0 before a run to see that
# the run went through the kernel).
traverse.launches = 0


class CudaBVH:
    """Packed arrays of a triangle BVH on ``device`` + the selection entry
    of the traversal."""

    leaf_kind = "tri"

    def __init__(self, bvh: BVHArrays, tri, mats, n_prims: int,
                 device=None):
        self._init_common(bvh, pack_leaf_tris(bvh, tri, mats), tri.prim_id,
                          n_prims, device if device is not None
                          else tri.prim_id.device)

    def _init_common(self, bvh, leaves, prim_id, n_prims, device):
        self.device = torch.device(device)
        self.nodes = torch.tensor(pack_nodes(bvh), device=self.device)
        self.leaves = torch.tensor(leaves, device=self.device)
        self.n_nodes = int(bvh.n_nodes)
        self.K = int(bvh.leaf_prims.shape[1])
        self.prim_to_row = torch.tensor(prim_to_row(prim_id, n_prims),
                                        device=self.device)

    def _skip(self, skip):
        if skip is None:
            return None
        f32 = torch.float32
        return dataclasses.replace(
            skip, prim=skip.prim.contiguous(),
            position=skip.position.detach().to(f32).contiguous(),
            normal=skip.normal.detach().to(f32).contiguous(),
            inside=skip.inside.contiguous())

    def _traverse(self, fn, ray_o, ray_d, skip, eps_behind, eps_pos,
                  want_stats):
        f32 = torch.float32
        return fn(self.nodes, self.leaves, self.leaf_kind,
                  ray_o.detach().to(f32).contiguous(),
                  ray_d.detach().to(f32).contiguous(), self._skip(skip),
                  float(eps_behind), float(eps_pos), want_stats)

    def select(self, ray_o, ray_d, skip, eps_behind, eps_pos,
               want_detail: bool = False, want_stats: bool = False,
               reference: bool = False):
        """``(best_row [R] int32 clamped to 0, any [R] bool, t [R])`` — the
        dispatch layer's triangle / sphere selection.

        ``want_detail=True`` appends the winner's full hit detail committed
        in the kernel: a dict with ``prim`` (int32), ``pos`` [R, 3], ``nrm``
        [R, 3] (FLAT normal for triangles), ``inside`` / ``inside_geo`` /
        ``smooth`` (bool) and ``u`` / ``v`` — so the dispatch layer builds
        the HitRecord with no [R]-row gathers from the primitive tables.
        ``want_stats=True`` appends the ``[R, 2]`` int32 counters (nodes
        visited, records tested).  ``reference=True`` runs the plain version
        on whatever device the rays are on (the comparison's side of
        ``chip_smoke.py``); otherwise CUDA tensors launch the kernel (or
        raise) and CPU tensors run the plain version."""
        out = self._traverse(traverse_reference if reference else traverse,
                             ray_o, ray_d, skip, eps_behind, eps_pos,
                             want_stats)
        res = (torch.clamp(out.row, min=0), out.row >= 0, out.t)
        if want_detail:
            res += ({"prim": out.prim, "pos": out.position,
                     "nrm": out.normal,
                     "inside": (out.flags & FLAG_INSIDE) != 0,
                     "inside_geo": (out.flags & FLAG_INSIDE_GEO) != 0,
                     "smooth": (out.flags & FLAG_SMOOTH) != 0,
                     "u": out.u, "v": out.v},)
        if want_stats:
            res += (out.stats,)
        return res


class CudaSphereBVH(CudaBVH):
    """Traversal over UNTRANSFORMED spheres — the acceleration tier the
    reference gives every primitive type through IBoundedObject
    (Scene.cs:39-49, Sphere.cs:220-232).  Shares the walk with the triangle
    kernel; only the leaf test differs (plain-sphere quadratic with per-root
    filtering)."""

    leaf_kind = "sph"

    def __init__(self, bvh: BVHArrays, sph, mats, n_prims: int,
                 device=None):
        self._init_common(bvh, pack_leaf_spheres(bvh, sph, mats),
                          sph.prim_id, n_prims, device if device is not None
                          else sph.prim_id.device)


class CudaEllipsoidBVH(CudaBVH):
    """Traversal over TRANSFORMED spheres (ellipsoids): the exact
    closed-form world box feeds the same skip-link build, and the leaf
    records carry the transform matrices for the in-kernel object-space
    quadratic."""

    leaf_kind = "spht"

    def __init__(self, bvh: BVHArrays, sph, mats, n_prims: int,
                 device=None):
        self._init_common(bvh, pack_leaf_ellipsoids(bvh, sph, mats),
                          sph.prim_id, n_prims, device if device is not None
                          else sph.prim_id.device)
