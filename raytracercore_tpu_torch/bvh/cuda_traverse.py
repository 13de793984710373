"""The BVH traversal kernel (counterpart of
``raytracercore_tpu.bvh.pallas_traverse``): the at-scale closest hit.

One launch answers one bounce's closest-hit query of every ray against one
skip-link BVH (:mod:`.builder`) whose leaves hold triangles, untransformed
spheres or transformed spheres (ellipsoids).  The kernel walks the binary
preorder tree collapsed into 4-wide nodes (:func:`pack_wide_nodes`): one
fetch, four slab tests, the passing children on a per-ray stack in binary
preorder.  A leaf's records are tested one after another and a candidate
is committed only if it is strictly closer (``t <``), so leaves count in
preorder and the earliest-preorder winner wins a tie.  The wide walk tests
the same leaves in the same order as the binary skip-link walk, so its
outputs and records tested are that walk's, bit for bit (the proof is in
``csrc/traverse.cu``'s header).  The kernel commits the winner's whole
detail (prim, position, flat normal, inside flags, u/v), so the dispatch
layer gathers nothing from the primitive tables.

* :func:`pack_nodes`, :func:`pack_wide_nodes`, :func:`pack_leaf_tris`,
  :func:`pack_leaf_spheres`, :func:`pack_leaf_ellipsoids` — the arrays the
  kernel and the binary walk read (the JAX package's record layouts,
  without its lane padding and its bf16 node words);
* :func:`traverse` — the wrapper: on CUDA tensors it launches
  ``csrc/traverse.cu`` (counted in ``traverse.launches``) or raises, on CPU
  tensors it runs the plain version;
* :func:`traverse_record` — the same walk ending in the bounce's final hit
  record (the record epilogue), merged into a prior record where one is
  given; its plain version :func:`record_reference` is the chain of torch
  ops that builds the record from :func:`traverse`'s outputs;
* :func:`traverse_wide_reference` — the plain version: the kernel's wide
  walk as a lockstep torch walk with per-ray stacks, the kernel's leaf
  tests in the kernel's operation order, all 12 outputs and the optional
  counters;
* :func:`traverse_reference` — the binary skip-link walk in torch, the
  counterpart of the JAX walk: the oracle of the 12 outputs and the
  records tested;
* :func:`sort_key`, :func:`sort_key_reference` — the ray-coherence key of
  the JAX package's ``PallasBVH._sort_key`` (direction octant, then the
  Morton code of the origin in the root box): the key kernel of
  ``csrc/traverse.cu`` (counted in ``sort_key.launches``) and its plain
  version;
* :class:`CudaBVH`, :class:`CudaSphereBVH`, :class:`CudaEllipsoidBVH` — the
  packed tree of one table (binary nodes, wide nodes, leaves) with the
  ``record`` entry that ``dispatch.make_bvh_closest_fn`` calls and the
  ``select`` entry of the debug views and the checks.

The launch counters, each kept by ``kernels.count_launch`` (a launch under
a graph's capture counts at each replay, so they count launches that ran):

* ``traverse.launches`` — every launch of the traversal kernel;
* ``traverse_record.launches`` — those that wrote the final record;
* ``traverse_record.by_kind["tri" | "sph" | "spht"].launches`` — the
  record launches by leaf kind (triangles, untransformed spheres,
  ellipsoids);
* ``traverse_record.merges.launches`` — the record launches that merged
  into a prior record (the sphere and ellipsoid trees after the triangle
  tree);
* ``sort_key.launches`` — the key kernel's launches.

Ray coherence (``select(sort=True)``, the JAX package's ``sort=``): the
rays are ordered by their key (``torch.sort``, stable) and the traversal
kernel reads that order: thread ``t`` walks ray ``order[t]`` and writes
its outputs at that ray's index, so the outputs come back in the caller's
order with no gather or scatter pass, bit-equal to the unsorted launch
(one thread walks one ray whatever its position).  Only which rays share
a warp changes: rays from nearby origins in one octant walk the same part
of the tree, and parked rays (origin ``config.PARKED_ORIGIN``, +x) all get
the largest key and fill whole warps that end at the root.

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

from ..kernels import LaunchCount, check_tensor as _check
from .builder import BVHArrays

TRI_F = 16   # packed floats per leaf triangle (see pack_leaf_tris)
SPH_F = 8    # packed floats per leaf sphere (see pack_leaf_spheres)
SPT_F = 32   # packed floats per leaf ellipsoid (transformed sphere)
LEAF_KINDS = {"tri": (0, TRI_F), "sph": (1, SPH_F), "spht": (2, SPT_F)}
BIG_INV = 3.4e38   # inverse of a zero direction component
INF = float("inf")
# flags plane bits
FLAG_INSIDE, FLAG_INSIDE_GEO, FLAG_SMOOTH = 1, 2, 4
# The sort key's shape (the JAX package's PallasBVH constants): bits per
# axis of the origin's Morton code, and direction bits per axis beyond the
# sign.
SORT_MORTON_BITS = 8
SORT_DIR_BITS = 0
# The wide tree the kernel walks (pack_wide_nodes): children a node, and
# the entries of the kernel's stack (csrc/traverse.cu WIDE_WIDTH,
# WIDE_STACK).
WIDE_WIDTH = 4
WIDE_STACK = 256


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


class WideNodes(NamedTuple):
    """The wide tree that the kernel walks, made by :func:`pack_wide_nodes`
    and by nothing else: the kernel trusts ``depth`` to be the packer's."""

    table: torch.Tensor   # [M, 8 * WIDE_WIDTH] f32, node 0 the root alone
    depth: int            # the most stack entries a walk can need

    def to(self, device) -> "WideNodes":
        return self._replace(table=self.table.to(device))


def pack_wide_nodes(bvh: BVHArrays, device="cpu") -> WideNodes:
    """The binary preorder tree of ``bvh`` collapsed into
    ``WIDE_WIDTH``-wide nodes, the table on ``device``.

    A wide node starts from an inner node's two children (``p + 1`` and
    ``skip[p + 1]``) and repeatedly replaces its inner child of largest
    surface area (the earliest in preorder on a tie) by that child's two
    children, until it has ``WIDE_WIDTH`` children or none is inner; its
    children stay in binary preorder.  Each child's box is its binary
    node's f32 box, bit for bit.  Node ``i`` is the row ``table[i]`` read
    as ``[8, WIDE_WIDTH]``: rows 0-2 the children's box minima x, y, z,
    rows 3-5 their maxima, row 6 their references (an inner child's wide
    node ≥ 1, a leaf ``-(slot + 1)``, 0 an empty slot), row 7 their binary
    preorder indices (-1 empty); an empty slot's box is NaN, which fails
    any slab test.  Node 0 holds the root alone, so that its box is tested
    first and a ray that misses it ends after one fetch; the others follow
    in breadth-first order, a node's inner children side by side.  The
    collapse runs on a whole level of wide nodes at once.

    ``depth`` is the most entries the kernel's stack can hold during a walk
    (every child passing: at a node of n children, walking child i leaves
    the n - 1 - i after it on the stack).  No builder bounds it: the
    kernel's launch refuses a tree that needs more than ``WIDE_STACK``,
    and the plain walk sizes its stacks to ``depth``."""
    W = WIDE_WIDTH
    lo = _np(bvh.bmin).astype(np.float32)
    hi = _np(bvh.bmax).astype(np.float32)
    skip = _np(bvh.skip).astype(np.int64)
    slot = _np(bvh.leaf_slot).astype(np.int64)
    n = len(skip)
    if n >= 1 << 24:
        raise ValueError(f"pack_wide_nodes: {n} nodes do not fit f32 links")
    ext = hi.astype(np.float64) - lo.astype(np.float64)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0])
    inner = (slot < 0) & (np.arange(n) + 1 < skip)

    def collapse(c):
        """[len(c), W]: the binary children of the wide nodes of inner
        nodes ``c``, in preorder, -1 for an empty slot."""
        kids = np.full((len(c), W), n, np.int64)   # n: empty, sorts last
        kids[:, 0] = c + 1
        kids[:, 1] = skip[c + 1]
        count = np.full(len(c), 2)
        for _ in range(W - 2):
            split = (kids < n) & inner[np.minimum(kids, n - 1)]
            a = np.where(split, area[np.minimum(kids, n - 1)], -np.inf)
            top = split & (a == a.max(1, keepdims=True))
            go = np.nonzero(split.any(1))[0]
            j = np.argmin(np.where(top, kids, n), axis=1)[go]
            c2 = kids[go, j]
            kids[go, j] = c2 + 1
            kids[go, count[go]] = skip[c2 + 1]
            count[go] += 1
        kids = np.sort(kids, axis=1)
        return np.where(kids < n, kids, -1)

    # Breadth first, a level at a time: the inner children of one level's
    # wide nodes, in row order, are the next level's wide nodes.
    levels = [np.full((1, W), -1, np.int64)]
    if n and (slot[0] >= 0 or inner[0]):
        levels[0][0, 0] = 0
    while True:
        kids = levels[-1]
        c = kids[kids >= 0]
        c = c[inner[c]]
        if not len(c):
            break
        levels.append(collapse(c))
    binary = np.concatenate(levels)
    M = len(binary)
    if M >= 1 << 24:
        raise ValueError(f"pack_wide_nodes: {M} wide nodes do not fit f32 "
                         "links")
    used = binary >= 0
    b = np.maximum(binary, 0)
    is_inner = used & inner[b]
    ref = np.zeros((M, W), np.int64)
    ref[is_inner] = np.arange(1, M)
    ref = np.where(used & ~is_inner, -(slot[b] + 1), ref)
    out = np.full((M, 8, W), np.nan, np.float32)
    for k in range(3):
        out[:, k] = np.where(used, lo[b, k], np.nan)
        out[:, 3 + k] = np.where(used, hi[b, k], np.nan)
    out[:, 6] = ref.astype(np.float32)
    out[:, 7] = binary.astype(np.float32)

    # The stack a walk needs, from the deepest level up.
    need = np.zeros(M, np.int64)
    after = used.sum(1, keepdims=True) - 1 - np.arange(W)
    ends = np.cumsum([len(x) for x in levels])
    for s0, s1 in zip(ends[-2::-1].tolist() + [0], ends[::-1].tolist()):
        below = np.where(is_inner[s0:s1], need[np.maximum(ref[s0:s1], 0)],
                         0)
        need[s0:s1] = np.where(used[s0:s1], after[s0:s1] + below, 0).max(1)
    return WideNodes(torch.tensor(out.reshape(M, 8 * W), device=device),
                     int(need[0]))


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


def _detail(out: TraverseOut) -> dict:
    """The winner's detail of ``select(want_detail=True)`` from the
    walk's planes."""
    return {"prim": out.prim, "pos": out.position, "nrm": out.normal,
            "inside": (out.flags & FLAG_INSIDE) != 0,
            "inside_geo": (out.flags & FLAG_INSIDE_GEO) != 0,
            "smooth": (out.flags & FLAG_SMOOTH) != 0,
            "u": out.u, "v": out.v}


@torch.no_grad()
def record_reference(out: TraverseOut, tri=None, prior=None):
    """The plain version of the record epilogue: the bounce's final hit
    record (``dispatch.HitRecord``) from the walk's outputs ``out``, by the
    chain of torch ops of ``dispatch``: ``_tri_smooth_fixup`` where ``tri``
    (the triangle table whose vertex normals smooth winners read) is
    given, ``_rec_from_detail``, then ``_merge2`` into ``prior`` (a record
    of this bounce, or None), which keeps the prior record unless this
    winner is strictly closer; prim -1 where neither has a hit.  A record's
    hit is ``prim >= 0``."""
    from ..intersect import dispatch

    det = _detail(out)
    if tri is not None:
        det = dispatch._tri_smooth_fixup(tri, torch.clamp(out.row, min=0),
                                         det)
    rec = dispatch._rec_from_detail(out.row >= 0, out.t, det)
    if prior is not None:
        rec = dispatch._merge2(dispatch._rec_dict(prior), rec)
    return dispatch._hit_from_rec(rec)


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
    """One packed untransformed sphere per ray: the dense test
    (``csrc/kernel_body.cuh`` ``sphere_pass`` / ``sphere_root``, the plain
    ``intersect.kernel_body.sphere_pass``) with the identity transform
    folded away, which changes no bit on finite inputs.  The quadratic of
    Sphere.DoRayTrace (Sphere.cs:175-209) on the direction times ``1 /
    |d|`` (prepared by :class:`_Walk`), each root's position ``o + n̂ ·
    t``, world-metric ``t = d·(pos - o)``, the normal ``(pos - c) · (1 /
    r)`` normalized and negated on the far root; two-sided / invert and
    the skip rule per root, the near root preferred."""
    ox, oy, oz, dx, dy, dz = ray[:6]
    nx, ny, nz = ray[6:9]
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
    inv_r = 1.0 / r

    def eval_root(t_obj, valid, far_root: bool):
        wx = ox + nx * t_obj
        wy = oy + ny * t_obj
        wz = oz + nz * t_obj
        tw = dx * (wx - ox) + dy * (wy - oy) + dz * (wz - oz)
        inside = ~inv_f if far_root else inv_f
        valid = (valid & (two_s | ~inside)
                 & ~_skip_match(sk, prim, wx, wy, wz, inside, eps2))
        qx = (wx - cx) * inv_r
        qy = (wy - cy) * inv_r
        qz = (wz - cz) * inv_r
        nrl = 1.0 / torch.sqrt(torch.clamp(qx * qx + qy * qy + qz * qz,
                                           min=1e-30))
        flip = -nrl if far_root else nrl
        return tw, valid, (wx, wy, wz), (qx * flip, qy * flip,
                                         qz * flip), inside

    t_n, near_ok, pos_n, nrm_n, in_n = eval_root((b - radix) * 0.5,
                                                 any_hit & both, False)
    t_f, far_ok, pos_f, nrm_f, in_f = eval_root((b + radix) * 0.5, any_hit,
                                                True)
    return _pick_root(near_ok, far_ok, (t_n, pos_n, nrm_n, in_n),
                      (t_f, pos_f, nrm_f, in_f), row, prim)


def _pick_root(near_ok, far_ok, near, far, row, prim):
    """A sphere leaf's result from its two roots (each ``(t, pos, nrm,
    inside)``): the near root where it survived, else the far one."""
    def pk(a, b2):
        return torch.where(near_ok, a, b2)
    tt = pk(near[0], far[0])
    ifl = (pk(near[3], far[3]).to(torch.int32) * FLAG_INSIDE
           + (~near_ok).to(torch.int32) * FLAG_INSIDE_GEO)
    zero = torch.zeros_like(tt)
    return near_ok | far_ok, tt, row, (
        prim, *(pk(a, b2) for a, b2 in zip(near[1], far[1])),
        *(pk(a, b2) for a, b2 in zip(near[2], far[2])), ifl, zero, zero)


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
    return _pick_root(near_ok, far_ok, (t_n, pos_n, nrm_n, in_n),
                      (t_f, pos_f, nrm_f, in_f), row, prim)


_LEAF_TESTS = {"tri": _tri_test, "sph": _sph_test, "spht": _spht_test}


def _in_order(walk, order, ray_o, ray_d, skip):
    """``walk(ray_o, ray_d, skip)`` with the rays taken in the order
    ``order`` (int64 [R], a permutation) and every output put back at its
    ray's index, as the kernel's thread ``t`` walks ray ``order[t]``."""
    if skip is not None:
        skip = dataclasses.replace(skip, **{
            f.name: getattr(skip, f.name)[order]
            for f in dataclasses.fields(skip)})
    out = walk(ray_o[order], ray_d[order], skip)

    def back(x):
        if x is None:
            return None
        y = torch.empty_like(x)
        y[order] = x
        return y
    return TraverseOut(*(back(x) for x in out))


class _Walk:
    """What the two plain walks share: the rays with their inverse
    direction (and, for untransformed sphere leaves, the normalized
    direction), the skip record's planes, the running winner with its
    detail and the counters; :meth:`slab` and :meth:`leaves` are the
    kernel's box and leaf tests."""

    def __init__(self, leaves, leaf_kind, ray_o, ray_d, skip, eps_behind,
                 eps_pos):
        f32, i32 = torch.float32, torch.int32
        _, self.F = LEAF_KINDS[leaf_kind]
        self.leaf_test = _LEAF_TESTS[leaf_kind]
        self.table = leaves
        self.K = leaves.shape[1] // self.F
        self.eps_behind, self.eps2 = eps_behind, eps_pos * eps_pos
        device = ray_o.device
        R = ray_o.shape[0]
        o = ray_o.to(f32)
        d = ray_d.to(f32)
        ray = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
        self.inv = [torch.where(c != 0, 1.0 / torch.where(c == 0, 1.0, c),
                                BIG_INV) for c in ray[3:6]]
        if leaf_kind == "sph":
            # The dense sphere test's normalized direction, d times 1 / |d|:
            # on tangent rays the discriminant's sign flips with sub-ulp
            # deviations of the direction.
            inv_len = 1.0 / torch.sqrt(torch.clamp(
                ray[3] * ray[3] + ray[4] * ray[4] + ray[5] * ray[5],
                min=1e-30))
            ray += [ray[3] * inv_len, ray[4] * inv_len, ray[5] * inv_len]
        self.ray = ray
        self.sk = None
        if skip is not None:
            pos, nrm = skip.position.to(f32), skip.normal.to(f32)
            px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
            self.sk = {"prim": skip.prim, "px": px, "py": py, "pz": pz,
                       "leaving": (ray[3] * nrm[:, 0] + ray[4] * nrm[:, 1]
                                   + ray[5] * nrm[:, 2]) > 0,
                       "inside": skip.inside,
                       "scale": 1.0 + px * px + py * py + pz * pz}
        self.best_t = torch.full((R,), INF, dtype=f32, device=device)
        self.best_row = torch.full((R,), -1, dtype=i32, device=device)
        # prim, px, py, pz, nx, ny, nz, flags, u, v
        self.detail = [torch.full((R,), -1, dtype=i32, device=device)] + [
            torch.zeros((R,), dtype=(i32 if j == 7 else f32), device=device)
            for j in range(1, 10)]
        self.stats = torch.zeros((R, 2), dtype=i32, device=device)

    def slab(self, at, lo, hi):
        """The kernel's slab test of rays ``at`` against boxes ``lo``,
        ``hi`` ([A, 3], or [A, 3, W] for W boxes a ray): ``(near,
        passes)``."""
        shape = (-1,) + (1,) * (lo.dim() - 2)
        lo_hi = []
        for k in range(3):
            o, inv = self.ray[k][at].view(shape), self.inv[k][at].view(shape)
            t0 = (lo[:, k] - o) * inv
            t1 = (hi[:, k] - o) * inv
            lo_hi.append((torch.minimum(t0, t1), torch.maximum(t0, t1)))
        near = torch.maximum(torch.maximum(lo_hi[0][0], lo_hi[1][0]),
                             lo_hi[2][0])
        far = torch.minimum(torch.minimum(lo_hi[0][1], lo_hi[1][1]),
                            lo_hi[2][1])
        best = self.best_t[at].view(shape)
        return near, ((near <= far) & (far >= -self.eps_behind)
                      & (near <= best))

    def leaves(self, sub, slot):
        """Rays ``sub`` test the K records of their leaf ``slot`` one after
        another, each candidate committed if strictly closer."""
        recs = self.table[slot]
        F = self.F
        sub_ray = [c[sub] for c in self.ray]
        sub_sk = (None if self.sk is None
                  else {k: v[sub] for k, v in self.sk.items()})
        b_t, b_row = self.best_t[sub], self.best_row[sub]
        b_det = [c[sub] for c in self.detail]
        tested = torch.zeros_like(b_row)
        for k in range(self.K):
            ok, tt, row, det = self.leaf_test(
                lambda c, k=k: recs[:, k * F + c], sub_ray, sub_sk,
                self.eps_behind, self.eps2)
            tested += (row >= 0).to(torch.int32)
            better = ok & (tt < b_t)
            b_t = torch.where(better, tt, b_t)
            b_row = torch.where(better, row, b_row)
            b_det = [torch.where(better, new, old)
                     for new, old in zip(det, b_det)]
        self.best_t[sub], self.best_row[sub] = b_t, b_row
        for c, new in zip(self.detail, b_det):
            c[sub] = new
        self.stats[sub, 1] += tested

    def out(self, want_stats):
        det = self.detail
        return TraverseOut(
            row=self.best_row, t=self.best_t, prim=det[0],
            position=torch.stack(det[1:4], dim=1),
            normal=torch.stack(det[4:7], dim=1), flags=det[7], u=det[8],
            v=det[9], stats=self.stats if want_stats else None)


@torch.no_grad()
def traverse_reference(nodes, leaves, leaf_kind: str, ray_o, ray_d, skip,
                       eps_behind: float, eps_pos: float,
                       want_stats: bool = False, order=None) -> TraverseOut:
    """The binary skip-link walk over ``nodes`` ([N, 8], :func:`pack_nodes`)
    in plain torch (any device), f32: the counterpart of the JAX walk, and
    the oracle that the wide walk (the kernel and
    :func:`traverse_wide_reference`) is held to on all 12 outputs and the
    records tested.

    ``leaves`` [L, K·F] are the packed records; ``skip`` is the previous
    hit (a ``HitRecord``) or None.  All rays advance one node per
    iteration; the rays still walking are gathered each iteration, the
    rays at a leaf test its K records one after another and commit with a
    strict ``t <``.  The counters are the nodes visited and the records
    tested.

    ``order`` (int64 [R], a permutation, or None for the identity): the
    rays are walked in that order and every output is put back at its
    ray's index."""
    if order is not None:
        return _in_order(
            lambda o, d, sk: traverse_reference(
                nodes, leaves, leaf_kind, o, d, sk, eps_behind, eps_pos,
                want_stats), order, ray_o, ray_d, skip)
    walk = _Walk(leaves, leaf_kind, ray_o, ray_d, skip, eps_behind, eps_pos)
    n_nodes = nodes.shape[0]
    ptr = torch.zeros((ray_o.shape[0],), dtype=torch.int64,
                      device=ray_o.device)
    skip_link = nodes[:, 6].to(torch.int64)
    leaf_slot = nodes[:, 7].to(torch.int64)

    while True:
        at = torch.nonzero(ptr < n_nodes)[:, 0]   # the rays still walking
        if at.numel() == 0:
            break
        p = ptr[at]
        box = nodes[p]
        _, hit = walk.slab(at, box[:, 0:3], box[:, 3:6])
        slot = leaf_slot[p]
        is_leaf = slot >= 0
        walk.stats[at, 0] += 1
        ptr[at] = torch.where(hit & ~is_leaf, p + 1, skip_link[p])
        do_leaf = hit & is_leaf
        if bool(do_leaf.any()):
            walk.leaves(at[do_leaf], slot[do_leaf])
    return walk.out(want_stats)


@torch.no_grad()
def traverse_wide_reference(wide: WideNodes, leaves, leaf_kind: str, ray_o,
                            ray_d, skip, eps_behind: float, eps_pos: float,
                            want_stats: bool = False,
                            order=None) -> TraverseOut:
    """The kernel's walk over the wide tree ``wide`` (:func:`pack_wide_nodes`)
    in plain torch (any device), f32, in the kernel's arithmetic: all 12
    outputs and both counters are held bit-equal to the kernel on the
    card, and the 12 outputs and the records tested equal
    :func:`traverse_reference`'s.

    Every ray starts at node 0, which holds the root's box alone.  A ray at
    an inner node counts a fetch and slab-tests the node's W children; the
    passing children but the first (in binary preorder) go on its stack
    with their ``near``, the last child first, and the first is walked
    next.  A ray at a leaf tests the leaf's K records.  Then it pops
    entries until one has ``near <= best t`` and walks it, or ends on an
    empty stack.  The stacks are one ``[R, depth]`` tensor.  ``order``: as
    :func:`traverse_reference`."""
    if order is not None:
        return _in_order(
            lambda o, d, sk: traverse_wide_reference(
                wide, leaves, leaf_kind, o, d, sk, eps_behind, eps_pos,
                want_stats), order, ray_o, ray_d, skip)
    walk = _Walk(leaves, leaf_kind, ray_o, ray_d, skip, eps_behind, eps_pos)
    device = ray_o.device
    R = ray_o.shape[0]
    W = WIDE_WIDTH
    node = wide.table.view(-1, 8, W)
    kids = node[:, 6].to(torch.int64)
    pop = torch.iinfo(torch.int64).min   # `cur` of a ray that pops next
    depth = max(wide.depth, 1)
    stack_ref = torch.zeros((R, depth), dtype=torch.int64, device=device)
    stack_near = torch.zeros((R, depth), dtype=torch.float32, device=device)
    sp = torch.zeros((R,), dtype=torch.int64, device=device)
    cur = torch.zeros((R,), dtype=torch.int64, device=device)
    live = torch.ones((R,), dtype=torch.bool, device=device)

    while True:
        at = torch.nonzero(live)[:, 0]
        if at.numel() == 0:
            break
        c = cur[at]
        inner = c >= 0
        ia, n = at[inner], c[inner]
        if ia.numel():
            walk.stats[ia, 0] += 1
            box = node[n]                                  # [A, 8, W]
            ref = kids[n]                                  # [A, W]
            near, hit = walk.slab(ia, box[:, 0:3], box[:, 3:6])
            hit = hit & (ref != 0)
            first = torch.argmax(hit.to(torch.int32), dim=1)
            for k in reversed(range(1, W)):
                m = hit[:, k] & (first < k)
                rows = ia[m]
                top = sp[rows]
                stack_ref[rows, top] = ref[m, k]
                stack_near[rows, top] = near[m, k]
                sp[rows] = top + 1
            nxt = ref.gather(1, first[:, None])[:, 0]
            cur[ia] = torch.where(hit.any(1), nxt, pop)
        la = at[~inner]
        if la.numel():
            walk.leaves(la, -c[~inner] - 1)
            cur[la] = pop
        pending = at[cur[at] == pop]
        while pending.numel():
            has = sp[pending] > 0
            live[pending[~has]] = False
            pending = pending[has]
            sp[pending] -= 1
            top = sp[pending]
            ok = stack_near[pending, top] <= walk.best_t[pending]
            cur[pending[ok]] = stack_ref[pending[ok], top[ok]]
            pending = pending[~ok]
    return walk.out(want_stats)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _stream(device) -> int:
    """The handle of ``device``'s current CUDA stream."""
    return torch.cuda.current_stream(device).cuda_stream


def _walk_args(wide, leaves, leaf_kind, ray_o, ray_d, skip, order):
    """The checks and the leading pointers (nodes, leaves, rays, skip
    record, order) that both C entries take."""
    _, F = LEAF_KINDS[leaf_kind]
    dev = ray_o.device
    R = ray_o.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("wide", wide.table, (wide.table.shape[0], 8 * WIDE_WIDTH), f32,
           dev)
    if not 0 <= wide.depth <= WIDE_STACK:
        raise ValueError(f"wide: a walk may need {wide.depth} stack "
                         f"entries, the kernel has {WIDE_STACK}")
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
    if order is not None:
        _check("order", order, (R,), torch.int64, dev)
    return (wide.table.data_ptr(), leaves.data_ptr(), ray_o.data_ptr(),
            ray_d.data_ptr(), *skip_ptrs,
            None if order is None else order.data_ptr())


def _walk_sizes(wide, leaves, leaf_kind, ray_o):
    """R, n_wide, depth, K and the leaf kind, as both C entries take
    them."""
    kind, F = LEAF_KINDS[leaf_kind]
    return (ray_o.shape[0], wide.table.shape[0], wide.depth,
            leaves.shape[1] // F, kind)


def _launch(wide, leaves, leaf_kind, ray_o, ray_d, skip, eps_behind,
            eps_pos, want_stats, order=None) -> TraverseOut:
    from .. import kernels

    ptrs = _walk_args(wide, leaves, leaf_kind, ray_o, ray_d, skip, order)
    dev = ray_o.device
    R = ray_o.shape[0]
    f32, i32 = torch.float32, torch.int32

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = TraverseOut(
        row=empty((R,), i32), t=empty((R,), f32), prim=empty((R,), i32),
        position=empty((R, 3), f32), normal=empty((R, 3), f32),
        flags=empty((R,), i32), u=empty((R,), f32), v=empty((R,), f32),
        stats=empty((R, 2), i32) if want_stats else None)
    err = kernels.load().rtc_traverse(
        *ptrs, *(None if t is None else t.data_ptr() for t in out),
        *_walk_sizes(wide, leaves, leaf_kind, ray_o), eps_behind,
        eps_pos * eps_pos, _stream(dev))
    if err != 0:
        raise RuntimeError(f"traversal kernel launch failed: CUDA error {err}")
    kernels.count_launch(traverse)
    return out


def _launch_record(wide, leaves, leaf_kind, ray_o, ray_d, skip, eps_behind,
                   eps_pos, tri, prior, order):
    from .. import kernels
    from ..intersect.dispatch import HitRecord

    ptrs = _walk_args(wide, leaves, leaf_kind, ray_o, ray_d, skip, order)
    dev = ray_o.device
    R = ray_o.shape[0]
    f32, i32 = torch.float32, torch.int32
    if tri is None:
        normal_ptrs = [None] * 3
    else:
        if leaf_kind != "tri":
            raise ValueError("traverse_record: smooth normals are a "
                             "triangle table's")
        n_rows = tri.n0.shape[0]
        for name in ("n0", "n1", "n2"):
            _check(f"tri.{name}", getattr(tri, name), (n_rows, 3), f32, dev)
        normal_ptrs = [tri.n0.data_ptr(), tri.n1.data_ptr(),
                       tri.n2.data_ptr()]
    if prior is None:
        prior_ptrs = [None] * 5
    else:
        _check("prior.prim", prior.prim, (R,), i32, dev)
        _check("prior.t", prior.t, (R,), f32, dev)
        _check("prior.position", prior.position, (R, 3), f32, dev)
        _check("prior.normal", prior.normal, (R, 3), f32, dev)
        _check("prior.inside", prior.inside, (R,), torch.bool, dev)
        prior_ptrs = [t.data_ptr() for t in (prior.prim, prior.t,
                                             prior.position, prior.normal,
                                             prior.inside)]

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = HitRecord(prim=empty((R,), i32), t=empty((R,), f32),
                    position=empty((R, 3), f32), normal=empty((R, 3), f32),
                    inside=empty((R,), torch.bool))
    err = kernels.load().rtc_traverse_record(
        *ptrs, *normal_ptrs, *prior_ptrs, out.prim.data_ptr(),
        out.t.data_ptr(), out.position.data_ptr(), out.normal.data_ptr(),
        out.inside.data_ptr(), *_walk_sizes(wide, leaves, leaf_kind, ray_o),
        int(tri is not None), eps_behind, eps_pos * eps_pos, _stream(dev))
    if err != 0:
        raise RuntimeError(f"traversal kernel launch failed: CUDA error {err}")
    kernels.count_launch(traverse)
    kernels.count_launch(traverse_record)
    kernels.count_launch(traverse_record.by_kind[leaf_kind])
    if prior is not None:
        kernels.count_launch(traverse_record.merges)
    return out


def traverse(wide: WideNodes, leaves, leaf_kind: str, ray_o, ray_d, skip,
             eps_behind: float, eps_pos: float, want_stats: bool = False,
             order=None) -> TraverseOut:
    """Closest hit of every ray in one packed BVH, walked through its wide
    tree ``wide``.  On CUDA tensors this launches ``csrc/traverse.cu``
    (counted in ``traverse.launches``) or raises; on CPU tensors it runs
    :func:`traverse_wide_reference`.  Rays and the skip record are f32 and
    contiguous; ``order`` (int64 [R] or None) is the order in which the
    rays are walked (:meth:`CudaBVH.ray_order`), which changes no
    output."""
    if leaf_kind not in LEAF_KINDS:
        raise ValueError(f"traverse: unknown leaf kind {leaf_kind!r}")
    if ray_o.device.type == "cuda":
        return _launch(wide, leaves, leaf_kind, ray_o, ray_d, skip,
                       eps_behind, eps_pos, want_stats, order)
    if ray_o.device.type == "cpu":
        return traverse_wide_reference(wide, leaves, leaf_kind, ray_o,
                                       ray_d, skip, eps_behind, eps_pos,
                                       want_stats, order)
    raise ValueError(f"traverse: unsupported device {ray_o.device}")


# Launches of the traversal kernel (set it to 0 before a run to see that
# the run went through the kernel).
traverse.launches = 0


def traverse_record(wide: WideNodes, leaves, leaf_kind: str, ray_o, ray_d,
                    skip, eps_behind: float, eps_pos: float, tri=None,
                    prior=None, order=None):
    """The bounce's final hit record (``dispatch.HitRecord``) from the walk
    of one packed BVH: :func:`record_reference` of :func:`traverse`'s
    outputs, with ``tri`` (the triangle table, for its smooth rows' vertex
    normals, or None) and ``prior`` (a record this one merges into, or
    None).  On CUDA tensors where the tables and the prior record are
    float32 the kernel writes the record itself (counted in
    ``traverse.launches`` and ``traverse_record.launches``); a float64
    scene's smooth normals take the chain on the kernel's outputs, as
    CPU tensors take it on the plain walk's."""
    if leaf_kind not in LEAF_KINDS:
        raise ValueError(f"traverse: unknown leaf kind {leaf_kind!r}")
    planes = (([] if tri is None else [tri.n0, tri.n1, tri.n2])
              + ([] if prior is None else [prior.t, prior.position,
                                           prior.normal]))
    if ray_o.device.type == "cuda" and all(x.dtype == torch.float32
                                           for x in planes):
        return _launch_record(wide, leaves, leaf_kind, ray_o, ray_d, skip,
                              eps_behind, eps_pos, tri, prior, order)
    return record_reference(
        traverse(wide, leaves, leaf_kind, ray_o, ray_d, skip, eps_behind,
                 eps_pos, order=order), tri, prior)


# The traversal launches that wrote the final record (each is counted in
# traverse.launches too): where a BVH route's run reads less here than
# there, the eager chain built a record.  Of them, by leaf kind, and those
# that merged into a prior record.
traverse_record.launches = 0
traverse_record.by_kind = {kind: LaunchCount(f"traverse_record.{kind}")
                           for kind in LEAF_KINDS}
traverse_record.merges = LaunchCount("traverse_record.merges")


# ---------------------------------------------------------------------------
# The ray-coherence key
# ---------------------------------------------------------------------------

def _spread(x):
    """Bit ``i`` of ``x`` (int32, < 2^10) to bit ``3i``: the 3-D Morton
    interleave."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


@torch.no_grad()
def sort_key_reference(ray_o, ray_d, root_min, root_max):
    """int32 [R] coherence keys of f32 rays (any device): the JAX package's
    ``PallasBVH._sort_key`` with its operations in its order.  The
    direction bin (per axis ``d · 0.5 + 0.5`` clipped to [0, 1] and cut
    into ``2^(SORT_DIR_BITS + 1)`` bins: the octant) sits above the Morton
    code of the origin, each axis clipped to the root box ``root_min``,
    ``root_max`` ([3] f32) and truncated to ``SORT_MORTON_BITS`` bits.  A
    parked ray (far outside the box, direction +x) gets the largest key,
    ``2^27 - 1``."""
    mb, db = SORT_MORTON_BITS, SORT_DIR_BITS
    ext = torch.clamp(root_max - root_min, min=1e-30)
    q = torch.clamp((ray_o - root_min) / ext, 0.0, 1.0)
    q = (q * ((1 << mb) - 1)).to(torch.int32)
    morton = (_spread(q[:, 0]) | (_spread(q[:, 1]) << 1)
              | (_spread(q[:, 2]) << 2))
    dq = torch.clamp(ray_d * 0.5 + 0.5, 0.0, 1.0)
    dbin = torch.clamp((dq * (1 << (db + 1))).to(torch.int32), 0,
                       (1 << (db + 1)) - 1)
    dirbin = (dbin[:, 0] + (1 << (db + 1)) * dbin[:, 1]
              + (1 << (2 * (db + 1))) * dbin[:, 2])
    return (dirbin << (3 * mb)) | morton


def _launch_key(ray_o, ray_d, root_min, root_max):
    from .. import kernels

    dev = ray_o.device
    R = ray_o.shape[0]
    f32 = torch.float32
    _check("ray_o", ray_o, (R, 3), f32, dev)
    _check("ray_d", ray_d, (R, 3), f32, dev)
    _check("root_min", root_min, (3,), f32, dev)
    _check("root_max", root_max, (3,), f32, dev)
    key = torch.empty((R,), dtype=torch.int32, device=dev)
    err = kernels.load().rtc_sort_key(
        ray_o.data_ptr(), ray_d.data_ptr(), root_min.data_ptr(),
        root_max.data_ptr(), key.data_ptr(), R, SORT_MORTON_BITS,
        SORT_DIR_BITS, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sort key kernel launch failed: CUDA error {err}")
    kernels.count_launch(sort_key)
    return key


def sort_key(ray_o, ray_d, root_min, root_max):
    """The coherence key of every ray (:func:`sort_key_reference`).  On
    CUDA tensors this launches the key kernel of ``csrc/traverse.cu``
    (counted in ``sort_key.launches``) or raises; on CPU tensors it runs
    the plain version.  Rays f32 [R, 3] and contiguous."""
    if ray_o.device.type == "cuda":
        return _launch_key(ray_o, ray_d, root_min, root_max)
    if ray_o.device.type == "cpu":
        return sort_key_reference(ray_o, ray_d, root_min, root_max)
    raise ValueError(f"sort_key: unsupported device {ray_o.device}")


# Launches of the key kernel.
sort_key.launches = 0


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
        # The binary nodes (the oracle's, traverse_reference) and the wide
        # tree the kernel walks.
        self.nodes = torch.tensor(pack_nodes(bvh), device=self.device)
        self.wide = pack_wide_nodes(bvh, self.device)
        self.leaves = torch.tensor(leaves, device=self.device)
        self.n_nodes = int(bvh.n_nodes)
        self.K = int(bvh.leaf_prims.shape[1])
        # The root box, which the sort key's Morton code divides.
        self.root_min = torch.tensor(_np(bvh.bmin)[0], dtype=torch.float32,
                                     device=self.device)
        self.root_max = torch.tensor(_np(bvh.bmax)[0], dtype=torch.float32,
                                     device=self.device)
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

    def ray_order(self, ray_o, ray_d, reference: bool = False):
        """int64 [R]: the rays (f32, contiguous) in the order of their
        coherence key against this tree's root box: :func:`sort_key` (or
        its plain version with ``reference=True``), then ``torch.sort``,
        stable so that the launch order is the same from run to run (no
        output depends on it)."""
        key = (sort_key_reference if reference else sort_key)(
            ray_o, ray_d, self.root_min, self.root_max)
        return torch.sort(key, stable=True).indices

    def select(self, ray_o, ray_d, skip, eps_behind, eps_pos,
               want_detail: bool = False, want_stats: bool = False,
               reference: bool = False, sort: bool = False):
        """``(best_row [R] int32 clamped to 0, any [R] bool, t [R])`` — the
        dispatch layer's triangle / sphere selection.

        ``want_detail=True`` appends the winner's full hit detail committed
        in the kernel: a dict with ``prim`` (int32), ``pos`` [R, 3], ``nrm``
        [R, 3] (FLAT normal for triangles), ``inside`` / ``inside_geo`` /
        ``smooth`` (bool) and ``u`` / ``v`` — so the dispatch layer builds
        the HitRecord with no [R]-row gathers from the primitive tables.
        ``want_stats=True`` appends the ``[R, 2]`` int32 counters (the
        root test and wide nodes fetched, records tested).  ``sort=True``
        walks the rays in the
        order of :meth:`ray_order` (on CUDA tensors the key kernel, then the
        traversal kernel reading that order); every output, counters
        included, is the same as with ``sort=False`` and in the caller's
        ray order.  ``reference=True`` runs the plain versions (the wide
        walk :func:`traverse_wide_reference`) on whatever device the rays
        are on (the comparison's side of ``chip_smoke.py``); otherwise CUDA
        tensors launch the kernels (or raise) and CPU tensors run the plain
        versions."""
        f32 = torch.float32
        o = ray_o.detach().to(f32).contiguous()
        d = ray_d.detach().to(f32).contiguous()
        order = self.ray_order(o, d, reference) if sort else None
        out = (traverse_wide_reference if reference else traverse)(
            self.wide, self.leaves, self.leaf_kind, o, d, self._skip(skip),
            float(eps_behind), float(eps_pos), want_stats, order)
        res = (torch.clamp(out.row, min=0), out.row >= 0, out.t)
        if want_detail:
            res += (_detail(out),)
        if want_stats:
            res += (out.stats,)
        return res

    def record(self, ray_o, ray_d, skip, eps_behind, eps_pos, tri=None,
               prior=None, sort: bool = False):
        """The bounce's final hit record from this tree
        (:func:`traverse_record`: ``tri`` the triangle table of a tree
        with smooth rows, ``prior`` the record to merge into), the rays
        walked in the order of :meth:`ray_order` where ``sort``."""
        f32 = torch.float32
        o = ray_o.detach().to(f32).contiguous()
        d = ray_d.detach().to(f32).contiguous()
        order = self.ray_order(o, d) if sort else None
        return traverse_record(self.wide, self.leaves, self.leaf_kind, o, d,
                               self._skip(skip), float(eps_behind),
                               float(eps_pos), tri=tri, prior=prior,
                               order=order)


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
