"""Closest-hit query over the whole scene with material-level filtering
(counterpart of ``raytracercore_tpu.intersect.dispatch``): the dense
:func:`closest_hit` and the BVH tier's :func:`make_bvh_closest_fn`.

The batched equivalent of the reference's per-primitive wrapper + scene
scan:

* ``Primitive.RayTrace`` (Primitive.cs:46-75): iterate candidates nearest
  first, apply ``Invert`` (flip the inside flag), cull inside hits on
  single-sided primitives, and skip the hit matching the previous bounce's
  hit (``Util.RayHitMatches``, Util.cs:179-192) — self-intersection
  avoidance without epsilon ray offsets.
* ``Scene.RayTracePrimitives`` (Scene.cs:65-111): keep the closest
  surviving hit across all primitives.

Two phases, as in the JAX package:

1. **Selection** (no grad, on detached inputs): find which candidate wins.
   On CUDA tensors this is the select kernel
   (:func:`.cuda_select.select_all`); on CPU tensors a dense masked argmin
   over ``[R × N]`` grids of :mod:`.torch_ref`, walked in chunks of rays so
   the grids stay small.
2. **Winner evaluation** (differentiable through autograd): re-run the one
   winning primitive's intersection math per ray (``[R]``-shaped) to get
   t / position / normal with gradients attached.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SELECT_MAX_PRIMS
from ..core import vecmath as vm
from ..scene.types import SceneArrays
from . import torch_ref

INF = float("inf")

# make_bvh_closest_fn(sort=None) sorts, off the card, the rays of trees that
# cover more than this many leaf records (nodes x records a leaf): the JAX
# package's rule, which keys on the records covered, not the node count.
SORT_MIN_COVERED = 16384

# Grid cells (rays × table rows) one chunk of the dense scan may hold: a
# grid plane of 2^22 f32 cells is 16 MB, and a scan keeps a few dozen alive.
_GRID_CHUNK_CELLS = 1 << 22


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Batched hit: ``prim == -1`` ⇒ miss (the reference's null Hit)."""

    prim: torch.Tensor      # [R] int32 global primitive id, -1 = miss
    t: torch.Tensor         # [R]
    position: torch.Tensor  # [R, 3]
    normal: torch.Tensor    # [R, 3]
    inside: torch.Tensor    # [R] bool

    @property
    def found(self):
        return self.prim >= 0

    @classmethod
    def none(cls, n, dtype=torch.float32, device=None):
        return cls(prim=torch.full((n,), -1, dtype=torch.int32, device=device),
                   t=torch.zeros((n,), dtype=dtype, device=device),
                   position=torch.zeros((n, 3), dtype=dtype, device=device),
                   normal=torch.zeros((n, 3), dtype=dtype, device=device),
                   inside=torch.zeros((n,), dtype=torch.bool, device=device))

    def detach(self) -> "HitRecord":
        return HitRecord(*(getattr(self, f.name).detach()
                           for f in dataclasses.fields(self)))

    def rows(self, lo, hi) -> "HitRecord":
        """The record of rays ``lo:hi``."""
        return HitRecord(*(getattr(self, f.name)[lo:hi]
                           for f in dataclasses.fields(self)))


def _position_eps(dtype):
    """Tolerance for the skip-hit position match.

    The reference compares positions with a relative epsilon of 1e-24 in f64
    (Util.cs:18,41-74) — effectively exact.  In f32 the hit position is
    recomputed through different formulas between bounces, so a looser
    dtype-aware tolerance is needed.
    """
    return 1e-9 if dtype == torch.float64 else vm.POSITION_EPS_F32


def _skip_match(ray_d, cand_pos, cand_inside, cand_prim, skip, eps):
    """Batched Util.RayHitMatches (Util.cs:179-192) on ``[R, N]`` grids.

    a = candidate, b = skip (previous bounce's hit).  Match requires same
    primitive, nearly-equal position, and the inside-parity rule keyed on
    whether the new ray leaves along the skip hit's normal.  ``cand_pos``
    is a 3-tuple of ``[R, N]`` planes, ``cand_prim`` ``[N]``.
    """
    if skip is None:
        return torch.zeros_like(cand_inside)
    same_prim = cand_prim[None, :] == skip.prim[:, None]
    diff = tuple(cand_pos[k] - skip.position[:, k, None] for k in range(3))
    d2 = vm.dot3(diff, diff)
    scale = 1.0 + vm.dot(skip.position, skip.position)[:, None]
    pos_close = d2 <= (eps * eps) * scale
    leaving = vm.dot(ray_d, skip.normal)[:, None] > 0
    same_side = cand_inside == skip.inside[:, None]
    parity = leaving ^ same_side
    return same_prim & pos_close & parity & (skip.prim >= 0)[:, None]


def _filter(mats, prim_ids, inside_geo, valid, ray_d, approx_pos, skip, eps):
    """Apply invert / two-sided / skip filtering to candidate grids.

    Returns (valid', inside') where inside' has the Invert flip applied
    (Hit.Inverted, Hit.cs:39-42 — flips only the flag; the geometric normal
    flip already happened in the primitive's inside handling).
    """
    safe_ids = torch.clamp(prim_ids, min=0).long()
    invert = mats.invert[safe_ids][None, :]
    two_sided = mats.two_sided[safe_ids][None, :]

    inside = inside_geo ^ invert
    valid = valid & ~(inside & ~two_sided)
    match = _skip_match(ray_d, approx_pos, inside, prim_ids, skip, eps)
    return valid & ~match, inside


def _best(t, valid):
    """Masked argmin over the table axis → (idx [R], any [R]); the first
    row wins a tie."""
    t = torch.where(valid, t, INF)
    t_best, idx = torch.min(t, dim=1)
    return idx, torch.isfinite(t_best)


def _fin(x):
    """Sanitize inf/NaN to 0 — losing winners evaluate to t = inf, and
    computing positions with inf would leak NaNs through the final selects
    in reverse-mode AD."""
    return torch.where(torch.isfinite(x), x, 0.0)


def _chunks(scene_rows: int, n_rays: int):
    """Ray ranges of the dense scan: at most ``_GRID_CHUNK_CELLS`` grid
    cells each."""
    step = max(1, _GRID_CHUNK_CELLS // max(scene_rows, 1))
    return [(lo, min(lo + step, n_rays)) for lo in range(0, n_rays, step)]


def _chunked(select_rt, n_rows, ray_o, ray_d, skip):
    """Run a ``[rays, prims]`` scan ``select_rt(o, d, skip)`` over chunks
    of rays and join each of its outputs."""
    parts = [select_rt(ray_o[lo:hi], ray_d[lo:hi],
                       None if skip is None else skip.rows(lo, hi))
             for lo, hi in _chunks(n_rows, ray_o.shape[0])]
    if not parts:  # no rays
        return select_rt(ray_o, ray_d, skip)
    return tuple(torch.cat(outs) for outs in zip(*parts))


def _ray_planes(ray_o, ray_d, t):
    """``o + d·t`` for ``[R, N]`` grid ``t`` as three ``[R, N]`` planes."""
    return tuple(ray_o[:, k, None] + ray_d[:, k, None] * t for k in range(3))


# ---------------------------------------------------------------------------
# Triangles
# ---------------------------------------------------------------------------

def _triangle_select_dense(scene, ray_o, ray_d, skip, eps_behind, eps_pos):
    """Phase 1 (no grad): dense scan → winner index per ray."""
    return _chunked(
        lambda o, d, k: _triangle_select_rt(scene, o, d, k, eps_behind,
                                            eps_pos),
        scene.triangles.v0.shape[0], ray_o, ray_d, skip)


def _triangle_select_rt(scene, ray_o, ray_d, skip, eps_behind, eps_pos):
    """[rays, prims]-layout dense scan."""
    tri = scene.triangles
    tc = torch_ref.triangle_candidates(tri, ray_o, ray_d, eps_behind)
    pos_approx = _ray_planes(ray_o, ray_d,
                             torch.where(tc["valid"], tc["t"], 0.0))
    valid, _ = _filter(scene.materials, tri.prim_id, tc["inside"],
                       tc["valid"], ray_d, pos_approx, skip, eps_pos)
    return _best(tc["t"], valid)


def _triangle_winner_eval(scene, idx, any_, ray_o, ray_d, eps_behind):
    """Phase 2 (differentiable): one Möller–Trumbore per ray on the winner."""
    tri = scene.triangles
    safe = torch.clamp(idx, min=0).long()
    mt = torch_ref.moller_trumbore(
        ray_o, ray_d, tri.v0[safe], tri.e1[safe], tri.e2[safe],
        tri.normal[safe], tri.mirror[safe], any_, eps_behind)
    prim_ids = tri.prim_id[safe]
    invert = scene.materials.invert[torch.clamp(prim_ids, min=0).long()]
    inside = mt["inside"] ^ invert
    any_ = any_ & mt["valid"]
    pos, nrm = torch_ref.triangle_hit_detail(
        tri, safe, _fin(mt["u"]), _fin(mt["v"]), mt["inside"])
    return {
        "t": _fin(mt["t"]), "any": any_, "prim": prim_ids,
        "inside": inside, "position": pos, "normal": nrm,
    }


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

def _sphere_select(scene, ray_o, ray_d, skip, eps_pos):
    """Phase 1 (no grad): sphere scan (near+far roots) →
    (idx [R], use_near [R], any [R])."""
    return _chunked(
        lambda o, d, k: _sphere_select_rt(scene, o, d, k, eps_pos),
        scene.spheres.radius.shape[0], ray_o, ray_d, skip)


def _sphere_select_rt(scene, ray_o, ray_d, skip, eps_pos):
    """[rays, prims]-layout sphere scan."""
    sph = scene.spheres
    mats = scene.materials
    sc = torch_ref.sphere_candidates(sph, ray_o, ray_d)
    o_obj, d_obj = sc["o_obj"], sc["d_obj"]

    def sphere_set(t_obj, valid, inside_flag: bool):
        ts = torch.where(valid, t_obj, 0.0)
        pos_obj = tuple(o_obj[k] + d_obj[k] * ts for k in range(3))
        pos_w = torch_ref.rows3(sph.obj_to_world, *pos_obj)
        inside = torch.full_like(valid, inside_flag)
        valid2, _ = _filter(mats, sph.prim_id, inside, valid, ray_d, pos_w,
                            skip, eps_pos)
        t_w = vm.dot3(tuple(ray_d[:, k, None] for k in range(3)),
                      tuple(pos_w[k] - ray_o[:, k, None] for k in range(3)))
        return torch.where(valid2, t_w, INF), valid2

    near_tw, near_valid = sphere_set(sc["t_near_obj"], sc["valid_near"],
                                     False)
    far_tw, far_valid = sphere_set(sc["t_far_obj"], sc["valid_far"], True)

    # Near root is always closer; prefer it when valid (the reference's
    # ordered candidate scan, Sphere.cs:199-209).
    tw = torch.where(near_valid, near_tw, far_tw)
    valid = near_valid | far_valid
    idx, any_ = _best(tw, valid)
    use_near = torch.gather(near_valid, 1, idx[:, None])[:, 0]
    return idx, use_near, any_


def _sphere_winner_eval(scene, idx, use_near, any_, ray_o, ray_d):
    """Phase 2 (differentiable): re-solve the winning sphere per ray
    (Sphere.DoRayTrace math on [R] gathered rows, Sphere.cs:175-209)."""
    sph = scene.spheres
    safe = torch.clamp(idx, min=0).long()
    w2o = sph.world_to_obj[safe]
    o_obj = vm.transform_point(w2o, ray_o)
    d_obj = vm.transform_dir(w2o, ray_d)
    d_obj = d_obj / vm.safe_sqrt(vm.dot(d_obj, d_obj))[:, None]

    offset = o_obj - sph.center[safe]
    b = -2.0 * vm.dot(offset, d_obj)
    c = vm.dot(offset, offset) - sph.radius[safe] ** 2
    disc = b * b - 4.0 * c
    radix = vm.safe_sqrt(torch.where(disc >= 0, disc, 1.0))
    t_obj = torch.where(use_near, (b - radix) / 2.0, (b + radix) / 2.0)
    inside_geo = ~use_near

    pos, nrm, t = torch_ref.sphere_hit_detail(sph, safe, ray_o, ray_d, o_obj,
                                              d_obj, _fin(t_obj), inside_geo)
    prim_ids = sph.prim_id[safe]
    invert = scene.materials.invert[torch.clamp(prim_ids, min=0).long()]
    inside = inside_geo ^ invert
    return {
        "t": _fin(t), "any": any_ & (disc >= 0), "prim": prim_ids,
        "inside": inside, "position": pos, "normal": nrm,
    }


# ---------------------------------------------------------------------------
# Planes
# ---------------------------------------------------------------------------

def _plane_select(scene, ray_o, ray_d, skip, eps_behind, eps_pos):
    return _chunked(
        lambda o, d, k: _plane_select_rt(scene, o, d, k, eps_behind,
                                         eps_pos),
        scene.planes.origin_dist.shape[0], ray_o, ray_d, skip)


def _plane_select_rt(scene, ray_o, ray_d, skip, eps_behind, eps_pos):
    pl = scene.planes
    pc = torch_ref.plane_candidates(pl, ray_o, ray_d, eps_behind)
    pos_approx = _ray_planes(ray_o, ray_d,
                             torch.where(pc["valid"], pc["t"], 0.0))
    valid, _ = _filter(scene.materials, pl.prim_id, pc["inside"],
                       pc["valid"], ray_d, pos_approx, skip, eps_pos)
    return _best(pc["t"], valid)


def _plane_winner_eval(scene, idx, any_, ray_o, ray_d, eps_behind):
    pl = scene.planes
    safe = torch.clamp(idx, min=0).long()
    n = pl.normal[safe]
    dist0 = pl.origin_dist[safe]
    ray_dist = vm.dot(ray_o, n)
    denom = vm.dot(ray_d, n)
    nz_den = denom != 0
    coplanar = ~nz_den & (torch.abs(dist0 - ray_dist)
                          <= eps_behind * (1.0 + torch.abs(dist0)))
    t = torch.where(nz_den,
                    (dist0 - ray_dist) / torch.where(nz_den, denom, 1.0),
                    0.0)
    t = torch.where(coplanar, 0.0, torch.abs(t))
    inside_geo = coplanar | (denom > 0)
    pos, nrm = torch_ref.plane_hit_detail(pl, safe, ray_o, ray_d, _fin(t),
                                          inside_geo)
    prim_ids = pl.prim_id[safe]
    invert = scene.materials.invert[torch.clamp(prim_ids, min=0).long()]
    inside = inside_geo ^ invert
    return {
        "t": _fin(t), "any": any_, "prim": prim_ids,
        "inside": inside, "position": pos, "normal": nrm,
    }


# ---------------------------------------------------------------------------
# Combine
# ---------------------------------------------------------------------------

def _combine(tri_w, sph_w, pl_w):
    """Cross-table min reduction over the three winner records; on a tie
    the earlier table (triangles → spheres → planes) wins."""
    t0 = torch.where(tri_w["any"], tri_w["t"], INF)
    t1 = torch.where(sph_w["any"], sph_w["t"], INF)
    t2 = torch.where(pl_w["any"], pl_w["t"], INF)
    is0 = (t0 <= t1) & (t0 <= t2)
    is1 = ~is0 & (t1 <= t2)
    found = torch.isfinite(torch.minimum(torch.minimum(t0, t1), t2))

    def pick3(a, b, c):
        c0, c1 = (is0[:, None], is1[:, None]) if a.ndim == 2 else (is0, is1)
        return torch.where(c0, a, torch.where(c1, b, c))

    position = pick3(tri_w["position"], sph_w["position"], pl_w["position"])
    normal = pick3(tri_w["normal"], sph_w["normal"], pl_w["normal"])
    inside = pick3(tri_w["inside"], sph_w["inside"], pl_w["inside"])
    t = _fin(pick3(tri_w["t"], sph_w["t"], pl_w["t"]))
    prim = pick3(tri_w["prim"], sph_w["prim"], pl_w["prim"])
    prim = torch.where(found, prim, -1)

    return HitRecord(prim=prim.to(torch.int32), t=t, position=position,
                     normal=normal, inside=inside)


def n_table_rows(scene: SceneArrays) -> int:
    """Rows of the three primitive tables, padding rows included."""
    return (scene.triangles.v0.shape[0] + scene.spheres.radius.shape[0]
            + scene.planes.origin_dist.shape[0])


def _closest_from_tri_select(scene, ray_o, ray_d, skip, tri_select_fn,
                             sphere_select_fn=None):
    """Common part: no-grad selection for all tables, differentiable
    winner evaluation, cross-table combine.

    ``tri_select_fn`` (signature of :func:`_triangle_select_dense`) and
    ``sphere_select_fn`` (signature of :func:`_sphere_select`) override the
    dense scans — how a BVH plugs in.  With the dense defaults, on CUDA
    tensors all three selections come from one launch of the select kernel,
    which takes f32 rays (else ``ValueError``) and scenes within
    ``SELECT_MAX_PRIMS`` rows (else ``NotImplementedError``: they need
    :func:`make_bvh_closest_fn`); the grid scans run on CPU tensors, and on
    the card only behind a hook of the caller's own."""
    dtype = ray_o.dtype
    eps_behind = vm.near_enough(dtype)
    eps_pos = _position_eps(dtype)

    with torch.no_grad():
        o_sg, d_sg = ray_o.detach(), ray_d.detach()
        skip_sg = None if skip is None else skip.detach()
        if (ray_o.device.type == "cuda"
                and tri_select_fn is _triangle_select_dense
                and sphere_select_fn is None):
            from . import cuda_select
            rows = n_table_rows(scene)
            if rows > SELECT_MAX_PRIMS:
                raise NotImplementedError(
                    f"closest_hit on CUDA tensors: a scene of {rows} table "
                    "rows needs the BVH (make_bvh_closest_fn); the select "
                    f"kernel takes up to SELECT_MAX_PRIMS ({SELECT_MAX_PRIMS})"
                    " rows")
            ((tri_idx, tri_any), (sph_idx, use_near, sph_any),
             (pl_idx, pl_any)) = cuda_select.select_all(
                scene, o_sg.contiguous(), d_sg.contiguous(), skip_sg,
                eps_behind, eps_pos)
        else:
            tri_idx, tri_any = tri_select_fn(scene, o_sg, d_sg, skip_sg,
                                             eps_behind, eps_pos)
            sph_select = sphere_select_fn or _sphere_select
            sph_idx, use_near, sph_any = sph_select(scene, o_sg, d_sg,
                                                    skip_sg, eps_pos)
            pl_idx, pl_any = _plane_select(scene, o_sg, d_sg, skip_sg,
                                           eps_behind, eps_pos)

    tri_w = _triangle_winner_eval(scene, tri_idx, tri_any, ray_o, ray_d,
                                  eps_behind)
    sph_w = _sphere_winner_eval(scene, sph_idx, use_near, sph_any, ray_o,
                                ray_d)
    pl_w = _plane_winner_eval(scene, pl_idx, pl_any, ray_o, ray_d,
                              eps_behind)
    return _combine(tri_w, sph_w, pl_w)


def closest_hit(scene: SceneArrays, ray_o, ray_d, skip: HitRecord | None
                ) -> HitRecord:
    """Closest surviving hit across all primitive tables (dense selection).

    ``skip`` carries the previous bounce's hit per ray (prim == -1 ⇒ none).
    """
    return _closest_from_tri_select(scene, ray_o, ray_d, skip,
                                    _triangle_select_dense)


# ---------------------------------------------------------------------------
# The BVH tier
# ---------------------------------------------------------------------------

def _merge2(a, b):
    """Take ``b`` only where STRICTLY closer — preserves :func:`_combine`'s
    first-table-wins tie rule."""
    use_b = b["any"] & (~a["any"] | (b["t"] < a["t"]))
    sel = use_b[:, None]
    return {"t": torch.where(use_b, b["t"], a["t"]),
            "any": a["any"] | b["any"],
            "prim": torch.where(use_b, b["prim"], a["prim"]),
            "inside": torch.where(use_b, b["inside"], a["inside"]),
            "position": torch.where(sel, b["position"], a["position"]),
            "normal": torch.where(sel, b["normal"], a["normal"])}


def _rec_from_detail(any_, t, det):
    """Kernel detail dict → winner-record dict (the :func:`_merge2`
    shape)."""
    return {"t": _fin(torch.where(any_, t, 0.0)), "any": any_,
            "prim": det["prim"], "inside": det["inside"],
            "position": det["pos"], "normal": det["nrm"]}


def _rec_dict(hit: HitRecord):
    """A record → the :func:`_merge2` shape; its hit is ``prim >= 0``."""
    return {"t": hit.t, "any": hit.prim >= 0, "prim": hit.prim,
            "inside": hit.inside, "position": hit.position,
            "normal": hit.normal}


def _hit_from_rec(rec) -> HitRecord:
    """The :func:`_merge2` shape → a record, prim -1 where nothing hit."""
    prim = torch.where(rec["any"], rec["prim"], -1)
    return HitRecord(prim=prim.to(torch.int32), t=rec["t"],
                     position=rec["position"], normal=rec["normal"],
                     inside=rec["inside"])


def _tri_smooth_fixup(tri, row, det):
    """Re-interpolate the winner's SMOOTH normal (Triangle.GetNormal,
    Triangle.cs:209-224) from the kernel's committed (u, v): only the
    three per-vertex normal rows of the triangle table ``tri`` are
    gathered — the smooth flag rides the kernel's flag bits and the face
    normal is the committed flat normal un-flipped (nrm = fn·flip)."""
    safe = row.long()
    u, v = det["u"][:, None], det["v"][:, None]
    n_int = tri.n0[safe] * u + tri.n1[safe] * v + tri.n2[safe] * (u + v)
    n_int = vm.normalize(n_int, eps=1e-30)
    geo = det["inside_geo"][:, None]
    fn = det["nrm"] * torch.where(geo, -1.0, 1.0)
    refl = n_int - fn * (2.0 * vm.dot(n_int, fn))[:, None]
    n_sm = torch.where(geo, refl, n_int)
    return dict(det, nrm=torch.where(det["smooth"][:, None], n_sm,
                                     det["nrm"]))


def make_bvh_closest_fn(bvh, scene: SceneArrays | None = None,
                        traversal: str = "auto", sort=None):
    """Closest hit with the triangle selection routed through the skip-link
    BVH ``bvh`` (:func:`..bvh.builder.build_bvh`), for scenes of any size.
    Returns ``closest(scene, ray_o, ray_d, skip) → HitRecord``.

    ``traversal``:
      "walk"   — the hooks route: :func:`..bvh.traverse.traverse_closest`
                 picks the winning triangle (a lockstep torch walk, on any
                 device), the dense scans pick sphere and plane, and the
                 winners are evaluated differentiably
                 (:func:`_closest_from_tri_select`).  Slow at scale; its
                 geometry has gradients.
      "kernel" — the detail route (needs ``scene``, on the device the rays
                 will be on, for the leaf packing): every accelerated tier
                 returns the bounce's record from the traversal kernel
                 (:meth:`..bvh.cuda_traverse.CudaBVH.record`: on CUDA
                 tensors the kernel writes the final record in its
                 epilogue, the smooth normals re-interpolated and the
                 record merged into the tier before it; on CPU tensors the
                 plain walk and the chain of torch ops it replaces).
                 Untransformed and transformed spheres get BVHs of their
                 own from ``config.SPHERE_BVH_MIN_ROWS`` rows on; the
                 spheres that stay dense and the planes (the dense tail)
                 go through the select kernel in one launch, as a
                 sub-scene with an empty triangle table, and merge
                 eagerly.  Records merge with a strict ``t <`` in the
                 order triangles → sphere BVH → ellipsoid BVH → dense tail.
                 Geometry is stop-gradient: the material-gradient train
                 path never differentiates geometry, and forward rendering
                 takes no gradients.
      "auto"   — "kernel" when ``scene`` is given and lies on a CUDA
                 device, else "walk"; a walk picked this way refuses CUDA
                 rays (``ValueError``): on the card the plain walk runs only
                 when asked for by name.

    The flags of the materials (invert, two-sided) are packed at build
    time; the materials' colours are read from the scene given at call
    time.

    ``sort``: walk the rays of every BVH query in the order of their
    coherence key (``CudaBVH.select(sort=True)``: direction octant, then
    the Morton code of the origin in that BVH's root box), which changes
    which rays share a warp and no output; the decision holds for the
    triangle, sphere and ellipsoid BVHs alike.  None decides once from the
    triangle tree: off on a CUDA device, where the sorted walk measured
    slower (the key and the sort included) than the unsorted one; else
    the JAX package's rule, on when ``n_nodes * K > SORT_MIN_COVERED``
    (16384; ``K`` the records a leaf holds).  The "walk" route ignores
    it, as the JAX package's "xla" route does.

    The detail route's function carries what it walks: ``closest.bvhs``, the
    packed BVHs in merge order (``cuda_traverse.CudaBVH`` and its sphere
    kinds), ``closest.tail``, the dense tail's sub-scene or None, and
    ``closest.sort``, the decision.
    """
    if traversal not in ("auto", "walk", "kernel"):
        raise ValueError(f"make_bvh_closest_fn: unknown traversal "
                         f"{traversal!r}")
    walk_by_name = traversal == "walk"
    if traversal == "auto":
        on_card = (scene is not None
                   and scene.triangles.v0.device.type == "cuda")
        traversal = "kernel" if on_card else "walk"
    if traversal == "walk":
        from ..bvh.traverse import traverse_closest

        def tri_select_bvh(scene_sg, o_sg, d_sg, skip_sg, eps_behind,
                           eps_pos):
            best_idx, _ = traverse_closest(
                bvh, scene_sg.triangles, scene_sg.materials, o_sg, d_sg,
                skip_sg, eps_behind, eps_pos)
            return torch.clamp(best_idx, min=0), best_idx >= 0

        def closest_walk(scene: SceneArrays, ray_o, ray_d, skip):
            if ray_o.device.type == "cuda" and not walk_by_name:
                raise ValueError(
                    'make_bvh_closest_fn(traversal="auto") got rays on a CUDA '
                    "device but no scene on it to pack the kernel's leaves "
                    'from: give scene=, or ask for traversal="walk"')
            return _closest_from_tri_select(scene, ray_o, ray_d, skip,
                                            tri_select_bvh)
        return closest_walk
    if scene is None:
        raise ValueError('make_bvh_closest_fn(traversal="kernel") packs the '
                         "leaves from the scene: give scene=")

    from ..bvh import builder
    from ..bvh import cuda_traverse as ct
    from ..config import SPHERE_BVH_MIN_ROWS
    from .cuda_select import closest_hit_fused

    tri_bvh = ct.CudaBVH(bvh, scene.triangles, scene.materials,
                         scene.n_prims)
    any_smooth = bool(scene.triangles.smooth.any())
    if sort is None:
        # On the card the sorted walk measured slower than the unsorted one
        # on every bounce after the first (PERF.md §6): there None is off.
        do_sort = (tri_bvh.device.type != "cuda"
                   and tri_bvh.n_nodes * tri_bvh.K > SORT_MIN_COVERED)
    else:
        do_sort = bool(sort)

    # Sphere acceleration (the reference bounds every primitive type,
    # Scene.cs:39-49): a BVH over the UNTRANSFORMED spheres and one over
    # the TRANSFORMED ones (exact affine world AABBs); small tables stay
    # dense.
    sph = scene.spheres
    pid = sph.prim_id.cpu().numpy()
    transformed = sph.transformed.cpu().numpy()
    keep = pid >= 0
    sphere_bvhs = []
    for mask, cls, build in (
            (~transformed & (pid >= 0), ct.CudaSphereBVH,
             lambda m: builder.build_sphere_bvh(
                 sph.center.cpu().numpy(), sph.radius.cpu().numpy(), m,
                 device="cpu")),
            (transformed & (pid >= 0), ct.CudaEllipsoidBVH,
             lambda m: builder.build_ellipsoid_bvh(
                 sph.center.cpu().numpy(), sph.radius.cpu().numpy(),
                 sph.obj_to_world.cpu().numpy(), m, device="cpu"))):
        if int(mask.sum()) >= SPHERE_BVH_MIN_ROWS:
            sphere_bvhs.append(cls(build(mask), sph, scene.materials,
                                   scene.n_prims))
            keep &= ~mask

    # The dense tail: the spheres no BVH took and the planes, as a scene of
    # their own with an empty triangle table (COMPACT: a masked full-size
    # table would still cost its every row).
    def take(table, rows, masked):
        """Rows ``rows`` of a primitive table, as padding when ``masked``."""
        cols = {f.name: getattr(table, f.name)[rows]
                for f in dataclasses.fields(table)}
        if masked:
            cols["prim_id"] = torch.full_like(cols["prim_id"], -1)
        return dataclasses.replace(table, **cols)

    tail = None
    if keep.any() or bool((scene.planes.prim_id >= 0).any()):
        rows = torch.tensor(np.nonzero(keep)[0] if keep.any() else [0],
                            device=sph.prim_id.device)
        tail = dataclasses.replace(
            scene, spheres=take(sph, rows, not keep.any()),
            triangles=take(scene.triangles, slice(0, 1), True))

    def closest_kernel(scene_arg: SceneArrays, ray_o, ray_d, skip):
        dtype = ray_o.dtype
        eps_behind = vm.near_enough(torch.float32)
        eps_pos = _position_eps(torch.float32)
        with torch.no_grad():
            o_sg, d_sg = ray_o.detach(), ray_d.detach()
            skip_sg = None if skip is None else skip.detach()
            rec = tri_bvh.record(
                o_sg, d_sg, skip_sg, eps_behind, eps_pos,
                tri=scene_arg.triangles if any_smooth else None,
                sort=do_sort)
            for b in sphere_bvhs:
                rec = b.record(o_sg, d_sg, skip_sg, eps_behind, eps_pos,
                               prior=rec, sort=do_sort)
            if tail is not None:
                hit = closest_hit_fused(tail, o_sg, d_sg, skip_sg)
                rec = _hit_from_rec(_merge2(_rec_dict(rec), {
                    "t": hit.t.to(torch.float32), "any": hit.prim >= 0,
                    "prim": hit.prim, "inside": hit.inside,
                    "position": hit.position.to(torch.float32),
                    "normal": hit.normal.to(torch.float32)}))
        return HitRecord(prim=rec.prim, t=rec.t.to(dtype),
                         position=rec.position.to(dtype),
                         normal=rec.normal.to(dtype), inside=rec.inside)

    closest_kernel.bvhs = [tri_bvh, *sphere_bvhs]
    closest_kernel.tail = tail
    closest_kernel.sort = do_sort
    return closest_kernel
