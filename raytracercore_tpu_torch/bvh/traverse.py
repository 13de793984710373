"""Stackless skip-link BVH traversal as a lockstep torch walk (counterpart
of ``raytracercore_tpu.bvh.traverse``).

Replaces the reference's recursive collect-all-leaves + sorted scan
(BVH.IntersectLeaves, Acceleration/BVH.cs:295-331; consumed with early exit
by Scene.RayTracePrimitives, Scene.cs:65-91) with a closest-hit traversal:
every ray walks the preorder node list via skip links, culling subtrees whose
AABB entry distance exceeds the current best hit — the same pruning the
reference gets from its near/far sort, without materializing candidate lists.

All rays advance one node per iteration of a Python loop; the rays still
walking are gathered into a dense batch each iteration.  The walk is
deliberately NON-differentiable — it returns only the winning triangle
index per ray, and the dispatch layer re-evaluates that single triangle
differentiably.  It is the reference walk of the hooks route
(``dispatch.make_bvh_closest_fn(traversal="walk")``) and the independent
check of the traversal kernel's plain version
(:func:`.cuda_traverse.traverse_reference`), with which it shares no code:
this one tests triangles through :func:`..intersect.torch_ref.
moller_trumbore` (coplanar branch on) and treats a zero direction component
with an infinite inverse.
"""

from __future__ import annotations

import torch

from ..intersect.torch_ref import aabb_slab, moller_trumbore
from .builder import BVHArrays

INF = float("inf")


def _slab(bmin, bmax, o, inv_d):
    """Per-ray AABB slab test with precomputed 1/d (AABB.cs:107-142
    semantics: zero direction ⇒ ±inf handled via precomputed inv)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    # Zero-direction lanes: inv = ±inf gives ±inf already unless o == b
    # (0*inf = NaN); scrub NaNs to the open interval.
    lo = torch.where(torch.isnan(lo), -INF, lo)
    hi = torch.where(torch.isnan(hi), INF, hi)
    return lo.amax(dim=-1), hi.amin(dim=-1)


@torch.no_grad()
def traverse_closest(bvh: BVHArrays, tri, mats, ray_o, ray_d, skip,
                     near_enough, eps_pos):
    """Closest valid triangle per ray through the BVH.

    Filtering (invert / two-sided / skip-hit) happens DURING traversal so a
    closer invalid hit cannot shadow a farther valid one — mirroring
    Primitive.RayTrace inside the scan (Primitive.cs:46-75).

    Returns (best_idx [R] int32 triangle-table index or -1, best_t [R]).
    Non-differentiable.
    """
    R = ray_o.shape[0]
    device = ray_o.device
    bvh = bvh.to(device)
    n_nodes = bvh.n_nodes
    K = bvh.leaf_prims.shape[1]
    ray_o, ray_d = ray_o.detach(), ray_d.detach()

    zero_d = ray_d == 0
    inv_d = torch.where(zero_d, INF, 1.0 / torch.where(zero_d, 1.0, ray_d))

    # Per-triangle material flags, gathered per leaf slot below.
    tri_prim = tri.prim_id
    safe_prim = torch.clamp(tri_prim, min=0).long()
    tri_invert = mats.invert[safe_prim] & (tri_prim >= 0)
    tri_twosided = mats.two_sided[safe_prim] | (tri_prim < 0)

    def leaf_test(at, slot, best_t, best_idx):
        """Test the ≤K triangles of leaf rows ``slot`` against rays ``at``
        (both [A]); returns the updated (best_t, best_idx) of those rays."""
        o, d = ray_o[at], ray_d[at]
        rows = bvh.leaf_prims[slot.long()]                  # [A, K]
        safe = torch.clamp(rows, min=0).long()
        mt = moller_trumbore(
            o[:, None, :], d[:, None, :], tri.v0[safe], tri.e1[safe],
            tri.e2[safe], tri.normal[safe], tri.mirror[safe], rows >= 0,
            near_enough)

        inside = mt["inside"] ^ tri_invert[safe]
        valid = mt["valid"] & ~(inside & ~tri_twosided[safe])

        # Skip-hit (same-prim + position + parity; Util.cs:179-192).
        if skip is not None:
            sk_prim, sk_pos = skip.prim[at], skip.position[at]
            cand_pos = o[:, None, :] + d[:, None, :] * torch.where(
                valid, mt["t"], 0.0)[..., None]
            d2 = ((cand_pos - sk_pos[:, None, :]) ** 2).sum(-1)
            scale = 1.0 + (sk_pos ** 2).sum(-1)[:, None]
            pos_close = d2 <= (eps_pos * eps_pos) * scale
            leaving = ((d * skip.normal[at]).sum(-1) > 0)[:, None]
            same_side = inside == skip.inside[at][:, None]
            parity = leaving ^ same_side
            match = ((tri_prim[safe] == sk_prim[:, None]) & pos_close
                     & parity & (sk_prim >= 0)[:, None])
            valid = valid & ~match

        t = torch.where(valid, mt["t"], INF)
        leaf_t, leaf_best = t.min(dim=1)
        leaf_idx = torch.gather(rows, 1, leaf_best[:, None])[:, 0]
        better = leaf_t < best_t
        return (torch.where(better, leaf_t, best_t),
                torch.where(better, leaf_idx, best_idx))

    ptr = torch.zeros((R,), dtype=torch.int64, device=device)
    best_t = torch.full((R,), INF, dtype=ray_o.dtype, device=device)
    best_idx = torch.full((R,), -1, dtype=torch.int32, device=device)
    skip_link = bvh.skip.long()
    while True:
        at = torch.nonzero(ptr < n_nodes)[:, 0]   # the rays still walking
        if at.numel() == 0:
            break
        p = ptr[at]
        near, far = _slab(bvh.bmin[p], bvh.bmax[p], ray_o[at], inv_d[at])
        hit_box = ((near <= far) & (far >= -near_enough)
                   & (near <= best_t[at]))
        slot = bvh.leaf_slot[p]
        is_leaf = slot >= 0

        do_leaf = hit_box & is_leaf
        if bool(do_leaf.any()) and K:
            sub = at[do_leaf]
            best_t[sub], best_idx[sub] = leaf_test(
                sub, slot[do_leaf], best_t[sub], best_idx[sub])

        # Advance: internal hit → fall through to i+1; otherwise escape.
        ptr[at] = torch.where(hit_box & ~is_leaf, p + 1, skip_link[p])
    return best_idx, best_t


def count_node_hits(bvh: BVHArrays, ray_o, ray_d):
    """Per-ray count of BVH nodes whose AABB the ray enters — the debug
    heat-map statistic (BVH.GetIntersectionCount, BVH.cs:352-363).  Dense
    [R × nodes] evaluation (debug tool, small node counts)."""
    bvh = bvh.to(ray_o.device)
    near, far = aabb_slab(bvh.bmin, bvh.bmax, ray_o, ray_d)
    hit = (near <= far) & (far >= 0)
    return hit.sum(dim=1)
