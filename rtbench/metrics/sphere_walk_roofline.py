"""``sphere_walk_roofline``: the least time the card could take for one
launch of the BVH traversal kernel over untransformed spheres
(``traverse_kernel`` with leaf kind 1: one closest-hit query of a bounce
over the sphere table, merged into the triangle tree's record), over its
mean device time a launch in the traced stretch, in percent.

The work is the cell's problem, not the kernel's layout, as
``traverse_roofline`` counts it: a launch takes the rays of one bounce
(the pass's rays times the bounces the checked paths reach, over the
bounces of a pass), reads each ray's origin and direction (24 bytes), its
skip record (prim, position, normal, inside: 29 bytes) and the prior
record it merges into (prim, t, position, normal, inside: 41 bytes) once,
the sphere table's centres and radii (16 bytes a sphere) once, and writes
each ray's record (41 bytes) once.  Its operations (at least the
direction's normalization, 10, the winning sphere's quadratic, root and
normal, 54, and a box test of 27, a ray) are far under the bytes.  The
wide nodes and packed leaves of the program's tree are its own layout and
are not counted.  None where the program counts no record launch over
sphere leaves (``cuda_traverse.traverse_record.by_kind["sph"]``).  Moves
``samples_px_per_s``."""

import numpy as np

from rtbench.peaks import bound_ms

RAY_IN, SKIP_IN, PRIOR_IN, REC_OUT, SPHERE_BYTES = 24, 29, 41, 41, 16
OPS_RAY = 10 + 54 + 27
KERNEL = "traverse_kernel<1,"


def work(rays_per_launch, n_sph):
    """``(operations, bytes)`` of one launch."""
    return (rays_per_launch * OPS_RAY,
            rays_per_launch * (RAY_IN + SKIP_IN + PRIOR_IN + REC_OUT)
            + n_sph * SPHERE_BYTES)


def sphere_record_launches():
    """The program's count of record launches over sphere leaves, 0 where
    it keeps none."""
    try:
        from raytracercore_tpu_torch.bvh import cuda_traverse
    except ImportError:
        return 0
    by_kind = getattr(cuda_traverse.traverse_record, "by_kind", None)
    if not isinstance(by_kind, dict) or "sph" not in by_kind:
        return 0
    return int(by_kind["sph"].launches)


def read(ctx):
    if not sphere_record_launches():
        return None
    seconds, launches = ctx.profile.kernel(KERNEL)
    if not launches:
        return None
    t = ctx.counts["scene_tables"]
    sph = t["spheres"]
    n_sph = int(((np.asarray(sph["prim_id"]) >= 0)
                 & ~np.asarray(sph["transformed"], bool)).sum())
    per_launch = (ctx.counts["rays_per_pass"]
                  * ctx.counts["bounces_per_path"] / (int(t["recursion"]) + 1))
    ops, n_bytes = work(per_launch, n_sph)
    return 100.0 * bound_ms(ops, n_bytes) / (seconds / launches * 1e3)
