"""``ellipsoid_walk_roofline``: the least time the card could take for one
launch of the BVH traversal kernel over transformed spheres
(``traverse_kernel`` with leaf kind 2: one closest-hit query of a bounce
over the ellipsoid table, merged into the triangle tree's record), over
its mean device time a launch in the traced stretch, in percent.

The work is the cell's problem, not the kernel's layout, as
``sphere_walk_roofline`` counts it: a launch takes the rays of one bounce
(the pass's rays times the bounces the checked paths reach, over the
bounces of a pass), reads each ray's origin and direction (24 bytes), its
skip record (prim, position, normal, inside: 29 bytes) and the prior
record it merges into (prim, t, position, normal, inside: 41 bytes) once,
and writes each ray's record (41 bytes) once: 135 bytes a ray.  It reads
the ellipsoid table once, 112 bytes a row: the world-to-object and
object-to-world 3x4 maps (48 + 48) and the object-space centre and radius
(16); only rows with ``prim_id >= 0`` that are ``transformed`` count.
The leaf's row and flag words, the wide nodes and the packed leaves are
the program's layout and are not counted.

Its operations, at least, a ray: the origin into object space (18) and
the direction (15), the direction's normalization (10), the winner's
quadratic and root (22), its object-space position (6) and world position
(18), its world t (8) and world normal (31), and one box test (27): far
under the bytes.  None where the program counts no record launch over
ellipsoid leaves (``cuda_traverse.traverse_record.by_kind["spht"]``) or
no such launch ran in the stretch.  Moves ``samples_px_per_s``."""

import numpy as np

from rtbench.peaks import bound_ms

RAY_IN, SKIP_IN, PRIOR_IN, REC_OUT = 24, 29, 41, 41
ELLIPSOID_BYTES = 48 + 48 + 16
OPS_RAY = 18 + 15 + 10 + 22 + 6 + 18 + 8 + 31 + 27
KERNEL = "traverse_kernel<2,"


def work(rays_per_launch, n_ellipsoids):
    """``(operations, bytes)`` of one launch."""
    return (rays_per_launch * OPS_RAY,
            rays_per_launch * (RAY_IN + SKIP_IN + PRIOR_IN + REC_OUT)
            + n_ellipsoids * ELLIPSOID_BYTES)


def n_ellipsoids(tables):
    """The sphere table's rows that are primitives and transformed."""
    sph = tables["spheres"]
    return int(((np.asarray(sph["prim_id"]) >= 0)
                & np.asarray(sph["transformed"], bool)).sum())


def ellipsoid_record_launches():
    """The program's count of record launches over ellipsoid leaves, 0
    where it keeps none."""
    try:
        from raytracercore_tpu_torch.bvh import cuda_traverse
    except ImportError:
        return 0
    by_kind = getattr(cuda_traverse.traverse_record, "by_kind", None)
    if not isinstance(by_kind, dict) or "spht" not in by_kind:
        return 0
    return int(by_kind["spht"].launches)


def read(ctx):
    if not ellipsoid_record_launches():
        return None
    seconds, launches = ctx.profile.kernel(KERNEL)
    if not launches:
        return None
    t = ctx.counts["scene_tables"]
    per_launch = (ctx.counts["rays_per_pass"]
                  * ctx.counts["bounces_per_path"] / (int(t["recursion"]) + 1))
    ops, n_bytes = work(per_launch, n_ellipsoids(t))
    return 100.0 * bound_ms(ops, n_bytes) / (seconds / launches * 1e3)
