"""``traverse_roofline``: the least time the card could take for one
launch of the BVH traversal kernel (``traverse_kernel``: one closest-hit
query of a bounce over the triangle table), over its mean device time a
launch in the traced stretch, in percent.

The work is the cell's problem, not the kernel's layout: a launch takes
the rays of one bounce (the pass's rays times the bounces the checked
paths reach, over the bounces of a pass), reads each ray's origin and
direction (24 bytes) and skip record (prim, position, normal, inside: 29
bytes) once, the triangle table's vertex and edge rows (36 bytes a
triangle) once, and writes each ray's hit (prim, t, u, v, position,
normal, inside: 41 bytes) once.  Its operations (at least the winning
triangle's Möller–Trumbore, 46, and a box test of 27, a ray) are far
under the bytes.  The wide nodes and packed leaves of the program's
tree are its own layout and are not counted.  Moves
``samples_px_per_s``."""

import numpy as np

from rtbench.peaks import bound_ms

RAY_IN, SKIP_IN, HIT_OUT, TRI_BYTES = 24, 29, 41, 36
OPS_RAY = 46 + 27


def work(rays_per_launch, n_tri):
    """``(operations, bytes)`` of one launch."""
    return (rays_per_launch * OPS_RAY,
            rays_per_launch * (RAY_IN + SKIP_IN + HIT_OUT)
            + n_tri * TRI_BYTES)


def read(ctx):
    seconds, launches = ctx.profile.kernel("traverse_kernel")
    if not launches:
        return None
    t = ctx.counts["scene_tables"]
    n_tri = int((np.asarray(t["triangles"]["prim_id"]) >= 0).sum())
    per_launch = (ctx.counts["rays_per_pass"]
                  * ctx.counts["bounces_per_path"] / (int(t["recursion"]) + 1))
    ops, n_bytes = work(per_launch, n_tri)
    return 100.0 * bound_ms(ops, n_bytes) / (seconds / launches * 1e3)
