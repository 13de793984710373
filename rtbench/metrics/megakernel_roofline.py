"""``megakernel_roofline``: the least time the card could take for one
pass of the whole-path megakernel (``trace_fused_kernel``), over its mean
device time a launch in the traced stretch, in percent.

The work is the cell's problem, counted as ``chip_smoke.py`` counts it
(``row_ops``, ``OPS_SHADE`` and the megakernel's bound, commit 25c2873):
every ray at every bounce its path reaches (the reference's count on the
checked paths) tests every table row up to the row's first exit (a
triangle's Möller–Trumbore without the coplanar test 46 operations, a
sphere's object-space ray and discriminant 63, a plane's 13) and shades
once (150); the bytes are the rays (origin and direction), their
``[bounces, 7]`` uniforms and the tables read once, and colour and miss
(16 bytes a ray) written once.  Moves ``samples_px_per_s``."""

import numpy as np

from rtbench.peaks import bound_ms

OPS_TRI, OPS_SPH, OPS_PLN, OPS_SHADE = 46, 63, 13, 150
TABLE_BYTES = {"triangles": 21 * 4 + 16, "spheres": 28 * 4 + 16,
               "planes": 4 * 4 + 16, "materials": 14 * 4}


def work(rays, bounces_per_path, recursion, n_tri, n_sph, n_pln, n_mat):
    """``(operations, bytes)`` of one pass."""
    reached = rays * bounces_per_path
    ops = reached * (n_tri * OPS_TRI + n_sph * OPS_SPH + n_pln * OPS_PLN
                     + OPS_SHADE)
    n_bytes = (rays * (24 + (recursion + 1) * 7 * 4 + 16)
               + n_tri * TABLE_BYTES["triangles"]
               + n_sph * TABLE_BYTES["spheres"]
               + n_pln * TABLE_BYTES["planes"]
               + n_mat * TABLE_BYTES["materials"] + 16)
    return ops, n_bytes


def read(ctx):
    seconds, launches = ctx.profile.kernel("trace_fused_kernel")
    if not launches:
        return None
    t = ctx.counts["scene_tables"]

    def rows(table):
        return int((np.asarray(t[table]["prim_id"]) >= 0).sum())
    ops, n_bytes = work(ctx.counts["rays_per_pass"],
                        ctx.counts["bounces_per_path"], int(t["recursion"]),
                        rows("triangles"), rows("spheres"), rows("planes"),
                        int(t["n_prims"]))
    return 100.0 * bound_ms(ops, n_bytes) / (seconds / launches * 1e3)
