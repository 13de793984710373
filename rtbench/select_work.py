"""The work of the dense tier's closest-hit query (``csrc/select.cu``: the
list, select and finish kernels of one bounce), counted from the problem,
for the ``select_roofline.*`` readers.

As ``chip_smoke.py`` ``select_times`` counts it (commit 25c2873): every
live ray of the bounce tests every table row up to the row's first exit
(a triangle's Möller–Trumbore with the coplanar test 52 operations, a
sphere's object-space ray and discriminant 63, a plane's 13), and each
winner takes 40 more (hit position, normal, skip test).  Bytes: every
lane's origin (12, the parking test), a live lane's direction (12) and,
after bounce 0, its skip record (prim, position, normal, inside: 29), the
tables once, and every lane's 13 output planes (46) once.  The device
list of live lanes and the (t, row) keys are the kernel's own layout and
are not counted.

A pass (or a train step's recorder) asks ``recursion + 1`` queries.  Its
live rays are the rays times the bounces the checked paths reach (the
reference's ``bounces_per_path``); a path that reaches bounce ``i + 1``
won at bounce ``i``, so at least ``rays · (bounces_per_path − 1)`` queries
end in a winner.  The readers take the mean query.
"""

from __future__ import annotations

import numpy as np

from rtbench.peaks import bound_ms

OPS_TRI, OPS_SPH, OPS_PLN, OPS_HIT = 52, 63, 13, 40
LANE_IN, LIVE_IN, SKIP_IN, LANE_OUT = 12, 12, 29, 46
# A table row read once, as megakernel_roofline counts it: a triangle's 21
# floats and its prim and flags, a sphere's 28 floats, a plane's 4.
ROW_BYTES = {"triangles": 21 * 4 + 16, "spheres": 28 * 4 + 16,
             "planes": 4 * 4 + 16}
# The kernels of csrc/select.cu as the device trace names them; the list
# kernel runs once a query.
KERNELS, PER_QUERY = "rtc::select_", "rtc::select_list_kernel"


def work(lanes, live, winners, skipped, n_tri, n_sph, n_pln):
    """``(operations, bytes)`` of one query over ``lanes`` rays, ``live``
    of them scanned, ``winners`` of them hitting, ``skipped`` of them
    carrying a skip record."""
    ops = (live * (n_tri * OPS_TRI + n_sph * OPS_SPH + n_pln * OPS_PLN)
           + winners * OPS_HIT)
    n_bytes = (lanes * (LANE_IN + LANE_OUT) + live * LIVE_IN
               + skipped * SKIP_IN + n_tri * ROW_BYTES["triangles"]
               + n_sph * ROW_BYTES["spheres"] + n_pln * ROW_BYTES["planes"])
    return ops, n_bytes


def mean_query(rays, bounces_per_path, recursion, n_tri, n_sph, n_pln):
    """``(operations, bytes)`` of the mean query of a pass of ``rays``
    paths (see the module's doc)."""
    queries = recursion + 1
    live = rays * bounces_per_path
    return work(rays, live / queries,
                rays * max(bounces_per_path - 1.0, 0.0) / queries,
                (live - rays) / queries, n_tri, n_sph, n_pln)


def rows(tables, table):
    """The real rows of one of the benchmark's numpy tables (padding rows,
    prim -1, cost nothing)."""
    return int((np.asarray(tables[table]["prim_id"]) >= 0).sum())


def roofline(ctx, rays_key):
    """The share, in percent, of the least time of the mean query in its
    mean device time (the select kernels' summed time over the queries the
    traced stretch ran), or None where no query ran on the device."""
    seconds, _ = ctx.profile.kernel(KERNELS)
    _, queries = ctx.profile.kernel(PER_QUERY)
    if not queries:
        return None
    t = ctx.counts["scene_tables"]
    ops, n_bytes = mean_query(
        ctx.counts[rays_key], ctx.counts["bounces_per_path"],
        int(t["recursion"]), rows(t, "triangles"), rows(t, "spheres"),
        rows(t, "planes"))
    return 100.0 * bound_ms(ops, n_bytes) / (seconds / queries * 1e3)
