"""``replay_bwd_roofline``: the least time the card could take for the
replay backward of one train step (``replay_bwd``: the material gradient
of every path's shading along its recorded bounces), over its mean device
time a launch in the traced stretch, in percent.

The work is the cell's problem as ``chip_smoke.py`` counts the backward's
inputs and operations (``OPS_SHADE``, ``OPS_SHADE_BWD``, commit 25c2873):
every bounce the paths reach (the reference's count) shades forward and
back (150 + 600 operations); the bytes are each input read once (the
rays' directions, 12 bytes; their ``[bounces, 7]`` uniforms; the
recorded path, prim, flags and normal, 20 bytes a bounce; the colour's
cotangent, 12 bytes; the material table, 56 bytes a row) and the
gradient, 56 bytes a row, written once.  The per-block partial sums of
the program's kernel are its layout, not counted (``chip_smoke.py``
counts them: 0.0823 ms on cornell against 0.0807 here).  Moves
``fit_steps_per_s``."""

from rtbench.peaks import bound_ms

OPS_SHADE, OPS_SHADE_BWD = 150, 600


def work(rays, bounces, bounces_per_path, n_mat):
    """``(operations, bytes)`` of one backward."""
    reached = rays * bounces_per_path
    return (reached * (OPS_SHADE + OPS_SHADE_BWD),
            rays * (12 + bounces * (7 * 4 + 20) + 12)
            + n_mat * 56 * 2 + 16)


def read(ctx):
    seconds, launches = ctx.profile.kernel("replay_bwd")
    if not launches:
        return None
    t = ctx.counts["scene_tables"]
    ops, n_bytes = work(ctx.counts["rays_per_step"], int(t["recursion"]) + 1,
                        ctx.counts["bounces_per_path"], int(t["n_prims"]))
    return 100.0 * bound_ms(ops, n_bytes) / (seconds / launches * 1e3)
