"""``select_roofline.view``: the least time the card could take for one
closest-hit query of a bounce on the dense tier (``csrc/select.cu``: its
list, select and finish kernels), over the query's mean device time in
the traced stretch of frames, in percent.  The work is counted from the
problem (:mod:`rtbench.select_work`); none where no select kernel ran.
Moves ``samples_px_per_s``."""

from rtbench.select_work import roofline


def read(ctx):
    return roofline(ctx, "rays_per_pass")
