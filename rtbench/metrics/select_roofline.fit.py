"""``select_roofline.fit``: the least time the card could take for one
closest-hit query of a bounce of the train step's recorder on the dense
tier (``csrc/select.cu``: its list, select and finish kernels), over the
query's mean device time in the traced stretch of steps, in percent.  The
work is counted from the problem (:mod:`rtbench.select_work`); none where
no select kernel ran.  Moves ``fit_steps_per_s``."""

from rtbench.select_work import roofline


def read(ctx):
    return roofline(ctx, "rays_per_step")
