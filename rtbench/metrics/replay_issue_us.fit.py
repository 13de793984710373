"""``replay_issue_us.fit``: the median host µs of the port's span
``graph.replay`` inside ``train.step`` over the traced stretch's steps:
the host's time to issue one CUDA-graph replay of a step's forward and
backward, as the profiler, which slows every CUDA call, lets it.  Read
from the spans the port kept while the stretch was profiled; none where
it kept none.  Moves ``fit_steps_per_s``."""

from rtbench.spantrace import median_us, profiled


def read(ctx):
    return median_us(profiled(), "graph.replay", under="train.step")
