"""``optimizer_us.fit``: the median host µs of the port's span
``train.optimizer`` (the gradients re-pointed and ``optimizer.step()``,
Adam's eager kernels issued outside the step's graph) over the traced
stretch's steps, under the profiler, which slows every CUDA call.  Read
from the spans the port kept while the stretch was profiled; none where
it kept none.  Moves ``fit_steps_per_s``."""

from rtbench.spantrace import median_us, profiled


def read(ctx):
    return median_us(profiled(), "train.optimizer", under="train.step")
