"""``replay_issue_us.view``: the median host µs of the port's span
``graph.replay`` inside ``render.step`` over the traced stretch's frames:
the host's time to issue one CUDA-graph replay of a pass (one launch of
its ~90 nodes on cornell, more on the mesh), as the profiler, which
slows every CUDA call, lets it.  Read from the spans the port kept while
the stretch was profiled; none where it kept none.  Moves
``samples_px_per_s``."""

from rtbench.spantrace import median_us, profiled


def read(ctx):
    return median_us(profiled(), "graph.replay", under="render.step")
