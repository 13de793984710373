"""``image_ms.view_rate``: the median host time of ``Renderer.image()``
(the tonemap and the copy of the image to the host) over every frame of
the window, from the benchmark's own span around the call, in the view
cells that bound the rate and not the frame tail.  Moves
``samples_px_per_s``."""

import statistics


def read(ctx):
    times = ctx.counts.get("image_s")
    if not times:
        return None
    return statistics.median(times) * 1e3
