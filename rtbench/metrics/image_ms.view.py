"""``image_ms.view``: the median host time of ``Renderer.image()`` (the
tonemap and the copy of the image to the host) over every frame of the
window, from the benchmark's own span around the call.  Moves
``frame_ms_p95``."""

import statistics


def read(ctx):
    times = ctx.counts.get("image_s")
    if not times:
        return None
    return statistics.median(times) * 1e3
