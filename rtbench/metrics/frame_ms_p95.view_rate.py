"""``frame_ms_p95.view_rate``: the 95th percentile (nearest rank) of the
host times of all the window's frames, ``frame_ms_p95``'s arithmetic,
kept as a per-layer reading in the view cells whose frame tail spreads
too widely from run to run for a bound.  Moves ``samples_px_per_s``."""

from rtbench import stats


def read(ctx):
    frames = ctx.counts.get("frame_s")
    if not frames:
        return None
    return stats.p95(frames) * 1e3
