"""Where the device's idle time goes in a cell's traced stretch, by the
port's own spans, on the card.

    python3 -m rtbench.tools.idle_split --workload cornell-fit \
        --seeds 11 12 --seconds 5

Runs the cell's loop as a ``--trace 1`` run does, with
:class:`rtbench.spantrace.SpanProfile` in the place of the profile (the
port's span recorder on over the stretch, anchored to the profiler's
clock), and prints one JSON line a seed, every time a frame (``view``;
a ``render.step``) or a step (``fit``; a ``train.step``) of the stretch:

* ``idle_split_ms``: each part of each idle gap under the innermost span
  the host was in (the benchmark's span name where it was in none);
  ``split_minus_gaps_us``, what the split adds up to less the gaps;
* ``idle_under_ms``: the idle overlapping each span's intervals;
* ``host_us``: each span's total and self host time (the duration less
  its children's), and ``median_us`` its median duration;
* the mapping check: ``launches_inside``, the share of the profiler's
  ``cudaGraphLaunch`` calls inside a mapped ``graph.replay``; the anchor
  pair's width and the drift between the start and end anchors;
* ``window_ms``, ``device_idle`` and the breakdown, as ``--trace 1``.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent.parent
NAMES = ("render.step", "render.image", "render.sync", "graph.feed",
         "graph.replay", "film.tonemap", "film.to_host", "train.step",
         "train.seed", "train.optimizer", "train.loss")


def summary(p, unit: str) -> dict:
    """The numbers above from a stopped :class:`SpanProfile` ``p``, per
    span ``unit`` (``render.step`` or ``train.step``)."""
    n = sum(s[0] == unit for s in p.spans)
    total, own, durations = {}, {}, {}
    children = [0.0] * len(p.spans)
    for name, t0, t1, parent, _ in p.spans:
        if parent is not None:
            children[parent] += t1 - t0
    for (name, t0, t1, _, _), kids in zip(p.spans, children):
        total[name] = total.get(name, 0.0) + (t1 - t0)
        own[name] = own.get(name, 0.0) + (t1 - t0 - kids)
        durations.setdefault(name, []).append(t1 - t0)
    idle = sum(g1 - g0 for g0, g1 in p.gap_intervals) * 1e-6
    split = p.idle_split()
    return {
        "count": n,
        "window_ms": p.window_s * 1e3 / n,
        "device_idle": 100.0 * (1.0 - p.busy_s / p.window_s),
        "idle_ms": idle * 1e3 / n,
        "gaps": len(p.gap_intervals),
        "idle_split_ms": {k: v * 1e3 / n for k, v in sorted(
            split.items(), key=lambda kv: -kv[1])},
        "split_minus_gaps_us": (sum(split.values()) - idle) * 1e6,
        "idle_under_ms": {k: p.idle_under(k) * 1e3 / n for k in NAMES
                          if k in total},
        "host_us": {k: [total[k] / n, own[k] / n] for k in total},
        "median_us": {k: statistics.median(v) for k, v in durations.items()},
        "launches_inside": p.launches_inside,
        "anchor_width_us": p.anchor_width_us,
        "anchor_widths_us": [(t1 - t0) / 1e3 for t0, t1 in p.anchors],
        "drift_us": p.drift_us,
        "breakdown": p.breakdown(),
    }


def main(argv=None):
    from rtbench.run import Cell, Context, load_module
    from rtbench.spantrace import SpanProfile

    ap = argparse.ArgumentParser(prog="python3 -m rtbench.tools.idle_split")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("idle_split: needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(ROOT, args.workload)
    unit = ("train.step" if cell.traffic["loop"] == "fit"
            else "render.step")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        ctx = Context(cell, seed % (1 << 64), args.seconds, True, "cuda:0")
        ctx.profile = SpanProfile()
        out = load_module(cell.loop_path).run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": torch.cuda.get_device_name(0),
                          "numbers": out["numbers"],
                          **summary(ctx.profile, unit)}), flush=True)
        del ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
