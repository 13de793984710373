"""Readings that the limits of ``rtbench/limits/<workload>.json`` are set
from, at a cell's own size, on the card: the control (the reference put in
the program's place, computed in bfloat16, the precision below the
configuration's float32) and, for a fit cell, planted faults.

    python3 -m rtbench.tools.control --workload cornell-view \
        --seeds 11 12 13 --passes 15200
    python3 -m rtbench.tools.control --workload cornell-fit \
        --seeds 11 12 13 --kind control half altered

Prints one JSON line a seed and kind: the numbers the cell's loop
compares, the control's (or the fault's) against the float32 reference.
A view cell compares ``--passes`` passes (about what a window reaches),
its image after half of them.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent.parent


def view_reading(cell, seed, passes, device, got_dtype=torch.bfloat16):
    from rtbench import scenes
    from rtbench.reference import view as ref_view

    loop = _loop(cell)
    inputs = scenes.make(cell.config)
    w, h = cell.config["size"]
    pix = np.sort(np.random.default_rng([seed, 1]).choice(
        h * w, size=min(int(cell.traffic["check_pixels"]), h * w),
        replace=False))
    k = int(cell.traffic["passes_per_frame"])
    snap = max(k, (passes // 2) // k * k)
    want = ref_view.film_at(inputs.tables, inputs.camera, seed, pix, passes,
                            snap, device)
    got = ref_view.film_at(inputs.tables, inputs.camera, seed, pix, passes,
                           snap, device, dtype=got_dtype)
    return loop.compare(got, got["image"], want)


def fit_reading(cell, seed, kind, device):
    from rtbench import scenes
    from rtbench.reference import fit as ref_fit
    from rtbench.reference.tracer import pass_seed

    loop = _loop(cell)
    inputs = scenes.make(cell.config)
    w, h = cell.config["size"]
    mix = cell.traffic
    target = loop.make_target(seed, h, w, device)
    seeds = [pass_seed(loop.job_seed(seed, 0), i)
             for i in range(int(mix["setup_steps"]))]
    lr = float(mix["lr"])
    want = ref_fit.steps(inputs.tables, inputs.camera, target, seeds, lr,
                         device)
    if kind == "control":
        got = ref_fit.steps(inputs.tables, inputs.camera, target, seeds, lr,
                            device, dtype=torch.bfloat16)
    else:
        got = ref_fit.steps(inputs.tables, inputs.camera, target, seeds, lr,
                            device, fault=kind)
    got = {"losses": got["losses"],
           "grads": {f: g.float() for f, g in got["grads"].items()},
           "params": {f: p.float() for f, p in got["params"].items()},
           "start": {f: p.float() for f, p in got["start"].items()}}
    return loop.compare(got, want)


def _loop(cell):
    from rtbench.run import load_module
    return load_module(cell.loop_path)


def main(argv=None):
    from rtbench.run import Cell

    p = argparse.ArgumentParser(prog="python3 -m rtbench.tools.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--passes", type=int, default=0)
    p.add_argument("--kind", nargs="+", default=["control"],
                   choices=("control", "half", "altered"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(ROOT, args.workload)
    dev = torch.device("cuda:0")
    for seed in args.seeds:
        for kind in args.kind:
            if cell.traffic["loop"] == "view":
                if kind != "control":
                    continue
                nums = view_reading(cell, seed, args.passes, dev)
            else:
                nums = fit_reading(cell, seed, kind, dev)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "numbers": nums}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
