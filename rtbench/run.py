"""Run one cell of the benchmark once and print its result line.

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's entry in ``BENCHMARK.json``
names its configuration (``rtbench/configs/<config>.json``) and traffic
mix (``rtbench/traffic/<mix>.json``); the mix names its loop
(``rtbench/loops/<loop>.py``); each per-layer metric is read by
``rtbench/metrics/<metric>.py``; the limits of the numbers ``correct`` is
decided on are in ``rtbench/limits/<workload>.json``.

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read from a profiled
stretch of the window.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checked``: each compared
number with its limit); the compared numbers are also the last lines of
standard error.  No CUDA card, fewer cards than the cell asks for, or a
JAX module loaded: a message on standard error, no result, exit code 2.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "raytracercore_tpu")


def _age_at_start() -> float:
    """Seconds from this process's start (the kernel's record of it,
    against the uptime clock, to 10 ms) to ``_T_START``."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return max(age - (time.perf_counter() - _T_START), 0.0)


_BEFORE_START = _age_at_start()


def since_process_start() -> float:
    """Seconds since this process started."""
    return _BEFORE_START + time.perf_counter() - _T_START


def banned_modules():
    """The loaded modules whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's, compared whole."""
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(BANNED))


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "rtbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A cell's files, found by the names ``BENCHMARK.json`` gives."""

    def __init__(self, root: Path, workload: str):
        self.bench = read_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        base = root / "rtbench"
        self.config = read_json(
            base / "configs" / f"{self.workload['config']}.json")
        self.traffic = read_json(
            base / "traffic" / f"{self.workload['traffic']}.json")
        self.loop_path = base / "loops" / f"{self.traffic['loop']}.py"
        self.limits = read_json(base / "limits" / f"{workload}.json")
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.metric_paths = {m["name"]: base / "metrics" / f"{m['name']}.py"
                             for m in self.per_layer}


class Context:
    """What a loop and the metric readers share for one run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device):
        import torch

        from .spans import Spans

        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds = seed, seconds
        self.device = torch.device(device)
        self.spans = Spans()
        self.counts = {}
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.profile = None
        if trace:
            from .devtrace import Profile
            self.profile = Profile()
        self._profiling = False
        self.paused_s = 0.0  # the profiler's own start and stop

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def end_setup(self):
        self.setup_s = since_process_start()
        self.note(f"set-up {self.setup_s:.3f} s")

    def note(self, what: str):
        """A line on standard error, with the seconds since the process
        started."""
        print(f"rtbench [{since_process_start():8.3f} s] {what}",
              file=sys.stderr, flush=True)

    def profile_frame(self, index):
        """Start the profiled stretch before frame (or step) ``index`` =
        the mix's ``trace_after``; stop it ``trace_count`` later, or at
        ``None`` (the window's end).  The seconds the profiler takes to
        start and stop go to :attr:`paused_s`, which the window's deadline
        leaves out."""
        after = int(self.traffic["trace_after"])
        count = int(self.traffic["trace_count"])
        t0 = time.perf_counter()
        if index is not None and index == after and not self._profiling:
            self.profile.start(self.spans)
            self._profiling = True
        elif self._profiling and (index is None or index == after + count):
            self.profile.stop()
            self._profiling = False
        else:
            return
        self.paused_s += time.perf_counter() - t0

    def read_memory_peak(self):
        import torch
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))

    def free(self):
        import gc

        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device):
    """Run the cell and decide ``correct``: the result line's dict, with
    the end-to-end metrics, or with ``trace`` the per-layer ones."""
    import torch

    cell = Cell(root, workload)
    ctx = Context(cell, seed, seconds, trace, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx.note(f"{workload}: seed {seed}, {seconds} s, trace {int(trace)}")
    out = load_module(cell.loop_path).run(ctx)
    ctx.note("checked")
    checked = {}
    correct = True
    for name, limit in cell.limits.items():
        value = out["numbers"][name]
        checked[name] = {"value": value, "limit": limit}
        correct = correct and value <= limit
    correct = correct and out["failed"] == 0
    units = {m["name"]: m["unit"] for m in
             cell.bench["end_to_end"] + cell.bench["per_layer"]}
    metrics = {}
    if trace:
        for name, path in cell.metric_paths.items():
            value = load_module(path).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        values = dict(out["end_to_end"], setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(ctx)}
    if trace:
        result["device"]["busy_s"] = ctx.profile.busy_s
        result["device"]["window_s"] = ctx.profile.window_s
        result["breakdown"] = ctx.profile.breakdown()
    result["checked"] = checked
    return result


def device_info(ctx):
    import torch
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(ctx.device),
            "count": 1, "memory_peak_bytes": ctx.memory_peak_bytes}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m rtbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = Cell(ROOT, args.workload)
    import torch

    found = banned_modules()
    if found:
        print(f"rtbench: the process holds {', '.join(found)} at start: "
              "refused", file=sys.stderr)
        return 2

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: the cell {args.workload} needs {chips} CUDA "
              "card(s); none usable here", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    # The seed keys numpy's SeedSequence, which takes no negative number.
    seed = args.seed % (1 << 64)
    result = run_cell(ROOT, args.workload, seed, args.seconds,
                      bool(args.trace), "cuda:0")
    found = banned_modules()
    if found:
        print(f"rtbench: the process holds {', '.join(found)}: refused",
              file=sys.stderr)
        return 2
    for name, c in result["checked"].items():
        print(f"rtbench check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
