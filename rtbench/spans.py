"""The benchmark's own spans: host-clock intervals kept in memory, named
by the call into the program they time."""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self):
        self.items = []   # (name, start, end), perf_counter seconds
        self.annotate = False  # also open a profiler range of the name

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = None
        if self.annotate:
            import torch
            rng = torch.profiler.record_function("rtbench." + name)
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rng is not None:
                rng.__exit__(None, None, None)
            self.items.append((name, t0, t1))

    def durations(self, name: str):
        return [t1 - t0 for n, t0, t1 in self.items if n == name]
