"""A profiled stretch of a run, read from ``torch.profiler``'s device
trace: the union of device activity, each kernel's device time by name,
and the device's idle gaps by the benchmark span the host was in.

The busy arithmetic is a copy of ``chip_smoke.py`` ``device_busy``
(commit 25c2873): the union of the device events' intervals (kernels,
copies, fills; not the user ranges that also show on the device
timeline), over the host-clock length of the stretch, which starts and
ends at a synchronize.
"""

from __future__ import annotations

import time

import torch

SPAN_PREFIX = "rtbench."


class Profile:
    """Profile the calls between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self.busy_s = None
        self.window_s = None
        self.kernels = {}   # name -> [seconds, launches]
        self.gaps = {}      # host span -> idle seconds
        self._prof = None

    def start(self, spans):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        _sync()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        spans.annotate = True
        self._spans = spans
        self._t0 = time.perf_counter()

    def stop(self):
        _sync()
        self.window_s = time.perf_counter() - self._t0
        self._spans.annotate = False
        self._prof.__exit__(None, None, None)
        self._reduce(self._prof.events())
        self._prof = None

    def _reduce(self, events):
        from torch.autograd import DeviceType

        device, ranges = [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    device.append(e)
            elif e.name.startswith(SPAN_PREFIX):
                ranges.append((e.time_range.start, e.time_range.end,
                               e.name[len(SPAN_PREFIX):]))
        intervals = sorted((e.time_range.start, e.time_range.end)
                           for e in device)
        busy_us, end, gaps = 0.0, None, []
        for start, stop in intervals:
            if end is not None and start > end:
                gaps.append((end, start))
            busy_us += max(0.0, stop - max(start, end if end is not None
                                           else start))
            end = stop if end is None else max(end, stop)
        self.busy_s = busy_us * 1e-6
        for e in device:
            k = self.kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us() * 1e-6
            k[1] += 1
        ranges.sort()
        for g0, g1 in gaps:
            where = "outside every span"
            for r0, r1, name in ranges:
                if r0 <= g0 < r1:
                    where = name
                if r0 > g0:
                    break
            self.gaps[where] = self.gaps.get(where, 0.0) + (g1 - g0) * 1e-6

    def kernel(self, part: str):
        """``(seconds, launches)`` of the kernels whose name contains
        ``part``; ``(0.0, 0)`` where none ran."""
        s, n = 0.0, 0
        for name, (sec, count) in self.kernels.items():
            if part in name:
                s += sec
                n += count
        return s, n

    def breakdown(self):
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:160], sec] for name, (sec, _) in top],
                "idle_gaps": [[name, sec] for name, sec in gaps]}


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
