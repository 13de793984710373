"""The port's own spans (``raytracercore_tpu_torch.core.spans``) beside the
device trace: where the host was while the device idled.

* :func:`profiled` hands the per-layer metric readers the spans the port
  kept over the profiled stretch of a ``--trace 1`` run (the port keeps
  them while a profiler records); :func:`median_us` reads one span's
  median host time from them.
* :class:`SpanProfile` is :class:`rtbench.devtrace.Profile` with the
  port's recorder on over the stretch, anchored to the profiler's clock
  at its start (after a first range that warms the profiler) and end; it
  keeps the device's idle gaps as intervals, the spans on the profiler's
  clock, and the share of the profiler's
  ``cudaGraphLaunch`` calls that fall inside a mapped ``graph.replay``.
  Every number :class:`~rtbench.devtrace.Profile` gives it computes by
  that class's own code.  ``python3 -m rtbench.tools.idle_split`` runs a
  cell with it.
* :func:`idle_split` files each part of each idle gap under the
  innermost span the host was in (a gap that runs across several spans
  is split between them); :func:`idle_under` sums the idle that overlaps
  one span's intervals.

Times are the profiler's microseconds, idle is returned in seconds.
"""

from __future__ import annotations

import bisect
import statistics

from rtbench.devtrace import SPAN_PREFIX, Profile

OUTSIDE = "outside every span"


def profiled():
    """The port's span records ``(name, start_ns, end_ns, parent, top)``
    of its last profiled stretch; None where it kept none or has no
    spans."""
    try:
        from raytracercore_tpu_torch.core import spans
    except ImportError:
        return None
    return spans.profiled() or None


def median_us(records, name: str, under: str):
    """The median duration in µs of the spans ``name`` whose outermost
    span is ``under``; None where there is none."""
    if not records:
        return None
    times = [(t1 - t0) / 1e3 for n, t0, t1, _, top in records
             if n == name and records[top][0] == under]
    return statistics.median(times) if times else None


def idle_gaps(intervals):
    """The gaps ``(start, end)`` between the union of ``intervals``, as
    :meth:`rtbench.devtrace.Profile._reduce` finds them."""
    gaps, end = [], None
    for start, stop in sorted(intervals):
        if end is not None and start > end:
            gaps.append((end, start))
        end = stop if end is None else max(end, stop)
    return gaps


def _depths(spans):
    depth = []
    for _, _, _, parent, _ in spans:
        depth.append(0 if parent is None else depth[parent] + 1)
    return depth


def idle_split(gaps, spans, ranges) -> dict:
    """``{name: idle seconds}``: every part of every gap ``(start, end)``
    under the innermost of the program's ``spans`` ``(name, start, end,
    parent, top)`` it lies in, else under the benchmark's ``ranges``
    ``(start, end, name)`` it lies in, else under "outside every span".
    The parts add up to the gaps."""
    marks = [(s0, s1, (1 + d, s0), name)
             for (name, s0, s1, _, _), d in zip(spans, _depths(spans))]
    marks += [(r0, r1, (0, r0), name) for r0, r1, name in ranges]
    marks.sort()
    out, active, i = {}, [], 0
    for g0, g1 in sorted(gaps):
        while i < len(marks) and marks[i][0] < g1:
            active.append(marks[i])
            i += 1
        active = [m for m in active if m[1] > g0]
        cuts = sorted({g0, g1} | {t for m in active for t in m[:2]
                                  if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            cover = [m for m in active if m[0] <= mid < m[1]]
            name = max(cover, key=lambda m: m[2])[3] if cover else OUTSIDE
            out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def idle_under(gaps, spans, name: str) -> float:
    """The idle seconds of ``gaps`` that overlap the intervals of the
    spans named ``name`` (their children's time included)."""
    merged = []
    for s0, s1 in sorted((s[1], s[2]) for s in spans if s[0] == name):
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s1)
        else:
            merged.append([s0, s1])
    total, j = 0.0, 0
    for g0, g1 in sorted(gaps):
        while j < len(merged) and merged[j][1] <= g0:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < g1:
            total += min(g1, merged[k][1]) - max(g0, merged[k][0])
            k += 1
    return total * 1e-6


class SpanProfile(Profile):
    """:class:`rtbench.devtrace.Profile` with the port's span recorder on
    over the stretch.  After :meth:`stop`: :attr:`gap_intervals` (the
    device's idle gaps), :attr:`spans` (the port's spans on the
    profiler's clock), :attr:`ranges` (the benchmark's), the
    :attr:`anchors` ``(t0_ns, t1_ns)``, the map's
    :attr:`anchor_width_us` and :attr:`drift_us`, and
    :attr:`launches_inside` (the share of ``cudaGraphLaunch`` calls
    inside a ``graph.replay`` span; None where there was none)."""

    def start(self, spans):
        from raytracercore_tpu_torch.core import spans as recorder

        super().start(spans)
        self._recorder = recorder
        recorder.start()
        recorder.anchor()  # the profiler's first range costs more
        self.anchors = [recorder.anchor()]

    def stop(self):
        self.anchors.append(self._recorder.anchor())
        self._records = self._recorder.stop()
        super().stop()

    def _reduce(self, events):
        from torch.autograd import DeviceType

        super()._reduce(events)
        device, marks, launches = [], [], []
        self.ranges = []
        for e in events:
            t = (e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    device.append(t)
            elif e.name == self._recorder.ANCHOR:
                marks.append(t)
            elif e.name.startswith(SPAN_PREFIX):
                self.ranges.append((*t, e.name[len(SPAN_PREFIX):]))
            elif e.name.startswith("cudaGraphLaunch"):
                launches.append(t[0])
        self.gap_intervals = idle_gaps(device)
        offset, self.anchor_width_us, self.drift_us = (
            self._recorder.clock_offset(
                self.anchors, sorted(marks)[-len(self.anchors):]))
        self.spans = self._recorder.on_profiler_clock(self._records, offset)
        replays = sorted((s[1], s[2]) for s in self.spans
                         if s[0] == "graph.replay")
        starts = [r0 for r0, _ in replays]
        inside = 0
        for t in launches:
            i = bisect.bisect_right(starts, t) - 1
            inside += i >= 0 and t <= replays[i][1]
        self.launches_inside = inside / len(launches) if launches else None

    def idle_split(self) -> dict:
        return idle_split(self.gap_intervals, self.spans, self.ranges)

    def idle_under(self, name: str) -> float:
        return idle_under(self.gap_intervals, self.spans, name)
