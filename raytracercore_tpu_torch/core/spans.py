"""The port's spans: named host intervals at the layer boundaries of a
viewer frame and a train step, and the phases of an eager pass.

Where they are (each a ``with span(name)``):

* ``render.step`` (``Renderer.step``, whole): ``graph.feed``, one
  ``graph.replay`` a pass and ``render.sync`` (the closing synchronize);
  on the eager path ``trace_pass`` for a pass of the megakernel's
  whole-pass form, else the phases ``camera_rays``, ``trace_fused`` or
  ``closest_hit`` (one a bounce) and ``film_accum``, the JAX package's
  profiler scope names;
* ``render.image`` (``Renderer.image``, whole): ``film.tonemap`` and
  ``film.to_host``.  On a film of CUDA float32 planes ``film.tonemap`` is
  one launch of the tonemap kernel, which stores the image into pinned
  host memory, and ``film.to_host`` the synchronize of the stream; on
  every other film ``film.tonemap`` is the chain ``Film.to_uint8`` and
  ``film.to_host`` its copy to the host;
* ``train.step`` (``make_train_step``'s step, whole): ``graph.feed``,
  ``train.seed``, ``graph.replay``, ``train.optimizer`` (the gradients
  re-pointed and ``optimizer.step()``) and ``train.loss`` (the output's
  copy); on the eager path ``train.optimizer``.

``graph.feed`` and ``graph.replay`` sit in :class:`.graphs.Captured`, so
passes and steps share them.  A span's self time is its duration less
its children's.

:func:`span` does one of three things:

* **The recorder is on** (:func:`start` … :func:`stop`): the span is kept
  in memory as ``(name, start_ns, end_ns, parent, top)`` on the clock of
  ``time.perf_counter_ns``; ``parent`` is the index of the enclosing span
  (None for an outermost one), ``top`` the index of the outermost span
  around it (its own for an outermost one), so all spans of one frame
  part or one step share it.  No profiler range is opened; nothing is
  written out.  :func:`anchor` maps this clock onto a profiler's.
* **A profiler is recording** (``torch.profiler``) and the recorder is
  off: the span is kept as above in the records of that profiled stretch
  (:func:`profiled`), which start at the first span while the profiler
  records and end at the first span after it stopped (two profiles with
  no span between them make one stretch).  No profiler range is opened
  either: under a profiler that traces an H100, a range costs 12-16 µs
  of host time, and where the host bounds the step it moves the device's
  idle share.  :meth:`..render.renderer.Renderer.profile` writes its
  spans into its trace.
* **Otherwise** nothing: a shared context that does nothing, after one
  read of this module's recorder and one of the profiler's flag.

One thread; spans nest as ``with`` blocks do.
"""

from __future__ import annotations

import time

import torch
import torch.autograd.profiler as _profiler

ANCHOR = "rtc.anchor"


class _Null:
    """The off path's context, one for every span: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _Null()
_rec = None    # the running _Recorder, or None
_last = []     # the records of the last profiled stretch


class _Recorder:
    def __init__(self, profiled: bool):
        self.records = []   # [name, start_ns, end_ns, parent, top]
        self.stack = []     # indices of the open spans, innermost last
        self.profiled = profiled

    def done(self) -> list:
        """The closed spans' records, as tuples."""
        return [tuple(r) for r in self.records if r[2] is not None]


class _Span:
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec.stack
        self.index = len(rec.records)
        rec.records.append([self.name, time.perf_counter_ns(), None,
                            stack[-1] if stack else None,
                            stack[0] if stack else self.index])
        stack.append(self.index)

    def __exit__(self, exc_type, exc, tb):
        self.rec.records[self.index][2] = time.perf_counter_ns()
        self.rec.stack.pop()
        return False


def span(name: str):
    """The context of the span ``name`` (see the module's doc)."""
    rec = _rec
    if rec is None:
        if not _profiler._is_profiler_enabled:
            return _NULL
        rec = _begin(profiled=True)
    elif rec.profiled and not _profiler._is_profiler_enabled:
        _end()
        return _NULL
    return _Span(rec, name)


def _begin(profiled: bool) -> _Recorder:
    global _rec
    if _rec is not None:
        _end()
    _rec = _Recorder(profiled)
    return _rec


def _end() -> list:
    global _rec, _last
    records = _rec.done()
    if _rec.profiled:
        _last = records
    _rec = None
    return records


def start() -> None:
    """Turn the recorder on (ending a profiled stretch's records)."""
    if _rec is not None and not _rec.profiled:
        raise RuntimeError("spans: the recorder is already on")
    _begin(profiled=False)


def stop() -> list:
    """Turn the recorder off; returns its records, in the order the spans
    opened: ``(name, start_ns, end_ns, parent, top)``."""
    if _rec is None or _rec.profiled:
        raise RuntimeError("spans: the recorder is not on")
    return _end()


def profiled() -> list:
    """The records of the running, else of the last, profiled stretch."""
    if _rec is not None and _rec.profiled:
        return _rec.done()
    return list(_last)


def anchor() -> tuple:
    """``(t0_ns, t1_ns)``: two reads of the recorder's clock around a
    profiler range named ``rtc.anchor``, whose middle maps onto the
    middle of the pair to within half its width (:func:`clock_offset`)."""
    t0 = time.perf_counter_ns()
    with torch.profiler.record_function(ANCHOR):
        pass
    return t0, time.perf_counter_ns()


def clock_offset(anchors, events) -> tuple:
    """``(offset_us, width_us, drift_us)`` of the recorder's clock against
    a profiler's: ``anchors`` as :func:`anchor` returned them and
    ``events`` the ``(start_us, end_us)`` of the profiler's ``rtc.anchor``
    ranges, in the same order.  A recorder time ``t_ns`` is ``t_ns / 1e3
    + offset_us`` on the profiler's clock, by the middles of the narrowest
    pair (a profiler's first range costs more), whose width is
    ``width_us``; ``drift_us`` is the last pair's offset less the
    first's."""
    if len(anchors) != len(events) or not anchors:
        raise ValueError(f"spans: {len(anchors)} anchors against "
                         f"{len(events)} profiler anchor ranges")
    offsets = [(e0 + e1) / 2 - (t0 + t1) / 2e3
               for (t0, t1), (e0, e1) in zip(anchors, events)]
    widths = [(t1 - t0) / 1e3 for t0, t1 in anchors]
    i = widths.index(min(widths))
    return offsets[i], widths[i], offsets[-1] - offsets[0]


def on_profiler_clock(records, offset_us: float) -> list:
    """``records`` with their times in the profiler's microseconds:
    ``(name, start_us, end_us, parent, top)``."""
    return [(name, t0 / 1e3 + offset_us, t1 / 1e3 + offset_us, parent, top)
            for name, t0, t1, parent, top in records]
