"""CUDA graphs of the main path: the counterpart of ``jax.jit`` around the
JAX package's render pass and train step.

A body (one render pass, one train step's forward and backward) runs once
eagerly on a side stream — the warm-up, which builds the kernel library,
packs the scene's tables and sets every kernel's one-off launch
attributes — then is captured once with ``torch.cuda.graph`` in its
default (global) capture mode and replayed.  The replay reads its inputs
from the static buffers it was captured on, so a call copies its inputs
into them (:meth:`Captured.feed`) and replays; a random stream keyed per
call comes from a ``torch.Generator`` registered with the graph (seeded
before each replay) or from a key tensor filled before it.

What ``jit`` makes static is the cache key of the callers'
:class:`GraphCache`: the route, the shapes, the dtype, the recursion, the
tile, the compensation and, for a step, the recorder route.

Rules a captured body keeps: no read of the device from the host, no copy
from host memory, every launch on the current stream; no profiler
records while a graph is captured, and no other thread does CUDA work.
A capture that fails raises :class:`GraphCaptureError`, naming the body
and the operation that failed; nothing gives way to the eager body.

Kernel launches (``kernels.count_launch``) made while a graph is
captured run nothing: they are kept in the graph's tally
(:attr:`Captured.launches`) and added to each wrapper's count at every
replay, so a wrapper's ``launches`` counts kernels that ran.

A feed and a replay are the spans ``graph.feed`` and ``graph.replay``
(:mod:`.spans`), inside the caller's pass or step.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import os
import re
import time
import traceback
import warnings
from typing import Callable

import torch

from .. import kernels
from .spans import span

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A kernel node in the DOT text of ``cudaGraphDebugDotPrint``: its
# (mangled) function name follows the node's ID.
_KERNEL_NODE = re.compile(
    r"\{KERNEL\s*\|\s*\{ID \| \d+ \(topoId: \d+\) \| ([^\\|}]+)")


class GraphCaptureError(RuntimeError):
    """A CUDA graph could not be captured; the message names the body and
    the operation that failed."""


def capturing(device) -> bool:
    """True while the current stream of ``device`` is being captured into
    a CUDA graph (never off a CUDA device)."""
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _failing_op(exc: BaseException) -> str:
    """``file:line function`` of the innermost frame of this package in
    ``exc``'s traceback (or of the innermost frame at all), following the
    chain of exceptions it was raised during."""
    frames = []
    while exc is not None:
        frames = traceback.extract_tb(exc.__traceback__) + frames
        exc = exc.__context__
    ours = [f for f in frames
            if os.path.abspath(f.filename).startswith(PKG_DIR)
            and not os.path.abspath(f.filename).startswith(
                os.path.abspath(__file__))]
    if not (ours or frames):
        return "unknown operation"
    f = (ours or frames)[-1]
    return (f"{os.path.relpath(f.filename, os.path.dirname(PKG_DIR))}:"
            f"{f.lineno} {f.name}: {f.line}")


@dataclasses.dataclass
class Captured:
    """One captured graph: ``graph`` replays the body on the static
    ``inputs``; ``outputs`` is what the body returned while captured
    (overwritten by each replay); ``launches`` ``{wrapper: n}`` the kernel
    launches a replay makes; ``capture_ms`` the host time of the capture
    (warm-up excluded); ``pool_bytes`` the device memory the capture
    reserved (the graph's private pool); ``replays`` counts replays."""

    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    outputs: object
    launches: dict
    capture_ms: float
    pool_bytes: int
    label: str
    replays: int = 0

    def feed(self, *values) -> None:
        """Copy ``values`` into the static inputs, in order; a value that
        already is its static buffer is left alone."""
        if len(values) != len(self.inputs):
            raise ValueError(f"{self.label}: {len(values)} inputs fed, the "
                             f"graph takes {len(self.inputs)}")
        with span("graph.feed"):
            for static, value in zip(self.inputs, values):
                if value.data_ptr() != static.data_ptr():
                    static.copy_(value)

    def replay(self) -> None:
        """Launch the graph once on the current stream."""
        with span("graph.replay"):
            self.graph.replay()
        self.replays += 1
        for wrapper, n in self.launches.items():
            wrapper.launches += n

    def kernel_nodes(self, path: str) -> collections.Counter:
        """The graph's kernel nodes, counted by (mangled) function name,
        from the DOT dump of the captured graph written to ``path``."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.graph.debug_dump(path)
        with open(path) as f:
            return collections.Counter(
                name.strip() for name in _KERNEL_NODE.findall(f.read()))


def capture(fn: Callable, inputs: tuple, *, label: str, warmup=None,
            generators=()) -> Captured:
    """Capture ``fn(*inputs)`` as a CUDA graph.

    ``fn`` first runs eagerly on a side stream on ``warmup`` (a tuple like
    ``inputs``; default ``inputs``), so that every one-off of its first
    call happens outside the capture; a body that updates its inputs in
    place gets scratch copies there.  Then it is captured on ``inputs``,
    whose tensors become the graph's static buffers.  ``generators``: the
    ``torch.Generator`` s the body draws from, registered with the graph
    (seed one before a replay to key its draws).

    Raises :class:`GraphCaptureError` when a profiler is recording or
    when the warm-up or the capture fails."""
    device = inputs[0].device
    if torch.autograd._profiler_enabled():
        raise GraphCaptureError(
            f"{label}: a profiler is recording; capture the graph (run the "
            "first pass or step) before profiling, or profile the eager "
            "body")
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            fn(*(inputs if warmup is None else warmup))
    except Exception as exc:
        raise GraphCaptureError(
            f"{label}: the warm-up before the capture failed at "
            f"{_failing_op(exc)}: {type(exc).__name__}: {exc}") from exc
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    for gen in generators:
        graph.register_generator_state(gen)
    tally: dict = {}
    t0 = time.perf_counter()
    kernels._capture_tally[0] = tally
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph):
            outputs = fn(*inputs)
    except Exception as exc:
        raise GraphCaptureError(
            f"{label}: capture failed at {_failing_op(exc)}: "
            f"{type(exc).__name__}: {exc}") from exc
    finally:
        kernels._capture_tally[0] = None
    try:
        graph.instantiate()
    except Exception as exc:
        raise GraphCaptureError(f"{label}: the captured graph did not "
                                f"instantiate: {exc}") from exc
    torch.cuda.synchronize(device)
    return Captured(graph=graph, inputs=tuple(inputs), outputs=outputs,
                    launches=tally,
                    capture_ms=(time.perf_counter() - t0) * 1e3,
                    pool_bytes=torch.cuda.memory_reserved(device) - reserved,
                    label=label)


class GraphCache:
    """The counterpart of ``jit``'s cache: one captured entry per key, the
    ``size`` most recently used kept (an evicted entry frees its graph's
    pool).  ``captures`` counts the entries made."""

    def __init__(self, size: int = 1):
        self.size = size
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.captures = 0

    def get(self, key, make: Callable):
        """The entry of ``key``, made by ``make()`` on a miss."""
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
            return entry
        while len(self.entries) >= self.size:
            self.entries.popitem(last=False)
        entry = make()
        self.entries[key] = entry
        self.captures += 1
        return entry

    def clear(self) -> None:
        self.entries.clear()
