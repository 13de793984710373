"""Progressive renderer — the orchestration layer (counterpart of
``raytracercore_tpu.render.renderer``).

Replaces the reference's ``FullRaytracer`` (Raytracing/FullRaytracer.cs):
one full-frame render pass per sample, the whole image traced at once — by
the megakernel in one launch for scenes it takes, else by the integrator's
bounce loop with one closest-hit kernel launch per bounce (the select
kernel up to 768 table rows, the BVH traversal kernel above).  Progressive
refinement = calling ``step``
repeatedly; every pass adds +1 sample/pixel, like the reference's
wraparound tile loop (Raytracer.cs:302-327).

On a CUDA device a float32, uncompensated, untiled pass takes a whole form
after the pass's two draws (:func:`pass_form` decides, and its docstring
is the table): on the megakernel route one launch of
:func:`.fused.trace_pass` (camera rays, uniform channels and film add
inside the kernel); on the bounce loop's route hand-written launches only
(:func:`.integrator.trace_pass`: the camera kernel, then each bounce's
closest hit and shading kernel, which computes the uniform channels,
renormalizes and at the last bounce adds into the film).  Every other pass
runs the chain of camera rays, uniform channels, tracer and film add
(:func:`render_pass_`), which is the plain version of both.  The graphed
and the eager pass run the same body (:func:`_pass_body`).

Randomness: pass ``k`` draws its camera jitter and its path uniforms from a
``torch.Generator`` on the render device seeded from ``(seed, k)``, so a run
gives the same film however it is chunked into ``step`` calls.  The
numbers are the device generator's (Philox on CUDA, Mersenne Twister on
the CPU), not the JAX package's threefry stream.

On a CUDA device a pass is captured once as a CUDA graph and replayed
(:class:`PassGraph`, the counterpart of the JAX package's ``jax.jit``
pass): one generator per graph, registered with it and seeded with
:func:`pass_seed` before each replay, draws the same numbers as the eager
pass, and the graph accumulates into its own film in place
(:meth:`.film.Film.add_full_frame_`), so a graphed film equals the eager
one bit for bit.

A step and an image are spans (:mod:`..core.spans`): ``render.step``
holds ``graph.feed``, one ``graph.replay`` a pass and ``render.sync``, or
on the eager path the phases under the JAX package's profiler scope names
(``camera_rays``, ``trace_fused``, ``film_accum``; ``closest_hit`` on
every bounce of ``trace``; ``trace_pass`` for the megakernel's whole
form; ``camera_rays`` and a ``closest_hit`` a bounce for the bounce loop's
whole form);
``render.image`` holds ``film.tonemap`` (on a CUDA float32 film one
launch of the tonemap kernel into pinned host memory, else the chain
``Film.to_uint8``) and ``film.to_host`` (the stream's synchronize, or the
chain's copy).  A replay runs no Python, so nothing inside a graph is
a span.  :meth:`Renderer.profile` writes a trace of what ``step`` runs,
with these spans in it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import SELECT_MAX_PRIMS
from ..bvh.builder import build_bvh
from ..core import graphs as graphs_mod
from ..core import spans
from ..core.device import resolve_device
from ..intersect.cuda_select import closest_hit_fused
from ..intersect.dispatch import (closest_hit, make_bvh_closest_fn,
                                  n_table_rows)
from ..scene.types import (CameraRT, HostScene, SceneArrays, freeze_scene,
                           init_camera)
from . import camera as cam_mod
from . import fused
from . import integrator
from . import tonemap_kernel
from .film import Film
from .integrator import preprocess_uniforms, trace


def pass_seed(seed: int, pass_index: int) -> int:
    """The generator seed of pass ``pass_index`` of a run seeded ``seed``
    (a SeedSequence mix, so neighbouring passes and seeds get unrelated
    streams; its low 32 bits alone already differ, which the CPU
    generator needs)."""
    state = np.random.SeedSequence([seed, pass_index]).generate_state(
        2, np.uint32)
    return int(state[0]) | (int(state[1]) << 32)


def render_pass(scene: SceneArrays, camera, film: Film, jitter, uniforms,
                closest_fn=closest_hit, trace_fn=None, tile: int = 0
                ) -> Film:
    """One full-frame progressive pass: +1 sample for every pixel.

    ``jitter`` [H*W, 4] are the camera uniforms (:func:`.camera.camera_rays`)
    and ``uniforms`` [recursion + 1, 7, H*W] the path uniforms
    (:func:`.integrator.preprocess_uniforms`), one row per ray.
    The rays go through :func:`.integrator.trace` with ``closest_fn``,
    unless ``trace_fn(scene, ray_o, ray_d, uniforms) → (color, miss)``
    overrides the whole integrator call — how the megakernel
    (:func:`.fused.trace_fused`) plugs in.

    ``tile``: trace the pixels in square-tile order
    (:func:`.camera.pixel_grid_tiled`; ray ``i`` takes pixel ``i`` of that
    order with row ``i`` of ``jitter`` and ``uniforms``) instead of
    row-major, and untile colour and miss before the film adds them: only
    which random numbers land on which pixel changes.  0: row-major.
    """
    return _pass(scene, camera, film, jitter, uniforms, closest_fn, trace_fn,
                 tile, Film.add_full_frame)


def render_pass_(scene: SceneArrays, camera, film: Film, jitter, uniforms,
                 closest_fn=closest_hit, trace_fn=None, tile: int = 0
                 ) -> Film:
    """:func:`render_pass` accumulating into ``film``'s own tensors
    (:meth:`.film.Film.add_full_frame_`), bit-equal to it: the body a
    :class:`PassGraph` captures.  Returns ``film``."""
    return _pass(scene, camera, film, jitter, uniforms, closest_fn, trace_fn,
                 tile, Film.add_full_frame_)


def _pass(scene, camera, film, jitter, uniforms, closest_fn, trace_fn, tile,
          accumulate):
    h, w = film.shape
    if tile:
        px, py = cam_mod.pixel_grid_tiled(w, h, tile, device=jitter.device)
    else:
        px, py = cam_mod.pixel_grid(w, h, device=jitter.device)
    color, miss = trace_pixels(scene, camera, px, py, jitter, uniforms,
                               closest_fn, trace_fn)
    with spans.span("film_accum"):
        if tile:
            color = cam_mod.untile(color, w, h, tile)
            miss = cam_mod.untile(miss, w, h, tile)
        return accumulate(film, color, miss)


def trace_pixels(scene: SceneArrays, camera, px, py, jitter, uniforms,
                 closest_fn=closest_hit, trace_fn=None):
    """``(color [R, 3], miss [R])`` of one sample through each of the
    pixels ``(px, py)`` [R]: camera rays from ``jitter`` [R, 4], then
    ``trace_fn`` or :func:`.integrator.trace` with ``closest_fn`` on
    ``uniforms`` [B, 7, R] (the body of :func:`render_pass`)."""
    with spans.span("camera_rays"):
        ray_o, ray_d = cam_mod.camera_rays(camera, px, py, jitter)
        ray_o, ray_d = ray_o.contiguous(), ray_d.contiguous()
    if trace_fn is not None:
        with spans.span("trace_fused"):
            return trace_fn(scene, ray_o, ray_d, uniforms)
    # No early exit: at full-frame batches some ray nearly always survives
    # to the recursion cap, and the test costs a host read of the device
    # per bounce.
    return trace(scene, ray_o, ray_d, None, closest_fn=closest_fn,
                 uniforms=uniforms)


def pass_generator(seed: int, k: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with :func:`pass_seed` ``(seed,
    k)``: the one pass ``k`` of a run seeded ``seed`` draws from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(pass_seed(seed, k))
    return gen


def pass_draws(seed: int, k: int, n: int, bounces: int, device,
               dtype=torch.float32):
    """The random numbers of pass ``k`` of a run seeded ``seed`` over ``n``
    pixels: ``(jitter [n, 4], uniforms [bounces, 7, n])`` in ``dtype``,
    drawn from :func:`pass_generator` (:func:`generator_draws`)."""
    return generator_draws(pass_generator(seed, k, device), n, bounces,
                           dtype)


def raw_draws(gen: torch.Generator, n: int, bounces: int):
    """``(jitter [n, 4], raw [bounces, 5, n])``, float32 ``torch.rand``
    draws from ``gen`` on its device, in that order: what a pass draws."""
    jitter = torch.rand((n, 4), generator=gen, device=gen.device)
    raw = torch.rand((bounces, 5, n), generator=gen, device=gen.device)
    return jitter, raw


def generator_draws(gen: torch.Generator, n: int, bounces: int,
                    dtype=torch.float32):
    """``(jitter [n, 4], uniforms [bounces, 7, n])`` in ``dtype``, drawn
    from ``gen`` on its device.  The generator always draws f32 uniforms
    (:func:`raw_draws`, :func:`.integrator.prepare_uniforms`' stream), so
    every ``dtype`` sees the same numbers; the uniform channels are
    computed in ``dtype``."""
    jitter, raw = raw_draws(gen, n, bounces)
    return jitter.to(dtype), preprocess_uniforms(raw.to(dtype))


def pass_form(scene: SceneArrays, camera: CameraRT, trace_fn, device,
              dtype, compensated: bool, tile: int):
    """The whole form a pass takes, ``(scene, camera, film, jitter, raw,
    closest_fn) → film`` on the pass's :func:`raw_draws`, or None: the
    chain :func:`render_pass_`, which is the plain version of every form.

    A whole form needs a CUDA device and a float32, uncompensated, untiled
    film; then the route decides:

    ================================  ===================================
    route                             form
    ================================  ===================================
    megakernel (``trace_fn`` is       :func:`.fused.trace_pass`, in a span
    :func:`.fused.trace_fused`)       ``trace_pass``
    bounce loop (``trace_fn`` None,   :func:`.integrator.trace_pass` with
    select kernel or BVH)             ``closest_fn``, for a scene that is
                                      not ``debug geom`` with nothing of
                                      the scene or camera requiring grad
                                      where autograd records (the shading
                                      kernel is then the bounce body, as
                                      it is in ``trace``); else None
    any other ``trace_fn``            None
    ================================  ===================================
    """
    if not (torch.device(device).type == "cuda" and dtype == torch.float32
            and not compensated and not tile):
        return None
    if trace_fn is fused.trace_fused:
        return _megakernel_pass
    if trace_fn is not None or scene.debug_geom:
        return None
    tensors = _tensors_of(scene) + list(camera_tensors(camera))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return None
    return integrator.trace_pass


def _megakernel_pass(scene, camera, film, jitter, raw, closest_fn):
    """:func:`.fused.trace_pass` in a span ``trace_pass`` (the megakernel
    is its own closest hit: ``closest_fn`` goes unused)."""
    with spans.span("trace_pass"):
        return fused.trace_pass(scene, camera, film, jitter, raw)


def _tensors_of(x) -> list:
    """The tensor fields of the dataclass ``x``, recursively."""
    out = []
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out += _tensors_of(v)
    return out


def _pass_body(scene: SceneArrays, camera: CameraRT, film: Film, closest_fn,
               trace_fn, tile: int) -> Callable:
    """``add(camera, film, gen)``: one pass drawn from the generator
    ``gen``, added into ``film`` in place, in the form :func:`pass_form`
    gives a pass like the one of ``camera`` and ``film`` (decided here,
    once): the pass's :func:`raw_draws` and the whole form, or its
    :func:`generator_draws` in the film's dtype and the chain
    :func:`render_pass_`.  What a :class:`PassGraph` captures and what
    :func:`render_passes` runs eagerly."""
    form = pass_form(scene, camera, trace_fn, film.samples.device,
                     film.color_sum.dtype, film.color_c is not None, tile)
    h, w = film.shape
    n, bounces = h * w, scene.recursion + 1

    def add(camera, film, gen):
        with torch.no_grad():
            if form is not None:
                jitter, raw = raw_draws(gen, n, bounces)
                form(scene, camera, film, jitter, raw, closest_fn)
            else:
                jitter, uniforms = generator_draws(gen, n, bounces,
                                                   film.color_sum.dtype)
                render_pass_(scene, camera, film, jitter, uniforms,
                             closest_fn=closest_fn, trace_fn=trace_fn,
                             tile=tile)
    return add


def pick_route(arrays: SceneArrays, accelerator: str = "auto"):
    """The tracer of a scene, as :class:`Renderer` picks it: ``(closest_fn,
    trace_fn, bvh)`` for :func:`render_pass`.  ``accelerator``: "brute"
    (dense scan), "bvh", or "auto" — the BVH once the three tables together
    outgrow the select kernel (``config.SELECT_MAX_PRIMS`` rows, where
    "brute" raises ``NotImplementedError``).  Within the dense tier, scenes
    that :func:`.fused.fits` run the megakernel, the others ``trace`` with
    the select kernel's closest hit."""
    if accelerator not in ("auto", "brute", "bvh"):
        raise ValueError(f"Renderer: unknown accelerator {accelerator!r}")
    rows = n_table_rows(arrays)
    if accelerator == "bvh" or (accelerator == "auto"
                                and rows > SELECT_MAX_PRIMS):
        bvh = build_bvh(arrays)
        return (make_bvh_closest_fn(bvh, arrays, traversal="kernel"), None,
                bvh)
    if rows > SELECT_MAX_PRIMS:
        raise NotImplementedError(
            f"accelerator {accelerator!r} on a scene of {rows} table "
            "rows: the dense tier takes up to SELECT_MAX_PRIMS "
            f"({SELECT_MAX_PRIMS}) rows; use \"auto\" or \"bvh\"")
    trace_fn = fused.trace_fused if fused.fits(arrays) else None
    return closest_hit_fused, trace_fn, None


def camera_tensors(camera: CameraRT) -> tuple:
    """The tensor fields of ``camera``, in field order."""
    return tuple(getattr(camera, f.name) for f in dataclasses.fields(camera)
                 if isinstance(getattr(camera, f.name), torch.Tensor))


def _clone_camera(camera: CameraRT) -> CameraRT:
    return dataclasses.replace(camera, **{
        f.name: getattr(camera, f.name).clone()
        for f in dataclasses.fields(camera)
        if isinstance(getattr(camera, f.name), torch.Tensor)})


def _clone_film(film: Film) -> Film:
    return Film(*(t.clone() for t in film.tensors()))


class PassGraph:
    """One progressive pass of ``scene`` through ``closest_fn`` /
    ``trace_fn`` (and ``tile``), captured once as a CUDA graph
    (:func:`..core.graphs.capture`) and replayed: the counterpart of the
    JAX package's ``jax.jit`` ``render_pass``.

    The graph draws its jitter and uniforms from :attr:`generator`
    (registered with it; :meth:`run` seeds it with :func:`pass_seed`
    before each replay, so the draws are the eager pass's), reads the
    static camera :attr:`camera` and accumulates into the static film
    :attr:`film` in place, in the form :func:`pass_form` gives the pass
    (:func:`_pass_body`, as the eager :func:`render_passes`).  :meth:`run`
    copies the caller's camera and film into those buffers first, unless
    they are those buffers.  :attr:`key` is what the graph was captured
    for: a pass whose key differs needs another graph."""

    def __init__(self, scene: SceneArrays, camera: CameraRT, film: Film,
                 closest_fn=closest_hit, trace_fn=None, tile: int = 0):
        self.key = PassGraph.key_of(scene, camera, film, closest_fn,
                                    trace_fn, tile)
        self.scene = scene  # held, so that the id in the key stays its own
        h, w = film.shape
        self.generator = torch.Generator(device=film.samples.device)
        self.camera = _clone_camera(camera)
        self.film = _clone_film(film)

        cam = camera_tensors(self.camera)
        add = _pass_body(scene, camera, film, closest_fn, trace_fn, tile)

        def body(*tensors):  # the camera's tensors, then the film's
            add(self.camera, Film(*tensors[len(cam):]), self.generator)

        self.captured = graphs_mod.capture(
            body, cam + self.film.tensors(),
            warmup=cam + tuple(t.clone() for t in self.film.tensors()),
            generators=(self.generator,),
            label=f"render pass {h}x{w} rec{scene.recursion}")

    @staticmethod
    def key_of(scene, camera, film, closest_fn, trace_fn, tile):
        """What a pass's graph is specialized on: the scene and route, the
        film's shape, dtype and compensation, the camera's mode, the tile
        and the device."""
        return (id(scene), closest_fn, trace_fn, int(tile), film.shape,
                film.color_sum.dtype, film.color_c is not None, camera.mode,
                film.samples.device)

    def run(self, camera: CameraRT, film: Film, seed: int, start: int,
            n: int = 1) -> Film:
        """Passes ``start`` … ``start + n - 1`` of a run seeded ``seed``,
        accumulated into :attr:`film` (after ``camera`` and ``film`` are
        copied into the graph's buffers); returns :attr:`film`.  No host
        synchronisation."""
        self.captured.feed(*camera_tensors(camera), *film.tensors())
        for k in range(start, start + n):
            self.generator.manual_seed(pass_seed(seed, k))
            self.captured.replay()
        return self.film


# The graphs of the module-level render_passes on CUDA tensors.
PASS_GRAPHS = graphs_mod.GraphCache(size=2)


def render_passes(scene: SceneArrays, camera, film: Film, seed: int,
                  start: int, n: int = 1, closest_fn=closest_hit,
                  trace_fn=None, tile: int = 0, graphs: bool | None = None
                  ) -> Film:
    """``n`` progressive passes, pass ``k`` (``start <= k < start + n``)
    drawing from a generator seeded with :func:`pass_seed` ``(seed, k)``
    (:func:`pass_draws`); ``closest_fn``, ``trace_fn`` and ``tile`` as in
    :func:`render_pass`, each pass in the form :func:`pass_form` gives it,
    graphed or not (:func:`_pass_body`).

    ``graphs``: None replays a captured :class:`PassGraph` (kept in
    :data:`PASS_GRAPHS`) for a film on a CUDA device and runs the eager
    passes on the CPU; False always runs the eager passes; True on the CPU
    raises ``ValueError``.  Either way the returned film is a new value,
    bit-equal between the two forms."""
    device = film.samples.device
    graphs = _use_graphs(graphs, device, "render_passes")
    if graphs:
        key = PassGraph.key_of(scene, camera, film, closest_fn, trace_fn,
                               tile)
        pg = PASS_GRAPHS.get(key, lambda: PassGraph(
            scene, camera, film, closest_fn, trace_fn, tile))
        return _clone_film(pg.run(camera, film, seed, start, n))
    add = _pass_body(scene, camera, film, closest_fn, trace_fn, tile)
    film = _clone_film(film)
    for k in range(start, start + n):
        add(camera, film, pass_generator(seed, k, device))
    return film


def _use_graphs(graphs, device, what: str) -> bool:
    """``graphs`` resolved for ``device``: None means a CUDA device; True
    off a CUDA device raises ``ValueError``."""
    device = torch.device(device)
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"{what}: graphs=True needs a CUDA device (CUDA "
                         f"graphs), not {device}")
    return bool(graphs)


def _add_spans(path: str, records, anchors) -> None:
    """Write the span recorder's ``records`` into the Chrome trace at
    ``path`` as complete events on the host thread of its ``rtc.anchor``
    ranges, whose times and ``anchors`` (one for each of the last ranges)
    map the recorder's clock onto the trace's
    (:func:`..core.spans.clock_offset`)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    marks = sorted((e for e in events if e.get("name") == spans.ANCHOR
                    and e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    marks = marks[-len(anchors):]
    offset, width, drift = spans.clock_offset(
        anchors, [(e["ts"], e["ts"] + e["dur"]) for e in marks])
    for name, t0, t1, parent, top in spans.on_profiler_clock(records,
                                                              offset):
        events.append({"ph": "X", "cat": "rtc.span", "name": name,
                       "pid": marks[0]["pid"], "tid": marks[0]["tid"],
                       "ts": t0, "dur": t1 - t0,
                       "args": {"parent": parent, "top": top}})
    trace["rtcSpanClock"] = {"width_us": width, "drift_us": drift}
    with open(path, "w") as f:
        json.dump(trace, f)


class Renderer:
    """Progressive scene renderer with pause/resume/checkpoint.

    Equivalent surface to FullRaytracer: Start (construct), step/run
    (render loop), status throughput, GetBitmap (image()), camera switching
    (Scene.NextCamera, Scene.cs:122-135).
    """

    def __init__(self, scene: HostScene | SceneArrays, device="cuda",
                 seed: int = 0, camera_index: int = 0,
                 compensated: bool = False, accelerator: str = "auto",
                 closest_fn=None, cameras=None, dtype=torch.float32,
                 graphs: bool | None = None):
        """``scene``: a loaded :class:`HostScene`, or frozen
        :class:`SceneArrays` (as :mod:`..scene.meshgen` makes them, cast to
        ``dtype``) together with their host ``cameras``.  ``device``: where
        the scene, film and kernels live ("cuda" runs the kernels; "cpu"
        their plain versions).  ``compensated``: Neumaier-compensated film
        accumulation for runs of thousands of samples per pixel.

        ``dtype`` (f32 or f64): the scene tables, camera, random numbers,
        the shading outside the kernels and the film.  The kernels compute
        in f32 on f32 copies, so on the card an f64 renderer takes the
        route an f32 one takes.  On the CPU an f64 dense-tier scene is
        traced by ``trace`` with the f64
        :func:`..intersect.dispatch.closest_hit` (the JAX ``Renderer`` off
        its accelerator), not by the f32 plain versions of the kernels.

        ``accelerator``: "brute" (dense scan), "bvh", or "auto", the
        route :func:`pick_route` picks: the BVH route builds the triangle
        BVH (:func:`..bvh.builder.build_bvh`) and runs
        :func:`.integrator.trace` with
        :func:`..intersect.dispatch.make_bvh_closest_fn`'s closest hit;
        within the dense tier, scenes that :func:`.fused.fits` run the
        megakernel, the others (65 to ``SELECT_MAX_PRIMS`` rows, or ``debug
        geom``) ``trace`` with the select kernel's
        :func:`..intersect.cuda_select.closest_hit_fused`.  A given
        ``closest_fn`` overrides the pick and runs through ``trace``.

        ``graphs``: None (the default) captures the pass once as a CUDA
        graph and replays it (:class:`PassGraph`) on a CUDA device, and
        runs the eager passes on the CPU; False always runs the eager
        passes; True on the CPU raises ``ValueError``.  A graphed renderer
        accumulates into the graph's film in place: ``self.film`` is that
        film after a step (clone it to keep a copy), and a camera or film
        put in its place (``reset``, ``next_camera``,
        ``load_checkpoint``, assignment) is copied into the graph's
        buffers at the next step; a change of camera mode or film
        compensation captures the pass again.  Graphed and eager films
        are bit-equal."""
        if accelerator not in ("auto", "brute", "bvh"):
            raise ValueError(f"Renderer: unknown accelerator {accelerator!r}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"Renderer: dtype {dtype} is not float32 or "
                             "float64")
        self.device = resolve_device(device, "Renderer")
        self.graphs = _use_graphs(graphs, self.device, "Renderer")
        # The captured pass (one at a time): PassGraph, by PassGraph.key_of.
        self.pass_graphs = graphs_mod.GraphCache(size=1)
        self.seed = seed
        self.dtype = dtype
        self.compensated = compensated
        if isinstance(scene, SceneArrays):
            if not cameras:
                raise ValueError("Renderer: frozen SceneArrays come with "
                                 "their cameras=[HostCamera, ...]")
            self.arrays = scene.to(self.device, dtype)
            self.cameras = list(cameras)
        else:
            self.arrays = freeze_scene(scene, device=self.device,
                                       dtype=dtype)
            self.cameras = scene.cameras
        self.camera_index = camera_index
        if closest_fn is not None:
            self.closest_fn, self.trace_fn, self.bvh = closest_fn, None, None
        else:
            self.closest_fn, self.trace_fn, self.bvh = pick_route(
                self.arrays, accelerator)
            if (dtype == torch.float64 and self.device.type == "cpu"
                    and self.bvh is None):
                self.closest_fn, self.trace_fn = closest_hit, None
        self.reset()

    @property
    def route(self) -> str:
        """Which tracer a pass runs: "megakernel", "bvh" (the bounce loop
        with one traversal per BVH and bounce), or "trace" (the bounce loop
        with one dense closest-hit query per bounce)."""
        if self.trace_fn is not None:
            return "megakernel"
        return "bvh" if self.bvh is not None else "trace"

    # -- lifecycle ---------------------------------------------------------

    def _init_camera(self):
        s = self.arrays
        return init_camera(self.cameras[self.camera_index], s.width,
                           s.height, device=self.device, dtype=self.dtype)

    def reset(self) -> None:
        s = self.arrays
        self.camera = self._init_camera()
        self.film = Film.create(s.height, s.width, device=self.device,
                                dtype=self.dtype,
                                compensated=self.compensated)
        self.pass_index = 0
        self._elapsed = 0.0
        # (film, its tonemap Packer or None: the chain), made by image().
        self._packer = (None, None)

    def next_camera(self) -> bool:
        """Cycle cameras; returns True on wraparound (Scene.cs:127-135).
        Resets accumulation like the reference's render restart."""
        self.camera_index += 1
        wrapped = self.camera_index >= len(self.cameras)
        if wrapped:
            self.camera_index = 0
        self.reset()
        return wrapped

    # -- rendering ---------------------------------------------------------

    def step(self, n: int = 1) -> None:
        """Run n progressive passes (+n samples/pixel); returns once the
        device has finished them.  Graphed: n replays of the captured
        pass (captured at the first step, or when the key changed), then
        one synchronize."""
        self._advance(n, self.graphs)

    def _advance(self, n: int, graphed: bool) -> None:
        t0 = time.perf_counter()
        with spans.span("render.step"):
            if graphed:
                pg = self._pass_graph()
                self.film = pg.run(self.camera, self.film, self.seed,
                                   self.pass_index, n)
                self.camera = pg.camera
            else:
                self.film = render_passes(
                    self.arrays, self.camera, self.film, self.seed,
                    self.pass_index, n, closest_fn=self.closest_fn,
                    trace_fn=self.trace_fn, graphs=False)
            self.pass_index += n
            if self.device.type == "cuda":
                with spans.span("render.sync"):
                    torch.cuda.synchronize(self.device)
        self._elapsed += time.perf_counter() - t0

    def _pass_graph(self) -> PassGraph:
        """The captured pass of the current scene, route, camera mode and
        film, captured on a miss."""
        key = PassGraph.key_of(self.arrays, self.camera, self.film,
                               self.closest_fn, self.trace_fn, 0)
        return self.pass_graphs.get(key, lambda: PassGraph(
            self.arrays, self.camera, self.film, self.closest_fn,
            self.trace_fn))

    def run(self, spp: int, status_cb: Optional[Callable] = None,
            status_every: int = 8) -> None:
        """Render to a target samples/pixel with optional status callbacks
        (the coordinator loop, FullRaytracer.cs:307-370)."""
        while self.pass_index < spp:
            n = min(status_every, spp - self.pass_index)
            self.step(n)
            if status_cb is not None:
                status_cb(self.status())

    # -- observability -----------------------------------------------------

    def status(self) -> dict:
        """Throughput in the reference's terms (FullRaytracer.cs:346-357):
        samples/px/sec plus the asymptotic progress model spp/(spp+1000)."""
        spp = self.pass_index
        sps = spp / self._elapsed if self._elapsed > 0 else 0.0
        h, w = self.film.shape
        return {
            "samples_per_px": spp,
            "samples_per_px_per_sec": sps,
            "paths_per_sec": sps * h * w,
            "elapsed_sec": self._elapsed,
            "progress": spp / (spp + 1000.0),
        }

    def profile(self, logdir: str, n: int = 4) -> str:
        """Run ``n`` passes as ``step(n)`` runs them (the film and
        ``pass_index`` advance alike) under ``torch.profiler``, with the
        card's kernels on a CUDA device, and write the Chrome trace into
        ``logdir``; returns its path.

        Graphed, the pass's graph is looked up, or captured, before the
        profiler starts (a capture under a profiler raises).  The passes
        run with the span recorder on, and its spans go into the trace as
        complete events of category ``rtc.span`` on the host thread:
        ``render.step`` holding ``graph.feed``, a ``graph.replay`` a pass
        and ``render.sync``, or on the eager path ``trace_pass`` for the
        megakernel's whole form, ``camera_rays`` and a ``closest_hit`` a
        bounce for the bounce loop's (:func:`pass_form`), else the phases
        ``camera_rays``,
        ``trace_fused`` or ``closest_hit`` (one a bounce) and
        ``film_accum``.  They are mapped onto the profiler's clock by
        an ``rtc.anchor`` range before (after one that warms the profiler)
        and one after the passes (:func:`..core.spans.clock_offset`; the
        pair's width and the drift between them under the trace's
        ``rtcSpanClock``)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        if self.graphs:
            self._pass_graph()
        with profile(activities=activities) as prof:
            spans.start()
            spans.anchor()  # the profiler's first range costs more
            anchors = [spans.anchor()]
            try:
                self._advance(n, self.graphs)
            finally:
                anchors.append(spans.anchor())
                records = spans.stop()
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(
            logdir, f"render_passes_{self.pass_index - n}-"
            f"{self.pass_index - 1}_{os.getpid()}.trace.json")
        prof.export_chrome_trace(path)
        _add_spans(path, records, anchors)
        return path

    def image(self, exposure: float = 1.0) -> np.ndarray:
        """Tonemapped uint8 RGBA frame [H, W, 4] (GetBitmap,
        FullRaytracer.cs:179-205), an array of its own at every call.

        Two routes, by what :func:`.tonemap_kernel.takes` observes in the
        film.  A film of CUDA float32 planes (compensated or not): under
        ``film.tonemap`` one launch of the tonemap kernel
        (:class:`.tonemap_kernel.Packer`, kept while the film stays the
        same object, as a graphed film does), which stores the image
        straight into a fresh pinned host tensor; under ``film.to_host``
        the synchronize of the stream.  Every other film (the CPU,
        float64): under ``film.tonemap`` the chain
        :meth:`.film.Film.to_uint8`, the kernel's plain version, and under
        ``film.to_host`` its copy to the host.  The two are bit-equal."""
        s, film = self.arrays, self.film
        with spans.span("render.image"):
            if self._packer[0] is not film:
                self._packer = (film, tonemap_kernel.Packer(
                    film, s.background_rgb, s.background_alpha)
                    if tonemap_kernel.takes(film) else None)
            packer = self._packer[1]
            if packer is not None:
                with spans.span("film.tonemap"):
                    img = packer(exposure)
                with spans.span("film.to_host"):
                    packer.synchronize()
                    return img.numpy()
            with spans.span("film.tonemap"):
                img = film.to_uint8(s.background_rgb, s.background_alpha,
                                    exposure)
            with spans.span("film.to_host"):
                return img.cpu().numpy()

    # -- checkpoint / resume ----------------------------------------------
    # Same .npz keys as the JAX Renderer, so checkpoints move both ways.

    def save_checkpoint(self, path: str) -> None:
        extra = {}
        if self.film.color_c is not None:
            extra["color_c"] = self.film.color_c.cpu().numpy()
        np.savez(path,
                 color_sum=self.film.color_sum.cpu().numpy(),
                 samples=self.film.samples.cpu().numpy(),
                 misses=self.film.misses.cpu().numpy(),
                 pass_index=self.pass_index,
                 camera_index=self.camera_index, **extra)

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
        self.camera_index = int(arrays["camera_index"])
        self.camera = self._init_camera()

        def t(a):
            return torch.tensor(a, dtype=self.dtype, device=self.device)
        cc = t(arrays["color_c"]) if "color_c" in arrays else None
        self.film = Film(color_sum=t(arrays["color_sum"]),
                         samples=t(arrays["samples"]),
                         misses=t(arrays["misses"]), color_c=cc)
        self.compensated = cc is not None
        self.pass_index = int(arrays["pass_index"])
