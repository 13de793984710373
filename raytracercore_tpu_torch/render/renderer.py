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

Randomness: pass ``k`` draws its camera jitter and its path uniforms from a
``torch.Generator`` on the render device seeded from ``(seed, k)``, so a run
gives the same film however it is chunked into ``step`` calls.  The
numbers are the device generator's (Philox on CUDA, Mersenne Twister on
the CPU), not the JAX package's threefry stream.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import BVH_AUTO_THRESHOLD, SELECT_MAX_PRIMS
from ..bvh.builder import build_bvh
from ..core.device import resolve_device
from ..intersect.cuda_select import closest_hit_fused
from ..intersect.dispatch import (closest_hit, make_bvh_closest_fn,
                                  n_table_rows)
from ..scene.types import HostScene, SceneArrays, freeze_scene, init_camera
from . import camera as cam_mod
from . import fused
from .film import Film
from .integrator import prepare_uniforms, trace


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
    h, w = film.shape
    if tile:
        px, py = cam_mod.pixel_grid_tiled(w, h, tile, device=jitter.device)
    else:
        px, py = cam_mod.pixel_grid(w, h, device=jitter.device)
    color, miss = trace_pixels(scene, camera, px, py, jitter, uniforms,
                               closest_fn, trace_fn)
    if tile:
        color = cam_mod.untile(color, w, h, tile)
        miss = cam_mod.untile(miss, w, h, tile)
    return film.add_full_frame(color, miss)


def trace_pixels(scene: SceneArrays, camera, px, py, jitter, uniforms,
                 closest_fn=closest_hit, trace_fn=None):
    """``(color [R, 3], miss [R])`` of one sample through each of the
    pixels ``(px, py)`` [R]: camera rays from ``jitter`` [R, 4], then
    ``trace_fn`` or :func:`.integrator.trace` with ``closest_fn`` on
    ``uniforms`` [B, 7, R] (the body of :func:`render_pass`)."""
    ray_o, ray_d = cam_mod.camera_rays(camera, px, py, jitter)
    ray_o, ray_d = ray_o.contiguous(), ray_d.contiguous()
    if trace_fn is not None:
        return trace_fn(scene, ray_o, ray_d, uniforms)
    # No early exit: at full-frame batches some ray nearly always survives
    # to the recursion cap, and the test costs a host read of the device
    # per bounce.
    return trace(scene, ray_o, ray_d, None, closest_fn=closest_fn,
                 uniforms=uniforms)


def pass_draws(seed: int, k: int, n: int, bounces: int, device):
    """The random numbers of pass ``k`` of a run seeded ``seed`` over ``n``
    pixels: ``(jitter [n, 4], uniforms [bounces, 7, n])``, drawn from a
    generator on ``device`` seeded with :func:`pass_seed` ``(seed, k)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(pass_seed(seed, k))
    jitter = torch.rand((n, 4), generator=gen, device=device)
    return jitter, prepare_uniforms(gen, n, bounces, device)


def pick_route(arrays: SceneArrays, accelerator: str = "auto"):
    """The tracer of a scene, as :class:`Renderer` picks it: ``(closest_fn,
    trace_fn, bvh)`` for :func:`render_pass`.  ``accelerator``: "brute"
    (dense scan), "bvh", or "auto" — the BVH once the triangle table
    outgrows the dense tier (``config.BVH_AUTO_THRESHOLD``) or the three
    tables together outgrow the select kernel (``config.SELECT_MAX_PRIMS``
    rows, where "brute" raises ``NotImplementedError``).  Within the dense
    tier, scenes that :func:`.fused.fits` run the megakernel, the others
    ``trace`` with the select kernel's closest hit."""
    if accelerator not in ("auto", "brute", "bvh"):
        raise ValueError(f"Renderer: unknown accelerator {accelerator!r}")
    rows = n_table_rows(arrays)
    n_tris = int((arrays.triangles.prim_id >= 0).sum())
    if accelerator == "bvh" or (accelerator == "auto" and (
            n_tris > BVH_AUTO_THRESHOLD or rows > SELECT_MAX_PRIMS)):
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


def render_passes(scene: SceneArrays, camera, film: Film, seed: int,
                  start: int, n: int = 1, closest_fn=closest_hit,
                  trace_fn=None, tile: int = 0) -> Film:
    """``n`` progressive passes, pass ``k`` (``start <= k < start + n``)
    drawing from a generator seeded with :func:`pass_seed` ``(seed, k)``
    (:func:`pass_draws`); ``closest_fn``, ``trace_fn`` and ``tile`` as in
    :func:`render_pass`."""
    h, w = film.shape
    device = film.samples.device
    for k in range(start, start + n):
        jitter, uniforms = pass_draws(seed, k, h * w, scene.recursion + 1,
                                      device)
        with torch.no_grad():
            film = render_pass(scene, camera, film, jitter, uniforms,
                               closest_fn=closest_fn, trace_fn=trace_fn,
                               tile=tile)
    return film


class Renderer:
    """Progressive scene renderer with pause/resume/checkpoint.

    Equivalent surface to FullRaytracer: Start (construct), step/run
    (render loop), status throughput, GetBitmap (image()), camera switching
    (Scene.NextCamera, Scene.cs:122-135).
    """

    def __init__(self, scene: HostScene | SceneArrays, device="cuda",
                 seed: int = 0, camera_index: int = 0,
                 compensated: bool = False, accelerator: str = "auto",
                 closest_fn=None, cameras=None):
        """``scene``: a loaded :class:`HostScene`, or frozen
        :class:`SceneArrays` (as :mod:`..scene.meshgen` makes them) together
        with their host ``cameras``.  ``device``: where the scene, film and
        kernels live ("cuda" runs the kernels; "cpu" their plain versions).
        ``compensated``: Neumaier-compensated film accumulation for runs of
        thousands of samples per pixel.

        ``accelerator``: "brute" (dense scan), "bvh", or "auto", the
        route :func:`pick_route` picks: the BVH route builds the triangle
        BVH (:func:`..bvh.builder.build_bvh`) and runs
        :func:`.integrator.trace` with
        :func:`..intersect.dispatch.make_bvh_closest_fn`'s closest hit;
        within the dense tier, scenes that :func:`.fused.fits` run the
        megakernel, the others (65 to ``SELECT_MAX_PRIMS`` rows, or ``debug
        geom``) ``trace`` with the select kernel's
        :func:`..intersect.cuda_select.closest_hit_fused`.  A given
        ``closest_fn`` overrides the pick and runs through ``trace``."""
        if accelerator not in ("auto", "brute", "bvh"):
            raise ValueError(f"Renderer: unknown accelerator {accelerator!r}")
        self.device = resolve_device(device, "Renderer")
        self.seed = seed
        self.compensated = compensated
        if isinstance(scene, SceneArrays):
            if not cameras:
                raise ValueError("Renderer: frozen SceneArrays come with "
                                 "their cameras=[HostCamera, ...]")
            self.arrays = scene.to(self.device)
            self.cameras = list(cameras)
        else:
            self.arrays = freeze_scene(scene, device=self.device)
            self.cameras = scene.cameras
        self.camera_index = camera_index
        if closest_fn is not None:
            self.closest_fn, self.trace_fn, self.bvh = closest_fn, None, None
        else:
            self.closest_fn, self.trace_fn, self.bvh = pick_route(
                self.arrays, accelerator)
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
                           s.height, device=self.device)

    def reset(self) -> None:
        s = self.arrays
        self.camera = self._init_camera()
        self.film = Film.create(s.height, s.width, device=self.device,
                                compensated=self.compensated)
        self.pass_index = 0
        self._elapsed = 0.0

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
        device has finished them."""
        t0 = time.perf_counter()
        self.film = render_passes(self.arrays, self.camera, self.film,
                                  self.seed, self.pass_index, n,
                                  closest_fn=self.closest_fn,
                                  trace_fn=self.trace_fn)
        self.pass_index += n
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._elapsed += time.perf_counter() - t0

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

    def image(self, exposure: float = 1.0) -> np.ndarray:
        """Tonemapped uint8 RGBA frame [H, W, 4] (GetBitmap,
        FullRaytracer.cs:179-205)."""
        s = self.arrays
        return self.film.to_uint8(s.background_rgb.float(),
                                  s.background_alpha.float(),
                                  exposure).cpu().numpy()

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
            return torch.tensor(a, dtype=torch.float32, device=self.device)
        cc = t(arrays["color_c"]) if "color_c" in arrays else None
        self.film = Film(color_sum=t(arrays["color_sum"]),
                         samples=t(arrays["samples"]),
                         misses=t(arrays["misses"]), color_c=cc)
        self.compensated = cc is not None
        self.pass_index = int(arrays["pass_index"])
