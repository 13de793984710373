"""Progressive renderer — the orchestration layer (counterpart of
``raytracercore_tpu.render.renderer``).

Replaces the reference's ``FullRaytracer`` (Raytracing/FullRaytracer.cs):
one full-frame render pass per sample, the whole image traced by the
megakernel in one launch.  Progressive refinement = calling ``step``
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

from ..scene.types import HostScene, SceneArrays, freeze_scene, init_camera
from . import camera as cam_mod
from . import fused
from .film import Film
from .integrator import prepare_uniforms


def pass_seed(seed: int, pass_index: int) -> int:
    """The generator seed of pass ``pass_index`` of a run seeded ``seed``
    (a SeedSequence mix, so neighbouring passes and seeds get unrelated
    streams; its low 32 bits alone already differ, which the CPU
    generator needs)."""
    state = np.random.SeedSequence([seed, pass_index]).generate_state(
        2, np.uint32)
    return int(state[0]) | (int(state[1]) << 32)


def render_pass(scene: SceneArrays, camera, film: Film, jitter, uniforms,
                trace_fn=fused.trace_fused) -> Film:
    """One full-frame progressive pass: +1 sample for every pixel.

    ``jitter`` [H*W, 4] are the camera uniforms (:func:`.camera.camera_rays`)
    and ``uniforms`` [recursion + 1, 7, H*W] the path uniforms
    (:func:`.integrator.preprocess_uniforms`), in row-major pixel order.
    ``trace_fn(scene, ray_o, ray_d, uniforms) → (color, miss)`` traces the
    rays (default: the megakernel).
    """
    h, w = film.shape
    px, py = cam_mod.pixel_grid(w, h, device=jitter.device)
    ray_o, ray_d = cam_mod.camera_rays(camera, px, py, jitter)
    color, miss = trace_fn(scene, ray_o.contiguous(), ray_d.contiguous(),
                           uniforms)
    return film.add_full_frame(color, miss)


def render_passes(scene: SceneArrays, camera, film: Film, seed: int,
                  start: int, n: int = 1) -> Film:
    """``n`` progressive passes, pass ``k`` (``start <= k < start + n``)
    drawing from a generator seeded with :func:`pass_seed` ``(seed, k)``."""
    h, w = film.shape
    R = h * w
    device = film.samples.device
    gen = torch.Generator(device=device)
    for k in range(start, start + n):
        gen.manual_seed(pass_seed(seed, k))
        jitter = torch.rand((R, 4), generator=gen, device=device)
        uniforms = prepare_uniforms(gen, R, scene.recursion + 1, device)
        film = render_pass(scene, camera, film, jitter, uniforms)
    return film


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Renderer: device 'cuda' requested but no CUDA device is "
            "available (torch.cuda.is_available() is False)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"Renderer: unsupported device {device}")
    return device


class Renderer:
    """Progressive scene renderer with pause/resume/checkpoint.

    Equivalent surface to FullRaytracer: Start (construct), step/run
    (render loop), status throughput, GetBitmap (image()), camera switching
    (Scene.NextCamera, Scene.cs:122-135).
    """

    def __init__(self, scene: HostScene, device="cuda", seed: int = 0,
                 camera_index: int = 0, compensated: bool = False):
        """``device``: where the scene, film and kernel live ("cuda" runs
        the megakernel; "cpu" its plain version).  ``compensated``:
        Neumaier-compensated film accumulation for runs of thousands of
        samples per pixel."""
        self.device = _resolve_device(device)
        self.host_scene = scene
        self.seed = seed
        self.compensated = compensated
        self.arrays = freeze_scene(scene, device=self.device)
        if not fused.fits(self.arrays):
            raise NotImplementedError(
                "scene has more than FUSED_MAX_PRIMS "
                f"({fused.MAX_PRIMS}) table rows or uses `debug geom`; "
                "the port renders only megakernel-sized scenes so far "
                "(larger scenes need the per-bounce select kernel and the "
                "BVH: ROADMAP.md queue 1, items 1 and 3)")
        self.camera_index = camera_index
        self.reset()

    # -- lifecycle ---------------------------------------------------------

    def _init_camera(self):
        s = self.host_scene
        return init_camera(s.cameras[self.camera_index], s.width, s.height,
                           device=self.device)

    def reset(self) -> None:
        s = self.host_scene
        self.camera = self._init_camera()
        self.film = Film.create(s.height, s.width, device=self.device,
                                compensated=self.compensated)
        self.pass_index = 0
        self._elapsed = 0.0

    def next_camera(self) -> bool:
        """Cycle cameras; returns True on wraparound (Scene.cs:127-135).
        Resets accumulation like the reference's render restart."""
        self.camera_index += 1
        wrapped = self.camera_index >= len(self.host_scene.cameras)
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
                                  self.seed, self.pass_index, n)
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
        s = self.host_scene
        bg = torch.tensor(np.asarray(s.background_rgb, np.float64),
                          dtype=torch.float32, device=self.device)
        alpha = torch.tensor(float(s.background_alpha), dtype=torch.float32,
                             device=self.device)
        return self.film.to_uint8(bg, alpha, exposure).cpu().numpy()

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
