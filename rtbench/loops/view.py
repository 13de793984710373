"""The ``view`` loop: a viewer watching one camera converge.

One ``Renderer`` (graphed on the card, seeded from ``--seed``) accumulates
from the configuration's camera.  A frame is ``step(k)``, ``status()`` and
``image()``, up to the image on the host; frames follow each other with
no camera change (a closed loop of one viewer).  Set-up renders one frame,
which captures the pass's graph.  The window runs frames until
``--seconds`` have passed and ends at a synchronize.

End to end: ``samples_px_per_s``, the passes completed in the window over
its wall seconds; ``frame_ms_p95``, the 95th percentile (nearest rank)
of all its frames' times.

Correct: after the window, the program's film at ``check_pixels`` pixels
drawn from the seed, and the image of one frame drawn from the seed at
those pixels, against the reference's film of the same passes
(:func:`rtbench.reference.view.film_at`): the widest gap of a colour sum
as a share of the mean colour sum (``film_gap``) and the widest gap of an
image channel in levels (``image_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import scenes, stats
from rtbench.reference import view as ref_view


def run(ctx):
    cfg, mix = ctx.config, ctx.traffic
    k = int(mix["passes_per_frame"])
    inputs = scenes.make(cfg)
    scene, cameras = scenes.for_program(inputs, ctx.device)

    from raytracercore_tpu_torch.render.renderer import Renderer

    ctx.note("scene made")
    r = Renderer(scene, device=ctx.device, seed=ctx.seed,
                 camera_index=cfg.get("camera", 0), cameras=cameras)
    ctx.note(f"renderer made, route {r.route}")
    spans = ctx.spans

    def frame():
        with spans("step"):
            r.step(k)
        with spans("status"):
            r.status()
        with spans("image"):
            return r.image()

    frame()  # set-up: builds, loads and captures; its passes stay in
    ctx.sync()
    ctx.end_setup()
    spans.items.clear()

    keep_rng = np.random.default_rng([ctx.seed, 2])
    kept_image, kept_passes = None, 0
    frames = []
    start_pass = r.pass_index
    t0 = time.perf_counter()
    while True:
        if ctx.profile is not None:
            ctx.profile_frame(len(frames))
        f0 = time.perf_counter()
        img = frame()
        f1 = time.perf_counter()
        frames.append(f1 - f0)
        if keep_rng.random() * len(frames) < 1.0:
            kept_image, kept_passes = img, r.pass_index
        if f1 - t0 - ctx.paused_s >= ctx.seconds:
            break
    ctx.sync()
    t1 = time.perf_counter()
    if ctx.profile is not None:
        ctx.profile_frame(None)
    passes = r.pass_index - start_pass
    e2e = {"samples_px_per_s": stats.rate(passes, t1 - t0),
           "frame_ms_p95": stats.p95(frames) * 1e3}
    ctx.read_memory_peak()

    # Correctness, after the window: the program's film at pixels drawn
    # from the seed, then its state freed before the reference runs.
    h, w = cfg["size"][1], cfg["size"][0]
    pix = np.sort(np.random.default_rng([ctx.seed, 1]).choice(
        h * w, size=min(int(mix["check_pixels"]), h * w), replace=False))
    film = r.film
    got = {"color_sum": film.color_sum.reshape(h * w, 3)[
        torch.as_tensor(pix)].cpu().numpy()}
    got_image = kept_image.reshape(h * w, 4)[pix]
    total_passes = r.pass_index
    del r, film, scene
    ctx.free()
    ctx.note(f"window closed: {len(frames)} frames; reference of "
             f"{total_passes} passes at {len(pix)} pixels")
    want = ref_view.film_at(inputs.tables, inputs.camera, ctx.seed, pix,
                            total_passes, kept_passes, ctx.device)
    ctx.counts.update(
        rays_per_pass=h * w, bounces_per_path=want["bounces"],
        frames=len(frames), frame_s=frames, passes=passes,
        scene_tables=inputs.tables, image_s=spans.durations("image"))
    return {"end_to_end": e2e, "attempted": len(frames), "failed": 0,
            "numbers": compare(got, got_image, want)}


def compare(got, got_image, want):
    """The numbers ``correct`` is decided on (see the module's doc)."""
    ref_sum = want["color_sum"].astype(np.float64)
    gap = np.abs(got["color_sum"].astype(np.float64) - ref_sum).max()
    image_gap = np.abs(got_image.astype(np.int64)
                       - want["image"].astype(np.int64)).max()
    return {"film_gap": float(gap / max(ref_sum.mean(), 1e-30)),
            "image_gap": float(image_gap)}
