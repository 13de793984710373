#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``raytracercore_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``raytracercore_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card, drives the
main path (the progressive forward render: ``Renderer`` → camera rays →
uniforms → the whole-path megakernel → film → tonemapped image) on a
Cornell-class scene at 700×700, recursion 10, and prints what it measured.
The last two lines of standard output are a JSON object describing the
kernels and a JSON object ``{"ok": true, "device": ...}``.  Any failed
check exits non-zero before those lines.  Without a CUDA device it exits
non-zero at once.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Cornell-class scene in the reference's text format (the class of the
# reference's bounce.txt: an inverted room of differently coloured walls,
# an emissive light box at the ceiling, a rotated diffuse cube, a diffuse
# sphere, a glass ellipsoid, a mirror sphere and one two-sided plane).
CORNELL_SCENE = """
size 700 700
recursion 10
background 0 0 0 1
ambient color .03 .03 .04
camera 0 2 6.5  0 1.8 0  0 1 0  45
camera 2.5 3 6  0 1.2 0  0 1 0  50

# Room: single-sided inverted walls, each side its own colour.
twosided false
invert true
diffuse .75 .75 .75
cube 0 2 0  4 4 4 only +y -z
diffuse .75 .12 .12
instance -x
diffuse .12 .7 .15
instance +x
invert false

# Floor: a two-sided plane.
twosided true
diffuse .7 .7 .65
plane 0  0 1 0

# Light box at the ceiling.
emission 9 9 8
diffuse 0 0 0
cube 0 3.85 -.2  1.2 .3 1.2 not +y
emission 0 0 0

# Rotated diffuse cube.
diffuse .65 .6 .3
pushtransform
translate -1 .6 -.9
rotate 0 1 0 30
cube 0 0 0  1.2 1.2 1.2 all
poptransform

# Pedestal for the lens.
diffuse .5 .5 .55
cube .4 .25 .6  .9 .5 .9 not -y

# Diffuse sphere.
diffuse .25 .35 .8
sphere 1.3 .5 -1.2 .5

# Glass ellipsoid (a scaled sphere).
diffuse 0 0 0
specular .9 .9 .9
shininess 100000
refraction .9 .9 .9, 1.52
pushtransform
translate .4 1 .6
scale 1 .6 1
sphere 0 0 0 .5
poptransform

# Mirror sphere.
refraction off
shininess 1000000
sphere -1.1 .45 1.1 .45
"""

# The small scene of the JAX package's megakernel test (every branch of the
# bounce loop: emissive quad, two-sided plane, glass and mirror spheres).
FUSED_TEST_SCENE = """
size 16 16
recursion 4
ambient color 0.05 0.05 0.05
camera 0 1 4  0 1 0  0 1 0  60
emission 6 6 6
vertex -1 2.5 -1
vertex 1 2.5 -1
vertex -1 2.5 1
tri 0 1 2 mirrored
emission 0 0 0
diffuse .7 .6 .5
twosided true
plane -1  0 0 1
diffuse 0 0 0
specular .9 .9 .9
shininess 100000
refraction .9 .9 .9, 1.52
sphere -0.8 1 0.5 0.6
refraction off
shininess 1000000
sphere 0.8 1 0.5 0.6
"""

# The same scene in `ambient miss` mode with a smooth-shaded quad
# (vertex normals) in front of the back plane: the kernel's other
# specializations (ambient-miss, smooth normals).
SMOOTH_SCENE = FUSED_TEST_SCENE.replace(
    "ambient color 0.05 0.05 0.05", "ambient miss") + """
diffuse .6 .6 .6
specular 0 0 0
shininess 100
vertexnormal -1.5 0 -.9  -.3 .3 1
vertexnormal 1.5 0 -.9  .3 .3 1
vertexnormal -1.5 2.5 -.9  -.3 -.2 1
vertexnormal 1.5 2.5 -.9  .3 -.2 1
trinormal 0 1 2
trinormal 1 3 2
"""

MAIN_PASSES = 16      # timed passes of the main path
WARM_PASSES = 2       # untimed passes before them (first use loads the kernel)
COMPARE_SIZE = 256    # image size of the kernel-vs-plain comparisons
# Kernel vs plain tolerances (those of tests/test_fused.py): knife-edge f32
# branch flips may change a few whole paths, nothing else may differ.
CLOSE_ATOL = CLOSE_RTOL = 1e-3
MIN_CLOSE_FRAC = 0.97
MEAN_TOL = 5e-3


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n):
    """Mean device time of ``fn()`` over ``n`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def rays_and_uniforms(scene_text, size, recursion, seed, dev):
    from raytracercore_tpu_torch.render import camera as cam_mod
    from raytracercore_tpu_torch.render.fused import fits
    from raytracercore_tpu_torch.render.integrator import prepare_uniforms
    from raytracercore_tpu_torch.scene import loader
    from raytracercore_tpu_torch.scene.types import freeze_scene, init_camera

    host = loader.parse(scene_text)
    host.width = host.height = size
    host.recursion = recursion
    arrays = freeze_scene(host, device=dev)
    check(fits(arrays), "scene fits the megakernel")
    cam = init_camera(host.cameras[0], size, size, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    px, py = cam_mod.pixel_grid(size, size, device=dev)
    jitter = torch.rand((size * size, 4), generator=gen, device=dev)
    ray_o, ray_d = cam_mod.camera_rays(cam, px, py, jitter)
    uniforms = prepare_uniforms(gen, size * size, recursion + 1, dev)
    return arrays, ray_o.contiguous(), ray_d.contiguous(), uniforms


def compare(label, arrays, ray_o, ray_d, uniforms):
    """Kernel (tape on and off) against the plain version on the same rays
    and uniforms; returns the max abs error over rays whose paths agree."""
    from raytracercore_tpu_torch.render.fused import (
        classify_mismatches, trace_fused, trace_fused_reference)
    from raytracercore_tpu_torch.render.integrator import PathTape

    ref = trace_fused_reference(arrays, ray_o, ray_d, uniforms,
                                want_tape=True)
    got = trace_fused(arrays, ray_o, ray_d, uniforms, want_tape=True)
    got_nt = trace_fused(arrays, ray_o, ray_d, uniforms, want_tape=False)
    torch.cuda.synchronize()
    cls = classify_mismatches(ref, got, CLOSE_ATOL, CLOSE_RTOL)
    R = ray_o.shape[0]
    frac = {k: float(cls[k].mean()) for k in
            ("close", "miss_eq", "flip", "graze", "samepick")}
    ref_mean = ref[0].mean(0).cpu().numpy()
    got_mean = got[0].mean(0).cpu().numpy()
    mean_ok = np.all(np.abs(got_mean - ref_mean)
                     <= MEAN_TOL + MEAN_TOL * np.abs(ref_mean))

    # Tape: codes everywhere; prim and flag words where a replay reads them.
    code_r = (ref[2].flags & PathTape.CODE_MASK).cpu().numpy()
    code_g = (got[2].flags & PathTape.CODE_MASK).cpu().numpy()
    agree = code_r == code_g
    # Closest-hit queries the paths made (bounces reached), per path.
    hits_per_path = float((code_r != 0).sum(0).mean())
    bounced = agree & np.isin(code_r, (1, 2, 4))
    live = agree & (code_r != 0)
    prim_eq = np.all(ref[2].prim.cpu().numpy()[live]
                     == got[2].prim.cpu().numpy()[live])
    flags_eq = np.all(ref[2].flags.cpu().numpy()[bounced]
                      == got[2].flags.cpu().numpy()[bounced])

    # Tape-off specialization: same colours as tape-on, or at worst
    # different only on rays already explained as flips/grazes.
    same_nt = bool(torch.equal(got_nt[0], got[0])
                   and torch.equal(got_nt[1], got[1]))
    cls_nt = classify_mismatches(ref, (got_nt[0], got_nt[1], got[2]),
                                 CLOSE_ATOL, CLOSE_RTOL)
    nt_unexplained = int(((~cls_nt["close"] | ~cls_nt["miss_eq"])
                          & ~(cls["flip"] | cls["graze"])).sum())

    print(f"[compare] {label}: R={R} close_frac={frac['close']:.6f} "
          f"miss_agree={frac['miss_eq']:.6f} flip={frac['flip']:.6f} "
          f"graze={frac['graze']:.6f} samepick={frac['samepick']:.6f} "
          f"codes_agree={agree.mean():.6f} prim_eq={prim_eq} "
          f"bounces_per_path={hits_per_path:.4f} "
          f"flags_eq={flags_eq} means_ref={ref_mean.tolist()} "
          f"means_kernel={got_mean.tolist()} "
          f"max_abs_err_same_path={cls['max_abs_err_same_path']:.3e} "
          f"tape_off_bitwise_equal={same_nt} "
          f"tape_off_unexplained={nt_unexplained}")
    check(np.all(cls["miss_eq"] | cls["flip"]),
          f"{label}: miss flags equal outside flip rays")
    check(frac["close"] >= MIN_CLOSE_FRAC,
          f"{label}: close_frac {frac['close']:.4f} >= {MIN_CLOSE_FRAC}")
    check(mean_ok, f"{label}: channel means within {MEAN_TOL}")
    check(cls["samepick"].sum() == 0, f"{label}: samepick == 0")
    check(agree.mean() >= 0.99, f"{label}: tape codes agree >= 0.99")
    check(prim_eq and flags_eq, f"{label}: tape prim/flags equal where read")
    check(nt_unexplained == 0,
          f"{label}: tape-off kernel differs only on flip/graze rays")
    return cls["max_abs_err_same_path"]


def main():
    # --- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    # The port's own modules; in a directory without the repository this
    # import fails and the run ends here.
    from raytracercore_tpu_torch import kernels
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render.renderer import Renderer, render_pass
    from raytracercore_tpu_torch.scene import loader

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"[device] {torch.cuda.get_device_name(0)} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} python={sys.version.split()[0]}")

    # --- 2. build ----------------------------------------------------------
    info = kernels.build()
    kernels.load()
    print(f"[build] {info['path']} built={info['built']} "
          f"seconds={info['seconds']:.1f}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # --- 3. kernel vs plain on the card -----------------------------------
    max_err = 0.0
    for name, text in (("test_fused", FUSED_TEST_SCENE),
                       ("smooth+ambient_miss", SMOOTH_SCENE),
                       ("cornell", CORNELL_SCENE)):
        for rec in (4, 10):
            inputs = rays_and_uniforms(text, COMPARE_SIZE, rec, 1000 + rec,
                                       dev)
            max_err = max(max_err, compare(
                f"{name} {COMPARE_SIZE}x{COMPARE_SIZE} rec{rec}", *inputs))

    # --- 4. main path: Renderer at 700x700, recursion 10 ------------------
    host = loader.parse(CORNELL_SCENE)
    check((host.width, host.height, host.recursion) == (700, 700, 10),
          "main-path scene is 700x700 rec10")
    r = Renderer(host, device="cuda", seed=0)
    t0 = time.perf_counter()
    r.step(WARM_PASSES)
    warm_s = time.perf_counter() - t0
    r.reset()
    fused.trace_fused.launches = 0
    pass_s = []
    for _ in range(MAIN_PASSES):
        t0 = time.perf_counter()
        r.step(1)
        pass_s.append(time.perf_counter() - t0)
    launches = fused.trace_fused.launches
    st = r.status()
    print(f"[main] launches of trace_fused during {MAIN_PASSES} passes: "
          f"{launches}")
    check(launches == MAIN_PASSES,
          f"main path launched the megakernel once per pass "
          f"({launches} != {MAIN_PASSES})")
    film = r.film
    check(all(bool(torch.isfinite(t).all()) for t in
              (film.color_sum, film.samples, film.misses)),
          "film is finite")
    check(float(film.samples.sum() + film.misses.sum())
          == MAIN_PASSES * 700 * 700, "one sample per pixel per pass")
    img = r.image()
    check(img.shape == (700, 700, 4) and img.dtype == np.uint8,
          "image is 700x700 RGBA uint8")
    check(int(img[..., :3].max()) > 50, "image is lit (max > 50)")
    q = np.percentile(np.asarray(pass_s) * 1e3, [0, 25, 50, 75, 100])
    print(f"[main] cornell 700x700 rec10, {MAIN_PASSES} passes: "
          f"samples/px/sec={st['samples_per_px_per_sec']:.4f} "
          f"paths/sec={st['paths_per_sec']:.4e} "
          f"ms/pass min/p25/median/p75/max="
          f"{'/'.join(f'{x:.3f}' for x in q)} "
          f"warm-up s={warm_s:.3f} ({WARM_PASSES} passes) "
          f"image max={int(img[..., :3].max())} "
          f"mean={float(img[..., :3].mean()):.3f} on {card}")
    print("[main] ms of each pass: "
          + " ".join(f"{x * 1e3:.3f}" for x in pass_s))

    # Kernel and plain version at the main path's shapes: same rays and
    # uniforms, compared, then timed with CUDA events.
    arrays, ray_o, ray_d, uniforms = rays_and_uniforms(
        CORNELL_SCENE, 700, 10, 7, dev)
    max_err = max(max_err, compare("cornell 700x700 rec10", arrays, ray_o,
                                   ray_d, uniforms))
    kernel_ms = cuda_ms(
        lambda: fused.trace_fused(arrays, ray_o, ray_d, uniforms), 10)
    plain_ms = cuda_ms(
        lambda: fused.trace_fused_reference(arrays, ray_o, ray_d, uniforms),
        2)
    kernel_ms2 = cuda_ms(
        lambda: fused.trace_fused(arrays, ray_o, ray_d, uniforms), 10)
    print(f"[time] trace_fused cornell 700x700 rec10: kernel ms="
          f"{kernel_ms:.3f} (again {kernel_ms2:.3f}) plain ms={plain_ms:.3f} "
          f"on {card}")

    # The whole pass with the plain version, for the end-to-end comparison.
    jitter = torch.rand((700 * 700, 4), device=dev)
    film0 = r.film

    def plain_pass():
        render_pass(arrays, r.camera, film0, jitter, uniforms,
                    trace_fn=fused.trace_fused_reference)
    plain_pass_ms = cuda_ms(plain_pass, 2)
    print(f"[time] whole pass with the plain version: ms/pass="
          f"{plain_pass_ms:.3f} samples/px/sec={1e3 / plain_pass_ms:.4f} "
          f"on {card}")

    # --- 5. result lines ---------------------------------------------------
    print(card)
    print(json.dumps({"kernels": [{
        "name": "trace_fused",
        "route": "cuda",
        "source": "raytracercore_tpu_torch/csrc/fused.cu",
        "replaces": "raytracercore_tpu/render/fused.py:56",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
