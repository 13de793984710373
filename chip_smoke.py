#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``raytracercore_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``raytracercore_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card (the
megakernel, the train path's uniforms kernel, the replay forward and
backward kernels), drives the two main paths on a Cornell-class scene at
700×700, recursion 10 — the progressive forward render (``Renderer`` →
camera rays → uniforms → the whole-path megakernel → film → tonemapped
image) and the material-gradient train step (uniforms kernel → megakernel
recorder → replay backward kernel → L2 loss → ``torch.optim.Adam``) — and
prints what it measured.
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

# The geometry of FUSED_TEST_SCENE with materials whose total luminance
# exceeds 1, so the energy compensation max(total, 1) passes gradients to
# Fresnel: IOR and shininess get real gradients (with total < 1
# everywhere, as in the scenes above, those gradients are exactly 0).
ROUGH_SCENE = """
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
specular .5 .5 .5
shininess 40
twosided true
plane -1  0 0 1
diffuse .3 .3 .3
specular .8 .8 .8
shininess 30
refraction .7 .7 .7, 1.5
sphere -0.8 1 0.5 0.6
refraction off
diffuse .4 .4 .4
specular .9 .9 .9
shininess 60
sphere 0.8 1 0.5 0.6
"""

MAIN_PASSES = 16      # timed passes of the forward render
WARM_PASSES = 2       # untimed passes before them (first use loads the kernel)
COMPARE_SIZE = 256    # image size of the kernel-vs-plain comparisons
# Kernel vs plain tolerances (those of tests/test_fused.py): knife-edge f32
# branch flips may change a few whole paths, nothing else may differ.
CLOSE_ATOL = CLOSE_RTOL = 1e-3
MIN_CLOSE_FRAC = 0.97
MEAN_TOL = 5e-3
# Uniforms kernel vs plain: channel 3 (the raw draw) bit for bit, the
# transcendental channels within 1e-6 abs + 4 ulp rel (CUDA's logf, cosf,
# sinf, acosf against torch's calls of the same functions).
UNI_ATOL, UNI_ULPS = 1e-6, 4
# Replay kernels vs plain: same operations in f32, so colours agree to
# 1e-6 abs + 1e-5 rel; gradients are sums over rays in another order (the
# kernel adds with atomics), so each field within 1e-5 of its largest
# plain gradient.
REPLAY_ATOL, REPLAY_RTOL = 1e-6, 1e-5
GRAD_TOL = 1e-5
FIELD_COLS = {"emission": (0, 3), "diffuse": (3, 6), "specular": (6, 9),
              "refraction": (9, 12), "refractive_index": (12, 13),
              "shininess": (13, 14)}
# The train path: target from the scene's own materials, start from every
# non-emissive diffuse halved, Adam.
TARGET_SPP = 32
TRAIN_WARM, TRAIN_STEPS = 2, 20
TRAIN_LR = 1e-2
TRAIN_SEED = 2024
PROFILE_STEPS = 4


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


def device_busy(fn, n):
    """Device busy share of ``n`` calls ``fn(i)`` under torch.profiler: the
    union of the kernels' device intervals over the host span from the
    first call to the final synchronize.  Returns (percent, the top kernels
    by device time per call as text)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events that are kernels; a record_function range (such
    # as Optimizer.step) also shows on the device timeline, spanning the
    # idle gaps between its kernels, and is left out.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in kernels):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    text = "; ".join(f"{name[:50]} {us / n:.1f}" for name, us in top)
    check(busy_us > 0, "the profiler saw device time")
    return 100.0 * busy_us / wall_us, text


def compare_uniforms(dev, n, bounces):
    """Uniforms kernel against its plain version at the train path's
    shape; returns (max abs err, kernel ms, plain ms)."""
    from raytracercore_tpu_torch.render import uniforms_kernel as uk

    seed = 0x9E3779B97F4A7C15
    got = uk.prepare_uniforms_kernel(seed, n, bounces, dev)
    want = uk.prepare_uniforms_reference(seed, n, bounces, dev)
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = UNI_ATOL + UNI_ULPS * torch.finfo(torch.float32).eps * want.abs()
    per_ch = err.amax(dim=(0, 2)).tolist()
    ch3_equal = torch.equal(got[:, 3], want[:, 3])
    print(f"[uniforms] [{bounces},7,{n}] channel 3 bit-equal={ch3_equal} "
          f"max abs err per channel="
          f"{' '.join(f'{x:.3e}' for x in per_ch)} "
          f"within tol={bool((err <= tol).all())}")
    check(bool(torch.isfinite(got).all()), "uniforms kernel output finite")
    check(ch3_equal, "uniforms channel 3 bit-equal to the plain Philox")
    check(bool((err <= tol).all()),
          f"uniforms within {UNI_ATOL} abs + {UNI_ULPS} ulp rel")
    kernel_ms = cuda_ms(
        lambda: uk.prepare_uniforms_kernel(seed, n, bounces, dev), 10)
    plain_ms = cuda_ms(
        lambda: uk.prepare_uniforms_reference(seed, n, bounces, dev), 3)
    return float(err.max()), kernel_ms, plain_ms


def compare_replay(label, arrays, ray_o, ray_d, uniforms):
    """Replay forward and backward kernels against their plain versions
    on a tape the megakernel records; returns (max abs colour err, max abs
    gradient err)."""
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render import replay_kernel as rk

    color_r, miss_r, tape = fused.trace_fused(arrays, ray_o, ray_d,
                                              uniforms, want_tape=True)
    matf, scf = rk.material_table(arrays)
    aim = arrays.ambient_is_miss
    ref_c, ref_m = rk.replay_fwd_reference(ray_d, uniforms, tape, matf, scf,
                                           aim)
    got_c, got_m = rk.replay_fwd(ray_d, uniforms, tape, matf, scf, aim)
    torch.cuda.synchronize()
    fwd_err = float((got_c - ref_c).abs().max())
    fwd_ok = bool(((got_c - ref_c).abs()
                   <= REPLAY_ATOL + REPLAY_RTOL * ref_c.abs()).all())
    check(torch.equal(got_m, ref_m), f"{label}: replay miss equal")
    check(fwd_ok, f"{label}: replay colour within {REPLAY_ATOL} abs + "
          f"{REPLAY_RTOL} rel")

    # dL/d(material table) of L = mean(where(miss, 0, colour)^2): autograd
    # through the plain replay, the hand-written plain backward, the kernel.
    m = matf.clone().requires_grad_(True)
    c, mm = rk.replay_fwd_reference(ray_d, uniforms, tape, m, scf, aim)
    loss = torch.mean(torch.where(mm[:, None], 0.0, c) ** 2)
    ct, g_auto = torch.autograd.grad(loss, (c, m))
    ct = ct.contiguous()
    g_ref = rk.replay_bwd_reference(ray_d, uniforms, tape, matf, scf, aim, ct)
    g_k = rk.replay_bwd(ray_d, uniforms, tape, matf, scf, aim, ct)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(g_k).all()), f"{label}: kernel grads finite")
    worst = {}
    for field, (a, b) in FIELD_COLS.items():
        for name, plain in (("autograd", g_auto), ("hand", g_ref)):
            err = float((g_k[:, a:b] - plain[:, a:b]).abs().max())
            scale = float(plain[:, a:b].abs().max())
            check(err <= GRAD_TOL * scale,
                  f"{label}: {field} grad vs {name} plain: {err:.3e} > "
                  f"{GRAD_TOL} * {scale:.3e}")
            worst[f"{field}/{name}"] = (err, scale)
    bwd_err = max(e for e, _ in worst.values())

    # Record-as-primal: the recorder's colour comes back bit for bit.
    p_c, p_m = rk.replay_fused(arrays, ray_o, ray_d, uniforms, tape,
                               primal=(color_r, miss_r))
    check(torch.equal(p_c, color_r) and torch.equal(p_m, miss_r),
          f"{label}: record-as-primal colour bit-equal to the recorder's")
    rec_err = float((color_r - got_c).abs().max())
    nonzero = int((g_auto != 0).sum())
    print(f"[replay] {label}: fwd max_abs_err={fwd_err:.3e} miss_equal=True "
          f"bwd max_abs_err={bwd_err:.3e} nonzero_grads={nonzero} "
          + " ".join(f"{k}={e:.2e}/{s:.2e}" for k, (e, s) in worst.items()
                     if k.endswith("autograd"))
          + f" recorder_vs_replay_colour_max_diff={rec_err:.3e} "
          f"record_as_primal_bit_equal=True")
    return fwd_err, bwd_err


def train_step_on(trace, optimizer):
    """The step of ``make_train_step(None, optimizer)`` with ``trace(scene,
    ray_o, ray_d, path_seed) → (color, miss)`` in place of its
    ``trace_replay``: the replay-forward route and the all-plain step."""
    from raytracercore_tpu_torch.diff import with_material_params
    from raytracercore_tpu_torch.parallel.shard import image_loss, step_rays

    def step(params, scene, camera, target, seed):
        h, w = target.shape[:2]
        ray_o, ray_d, path_seed = step_rays(camera, h, w, seed)
        color, miss = trace(with_material_params(scene, params), ray_o,
                            ray_d, path_seed)
        loss = image_loss(color, miss, target)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def replay_forward_trace(scene, ray_o, ray_d, path_seed):
    """``trace_replay`` on its replay-forward route: the forward kernel
    recomputes the colour from the tape, so every kernel of the train path
    launches once per step."""
    from raytracercore_tpu_torch.render.replay import trace_replay

    return trace_replay(scene, ray_o, ray_d, seed=path_seed,
                        record_as_primal=False)


def plain_trace(scene, ray_o, ray_d, path_seed):
    """The train path's trace with every kernel replaced by its plain
    version (for the timing comparison only)."""
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render.replay import replay
    from raytracercore_tpu_torch.render.uniforms_kernel import \
        prepare_uniforms_reference

    u = prepare_uniforms_reference(path_seed, ray_o.shape[0],
                                   scene.recursion + 1, ray_o.device)
    with torch.no_grad():
        _, _, tape = fused.trace_fused_reference(scene, ray_o, ray_d, u,
                                                 want_tape=True)
    return replay(scene, ray_o, ray_d, u, tape)


def quartiles(ms):
    return "/".join(f"{x:.3f}" for x in
                    np.percentile(np.asarray(ms), [0, 25, 50, 75, 100]))


def train_path(card, dev):
    """Main path 2: the material-gradient train step at 700x700 rec10.
    Returns {kernel name: launches} summed over both routes' timed steps,
    and the stage times."""
    from raytracercore_tpu_torch.diff import get_material_params
    from raytracercore_tpu_torch.parallel import make_train_step
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render import replay_kernel as rk
    from raytracercore_tpu_torch.render import uniforms_kernel as uk
    from raytracercore_tpu_torch.render.renderer import Renderer, pass_seed
    from raytracercore_tpu_torch.scene import loader

    counters = {"trace_fused": fused.trace_fused,
                "prepare_uniforms_kernel": uk.prepare_uniforms_kernel,
                "replay_fwd": rk.replay_fwd, "replay_bwd": rk.replay_bwd}
    host = loader.parse(CORNELL_SCENE)
    r = Renderer(host, device=dev, seed=TRAIN_SEED)
    r.step(TARGET_SPP)
    film = r.film
    target = film.color_sum / (film.samples + film.misses)[..., None]
    check(bool(torch.isfinite(target).all()) and float(target.max()) > 0.1,
          "train target finite and lit")
    scene, camera = r.arrays, r.camera
    h, w = target.shape[:2]
    n_paths, n_bounces = h * w, scene.recursion + 1
    truth = {k: v.detach() for k, v in get_material_params(scene).items()}
    emissive = truth["emission"].sum(dim=1) > 0

    def start_params():
        p = get_material_params(scene)
        with torch.no_grad():
            p["diffuse"][~emissive] *= 0.5
        return p

    # Printed, not checked: the L2 loss of a one-sample render against a
    # converged target has its expected minimum below the true albedo (at
    # mean^2 / (mean^2 + variance) of it), so from a halved start the
    # diffuse may move away from the truth while the loss falls.
    def diffuse_err(p):
        return float((p["diffuse"].detach() - truth["diffuse"])[~emissive]
                     .abs().mean())

    launches = dict.fromkeys(counters, 0)
    step_ms = {}
    routes = (("record-as-primal", lambda opt: make_train_step(None, opt)),
              ("replay-forward",
               lambda opt: train_step_on(replay_forward_trace, opt)))
    for route, make_step in routes:
        params = start_params()
        adam = torch.optim.Adam(params.values(), lr=TRAIN_LR)
        step = make_step(adam)
        err0 = diffuse_err(params)
        for i in range(TRAIN_WARM):
            step(params, scene, camera, target, pass_seed(TRAIN_SEED, i))
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        losses, times = [], []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = step(params, scene, camera, target,
                        pass_seed(TRAIN_SEED, TRAIN_WARM + i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        counts = {k: f.launches for k, f in counters.items()}
        err1 = diffuse_err(params)
        want = {"trace_fused": TRAIN_STEPS,
                "prepare_uniforms_kernel": TRAIN_STEPS,
                "replay_fwd": (TRAIN_STEPS if route == "replay-forward"
                               else 0),
                "replay_bwd": TRAIN_STEPS}
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        med = float(np.median(times))
        step_ms[route] = med
        print(f"[train] {route}: launches during {TRAIN_STEPS} steps "
              f"{counts} (want {want})")
        print(f"[train] {route}: cornell 700x700 rec10 Adam lr={TRAIN_LR}: "
              f"ms/step min/p25/median/p75/max={quartiles(times)} "
              f"fwd+bwd steps/sec={1e3 / med:.4f} "
              f"wavefront rays/sec={n_paths * n_bounces / (med * 1e-3):.4e} "
              f"loss first5={first:.6f} last5={last:.6f} "
              f"diffuse mean abs err {err0:.5f} -> {err1:.5f} on {card}")
        print(f"[train] {route}: losses "
              + " ".join(f"{x:.6f}" for x in losses))
        print(f"[train] {route}: ms of each step "
              + " ".join(f"{x:.3f}" for x in times))
        check(counts == want, f"{route}: each kernel once per step")
        check(all(np.isfinite(losses)), f"{route}: every loss finite")
        check(last < first, f"{route}: loss falls (mean of last 5 < first 5)")
        for k, n in counts.items():
            launches[k] += n

    # --- where a step's time goes: each stage, kernel against plain -----
    from raytracercore_tpu_torch.parallel.shard import step_rays

    params = start_params()
    adam = torch.optim.Adam(params.values(), lr=TRAIN_LR)
    step = make_train_step(None, adam)
    plain_step = train_step_on(plain_trace, adam)
    step_seed = pass_seed(TRAIN_SEED, 99)
    ray_o, ray_d, path_seed = step_rays(camera, h, w, step_seed)
    u = uk.prepare_uniforms_kernel(path_seed, n_paths, n_bounces, dev)
    _, _, tape = fused.trace_fused(scene, ray_o, ray_d, u, want_tape=True)
    matf, scf = rk.material_table(scene)
    aim = scene.ambient_is_miss
    color, miss = rk.replay_fwd(ray_d, u, tape, matf, scf, aim)
    ct = (torch.where(miss[:, None], 0.0, 2.0 * color)
          / color.numel()).contiguous()

    def autograd_bwd():
        m = matf.clone().requires_grad_(True)
        c, _ = rk.replay_fwd_reference(ray_d, u, tape, m, scf, aim)
        torch.autograd.grad(c, m, ct)

    stages = [
        ("step rays (jitter + camera rays)",
         lambda: step_rays(camera, h, w, step_seed), None, 20, 0),
        ("uniforms", lambda: uk.prepare_uniforms_kernel(
            path_seed, n_paths, n_bounces, dev),
         lambda: uk.prepare_uniforms_reference(path_seed, n_paths, n_bounces,
                                               dev), 20, 3),
        ("record (megakernel, tape on)", lambda: fused.trace_fused(
            scene, ray_o, ray_d, u, want_tape=True),
         lambda: fused.trace_fused_reference(scene, ray_o, ray_d, u,
                                             want_tape=True), 20, 2),
        ("replay forward", lambda: rk.replay_fwd(ray_d, u, tape, matf, scf,
                                                 aim),
         lambda: rk.replay_fwd_reference(ray_d, u, tape, matf, scf, aim),
         20, 3),
        ("replay backward", lambda: rk.replay_bwd(ray_d, u, tape, matf, scf,
                                                  aim, ct),
         lambda: rk.replay_bwd_reference(ray_d, u, tape, matf, scf, aim, ct),
         20, 3),
        ("replay backward vs autograd plain", lambda: rk.replay_bwd(
            ray_d, u, tape, matf, scf, aim, ct), autograd_bwd, 20, 3),
        ("Adam step", adam.step, None, 20, 0),
        ("whole step", lambda: step(params, scene, camera, target, 5),
         lambda: plain_step(params, scene, camera, target, 7), 10, 2),
    ]
    times = {}
    for name, kernel_fn, plain_fn, n_k, n_p in stages:
        k_ms = cuda_ms(kernel_fn, n_k)
        p_ms = cuda_ms(plain_fn, n_p) if plain_fn is not None else None
        times[name] = (k_ms, p_ms)
        print(f"[stage] {name}: kernel path ms={k_ms:.3f} plain ms="
              + (f"{p_ms:.3f}" if p_ms is not None else "n/a")
              + f" on {card}")

    busy, top = device_busy(
        lambda i: step(params, scene, camera, target, 100 + i), PROFILE_STEPS)
    print(f"[profile] {PROFILE_STEPS} train steps: device busy {busy:.1f} % "
          f"of the span on {card}")
    print(f"[profile] top kernels, device us per step: {top}")
    return launches, times, step_ms


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
    fwd_err = bwd_err = 0.0
    for name, text in (("test_fused", FUSED_TEST_SCENE),
                       ("smooth+ambient_miss", SMOOTH_SCENE),
                       ("cornell", CORNELL_SCENE), ("rough", ROUGH_SCENE)):
        for rec in (4, 10):
            inputs = rays_and_uniforms(text, COMPARE_SIZE, rec, 1000 + rec,
                                       dev)
            label = f"{name} {COMPARE_SIZE}x{COMPARE_SIZE} rec{rec}"
            if name != "rough":
                max_err = max(max_err, compare(label, *inputs))
            errs = compare_replay(label, *inputs)
            fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])
    inputs = rays_and_uniforms(CORNELL_SCENE, 700, 10, 17, dev)
    errs = compare_replay("cornell 700x700 rec10", *inputs)
    fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])
    del inputs
    uni_err, uni_ms, uni_plain_ms = compare_uniforms(dev, 700 * 700, 11)
    print(f"[time] prepare_uniforms_kernel [11,7,490000]: kernel ms="
          f"{uni_ms:.3f} plain ms={uni_plain_ms:.3f} on {card}")

    # --- 4. main path 1: Renderer at 700x700, recursion 10 ----------------
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
    busy, top = device_busy(lambda i: r.step(1), 4)
    print(f"[profile] 4 render passes: device busy {busy:.1f} % of the span "
          f"on {card}")
    print(f"[profile] top kernels, device us per pass: {top}")

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

    # --- 5. main path 2: the train step at 700x700, recursion 10 ----------
    train_launches, stage, _ = train_path(card, dev)

    # --- 6. result lines ---------------------------------------------------
    def entry(name, source, replaces, launched, err, ms, p_ms):
        return {"name": name, "route": "cuda",
                "source": f"raytracercore_tpu_torch/csrc/{source}",
                "replaces": f"raytracercore_tpu/render/{replaces}",
                "launches": launched, "max_abs_err": err, "ms": ms,
                "plain_ms": p_ms}

    print(card)
    print(json.dumps({"kernels": [
        entry("trace_fused", "fused.cu", "fused.py:56",
              launches + train_launches["trace_fused"], max_err, kernel_ms,
              plain_ms),
        entry("prepare_uniforms_kernel", "uniforms.cu",
              "uniforms_kernel.py:64",
              train_launches["prepare_uniforms_kernel"], uni_err, uni_ms,
              uni_plain_ms),
        entry("replay_fwd", "replay.cu", "replay_kernel.py:163",
              train_launches["replay_fwd"], fwd_err,
              *stage["replay forward"]),
        entry("replay_bwd", "replay.cu", "replay_kernel.py:193",
              train_launches["replay_bwd"], bwd_err,
              *stage["replay backward"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
