#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``raytracercore_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``raytracercore_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version on the card (the
megakernel, the train path's uniforms kernel, the replay forward and
backward kernels, the per-bounce select kernel, the BVH traversal kernel,
the per-bounce shading kernel of ``trace``), and drives the main paths,
the first three at 700×700, recursion 10:

1. the progressive forward render of a Cornell-class scene (``Renderer`` →
   camera rays → uniforms → the whole-path megakernel → film → image);
2. its material-gradient train step (uniforms kernel → megakernel recorder
   → replay backward kernel → L2 loss → ``torch.optim.Adam``);
3. the forward render of a 722-triangle mesh scene, above the megakernel's
   cap (``Renderer`` → the integrator's bounce loop, one launch of the
   select kernel and one of the shading kernel per bounce), and that
   scene's train step (uniforms kernel → the bounce loop as recorder →
   replay forward and backward kernels);
4. the forward render of a 184,322-triangle mesh scene at 512×512,
   recursion 4, above the dense tier (``Renderer`` → the native BVH
   builder → the bounce loop, one launch of the traversal kernel per
   bounce, which writes the bounce's final hit record in its epilogue), in
   three forms: the default, the other ``sort=`` (the rays of
   every BVH query ordered by the key kernel and ``torch.sort``, the
   traversal kernel reading that order) with a bit-equal film, and 32×32
   tiles with the sort, bit-equal to the row-major pass on the reordered
   draws; and one pass of a 1,003,522-triangle scene at 1024×1024;
5. the train step of a 46,082-triangle mesh scene at 512×512, recursion 4
   (uniforms kernel → the bounce loop with the traversal kernel as recorder
   → replay forward and backward kernels reading the 46,082-row material
   table from device memory);

(every bounce loop on the card shades through the shading kernel, one
launch a bounce) and prints what it measured: every kernel's registers,
spills and occupancy beside its time (from the build's ``-Xptxas -v``
log, at the block size and shared memory of its launch); the
megakernel, the uniforms kernel and the replay kernels by CUDA-graph
replay; for the two closest-hit kernels every bounce's launch beside
its own bound, each kernel the wrapper launches
(the select kernel's list, main and finish kernels) by the profiler, and
the per-pass sums; both kernels are also held against their
plain versions with parked lanes mixed in, all lanes parked, none parked
and a ragged ray count, and one call of each runs under
``torch.cuda.set_sync_debug_mode("error")``.  The BVH tier's ray
coherence: the key kernel bit-equal to its plain version, the sorted
traversal bit-equal to the unsorted one (all 12 outputs and both
counters) on three leaf kinds, mesh-184k and mesh-1M, where the kernel
(a walk of 4-wide nodes) is also held bit-equal to its plain version and
to the binary skip-link walk (the 12 outputs, the records tested); its
record form, the one the main path launches, is held bit-equal to the
plain chain (``record_reference`` on the plain walk) tree after tree,
merged into the tree before where two trees hit, and every traversal
launch of the main paths is counted as one that wrote the record; each
bounce of
both scenes timed sorted and unsorted with its parts and the warp
efficiency of both launch orders, and one mesh-46k train step sorted
bit-equal to the unsorted one.  A phase of its own runs the
issue-rate probe (``tools/issue_probe.py``, the port of the TPU's VPU
microbenchmark): every mix against its plain chains, then the operations
per second the card sustains under ``-fmad=false``.
The surface phase (:func:`surface_phase`) drives the rest of the public
surface at full width: ``Film.add_scatter`` on a cornell pass in 32×32
tile order (bit-equal to ``add_full_frame``) and on 4× repeated indices,
``Film.merge`` against ``step(8)``, ``Renderer(dtype=torch.float64)``
against the float32 one (rays classified, samepick 0), ``Renderer.profile``
read back scope by scope on cornell and mesh-184k, and
``trace_replay(record_fused=False)`` / ``(replay_kernel=False)``.
The megakernel is held bit-equal to its plain version (colour, miss and
all five tape planes, tape on and off).  The shading kernel
(:func:`shade_stage`) is held bit-equal to ``shade_bounce_reference`` on
every bounce of mesh-722 and mesh-184k, in float32 and float64, tape and
records off and on, and on the lane variants; every bounce is timed
beside its bound.
The graph phase (:func:`graph_phase`) holds the graphed main path — each
pass and single-device step captured once as a CUDA graph and replayed,
the package's default on the card — against the eager one on every
route: cornell, mesh-722 and mesh-184k passes (films bit-equal, also
after ``next_camera``, ``load_checkpoint``, ``reset`` and for the
module-level ``render_passes``), one mesh-1M pass (in
:func:`bvh_big_pass`), and cornell, mesh-722, mesh-46k and a small
``use_replay=False`` train step (losses bit-equal, gradients within
1e-5·max|g|, params equal to Adam on the graph's gradient); the bounce
loop's passes and steps also against the same runs with the plain bounce
body (``shade_fn=shade_bounce_reference``: films and losses bit-equal,
gradients within 1e-5·max|g|); one graphed
call of each runs without a host sync, and the kernels a replay runs are
read from the graph itself.  Times, busy shares, capture ms, graph pools
and kernel nodes are printed, never gated.  Main path 1 runs the default
(graphed) ``Renderer``; the other phases build theirs with
``graphs=False``: they hold kernels and paths, not the graphs.
Every phase runs inside :func:`phase`, which prints its seconds; a failed
gate or an exception prints ``chip_smoke: FAILED in phase <name>: ...``
as the last line of standard output and exits 1.
The last two lines of standard output are a JSON object describing the
kernels and a JSON object ``{"ok": true, "device": ...}``.  Any failed
check exits non-zero before those lines.  Without a CUDA device it exits
non-zero at once.  It imports nothing of JAX.

To compare two trees on one card, in one call::

    python3 chip_smoke.py --times --root PARENT_CHECKOUT --label parent
    python3 chip_smoke.py --times --label change

``--times`` (:func:`times_main`) only builds the tree's kernels and times
the megakernel, the replay forward and backward and the select kernel at
the main paths' shapes, each held against its plain version first (the
replay forward bit-equal, with the bytes of the bounces the paths reach
and the rate achieved over them); it prints one JSON line.

``--trace-pass`` (:func:`trace_pass_main`) holds the bounce loop's pass
without eager glue (``integrator.trace_pass``: the camera kernel, then
each bounce's closest hit and the shading kernel's pass form) against the
chain it replaces on mesh-722 at 700x700 rec10 and mesh-184k at 512x512
rec4, films of 8 passes on 3 seeds bit-equal; times both by CUDA-graph
replay and graphed ``Renderer`` passes, with each kernel's device time a
pass; prints the new kernels' registers and spills; and, with ``--parent
CHECKOUT``, diffs the SASS of every function of ``csrc/*.cu`` against the
parent's (``cuobjdump -sass``), the shading kernel's ``[7, R]`` forms
mapped to their names before the pass form's flag::

    python3 chip_smoke.py --trace-pass --parent PARENT_CHECKOUT
"""

from __future__ import annotations

import contextlib
import copy
import json
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch


def cornell_scene():
    """The Cornell-class scene in the reference's text format (the class of
    the reference's bounce.txt: an inverted room of differently coloured
    walls, an emissive light box at the ceiling, a rotated diffuse cube, a
    diffuse sphere, a glass ellipsoid, a mirror sphere and one two-sided
    plane): the port's ``parallel.worker.CORNELL_SCENE``, imported at the
    call so that ``--times --root`` reads the tree it times."""
    from raytracercore_tpu_torch.parallel.worker import CORNELL_SCENE

    return CORNELL_SCENE


# The geometry of parallel.worker.FUSED_TEST_SCENE with materials whose
# total luminance exceeds 1, so the energy compensation max(total, 1)
# passes gradients to Fresnel: IOR and shininess get real gradients (with
# total < 1 everywhere, as in the other scenes, those gradients are
# exactly 0).
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
# The megakernel is held bit-equal to its plain version; where a colour
# differs, rays are sorted into flip / graze / samepick
# (fused.classify_mismatches) at 1e-3 abs + rel.  The trace + select route
# against the megakernel (the tolerances of tests/test_fused.py):
# knife-edge f32 branch flips may change a few whole paths, nothing else
# may differ.
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
# Select kernel vs plain version: the same passes in the same operation
# order, so all 13 outputs are held bit-equal.  Against the grid oracle
# (other formulas for the winner's position and normal): floats within
# 1e-4 · (1 + t) where both name the same primitive (a hit's f32 error
# grows with the ray's length t, and a unit-size sphere's normal carries its
# position's error), except at tangent grazes; rays naming different
# primitives (coplanar surfaces, shared edges) and grazes are counted and
# must stay below 1e-3 of the rays.
ORACLE_TOL = 1e-4
ORACLE_MAX_MISMATCH = 1e-3
GRAZE_COS = 0.3     # |normal . direction| below this is a tangent graze
# Main path 3 and its train step.
MESH_GRID, MESH_SUBDIV = 3, 1         # 9 icospheres x 80 + 2 = 722 triangles
MESH_TARGET_SPP = 8
MESH_TRAIN_WARM, MESH_TRAIN_STEPS = 2, 5
# The BVH tier.  Traversal kernel vs plain version: the same walk and the
# same leaf tests in the same operation order, so all outputs (row, t, the
# ten detail planes, the two counters) are held bit-equal.  Against the grid
# oracle, on a sample of the rays: the tolerances of the select kernel.
BVH_SIZE, BVH_REC = 512, 4
BVH_PASSES = 16
BVH_MESH = (12, 3)                    # 144 icospheres x 1280 + 2 = 184,322
BVH_TRAIN_MESH = (3, 4)               # 9 icospheres x 5120 + 2 = 46,082
BVH_BIG_MESH, BVH_BIG_SIZE = (14, 4), 1024   # 196 x 5120 + 2 = 1,003,522
BVH_FIELD_GRID = 17                   # 289 spheres: a BVH of their own
BVH_LEAF_SIZES = (1, 2, 3, 4, 8, 16)  # timed in turn on main path 4
ORACLE_SAMPLE = 16384
# The port's kernels one wrapper call launches: the select kernel's list,
# main and finish kernels; the traversal's walk (and the key kernel before
# it where the rays are sorted).
SELECT_KERNELS, TRAVERSE_KERNELS = 3, 1
# Ray coherence on the BVH tier: the tile of the JAX package's large-scene
# configuration (tile 32 and the sort), the lanes of a warp for the warp
# efficiency, and the largest key (direction bin 7, Morton code all ones:
# a parked lane's).
BVH_TILE = 32
WARP = 32
KEY_MAX = (1 << 27) - 1
# Registers, stack, spills and static shared memory of every kernel of the
# build, from its log (main fills it), and the threads per block of their
# launches (csrc/*.cu), for their occupancy.
BUILD_REGS = {}
STACK_DEPTHS = []   # every wide tree's stack depth (record_stack_depths)
FUSED_THREADS = TRAVERSE_THREADS = 128
UNIFORMS_THREADS = SELECT_THREADS = LIST_THREADS = TONEMAP_THREADS = 256
# The main paths' image() stages (image_stage), by path.
IMAGE_STAGES = {}
# Peak rates of one H100 SXM (NVIDIA's data sheet): fp32 outside the tensor
# cores, and device memory.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# PCIe Gen5 x16, one direction: the tonemap kernel's store to host memory.
PEAK_PCIE_BYTES = 64e9
# fp32 operations per table row up to the row's first exit, which every
# (ray, row) pair runs, counted from csrc/kernel_body.cuh: a triangle's
# Moller-Trumbore (two cross products, four dot products, one division and
# the coplanar test), a sphere's object-space ray and discriminant, a
# plane's two dot products and division; and the work behind the exit (hit
# position, normal, skip test), run for the few candidates that get there.
OPS_TRI, OPS_SPH, OPS_PLN, OPS_HIT = 52, 63, 13, 40
OPS_SHADE = 150           # one bounce of shading (fused.cu, replay.cu fwd)
OPS_SHADE_BWD = 600       # its hand-written adjoint (replay.cu backward)
OPS_UNIFORMS = 245        # per path and bounce: 5 Philox draws + 7 channels
# csrc/traverse.cu: a box test is the slab test (6 subtractions, 6
# products, 12 min/max, 3 comparisons), W of them a wide fetch; a leaf
# record up to its first exit
# is the triangle's Moller-Trumbore without the coplanar test, the sphere's
# discriminant on the normalized direction, or the ellipsoid's object-space
# ray and discriminant.
OPS_NODE = 27
OPS_LEAF = {"tri": OPS_TRI - 6, "sph": 24, "spht": OPS_SPH}
# csrc/traverse.cu sort_key_kernel per ray and axis: a subtraction, a
# division, a clip (max, min) and a product for the origin, a product, a sum,
# a clip and a product for the direction (the integer bit work aside).
OPS_KEY = 30


# The issue-rate probe: chains checked against the plain version at a few
# trips (relative error: exp may differ in its last bits), timed at many.
PROBE_CHECK_ITERS, PROBE_ITERS, PROBE_RTOL = 4, 2048, 1e-6


# The phase main() is in, named on the line a failure prints, and the
# seconds each finished phase took.
PHASE = ["start"]
PHASE_SECONDS = {}
T0 = [time.perf_counter()]


def fail(what):
    """Print ``chip_smoke: FAILED in phase <phase>: <what>`` as the last
    line of standard output and exit non-zero."""
    msg = (f"chip_smoke: FAILED in phase {PHASE[0]}: "
           + " | ".join(str(what).splitlines()))
    sys.stderr.flush()
    print(msg, flush=True)
    raise SystemExit(1)


def check(cond, what):
    """A gate: ``what`` names the route and the compared numbers."""
    if not cond:
        fail(what)


@contextlib.contextmanager
def phase(name):
    """A top-level phase: its gates and any exception it raises fail the
    run naming it; its seconds are printed and kept."""
    PHASE[0] = name
    t0 = time.perf_counter()
    try:
        yield
    except SystemExit:
        raise
    except BaseException as exc:
        traceback.print_exc()
        fail(f"{type(exc).__name__}: {exc}")
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"[phase] {name} s={PHASE_SECONDS[name]:.1f}", flush=True)


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


def image_stage(card, r, label):
    """``r.image()`` on a main path's CUDA float32 film, the tonemap
    kernel's route: one ``tonemap_pack`` launch an image, 0 differing bytes
    against the chain ``Film.to_uint8`` and its copy at exposure 1 and 1.5;
    the kernel's device ms (launches queued behind a wait on the card, so
    that the host's issue rate does not count), the chain's (a CUDA graph,
    its copy to the host aside), the host ms of an image on each route, and
    the kernel's bound: the film read from device memory, the image stored
    across PCIe.  Kept in ``IMAGE_STAGES[label]`` and returned."""
    from raytracercore_tpu_torch.render import tonemap_kernel as tk

    film, s = r.film, r.arrays
    bg, ba = s.background_rgb, s.background_alpha
    h, w = film.shape
    check(tk.takes(film), f"{label}: the film takes the tonemap kernel")
    differ, launched = {}, []
    for exposure in (1.0, 1.5):
        want = film.to_uint8(bg, ba, exposure).cpu().numpy()
        tk.tonemap_pack.launches = 0
        got = r.image(exposure)
        launched.append(tk.tonemap_pack.launches)
        differ[exposure] = int((got != want).sum())
    check(launched == [1, 1], f"{label}: one tonemap_pack launch an image() "
          f"({launched})")
    check(differ == {1.0: 0, 1.5: 0}, f"{label}: image() bit-equal to "
          f"Film.to_uint8 (differing bytes by exposure: {differ})")

    def host_ms(fn, n=20):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    chain_host = host_ms(lambda: film.to_uint8(bg, ba, 1.0).cpu().numpy())
    image_host = host_ms(r.image)
    packer = tk.Packer(film, bg, ba)
    packer()
    torch.cuda.synchronize()
    n = 200
    torch.cuda._sleep(100_000_000)
    ms = cuda_ms(packer, n)
    plain_ms = graph_ms(lambda: film.to_uint8(bg, ba, 1.0), 20)
    hbm = nbytes(*film.tensors(), bg, ba)
    pcie = h * w * 4
    bnd = max((hbm / PEAK_BYTES * 1e3, "bytes"),
              (pcie / PEAK_PCIE_BYTES * 1e3, "PCIe bytes"))
    print(f"[time] tonemap_pack_kernel {label} {w}x{h}: differing bytes "
          f"{differ}; kernel device ms={ms:.5f} (into pinned memory) "
          f"plain ms={fmt_ms(plain_ms)} (the chain, graphed, its copy "
          f"aside); host ms an image: image() {image_host:.4f}, the chain "
          f"and its pageable copy {chain_host:.4f}; bound ms={bnd[0]:.5f} "
          f"({bnd[1]}: {hbm / (h * w):.0f} B a pixel read, 4 B stored to "
          f"the host) on {card}; "
          + occupancy_text("tonemap_pack_kernel", TONEMAP_THREADS))
    IMAGE_STAGES[label] = {"ms": ms, "plain_ms": plain_ms, "bound": bnd,
                           "launches": sum(launched),
                           "differ": max(differ.values())}
    return IMAGE_STAGES[label]


def bound(ops, n_bytes):
    """The least time the card could take for ``ops`` fp32 operations and
    ``n_bytes`` bytes moved (each input read once, each output written
    once): ``(ms, "operations" | "bytes")``."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def fwd_reached_bytes(tape, matf, scf):
    """Bytes the replay forward's function needs on this tape, by each
    bounce's code (csrc/replay.cu ``shade_v`` and ``advance_with``): the
    flags of every bounce a path reaches (4 bytes; all a Missed bounce
    needs); the prim of every other one (4: its material row; a terminal
    code needs no more); the normal and uniform channels 0-2 of a bounce
    that goes on (Diffuse, Specular, Transmitted: 24), and channels 4-6 of
    a Diffuse one (12; channel 3 is never read); per path its direction,
    colour and miss (28); the table and scalars once."""
    from raytracercore_tpu_torch.render.integrator import BounceType as BT

    code = tape.flags & 0xF

    def count(*codes):
        return sum(int((code == c).sum()) for c in codes)

    reached = tape.flags.numel() - count(BT.SKIPPED)
    return (4 * reached + 4 * (reached - count(BT.MISSED))
            + 24 * count(BT.DIFFUSE, BT.SPECULAR, BT.TRANSMITTED)
            + 12 * count(BT.DIFFUSE)
            + tape.flags.shape[1] * 28 + nbytes(matf, scf))


def kernel_us(fn, n, expect):
    """Device time of every kernel that ``n`` calls ``fn()`` launch, by
    torch.profiler: ``{kernel name: us per call}`` (the name without its
    argument list).  ``expect`` is the number of the port's kernels one
    call launches; a trace that holds fewer (the profiler may drop events)
    is taken again, up to three times, and then reported empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        by_name, ours = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(
                    e, "is_user_annotation", False):
                name = e.name.split("(")[0].replace("void ", "")
                by_name[name] = by_name.get(name, 0.0) + \
                    e.time_range.elapsed_us() / n
                ours += name.startswith("rtc::")
        if ours == expect * n:
            return by_name
    return {}


def graph_ms(fn, n, calls=1):
    """Device time of one call ``fn()``: ``calls`` calls captured once in a
    CUDA graph, the graph replayed ``n`` times between CUDA events, so that
    no host work sits between the launches (``calls`` > 1 for a kernel of a
    few microseconds, shorter than the launch of a graph).  None where the
    capture fails."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as err:
        print(f"[time] CUDA graph capture failed "
              f"({str(err).splitlines()[0][:120]}): not measured")
        return None
    graph.replay()
    ms = cuda_ms(graph.replay, n) / calls
    del graph
    return ms


def ptxas_registers(log):
    """``{kernel: (registers, stack bytes, spill store bytes, static shared
    bytes)}`` from nvcc's ``-Xptxas -v`` output, the kernel named as
    ``rtc::name<template arguments>`` as far as the mangled name gives
    it."""
    import re

    out, name, props = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, props = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if name and m:
            props = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            stack = re.search(r"(\d+) bytes cumulative stack", line)
            smem = re.search(r"(\d+) bytes smem", line)
            short = re.sub(r"^_ZN3rtc\d+", "", name)
            out[short] = (int(m.group(1)),
                          max(props[0], int(stack.group(1)) if stack else 0),
                          props[1], int(smem.group(1)) if smem else 0)
            name = None
    return out


def occupancy(regs, threads, smem=0):
    """``(blocks, share)``: blocks of ``threads`` threads with ``regs``
    registers a thread and ``smem`` bytes of shared memory a block that stay
    resident on one H100 SM, and the share of the SM's 64 warps they fill.
    The SM has 64K registers (allocated in 256s a warp), 2048 threads, 32
    blocks and 228 KB of shared memory (allocated in 128-byte units, 1 KB
    of it reserved per block)."""
    warps = -(-threads // 32)
    per_warp = -(-max(regs, 1) * 32 // 256) * 256
    per_block = -(-smem // 128) * 128 + 1024
    blocks = min(65536 // per_warp // warps, 2048 // threads, 32,
                 233472 // per_block)
    return blocks, blocks * warps / 64


def occupancy_text(prefix, threads, smem=0):
    """Registers, stack, spills and occupancy of the build's kernels whose
    name starts with ``prefix`` (a string or a tuple of them: every
    template instantiation; occupancy at the most registers), at the block size and dynamic shared memory of
    their launch, from the build log (:func:`ptxas_registers`)."""
    rows = [v for k, v in BUILD_REGS.items() if k.startswith(prefix)]
    if not rows:
        return f"{prefix} not in the build log"
    regs = sorted({r[0] for r in rows})
    static = max(r[3] for r in rows)
    blocks, share = occupancy(regs[-1], threads, smem + static)
    reg_text = (f"{regs[0]}-{regs[-1]}" if len(regs) > 1 else f"{regs[0]}")
    return (f"{reg_text} registers, {max(r[1] for r in rows)} bytes stack, "
            f"{max(r[2] for r in rows)} bytes spilled; {blocks} blocks of "
            f"{threads} threads per SM at {smem + static} bytes shared, "
            f"occupancy {share:.3f}")


def replay_occupancy(kind, n_mats, n_bounces, aim=False, n_paths=None):
    """:func:`occupancy_text` of the replay kernel ``kind`` ("fwd" or
    "bwd") that a launch over ``n_mats`` material rows and ``n_bounces``
    bounces runs (``aim``: the scene's ambient_is_miss), at its shared
    memory (csrc/replay.cu: the table, and for the backward its accumulator
    and, where the wrapper puts it there, the ``[bounce][6][thread]``
    stash; the forward has none).  For the forward over ``n_paths`` paths
    (one block per ``REPLAY_BLOCK``) also the resident warps per SM of the
    grid really launched: the block occupancy or the grid's blocks per SM,
    whichever is smaller."""
    from raytracercore_tpu_torch.render import replay_kernel as rk

    if kind == "fwd":
        # Template argument <ambient_is_miss>.
        prefix = f"replay_fwd_kernelILb{int(aim)}E"
        text = occupancy_text(prefix, rk.REPLAY_BLOCK)
        rows = [v for k, v in BUILD_REGS.items() if k.startswith(prefix)]
        if not rows:
            return text
        blocks, _ = occupancy(max(r[0] for r in rows), rk.REPLAY_BLOCK,
                              max(r[3] for r in rows))
        grid = -(-n_paths // rk.REPLAY_BLOCK)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        warps = min(blocks, grid / sms) * rk.REPLAY_BLOCK / 32
        return (f"{text}; grid {grid} blocks = {grid / sms:.2f} per SM, "
                f"resident warps per SM {warps:.2f} ({warps / 64:.3f})")
    table = n_mats * rk.C * 4 if n_mats <= rk.MAX_KERNEL_MATS else 0
    prefix = ("replay_bwd_regen_kernel" if rk._regenerates(n_mats)
              else "replay_bwd_kernel")
    # Template arguments <ambient_is_miss, global table, shared stash>.
    sh = rk.shared_stash(n_mats, n_bounces, aim, "cuda")
    stash = n_bounces * 6 * rk.REPLAY_BLOCK * 4 * sh
    prefix = tuple(f"{prefix}ILb{a}ELb{int(table == 0)}ELb{int(sh)}E"
                   for a in (0, 1))
    return occupancy_text(prefix, rk.REPLAY_BLOCK, 2 * table + stash)


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def parts_text(parts):
    return " ".join(f"{name}={us:.1f}" for name, us in sorted(parts.items()))


def check_no_sync(what, fn):
    """One call of ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``:
    any host synchronisation PyTorch sees in it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[sync] {what}: one call under torch.cuda.set_sync_debug_mode("
          f"'error') ran without a host synchronisation")


def parked(o):
    """Lanes whose origin is the integrator's parking point in all three
    coordinates (finished paths)."""
    from raytracercore_tpu_torch.config import PARKED_ORIGIN

    return (o == PARKED_ORIGIN).all(1)


def lane_variants(query, seed):
    """Queries made from ``query`` for the kernel-vs-plain gates: parked
    lanes mixed in at random, every lane parked, no lane parked, and a
    ragged R (not a multiple of a warp or a block): ``[(name, query)]``."""
    from raytracercore_tpu_torch.config import PARKED_ORIGIN

    o, d, skip = query
    R = o.shape[0]
    gen = torch.Generator(device=o.device)
    gen.manual_seed(seed)
    mix = torch.rand(R, generator=gen, device=o.device) < 0.5
    p_o = torch.full_like(o, PARKED_ORIGIN)
    p_d = torch.zeros_like(d)
    p_d[:, 0] = 1.0

    def park(mask):
        return (torch.where(mask[:, None], p_o, o).contiguous(),
                torch.where(mask[:, None], p_d, d).contiguous(), skip)
    live = torch.nonzero(~parked(o))[:, 0]
    n_rag = R - 37 if R > 64 else R - 1
    return [("parked at random", park(mix)),
            ("all parked", park(torch.ones_like(mix))),
            (f"none parked (R={live.numel()})", take_rays(query, live)),
            (f"ragged R={n_rag}", take_rays(query, torch.arange(
                n_rag, device=o.device)))]


def row_ops(scene, coplanar=True):
    """fp32 operations of one closest-hit query of one ray, up to every
    row's first exit (padding rows cost nothing)."""
    n_tri = int((scene.triangles.prim_id >= 0).sum())
    n_sph = int((scene.spheres.prim_id >= 0).sum())
    n_pln = int((scene.planes.prim_id >= 0).sum())
    per_tri = OPS_TRI if coplanar else OPS_TRI - 6
    return n_tri * per_tri + n_sph * OPS_SPH + n_pln * OPS_PLN


def lit_mesh_scene(grid, subdiv, size, recursion, dev):
    """``scene.meshgen.make_mesh_scene`` with its light quad made two-sided:
    ``(SceneArrays, HostCamera)``.  The generator's light faces up and is
    single-sided: the camera above sees it, but it lights nothing below,
    every bounced path ends in the ambient colour and no colour depends on
    a diffuse material.  Two-sided, it lights the mesh and the train step
    has material gradients."""
    import dataclasses

    from raytracercore_tpu_torch.scene import meshgen

    arrays, cam, _ = meshgen.make_mesh_scene(
        grid=grid, subdiv=subdiv, recursion=recursion, width=size,
        height=size, device=dev)
    two_sided = arrays.materials.two_sided.clone()
    two_sided[-1] = True
    return dataclasses.replace(arrays, materials=dataclasses.replace(
        arrays.materials, two_sided=two_sided)), cam


def camera_rays_and_uniforms(scene, host_camera, size, seed, dev):
    """Jittered camera rays and path uniforms of a ``size`` x ``size``
    frame."""
    from raytracercore_tpu_torch.render import camera as cam_mod
    from raytracercore_tpu_torch.render.integrator import prepare_uniforms
    from raytracercore_tpu_torch.scene.types import init_camera

    cam = init_camera(host_camera, size, size, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    px, py = cam_mod.pixel_grid(size, size, device=dev)
    jitter = torch.rand((size * size, 4), generator=gen, device=dev)
    ray_o, ray_d = cam_mod.camera_rays(cam, px, py, jitter)
    uniforms = prepare_uniforms(gen, size * size, scene.recursion + 1, dev)
    return ray_o.contiguous(), ray_d.contiguous(), uniforms


def closest_hit_queries(scene, ray_o, ray_d, uniforms, closest_fn=None):
    """The closest-hit inputs ``(ray_o, ray_d, skip)`` of every bounce of a
    ``trace`` of these rays through ``closest_fn`` (by default the select
    kernel): real secondary rays with their previous hit as skip record."""
    from raytracercore_tpu_torch.intersect.cuda_select import \
        closest_hit_fused
    from raytracercore_tpu_torch.render.integrator import trace

    if closest_fn is None:
        closest_fn = closest_hit_fused
    queries = []

    def spy(s, o, d, skip):
        queries.append((o.contiguous(), d.contiguous(), skip))
        return closest_fn(s, o, d, skip)

    with torch.no_grad():
        color, _ = trace(scene, ray_o, ray_d, None, closest_fn=spy,
                         uniforms=uniforms)
    check(bool(torch.isfinite(color).all()), "traced colours finite")
    return queries


def grid_closest_hit(scene, ray_o, ray_d, skip):
    """``dispatch.closest_hit`` with its selection from the dense grid scan
    of ``torch_ref`` on the card too (a select hook that is not the default
    keeps the dispatch from taking the kernel's selection): the oracle that
    shares no code with the kernel."""
    from raytracercore_tpu_torch.intersect import dispatch

    return dispatch._closest_from_tri_select(
        scene, ray_o, ray_d, skip,
        lambda *args: dispatch._triangle_select_dense(*args))


def max_curvature(scene):
    """The largest curvature of the scene's spheres and ellipsoids (semi-axes
    a >= ... >= c: a / c^2), at least 1: a unit normal moves by the position
    error times the curvature, so this scales the normals' tolerance."""
    sph = scene.spheres
    ok = sph.prim_id >= 0
    if not bool(ok.any()):
        return 1.0
    axes = torch.linalg.svdvals(sph.obj_to_world[ok][:, :3, :3].cpu())
    axes = axes * sph.radius[ok].cpu()[:, None]
    return max(1.0, float((axes[:, 0] / axes[:, -1] ** 2).max()))


def against_oracle(tag, label, rec, want, d, normal_factor=1.0):
    """A kernel route's hit record ``rec`` against another route's ``want``
    (the grid oracle, or a second kernel route) for rays of directions
    ``d``, every differing ray classified: another primitive (a flip; at the
    same t a tie on a shared edge or coplanar surfaces), the same primitive
    with floats beyond ``ORACLE_TOL`` * (1 + t) at a tangent graze, or the
    same primitive with other floats elsewhere (a samepick: a fault).
    Normals are held to ``normal_factor`` times that tolerance (see
    :func:`max_curvature`).  Checks flips + grazes <=
    ``ORACLE_MAX_MISMATCH`` of the rays and samepick == 0."""
    R = d.shape[0]
    same = (rec.prim == want.prim)
    both = same & (want.prim >= 0)
    tol_t = ORACLE_TOL * (1.0 + want.t.abs())
    off = both & (
        ((rec.t - want.t).abs() > tol_t)
        | ((rec.position - want.position).abs() > tol_t[:, None]).any(1)
        | ((rec.normal - want.normal).abs()
           > normal_factor * tol_t[:, None]).any(1)
        | (rec.inside != want.inside))
    # A hit near the tangent of a curved surface: the root is the small
    # difference of large numbers, and two f32 formulas land apart.
    graze = off & ((want.normal * d).sum(1).abs() < GRAZE_COS)
    n_off, n_graze = int(off.sum()), int(graze.sum())
    n_diff = int((~same).sum())
    tie = (~same & (rec.prim >= 0) & (want.prim >= 0)
           & ((rec.t - want.t).abs() <= tol_t))
    print(f"[{tag}] {label}: R={R} "
          f"found={float((want.prim >= 0).float().mean()):.4f} "
          f"prim differs on {n_diff} rays (same-t ties {int(tie.sum())}), "
          f"floats beyond {ORACLE_TOL} on {n_off} rays of equal prim "
          f"({n_graze} tangent grazes, {n_off - n_graze} samepick)")
    for r in torch.nonzero(off & ~graze)[:5, 0].tolist():
        print(f"[{tag}]   samepick ray {r}: prim {int(want.prim[r])} "
              f"|n.d|={float((want.normal[r] * d[r]).sum().abs()):.4f} "
              f"t {float(rec.t[r]):.6f} vs {float(want.t[r]):.6f} "
              f"position err "
              f"{float((rec.position[r] - want.position[r]).abs().max()):.3e} "
              f"normal err "
              f"{float((rec.normal[r] - want.normal[r]).abs().max()):.3e} "
              f"inside {bool(rec.inside[r])} vs {bool(want.inside[r])}")
    check(n_diff + n_graze <= ORACLE_MAX_MISMATCH * R,
          f"{label}: {n_diff} prim flips + {n_graze} grazes, more than "
          f"{ORACLE_MAX_MISMATCH} of the rays")
    check(n_off == n_graze, f"{label}: t/position/normal/inside within "
          f"{ORACLE_TOL} outside tangent grazes (samepick == 0)")


def select_outputs(select_all, closest_hit, scene, o, d, skip):
    """All 13 outputs of one closest-hit query through the two public entry
    points (``select_all``: the four per-table planes as clamped rows,
    any-flags and the near-root flag; ``closest_hit_fused``: the record's
    nine), kernel or plain, as ``{name: tensor}``."""
    from raytracercore_tpu_torch.core import vecmath as vm

    tri, sph, pln = select_all(scene, o, d, skip,
                               vm.near_enough(torch.float32),
                               vm.POSITION_EPS_F32)
    rec = closest_hit(scene, o, d, skip)
    return {"tri_idx": tri[0], "tri_any": tri[1], "sph_idx": sph[0],
            "sph_near": sph[1], "sph_any": sph[2], "pl_idx": pln[0],
            "pl_any": pln[1], "t": rec.t, "prim": rec.prim,
            "inside": rec.inside, "position": rec.position,
            "normal": rec.normal}


def select_case(label, scene, o, d, skip):
    """The select kernel against its plain version on one query: all 13
    outputs bit for bit, through the wrappers ``select_all`` and
    ``closest_hit_fused``.  Returns the max abs error of the floats."""
    from raytracercore_tpu_torch.intersect import cuda_select as cs

    got = select_outputs(cs.select_all, cs.closest_hit_fused, scene, o, d,
                         skip)
    ref = select_outputs(cs.select_all_reference,
                         cs.closest_hit_fused_reference, scene, o, d, skip)
    torch.cuda.synchronize()
    differing = {f: int((got[f] != ref[f]).sum()) for f in ref
                 if not torch.equal(got[f], ref[f])}
    max_err = 0.0
    for f in ("t", "position", "normal"):
        if got[f].numel():
            max_err = max(max_err, float((got[f] - ref[f]).abs().max()))
        check(bool(torch.isfinite(got[f]).all()),
              f"{label}: kernel outputs finite")
    print(f"[select] {label}: R={o.shape[0]} kernel==plain on all 13 "
          f"outputs={not differing} {differing or ''}")
    check(not differing, f"{label}: select kernel bit-equal to its plain "
          f"version ({differing})")
    return max_err


def compare_select(label, scene, queries, bounces=(0, 1, 2, 3)):
    """Select kernel against its plain version (all 13 outputs, bit for
    bit, through the wrappers ``select_all`` and ``closest_hit_fused``) and
    against the grid oracle, on the closest-hit queries of a trace: bounce
    0 without a skip record (camera rays) and with the empty one the trace
    passes, later bounces with their previous hit; then on the lane
    variants (:func:`lane_variants`) of bounce 1.  Returns the max abs
    error over the float outputs."""
    from raytracercore_tpu_torch.intersect import cuda_select as cs

    max_err = 0.0
    cases = [(0, None)] + [(b, queries[b][2]) for b in bounces
                           if b < len(queries)]
    for b, skip in cases:
        o, d, _ = queries[b]
        max_err = max(max_err, select_case(
            f"{label} bounce {b} skip={skip is not None}", scene, o, d,
            skip))
        against_oracle("select", f"{label} bounce {b} vs grid oracle",
                       cs.closest_hit_fused(scene, o, d, skip),
                       grid_closest_hit(scene, o, d, skip), d)
    b = min(1, len(queries) - 1)
    for name, query in lane_variants(queries[b], 51 + b):
        max_err = max(max_err, select_case(f"{label} bounce {b} {name}",
                                           scene, *query))
    k_ms = cuda_ms(lambda: cs.closest_hit_fused(scene, *queries[b]), 10)
    print(f"[select] {label}: kernel ms per launch (bounce {b})={k_ms:.3f}")
    return max_err


def select_times(label, scene, queries, card):
    """Every bounce's select launch at the main path's shapes: the wrapper
    by CUDA events over 10 calls, its device time by CUDA-graph replay
    (:func:`graph_ms`), each kernel it launches by the profiler, and the
    launch's own bound (the rows scanned for the lanes the kernel scans,
    the winners' extra work, the bytes this query needs).  Returns
    ``[{"ms", "device_ms", "bound"}]`` per bounce."""
    from raytracercore_tpu_torch.intersect import cuda_select as cs

    tables = nbytes(*scene.fused_tables[:6])
    rows = []
    for b, (o, d, skip) in enumerate(queries):
        def call(o=o, d=d, skip=skip):
            return cs.closest_hit_fused(scene, o, d, skip)
        ms = cuda_ms(call, 10)
        dev_ms = graph_ms(call, 20)
        parts = kernel_us(call, 5, SELECT_KERNELS)
        out = select_outputs(cs.select_all, cs.closest_hit_fused, scene, o,
                             d, skip)
        R = o.shape[0]
        n_live = int((~parked(o)).sum())
        winners = int(out["tri_any"].sum() + out["sph_any"].sum()
                      + out["pl_any"].sum())
        # Origins of every lane (the parking test), the rest of a live
        # lane's query, the tables, and the 13 output planes of every lane
        # (3 int32 rows, 2 bools, t, prim, position, normal: 46 bytes).
        n_bytes = R * 12 + n_live * 12 + tables + R * 46
        if skip is not None:
            n_bytes += n_live * 29
        bnd = bound(n_live * row_ops(scene) + winners * OPS_HIT, n_bytes)
        rows.append({"ms": ms, "device_ms": dev_ms, "bound": bnd})
        print(f"[time] select {label} bounce {b}: wrapper ms={ms:.4f} "
              f"device ms (CUDA graph)={fmt_ms(dev_ms)} lanes scanned="
              f"{n_live} of {R} winners={winners} bound ms={bnd[0]:.4f} "
              f"(by {bnd[1]}) on {card}")
        print(f"[time] select {label} bounce {b} kernels, us per launch "
              f"(profiler): {parts_text(parts) or 'not measured'}")
    sel = scene.select_tables
    print(f"[time] select {label} kernels: main "
          + occupancy_text("select_kernel", SELECT_THREADS,
                           nbytes(sel[0], *sel[2:]))
          + "; list " + occupancy_text("select_list_kernel", LIST_THREADS)
          + "; finish "
          + occupancy_text("select_finish_kernel", LIST_THREADS))
    print(f"[time] select {label} per pass ({len(rows)} launches): wrapper "
          f"ms sum={sum(r['ms'] for r in rows):.4f} device ms sum="
          f"{fmt_ms(sum_or_none(r['device_ms'] for r in rows))} bound ms "
          f"sum={sum(r['bound'][0] for r in rows):.4f} on {card}")
    return rows


def stage_ms(row):
    """A launch's time for the kernels line: the whole wrapper's device time
    (CUDA-graph replay), or its CUDA-event time where the graph was not
    measured."""
    return row["device_ms"] if row["device_ms"] is not None else row["ms"]


def sum_or_none(values):
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


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
    and uniforms: colour, miss and the five tape planes (the unreached rows
    too) must be equal bit for bit; returns the max abs colour error over
    all rays (0)."""
    from raytracercore_tpu_torch.render.fused import (
        classify_mismatches, trace_fused, trace_fused_reference)
    from raytracercore_tpu_torch.render.integrator import PathTape

    ref = trace_fused_reference(arrays, ray_o, ray_d, uniforms,
                                want_tape=True)
    got = trace_fused(arrays, ray_o, ray_d, uniforms, want_tape=True)
    got_nt = trace_fused(arrays, ray_o, ray_d, uniforms, want_tape=False)
    torch.cuda.synchronize()
    planes = ("prim", "flags", "nx", "ny", "nz")
    equal = {"color": torch.equal(got[0], ref[0]),
             "miss": torch.equal(got[1], ref[1]),
             **{f"tape.{k}": torch.equal(getattr(got[2], k),
                                         getattr(ref[2], k))
                for k in planes},
             "color (tape off)": torch.equal(got_nt[0], ref[0]),
             "miss (tape off)": torch.equal(got_nt[1], ref[1])}
    # Where anything differs, the classification says why (flip, graze or
    # samepick, each a count of rays).
    cls = classify_mismatches(ref, got, CLOSE_ATOL, CLOSE_RTOL)
    cls_nt = classify_mismatches(ref, (got_nt[0], got_nt[1], got[2]),
                                 CLOSE_ATOL, CLOSE_RTOL)
    counts = {k: int(cls[k].sum() + cls_nt[k].sum())
              for k in ("flip", "graze", "samepick")}
    err = max(float((got[0] - ref[0]).abs().max()),
              float((got_nt[0] - ref[0]).abs().max()))
    code = ref[2].flags & PathTape.CODE_MASK
    per_path = float((code != 0).sum(0).double().mean())
    print(f"[compare] {label}: R={ray_o.shape[0]} bit-equal: "
          + " ".join(f"{k}={v}" for k, v in equal.items())
          + f" flip={counts['flip']} graze={counts['graze']} "
          f"samepick={counts['samepick']} max_abs_err={err:.3e} "
          f"bounces_per_path={per_path:.4f}")
    check(bool(torch.isfinite(got[0]).all()), f"{label}: colour finite")
    for what, same in equal.items():
        check(same, f"{label}: megakernel {what} bit-equal to the plain "
              f"version")
    check(counts == {"flip": 0, "graze": 0, "samepick": 0} and err == 0.0,
          f"{label}: flip, graze, samepick and max abs err all 0")
    return err


def device_busy(fn, n):
    """Device busy share of ``n`` calls ``fn(i)`` under torch.profiler: the
    union of the kernels' device intervals over the host span from the
    first call to the final synchronize.  Returns (percent, text: the
    kernel launches per call and the top kernels by device time per
    call); (nan, a note) where the profiler saw no device time."""
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
    text = (f"{len(kernels) / n:.0f} kernel launches per call; "
            + "; ".join(f"{name[:50]} {us / n:.1f}" for name, us in top))
    if busy_us == 0:  # printed, not gated: a busy share is no gate
        return float("nan"), "the profiler saw no device time: not measured"
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
    kernel_ms = graph_ms(
        lambda: uk.prepare_uniforms_kernel(seed, n, bounces, dev), 20)
    plain_ms = cuda_ms(
        lambda: uk.prepare_uniforms_reference(seed, n, bounces, dev), 3)
    return float(err.max()), kernel_ms, plain_ms


def probe_phase(card, dev):
    """The issue-rate probe (``tools/issue_probe.py``, the port of
    ``scripts/vpu_issue_bench.py``): every mix held against its plain
    chains, then each timed on a full card of threads.  Returns the
    kernels-line numbers and the rates (operations per second, the bounds'
    convention)."""
    from raytracercore_tpu_torch.tools import issue_probe as ip

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = sms * 8 * ip.THREADS
    abc = ip.probe_inputs(n, device=dev)
    worst = 0.0
    for mix in ip.MIXES:
        got = ip.issue_probe(abc, mix, PROBE_CHECK_ITERS)
        want = ip.probe_reference(abc, mix, PROBE_CHECK_ITERS)
        torch.cuda.synchronize()
        err = float(((got - want).abs() / want.abs()).max())
        check(bool(torch.isfinite(got).all()) and err <= PROBE_RTOL,
              f"issue probe {mix}: chains within {PROBE_RTOL} of the plain "
              f"version ({err:.3e})")
        worst = max(worst, err)
    ip.issue_probe.launches = 0
    rates = {}
    for mix in ip.MIXES:
        rates[mix], ms = ip.probe_rate(mix, n, PROBE_ITERS)
        print(f"[probe] {mix}: {rates[mix]:.4e} operations/s "
              f"({ms:.3f} ms for {n} threads x {PROBE_ITERS} trips) on "
              f"{card}")
    launches = ip.issue_probe.launches
    check(launches == 6 * len(ip.MIXES), "issue probe: 6 launches a mix")
    k_ms = graph_ms(lambda: ip.issue_probe(abc, "megakernel",
                                           PROBE_CHECK_ITERS), 20)
    p_ms = cuda_ms(lambda: ip.probe_reference(abc, "megakernel",
                                              PROBE_CHECK_ITERS), 1)
    bnd = bound(n * ip.ops_per_thread("megakernel", PROBE_CHECK_ITERS),
                nbytes(abc) + abc[0].numel() * 4)
    print(f"[probe] ceiling under -fmad=false: the megakernel's mix "
          f"{rates['megakernel'] / 1e12:.3f} T operations/s, separate "
          f"multiplies {rates['mul'] / 1e12:.3f}, adds "
          f"{rates['add'] / 1e12:.3f} (against {PEAK_FP32 / 1e12:.0f} "
          f"TFLOP/s, which counts an FMA as two) on {card}; max rel err vs "
          f"plain {worst:.3e}; megakernel mix at {PROBE_CHECK_ITERS} trips: "
          f"kernel device ms (CUDA graph)={fmt_ms(k_ms)} plain ms="
          f"{p_ms:.3f} bound ms={bnd[0]:.4f} (by {bnd[1]}); "
          + occupancy_text("issue_probe_kernel", ip.THREADS))
    # The probe is built with -fmad=false, so nothing fuses: its ceiling is
    # the SM's unfused fp32 issue rate, 128 lanes an SM a clock, at the
    # card's highest SM clock (67 TFLOP/s counts an FMA as two).
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    issue_peak = 128 * sms * clk * 1e6
    issue_ms = n * ip.ops_per_thread("megakernel", PROBE_CHECK_ITERS) / \
        issue_peak * 1e3
    print(f"[probe] unfused fp32 issue peak 128 lanes x {sms} SMs x "
          f"{clk:.0f} MHz (clocks.max.sm) = {issue_peak / 1e12:.3f} T "
          f"operations/s: the megakernel's mix reaches "
          f"{rates['megakernel'] / issue_peak:.3f} of it; bound at it of the "
          f"{PROBE_CHECK_ITERS}-trip launch ms={issue_ms:.4f} (kernel "
          f"{fmt_ms(k_ms)}) on {card}")
    return {"launches": launches, "max_abs_err": worst, "ms": k_ms,
            "plain_ms": p_ms, "bound": bnd, "rates": rates}


def compare_replay(label, arrays, ray_o, ray_d, uniforms, record=None):
    """Replay forward and backward kernels against their plain versions
    on a tape that ``record(arrays, ray_o, ray_d, uniforms) → (color, miss,
    tape)`` records (by default the megakernel, and then the forward's
    colour is held bit-equal; on the train paths' recorders within
    ``REPLAY_ATOL`` + ``REPLAY_RTOL``); returns (max abs colour err, max
    abs gradient err)."""
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render import replay_kernel as rk

    exact = record is None
    if exact:
        def record(*args):
            return fused.trace_fused(*args, want_tape=True)
    color_r, miss_r, tape = record(arrays, ray_o, ray_d, uniforms)
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
    check(not exact or fwd_err == 0.0,
          f"{label}: replay colour bit-equal ({fwd_err:.3e})")

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


def compare_routes(card, dev):
    """The per-bounce route (``trace`` with the select kernel) against the
    megakernel on the Cornell scene at 700x700 rec10, same rays and
    uniforms.  The two differ by design on a few knife-edge rays (``trace``
    renormalizes at bounce 0 too, the select kernel keeps the coplanar
    triangle branch, and their normals come from the same passes but meet
    different rounding downstream): every differing ray is classified."""
    from raytracercore_tpu_torch.intersect.cuda_select import \
        closest_hit_fused
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render.integrator import trace

    arrays, ray_o, ray_d, uniforms = rays_and_uniforms(
        cornell_scene(), 700, 10, 7, dev)
    ref = fused.trace_fused(arrays, ray_o, ray_d, uniforms, want_tape=True)
    with torch.no_grad():
        got = trace(arrays, ray_o, ray_d, None, closest_fn=closest_hit_fused,
                    uniforms=uniforms, want_tape=True)
    torch.cuda.synchronize()
    cls = fused.classify_mismatches(ref, got, CLOSE_ATOL, CLOSE_RTOL)
    n = {k: int(cls[k].sum()) for k in ("close", "flip", "graze", "samepick")}
    ref_mean = ref[0].mean(0).cpu().numpy()
    got_mean = got[0].mean(0).cpu().numpy()
    print(f"[routes] cornell 700x700 rec10, trace + select kernel vs "
          f"megakernel: R={ray_o.shape[0]} close={n['close']} "
          f"flip={n['flip']} graze={n['graze']} samepick={n['samepick']} "
          f"miss_equal={int(cls['miss_eq'].sum())} "
          f"max_abs_err_same_path={cls['max_abs_err_same_path']:.3e} "
          f"means megakernel={ref_mean.tolist()} trace={got_mean.tolist()} "
          f"on {card}")
    check(n["samepick"] == 0, "routes: samepick == 0")
    check(np.all(np.abs(got_mean - ref_mean)
                 <= MEAN_TOL + MEAN_TOL * np.abs(ref_mean)),
          f"routes: channel means within {MEAN_TOL}")
    check(np.all(cls["miss_eq"] | cls["flip"]),
          "routes: miss flags equal outside flip rays")
    check(n["close"] >= MIN_CLOSE_FRAC * ray_o.shape[0],
          f"routes: close fraction >= {MIN_CLOSE_FRAC}")


def train_steps(tag, label, r, step_closest_fn, eval_closest_fn, counters,
                target_spp, card, dev):
    """``MESH_TRAIN_WARM`` + ``MESH_TRAIN_STEPS`` Adam steps of
    ``make_train_step`` on the scene of ``Renderer`` ``r`` (target: its own
    ``target_spp`` render; start: every non-emissive diffuse halved), with
    ``step_closest_fn`` as the step's closest hit (None: the default, the
    dense one).  ``counters``: ``{name: (wrapper, launches wanted per
    step)}``.  Checks the launches, that every loss is finite and that the
    loss on one fixed set of rays falls; returns ``{name: launches}`` of the
    timed steps."""
    from raytracercore_tpu_torch.diff import (get_material_params,
                                              with_material_params)
    from raytracercore_tpu_torch.parallel import make_train_step
    from raytracercore_tpu_torch.parallel.shard import image_loss, step_rays
    from raytracercore_tpu_torch.render import uniforms_kernel as uk
    from raytracercore_tpu_torch.render.integrator import trace
    from raytracercore_tpu_torch.render.renderer import pass_seed

    scene, camera = r.arrays, r.camera
    h, w = scene.height, scene.width
    n_bounces = scene.recursion + 1
    r.reset()
    r.step(target_spp)
    film = r.film
    target = film.color_sum / (film.samples + film.misses)[..., None]
    check(bool(torch.isfinite(target).all()) and float(target.max()) > 0.05,
          f"{label}: train target finite and lit")
    emissive = scene.materials.emission.sum(dim=1) > 0
    params = get_material_params(scene)
    with torch.no_grad():
        params["diffuse"][~emissive] *= 0.5
    adam = torch.optim.Adam(params.values(), lr=TRAIN_LR)
    step = (make_train_step(None, adam, graphs=False)
            if step_closest_fn is None
            else make_train_step(None, adam, closest_fn=step_closest_fn,
                                 graphs=False))

    # The step losses are one-sample renders under a new seed each, and
    # the bright light quad's edge pixels dominate their noise; whether the
    # loss falls is read from one fixed set of rays and uniforms, before
    # and after the steps.
    eval_o, eval_d, eval_seed = step_rays(camera, h, w,
                                          pass_seed(TRAIN_SEED, 1000))
    eval_u = uk.prepare_uniforms_kernel(eval_seed, h * w, n_bounces, dev)

    def eval_loss():
        with torch.no_grad():
            color, miss = trace(with_material_params(scene, params), eval_o,
                                eval_d, None, closest_fn=eval_closest_fn,
                                uniforms=eval_u)
            return float(image_loss(color, miss, target))

    loss_before = eval_loss()
    for i in range(MESH_TRAIN_WARM):
        step(params, scene, camera, target, pass_seed(TRAIN_SEED, i))
    torch.cuda.synchronize()
    for f, _ in counters.values():
        f.launches = 0
    losses, times = [], []
    for i in range(MESH_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(params, scene, camera, target,
                    pass_seed(TRAIN_SEED, MESH_TRAIN_WARM + i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = {k: f.launches for k, (f, _) in counters.items()}
    loss_after = eval_loss()
    want = {k: MESH_TRAIN_STEPS * n for k, (_, n) in counters.items()}
    med = float(np.median(times))
    print(f"[{tag}] launches during {MESH_TRAIN_STEPS} steps {counts} "
          f"(want {want}; {scene.materials.emission.shape[0]} material "
          f"rows)")
    print(f"[{tag}] {label} Adam lr={TRAIN_LR}: ms/step "
          f"min/p25/median/p75/max={quartiles(times)} "
          f"fwd+bwd steps/sec={1e3 / med:.4f} "
          f"wavefront rays/sec={h * w * n_bounces / (med * 1e-3):.4e} "
          "step losses " + " ".join(f"{x:.6f}" for x in losses)
          + f" loss on fixed rays before {loss_before:.6f} after "
          f"{MESH_TRAIN_WARM}+{MESH_TRAIN_STEPS} steps {loss_after:.6f} "
          f"on {card}")
    check(counts == want, f"{label} train step: every kernel launched as "
          f"often as wanted ({counts} != {want})")
    check(all(np.isfinite(losses)), f"{label} train step: every loss finite")
    check(np.isfinite(loss_after) and loss_after < loss_before,
          f"{label} train step: the loss on fixed rays falls")
    return counts


def replay_on_path(label, r, closest_fn, card, dev):
    """The replay kernels at the shapes of the train path of ``Renderer``
    ``r`` (its material table, a tape that the bounce loop records through
    ``closest_fn``) against their plain versions, then timed.  Returns
    ((max abs colour err, max abs gradient err), {"forward" | "backward":
    (kernel ms, plain ms, (bound ms, bound by))})."""
    from raytracercore_tpu_torch.parallel.shard import step_rays
    from raytracercore_tpu_torch.render import replay_kernel as rk
    from raytracercore_tpu_torch.render import uniforms_kernel as uk
    from raytracercore_tpu_torch.render.integrator import PathTape, trace
    from raytracercore_tpu_torch.render.renderer import pass_seed

    scene, camera = r.arrays, r.camera
    h, w = scene.height, scene.width
    n_paths, n_bounces = h * w, scene.recursion + 1

    def record(s, o, d, u):
        with torch.no_grad():
            return trace(s, o, d, None, closest_fn=closest_fn, uniforms=u,
                         want_tape=True)
    o, d, path_seed = step_rays(camera, h, w, pass_seed(TRAIN_SEED, 999))
    u = uk.prepare_uniforms_kernel(path_seed, n_paths, n_bounces, dev)
    errs = compare_replay(label, scene, o, d, u, record)
    tape = record(scene, o, d, u)[2]
    matf, scf = rk.material_table(scene)
    n_mats = matf.shape[0]
    ct = torch.full((n_paths, 3), 1e-6, device=dev)
    aim = scene.ambient_is_miss
    grids = {"forward": -(-n_paths // rk.REPLAY_BLOCK),
             "backward": rk.bwd_launch_blocks(
                 n_paths, n_mats, dev,
                 lambda: rk.bwd_blocks_per_sm(n_mats, n_bounces, aim, dev))}
    live = int(((tape.flags & PathTape.CODE_MASK) != 0).sum())
    tape_bytes = nbytes(tape.prim, tape.flags, tape.nx, tape.ny, tape.nz)
    # The backward writes its [blocks, N, 14] slices of floats, or above the
    # shared-memory cap one [N, 14] accumulator of doubles.
    grad_bytes = (matf.numel() * 8 if n_mats > rk.MAX_KERNEL_MATS
                  else grids["backward"] * matf.numel() * 4)
    bounds = {
        "forward": bound(live * OPS_SHADE, nbytes(d, u, matf, scf)
                         + tape_bytes + n_paths * 16),
        "backward": bound(live * (OPS_SHADE + OPS_SHADE_BWD),
                          nbytes(d, u, matf, scf, ct) + tape_bytes
                          + grad_bytes)}
    times = {}
    for name, kernel, plain in (("forward", rk.replay_fwd,
                                 rk.replay_fwd_reference),
                                ("backward", rk.replay_bwd,
                                 rk.replay_bwd_reference)):
        args = (d, u, tape, matf, scf, aim) + ((ct,) if name == "backward"
                                               else ())
        times[name] = (graph_ms(lambda: kernel(*args), 20),
                       cuda_ms(lambda: plain(*args), 2), bounds[name])
        attrs = (" (" + replay_occupancy(
            "bwd" if name == "backward" else "fwd", n_mats, n_bounces, aim,
            n_paths) + ")")
        if name == "forward":
            reached = fwd_reached_bytes(tape, matf, scf)
            attrs += (f" reached-bytes bound ms="
                      f"{reached / PEAK_BYTES * 1e3:.4f} ({reached} bytes)")
        print(f"[time] replay {name} {label} ({n_mats} material rows, "
              f"{grids[name]} blocks, {live / n_paths:.4f} live bounces per "
              f"path): kernel device ms (CUDA graph)={fmt_ms(times[name][0])}"
              f"{attrs} plain ms={times[name][1]:.3f} bound ms="
              f"{bounds[name][0]:.4f} (by {bounds[name][1]}) on {card}")
    return errs, times


def mesh_train_path(card, dev, r):
    """The train step of main path 3's scene (``r`` is its ``Renderer``):
    recorded by the bounce loop with the select kernel, its colour from
    the replay forward kernel and its gradient from the replay backward
    kernel on the 722-row material table; then full AD
    through ``trace`` against the replay route on the 82-triangle scene.
    Returns {kernel name: launches} of the timed steps."""
    from raytracercore_tpu_torch.diff import get_material_params
    from raytracercore_tpu_torch.intersect import cuda_select as cs
    from raytracercore_tpu_torch.parallel import make_train_step
    from raytracercore_tpu_torch.render import replay_kernel as rk
    from raytracercore_tpu_torch.render import shade_kernel as sk
    from raytracercore_tpu_torch.render import uniforms_kernel as uk
    from raytracercore_tpu_torch.render.renderer import Renderer

    n_bounces = r.arrays.recursion + 1
    errs, _ = replay_on_path("mesh-722 700x700 rec10", r,
                             cs.closest_hit_fused, card, dev)
    counts = train_steps(
        "mesh-train", "mesh-722 700x700 rec10", r, None, cs.closest_hit_fused,
        {"closest_hit_fused": (cs.closest_hit_fused, n_bounces),
         "shade_bounce": (sk.shade_bounce, n_bounces),
         "prepare_uniforms_kernel": (uk.prepare_uniforms_kernel, 1),
         "replay_fwd": (rk.replay_fwd, 1), "replay_bwd": (rk.replay_bwd, 1)},
        MESH_TARGET_SPP, card, dev)

    # --- full AD through trace against the replay, 128x128 on mesh-82 ------
    small, small_cam = lit_mesh_scene(1, 1, 128, 4, dev)
    rs = Renderer(small, device="cuda", cameras=[small_cam], graphs=False)
    check(rs.route == "trace", "mesh-82 takes the per-bounce route")
    u = uk.prepare_uniforms_kernel(5, 128 * 128, small.recursion + 1, dev)
    tgt = torch.full((128, 128, 3), 0.05, device=dev)
    grads, loss_of = {}, {}
    for use_replay in (True, False):
        p = get_material_params(rs.arrays)
        step = make_train_step(None, torch.optim.SGD(p.values(), lr=0.0),
                               use_replay=use_replay, graphs=False)
        loss_of[use_replay] = float(step(p, rs.arrays, rs.camera, tgt, 3,
                                         uniforms=u))
        grads[use_replay] = {k: v.grad.clone() for k, v in p.items()}
    torch.cuda.synchronize()
    worst = 0.0
    for k in grads[True]:
        scale = float(grads[False][k].abs().max())
        err_k = float((grads[True][k] - grads[False][k]).abs().max())
        check(err_k <= GRAD_TOL * scale + 1e-12,
              f"use_replay True vs False: {k} gradient {err_k:.3e} > "
              f"{GRAD_TOL} * {scale:.3e}")
        worst = max(worst, err_k / scale if scale else 0.0)
    rel = abs(loss_of[True] - loss_of[False]) / abs(loss_of[False])
    nonzero = sum(int((g != 0).sum()) for g in grads[False].values())
    print(f"[mesh-train] mesh-82 128x128 rec4, use_replay=True vs full AD "
          f"through trace: loss {loss_of[True]:.8f} vs {loss_of[False]:.8f} "
          f"(rel diff {rel:.2e}), worst gradient diff / max|g| = "
          f"{worst:.2e}, nonzero gradient entries {nonzero}")
    check(rel <= 1e-6, "use_replay True vs False: loss equal to 1e-6")
    check(nonzero > 50, "use_replay comparison is not vacuous")
    return counts, errs


def mesh_path(card, dev):
    """Main path 3: ``Renderer`` on the 722-triangle mesh scene at 700x700
    rec10 (the bounce loop, one launch of the select kernel and one of the
    shading kernel per bounce), then the scene's train step.  Returns
    ({kernel name: launches} of the timed passes, ({kernel name: launches}
    of the train steps, the replay kernels' max abs errors there), the
    select kernel's stage numbers, the shading kernel's)."""
    from raytracercore_tpu_torch.intersect import cuda_select as cs
    from raytracercore_tpu_torch.intersect.dispatch import n_table_rows
    from raytracercore_tpu_torch.render import shade_kernel as sk
    from raytracercore_tpu_torch.render.renderer import Renderer

    scene, host_cam = lit_mesh_scene(MESH_GRID, MESH_SUBDIV, 700, 10, dev)
    r = Renderer(scene, device="cuda", seed=0, cameras=[host_cam],
                 graphs=False)
    scene = r.arrays
    n_rows = n_table_rows(scene)
    check(scene.triangles.v0.shape[0] == 722 and scene.recursion == 10
          and (scene.width, scene.height) == (700, 700),
          "main path 3 scene is mesh-722 at 700x700 rec10")
    check(r.route == "trace", "mesh-722 takes the per-bounce route")
    n_bounces = scene.recursion + 1
    t0 = time.perf_counter()
    r.step(WARM_PASSES)
    warm_s = time.perf_counter() - t0
    r.reset()
    cs.closest_hit_fused.launches = sk.shade_bounce.launches = 0
    pass_s = []
    for _ in range(MAIN_PASSES):
        t0 = time.perf_counter()
        r.step(1)
        pass_s.append(time.perf_counter() - t0)
    launches = {"closest_hit_fused": cs.closest_hit_fused.launches,
                "shade_bounce": sk.shade_bounce.launches}
    st = r.status()
    print(f"[mesh] launches of the select and shading kernels during "
          f"{MAIN_PASSES} passes: {launches} ({n_bounces} bounces per pass, "
          f"no whole-wavefront early exit)")
    want = MAIN_PASSES * n_bounces
    check(launches == {"closest_hit_fused": want, "shade_bounce": want},
          f"main path 3 launched the select and shading kernels once per "
          f"bounce ({launches}, want {want} each)")
    film = r.film
    check(all(bool(torch.isfinite(t).all()) for t in
              (film.color_sum, film.samples, film.misses)),
          "mesh film is finite")
    check(float(film.samples.sum() + film.misses.sum())
          == MAIN_PASSES * 700 * 700, "mesh: one sample per pixel per pass")
    image_stage(card, r, "mesh-722")
    img = r.image()
    check(img.shape == (700, 700, 4) and img.dtype == np.uint8,
          "mesh image is 700x700 RGBA uint8")
    check(int(img[..., :3].max()) > 50, "mesh image is lit (max > 50)")
    print(f"[mesh] mesh-722 ({n_rows} table rows) 700x700 rec10, "
          f"{MAIN_PASSES} passes: "
          f"samples/px/sec={st['samples_per_px_per_sec']:.4f} "
          f"paths/sec={st['paths_per_sec']:.4e} "
          f"ms/pass min/p25/median/p75/max="
          f"{quartiles(np.asarray(pass_s) * 1e3)} "
          f"warm-up s={warm_s:.3f} ({WARM_PASSES} passes) "
          f"image max={int(img[..., :3].max())} "
          f"mean={float(img[..., :3].mean()):.3f} on {card}")
    print("[mesh] ms of each pass: "
          + " ".join(f"{x * 1e3:.3f}" for x in pass_s))
    busy, top = device_busy(lambda i: r.step(1), 4)
    print(f"[profile] 4 mesh-722 passes: device busy {busy:.1f} % of the "
          f"span on {card}")
    print(f"[profile] top kernels, device us per pass: {top}")

    stage, shade = select_stage(card, dev, scene, host_cam)
    return launches, mesh_train_path(card, dev, r), stage, shade


def select_stage(card, dev, scene, host_cam):
    """The select kernel at main path 3's shapes (mesh-722 700x700 rec10):
    its queries, compared, every bounce's launch timed beside its bound,
    the plain version and the shading (kernel and plain) timed; then the
    shading kernel's stage (:func:`shade_stage`).  Returns the select
    kernel's stage numbers (bounce 0's time and bound) and the shading
    kernel's."""
    from raytracercore_tpu_torch.intersect import cuda_select as cs
    from raytracercore_tpu_torch.render.integrator import (
        shade_bounce_reference, trace)

    n_bounces = scene.recursion + 1
    ray_o, ray_d, uniforms = camera_rays_and_uniforms(
        scene, host_cam, 700, 11, dev)
    queries = closest_hit_queries(scene, ray_o, ray_d, uniforms)
    check(len(queries) == n_bounces, "one closest-hit query per bounce")
    err = compare_select("mesh-722 700x700", scene, queries, (1, 3))
    check_no_sync("select kernel wrapper closest_hit_fused, mesh-722 bounce 1",
                  lambda: cs.closest_hit_fused(scene, *queries[1]))
    times = select_times("mesh-722 700x700", scene, queries, card)
    plain_ms = cuda_ms(
        lambda: cs.closest_hit_fused_reference(scene, *queries[1]), 1)
    # Shading alone: the bounce loop fed the hits it was given before.
    with torch.no_grad():
        hits = [cs.closest_hit_fused(scene, *q) for q in queries]

    def shading_only(shade_fn=None):
        it = iter(hits)
        with torch.no_grad():
            trace(scene, ray_o, ray_d, None,
                  closest_fn=lambda *_: next(it), uniforms=uniforms,
                  shade_fn=shade_fn)
    shade_ms = cuda_ms(shading_only, 5) / n_bounces
    plain_shade_ms = cuda_ms(
        lambda: shading_only(shade_bounce_reference), 5) / n_bounces
    print(f"[time] select kernel mesh-722 700x700: plain ms (one launch, "
          f"bounce 1)={plain_ms:.3f}; the bounce loop fed its hits, ms per "
          f"bounce (CUDA events, eager): shading kernel {shade_ms:.3f}, "
          f"eager plain shading {plain_shade_ms:.3f} on {card}")
    print("[mesh] share of lanes not parked, per bounce: "
          + " ".join(f"{float((~parked(q[0])).float().mean()):.4f}"
                     for q in queries))
    del queries, hits
    shade = shade_stage(card, "mesh-722 700x700", scene, shade_inputs(
        scene, ray_o, ray_d, uniforms, cs.closest_hit_fused), 63)
    return {"ms": stage_ms(times[0]), "plain_ms": plain_ms,
            "bound_ms": times[0]["bound"][0],
            "bound_by": times[0]["bound"][1], "max_abs_err": err}, shade


# csrc/shade.cu: threads a block, and the floating-point operations of one
# ray's bounce of shading (four luminances, two cone samples of ~45 each,
# the Fresnel split ~30, the branch pick, the three directions and the
# tint ~60).
SHADE_THREADS = 256
OPS_SHADE_BOUNCE = 250


def shade_inputs(scene, ray_o, ray_d, uniforms, closest_fn):
    """The shading kernel's inputs at every bounce of a no-grad ``trace``
    of these rays through ``closest_fn``: ``[(hit, state, d, u_i, i)]``,
    captured by a ``shade_fn`` that runs the plain body."""
    from raytracercore_tpu_torch.render.integrator import (
        shade_bounce_reference, trace)

    seen = []

    def spy(hit, state, d, u, matf, ambient, air, i, *rest):
        seen.append((hit, state, d, u, i))
        return shade_bounce_reference(hit, state, d, u, matf, ambient, air,
                                      i, *rest)
    with torch.no_grad():
        trace(scene, ray_o, ray_d, None, closest_fn=closest_fn,
              uniforms=uniforms, shade_fn=spy)
    return seen


def named_tensors(x, prefix=""):
    """``[(name, tensor)]`` of a PathState / HitRecord / PathTape /
    BounceRecords, nested fields by dotted name."""
    import dataclasses

    out = []
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if dataclasses.is_dataclass(v):
            out += named_tensors(v, f"{prefix}{f.name}.")
        else:
            out.append((prefix + f.name, v))
    return out


def bits_equal(a, b):
    """Equal shape, dtype and bits (NaN payloads and signed zeros
    included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


def cast_bounce(bounce, dtype):
    """A bounce's inputs with every float tensor cast to ``dtype``."""
    import dataclasses

    def cast(x):
        if dataclasses.is_dataclass(x):
            return type(x)(*(cast(getattr(x, f.name))
                             for f in dataclasses.fields(x)))
        return x.to(dtype) if x.is_floating_point() else x
    hit, state, d, u, i = bounce
    return cast(hit), cast(state), d.to(dtype), u.to(dtype).contiguous(), i


def shade_args(scene, bounce, tape=False, records=False):
    """The wrapper's arguments for one bounce, with fresh ``[B, R]`` tape
    and ``[R, B]`` records where asked."""
    from raytracercore_tpu_torch.render import integrator as integ

    hit, state, d, u, i = bounce
    dt, dev, R = d.dtype, d.device, d.shape[0]
    B = scene.recursion + 1
    matf = integ._material_matrix(scene.materials).to(dt)
    return (hit, state, d, u, matf, scene.ambient_rgb.to(dt),
            scene.air_refractive_index.to(dt), i, scene.recursion,
            scene.ambient_is_miss,
            integ.PathTape.create(R, B, dt, dev) if tape else None,
            integ.BounceRecords.create(R, B, dt, dev) if records else None)


def shade_case(label, scene, bounce):
    """Gate: the shading kernel bit-equal to its plain version on one
    bounce's inputs, tape and records off, then on: every output, every
    lane.  Returns the number of outputs compared."""
    from raytracercore_tpu_torch.render import shade_kernel as sk
    from raytracercore_tpu_torch.render.integrator import \
        shade_bounce_reference

    n = 0
    for extras in (False, True):
        got, want = [], []
        for fn, out in ((sk.shade_bounce, got),
                        (shade_bounce_reference, want)):
            args = shade_args(scene, bounce, extras, extras)
            state = fn(*args)
            out += named_tensors(state)
            if extras:
                out += named_tensors(args[10], "tape.")
                out += named_tensors(args[11], "records.")
        differ = [name for (name, a), (_, b) in zip(got, want)
                  if not bits_equal(a, b)]
        check(not differ, f"shade kernel {label} (tape and records "
              f"{'on' if extras else 'off'}): outputs differing from the "
              f"plain version {differ}")
        n += len(got)
    return n


def shade_lane_variants(bounce, seed):
    """A bounce's inputs made into the lane variants of
    :func:`lane_variants`: lanes parked at random (the no-hit record, not
    alive, the parked ray), every lane parked, only the lanes alive before
    the bounce, and a ragged R: ``[(name, bounce)]``."""
    import dataclasses

    from raytracercore_tpu_torch.config import PARKED_ORIGIN
    from raytracercore_tpu_torch.intersect.dispatch import HitRecord
    from raytracercore_tpu_torch.render.integrator import PathState

    hit, state, d, u, i = bounce
    R, dev = d.shape[0], d.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mix = torch.rand(R, generator=gen, device=dev) < 0.5
    p_d = torch.zeros_like(d)
    p_d[:, 0] = 1.0

    def where(mask, a, b):
        return torch.where(mask if a.dim() == 1 else mask[:, None], a, b)

    def park(mask):
        none = HitRecord.none(R, d.dtype, dev)
        h = HitRecord(*(where(mask, getattr(none, f.name),
                              getattr(hit, f.name))
                        for f in dataclasses.fields(hit)))
        s = dataclasses.replace(
            state, alive=state.alive & ~mask,
            ray_o=where(mask, torch.full_like(state.ray_o, PARKED_ORIGIN),
                        state.ray_o))
        return h, s, where(mask, p_d, d).contiguous(), u, i

    def take(idx):
        def rows(x):
            return type(x)(*(getattr(x, f.name)[idx]
                             for f in dataclasses.fields(x)))
        s = PathState(*(getattr(state, f.name)[idx] for f in
                        dataclasses.fields(state) if f.name != "prev"),
                      prev=rows(state.prev))
        return (rows(hit), s, d[idx].contiguous(),
                u[:, idx].contiguous(), i)
    live = torch.nonzero(state.alive)[:, 0]
    n_rag = R - 37 if R > 64 else R - 1
    return [("parked at random", park(mix)),
            ("all parked", park(torch.ones_like(mix))),
            (f"none parked (R={live.numel()})", take(live)),
            (f"ragged R={n_rag}", take(torch.arange(n_rag, device=dev)))]


def shade_bound(bounce, out, tape=False, records=False):
    """The least time of one bounce's shading (:func:`bound`): the
    floating-point operations of every lane, and the bytes this bounce's
    function needs — every lane's hit record but its t, direction, tint,
    alive, result, miss and 7 uniforms; the t of the lanes that go on and
    the skip record of the others; the material table, ambient and air
    once; every output once (the state and skip record, and the tape and
    record rows where asked)."""
    hit, state, d, u, _ = bounce
    R, fb = d.shape[0], d.element_size()
    n_on = int(out.alive.sum())
    skip_row = 4 + 7 * fb + 1           # prim, t, position, normal, inside
    n_bytes = (nbytes(hit.prim, hit.position, hit.normal, hit.inside, d,
                      state.tint, state.alive, state.result, state.miss, u)
               + n_on * fb + (R - n_on) * skip_row
               + nbytes(*(t for _, t in named_tensors(out))))
    if tape:
        n_bytes += R * (8 + 3 * fb)
    if records:
        n_bytes += R * (8 + 9 * fb + 1)
    return bound(R * OPS_SHADE_BOUNCE, n_bytes)


def shade_stage(card, label, scene, bounces, seed):
    """The shading kernel at a main path's shapes: every bounce of a trace
    (``bounces``, :func:`shade_inputs`) held bit-equal to the plain
    version in float32 and float64, tape and records off and on, and the
    lane variants of bounce 1; then every bounce's launch timed by
    CUDA-graph replay beside its bound, bounce 1 also with the tape, with
    the records and in float64, and the plain version on bounce 1; one
    call under the sync check.  Returns the stage numbers of bounce 1
    (float32, tape and records off)."""
    from raytracercore_tpu_torch.render import shade_kernel as sk
    from raytracercore_tpu_torch.render.integrator import \
        shade_bounce_reference

    outputs = 0
    for b, bounce in enumerate(bounces):
        outputs += shade_case(f"{label} bounce {b}", scene, bounce)
        outputs += shade_case(f"{label} bounce {b} float64", scene,
                              cast_bounce(bounce, torch.float64))
    for name, bounce in shade_lane_variants(bounces[1], seed):
        outputs += shade_case(f"{label} bounce 1 {name}", scene, bounce)
    print(f"[shade] {label}: the kernel bit-equal to shade_bounce_reference "
          f"on {len(bounces)} bounces in float32 and float64, tape and "
          f"records off and on, and the lane variants of bounce 1 "
          f"({outputs} outputs compared, every lane) on {card}")
    check_no_sync(f"shading kernel wrapper shade_bounce, {label} bounce 1",
                  lambda: sk.shade_bounce(*shade_args(scene, bounces[1])))
    rows = []
    for b, bounce in enumerate(bounces):
        args = shade_args(scene, bounce)
        out = sk.shade_bounce(*args)
        ms = graph_ms(lambda: sk.shade_bounce(*args), 20, calls=10)
        bnd = shade_bound(bounce, out)
        rows.append((ms, bnd))
        print(f"[time] shade {label} bounce {b} (R={bounce[2].shape[0]}, "
              f"{int(out.alive.sum())} go on): kernel device ms (CUDA "
              f"graph)={fmt_ms(ms)} bound ms={bnd[0]:.4f} (by {bnd[1]}) "
              f"on {card}")
    one = bounces[1]
    extra = {}
    for what, bounce, tape, rec in (
            ("tape", one, True, False), ("records", one, False, True),
            ("float64", cast_bounce(one, torch.float64), False, False)):
        args = shade_args(scene, bounce, tape, rec)
        extra[what] = (graph_ms(lambda: sk.shade_bounce(*args), 20,
                                calls=10),
                       shade_bound(bounce, sk.shade_bounce(*args), tape,
                                   rec))
    args = shade_args(scene, one)
    plain_ms = cuda_ms(lambda: shade_bounce_reference(*args), 3)
    print(f"[time] shade {label} bounce 1: with the tape "
          + ", ".join(f"{what} {fmt_ms(ms)} (bound {bnd[0]:.4f})"
                      for what, (ms, bnd) in extra.items())
          + f"; plain ms={plain_ms:.3f}; per pass ({len(rows)} launches) "
          f"kernel ms sum={fmt_ms(sum_or_none(r[0] for r in rows))} bound "
          f"ms sum={sum(r[1][0] for r in rows):.4f} on {card}; "
          + occupancy_text("shade_bounce_kernel", SHADE_THREADS))
    ms, bnd = rows[1]
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "max_abs_err": 0.0}


def plain_shading_trace_fn(closest_fn):
    """``render_pass``'s ``trace_fn`` that runs ``trace`` through
    ``closest_fn`` with the plain bounce body on the card
    (``shade_fn=shade_bounce_reference``): the film the kernel's route is
    held bit-equal to."""
    from raytracercore_tpu_torch.render.integrator import (
        shade_bounce_reference, trace)

    def trace_fn(scene, ray_o, ray_d, uniforms):
        return trace(scene, ray_o, ray_d, None, closest_fn=closest_fn,
                     uniforms=uniforms, shade_fn=shade_bounce_reference)
    return trace_fn


def plain_shading_step_loss(params, scene, camera, target, seed,
                            closest_fn):
    """The loss and material gradients of one ``make_train_step`` step
    seeded ``seed`` from ``params`` (copied), its recorder's bounce body
    the plain version (``trace(want_tape=True,
    shade_fn=shade_bounce_reference)``), the rest the step's own route:
    the uniforms kernel, ``replay_fused``, the L2 loss.  Returns (loss,
    {field: gradient})."""
    from raytracercore_tpu_torch.diff import with_material_params
    from raytracercore_tpu_torch.parallel.shard import image_loss, step_rays
    from raytracercore_tpu_torch.render import replay
    from raytracercore_tpu_torch.render.integrator import (
        shade_bounce_reference, trace)
    from raytracercore_tpu_torch.render.replay_kernel import replay_fused
    from raytracercore_tpu_torch.render.uniforms_kernel import (
        prepare_uniforms_keyed, seed_key)

    from raytracercore_tpu_torch.intersect.dispatch import closest_hit

    h, w = target.shape[:2]
    closest_fn = closest_hit if closest_fn is None else closest_fn
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    s = with_material_params(scene, p)
    ray_o, ray_d, path_seed = step_rays(camera, h, w, seed)
    u = prepare_uniforms_keyed(seed_key(path_seed, ray_o.device), h * w,
                               scene.recursion + 1)
    with torch.no_grad():
        tape = trace(s, ray_o, ray_d, None,
                     closest_fn=replay._default_record_fn(s, closest_fn),
                     uniforms=u, want_tape=True,
                     shade_fn=shade_bounce_reference)[2]
    color, miss = replay_fused(s, ray_o, ray_d, u, tape)
    loss = image_loss(color, miss, target)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in p.items()}


def take_rays(query, idx):
    """Rays ``idx`` of a closest-hit query ``(ray_o, ray_d, skip)``."""
    import dataclasses

    o, d, skip = query
    if skip is not None:
        skip = type(skip)(*(getattr(skip, f.name)[idx]
                            for f in dataclasses.fields(skip)))
    return o[idx].contiguous(), d[idx].contiguous(), skip


def select_flat(out):
    """``select(want_detail=True, want_stats=True)``'s result as one
    ``{name: tensor}``: the kernel's 12 output planes and its counters."""
    row, found, t, detail, stats = out
    return {"row": row, "any": found, "t": t, **detail, "stats": stats}


def in_sphere_bvh_metric(scene, want, d):
    """The dense scan's record ``want`` with the t of untransformed spheres
    in the sphere BVH's metric.  The dense scan returns such a sphere's t
    along the re-normalized direction, t_n; the sphere leaves return
    d . (position - origin) = |d| t_n, the metric of the transformed spheres
    and of the merge (both as in the JAX package).  They differ where |d| is
    not 1: by some 3e-4 after a bounce, between two renormalizations."""
    import dataclasses

    sph = scene.spheres
    plain = torch.zeros(scene.n_prims + 1, dtype=torch.bool, device=d.device)
    plain[sph.prim_id[(sph.prim_id >= 0) & ~sph.transformed].long()] = True
    on_plain = plain[want.prim.long()] & (want.prim >= 0)
    return dataclasses.replace(want, t=torch.where(
        on_plain, want.t * torch.linalg.vector_norm(d, dim=1), want.t))


def traverse_flat(out):
    """A ``TraverseOut`` as :func:`select_flat` gives ``select``'s result."""
    f = out.flags
    return {"row": torch.clamp(out.row, min=0), "any": out.row >= 0,
            "t": out.t, "prim": out.prim, "pos": out.position,
            "nrm": out.normal, "inside": (f & 1) != 0,
            "inside_geo": (f & 2) != 0, "smooth": (f & 4) != 0, "u": out.u,
            "v": out.v, "stats": out.stats}


def differing_fields(got, want, fields):
    return {f: int((got[f] != want[f]).sum()) for f in fields
            if not torch.equal(got[f], want[f])}


def traverse_case(label, bvh, o, d, skip):
    """The traversal kernel's detail form on one query through
    ``bvh.select``, unsorted and sorted, against its plain version (the
    wide walk ``traverse_wide_reference``): all 12 outputs and both
    counters bit for bit; and against the binary skip-link walk
    ``traverse_reference`` on ``bvh.nodes``: the 12 outputs and the records
    tested bit for bit (its first counter counts binary nodes visited, the
    kernel's the root test and the wide nodes fetched).  Returns (max abs
    error of the floats where a hit was found, the kernel's counters, the
    binary walk's, the wide plain walk's ``TraverseOut``)."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.core import vecmath as vm

    eps = (vm.near_enough(torch.float32), vm.POSITION_EPS_F32)
    got = select_flat(bvh.select(o, d, skip, *eps, want_detail=True,
                                 want_stats=True))
    plain = ct.traverse_wide_reference(
        bvh.wide, bvh.leaves, bvh.leaf_kind, o.float().contiguous(),
        d.float().contiguous(), bvh._skip(skip), *eps, want_stats=True)
    ref = traverse_flat(plain)
    srt = select_flat(bvh.select(o, d, skip, *eps, want_detail=True,
                                 want_stats=True, sort=True))
    binary = traverse_flat(ct.traverse_reference(
        bvh.nodes, bvh.leaves, bvh.leaf_kind, o.float().contiguous(),
        d.float().contiguous(), bvh._skip(skip), *eps, want_stats=True))
    torch.cuda.synchronize()
    differing = differing_fields(got, ref, ref)
    sort_differing = differing_fields(srt, got, got)
    outputs = [f for f in got if f != "stats"]
    bin_differing = differing_fields(got, binary, outputs)
    bin_differing.update(differing_fields(
        {"records tested": got["stats"][:, 1]},
        {"records tested": binary["stats"][:, 1]}, ["records tested"]))
    hit = ref["any"]
    max_err = 0.0
    for f in ("t", "pos", "nrm", "u", "v"):
        check(bool(torch.isfinite(got[f][hit]).all()),
              f"{label}: kernel outputs finite")
        if bool(hit.any()):
            max_err = max(max_err, float(
                (got[f][hit] - ref[f][hit]).abs().max()))
    fetched, tested = (got["stats"].float().mean(0).tolist()
                       if o.shape[0] else (0.0, 0.0))
    visited = (float(binary["stats"][:, 0].float().mean())
               if o.shape[0] else 0.0)
    print(f"[traverse] {label} {bvh.leaf_kind} leaves ({bvh.n_nodes} "
          f"nodes, {bvh.wide.table.shape[0]} {ct.WIDE_WIDTH}-wide, stack "
          f"depth {bvh.wide.depth}, leaf size {bvh.K}): R={o.shape[0]} "
          f"found={float(hit.float().mean()):.4f} wide fetches per ray="
          f"{fetched:.2f} (binary nodes visited {visited:.2f}) records "
          f"tested per ray={tested:.2f} kernel==wide plain on all 12 "
          f"outputs and both counters={not differing} {differing or ''} "
          f"kernel==binary plain on the 12 outputs and records tested="
          f"{not bin_differing} {bin_differing or ''} sorted kernel=="
          f"unsorted={not sort_differing} {sort_differing or ''}")
    check(not differing, f"{label} {bvh.leaf_kind}: traversal kernel "
          f"bit-equal to its plain version ({differing})")
    check(not bin_differing, f"{label} {bvh.leaf_kind}: traversal kernel "
          f"bit-equal to the binary walk ({bin_differing})")
    check(not sort_differing, f"{label} {bvh.leaf_kind}: the sorted "
          f"traversal bit-equal to the unsorted one ({sort_differing})")
    return max_err, got["stats"], binary["stats"], plain


RECORD_FIELDS = ("prim", "t", "position", "normal", "inside")


def record_tri(scene, bvh):
    """The triangle table whose vertex normals a tree's record epilogue
    reads (``make_bvh_closest_fn``'s rule): a triangle tree's, where the
    scene has smooth rows; else None."""
    if bvh.leaf_kind == "tri" and bool(scene.triangles.smooth.any()):
        return scene.triangles
    return None


def record_case(label, bvh, o, d, skip, plain, tri, prior):
    """The traversal kernel's record form (``bvh.record``: the bounce's
    final hit record written in the kernel's epilogue, the smooth normals
    re-interpolated where ``tri`` is given, merged into ``prior``),
    unsorted and sorted, against its plain version: ``record_reference``
    (the chain of torch ops) on the wide plain walk ``plain`` of the same
    query, all five fields bit for bit.  Returns (max abs error of the
    floats where a hit was found, the kernel's record, the rays on which
    both ``prior`` and this tree hit)."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.core import vecmath as vm

    eps = (vm.near_enough(torch.float32), vm.POSITION_EPS_F32)
    rec = bvh.record(o, d, skip, *eps, tri=tri, prior=prior)
    srt = bvh.record(o, d, skip, *eps, tri=tri, prior=prior, sort=True)
    ref = ct.record_reference(plain, tri, prior)
    torch.cuda.synchronize()
    got, srt, ref = ({f: getattr(x, f) for f in RECORD_FIELDS}
                     for x in (rec, srt, ref))
    differing = [f for f in RECORD_FIELDS if not bits_equal(got[f], ref[f])]
    sort_differing = [f for f in RECORD_FIELDS
                      if not bits_equal(srt[f], got[f])]
    hit = ref["prim"] >= 0
    both = (int(((prior.prim >= 0) & (plain.row >= 0)).sum())
            if prior is not None else 0)
    max_err = 0.0
    for f in ("t", "position", "normal"):
        check(bool(torch.isfinite(got[f][hit]).all()),
              f"{label}: record outputs finite")
        if bool(hit.any()):
            max_err = max(max_err, float(
                (got[f][hit] - ref[f][hit]).abs().max()))
    print(f"[traverse] {label} {bvh.leaf_kind} record form (smooth "
          f"{tri is not None}, merged into a prior record "
          f"{prior is not None}, both hit on {both} rays): R={o.shape[0]} "
          f"found={float(hit.float().mean()):.4f} kernel==plain chain on "
          f"the 5 fields={not differing} {differing or ''} sorted kernel=="
          f"unsorted={not sort_differing} {sort_differing or ''}")
    check(not differing, f"{label} {bvh.leaf_kind}: the record epilogue "
          f"bit-equal to its plain version ({differing})")
    check(not sort_differing, f"{label} {bvh.leaf_kind}: the sorted record "
          f"bit-equal to the unsorted one ({sort_differing})")
    return max_err, rec, both


def key_case(label, bvh, o, d):
    """The key kernel against its plain version on one query's rays, bit
    for bit, and every parked lane at the largest key.  Returns the max abs
    difference (0)."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct

    got = ct.sort_key(o, d, bvh.root_min, bvh.root_max)
    ref = ct.sort_key_reference(o, d, bvh.root_min, bvh.root_max)
    torch.cuda.synchronize()
    n_diff = int((got != ref).sum())
    err = (float((got.long() - ref.long()).abs().max()) if got.numel()
           else 0.0)
    dead = parked(o)
    print(f"[key] {label}: R={o.shape[0]} parked={int(dead.sum())} distinct "
          f"keys={int(torch.unique(got).numel())} kernel==plain="
          f"{n_diff == 0} ({n_diff} differ)")
    check(n_diff == 0, f"{label}: key kernel bit-equal to its plain version")
    check(bool((got[dead] == KEY_MAX).all()),
          f"{label}: every parked lane has the largest key")
    return err


def warps_of(x, fill):
    """``x`` [R] as ``[ceil(R / 32), 32]`` warps, the ragged last warp
    padded with ``fill``."""
    pad = (-x.numel()) % WARP
    return torch.nn.functional.pad(x, (0, pad), value=fill).view(-1, WARP)


def warp_efficiency(visited, order=None):
    """Sum of the nodes visited over the lanes / (32 x sum over warps of the
    warp's largest count), the lanes in launch order (thread t walks ray
    ``order[t]``; None: ray t): a warp runs as long as its longest lane."""
    v = warps_of((visited if order is None else visited[order]).long(), 0)
    return float(v.sum()) / float(WARP * v.max(1).values.sum())


def parked_warps(o, visited, order=None):
    """``(warps whose every lane is parked, the most nodes a lane of them
    visited)`` in launch order."""
    if order is not None:
        o, visited = o[order], visited[order]
    dead = warps_of(parked(o).to(torch.int32), 1).bool().all(1)
    most = warps_of(visited.long(), 0).max(1).values
    return int(dead.sum()), int(most[dead].max()) if bool(dead.any()) else 0


def compare_traverse(label, scene, closest, queries, bounces=(0, 1, 2, 3),
                     oracle_bounces=(0, 1)):
    """Traversal kernel against its plain version on the closest-hit
    queries of a trace, on every BVH that ``closest``, a
    ``make_bvh_closest_fn`` closure, walks, in its order: the detail form
    (:func:`traverse_case`: all 12 outputs and the two counters, bit for
    bit) and the record form the closure runs (:func:`record_case`: the
    five fields bit for bit, each tree's record merged into the one
    before); bounce 0 without a skip record and with the empty one the
    trace passes, later bounces with their previous hit, then the lane
    variants (:func:`lane_variants`) of bounce 1; and the closure's merged
    record against the grid oracle on a sample of ``ORACLE_SAMPLE`` rays.
    Where the closure walks more than one tree, a merge on rays that both
    trees hit must be among the cases.  Returns the record form's max abs
    error over the float outputs."""
    R = queries[0][0].shape[0]
    max_err, merged = 0.0, 0

    def walk_trees(name, o, d, skip):
        nonlocal max_err, merged
        prior = None
        for bvh in closest.bvhs:
            _, stats, _, plain = traverse_case(name, bvh, o, d, skip)
            err, prior, both = record_case(name, bvh, o, d, skip, plain,
                                           record_tri(scene, bvh), prior)
            max_err, merged = max(max_err, err), merged + both
            yield stats

    cases = [(0, None)] + [(b, queries[b][2]) for b in bounces
                           if b < len(queries)]
    for b, skip in cases:
        o, d, _ = queries[b]
        for _ in walk_trees(f"{label} bounce {b} skip={skip is not None}",
                            o, d, skip):
            pass
        if b in oracle_bounces:
            gen = torch.Generator(device=o.device)
            gen.manual_seed(b)
            idx = torch.randperm(R, generator=gen, device=o.device)
            sample = take_rays((o, d, skip), idx[:ORACLE_SAMPLE])
            want = grid_closest_hit(scene, *sample)
            if any(bvh.leaf_kind == "sph" for bvh in closest.bvhs):
                want = in_sphere_bvh_metric(scene, want, sample[1])
            against_oracle("traverse", f"{label} bounce {b} "
                           f"skip={skip is not None} vs grid oracle",
                           closest(scene, *sample), want, sample[1],
                           max_curvature(scene))
    b = min(1, len(queries) - 1)
    for name, query in lane_variants(queries[b], 61 + b):
        for stats in walk_trees(f"{label} bounce {b} {name}", *query):
            dead = parked(query[0])
            if bool(dead.any()):
                check(int(stats[dead, 0].max()) == 1
                      and int(stats[dead, 1].max()) == 0,
                      f"{label} {name}: a parked lane visits the root, "
                      f"nothing else")
    check(len(closest.bvhs) == 1 or merged > 0, f"{label}: a merge on "
          f"rays that both trees hit compared ({merged} rays)")
    return max_err


def traverse_times(label, bvh, queries, card):
    """Every bounce's traversal launch through ``bvh.select``, unsorted and
    sorted (``sort=True``: the key kernel, ``torch.sort`` and the
    traversal kernel reading the order).  The sorted outputs and counters
    are held bit-equal to the unsorted ones; then the unsorted wrapper by
    CUDA events over 10 calls, the device time of both forms by CUDA-graph
    replay (:func:`graph_ms`), and of the key, the sort and the walk in
    key order each on its own (beside two diagnostic orders), every kernel
    they launch by the profiler,
    the launch's bound from the kernel's own counters (the same for both
    forms: the counters are per ray), and the warp efficiency of both
    launch orders (:func:`warp_efficiency`).  Returns ``[{"ms",
    "device_ms", "sorted_ms", "key_ms", "sort_ms", "walk_ms",
    "gathered_ms", "parked_last_ms", "bound", "stats", "eff",
    "eff_sorted"}]`` per bounce."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.core import vecmath as vm

    eps = (vm.near_enough(torch.float32), vm.POSITION_EPS_F32)
    rows = []
    for b, query in enumerate(queries):
        o, d, skip = query

        def call(sort=False, query=query):
            return bvh.select(*query, *eps, want_detail=True, sort=sort)
        _, stats, bin_stats, _ = traverse_case(f"{label} bounce {b}", bvh,
                                               *query)
        key = ct.sort_key(o, d, bvh.root_min, bvh.root_max)
        order = bvh.ray_order(o, d)
        sk = bvh._skip(skip)
        ms = cuda_ms(call, 10)
        dev_ms = graph_ms(call, 20)
        sorted_ms = graph_ms(lambda: call(True), 20)
        key_ms = graph_ms(lambda: ct.sort_key(o, d, bvh.root_min,
                                              bvh.root_max), 20, calls=20)
        sort_ms = graph_ms(lambda: torch.sort(key, stable=True), 20)
        walk_ms = graph_ms(lambda: ct.traverse(
            bvh.wide, bvh.leaves, bvh.leaf_kind, o, d, sk, *eps,
            order=order), 20)
        # Two orders that tell the sort's parts apart: the rays copied into
        # key order beforehand (the walk without scattered reads and
        # stores), and the parked lanes last, the others in image order
        # (the compaction without the spatial sort).
        go, gd, gsk = take_rays(query, order)
        gathered_ms = graph_ms(lambda: ct.traverse(
            bvh.wide, bvh.leaves, bvh.leaf_kind, go, gd, bvh._skip(gsk),
            *eps), 20)
        del go, gd, gsk
        last = torch.sort(parked(o).to(torch.int32), stable=True).indices
        parked_last_ms = graph_ms(lambda: ct.traverse(
            bvh.wide, bvh.leaves, bvh.leaf_kind, o, d, sk, *eps,
            order=last), 20)
        parts = kernel_us(call, 5, TRAVERSE_KERNELS)
        sorted_parts = kernel_us(lambda: call(True), 5, TRAVERSE_KERNELS + 1)
        bnd = traverse_bound(bvh, stats, query)
        reached = reached_bound(ct.WIDE_WIDTH * 32, stats, query,
                                bvh.leaf_kind)
        reached_bin = reached_bound(32, bin_stats, query, bvh.leaf_kind)
        R = o.shape[0]
        n_alive = max(float((~parked(o)).sum()), 1.0)
        visited, tested = stats.float().mean(0).tolist()
        bin_visited = float(bin_stats[:, 0].float().mean())
        eff = warp_efficiency(stats[:, 0])
        eff_sorted = warp_efficiency(stats[:, 0], order)
        eff_last = warp_efficiency(stats[:, 0], last)
        dead_w = parked_warps(o, stats[:, 0])
        dead_ws = parked_warps(o, stats[:, 0], order)
        check(dead_ws[1] <= 1, f"{label} bounce {b}: the warps of parked "
              "lanes end at the root in key order")
        rows.append({"ms": ms, "device_ms": dev_ms, "sorted_ms": sorted_ms,
                     "key_ms": key_ms, "sort_ms": sort_ms,
                     "walk_ms": walk_ms, "gathered_ms": gathered_ms,
                     "parked_last_ms": parked_last_ms, "bound": bnd,
                     "reached": reached, "reached_binary": reached_bin,
                     "stats": stats, "eff": eff, "eff_sorted": eff_sorted})
        print(f"[time] traversal {label} bounce {b}: wrapper ms={ms:.4f} "
              f"device ms (CUDA graph) unsorted={fmt_ms(dev_ms)} sorted="
              f"{fmt_ms(sorted_ms)} (key {fmt_ms(key_ms)}, sort "
              f"{fmt_ms(sort_ms)}, walk in key order {fmt_ms(walk_ms)}; "
              f"walk on rays copied into key order {fmt_ms(gathered_ms)}, "
              f"walk with the parked lanes last {fmt_ms(parked_last_ms)}, "
              f"warp efficiency {eff_last:.4f}) "
              f"bound ms={bnd[0]:.4f} (by {bnd[1]}) reached-bytes bound ms "
              f"wide={reached:.4f} binary walk={reached_bin:.4f} lanes not "
              f"parked={n_alive / R:.4f} {ct.WIDE_WIDTH}-wide fetches per "
              f"ray={visited:.2f} box tests per ray="
              f"{visited * ct.WIDE_WIDTH:.2f} (binary nodes visited per "
              f"ray={bin_visited:.2f}) records tested per ray={tested:.2f} "
              f"warp efficiency "
              f"unsorted={eff:.4f} sorted={eff_sorted:.4f} warps all parked "
              f"unsorted={dead_w[0]} sorted={dead_ws[0]} of "
              f"{-(-R // WARP)} (most nodes a lane of them visited: "
              f"{dead_ws[1]}) sorted==unsorted on all 12 outputs and both "
              f"counters=True; stack {bvh.wide.depth} entries deep of "
              f"{ct.WIDE_STACK} on {card}")
        print(f"[time] traversal {label} bounce {b} kernels, us per call "
              f"(profiler): unsorted {parts_text(parts) or 'not measured'}; "
              f"sorted {parts_text(sorted_parts) or 'not measured'}")
    print(f"[time] traversal {label} kernel ({ct.WIDE_WIDTH}-wide): "
          + occupancy_text("traverse_kernel", TRAVERSE_THREADS))

    def total(k):
        return sum_or_none(r[k] for r in rows)
    print(f"[time] traversal {label} per pass ({len(rows)} launches): "
          f"wrapper ms sum={sum(r['ms'] for r in rows):.4f} device ms sum "
          f"unsorted={fmt_ms(total('device_ms'))} sorted="
          f"{fmt_ms(total('sorted_ms'))} (key {fmt_ms(total('key_ms'))}, "
          f"sort {fmt_ms(total('sort_ms'))}, walk in key order "
          f"{fmt_ms(total('walk_ms'))}; on rays copied into key order "
          f"{fmt_ms(total('gathered_ms'))}, parked lanes last "
          f"{fmt_ms(total('parked_last_ms'))}) bound ms sum="
          f"{sum(r['bound'][0] for r in rows):.4f} reached-bytes bound ms "
          f"sum wide={sum(r['reached'] for r in rows):.4f} binary walk="
          f"{sum(r['reached_binary'] for r in rows):.4f} on {card}")
    return rows


def record_stack_depths():
    """Print, and hold under the kernel's ``WIDE_STACK``, the stack depth
    of every wide tree the run packs (``CudaBVH`` calls the module's
    ``pack_wide_nodes``), with its packing time on the host clock: no
    builder bounds the depth, so the run shows the headroom of every tree
    it builds (:data:`STACK_DEPTHS`)."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct

    packer = ct.pack_wide_nodes

    def recording_packer(bvh, device="cpu"):
        t0 = time.perf_counter()
        wide = packer(bvh, device)
        pack_s = time.perf_counter() - t0
        STACK_DEPTHS.append(wide.depth)
        print(f"[bvh] packed {bvh.n_nodes} binary nodes into "
              f"{wide.table.shape[0]} {ct.WIDE_WIDTH}-wide nodes in "
              f"{pack_s:.4f} s: stack depth {wide.depth} of "
              f"{ct.WIDE_STACK}")
        check(wide.depth <= ct.WIDE_STACK, f"a tree of {bvh.n_nodes} nodes "
              f"needs {wide.depth} stack entries, the kernel has "
              f"{ct.WIDE_STACK}")
        return wide
    ct.pack_wide_nodes = recording_packer


def bvh_closest(scene):
    """The BVH tier's closest hit of a scene on the card, its tree from the
    native builder asked for by name (a missing host compiler fails the
    run): ``(closest, seconds to build and pack)``."""
    from raytracercore_tpu_torch.bvh.builder import build_bvh
    from raytracercore_tpu_torch.intersect.dispatch import \
        make_bvh_closest_fn

    t0 = time.perf_counter()
    closest = make_bvh_closest_fn(build_bvh(scene, backend="native"), scene,
                                  traversal="kernel")
    return closest, time.perf_counter() - t0


def ray_io_bytes(query, n_out_planes=12):
    """Bytes of a traversal's rays, skip record and output planes, each
    once."""
    o, d, skip = query
    n_bytes = nbytes(o, d) + o.shape[0] * 4 * n_out_planes
    if skip is not None:
        n_bytes += nbytes(skip.prim, skip.position, skip.normal, skip.inside)
    return n_bytes


def traverse_bound(bvh, stats, query):
    """The least time the card could take for one traversal: the slab
    tests (W a wide fetch) and leaf records that these rays' walks counted,
    and every input (wide nodes, leaf records, rays, skip record) and
    output plane once."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct

    fetched, tested = (int(x) for x in stats.sum(0))
    return bound(fetched * ct.WIDE_WIDTH * OPS_NODE
                 + tested * OPS_LEAF[bvh.leaf_kind],
                 nbytes(bvh.wide.table, bvh.leaves) + ray_io_bytes(query))


def reached_bound(node_bytes, stats, query, leaf_kind):
    """ms to move the bytes a walk reaches at the card's memory rate: its
    counters' node fetches of ``node_bytes`` each and records tested of
    the leaf kind's record, and the rays' I/O (:func:`ray_io_bytes`)."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct

    fetched, tested = (int(x) for x in stats.sum(0))
    n_bytes = (fetched * node_bytes + tested * 4 * ct.LEAF_KINDS[leaf_kind][1]
               + ray_io_bytes(query))
    return n_bytes / PEAK_BYTES * 1e3


def bvh_compare_scenes(card, dev):
    """The traversal kernel against its plain version and the grid oracle
    on a 5k-triangle mesh, a sphere field and an ellipsoid field at 256x256
    (triangle, sphere and ellipsoid leaves), and the BVH route against the
    select route on mesh-722 and on the Cornell scene (whose spheres and
    plane are the BVH route's dense tail), which both take.  Returns the max
    abs error kernel vs plain."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.intersect import cuda_select as cs
    from raytracercore_tpu_torch.scene import loader, meshgen
    from raytracercore_tpu_torch.scene.types import freeze_scene

    cornell = loader.parse(cornell_scene())
    cornell.recursion = BVH_REC
    scenes = [
        ("mesh-5k", meshgen.make_mesh_scene(
            grid=2, subdiv=3, recursion=BVH_REC, device=dev)[:2]),
        (f"spheres-{BVH_FIELD_GRID}", meshgen.make_sphere_field_scene(
            grid=BVH_FIELD_GRID, recursion=BVH_REC, device=dev)),
        (f"ellipsoids-{BVH_FIELD_GRID}", meshgen.make_sphere_field_scene(
            grid=BVH_FIELD_GRID, recursion=BVH_REC, ellipsoid=True,
            device=dev)),
        ("mesh-722", meshgen.make_mesh_scene(
            grid=MESH_GRID, subdiv=MESH_SUBDIV, recursion=BVH_REC,
            device=dev)[:2]),
        # 20 triangles in the BVH; 3 spheres and a plane in the dense tail.
        ("cornell", (freeze_scene(cornell, device=dev), cornell.cameras[0])),
    ]
    err, seen, tails = 0.0, set(), 0
    for name, (scene, host_cam) in scenes:
        closest, build_s = bvh_closest(scene)
        kinds = [b.leaf_kind for b in closest.bvhs]
        seen.update(kinds)
        rays = camera_rays_and_uniforms(scene, host_cam, COMPARE_SIZE, 41,
                                        dev)
        ct.traverse.launches = ct.traverse_record.launches = 0
        cs.closest_hit_fused.launches = 0
        queries = closest_hit_queries(scene, *rays, closest_fn=closest)
        check(ct.traverse.launches == ct.traverse_record.launches
              == len(queries) * len(kinds), f"{name}: one traversal "
              f"launch per BVH and bounce, each writing the record")
        has_tail = closest.tail is not None
        tails += has_tail
        check(cs.closest_hit_fused.launches == len(queries) * has_tail,
              f"{name}: one select launch per bounce for the dense tail")
        print(f"[traverse] {name}: BVHs {kinds}, dense tail "
              f"{closest.tail is not None}, build+pack s={build_s:.3f}")
        label = f"{name} {COMPARE_SIZE}x{COMPARE_SIZE}"
        err = max(err, compare_traverse(label, scene, closest, queries))
        if name in ("mesh-722", "cornell"):
            for b, query in enumerate(queries[:4]):
                against_oracle("traverse", f"{label} bounce {b}: BVH route "
                               "vs select route", closest(scene, *query),
                               cs.closest_hit_fused(scene, *query), query[1])
    check(seen == {"tri", "sph", "spht"}, "all three leaf kinds compared")
    check(tails > 0, "a scene with a dense tail compared")
    return err


def films_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("color_sum", "samples", "misses"))


def bvh_render_forms(card, dev, r, film):
    """The mesh-184k pass in the two forms beside the default (whose film
    after ``BVH_PASSES`` passes is ``film``): the other ``sort=`` than the
    default's, whose film must be bit-equal to the default's; and
    ``tile=BVH_TILE`` with the sort on, the JAX package's large-scene
    configuration, one pass of
    which must be bit-equal to the row-major pass drawn with the same
    jitter and uniforms moved to the tile order's pixels.  Quartiles of
    ``BVH_PASSES`` after ``WARM_PASSES`` each.  Returns the launches
    ``{"traverse", "sort_key"}`` of their timed passes."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.intersect.dispatch import \
        make_bvh_closest_fn
    from raytracercore_tpu_torch.render import camera as cam_mod
    from raytracercore_tpu_torch.render.film import Film
    from raytracercore_tpu_torch.render.renderer import (Renderer, pass_draws,
                                                         render_pass,
                                                         render_passes)

    scene = r.arrays
    n_bounces = scene.recursion + 1
    R = BVH_SIZE * BVH_SIZE
    launches = {"traverse": 0, "sort_key": 0}

    def timed(step, reset):
        """Host ms of ``BVH_PASSES`` synchronized calls ``step()`` after
        ``WARM_PASSES`` untimed ones and ``reset()``, the launch counts
        zeroed just before the timed calls."""
        for _ in range(WARM_PASSES):
            step()
        reset()
        ct.traverse.launches = ct.sort_key.launches = 0
        ms = []
        for _ in range(BVH_PASSES):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    # The other sort= through Renderer, the same seed: the same film.
    other = not r.closest_fn.sort
    r2 = Renderer(scene, device="cuda", seed=0, cameras=r.cameras,
                  closest_fn=make_bvh_closest_fn(r.bvh, scene,
                                                 traversal="kernel",
                                                 sort=other), graphs=False)
    ms2 = timed(lambda: r2.step(1), r2.reset)
    got = (ct.traverse.launches, ct.sort_key.launches)
    launches["traverse"] += got[0]
    launches["sort_key"] += got[1]
    check(got == (BVH_PASSES * n_bounces, BVH_PASSES * n_bounces * other),
          f"mesh-184k sort={other}: one traversal launch per bounce, the key "
          f"kernel before it where sorted ({got})")
    same = films_equal(r2.film, film)
    print(f"[coherence] mesh-184k 512x512 rec4 sort={other}, {BVH_PASSES} "
          f"passes: ms/pass min/p25/median/p75/max={quartiles(ms2)} film "
          f"bit-equal to the default's (sort={not other})={same} on {card}")
    check(same, f"mesh-184k: the sort={other} film bit-equal to the "
          "default's")
    del r2

    # tile=BVH_TILE with the sort on, pass k drawing as Renderer's pass k.
    tiled = make_bvh_closest_fn(r.bvh, scene, traversal="kernel", sort=True)
    box = {}

    def reset():
        box.update(film=Film.create(BVH_SIZE, BVH_SIZE, device=dev), k=0)

    def step3():
        box["film"] = render_passes(scene, r.camera, box["film"], 0,
                                    box["k"], 1, closest_fn=tiled,
                                    tile=BVH_TILE, graphs=False)
        box["k"] += 1
    reset()
    ms3 = timed(step3, reset)
    got = (ct.traverse.launches, ct.sort_key.launches)
    launches["traverse"] += got[0]
    launches["sort_key"] += got[1]
    check(got == (BVH_PASSES * n_bounces,) * 2,
          f"mesh-184k tile={BVH_TILE}: one key and one traversal launch per "
          f"bounce ({got})")
    tf = box["film"]
    check(bool(torch.isfinite(tf.color_sum).all())
          and float(tf.samples.sum() + tf.misses.sum()) == BVH_PASSES * R,
          f"mesh-184k tile={BVH_TILE}: film finite, one sample per pixel "
          "per pass")
    jitter, uniforms = pass_draws(0, 0, R, n_bounces, dev)
    px, py = cam_mod.pixel_grid_tiled(BVH_SIZE, BVH_SIZE, BVH_TILE,
                                      device=dev)
    perm = py * BVH_SIZE + px
    j2, u2 = torch.empty_like(jitter), torch.empty_like(uniforms)
    j2[perm] = jitter
    u2[..., perm] = uniforms
    blank = Film.create(BVH_SIZE, BVH_SIZE, device=dev)
    with torch.no_grad():
        a = render_pass(scene, r.camera, blank, jitter, uniforms,
                        closest_fn=tiled, tile=BVH_TILE)
        b = render_pass(scene, r.camera, blank, j2, u2, closest_fn=tiled)
        c = render_passes(scene, r.camera, blank, 0, 0, 1, closest_fn=tiled,
                          tile=BVH_TILE, graphs=False)
    same = films_equal(a, b) and films_equal(a, c)
    print(f"[coherence] mesh-184k 512x512 rec4 tile={BVH_TILE} + sort, "
          f"{BVH_PASSES} passes: ms/pass min/p25/median/p75/max="
          f"{quartiles(ms3)}; one pass bit-equal to the row-major pass on "
          f"the draws moved to the tile order's pixels={same} on {card}")
    check(same, f"mesh-184k tile={BVH_TILE}: the tiled pass bit-equal to "
          "the row-major pass on the reordered draws")
    return launches


def bvh_render_path(card, dev):
    """Main path 4: ``Renderer(accelerator="auto")`` on the 184,322-triangle
    mesh scene at 512x512 rec4 (the native builder, the bounce loop, one
    launch of the traversal kernel per bounce, after the key kernel where
    ``make_bvh_closest_fn`` sorts), then its two other forms
    (:func:`bvh_render_forms`).  Returns (launches ``{"traverse",
    "sort_key"}`` during the timed passes, the traversal's stage numbers,
    the key kernel's, the per-bounce rows of :func:`traverse_times`)."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.bvh.builder import build_bvh
    from raytracercore_tpu_torch.bvh.cuda_traverse import CudaBVH
    from raytracercore_tpu_torch.core import vecmath as vm
    from raytracercore_tpu_torch.render import shade_kernel as sk
    from raytracercore_tpu_torch.render.integrator import (
        shade_bounce_reference, trace)
    from raytracercore_tpu_torch.render.renderer import Renderer

    t0 = time.perf_counter()
    scene, host_cam = lit_mesh_scene(*BVH_MESH, BVH_SIZE, BVH_REC, dev)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = Renderer(scene, device="cuda", seed=0, cameras=[host_cam],
                 accelerator="auto", graphs=False)
    build_s = time.perf_counter() - t0
    scene = r.arrays
    n_tris = int((scene.triangles.prim_id >= 0).sum())
    check(n_tris == 184322 and scene.recursion == BVH_REC
          and (scene.width, scene.height) == (BVH_SIZE, BVH_SIZE),
          "main path 4 scene is mesh-184k at 512x512 rec4")
    check(r.route == "bvh", "mesh-184k takes the BVH route")
    bvhs = r.closest_fn.bvhs
    check(len(bvhs) == 1 and r.closest_fn.tail is None,
          "mesh-184k: one triangle BVH, no dense tail")
    n_bounces = scene.recursion + 1
    R = BVH_SIZE * BVH_SIZE
    t0 = time.perf_counter()
    r.step(WARM_PASSES)
    warm_s = time.perf_counter() - t0
    r.reset()
    ct.traverse.launches = ct.traverse_record.launches = 0
    ct.sort_key.launches = sk.shade_bounce.launches = 0
    pass_s = []
    for _ in range(BVH_PASSES):
        t0 = time.perf_counter()
        r.step(1)
        pass_s.append(time.perf_counter() - t0)
    launches = {"traverse": ct.traverse.launches,
                "traverse_record": ct.traverse_record.launches,
                "sort_key": ct.sort_key.launches,
                "shade_bounce": sk.shade_bounce.launches}
    st = r.status()
    sort_on = r.closest_fn.sort
    print(f"[bvh] launches during {BVH_PASSES} passes: {launches} "
          f"({n_bounces} bounces per pass, one BVH; sort by the rule: "
          f"{sort_on}, {bvhs[0].n_nodes} nodes x {bvhs[0].K} records a leaf)")
    check(launches == {"traverse": BVH_PASSES * n_bounces,
                       "traverse_record": BVH_PASSES * n_bounces,
                       "sort_key": BVH_PASSES * n_bounces * sort_on,
                       "shade_bounce": BVH_PASSES * n_bounces},
          f"main path 4 launched the traversal (writing the record) and "
          f"shading kernels once per bounce, the key kernel before the walk "
          f"where the rule sorts ({launches})")
    film = r.film
    film_default = film   # Film.add_full_frame makes a new film
    check(all(bool(torch.isfinite(t).all()) for t in
              (film.color_sum, film.samples, film.misses)),
          "mesh-184k film is finite")
    check(float(film.samples.sum() + film.misses.sum()) == BVH_PASSES * R,
          "mesh-184k: one sample per pixel per pass")
    image_stage(card, r, "mesh-184k")
    img = r.image()
    check(img.shape == (BVH_SIZE, BVH_SIZE, 4) and img.dtype == np.uint8,
          "mesh-184k image is 512x512 RGBA uint8")
    check(int(img[..., :3].max()) > 50, "mesh-184k image is lit (max > 50)")
    med_s = float(np.median(pass_s))
    print(f"[bvh] mesh-184k ({n_tris} triangles, {bvhs[0].n_nodes} nodes, "
          f"leaf size {bvhs[0].K}) 512x512 rec4, {BVH_PASSES} passes: "
          f"samples/px/sec={st['samples_per_px_per_sec']:.4f} "
          f"paths/sec={st['paths_per_sec']:.4e} "
          f"wavefront rays/sec={R * n_bounces / med_s:.4e} "
          f"ms/pass min/p25/median/p75/max="
          f"{quartiles(np.asarray(pass_s) * 1e3)} "
          f"scene generation s={gen_s:.3f} Renderer (BVH build + pack) s="
          f"{build_s:.3f} warm-up s={warm_s:.3f} ({WARM_PASSES} passes) "
          f"image max={int(img[..., :3].max())} "
          f"mean={float(img[..., :3].mean()):.3f} on {card}")
    print("[bvh] ms of each pass: "
          + " ".join(f"{x * 1e3:.3f}" for x in pass_s))
    for k, v in bvh_render_forms(card, dev, r, film_default).items():
        launches[k] += v
    busy, top = device_busy(lambda i: r.step(1), 4)
    print(f"[profile] 4 mesh-184k passes: device busy {busy:.1f} % of the "
          f"span on {card}")
    print(f"[profile] top kernels, device us per pass: {top}")

    # The traversal kernel at the main path's shapes: its queries,
    # compared, then every bounce's launch timed beside its bound.
    rays = camera_rays_and_uniforms(scene, host_cam, BVH_SIZE, 11, dev)
    queries = closest_hit_queries(scene, *rays, closest_fn=r.closest_fn)
    check(len(queries) == n_bounces, "one closest-hit query per bounce")
    err = compare_traverse("mesh-184k 512x512", scene, r.closest_fn, queries)
    eps = (vm.near_enough(torch.float32), vm.POSITION_EPS_F32)
    check_no_sync("traversal kernel wrapper CudaBVH.select, mesh-184k "
                  "bounce 1", lambda: bvhs[0].select(
                      *queries[1], *eps, want_detail=True))
    check_no_sync("CudaBVH.select(sort=True) (key kernel, torch.sort, "
                  "traversal in key order), mesh-184k bounce 1",
                  lambda: bvhs[0].select(*queries[1], *eps,
                                         want_detail=True, sort=True))
    bvh = bvhs[0]
    tri = record_tri(scene, bvh)
    check(tri is not None, "mesh-184k: the record epilogue reads the "
          "smooth normals")
    check_no_sync("the record form CudaBVH.record, mesh-184k bounce 1",
                  lambda: bvh.record(*queries[1], *eps, tri=tri))
    # The key kernel against its plain version on every bounce's rays and
    # the lane variants of bounce 1, then timed on bounce 1's.
    key_err = max(key_case(f"mesh-184k 512x512 bounce {b}", bvh, o, d)
                  for b, (o, d, _) in enumerate(queries))
    for name, (o, d, _) in lane_variants(queries[1], 62):
        key_err = max(key_err, key_case(f"mesh-184k 512x512 bounce 1 {name}",
                                         bvh, o, d))
    o1, d1 = queries[1][0], queries[1][1]
    key_args = (o1, d1, bvh.root_min, bvh.root_max)
    key_stage = {
        "ms": graph_ms(lambda: ct.sort_key(*key_args), 20, calls=20),
        "plain_ms": cuda_ms(lambda: ct.sort_key_reference(*key_args), 5),
        "bound": bound(o1.shape[0] * OPS_KEY,
                       nbytes(o1, d1) + o1.shape[0] * 4),
        "max_abs_err": key_err}
    print(f"[time] sort_key mesh-184k bounce 1 (R={o1.shape[0]}): kernel "
          f"device ms (CUDA graph)={fmt_ms(key_stage['ms'])} plain ms="
          f"{key_stage['plain_ms']:.4f} bound ms={key_stage['bound'][0]:.5f} "
          f"(by {key_stage['bound'][1]}) on {card}; "
          + occupancy_text("sort_key_kernel", 256))

    def run(b, **kw):
        return bvh.select(*queries[b], *eps, want_detail=True, **kw)
    times = traverse_times("mesh-184k 512x512", bvh, queries, card)
    k_ms_again = cuda_ms(lambda: run(0), 10)
    # The kernels line's traversal entry is the record form, the one the
    # main path launches: bounce 0 by CUDA-graph replay, and its plain
    # version (the wide walk, then the chain of torch ops).
    o0, d0, skip0 = queries[0]
    rec_ms = [graph_ms(lambda q=q: bvh.record(*q, *eps, tri=tri), 20)
              for q in queries]
    plain_ms = cuda_ms(lambda: ct.record_reference(ct.traverse_wide_reference(
        bvh.wide, bvh.leaves, bvh.leaf_kind, o0.float().contiguous(),
        d0.float().contiguous(), bvh._skip(skip0), *eps), tri), 1)
    print(f"[time] traversal kernel mesh-184k 512x512, record form (smooth "
          f"normals in the epilogue): device ms per bounce (CUDA graph) "
          + " ".join(fmt_ms(x) for x in rec_ms)
          + "; detail form " + " ".join(fmt_ms(t["device_ms"])
                                        for t in times)
          + f"; plain record ms (one walk and the chain, bounce 0)="
          f"{plain_ms:.3f} on {card}")
    with torch.no_grad():
        hits = [r.closest_fn(scene, *q) for q in queries]

    def shading_only(shade_fn=None):
        it = iter(hits)
        with torch.no_grad():
            trace(scene, rays[0], rays[1], None,
                  closest_fn=lambda *_: next(it), uniforms=rays[2],
                  shade_fn=shade_fn)
    shade_ms = cuda_ms(shading_only, 5) / n_bounces
    plain_shade_ms = cuda_ms(
        lambda: shading_only(shade_bounce_reference), 5) / n_bounces
    closest_ms = cuda_ms(lambda: r.closest_fn(scene, *queries[1]), 10)
    print(f"[time] traversal kernel mesh-184k 512x512: bounce 0 again ms="
          f"{k_ms_again:.3f} whole closest hit (the record form, bounce 1) "
          f"ms={closest_ms:.3f}"
          f"; the bounce loop fed its hits, ms per bounce (CUDA events, "
          f"eager): shading kernel {shade_ms:.3f}, eager plain shading "
          f"{plain_shade_ms:.3f} on {card}")
    del hits
    shade = shade_stage(card, "mesh-184k 512x512", scene, shade_inputs(
        scene, *rays, r.closest_fn), 64)
    # A parked lane (a finished path, moved far outside the scene) fails the
    # root's slab test and ends its walk there.
    for b in range(1, n_bounces):
        dead = parked(queries[b][0])
        if bool(dead.any()):
            stats = times[b]["stats"]
            check(int(stats[dead, 0].max()) == 1
                  and int(stats[dead, 1].max()) == 0,
                  f"bounce {b}: a parked lane visits the root, nothing else")

    # Leaf size: the same five queries through trees of these leaf sizes,
    # each built anew and its device time taken in turn by CUDA-graph
    # replay (the winner does not depend on the leaf size but on exact
    # ties); printed beside config.BVH_LEAF_SIZE's, not gated.
    want_row = [run(b)[0] for b in range(n_bounces)]
    sums = {}
    for leaf in BVH_LEAF_SIZES:
        t0 = time.perf_counter()
        other = CudaBVH(build_bvh(scene, leaf_size=leaf, backend="native"),
                        scene.triangles, scene.materials, scene.n_prims)
        leaf_s = time.perf_counter() - t0

        def run_other(b, **kw):
            return other.select(*queries[b], *eps, want_detail=True, **kw)
        ms = [graph_ms(lambda b=b: run_other(b), 20)
              for b in range(n_bounces)]
        check(None not in ms, f"leaf size {leaf}: device time measured")
        visited, tested = run_other(0, want_stats=True)[4].float().mean(
            0).tolist()
        same = min(float((run_other(b)[0] == want_row[b]).float().mean())
                   for b in range(n_bounces))
        print(f"[time] traversal kernel mesh-184k 512x512 leaf size {leaf} "
              f"({other.n_nodes} nodes, build+pack s={leaf_s:.3f}): device "
              f"ms per bounce " + " ".join(f"{x:.3f}" for x in ms)
              + f" sum={sum(ms):.3f} bounce 0 wide fetches per ray="
              f"{visited:.2f} records tested per ray={tested:.2f} rows equal "
              f"to leaf size {bvh.K}'s on >= {same:.6f} of the rays on {card}")
        check(same >= 0.999, f"leaf size {leaf}: same winners but for ties")
        sums[leaf] = sum(ms)
        del other
    best = min(sums, key=sums.get)
    # Printed, not gated: no gate of this script compares times.
    print(f"[time] leaf size: fastest {best} ({sums[best]:.3f} ms over the "
          f"{n_bounces} bounces), config.BVH_LEAF_SIZE {bvh.K} "
          f"({sums.get(bvh.K, float('nan')):.3f} ms); the default within "
          f"10 % of the fastest: "
          f"{sums.get(bvh.K, float('inf')) <= 1.1 * sums[best]}")
    rec0_ms = (rec_ms[0] if rec_ms[0] is not None else
               cuda_ms(lambda: bvh.record(*queries[0], *eps, tri=tri), 10))
    stage = {"ms": rec0_ms, "plain_ms": plain_ms, "bound_ms": times[0]["bound"][0],
             "bound_by": times[0]["bound"][1], "max_abs_err": err}
    return launches, stage, key_stage, times, shade


def bvh_big_pass(card, dev):
    """One timed pass of the 1,003,522-triangle mesh scene at 1024x1024
    rec4 through ``Renderer`` (after one untimed pass), then the traversal
    alone, unsorted and sorted, on every bounce of that size.  Returns
    (launches ``{"traverse", "sort_key", "shade_bounce"}`` of the two
    passes, the rows of :func:`traverse_times`)."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.render import shade_kernel as sk
    from raytracercore_tpu_torch.render.renderer import Renderer

    t0 = time.perf_counter()
    scene, host_cam = lit_mesh_scene(*BVH_BIG_MESH, BVH_BIG_SIZE, BVH_REC,
                                     dev)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = Renderer(scene, device="cuda", seed=0, cameras=[host_cam],
                 graphs=False)
    build_s = time.perf_counter() - t0
    n_tris = int((r.arrays.triangles.prim_id >= 0).sum())
    check(n_tris == 1003522 and r.route == "bvh",
          "mesh-1M has 1,003,522 triangles and takes the BVH route")
    times = []
    ct.traverse.launches = ct.traverse_record.launches = 0
    ct.sort_key.launches = sk.shade_bounce.launches = 0
    for _ in range(2):
        t0 = time.perf_counter()
        r.step(1)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"traverse": ct.traverse.launches,
                "traverse_record": ct.traverse_record.launches,
                "sort_key": ct.sort_key.launches,
                "shade_bounce": sk.shade_bounce.launches}
    check(launches == {"traverse": 2 * (BVH_REC + 1),
                       "traverse_record": 2 * (BVH_REC + 1),
                       "sort_key": 2 * (BVH_REC + 1) * r.closest_fn.sort,
                       "shade_bounce": 2 * (BVH_REC + 1)},
          f"mesh-1M launched the traversal (writing the record) and shading "
          f"kernels once per bounce, the key kernel before the walk where "
          f"the rule sorts ({launches})")
    film = r.film
    check(bool(torch.isfinite(film.color_sum).all())
          and float(film.samples.sum() + film.misses.sum())
          == 2 * BVH_BIG_SIZE ** 2, "mesh-1M film finite, one sample per "
          "pixel per pass")
    graphed = graph_big_pass(card, r)
    add_counts(launches, {k: graphed[k] for k in launches})
    check(launches["traverse_record"] == launches["traverse"],
          f"mesh-1M: every traversal launch wrote the record ({launches})")
    bvh = r.closest_fn.bvhs[0]
    R = BVH_BIG_SIZE ** 2
    print(f"[bvh] mesh-1M ({n_tris} triangles, {bvh.n_nodes} nodes, leaf "
          f"size {bvh.K}) 1024x1024 rec4: first pass ms={times[0]:.3f} "
          f"second pass ms={times[1]:.3f} = "
          f"{1e3 / times[1]:.4f} samples/px/sec, "
          f"{R * (BVH_REC + 1) / (times[1] * 1e-3):.4e} wavefront rays/sec; "
          f"scene generation s={gen_s:.3f} Renderer (BVH build + pack) s="
          f"{build_s:.3f} peak device memory MB="
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} sort by the "
          f"rule: {r.closest_fn.sort} on {card}")
    # The kernel alone on every bounce: this tree does not fit the L2.
    rays = camera_rays_and_uniforms(r.arrays, host_cam, BVH_BIG_SIZE, 11, dev)
    queries = closest_hit_queries(r.arrays, *rays, closest_fn=r.closest_fn)
    del rays
    return launches, traverse_times("mesh-1M 1024x1024", bvh, queries, card)


def graph_big_pass(card, r):
    """The graphed mesh-1M pass: the module-level ``render_passes`` on the
    eager renderer ``r``'s scene, route and camera after its first two
    passes (0 and 1), captured and replayed over the same passes.  Gates:
    the film bit-equal to ``r``'s, the kernels a replay runs.  Times one
    more graphed pass beside the eager one.  Returns the launches of the
    graphed calls."""
    from raytracercore_tpu_torch.render.film import Film
    from raytracercore_tpu_torch.render.renderer import (PASS_GRAPHS,
                                                         render_passes)

    before = read_counts()
    h, w = r.film.shape
    kw = {"closest_fn": r.closest_fn, "trace_fn": r.trace_fn}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = render_passes(r.arrays, r.camera, Film.create(h, w, device=r.device),
                        r.seed, 0, 2, **kw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    check(films_equal(got, r.film), "mesh-1M 1024x1024: graphed film of "
          "passes 0-1 bit-equal to the eager Renderer's")
    pg = next(iter(PASS_GRAPHS.entries.values()))
    with tempfile.TemporaryDirectory() as tmp:
        kern = graph_kernels("mesh-1M pass", pg.captured,
                             {**bvh_kernels(r), "pass_rays": 1}, tmp)
    ms_g, ms_e = interleaved((
        lambda: render_passes(r.arrays, r.camera, got, r.seed, 2, 1, **kw),
        lambda: render_passes(r.arrays, r.camera, got, r.seed, 2, 1,
                              graphs=False, **kw)), 1)
    PASS_GRAPHS.clear()
    print(f"[graph] mesh-1M 1024x1024 rec4 pass: graphed film of 2 passes "
          f"bit-equal to the eager passes; first call ms={first_ms:.1f} "
          f"(warm-up, capture, 2 replays); {kern}; pass 2 ms graphed="
          f"{ms_g[0]:.3f} eager={ms_e[0]:.3f} on {card}")
    return {k: v - before[k] for k, v in read_counts().items()}


def coherence_verdict(card, scenes):
    """The sorted ``select`` against the unsorted one, device ms summed
    over every bounce of each scene (rows of :func:`traverse_times`) and
    over both, with the warp efficiency per bounce: the measurement that
    ``make_bvh_closest_fn(sort=None)`` is read against.  Returns (unsorted
    ms, sorted ms) over both scenes."""
    total = [0.0, 0.0]
    for label, rows in scenes.items():
        unsorted = sum_or_none(r["device_ms"] for r in rows)
        srt = sum_or_none(r["sorted_ms"] for r in rows)
        check(None not in (unsorted, srt),
              f"{label}: both forms' device time measured")
        total[0] += unsorted
        total[1] += srt
        print(f"[coherence] {label} per bounce, device ms unsorted / sorted "
              f"(warp efficiency unsorted / sorted): "
              + "; ".join(f"{r['device_ms']:.4f} / {r['sorted_ms']:.4f} "
                          f"({r['eff']:.3f} / {r['eff_sorted']:.3f})"
                          for r in rows)
              + f"; sums {unsorted:.4f} / {srt:.4f} on {card}")
    print(f"[coherence] both scenes, device ms summed over the bounces: "
          f"unsorted {total[0]:.4f} sorted {total[1]:.4f} (sorted / "
          f"unsorted {total[1] / total[0]:.3f}): the sort "
          f"{'pays' if total[1] < total[0] else 'does not pay'} on {card}")
    return tuple(total)


def bvh_train_path(card, dev):
    """Main path 5: the train step of the 46,082-triangle mesh scene at
    512x512 rec4: recorded by the bounce loop with the traversal kernel, its
    colour from the replay forward kernel and its gradient from the replay
    backward kernel, both reading the 46,082-row material table from device
    memory.  Returns ({kernel name: launches} of the timed steps, the
    replay kernels' max abs errors, their times)."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.render import replay_kernel as rk
    from raytracercore_tpu_torch.render import shade_kernel as sk
    from raytracercore_tpu_torch.render import uniforms_kernel as uk
    from raytracercore_tpu_torch.render.renderer import Renderer

    scene, host_cam = lit_mesh_scene(*BVH_TRAIN_MESH, BVH_SIZE, BVH_REC, dev)
    t0 = time.perf_counter()
    r = Renderer(scene, device="cuda", seed=0, cameras=[host_cam],
                 graphs=False)
    build_s = time.perf_counter() - t0
    n_tris = int((r.arrays.triangles.prim_id >= 0).sum())
    n_mats = r.arrays.materials.emission.shape[0]
    check(n_tris == 46082 and r.route == "bvh"
          and n_mats > rk.MAX_KERNEL_MATS,
          "main path 5 scene is mesh-46k on the BVH route, its material "
          "table above the replay kernels' shared-memory cap")
    print(f"[bvh-train] mesh-46k: {n_tris} triangles, {n_mats} material "
          f"rows, Renderer (BVH build + pack) s={build_s:.3f}")
    label = "mesh-46k 512x512 rec4"
    errs, times = replay_on_path(label, r, r.closest_fn, card, dev)
    n_bounces = r.arrays.recursion + 1
    counts = train_steps(
        "bvh-train", label, r, r.closest_fn, r.closest_fn,
        {"traverse": (ct.traverse, n_bounces),
         "traverse_record": (ct.traverse_record, n_bounces),
         "sort_key": (ct.sort_key, n_bounces * r.closest_fn.sort),
         "shade_bounce": (sk.shade_bounce, n_bounces),
         "prepare_uniforms_kernel": (uk.prepare_uniforms_kernel, 1),
         "replay_fwd": (rk.replay_fwd, 1), "replay_bwd": (rk.replay_bwd, 1)},
        MESH_TARGET_SPP, card, dev)
    add_counts(counts, sorted_step(card, dev, r))
    return counts, errs, times


def sorted_step(card, dev, r):
    """One Adam step of the mesh-46k scene with ``sort=True`` against one
    with ``sort=False`` from the same parameters and seed: the loss, every
    gradient and every parameter after the step bit-equal.  Returns the
    sorted step's launches ``{"traverse", "sort_key"}``."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.intersect.dispatch import \
        make_bvh_closest_fn
    from raytracercore_tpu_torch.render.renderer import pass_seed

    fns = {sort: make_bvh_closest_fn(r.bvh, r.arrays, traversal="kernel",
                                     sort=sort) for sort in (False, True)}
    seed = pass_seed(TRAIN_SEED, 500)
    want = one_step(None, r.arrays, r.camera, seed, dev,
                    closest_fn=fns[False], adam=True)
    ct.traverse.launches = ct.traverse_record.launches = 0
    ct.sort_key.launches = 0
    got = one_step(None, r.arrays, r.camera, seed, dev,
                   closest_fn=fns[True], adam=True)
    launches = {"traverse": ct.traverse.launches,
                "traverse_record": ct.traverse_record.launches,
                "sort_key": ct.sort_key.launches}
    n_bounces = r.arrays.recursion + 1
    check(launches == {"traverse": n_bounces, "traverse_record": n_bounces,
                       "sort_key": n_bounces},
          f"mesh-46k sorted step: one key and one traversal launch per "
          f"bounce ({launches})")
    differ = [f"{what} {k}" for what, i in (("gradient", 1), ("param", 2))
              for k in want[i] if not torch.equal(got[i][k], want[i][k])]
    same_loss = float(got[0]) == float(want[0])
    print(f"[bvh-train] mesh-46k 512x512 rec4 one Adam step sort=True vs "
          f"sort=False: loss {float(got[0]):.9f} vs {float(want[0]):.9f} "
          f"bit-equal={same_loss}; gradients and params bit-equal="
          f"{not differ} {differ or ''}; ms {got[3]:.3f} vs {want[3]:.3f} "
          f"(each the first step of its closest hit) on {card}")
    check(same_loss and not differ, "mesh-46k: the sorted step bit-equal "
          f"to the unsorted one (loss {same_loss}, differing {differ})")
    return launches


def quartiles(ms):
    return "/".join(f"{x:.3f}" for x in
                    np.percentile(np.asarray(ms), [0, 25, 50, 75, 100]))


def train_path(card, dev):
    """Main path 2: the material-gradient train step at 700x700 rec10.
    Returns {kernel name: launches} summed over both routes' timed steps,
    the stage times and the train-path kernels' bounds."""
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
    host = loader.parse(cornell_scene())
    r = Renderer(host, device=dev, seed=TRAIN_SEED, graphs=False)
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
    routes = (("record-as-primal",
               lambda opt: make_train_step(None, opt, graphs=False)),
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
    step = make_train_step(None, adam, graphs=False)
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

    # The least time the card could take for each train-path kernel: the
    # bounces the paths really reach (from the tape), the bytes of each
    # input and output once.
    from raytracercore_tpu_torch.render.integrator import PathTape
    live = int(((tape.flags & PathTape.CODE_MASK) != 0).sum())
    tape_bytes = nbytes(tape.prim, tape.flags, tape.nx, tape.ny, tape.nz)
    n_blocks = -(-n_paths // rk.REPLAY_BLOCK)
    # The forward stops a path at its end, so its bound counts the bytes
    # this run's tape needs, by each bounce's code (fwd_reached_bytes);
    # beside it the bound of every input and output once, as before the
    # forward stopped early.
    fwd_every_byte = bound(
        live * OPS_SHADE,
        nbytes(ray_d, u, matf, scf, color) + tape_bytes + n_paths * 4)
    fwd_reached = fwd_reached_bytes(tape, matf, scf)
    bounds = {
        "uniforms": bound(n_paths * n_bounces * OPS_UNIFORMS, nbytes(u)),
        "replay forward": bound(live * OPS_SHADE, fwd_reached),
        "replay backward": bound(
            live * (OPS_SHADE + OPS_SHADE_BWD),
            nbytes(ray_d, u, matf, scf, ct) + tape_bytes
            + n_blocks * matf.numel() * 4),
    }

    print(f"[bound] replay forward cornell 700x700 rec10: "
          f"{fwd_every_byte[0]:.4f} ms (every input and output once, by "
          f"{fwd_every_byte[1]}); reached-bytes bound "
          f"{bounds['replay forward'][0]:.4f} ms (by "
          f"{bounds['replay forward'][1]}; {fwd_reached} bytes the tape's "
          f"codes need), the kernels line's")

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
    # One kernel launch each: device time by CUDA-graph replay (CUDA events
    # around such a short call read the host's time).
    one_kernel = {"uniforms", "record (megakernel, tape on)",
                  "replay forward", "replay backward"}
    times = {}
    for name, kernel_fn, plain_fn, n_k, n_p in stages:
        graph = name in one_kernel
        k_ms = graph_ms(kernel_fn, n_k) if graph else cuda_ms(kernel_fn, n_k)
        p_ms = cuda_ms(plain_fn, n_p) if plain_fn is not None else None
        times[name] = (k_ms, p_ms)
        print(f"[stage] {name}: kernel path ms"
              + (" (device, CUDA graph)" if graph else "")
              + f"={fmt_ms(k_ms)} plain ms="
              + (f"{p_ms:.3f}" if p_ms is not None else "n/a")
              + f" on {card}")
    for kind in ("fwd", "bwd"):
        occ = replay_occupancy(kind, matf.shape[0], n_bounces, aim, n_paths)
        print(f"[stage] replay {kind} kernel: {occ}")
    print(f"[stage] uniforms kernel: "
          f"{occupancy_text('uniforms_kernel', UNIFORMS_THREADS)}")

    busy, top = device_busy(
        lambda i: step(params, scene, camera, target, 100 + i), PROFILE_STEPS)
    print(f"[profile] {PROFILE_STEPS} train steps: device busy {busy:.1f} % "
          f"of the span on {card}")
    print(f"[profile] top kernels, device us per step: {top}")
    return launches, times, bounds


# --- --times: device times of two trees in one call ----------------------

def warp_row_share(tape):
    """Share of the live bounces whose warp (32 paths in index order, all
    at the same bounce) has >= 8 live lanes on the same material row."""
    prim = tape.prim.long()
    live = (tape.flags & 0xF) != 0
    B, R = prim.shape
    p = torch.where(live, prim, -1)[:, :R // 32 * 32].reshape(B, -1, 32)
    same = (p[..., :, None] == p[..., None, :]).sum(-1)
    return float(((same >= 8) & (p >= 0)).sum()) / max(1, int((p >= 0).sum()))


def fwd_times(label, scene, d, u, tape):
    """The replay forward on a recorded tape: held bit-equal (colour and
    miss) to the plain version (fails the run otherwise), then timed twice
    by CUDA-graph replay, with the achieved rate over the bytes the bounces
    reached need (:func:`fwd_reached_bytes`), the share of warps (32 paths
    in index order) whose paths end on different bounces, registers and
    the launched grid's resident warps."""
    from raytracercore_tpu_torch.render import replay_kernel as rk

    matf, scf = rk.material_table(scene)
    aim = scene.ambient_is_miss
    B, R = tape.prim.shape
    n_mats = matf.shape[0]
    ref_c, ref_m = rk.replay_fwd_reference(d, u, tape, matf, scf, aim)
    live = (tape.flags & 0xF) != 0
    ends = live.sum(0)[:R // 32 * 32].reshape(-1, 32)
    reached = fwd_reached_bytes(tape, matf, scf)
    row = {"material_rows": n_mats, "bounces": B,
           "live_bounces": int(live.sum()),
           "live_bounces_per_path": float(live.sum()) / R,
           "warps_ending_apart": float(
               (ends.max(1).values != ends.min(1).values).float().mean()),
           "reached_bytes": reached,
           "reached_bound_ms": reached / PEAK_BYTES * 1e3}
    c, m = rk.replay_fwd(d, u, tape, matf, scf, aim)
    torch.cuda.synchronize()
    check(torch.equal(c, ref_c) and torch.equal(m, ref_m),
          f"{label}: replay forward colour and miss bit-equal to the plain "
          f"version (max abs diff {float((c - ref_c).abs().max()):.3e})")
    ms = [graph_ms(lambda: rk.replay_fwd(d, u, tape, matf, scf, aim), 20)
          for _ in range(2)]
    row["ms"] = ms
    row["reached_GB_per_s"] = [None if t is None else reached / t * 1e-6
                               for t in ms]
    row["occupancy"] = replay_occupancy("fwd", n_mats, B, aim, R)
    print(f"[times] replay forward {label}: {row}", flush=True)
    return row


def replay_times(res, label, scene, d, u, tape):
    """:func:`fwd_times` and :func:`bwd_times` at one point, into
    ``res["fwd"]`` and ``res["bwd"]``."""
    res["fwd"][label] = fwd_times(label, scene, d, u, tape)
    res["bwd"][label] = bwd_times(label, scene, d, u, tape)


def bwd_times(label, scene, d, u, tape):
    """The replay backward on a recorded tape: held within ``GRAD_TOL`` of
    max|g| per field of the plain version (fails the run otherwise), then
    timed twice by CUDA-graph replay: as the wrapper places the bounce
    entries, and with them forced (``STASH_IN_SHARED``) into shared memory
    and into local memory in turn."""
    from raytracercore_tpu_torch.render import replay_kernel as rk

    matf, scf = rk.material_table(scene)
    aim = scene.ambient_is_miss
    B = tape.prim.shape[0]
    color, miss = rk.replay_fwd(d, u, tape, matf, scf, aim)
    ct = (torch.where(miss[:, None], 0.0, 2.0 * color)
          / color.numel()).contiguous()
    ref = rk.replay_bwd_reference(d, u, tape, matf, scf, aim, ct)
    row = {"material_rows": matf.shape[0], "bounces": B,
           "live_bounces": int(((tape.flags & 0xF) != 0).sum()),
           "warp_row_share_ge8": warp_row_share(tape), "worst_rel": 0.0,
           "ms": {}, "occupancy": {}}
    placements = {"chosen": None, "shared stash": True,
                  "local stash": False}
    try:
        for name, force in placements.items():
            if force is not None:
                rk.STASH_IN_SHARED = force
            g = rk.replay_bwd(d, u, tape, matf, scf, aim, ct)
            torch.cuda.synchronize()
            worst = max(float((g[:, a:b] - ref[:, a:b]).abs().max())
                        / max(float(ref[:, a:b].abs().max()), 1e-30)
                        for a, b in FIELD_COLS.values())
            check(bool(torch.isfinite(g).all()) and worst <= GRAD_TOL,
                  f"{label}, {name}: replay backward within {GRAD_TOL} of "
                  f"max|g| ({worst:.3e})")
            row["worst_rel"] = max(row["worst_rel"], worst)
            row["ms"][name] = [graph_ms(lambda: rk.replay_bwd(
                d, u, tape, matf, scf, aim, ct), 20) for _ in range(2)]
            row["occupancy"][name] = replay_occupancy("bwd", matf.shape[0], B,
                                                      aim)
    finally:
        rk.STASH_IN_SHARED = None
    print(f"[times] replay backward {label}: {row}", flush=True)
    return row


def traced_tape(scene, camera, closest_fn, seed):
    """A tape recorded by the bounce loop (``trace``) on the camera's rays
    and the uniforms kernel's draws: ``(ray_d, uniforms, tape)``."""
    from raytracercore_tpu_torch.parallel.shard import step_rays
    from raytracercore_tpu_torch.render import uniforms_kernel as uk
    from raytracercore_tpu_torch.render.integrator import trace
    from raytracercore_tpu_torch.render.renderer import pass_seed

    h, w = scene.height, scene.width
    o, d, path_seed = step_rays(camera, h, w, pass_seed(seed, 999))
    u = uk.prepare_uniforms_kernel(path_seed, h * w, scene.recursion + 1,
                                   o.device)
    with torch.no_grad():
        tape = trace(scene, o, d, None, closest_fn=closest_fn, uniforms=u,
                     want_tape=True)[2]
    return d, u, tape


def times_main(label, card):
    """``--times``: the megakernel on cornell 700x700 rec10, tape on and
    off (held bit-equal first); the replay forward and backward
    (:func:`replay_times`) on cornell (24 material rows) at rec 10, 20 and
    31, mesh-722 700x700 (722 rows) at rec 10 and 31, and mesh-46k 512x512
    rec4 (global table); the select kernel on every bounce of a mesh-722
    pass: each by CUDA-graph replay, twice.  Prints one JSON line; a failed
    check exits non-zero."""
    import raytracercore_tpu_torch as pkg
    from raytracercore_tpu_torch import kernels
    from raytracercore_tpu_torch.intersect import cuda_select
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render.renderer import Renderer

    dev = torch.device("cuda", 0)
    info = kernels.build()
    kernels.load()
    BUILD_REGS.update(ptxas_registers(info["log"]))
    res = {"label": label, "package": str(Path(pkg.__file__).parent),
           "card": card, "build_s": info["seconds"], "fwd": {}, "bwd": {}}
    print(f"[times] {label}: {res['package']} on {card}", flush=True)

    arrays, o, d, u = rays_and_uniforms(cornell_scene(), 700, 10, 7, dev)
    compare(f"{label} cornell 700x700 rec10", arrays, o, d, u)
    tape = fused.trace_fused(arrays, o, d, u, want_tape=True)[2]
    res["path_length_histogram"] = torch.bincount(
        ((tape.flags & 0xF) != 0).sum(0), minlength=12).tolist()
    res["fused"] = {"tape" if want else "no_tape": [graph_ms(
        lambda: fused.trace_fused(arrays, o, d, u, want_tape=want), 20)
        for _ in range(2)] for want in (False, True)}
    res["fused"]["occupancy"] = occupancy_text(
        "trace_fused_kernel", FUSED_THREADS,
        nbytes(*arrays.fused_tables))
    print(f"[times] megakernel: {res['fused']}", flush=True)
    replay_times(res, "cornell rec10", arrays, d, u, tape)
    del tape
    for rec in (20, 31):
        arrays, o, d, u = rays_and_uniforms(cornell_scene(), 700, rec, 7, dev)
        tape = fused.trace_fused(arrays, o, d, u, want_tape=True)[2]
        replay_times(res, f"cornell rec{rec}", arrays, d, u, tape)
        del tape

    mesh, cam = lit_mesh_scene(MESH_GRID, MESH_SUBDIV, 700, 10, dev)
    r = Renderer(mesh, device="cuda", seed=0, cameras=[cam])
    d, u, tape = traced_tape(r.arrays, r.camera,
                             cuda_select.closest_hit_fused, TRAIN_SEED)
    replay_times(res, "mesh-722", r.arrays, d, u, tape)
    ro, rd, ru = camera_rays_and_uniforms(r.arrays, cam, 700, 11, dev)
    sel = [graph_ms(lambda q=q: cuda_select.closest_hit_fused(r.arrays, *q),
                    20) for q in closest_hit_queries(r.arrays, ro, rd, ru)]
    res["select_mesh722"] = {"per_bounce": sel, "per_pass": sum(sel)}
    print(f"[times] select mesh-722 per pass {sum(sel)}", flush=True)
    del tape, r
    mesh, cam = lit_mesh_scene(MESH_GRID, MESH_SUBDIV, 700, 31, dev)
    r = Renderer(mesh, device="cuda", seed=0, cameras=[cam])
    d, u, tape = traced_tape(r.arrays, r.camera,
                             cuda_select.closest_hit_fused, TRAIN_SEED)
    replay_times(res, "mesh-722 rec31", r.arrays, d, u, tape)
    del tape, r

    big, cam = lit_mesh_scene(*BVH_TRAIN_MESH, BVH_SIZE, BVH_REC, dev)
    r = Renderer(big, device="cuda", seed=0, cameras=[cam])
    d, u, tape = traced_tape(r.arrays, r.camera, r.closest_fn, TRAIN_SEED)
    replay_times(res, "mesh-46k", r.arrays, d, u, tape)
    print(json.dumps(res))



TRACE_PASS_SEEDS = (0, 7, 2**33 + 5)
TRACE_PASS_FILM_PASSES = 8
# The functions whose SASS may differ from the parent's: the shading
# kernel's pass form and the camera kernel are new.
SASS_NEW = (r"shade_bounce_kernel<float, false, false, true>",
            r"pass_rays_kernel")


def pass_kernels_us(fn, n):
    """``{kernel name: device us per call}`` of every kernel ``n`` calls of
    ``fn()`` run, by torch.profiler (the name without its arguments)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            name = e.name.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / n
    return out


def sass_functions(cu: Path, tmp: Path, tag: str) -> dict:
    """``{demangled function name: SASS lines}`` of ``cu`` compiled alone
    to a cubin with the build's flags (``cuobjdump -sass``)."""
    from raytracercore_tpu_torch import kernels

    cubin = tmp / f"{tag}_{cu.stem}.cubin"
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([kernels._nvcc(), *flags, "-cubin", "-o", str(cubin),
                    str(cu)], check=True, capture_output=True, text=True)
    cuobjdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(line.strip())
    names = list(funcs)
    demangled = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    return {re.sub(r"\(.*", "", d): funcs[n]
            for n, d in zip(names, demangled)}


def sass_diff(parent: Path) -> dict:
    """Every function of the parent's ``csrc/*.cu`` against this tree's by
    SASS: ``{source: (identical, [differing or missing], [new])}``; the
    shading kernel's ``[7, R]`` forms (``shade_bounce_kernel<T, tape,
    records>``) are matched to this tree's ``<T, tape, records, false>``."""
    here = Path(__file__).resolve().parent
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for cu in sorted((parent / "raytracercore_tpu_torch" / "csrc")
                         .glob("*.cu")):
            mine = here / "raytracercore_tpu_torch" / "csrc" / cu.name
            old = sass_functions(cu, tmp, "parent")
            new = sass_functions(mine, tmp, "tree")
            renamed = {}
            for name, body in new.items():
                m = re.match(r"(.*shade_bounce_kernel<.*), false>$", name)
                renamed[m.group(1) + ">" if m else name] = body
            same = [n for n in old if renamed.get(n) == old[n]]
            differ = [n for n in old if renamed.get(n) != old[n]]
            fresh = [n for n in renamed if n not in old]
            out[cu.name] = (same, differ, fresh)
    return out


def trace_pass_main(card, parent):
    """``--trace-pass``: the bounce loop's pass without eager glue
    (``integrator.trace_pass``) against the chain (``render_pass_`` on
    ``preprocess_uniforms``) on mesh-722 700x700 rec10 (the dense route)
    and mesh-184k 512x512 rec4 (the BVH route).  Gates: films of
    ``TRACE_PASS_FILM_PASSES`` passes bit-equal on each of
    ``TRACE_PASS_SEEDS`` (widest gap 0); one camera launch a pass and one
    shading launch a bounce; with ``parent``, every parent function's SASS
    unchanged.  Prints the pass by CUDA-graph replay both ways (twice,
    interleaved), graphed ``Renderer`` passes both ways with their kernel
    nodes, each kernel's device us a pass, and the new kernels'
    registers, spills and occupancy; one JSON line last."""
    from raytracercore_tpu_torch import kernels
    from raytracercore_tpu_torch.render import integrator
    from raytracercore_tpu_torch.render import renderer as rmod
    from raytracercore_tpu_torch.render import shade_kernel as sk
    from raytracercore_tpu_torch.render.film import Film
    from raytracercore_tpu_torch.render.integrator import preprocess_uniforms

    dev = torch.device("cuda", 0)
    info = kernels.build()
    kernels.load()
    BUILD_REGS.update(ptxas_registers(info["log"]))
    res = {"card": card, "build_s": info["seconds"]}
    res["occupancy"] = {
        "shade pass form": occupancy_text("shade_bounce_kernelIfLb0ELb0ELb1E",
                                          SHADE_THREADS),
        "shade [7, R] float": occupancy_text(
            "shade_bounce_kernelIfLb0ELb0ELb0E", SHADE_THREADS),
        "pass_rays": occupancy_text("pass_rays_kernel", SHADE_THREADS)}
    print(f"[trace-pass] registers: {res['occupancy']} on {card}",
          flush=True)
    if parent:
        diff = sass_diff(Path(parent).resolve())
        res["sass"] = {k: {"identical": len(a), "differ": b, "new": c}
                       for k, (a, b, c) in diff.items()}
        for src, (same, differ, fresh) in diff.items():
            print(f"[trace-pass] SASS {src}: {len(same)} functions identical "
                  f"to the parent's, differ {differ}, new {fresh}")
            check(not differ, f"{src}: SASS of {differ} differs from the "
                  f"parent's")
            check(all(any(re.search(p, n) for p in SASS_NEW) for n in fresh),
                  f"{src}: unexpected new functions {fresh}")

    cases = (("mesh-722 700x700 rec10",
              lit_mesh_scene(MESH_GRID, MESH_SUBDIV, 700, 10, dev), "trace"),
             ("mesh-184k 512x512 rec4",
              lit_mesh_scene(*BVH_MESH, BVH_SIZE, BVH_REC, dev), "bvh"))
    for label, (scene, host_cam), route in cases:
        r = rmod.Renderer(scene, device=dev, seed=0, cameras=[host_cam],
                          graphs=False)
        check(r.route == route, f"{label}: route {r.route}, want {route}")
        arrays, cam, closest_fn = r.arrays, r.camera, r.closest_fn
        h, w = r.film.shape
        B = arrays.recursion + 1
        row = {}

        def draws(seed, k):
            return rmod.raw_draws(rmod.pass_generator(seed, k, dev), h * w,
                                  B)
        gaps = []
        for seed in TRACE_PASS_SEEDS:
            want = Film.create(h, w, device=dev)
            got = Film.create(h, w, device=dev)
            before = sk.pass_rays.launches, sk.shade_bounce.launches
            for k in range(TRACE_PASS_FILM_PASSES):
                jitter, raw = draws(seed, k)
                with torch.no_grad():
                    integrator.trace_pass(arrays, cam, got, jitter, raw,
                                          closest_fn)
            torch.cuda.synchronize()
            launched = (sk.pass_rays.launches - before[0],
                        sk.shade_bounce.launches - before[1])
            check(launched == (TRACE_PASS_FILM_PASSES,
                               TRACE_PASS_FILM_PASSES * B),
                  f"{label}: camera and shading launches {launched}")
            for k in range(TRACE_PASS_FILM_PASSES):
                jitter, raw = draws(seed, k)
                with torch.no_grad():
                    rmod.render_pass_(arrays, cam, want, jitter,
                                      preprocess_uniforms(raw),
                                      closest_fn=closest_fn)
            gap = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(got.tensors(), want.tensors()))
            gaps.append(gap)
            check(gap == 0.0, f"{label} seed {seed}: the glue-free pass's "
                  f"film differs from the chain's by {gap:.3e}")
        row["widest_gap"] = max(gaps)
        print(f"[trace-pass] {label}: films of {TRACE_PASS_FILM_PASSES} "
              f"passes bit-equal to the chain's on seeds "
              f"{TRACE_PASS_SEEDS} (widest gap {max(gaps)})", flush=True)

        jitter, raw = draws(1, 0)
        scratch = Film.create(h, w, device=dev)

        def chain():
            rmod.render_pass_(arrays, cam, scratch, jitter,
                              preprocess_uniforms(raw),
                              closest_fn=closest_fn)

        def glue_free():
            integrator.trace_pass(arrays, cam, scratch, jitter, raw,
                                  closest_fn)
        with torch.no_grad():
            times = {"chain": [], "trace_pass": []}
            for name in ("chain", "trace_pass", "trace_pass", "chain"):
                times[name].append(graph_ms(
                    chain if name == "chain" else glue_free, 20))
            row["graph_ms"] = times
            row["kernels_us"] = {
                "chain": pass_kernels_us(chain, 3),
                "trace_pass": pass_kernels_us(glue_free, 3)}
        for name, by in row["kernels_us"].items():
            ours = sum(v for k, v in by.items() if k.startswith("rtc::"))
            rest = sum(v for k, v in by.items()
                       if not k.startswith("rtc::"))
            print(f"[trace-pass] {label} {name}: {len(by)} kernels, the "
                  f"port's {ours:.1f} us a pass, torch's {rest:.1f} us; "
                  + "; ".join(f"{k} {v:.1f}" for k, v in sorted(
                      by.items(), key=lambda kv: -kv[1])[:12]), flush=True)
        print(f"[trace-pass] {label}: a pass by CUDA-graph replay, ms "
              f"(chain, glue-free, glue-free, chain order): {times} on "
              f"{card}", flush=True)

        # The Renderer's graphed pass with its draws (PassGraph): the
        # glue-free body against the chain's (the predicate turned off).
        graphed = {}
        real = rmod.pass_form
        with tempfile.TemporaryDirectory() as tmp:
            for name in ("chain", "trace_pass", "trace_pass", "chain"):
                rmod.pass_form = (real if name == "trace_pass"
                                  else (lambda *a: None))
                try:
                    pg = rmod.PassGraph(arrays, cam,
                                        Film.create(h, w, device=dev),
                                        closest_fn)
                finally:
                    rmod.pass_form = real
                pg.run(cam, pg.film, 3, 0, 2)
                nodes = sum(pg.captured.kernel_nodes(
                    str(Path(tmp) / "graph.dot")).values())
                ms = cuda_ms(pg.captured.replay, 20)
                graphed.setdefault(name, []).append(
                    {"ms": ms, "kernel_nodes": nodes,
                     "issue_ms": issue_ms(pg.captured)})
                del pg
                torch.cuda.empty_cache()
        row["graphed_pass"] = graphed
        print(f"[trace-pass] {label}: a graphed Renderer pass with its "
              f"draws (ms by CUDA events over 20 replays, kernel nodes, "
              f"host ms to issue a replay): {graphed} on {card}",
              flush=True)
        res[label] = row
        del r, arrays, scene
        torch.cuda.empty_cache()
    print(json.dumps(res))


def bvh_times_main(label, card):
    """``--bvh-times``: the BVH tier's set-up and walk on mesh-184k 512x512
    rec4 and mesh-1M 1024x1024 rec4, through the entry points every tree
    of the port has (``build_bvh``, ``CudaBVH``, ``CudaBVH.select``), for a
    comparison of trees in one call: the native build and the packing
    (``CudaBVH``: binary nodes, leaf records and, where the tree has them,
    wide nodes, uploaded) each timed twice on the host clock after a
    warm-up, then the walk of every bounce by CUDA-graph replay, with a
    checksum of its rows and t that must agree from tree to tree.  Prints
    one JSON line."""
    import raytracercore_tpu_torch as pkg
    from raytracercore_tpu_torch import kernels
    from raytracercore_tpu_torch.bvh.builder import build_bvh
    from raytracercore_tpu_torch.bvh.cuda_traverse import CudaBVH
    from raytracercore_tpu_torch.core import vecmath as vm
    from raytracercore_tpu_torch.intersect.dispatch import \
        make_bvh_closest_fn

    dev = torch.device("cuda", 0)
    info = kernels.build()
    kernels.load()
    regs = ptxas_registers(info["log"])
    res = {"label": label, "package": str(Path(pkg.__file__).parent),
           "card": card, "build_s": info["seconds"],
           "traverse": {k: v for k, v in regs.items()
                        if "traverse_kernel" in k}}
    print(f"[bvh-times] {label}: {res['package']} on {card}", flush=True)
    eps = (vm.near_enough(torch.float32), vm.POSITION_EPS_F32)
    small, _ = lit_mesh_scene(1, 1, 64, BVH_REC, dev)
    CudaBVH(build_bvh(small, backend="native"), small.triangles,
            small.materials, small.n_prims)   # the native builder's warm-up
    for name, mesh, size in (("mesh-184k", BVH_MESH, BVH_SIZE),
                             ("mesh-1M", BVH_BIG_MESH, BVH_BIG_SIZE)):
        scene, cam = lit_mesh_scene(*mesh, size, BVH_REC, dev)
        build_s, pack_s = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            bvh = build_bvh(scene, backend="native")
            t1 = time.perf_counter()
            sel = CudaBVH(bvh, scene.triangles, scene.materials,
                          scene.n_prims)
            torch.cuda.synchronize()
            build_s.append(t1 - t0)
            pack_s.append(time.perf_counter() - t1)
        rays = camera_rays_and_uniforms(scene, cam, size, 11, dev)
        queries = closest_hit_queries(
            scene, *rays, closest_fn=make_bvh_closest_fn(
                bvh, scene, traversal="kernel"))
        del rays
        ms, check_sum = [], []
        for query in queries:
            def call(query=query):
                return sel.select(*query, *eps, want_detail=True)
            row, _, t = call()[:3]
            check_sum.append([int(row.long().sum()),
                              float(t[torch.isfinite(t)].double().sum())])
            ms.append(graph_ms(call, 20))
        check(None not in ms, f"{label} {name}: device time measured")
        depth = sel.wide.depth if hasattr(sel, "wide") else None
        res[name] = {"nodes": int(bvh.n_nodes), "build_s": build_s,
                     "pack_s": pack_s, "ms": ms, "pass_ms": sum(ms),
                     "stack_depth": depth, "check_sum": check_sum}
        print(f"[bvh-times] {label} {name} {size}x{size}: {bvh.n_nodes} "
              f"nodes, build s {build_s}, pack s {pack_s}, stack depth "
              f"{depth}, device ms per bounce (CUDA graph) {ms} sum "
              f"{sum(ms):.4f} on {card}", flush=True)
        del queries, sel, bvh, scene
        torch.cuda.empty_cache()
    print(json.dumps(res))

# --- the surface phase: add_scatter, merge, dtype=, profile, trace_replay ----

SURF_SEED = 41
SURF_TILE = 32            # tile order of the add_scatter pass
SURF_REPEAT = 4           # samples a pixel in the repeated-index scatter
SURF_REPEAT_PIXELS = 256 * 256
SURF_F64_SIZE = 256
SURF_F64_PASSES = 4
SURF_PROFILE_PASSES = 4
SURF_SCOPE_PAIRS = 10000  # record_function pairs timed with no profiler
SCOPES = ("camera_rays", "trace_fused", "closest_hit", "film_accum",
          "trace_pass")
FILM_RTOL = 1e-6
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def tile_order(width, height, tile, dev):
    """``(px, py)`` [H*W] in square-tile order with the edge tiles cut to
    the image (``camera.pixel_grid_tiled``'s order where ``tile`` divides
    the size; 700 is not a multiple of 32)."""
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    tiles_x = -(-width // tile)
    key = (((ys // tile) * tiles_x + xs // tile) * tile * tile
           + (ys % tile) * tile + xs % tile)
    order = torch.argsort(key.reshape(-1))
    return xs.reshape(-1)[order], ys.reshape(-1)[order]


def traced(r, k, want_tape=True):
    """``(color, miss, tape)`` of pass ``k`` of Renderer ``r`` traced by
    its own route, the body of ``render_pass`` with the tape on."""
    from raytracercore_tpu_torch.render import camera as cam_mod
    from raytracercore_tpu_torch.render.integrator import trace
    from raytracercore_tpu_torch.render.renderer import pass_draws

    h, w = r.film.shape
    jitter, uniforms = pass_draws(r.seed, k, h * w,
                                  r.arrays.recursion + 1, r.device, r.dtype)
    px, py = cam_mod.pixel_grid(w, h, device=r.device)
    o, d = cam_mod.camera_rays(r.camera, px, py, jitter)
    o, d = o.contiguous(), d.contiguous()
    with torch.no_grad():
        if r.trace_fn is not None:
            return r.trace_fn(r.arrays, o, d, uniforms, want_tape=want_tape)
        return trace(r.arrays, o, d, None, closest_fn=r.closest_fn,
                     uniforms=uniforms, want_tape=want_tape)


def scope_split(path, n):
    """Read a ``Renderer.profile`` Chrome trace of ``n`` passes back:
    ``{scope: (host ms, device ms)}`` per pass, for each scope of
    :data:`SCOPES` found and for ``"outside"`` (host time of the traced
    span outside every scope, and the device time of kernels, copies and
    fills launched outside every scope).  A kernel belongs to the scope
    its launch (the runtime call with the same correlation id) lies in;
    the scopes are the trace's ``rtc.span`` events, on the profiler's
    clock to within half the anchors' width (``rtcSpanClock``)."""
    import bisect

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    scopes = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "rtc.span" and e["name"] in SCOPES)
    host = [e for e in events if e.get("cat") in
            ("cpu_op", "user_annotation", "rtc.span") + LAUNCH_CATS]
    span = (max(e["ts"] + e["dur"] for e in host)
            - min(e["ts"] for e in host))
    out = {}
    for t0, t1, name in scopes:
        h, dv = out.get(name, (0.0, 0.0))
        out[name] = (h + (t1 - t0), dv)
    out["outside"] = (span - sum(t1 - t0 for t0, t1, _ in scopes), 0.0)
    launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    starts = [s[0] for s in scopes]
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = launch_at.get(e.get("args", {}).get("correlation"))
        name = "outside"
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= scopes[i][1]:
                name = scopes[i][2]
        h, dv = out.get(name, (0.0, 0.0))
        out[name] = (h, dv + e["dur"])
    return {k: (h / n / 1e3, dv / n / 1e3) for k, (h, dv) in out.items()}


def scope_cost_us():
    """Host µs of one enter/exit pair, with no profiler recording, of
    ``torch.profiler.record_function`` and of the port's gated
    ``core.spans.span`` (what a pass pays)."""
    from raytracercore_tpu_torch.core.spans import span

    check(not torch.autograd._profiler_enabled(), "no profiler recording")
    res = []
    for make in (torch.profiler.record_function, span):
        t0 = time.perf_counter()
        for _ in range(SURF_SCOPE_PAIRS):
            with make("camera_rays"):
                pass
        res.append((time.perf_counter() - t0) / SURF_SCOPE_PAIRS * 1e6)
    return res


def film_close(a, b, what, corrected=False):
    """Counts exact, colour within ``FILM_RTOL``·(1 + |c|)."""
    for k in ("samples", "misses"):
        check(torch.equal(getattr(a, k), getattr(b, k)), f"{what}: {k} "
              "exact")
    ca = a.corrected_sum if corrected else a.color_sum
    cb = b.corrected_sum if corrected else b.color_sum
    err = float(((ca - cb).abs() / (1 + cb.abs())).max())
    check(err <= FILM_RTOL, f"{what}: colour within {FILM_RTOL}·(1+|c|) "
          f"({err:.3e})")
    return err


def surface_scatter_merge(card, dev, host):
    """``Film.add_scatter`` on one cornell 700² rec10 pass in 32×32 tile
    order, and ``Film.merge`` of passes 0-3 and 4-7 against ``step(8)``.
    Returns the launches of the driven passes."""
    from raytracercore_tpu_torch.render.film import Film
    from raytracercore_tpu_torch.render.renderer import (Renderer,
                                                         pass_draws,
                                                         trace_pixels)

    counts = {}
    r = Renderer(host, device=dev, seed=SURF_SEED, graphs=False)
    h, w = r.film.shape
    r.step(1)  # a film that already holds a pass
    px, py = tile_order(w, h, SURF_TILE, dev)
    jitter, uniforms = pass_draws(r.seed, 1, h * w, r.arrays.recursion + 1,
                                  dev)
    zero_counts()
    color, miss = trace_pixels(r.arrays, r.camera, px, py, jitter, uniforms,
                               r.closest_fn, r.trace_fn)
    pix = (py * w + px).contiguous()
    scattered = r.film.add_scatter(pix, color, miss)
    torch.cuda.synchronize()
    add_counts(counts, read_counts())
    row_c, row_m = torch.empty_like(color), torch.empty_like(miss)
    row_c[pix], row_m[pix] = color, miss   # the samples in pixel order
    framed = r.film.add_full_frame(row_c, row_m)
    check(films_equal(scattered, framed), "add_scatter at the tiled pixel "
          "indices bit-equal to add_full_frame in pixel order")
    scatter_ms = cuda_ms(lambda: r.film.add_scatter(pix, color, miss), 20)
    frame_ms = cuda_ms(lambda: r.film.add_full_frame(row_c, row_m), 20)

    # SURF_REPEAT samples onto each of SURF_REPEAT_PIXELS pixels.
    n = SURF_REPEAT * SURF_REPEAT_PIXELS
    side = int(SURF_REPEAT_PIXELS ** 0.5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SURF_SEED)
    idx = (torch.arange(n, device=dev) % SURF_REPEAT_PIXELS)[
        torch.randperm(n, generator=gen, device=dev)]
    small = Film.create(side, side, device=dev)
    rep = small.add_scatter(idx, color[:n], miss[:n])
    hit = ~miss[:n]

    def exact(src):
        return torch.zeros((SURF_REPEAT_PIXELS,) + src.shape[1:],
                           dtype=torch.float64, device=dev).index_add_(
            0, idx, src.double())
    for k, src in (("samples", hit), ("misses", miss[:n])):
        check(torch.equal(getattr(rep, k).reshape(-1).double(), exact(src)),
              f"repeated add_scatter: {k} exact")
    want = exact(torch.where(hit[:, None], color[:n], 0.0))
    got = rep.color_sum.reshape(-1, 3).double()
    rep_err = float(((got - want).abs() / want.abs().clamp(min=1e-30))
                    .max())
    check(bool(((got - want).abs() <= FILM_RTOL * want.abs()).all()),
          f"repeated add_scatter: colour within {FILM_RTOL} rel of the f64 "
          f"index_add_ ({rep_err:.3e})")
    print(f"[surface] add_scatter cornell {w}x{h} rec10, one pass in "
          f"{SURF_TILE}x{SURF_TILE} tile order: bit-equal to add_full_frame "
          f"in pixel order; {n} samples onto {SURF_REPEAT_PIXELS} pixels "
          f"({SURF_REPEAT} each): counts exact, colour max rel err "
          f"{rep_err:.3e} against the f64 index_add_; device ms "
          f"add_scatter={scatter_ms:.4f} add_full_frame={frame_ms:.4f} "
          f"(CUDA events, 20 calls) on {card}")

    # merge: passes 0-3 and 4-7 against step(8).
    errs = []
    for compensated in (False, True):
        def run(start, n_passes):
            x = Renderer(host, device=dev, seed=SURF_SEED,
                         compensated=compensated, graphs=False)
            x.pass_index = start
            zero_counts()
            x.step(n_passes)
            add_counts(counts, read_counts())
            return x.film
        merged = run(0, 4).merge(run(4, 4))
        check((merged.color_c is not None) == compensated,
              "merge keeps the compensation")
        errs.append(film_close(merged, run(0, 8),
                               f"merge (compensated={compensated})",
                               corrected=compensated))
    print(f"[surface] merge of passes 0-3 and 4-7 against step(8), cornell "
          f"{w}x{h} rec10: counts exact, colour max err/(1+|c|) "
          f"{errs[0]:.3e} plain, {errs[1]:.3e} compensated on {card}")
    return counts


def surface_float64(card, dev, host):
    """``Renderer(dtype=torch.float64)`` against the f32 Renderer on cornell
    256² rec10 (the megakernel on f32 copies) and mesh-722 256² rec10
    (``trace`` in f64 with the select kernel on f32 copies): the rays
    classified (samepick 0, close ≥ ``MIN_CLOSE_FRAC``), the f64 film,
    ``step(2); step(2)`` bit-equal to ``step(4)``.  Returns the launches
    of the f64 passes."""
    import copy

    from raytracercore_tpu_torch.render.fused import classify_mismatches
    from raytracercore_tpu_torch.render.renderer import Renderer

    counts = {}
    small = copy.deepcopy(host)
    small.width = small.height = SURF_F64_SIZE
    mesh, mesh_cam = lit_mesh_scene(MESH_GRID, MESH_SUBDIV, SURF_F64_SIZE,
                                    10, dev)
    for label, make in (
            ("cornell", lambda dt: Renderer(small, device=dev,
                                            seed=SURF_SEED, dtype=dt,
                                            graphs=False)),
            ("mesh-722", lambda dt: Renderer(mesh, device=dev,
                                             seed=SURF_SEED,
                                             cameras=[mesh_cam], dtype=dt,
                                             graphs=False))):
        r32, r64 = make(torch.float32), make(torch.float64)
        check(r64.route == r32.route, f"{label}: f64 takes the f32 route "
              f"({r64.route} vs {r32.route})")
        tally = {"flip": 0, "graze": 0, "samepick": 0}
        close, n_rays, miss_eq = 0, 0, 0
        for k in range(SURF_F64_PASSES):
            ref, got = traced(r32, k), traced(r64, k)
            check(got[0].dtype == torch.float64, f"{label}: f64 colour")
            cls = classify_mismatches(ref, got, CLOSE_ATOL, CLOSE_RTOL)
            for c in tally:
                tally[c] += int(cls[c].sum())
            close += int(cls["close"].sum())
            miss_eq += int(cls["miss_eq"].sum())
            n_rays += ref[0].shape[0]
        zero_counts()
        r64.step(2)
        r64.step(2)
        add_counts(counts, read_counts())
        whole = make(torch.float64)
        zero_counts()
        whole.step(4)
        add_counts(counts, read_counts())
        check(r64.film.color_sum.dtype == torch.float64, f"{label}: f64 film")
        check(films_equal(r64.film, whole.film), f"{label}: f64 step(2); "
              "step(2) bit-equal to step(4)")
        check(tally["samepick"] == 0, f"{label}: f64 vs f32 samepick 0")
        check(close >= MIN_CLOSE_FRAC * n_rays, f"{label}: f64 vs f32 close "
              f"{close / n_rays:.4f} >= {MIN_CLOSE_FRAC}")
        print(f"[surface] Renderer(dtype=float64) {label} "
              f"{SURF_F64_SIZE}x{SURF_F64_SIZE} rec10, route {r64.route}, "
              f"{SURF_F64_PASSES} passes ({n_rays} rays) against float32: "
              f"close={close / n_rays:.5f} miss_equal={miss_eq / n_rays:.5f} "
              f"flip={tally['flip']} graze={tally['graze']} "
              f"samepick={tally['samepick']}; film float64, step(2)+step(2) "
              f"bit-equal to step(4) on {card}")
    return counts


def surface_profile(card, dev, host):
    """``Renderer.profile`` on cornell 700² rec10 and mesh-184k 512² rec4:
    the per-scope host and device ms a pass from the trace, the profiled
    film against ``step(4)`` from the same start, and the host cost of the
    scopes.  Returns the launches of the profiled passes."""
    import tempfile

    from raytracercore_tpu_torch.render.renderer import Renderer, pass_draws

    counts = {}
    pair_us, gated_us = scope_cost_us()
    mesh, mesh_cam = lit_mesh_scene(*BVH_MESH, BVH_SIZE, BVH_REC, dev)
    cases = (
        ("cornell", lambda: Renderer(host, device=dev, seed=SURF_SEED,
                                     graphs=False)),
        ("mesh-184k", lambda: Renderer(mesh, device=dev, seed=SURF_SEED,
                                       cameras=[mesh_cam],
                                       accelerator="auto", graphs=False)))
    with tempfile.TemporaryDirectory() as tmp:
        for name, make in cases:
            r = make()
            label = (f"{name} {r.arrays.width}x{r.arrays.height} "
                     f"rec{r.arrays.recursion}")
            r.step(2)  # warm
            pass_ms = []
            for _ in range(8):
                t0 = time.perf_counter()
                r.step(1)
                pass_ms.append((time.perf_counter() - t0) * 1e3)
            h, w = r.film.shape
            t0 = time.perf_counter()
            for k in range(20):
                pass_draws(r.seed, k, h * w, r.arrays.recursion + 1, dev)
            torch.cuda.synchronize()
            draws_ms = (time.perf_counter() - t0) / 20 * 1e3
            film0, start = r.film, r.pass_index
            zero_counts()
            path = r.profile(tmp, SURF_PROFILE_PASSES)
            add_counts(counts, read_counts())
            profiled = r.film
            r.film, r.pass_index = film0, start
            r.step(SURF_PROFILE_PASSES)
            check(films_equal(profiled, r.film), f"{label}: profiled film "
                  f"bit-equal to step({SURF_PROFILE_PASSES})")
            split = scope_split(path, SURF_PROFILE_PASSES)
            # An eager float32 cornell pass is the megakernel's whole
            # pass, one span; the BVH route's is the camera kernel and a
            # closest hit a bounce (integrator.trace_pass).
            want = ({"trace_pass"} if r.route == "megakernel"
                    else {"camera_rays", "closest_hit"})
            check(want <= set(split), f"{label}: the trace holds the scopes "
                  f"{sorted(want)} ({sorted(split)})")
            median = float(np.median(pass_ms))
            n_scopes = (1 if r.route == "megakernel"
                        else 1 + r.arrays.recursion + 1)
            print(f"[surface] profile {label} (route {r.route}), "
                  f"{SURF_PROFILE_PASSES} passes under torch.profiler, "
                  f"per pass host ms / device ms: "
                  + "; ".join(f"{k} {hm:.4f} / {dm:.4f}"
                              for k, (hm, dm) in split.items())
                  + f"; unprofiled pass median ms={median:.3f} (8 passes, "
                  f"host clock), pass_draws host ms={draws_ms:.4f}; film "
                  f"bit-equal to step({SURF_PROFILE_PASSES}) on {card}")
            print(f"[surface] scopes of a {label} pass: {n_scopes} a pass; "
                  f"{SURF_SCOPE_PAIRS} record_function enter/exit pairs with "
                  f"no profiler took {pair_us * SURF_SCOPE_PAIRS / 1e3:.3f} "
                  f"ms, {pair_us:.3f} us a pair "
                  f"= {100 * n_scopes * pair_us / (median * 1e3):.3f} % of "
                  f"the pass if always entered; the gated span() "
                  f"{gated_us:.3f} us a pair = "
                  f"{100 * n_scopes * gated_us / (median * 1e3):.4f} % on "
                  f"{card}")
            del r, film0, profiled
            torch.cuda.empty_cache()
    return counts


def surface_replay(card, dev, host):
    """``trace_replay``'s options on cornell 700² rec10: the ``trace``
    recorder (``record_fused=False``) against ``trace`` with the select
    kernel and against the plain replay's autograd on its own tape; the
    megakernel recorder refused on mesh-722; the plain replay
    (``replay_kernel=False``) against the kernels on the same tape.
    Returns the launches of the driven ``trace_replay`` calls."""
    import dataclasses

    from raytracercore_tpu_torch.diff import (get_material_params,
                                              with_material_params)
    from raytracercore_tpu_torch.intersect.cuda_select import \
        closest_hit_fused
    from raytracercore_tpu_torch.render import camera as cam_mod
    from raytracercore_tpu_torch.render.integrator import trace
    from raytracercore_tpu_torch.render.renderer import Renderer
    from raytracercore_tpu_torch.render.replay import (record_tape, replay,
                                                       trace_replay)
    from raytracercore_tpu_torch.render.uniforms_kernel import \
        prepare_uniforms_kernel

    counts = {}
    r = Renderer(host, device=dev, seed=SURF_SEED, graphs=False)
    scene = r.arrays
    h, w = r.film.shape
    px, py = cam_mod.pixel_grid(w, h, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SURF_SEED)
    jitter = torch.rand((h * w, 4), generator=gen, device=dev)
    o, d = cam_mod.camera_rays(r.camera, px, py, jitter)
    o, d = o.contiguous(), d.contiguous()
    seed = SURF_SEED + 1
    u = prepare_uniforms_kernel(seed, h * w, scene.recursion + 1, dev)

    def grads(fn, *args, **kw):
        params = get_material_params(scene)
        color, miss = fn(with_material_params(scene, params), *args, **kw)
        loss = torch.mean(torch.where(miss[:, None], 0.0, color) ** 2)
        loss.backward()
        return color.detach(), miss, {k: p.grad for k, p in params.items()}

    def grad_err(got, want, what):
        worst = 0.0
        for k in want:
            err = float((got[k] - want[k]).abs().max())
            scale = float(want[k].abs().max())
            check(bool(torch.isfinite(got[k]).all()), f"{what}: {k} finite")
            check(err <= GRAD_TOL * scale, f"{what}: {k} grad {err:.3e} > "
                  f"{GRAD_TOL} * {scale:.3e}")
            worst = max(worst, err / scale if scale else 0.0)
        return worst

    zero_counts()
    c_u, m_u, g_u = grads(trace_replay, o, d, seed=seed, record_fused=False)
    torch.cuda.synchronize()
    add_counts(counts, read_counts())
    with torch.no_grad():
        c_t, m_t = trace(scene, o, d, None, closest_fn=closest_hit_fused,
                         uniforms=u)
    check(torch.equal(m_u, m_t), "record_fused=False: misses equal trace's")
    c_err = float((c_u - c_t).abs().max())
    check(bool(((c_u - c_t).abs() <= REPLAY_ATOL + REPLAY_RTOL * c_t.abs())
               .all()), f"record_fused=False: colour within {REPLAY_ATOL} + "
          f"{REPLAY_RTOL} rel of trace ({c_err:.3e})")
    tape = record_tape(scene, o, d, u, closest_fn=closest_hit_fused)
    _, _, g_plain = grads(replay, o, d, u, tape)
    e_unfused = grad_err(g_u, g_plain, "record_fused=False vs the plain "
                         "replay's autograd")

    mesh = lit_mesh_scene(MESH_GRID, MESH_SUBDIV, 64, 10, dev)[0]
    try:
        trace_replay(mesh, o[:4096], d[:4096], seed=seed, record_fused=True)
        raised = ""
    except ValueError as err:
        raised = str(err)
    check("fits" in raised, "record_fused=True raises on mesh-722, naming "
          "fits")

    zero_counts()
    c_k, m_k, g_k = grads(trace_replay, o, d, seed=seed)
    torch.cuda.synchronize()
    add_counts(counts, read_counts())
    air = scene.air_refractive_index.detach().clone().requires_grad_(True)
    amb = scene.ambient_rgb.detach().clone().requires_grad_(True)
    params = get_material_params(scene)
    s = dataclasses.replace(with_material_params(scene, params),
                            air_refractive_index=air, ambient_rgb=amb)
    zero_counts()
    c_p, m_p = trace_replay(s, o, d, seed=seed, replay_kernel=False)
    add_counts(counts, read_counts())
    torch.mean(torch.where(m_p[:, None], 0.0, c_p) ** 2).backward()
    g_p = {k: p.grad for k, p in params.items()}
    check(torch.equal(m_p, m_k), "replay_kernel=False: misses equal")
    e_plain = grad_err(g_p, g_k, "replay_kernel=False vs the kernels")
    check(bool(torch.isfinite(air.grad).all() and torch.isfinite(amb.grad)
               .all()), "replay_kernel=False: air IOR and ambient grads "
          "finite")
    print(f"[surface] trace_replay cornell {w}x{h} rec10: "
          f"record_fused=False colour max abs err {c_err:.3e} vs trace + "
          f"select kernel, misses equal, grads max err/max|g| "
          f"{e_unfused:.3e} vs the plain replay's autograd on its tape; "
          f"record_fused=True on mesh-722 raised ValueError; "
          f"replay_kernel=False grads max err/max|g| {e_plain:.3e} vs the "
          f"kernels on the same tape, air IOR grad "
          f"{float(air.grad):.6e}, ambient grad "
          f"{[round(float(x), 9) for x in amb.grad]} on {card}")
    return counts


def surface_phase(card, dev):
    """The rest of the JAX package's public surface at full width:
    ``Film.add_scatter`` and ``merge``, ``Renderer(dtype=float64)``,
    ``Renderer.profile`` with the phase scopes, ``trace_replay``'s
    ``record_fused=`` and ``replay_kernel=``.  Returns the main-path
    launches of the phase, by kernel."""
    from raytracercore_tpu_torch.scene import loader

    t_phase = time.perf_counter()
    host = loader.parse(cornell_scene())
    counts, times = {}, {}
    for name, part in (("scatter+merge", surface_scatter_merge),
                       ("float64", surface_float64),
                       ("profile", surface_profile),
                       ("trace_replay", surface_replay)):
        t0 = time.perf_counter()
        add_counts(counts, part(card, dev, host))
        times[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print(f"[surface] phase s={time.perf_counter() - t_phase:.1f} ("
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
          + f"); launches {counts}")
    for k in ("trace_fused", "prepare_uniforms_kernel", "replay_fwd",
              "replay_bwd", "closest_hit_fused", "traverse"):
        check(counts.get(k, 0) > 0, f"surface phase launched {k}")
    return counts


# --- the parallel and debug phase --------------------------------------------
# Ranks share the one card: two processes over gloo (NCCL refuses two ranks
# on one device), and the parent alone over NCCL at world size 1.  Their
# times measure correctness and collective cost, never scaling.
PAR_SEED = 31
PAR_PASSES = 4            # sharded cornell passes timed (after one warm)
PAR_SIZE, PAR_REC = 700, 10  # the main paths' widths (BVH: BVH_TRAIN_MESH)
HEATMAP_STRIDE = 49       # the CPU count takes every 49th pixel
PAR_REPS = 20             # all-reduces timed per bucket
PAR_JOIN_S = 600
SHARE_NOTE = "2 ranks share one card: not a scaling number"
HEATMAP_OFF_FRAC = 1e-3   # pixels whose node count may differ by one


def kernel_counters():
    """Every main-path kernel's wrapper (its ``launches`` counter), by
    name."""
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct
    from raytracercore_tpu_torch.intersect import cuda_select as cs
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render import replay_kernel as rk
    from raytracercore_tpu_torch.render import shade_kernel as sk
    from raytracercore_tpu_torch.render import uniforms_kernel as uk

    return {"trace_fused": fused.trace_fused,
            "trace_pass": fused.trace_pass, "pass_rays": sk.pass_rays,
            "prepare_uniforms_kernel": uk.prepare_uniforms_kernel,
            "replay_fwd": rk.replay_fwd, "replay_bwd": rk.replay_bwd,
            "closest_hit_fused": cs.closest_hit_fused,
            "traverse": ct.traverse,
            "traverse_record": ct.traverse_record, "sort_key": ct.sort_key,
            "shade_bounce": sk.shade_bounce}


def zero_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in kernel_counters().items()}


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def one_step(mesh, scene, camera, seed, dev, closest_fn=None, adam=False,
             overlapped=False):
    """One ``make_train_step`` step on ``mesh`` (None: one device), or one
    ``make_overlapped_train_step`` step, from the scene's materials with
    every diffuse halved, against a flat 0.2 target: ``(loss, {field:
    gradient}, {field: param after}, ms)``."""
    from raytracercore_tpu_torch.diff import get_material_params
    from raytracercore_tpu_torch.parallel import (make_overlapped_train_step,
                                                  make_train_step)

    params = get_material_params(scene)
    with torch.no_grad():
        params["diffuse"].mul_(0.5)
    opt = (torch.optim.Adam(params.values(), lr=TRAIN_LR) if adam
           else torch.optim.SGD(params.values(), lr=TRAIN_LR))
    kw = {} if closest_fn is None else {"closest_fn": closest_fn}
    step = (make_overlapped_train_step(mesh, opt) if overlapped
            else make_train_step(mesh, opt, graphs=False, **kw))
    target = torch.full((scene.height, scene.width, 3), 0.2, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step(params, scene, camera, target, seed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (loss, {k: v.grad.clone() for k, v in params.items()},
            {k: v.detach().clone() for k, v in params.items()}, ms)


def steps_close(label, got, want):
    """A sharded step against the single-device step: every field's
    gradient and param within ``GRAD_TOL`` of the field's largest
    gradient, the loss within 1e-5 relative.  Returns the worst gradient
    error over max|g|."""
    worst = 0.0
    for k, g in want[1].items():
        scale = float(g.abs().max())
        err_g = float((got[1][k] - g).abs().max())
        err_p = float((got[2][k] - want[2][k]).abs().max())
        check(err_g <= GRAD_TOL * scale + 1e-12
              and err_p <= GRAD_TOL * scale + 1e-12,
              f"{label}: {k} gradient {err_g:.3e} / param {err_p:.3e} > "
              f"{GRAD_TOL} * max|g| {scale:.3e}")
        worst = max(worst, err_g / scale if scale else 0.0)
    rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    check(rel <= 1e-5, f"{label}: loss rel diff {rel:.2e} > 1e-5")
    check(sum(int((g != 0).sum()) for g in want[1].values()) > 50,
          f"{label}: the gradient comparison is not vacuous")
    return worst


def bucket_ms(flat, group, n, events):
    """Median ms of ``n`` all-reduces of ``flat`` over ``group``: by CUDA
    events (NCCL, stream-ordered) or by the host clock around a
    synchronised call (gloo, which returns when it is done)."""
    import torch.distributed as dist

    times = []
    for _ in range(n):
        if events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist.all_reduce(flat, group=group)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(flat, group=group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def flat_grads(grads):
    return torch.cat([g.reshape(-1) for g in grads.values()])


def nccl_world_one(card, dev, tmp):
    """NCCL at world size 1, in this process: the cornell sharded pass
    bit-equal to ``render_passes``, a sharded Adam step bit-equal to the
    ``mesh=None`` step (the sum over one rank is the identity), and the
    material bucket's all-reduce timed.  Returns the main-path launches."""
    import torch.distributed as dist

    from raytracercore_tpu_torch.intersect.cuda_select import \
        closest_hit_fused
    from raytracercore_tpu_torch.parallel import (init_distributed,
                                                  make_mesh, worker)
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render.film import Film
    from raytracercore_tpu_torch.render.renderer import render_passes

    size = PAR_SIZE
    init_distributed(num_processes=1, process_id=0, backend="nccl",
                     init_method=(tmp / "nccl").as_uri())
    try:
        mesh = make_mesh()
        check(mesh.device == dev, f"make_mesh put rank 0 on {mesh.device}")
        arrays, camera = placed(mesh, "cornell", dev)
        zero_counts()
        film = worker.render_film(mesh, arrays, camera, 1, PAR_SEED)
        got = one_step(mesh, arrays, camera, PAR_SEED, dev, adam=True)
        got_ov = one_step(mesh, arrays, camera, PAR_SEED, dev, adam=True,
                          overlapped=True)
        torch.cuda.synchronize()
        counts = read_counts()
        want = render_passes(arrays, camera,
                             Film.create(size, size, device=dev), PAR_SEED, 0,
                             1, closest_fn=closest_hit_fused,
                             trace_fn=fused.trace_fused, graphs=False)
        same = {k: torch.equal(getattr(film, k), getattr(want, k))
                for k in ("color_sum", "samples", "misses")}
        ref = one_step(None, arrays, camera, PAR_SEED, dev, adam=True)
        step_same = all(torch.equal(g[0], ref[0]) and all(
            torch.equal(g[2][k], ref[2][k]) for k in ref[2])
            for g in (got, got_ov))
        flat = flat_grads(got[1])
        ms = bucket_ms(flat, mesh.rays_group, PAR_REPS, events=True)
    finally:
        dist.destroy_process_group()
    print(f"[parallel] nccl world size 1: cornell {size}x{size} "
          f"rec{PAR_REC} sharded "
          f"pass bit-equal to render_passes: {same}; sharded and "
          f"overlapped Adam steps' loss and params bit-equal to the "
          f"mesh=None step: {step_same} "
          f"(loss {float(got[0]):.8f}); launches {counts}")
    print(f"[parallel] nccl all_reduce of the material bucket "
          f"({flat.numel()} f32, world size 1): median ms of {PAR_REPS} "
          f"(CUDA events)={ms:.4f} on {card}")
    check(all(same.values()), "NCCL world 1: sharded pass bit-equal")
    check(step_same, "NCCL world 1: sharded step bit-equal")
    check(counts["trace_fused"] == 3 and counts["replay_bwd"] == 2
          and counts["prepare_uniforms_kernel"] == 2,
          f"NCCL world 1: the pass and the step ran the kernels ({counts})")
    return counts


def placed(mesh, name, dev):
    """A named scene of the worker placed on ``mesh``, and its camera."""
    from raytracercore_tpu_torch.parallel import place_scene, worker
    from raytracercore_tpu_torch.scene.types import init_camera

    arrays, host_cam = worker.load_scene(name, PAR_SIZE, PAR_REC, dev)
    return (place_scene(mesh, arrays),
            init_camera(host_cam, PAR_SIZE, PAR_SIZE, device=dev))


def rank_main(rank, world, tmp):
    """One of two ranks on ``cuda:0`` over gloo: the sharded paths, its
    launches and times written to ``rank<r>.json``;
    rank 0 then holds each path against the single-device path on the
    same card."""
    import torch.distributed as dist

    from raytracercore_tpu_torch import kernels
    from raytracercore_tpu_torch.parallel import (gather_film,
                                                  init_distributed,
                                                  make_mesh, place_scene,
                                                  worker)
    from raytracercore_tpu_torch.scene.types import init_camera

    tmp = Path(tmp)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    init_distributed(num_processes=world, process_id=rank, backend="gloo",
                     init_method=(tmp / "gloo").as_uri())
    out = {"rank": rank}
    try:
        rays = make_mesh(device=dev)                      # (2 rays, 1)
        prims = make_mesh(n_rays=1, n_prims=2, device=dev)  # (1, 2 prims)
        cornell, cam = placed(rays, "cornell", dev)
        mesh722, cam722 = placed(prims, "mesh-722", dev)
        mesh46, host46 = lit_mesh_scene(*BVH_TRAIN_MESH, BVH_SIZE, BVH_REC,
                                        dev)
        mesh46 = place_scene(rays, mesh46)
        cam46 = init_camera(host46, BVH_SIZE, BVH_SIZE, device=dev)
        bvh46, _ = bvh_closest(mesh46)
        worker.render_film(rays, cornell, cam, 1, PAR_SEED)      # warm
        torch.cuda.synchronize()

        zero_counts()
        t0 = time.perf_counter()
        film = worker.render_film(rays, cornell, cam, PAR_PASSES, PAR_SEED)
        torch.cuda.synchronize()
        out["pass_ms"] = (time.perf_counter() - t0) * 1e3 / PAR_PASSES
        t0 = time.perf_counter()
        whole = gather_film(film, rays)
        out["gather_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        film722 = gather_film(worker.render_film(prims, mesh722, cam722, 1,
                                                 PAR_SEED), prims)
        out["prims_pass_ms"] = (time.perf_counter() - t0) * 1e3
        steps = {}
        for name, scene, camera, closest in (
                ("cornell", cornell, cam, None),
                ("mesh-722", mesh722, cam722, None),
                ("mesh-46k", mesh46, cam46, bvh46),
                ("cornell-overlapped", cornell, cam, None)):
            steps[name] = one_step(rays, scene, camera, PAR_SEED + 1, dev,
                                   closest_fn=closest,
                                   overlapped=name.endswith("overlapped"))
            out[f"step_ms {name}"] = steps[name][3]
        out["counts"] = read_counts()
        for name in ("cornell", "mesh-46k"):
            flat = flat_grads(steps[name][1])
            out[f"gloo_bucket_ms {name}"] = bucket_ms(
                flat, rays.rays_group, PAR_REPS, events=False)
            out[f"bucket_size {name}"] = flat.numel()
        if rank == 0:
            out.update(rank0_checks(rays, cornell, cam, whole, mesh722,
                                    cam722, film722, steps, mesh46, cam46,
                                    bvh46, dev))
        (tmp / f"rank{rank}.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def rank0_checks(rays, cornell, cam, whole, mesh722, cam722, film722, steps,
                 mesh46, cam46, bvh46, dev):
    """Rank 0 after the sharded paths: each against the single-device path
    on the same card and the same numbers."""
    from raytracercore_tpu_torch.intersect.cuda_select import \
        closest_hit_fused
    from raytracercore_tpu_torch.parallel import ray_slice
    from raytracercore_tpu_torch.render import camera as cam_mod
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render.film import Film
    from raytracercore_tpu_torch.render.renderer import (pass_draws,
                                                         render_passes)

    size, n_bounces = PAR_SIZE, PAR_REC + 1
    res = {}
    want = render_passes(cornell, cam, Film.create(size, size, device=dev),
                         PAR_SEED, 0, PAR_PASSES,
                         closest_fn=closest_hit_fused,
                         trace_fn=fused.trace_fused, graphs=False)
    same = {k: np.array_equal(getattr(whole, k),
                              getattr(want, k).cpu().numpy())
            for k in ("color_sum", "samples", "misses")}
    # Per ray, pass 0: this rank's rows traced alone against the same rows
    # of the whole frame, sorted by fused.classify_mismatches.
    jitter, uniforms = pass_draws(PAR_SEED, 0, size * size, n_bounces, dev)
    px, py = cam_mod.pixel_grid(size, size, device=dev)
    o, d = cam_mod.camera_rays(cam, px, py, jitter)
    full = fused.trace_fused(cornell, o.contiguous(), d.contiguous(),
                             uniforms, want_tape=True)
    rows = ray_slice(rays, size)
    pix = slice(rows.start * size, rows.stop * size)
    part = fused.trace_fused(cornell, o[pix].contiguous(),
                             d[pix].contiguous(),
                             uniforms[:, :, pix].contiguous(), want_tape=True)
    tape = type(full[2])(*(getattr(full[2], k)[:, pix] for k in
                           ("prim", "flags", "nx", "ny", "nz")))
    cls = fused.classify_mismatches((full[0][pix], full[1][pix], tape), part,
                                    CLOSE_ATOL, CLOSE_RTOL)
    res["cornell"] = {"bit_equal": same,
                      **{k: int(cls[k].sum())
                         for k in ("flip", "graze", "samepick")},
                      "miss_diff": int((~cls["miss_eq"]).sum())}
    check(all(same.values()) and res["cornell"]["samepick"] == 0
          and res["cornell"]["miss_diff"] == 0,
          f"2 ranks: cornell sharded film equals the single-device film "
          f"({res['cornell']})")

    want722 = render_passes(mesh722, cam722,
                            Film.create(size, size, device=dev), PAR_SEED,
                            0, 1, closest_fn=closest_hit_fused,
                            graphs=False)
    err = float(np.abs(film722.color_sum
                       - want722.color_sum.cpu().numpy()).max())
    miss_eq = np.array_equal(film722.misses, want722.misses.cpu().numpy())
    samples_eq = np.array_equal(film722.samples,
                                want722.samples.cpu().numpy())
    res["mesh-722 prims"] = {"max_abs_err": err, "misses_equal": miss_eq,
                             "samples_equal": samples_eq}
    check(miss_eq and samples_eq and err <= 1e-5,
          f"2 prims ranks: mesh-722 film within 1e-5 of trace + select "
          f"({res['mesh-722 prims']})")

    for name, scene, camera, closest in (
            ("cornell", cornell, cam, None),
            ("mesh-722", mesh722, cam722, None),
            ("mesh-46k", mesh46, cam46, bvh46),
            ("cornell-overlapped", cornell, cam, None)):
        ref = one_step(None, scene, camera, PAR_SEED + 1, dev,
                       closest_fn=closest)
        res[f"step {name} worst grad err / max|g|"] = steps_close(
            f"2 ranks: {name} sharded step", steps[name], ref)
        res[f"step {name} loss"] = [float(steps[name][0]), float(ref[0])]
    return res


def parallel_phase(card, dev):
    """The sharded paths and the debug views at full width (700x700 rec10;
    the BVH step at 512x512 rec4): NCCL at world size 1 in this process,
    then two ranks on the card over gloo, then the debug views.  Returns
    the main-path launches of the phase, by kernel."""
    import multiprocessing
    import tempfile

    from raytracercore_tpu_torch import kernels

    kernels.build()  # the ranks load the library this process built
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        counts = nccl_world_one(card, dev, tmp)
        nccl_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=rank_main,
                             args=(r, 2, str(tmp)))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=PAR_JOIN_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks_s = time.perf_counter() - t0
        check([p.exitcode for p in procs] == [0, 0],
              f"2 ranks on the card: exit codes "
              f"{[p.exitcode for p in procs]}")
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(2)]
    for r in res:
        add_counts(counts, r["counts"])
        # trace's bounce loop on each rank: the prims-sharded mesh-722 pass
        # and the recorders of the mesh-722 and mesh-46k steps.
        want = 2 * (PAR_REC + 1) + BVH_REC + 1
        check(r["counts"]["shade_bounce"] == want, f"rank {r['rank']}: the "
              f"sharded pass and steps launched the shading kernel once a "
              f"bounce ({r['counts']['shade_bounce']} != {want})")
        print(f"[parallel] gloo rank {r['rank']} of 2 on cuda:0 ({SHARE_NOTE}"
              f"): cornell {PAR_SIZE}² rec{PAR_REC} ms/pass="
              f"{r['pass_ms']:.3f} (mean of {PAR_PASSES}, the megakernel on "
              f"half the paths) gather_film ms={r['gather_ms']:.3f}; "
              f"mesh-722 {PAR_SIZE}² "
              f"prims-sharded pass + gather ms={r['prims_pass_ms']:.3f} "
              f"(first pass, {PAR_REC + 1} all_gathers); ms of one "
              f"step (the first in the process) "
              + " ".join(f"{k.split()[1]}={r[k]:.3f}" for k in r
                         if k.startswith("step_ms"))
              + f"; gloo all_reduce median ms of {PAR_REPS}: "
              + " ".join(f"{k.split()[1]} ({r['bucket_size ' + k.split()[1]]}"
                         f" f32)={r[k]:.3f}" for k in r
                         if k.startswith("gloo_bucket_ms"))
              + f"; launches {r['counts']} on {card}")
    r0 = res[0]
    print(f"[parallel] 2 ranks vs one device: cornell film {r0['cornell']}; "
          f"mesh-722 prims film {r0['mesh-722 prims']}; steps "
          + "; ".join(f"{k}={r0[k]}" for k in r0 if k.startswith("step ")))
    t0 = time.perf_counter()
    add_counts(counts, debug_views(card, dev))
    debug_s = time.perf_counter() - t0
    print(f"[parallel] phase s={time.perf_counter() - t_phase:.1f} (NCCL "
          f"world 1 {nccl_s:.1f}, 2 ranks incl. start-up {ranks_s:.1f}, "
          f"debug views {debug_s:.1f}); launches {counts}")
    for k in ("trace_fused", "prepare_uniforms_kernel", "replay_fwd",
              "replay_bwd", "closest_hit_fused", "traverse", "shade_bounce"):
        check(counts.get(k, 0) > 0, f"parallel phase launched {k}")
    return counts


def debug_views(card, dev):
    """The debug views on the card at 700x700: primitive ids (cornell:
    against the megakernel tape's first-bounce prim on the same centre
    rays; mesh-722: against the select kernel's plain version), the BVH
    node counts of mesh-722 against the same count on CPU tensors, one
    bounce listing, and a selection overlay of one prim and one node.
    Returns the views' launches."""
    from raytracercore_tpu_torch.bvh.builder import build_bvh
    from raytracercore_tpu_torch.intersect.cuda_select import \
        closest_hit_fused_reference
    from raytracercore_tpu_torch.parallel import worker
    from raytracercore_tpu_torch.render import camera as cam_mod
    from raytracercore_tpu_torch.render import fused
    from raytracercore_tpu_torch.render.renderer import pass_draws
    from raytracercore_tpu_torch.scene import loader
    from raytracercore_tpu_torch.scene.types import (freeze_scene,
                                                     init_camera)
    from raytracercore_tpu_torch.tools import debug

    size = PAR_SIZE
    host = loader.parse(worker.CORNELL_SCENE)
    host.width = host.height = size
    host.recursion = PAR_REC
    mesh, mesh_cam = worker.load_scene("mesh-722", size, PAR_REC, dev)
    bvh = build_bvh(mesh, backend="native")
    ms = {}
    zero_counts()

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    ids = timed("primitive_ids cornell",
                lambda: debug.primitive_ids(host, device=dev))
    img = timed("primitive_id_map cornell",
                lambda: debug.primitive_id_map(host, device=dev))
    ids722 = timed("primitive_ids mesh-722", lambda: debug.primitive_ids(
        mesh, device=dev, cameras=[mesh_cam]))
    counts722 = timed("bvh_hit_counts mesh-722", lambda: debug.bvh_hit_counts(
        mesh, bvh=bvh, device=dev, cameras=[mesh_cam]))
    heat = timed("bvh_heatmap mesh-722", lambda: debug.bvh_heatmap(
        mesh, bvh=bvh, device=dev, cameras=[mesh_cam]))
    listing = timed("trace_pixel cornell", lambda: debug.trace_pixel(
        host, size // 2, size * 3 // 5, n_traces=2, seed=PAR_SEED,
        device=dev))
    sel = int(np.bincount(ids722[ids722 >= 0]).argmax())
    overlay = timed(f"selection_map mesh-722 prim:{sel}",
                    lambda: debug.selection_map(mesh, f"prim:{sel}",
                                                device=dev,
                                                cameras=[mesh_cam]))
    node = timed("selection_map mesh-722 node:1", lambda: debug.selection_map(
        mesh, "node:1", bvh=bvh, device=dev, cameras=[mesh_cam]))
    counts = read_counts()

    # The references (not counted).
    arrays = freeze_scene(host, device=dev)
    camera = init_camera(host.cameras[0], size, size, device=dev)
    px, py = cam_mod.pixel_grid(size, size, device=dev)
    o, d = cam_mod.center_rays(camera, px, py)
    _, uniforms = pass_draws(PAR_SEED, 0, size * size, PAR_REC + 1, dev)
    tape = fused.trace_fused(arrays, o.contiguous(), d.contiguous(),
                             uniforms, want_tape=True)[2]
    first = tape.prim[0].cpu().numpy().reshape(size, size)
    cam722 = init_camera(mesh_cam, size, size, device=dev)
    o, d = cam_mod.center_rays(cam722, px, py)
    plain722 = closest_hit_fused_reference(
        mesh, o.contiguous(), d.contiguous(), None).prim.cpu().numpy()
    # The plain count on CPU tensors (a dense [rays x nodes] slab test,
    # minutes at 490,000 rays on a host's cores): every 49th pixel.
    sample = torch.arange(0, size * size, HEATMAP_STRIDE)
    counts_cpu = debug.node_hit_counts(bvh, o.cpu()[sample],
                                       d.cpu()[sample]).numpy()
    diff = np.abs(counts722.reshape(-1)[sample.numpy()].astype(np.int64)
                  - counts_cpu)
    vis = ids722 == sel
    res = {"cornell ids != megakernel first prim": int((ids != first).sum()),
           "mesh-722 ids != plain select": int(
               (ids722.reshape(-1) != plain722).sum()),
           "heatmap pixels off by one": int((diff == 1).sum()),
           "heatmap pixels off by more": int((diff > 1).sum()),
           "heatmap max count": int(counts722.max()),
           "heatmap mean count": float(counts722.mean()),
           "heatmap image mean": float(heat.mean()),
           f"prim:{sel} overlay pixels": int((overlay[..., 3] == 255).sum()),
           f"prim:{sel} visible pixels": int(vis.sum()),
           "node:1 overlay pixels": int((node[..., 3] == 255).sum())}
    print(f"[debug] views at {size}x{size} on {dev}: {res} (heat-map "
          f"counts against the CPU on {sample.numel()} pixels); "
          f"wall ms {{{', '.join(f'{k}: {v:.1f}' for k, v in ms.items())}}}"
          f"; launches {counts} on {card}")
    print(f"[debug] trace_pixel cornell ({size // 2}, {size * 3 // 5}), "
          "2 traces:")
    for t_i, lines in enumerate(listing):
        print(f"[debug]   trace {t_i}: " + " | ".join(lines))
    check(img.shape == (size, size, 3) and len(np.unique(
        img.reshape(-1, 3), axis=0)) > 3, "primitive_id_map has its colours")
    check(res["cornell ids != megakernel first prim"] == 0,
          "primitive ids equal the megakernel's first-bounce prims")
    check(res["mesh-722 ids != plain select"] == 0,
          "mesh-722 primitive ids equal the plain select version's")
    check(res["heatmap pixels off by more"] == 0
          and res["heatmap pixels off by one"]
          <= HEATMAP_OFF_FRAC * sample.numel(),
          "BVH node counts equal the counts on CPU tensors (to one count "
          f"on at most {HEATMAP_OFF_FRAC} of the sampled pixels)")
    check(all(lines[-1].startswith("color=") and len(lines) > 1
              for lines in listing), "trace_pixel lists bounces")
    check(counts["shade_bounce"] == PAR_REC + 1, "trace_pixel's "
          "trace(record=True) launched the shading kernel once a bounce "
          f"({counts['shade_bounce']} != {PAR_REC + 1})")
    check(bool((overlay[..., 3] == 255)[vis].all()) and vis.any(),
          "the prim overlay covers every pixel where the prim is visible")
    check(res["node:1 overlay pixels"] > 0, "the node overlay is not empty")
    return counts


# --- the graph phase: passes and steps captured as CUDA graphs -------------

GRAPH_SEED = 57
GRAPH_PASSES = 16         # passes timed each way, eager and graphed in turn
GRAPH_STEPS = 5           # steps compared, each from one saved state
GRAPH_TIMED_STEPS = 6     # steps timed each way, in turn
GRAPH_BUSY = 3            # calls under the profiler for a busy share
GRAPH_ISSUE = 8           # replays whose host issue time is taken
GRAPH_TARGET = 0.2        # the steps' target colour (gradients need none)
# The kernel nodes of a captured graph that each wrapper's launch becomes,
# by a pattern of the kernel's (mangled) name: the select wrapper's list
# and finish kernels are not counted, as its count does not count them.
NODE_NAMES = {
    # The megakernel's last template flag is its whole-pass form.
    "trace_fused": r"(?<![A-Za-z_])trace_fused_kernelI(Lb[01]E){4}Lb0E",
    "trace_pass": r"(?<![A-Za-z_])trace_fused_kernelI(Lb[01]E){4}Lb1E",
    "prepare_uniforms_kernel": r"(?<![A-Za-z_])uniforms_kernel",
    "replay_fwd": r"(?<![A-Za-z_])replay_fwd_kernel",
    "replay_bwd": r"(?<![A-Za-z_])replay_bwd(_regen)?_kernel",
    "closest_hit_fused": r"(?<![A-Za-z_])select_kernel",
    "traverse": r"(?<![A-Za-z_])traverse_kernel",
    # The record epilogue: the third template argument (MODE) not 0.
    "traverse_record": r"(?<![A-Za-z_])traverse_kernelILi\d+ELb[01]ELi[1-9]",
    "sort_key": r"(?<![A-Za-z_])sort_key_kernel",
    "shade_bounce": r"(?<![A-Za-z_])shade_bounce_kernel",
    "pass_rays": r"(?<![A-Za-z_])pass_rays_kernel",
}


def graph_kernels(label, captured, want, tmp):
    """Gate: the kernels one replay of ``captured`` runs — the graph's
    kernel nodes (its DOT dump) and the launches recorded while it was
    captured, by wrapper (the counts of a kernel's forms, each launch
    also in its wrapper's count, aside) — are ``want`` ``{wrapper: n}``,
    the route's.  Returns the text printed beside the route (kernel nodes
    in all, ours per replay)."""
    from raytracercore_tpu_torch.kernels import LaunchCount

    nodes = captured.kernel_nodes(str(Path(tmp) / "graph.dot"))
    ours = {name: sum(n for k, n in nodes.items() if re.search(pat, k))
            for name, pat in NODE_NAMES.items()}
    ours = {k: v for k, v in ours.items() if v}
    tally = {w.__name__: n for w, n in captured.launches.items()
             if not isinstance(w, LaunchCount)}
    check(ours == want and tally == want,
          f"{label}: kernels a replay runs: the graph's kernel nodes {ours}, "
          f"the launches recorded at the capture {tally}, the route's "
          f"{want}")
    return (f"{sum(nodes.values())} kernel nodes a replay, ours {ours}; "
            f"capture ms={captured.capture_ms:.1f} graph pool MB="
            f"{captured.pool_bytes / 2 ** 20:.1f}")


def interleaved(fns, n):
    """``n`` turns of each ``fns[k]()`` in turn, each timed on the host
    clock to a synchronize: a list of ms lists."""
    out = [[] for _ in fns]
    for _ in range(n):
        for ms, fn in zip(out, fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return out


def issue_ms(captured):
    """Host ms to issue one replay (``GRAPH_ISSUE`` replays, each waited
    for before the next): the quartiles."""
    ms = []
    for _ in range(GRAPH_ISSUE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        captured.replay()
        ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return quartiles(ms)


def graph_pass_route(card, label, make, want, tmp, states=False):
    """One route's pass: a graphed ``Renderer`` (``make(None)``, the
    default) against an eager one (``make(False)``) on the same seed.
    Gates: the films of the first pass and of ``GRAPH_PASSES`` more,
    timed in turn, bit-equal; one graphed ``step(1)`` without a host
    sync; the kernels a replay runs (:func:`graph_kernels`).  With
    ``states``: the films again after ``next_camera``,
    ``load_checkpoint`` and ``reset``, and the module-level
    ``render_passes`` graphed against eager.  Prints the quartiles, the
    busy shares, capture ms, pool MB, kernel nodes and the host ms to
    issue a replay."""
    from raytracercore_tpu_torch.render.film import Film
    from raytracercore_tpu_torch.render.renderer import (PASS_GRAPHS,
                                                         pass_draws,
                                                         render_pass,
                                                         render_passes)

    t_route = time.perf_counter()
    g, e = make(None), make(False)
    want = want(g)
    check(g.graphs and not e.graphs and g.route == e.route,
          f"{label}: graphs on by default on the card, off when asked "
          f"(graphed {g.graphs}, eager {e.graphs}; routes {g.route} / "
          f"{e.route})")
    t0 = time.perf_counter()
    g.step(1)
    first_ms = (time.perf_counter() - t0) * 1e3
    e.step(1)
    pg = next(iter(g.pass_graphs.entries.values()))
    kern = graph_kernels(f"{label} pass", pg.captured, want, tmp)
    ms_e, ms_g = interleaved((lambda: e.step(1), lambda: g.step(1)),
                             GRAPH_PASSES)

    def same(what):
        diff = [f for f in ("color_sum", "samples", "misses")
                if not torch.equal(getattr(g.film, f), getattr(e.film, f))]
        check(not diff and g.pass_index == e.pass_index,
              f"{label}: graphed film bit-equal to the eager film {what} "
              f"(differing planes {diff}; pass {g.pass_index} / "
              f"{e.pass_index})")
    same(f"after {1 + GRAPH_PASSES} passes")
    plain_note = ""
    if g.route == "megakernel":
        # The whole pass against its plain version, the chain of camera
        # rays, uniform channels, megakernel and film add on the same draws.
        chain = Film.create(*g.film.shape, device=g.device)
        for k in range(g.pass_index):
            jitter, uniforms = pass_draws(
                GRAPH_SEED, k, chain.samples.numel(), g.arrays.recursion + 1,
                g.device)
            chain = render_pass(g.arrays, g.camera, chain, jitter, uniforms,
                                trace_fn=g.trace_fn)
        check(films_equal(chain, g.film), f"{label}: graphed film of "
              f"{g.pass_index} whole passes bit-equal to the chain's")
        plain_note = " and to the chain's (camera rays, channels, film add)"
    else:
        # The bounce loop's route against the same passes with the plain
        # bounce body: the Renderer's graphed film, then the module-level
        # render_passes graphed.
        plain_fn = plain_shading_trace_fn(g.closest_fn)
        size = g.film.shape
        plain = render_passes(g.arrays, g.camera, Film.create(
            *size, device=g.device), GRAPH_SEED, 0, g.pass_index,
            trace_fn=plain_fn, graphs=False)
        check(films_equal(plain, g.film), f"{label}: graphed film of "
              f"{g.pass_index} passes bit-equal to the passes with the plain "
              f"bounce body")
        got_f = render_passes(g.arrays, g.camera, Film.create(
            *size, device=g.device), GRAPH_SEED, 3, 2,
            closest_fn=g.closest_fn)
        want_f = render_passes(g.arrays, g.camera, Film.create(
            *size, device=g.device), GRAPH_SEED, 3, 2, trace_fn=plain_fn,
            graphs=False)
        check(films_equal(got_f, want_f), f"{label}: module-level "
              f"render_passes graphed bit-equal to the plain bounce body's")
        PASS_GRAPHS.clear()
        plain_note = (" and to the plain bounce body's (the Renderer's and "
                      "render_passes')")
    check_no_sync(f"{label} graphed pass", lambda: g.step(1))
    e.step(1)
    same("after the pass under the sync check")
    notes = []
    if states:
        with tempfile.TemporaryDirectory() as ckpt_dir:
            ckpt = str(Path(ckpt_dir) / "state.npz")
            e.save_checkpoint(ckpt)
            for r in (g, e):
                r.step(2)
            for what, act in (
                    ("next_camera", lambda r: r.next_camera()),
                    ("load_checkpoint", lambda r: r.load_checkpoint(ckpt)),
                    ("reset", lambda r: r.reset())):
                for r in (g, e):
                    act(r)
                    r.step(2)
                same(f"after {what} and 2 passes")
                notes.append(what)
        size = g.film.shape
        kw = {"closest_fn": g.closest_fn, "trace_fn": g.trace_fn}
        for start in (0, 3):
            want_f = render_passes(g.arrays, g.camera, Film.create(
                *size, device=g.device), GRAPH_SEED, start, 2, graphs=False,
                **kw)
            got_f = render_passes(g.arrays, g.camera, Film.create(
                *size, device=g.device), GRAPH_SEED, start, 2, **kw)
            check(films_equal(got_f, want_f), f"{label}: module-level "
                  f"render_passes graphed bit-equal to eager, passes "
                  f"{start}-{start + 1}")
        check(PASS_GRAPHS.captures >= 1 and len(PASS_GRAPHS.entries) == 1,
              f"{label}: render_passes captured once and replayed "
              f"({PASS_GRAPHS.captures} captures)")
        PASS_GRAPHS.clear()
        notes.append("render_passes")
    busy_e, _ = device_busy(lambda i: e.step(1), GRAPH_BUSY)
    busy_g, top_g = device_busy(lambda i: g.step(1), GRAPH_BUSY)
    issue = issue_ms(pg.captured)
    print(f"[graph] {label} pass (route {g.route}): films bit-equal to the "
          f"eager passes{plain_note}"
          + (f", again after {', '.join(notes)}" if notes else "")
          + f"; first call ms={first_ms:.1f} (warm-up, capture, replay); "
          f"{kern}; {GRAPH_PASSES} passes each in turn, ms min/p25/median/"
          f"p75/max eager={quartiles(ms_e)} graphed={quartiles(ms_g)}; "
          f"device busy eager {busy_e:.1f} % graphed {busy_g:.1f} %; host "
          f"ms to issue a replay min/p25/median/p75/max={issue}; route s="
          f"{time.perf_counter() - t_route:.1f} on {card}")
    print(f"[graph] {label} graphed passes, device us per pass: {top_g}")


def graph_step_route(card, label, scene, camera, closest_fn, want, tmp,
                     use_replay=True, timed=True):
    """One route's train step: ``make_train_step(None, Adam)`` graphed (the
    default) against the eager step (``graphs=False``), on the scene's own
    materials against a flat target.  Gates, for ``GRAPH_STEPS`` steps
    each from one saved state (params and Adam state): losses bit-equal,
    gradients within ``GRAD_TOL``·max|g|, and the params after the graphed
    step bit-equal to a fresh Adam from that state on the graph's
    gradient; one graphed step without a host sync; the kernels a replay
    runs.  Prints capture ms, pool MB and kernel nodes, and with ``timed``
    the quartiles of steps timed in turn and the busy shares."""
    from raytracercore_tpu_torch.diff import get_material_params
    from raytracercore_tpu_torch.parallel import make_train_step
    from raytracercore_tpu_torch.render.renderer import pass_seed

    t_route = time.perf_counter()
    target = torch.full((scene.height, scene.width, 3), GRAPH_TARGET,
                        device=scene.materials.diffuse.device)
    pe, pg = get_material_params(scene), get_material_params(scene)
    oe = torch.optim.Adam(pe.values(), lr=TRAIN_LR)
    og = torch.optim.Adam(pg.values(), lr=TRAIN_LR)
    kw = {"use_replay": use_replay}
    if closest_fn is not None:
        kw["closest_fn"] = closest_fn
    se = make_train_step(None, oe, graphs=False, **kw)
    sg = make_train_step(None, og, **kw)

    def restore(params, opt, saved_p, saved_o):
        with torch.no_grad():
            for k, v in saved_p.items():
                params[k].copy_(v)
        opt.load_state_dict(copy.deepcopy(saved_o))

    saved = ({k: v.detach().clone() for k, v in pe.items()},
             copy.deepcopy(oe.state_dict()))
    t0 = time.perf_counter()
    sg(pg, scene, camera, target, pass_seed(GRAPH_SEED, 99))
    first_ms = (time.perf_counter() - t0) * 1e3
    restore(pg, og, *saved)
    entry = next(iter(sg.graphs.entries.values()))
    kern = graph_kernels(f"{label} train step", entry.captured, want, tmp)
    losses, worst_g, worst_p = [], 0.0, 0.0
    for i in range(GRAPH_STEPS):
        seed = pass_seed(GRAPH_SEED, i)
        saved = ({k: v.detach().clone() for k, v in pe.items()},
                 copy.deepcopy(oe.state_dict()))
        le = se(pe, scene, camera, target, seed)
        ge = {k: v.grad.clone() for k, v in pe.items()}
        restore(pg, og, *saved)
        lg = sg(pg, scene, camera, target, seed)
        gg = {k: v.grad.clone() for k, v in pg.items()}
        check(torch.equal(lg, le), f"{label} step {i}: graphed loss "
              f"{float(lg):.9f} bit-equal to the eager {float(le):.9f}")
        scale = max(float(v.abs().max()) for v in ge.values())
        err = max(float((gg[k] - ge[k]).abs().max()) for k in ge)
        check(scale > 0 and err <= GRAD_TOL * scale,
              f"{label} step {i}: gradients within {GRAD_TOL}·max|g| of the "
              f"eager step's (max err {err:.3e}, max|g| {scale:.3e})")
        worst_g = max(worst_g, err / scale)
        ref = {k: v.clone().requires_grad_(True) for k, v in saved[0].items()}
        oref = torch.optim.Adam(ref.values(), lr=TRAIN_LR)
        oref.load_state_dict(copy.deepcopy(saved[1]))
        for k, v in ref.items():
            v.grad = gg[k].clone()
        oref.step()
        differ = [k for k in ref if not torch.equal(ref[k], pg[k])]
        check(not differ, f"{label} step {i}: params after the graphed step "
              f"bit-equal to Adam on the graph's gradient (differing "
              f"{differ})")
        if "shade_bounce" in want:
            lp, gp = plain_shading_step_loss(saved[0], scene, camera, target,
                                             seed, closest_fn)
            err = max(float((gg[k] - gp[k]).abs().max()) for k in gp)
            check(torch.equal(lg, lp) and err <= GRAD_TOL * scale,
                  f"{label} step {i}: graphed loss {float(lg):.9f} bit-equal "
                  f"to the plain bounce body's {float(lp):.9f}, gradients "
                  f"within {GRAD_TOL}·max|g| (max err {err:.3e})")
            worst_p = max(worst_p, err / scale)
        losses.append(float(lg))
    check_no_sync(f"{label} graphed train step",
                  lambda: sg(pg, scene, camera, target, 7))
    times = ""
    if timed:
        k = iter(range(10 ** 6))
        ms_e, ms_g = interleaved(
            (lambda: se(pe, scene, camera, target, next(k)),
             lambda: sg(pg, scene, camera, target, next(k))),
            GRAPH_TIMED_STEPS)
        busy_e, _ = device_busy(lambda i: se(pe, scene, camera, target, i),
                                GRAPH_BUSY)
        busy_g, top_g = device_busy(
            lambda i: sg(pg, scene, camera, target, i), GRAPH_BUSY)
        times = (f"; {GRAPH_TIMED_STEPS} steps each in turn, ms min/p25/"
                 f"median/p75/max eager={quartiles(ms_e)} graphed="
                 f"{quartiles(ms_g)}; device busy eager {busy_e:.1f} % "
                 f"graphed {busy_g:.1f} %")
    print(f"[graph] {label} train step (use_replay={use_replay}): "
          f"{GRAPH_STEPS} Adam steps lr="
          f"{TRAIN_LR}, each from one saved state: losses bit-equal ("
          + " ".join(f"{x:.8f}" for x in losses)
          + f"), worst gradient diff / max|g| {worst_g:.3e}, params "
          f"bit-equal to Adam on the graph's gradient"
          + (f"; losses bit-equal to the plain bounce body's recorder, "
             f"gradients within {worst_p:.3e}·max|g|"
             if "shade_bounce" in want else "")
          + f"; first call ms="
          f"{first_ms:.1f} (warm-up, capture, replay); {kern}{times}; "
          f"route s={time.perf_counter() - t_route:.1f} on {card}")
    if timed:
        print(f"[graph] {label} graphed train steps, device us per step: "
              f"{top_g}")


def bvh_kernels(r):
    """The kernels one pass of a BVH-route renderer ``r`` launches: the
    traversal once per BVH and bounce (the key kernel before it where it
    sorts), the select kernel once a bounce for a dense tail, the shading
    kernel once a bounce; every traversal launch writes the record."""
    n = r.arrays.recursion + 1
    want = {"traverse": len(r.closest_fn.bvhs) * n,
            "traverse_record": len(r.closest_fn.bvhs) * n, "shade_bounce": n}
    if r.closest_fn.sort:
        want["sort_key"] = want["traverse"]
    if r.closest_fn.tail is not None:
        want["closest_hit_fused"] = n
    return want


def graph_phase(card, dev):
    """The graphed forms of the main path, at full width on every route:
    cornell 700² rec10 (the megakernel), mesh-722 700² rec10 (``trace`` +
    select), mesh-184k 512² rec4 (the BVH) passes; train steps on cornell,
    mesh-722 and mesh-46k 512² rec4.  (The graphed mesh-1M pass is in
    :func:`bvh_big_pass`.)  Returns the launches of the phase."""
    from raytracercore_tpu_torch.render.renderer import Renderer
    from raytracercore_tpu_torch.scene import loader

    zero_counts()
    host = loader.parse(cornell_scene())
    mesh, mesh_cam = lit_mesh_scene(MESH_GRID, MESH_SUBDIV, 700, 10, dev)
    big, big_cam = lit_mesh_scene(*BVH_MESH, BVH_SIZE, BVH_REC, dev)
    bounces = host.recursion + 1
    with tempfile.TemporaryDirectory() as tmp:
        graph_pass_route(
            card, "cornell 700x700 rec10",
            lambda gr: Renderer(host, device=dev, seed=GRAPH_SEED,
                                graphs=gr),
            lambda r: {"trace_pass": 1}, tmp, states=True)
        graph_pass_route(
            card, "mesh-722 700x700 rec10",
            lambda gr: Renderer(mesh, device=dev, seed=GRAPH_SEED,
                                cameras=[mesh_cam], graphs=gr),
            lambda r: {"closest_hit_fused": bounces,
                       "shade_bounce": bounces, "pass_rays": 1}, tmp)
        torch.cuda.empty_cache()
        graph_pass_route(
            card, "mesh-184k 512x512 rec4",
            lambda gr: Renderer(big, device=dev, seed=GRAPH_SEED,
                                cameras=[big_cam], graphs=gr),
            lambda r: {**bvh_kernels(r), "pass_rays": 1}, tmp)
        torch.cuda.empty_cache()
        rc = Renderer(host, device=dev, graphs=False)
        graph_step_route(card, "cornell 700x700 rec10", rc.arrays,
                         rc.camera, None, {"trace_fused": 1,
                                           "prepare_uniforms_kernel": 1,
                                           "replay_bwd": 1}, tmp)
        rm = Renderer(mesh, device=dev, cameras=[mesh_cam], graphs=False)
        graph_step_route(card, "mesh-722 700x700 rec10", rm.arrays,
                         rm.camera, None,
                         {"prepare_uniforms_kernel": 1, "replay_fwd": 1,
                          "replay_bwd": 1, "closest_hit_fused": bounces,
                          "shade_bounce": bounces}, tmp)
        # The autograd oracle's step (use_replay=False: the backward of
        # the whole bounce loop) on a small mesh.
        small, small_cam = lit_mesh_scene(1, 1, 128, 4, dev)
        rs = Renderer(small, device=dev, cameras=[small_cam], graphs=False)
        graph_step_route(card, "mesh-82 128x128 rec4", rs.arrays, rs.camera,
                         None, {"prepare_uniforms_kernel": 1,
                                "closest_hit_fused": small.recursion + 1},
                         tmp, use_replay=False, timed=False)
        del rc, rm, rs
        torch.cuda.empty_cache()
        scene46, cam46 = lit_mesh_scene(*BVH_TRAIN_MESH, BVH_SIZE, BVH_REC,
                                        dev)
        r46 = Renderer(scene46, device=dev, cameras=[cam46], graphs=False)
        want = {"prepare_uniforms_kernel": 1, "replay_fwd": 1,
                "replay_bwd": 1, **bvh_kernels(r46)}
        graph_step_route(card, "mesh-46k 512x512 rec4", r46.arrays,
                         r46.camera, r46.closest_fn, want, tmp)
    counts = read_counts()
    print(f"[graph] launches of the graph phase (eager and graphed, replays "
          f"counted kernel by kernel) {counts}")
    check(counts["traverse_record"] == counts["traverse"], "graph phase: "
          f"every traversal launch wrote the record ({counts})")
    return counts


def main():
    import argparse

    ap = argparse.ArgumentParser(
        description="Chip smoke test of the PyTorch + CUDA port.")
    ap.add_argument("--times", action="store_true",
                    help="only time the megakernel, the replay forward "
                    "and backward and the select kernel (times_main), for a "
                    "parent-vs-change comparison in one call")
    ap.add_argument("--bvh-times", action="store_true",
                    help="only time the BVH tier's build, packing and "
                    "walk on mesh-184k and mesh-1M (bvh_times_main), for a "
                    "parent-vs-change comparison in one call")
    ap.add_argument("--trace-pass", action="store_true",
                    help="only hold the bounce loop's glue-free pass "
                    "against the chain on mesh-722 and mesh-184k and time "
                    "both (trace_pass_main)")
    ap.add_argument("--parent", default=None,
                    help="with --trace-pass: the parent checkout whose "
                    "csrc/*.cu SASS this tree's is diffed against")
    ap.add_argument("--root", default=None,
                    help="with --times or --bvh-times: the checkout whose "
                    "raytracercore_tpu_torch is built and timed (default: "
                    "the one this file lies in)")
    ap.add_argument("--label", default="tree",
                    help="with --times or --bvh-times: the name of the tree "
                    "in the output")
    args = ap.parse_args()
    if args.root and not (args.times or args.bvh_times):
        ap.error("--root goes with --times or --bvh-times")
    if args.parent and not args.trace_pass:
        ap.error("--parent goes with --trace-pass")

    # --- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    if args.trace_pass:
        card = card_line()
        print(card)
        return trace_pass_main(card, args.parent)
    if args.times or args.bvh_times:
        if args.root:
            sys.path.insert(0, str(Path(args.root).resolve()))
        card = card_line()
        print(card)
        return (times_main if args.times else bvh_times_main)(args.label,
                                                              card)
    with phase("import"):
        # The port's own modules; in a directory without the repository this
        # import fails and the run ends here.
        from raytracercore_tpu_torch import kernels
        from raytracercore_tpu_torch.parallel.worker import (FUSED_TEST_SCENE,
                                                             SMOOTH_SCENE)
        from raytracercore_tpu_torch.render import fused
        from raytracercore_tpu_torch.render.renderer import (Renderer,
                                                             render_pass)
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
    with phase("build"):
        info = kernels.build()
        kernels.load()
        print(f"[build] {info['path']} built={info['built']} "
              f"seconds={info['seconds']:.1f}")
        BUILD_REGS.update(ptxas_registers(info["log"]))
        print(f"[build] {len(BUILD_REGS)} kernels in the build log; registers "
              f"and occupancy stand beside each kernel's time")
        record_stack_depths()

    # --- 3. kernel vs plain on the card -----------------------------------
    with phase("kernels vs plain"):
        max_err = 0.0
        fwd_err = bwd_err = 0.0
        for name, text in (("test_fused", FUSED_TEST_SCENE),
                           ("smooth+ambient_miss", SMOOTH_SCENE),
                           ("cornell", cornell_scene()), ("rough", ROUGH_SCENE)):
            for rec in (4, 10):
                inputs = rays_and_uniforms(text, COMPARE_SIZE, rec, 1000 + rec,
                                           dev)
                label = f"{name} {COMPARE_SIZE}x{COMPARE_SIZE} rec{rec}"
                if name != "rough":
                    max_err = max(max_err, compare(label, *inputs))
                errs = compare_replay(label, *inputs)
                fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])
        inputs = rays_and_uniforms(cornell_scene(), 700, 10, 17, dev)
        errs = compare_replay("cornell 700x700 rec10", *inputs)
        fwd_err, bwd_err = max(fwd_err, errs[0]), max(bwd_err, errs[1])
        del inputs
        uni_err, uni_ms, uni_plain_ms = compare_uniforms(dev, 700 * 700, 11)
        print(f"[time] prepare_uniforms_kernel [11,7,490000]: kernel device ms "
              f"(CUDA graph)={fmt_ms(uni_ms)} plain ms={uni_plain_ms:.3f} on "
              f"{card}; "
              + occupancy_text("uniforms_kernel", UNIFORMS_THREADS))
        probe = probe_phase(card, dev)

        # The select kernel on five scenes at 256x256 (all three tables, an
        # ellipsoid and a two-sided plane; triangles only, with smooth normals;
        # transformed and plain spheres) and one sphere scene at 700x700; the
        # mesh scene at 700x700 is compared beside main path 3.
        from raytracercore_tpu_torch.scene import meshgen
        from raytracercore_tpu_torch.scene.types import freeze_scene

        cornell = loader.parse(cornell_scene())
        select_scenes = [
            ("cornell", freeze_scene(cornell, device=dev), cornell.cameras[0],
             COMPARE_SIZE),
            ("mesh-82", *meshgen.make_mesh_scene(
                grid=1, subdiv=1, recursion=4, device=dev)[:2], COMPARE_SIZE),
            ("mesh-722", *meshgen.make_mesh_scene(
                grid=MESH_GRID, subdiv=MESH_SUBDIV, recursion=4, device=dev)[:2],
             COMPARE_SIZE),
            ("ellipsoids-12", *meshgen.make_sphere_field_scene(
                grid=12, ellipsoid=True, device=dev), COMPARE_SIZE),
            ("spheres-16", *meshgen.make_sphere_field_scene(
                grid=16, device=dev), COMPARE_SIZE),
            ("spheres-16", *meshgen.make_sphere_field_scene(
                grid=16, recursion=10, device=dev), 700),
        ]
        select_err = 0.0
        for name, scene, host_cam, size in select_scenes:
            rays = camera_rays_and_uniforms(scene, host_cam, size, 31, dev)
            queries = closest_hit_queries(scene, *rays)
            select_err = max(select_err, compare_select(
                f"{name} {size}x{size}", scene, queries))
        del select_scenes, queries, rays
        compare_routes(card, dev)

    # --- 4. main path 1: Renderer at 700x700, recursion 10 ----------------
    with phase("main path 1 (cornell Renderer)"):
        host = loader.parse(cornell_scene())
        check((host.width, host.height, host.recursion) == (700, 700, 10),
              "main-path scene is 700x700 rec10")
        r = Renderer(host, device="cuda", seed=0)
        t0 = time.perf_counter()
        r.step(WARM_PASSES)
        warm_s = time.perf_counter() - t0
        r.reset()
        fused.trace_pass.launches = 0
        pass_s = []
        for _ in range(MAIN_PASSES):
            t0 = time.perf_counter()
            r.step(1)
            pass_s.append(time.perf_counter() - t0)
        launches = fused.trace_pass.launches
        st = r.status()
        print(f"[main] launches of trace_pass (the megakernel's whole pass) "
              f"during {MAIN_PASSES} passes: {launches}")
        check(launches == MAIN_PASSES,
              f"main path launched the megakernel once per pass "
              f"({launches} != {MAIN_PASSES})")
        film = r.film
        check(all(bool(torch.isfinite(t).all()) for t in
                  (film.color_sum, film.samples, film.misses)),
              "film is finite")
        check(float(film.samples.sum() + film.misses.sum())
              == MAIN_PASSES * 700 * 700, "one sample per pixel per pass")
        image_stage(card, r, "cornell")
        img = r.image()
        check(img.shape == (700, 700, 4) and img.dtype == np.uint8,
              "image is 700x700 RGBA uint8")
        check(int(img[..., :3].max()) > 50, "image is lit (max > 50)")
        q = np.percentile(np.asarray(pass_s) * 1e3, [0, 25, 50, 75, 100])
        print(f"[main] cornell 700x700 rec10, {MAIN_PASSES} passes "
              f"(graphed={r.graphs}): "
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
            cornell_scene(), 700, 10, 7, dev)
        max_err = max(max_err, compare("cornell 700x700 rec10", arrays, ray_o,
                                       ray_d, uniforms))
        kernel_ms = graph_ms(
            lambda: fused.trace_fused(arrays, ray_o, ray_d, uniforms), 20)
        plain_ms = cuda_ms(
            lambda: fused.trace_fused_reference(arrays, ray_o, ray_d, uniforms),
            2)
        kernel_ms2 = graph_ms(
            lambda: fused.trace_fused(arrays, ray_o, ray_d, uniforms), 20)
        kernel_tape_ms = graph_ms(lambda: fused.trace_fused(
            arrays, ray_o, ray_d, uniforms, want_tape=True), 20)
        _, _, tape = fused.trace_fused(arrays, ray_o, ray_d, uniforms,
                                       want_tape=True)
        reached = int(((tape.flags & 0xF) != 0).sum())  # bounces the paths reach
        fused_bound = bound(
            reached * (row_ops(arrays, coplanar=False) + OPS_SHADE),
            nbytes(ray_o, ray_d, uniforms, *arrays.fused_tables)
            + ray_o.shape[0] * 16)
        del tape
        print(f"[time] trace_fused cornell 700x700 rec10: kernel device ms "
              f"(CUDA graph)={fmt_ms(kernel_ms)} (again {fmt_ms(kernel_ms2)}; "
              f"with the tape {fmt_ms(kernel_tape_ms)}) plain ms={plain_ms:.3f} "
              f"bound ms={fused_bound[0]:.4f} (by {fused_bound[1]}, "
              f"{reached / ray_o.shape[0]:.4f} bounces per path) on {card}")
        print(f"[time] trace_fused kernel: " + occupancy_text(
            "trace_fused_kernel", FUSED_THREADS,
            nbytes(*arrays.fused_tables)))

        # The megakernel's whole pass alone: one launch on a pass's draws
        # into a film (camera rays, uniform channels and film add inside).
        from raytracercore_tpu_torch.render.film import Film
        from raytracercore_tpu_torch.render.renderer import (pass_generator,
                                                             raw_draws)
        p_jitter, p_raw = raw_draws(pass_generator(7, 0, dev), 700 * 700, 11)
        p_film = Film.create(700, 700, device=dev)
        whole_ms = graph_ms(lambda: fused.trace_pass(
            arrays, r.camera, p_film, p_jitter, p_raw), 20)
        pass_kernels = tuple(
            "trace_fused_kernelILb0E" + "".join(f"Lb{b}E" for b in bits)
            + "Lb1E" for bits in np.ndindex(2, 2, 2))
        print(f"[time] trace_pass cornell 700x700 rec10: the whole pass's "
              f"kernel device ms (CUDA graph)={fmt_ms(whole_ms)} (trace_fused "
              f"alone {fmt_ms(kernel_ms)}); " + occupancy_text(
                  pass_kernels, FUSED_THREADS,
                  nbytes(*arrays.fused_tables) + 19 * 4))
        del p_jitter, p_raw, p_film

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
    with phase("main path 2 (cornell train step)"):
        train_launches, stage, train_bounds = train_path(card, dev)

    # --- 6. main path 3: the mesh scene above the megakernel's cap ---------
    with phase("main path 3 (mesh-722)"):
        del arrays, ray_o, ray_d, uniforms, jitter, film0
        (mesh_launches, (mesh_train_counts, mesh_replay_errs), select_stage,
         shade_stage_722) = mesh_path(card, dev)
        fwd_err = max(fwd_err, mesh_replay_errs[0])
        bwd_err = max(bwd_err, mesh_replay_errs[1])

    # --- 7. the BVH tier: kernel vs plain, main paths 4 and 5 --------------
    # Renderer builds its tree with backend "auto", which would hand a
    # failed native build to the numpy builder with a warning: here that
    # fails the run (the comparisons ask for "native" by name).
    with phase("BVH tier (mesh-184k, mesh-1M, mesh-46k)"):
        import warnings
        warnings.filterwarnings("error", message="native BVH builder")
        parts = [time.perf_counter()]
        traverse_err = bvh_compare_scenes(card, dev)
        parts.append(time.perf_counter())
        (bvh_launches, traverse_stage, key_stage, rows_184k,
         shade_stage_184k) = bvh_render_path(card, dev)
        parts.append(time.perf_counter())
        torch.cuda.empty_cache()
        big_launches, rows_1m = bvh_big_pass(card, dev)
        add_counts(bvh_launches, big_launches)
        coherence_verdict(card, {"mesh-184k 512x512": rows_184k,
                                 "mesh-1M 1024x1024": rows_1m})
        del rows_184k, rows_1m
        parts.append(time.perf_counter())
        torch.cuda.empty_cache()
        bvh_train_counts, bvh_replay_errs, _ = bvh_train_path(card, dev)
        fwd_err = max(fwd_err, bvh_replay_errs[0])
        bwd_err = max(bwd_err, bvh_replay_errs[1])
        parts.append(time.perf_counter())
        print("[phase] BVH tier parts s: " + ", ".join(
            f"{name} {b - a:.1f}" for name, a, b in zip(
                ("kernel vs plain and oracle", "mesh-184k passes and sweep",
                 "mesh-1M", "mesh-46k train"), parts, parts[1:])))

    # --- 8. the graphed forms: each pass and step captured as a CUDA graph
    # and replayed, against the eager forms, on every route -----------------
    with phase("graphs"):
        torch.cuda.empty_cache()
        graph_counts = graph_phase(card, dev)

    # --- 9. the rest of the surface: add_scatter, merge, dtype=, profile,
    # trace_replay's options ------------------------------------------------
    with phase("surface"):
        torch.cuda.empty_cache()
        surf_counts = surface_phase(card, dev)

    # --- 10. the sharded paths and the debug views ------------------------
    with phase("parallel and debug views"):
        torch.cuda.empty_cache()
        # The launches of the graph, surface and parallel phases' paths.
        phase_counts = add_counts(add_counts(parallel_phase(card, dev),
                                             surf_counts), graph_counts)

    # --- 11. result lines -------------------------------------------------
    PHASE[0] = "result lines"
    from raytracercore_tpu_torch.bvh import cuda_traverse as ct

    check(len(STACK_DEPTHS) > 0, "the run packed wide trees")
    print(f"[bvh] {len(STACK_DEPTHS)} wide trees packed, stack depth "
          f"{min(STACK_DEPTHS)}-{max(STACK_DEPTHS)} of "
          f"{ct.WIDE_STACK}")
    # No single PyTorch call computes any of these functions (a whole path,
    # Philox channels, a path replay and its adjoint, a closest hit over
    # three primitive tables, a BVH walk, a Morton key, a bounce of
    # shading, an issue-rate probe), so there is no library time to
    # report.
    def entry(name, source, replaces, launched, err, ms, p_ms, bound_ms):
        if not replaces.startswith("scripts/"):
            replaces = f"raytracercore_tpu/{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"raytracercore_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": launched, "max_abs_err": err, "ms": ms,
                "plain_ms": p_ms, "bound_ms": bound_ms[0],
                "bound_by": bound_ms[1], "library_ms": None}

    print("[phase] seconds: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in PHASE_SECONDS.items())
        + f"; total {time.perf_counter() - T0[0]:.1f}")
    print(card)
    print(json.dumps({"kernels": [
        entry("trace_fused", "fused.cu", "render/fused.py:56",
              launches + train_launches["trace_fused"]
              + phase_counts["trace_fused"]
              + phase_counts.get("trace_pass", 0),
              max_err, kernel_ms,
              plain_ms, fused_bound),
        entry("prepare_uniforms_kernel", "uniforms.cu",
              "render/uniforms_kernel.py:64",
              train_launches["prepare_uniforms_kernel"]
              + mesh_train_counts["prepare_uniforms_kernel"]
              + bvh_train_counts["prepare_uniforms_kernel"]
              + phase_counts["prepare_uniforms_kernel"], uni_err,
              uni_ms, uni_plain_ms, train_bounds["uniforms"]),
        entry("replay_fwd", "replay.cu", "render/replay_kernel.py:163",
              train_launches["replay_fwd"] + mesh_train_counts["replay_fwd"]
              + bvh_train_counts["replay_fwd"] + phase_counts["replay_fwd"],
              fwd_err,
              *stage["replay forward"], train_bounds["replay forward"]),
        entry("replay_bwd", "replay.cu", "render/replay_kernel.py:193",
              train_launches["replay_bwd"] + mesh_train_counts["replay_bwd"]
              + bvh_train_counts["replay_bwd"] + phase_counts["replay_bwd"],
              bwd_err,
              *stage["replay backward"], train_bounds["replay backward"]),
        entry("closest_hit_fused", "select.cu",
              "intersect/pallas_select.py:42",
              mesh_launches["closest_hit_fused"]
              + mesh_train_counts["closest_hit_fused"]
              + phase_counts["closest_hit_fused"],
              max(select_err, select_stage["max_abs_err"]),
              select_stage["ms"], select_stage["plain_ms"],
              (select_stage["bound_ms"], select_stage["bound_by"])),
        entry("traverse", "traverse.cu", "bvh/pallas_traverse.py:292",
              bvh_launches["traverse"] + bvh_train_counts["traverse"]
              + phase_counts["traverse"],
              max(traverse_err, traverse_stage["max_abs_err"]),
              traverse_stage["ms"], traverse_stage["plain_ms"],
              (traverse_stage["bound_ms"], traverse_stage["bound_by"])),
        # The counterpart of the XLA operations of PallasBVH._sort_key, not
        # of a Pallas kernel.
        entry("sort_key", "traverse.cu", "bvh/pallas_traverse.py:951",
              bvh_launches["sort_key"] + bvh_train_counts["sort_key"]
              + phase_counts.get("sort_key", 0), key_stage["max_abs_err"],
              key_stage["ms"], key_stage["plain_ms"], key_stage["bound"]),
        # The counterpart of the XLA fusions of the JAX trace's bounce
        # body under jit, not of a Pallas kernel; timed on mesh-722 bounce
        # 1 (mesh-184k's in the shade lines above).
        entry("shade_bounce", "shade.cu", "render/integrator.py:298",
              mesh_launches["shade_bounce"] + bvh_launches["shade_bounce"]
              + mesh_train_counts["shade_bounce"]
              + bvh_train_counts["shade_bounce"]
              + phase_counts["shade_bounce"],
              max(shade_stage_722["max_abs_err"],
                  shade_stage_184k["max_abs_err"]),
              shade_stage_722["ms"], shade_stage_722["plain_ms"],
              (shade_stage_722["bound_ms"], shade_stage_722["bound_by"])),
        entry("issue_probe", "issue_probe.cu",
              "scripts/vpu_issue_bench.py:106",
              probe["launches"], probe["max_abs_err"], probe["ms"],
              probe["plain_ms"], probe["bound"]),
        # The counterpart of the XLA fusion of Film.to_uint8 in the JAX
        # Renderer.image, not of a Pallas kernel; timed on main path 1's
        # film (cornell 700x700), its error the most differing bytes of
        # the three main paths' images.
        entry("tonemap_pack", "tonemap.cu", "render/renderer.py:233",
              sum(v["launches"] for v in IMAGE_STAGES.values()),
              max(v["differ"] for v in IMAGE_STAGES.values()),
              IMAGE_STAGES["cornell"]["ms"],
              IMAGE_STAGES["cornell"]["plain_ms"],
              IMAGE_STAGES["cornell"]["bound"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
