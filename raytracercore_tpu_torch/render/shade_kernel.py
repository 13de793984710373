"""One bounce of ``trace``'s shading as one CUDA kernel (``csrc/shade.cu``):
the counterpart of the XLA fusions the JAX package compiles its bounce body
into (``raytracercore_tpu/render/integrator.py:298``, under ``jax.jit``).

:func:`shade_bounce` is the wrapper :func:`.integrator.trace` runs after
each closest hit wherever no gradient is needed: on CUDA tensors it
launches the kernel (counted in ``shade_bounce.launches``) or raises; on
CPU tensors it runs the plain version,
:func:`.integrator.shade_bounce_reference`, which is also the body autograd
differentiates.  The kernel is bit-equal to the plain version on every
output and every lane, dead lanes included.

One thread shades one ray: it reads the ray's hit record, its path state
and skip record, the bounce's 7 uniform channels and its hit's material
row, and writes the new state and skip record, and where asked the
bounce's tape row into the ``[B, R]`` tape and its record row into the
``[R, B]`` records that ``trace`` made for the whole loop.  No host
synchronisation: ambient and air IOR are read from device memory, so a
CUDA graph captures the launch.

The trace route's pass without eager glue (:func:`.integrator.trace_pass`)
runs two more entry points of the same file, each with its plain version
on CPU tensors: :func:`pass_rays` (the pass's camera rays, one launch a
pass, counted in ``pass_rays.launches``) and :func:`shade_bounce_pass`
(the kernel's float32 form on the bounce's raw draws, counted in
``shade_bounce.launches``: one launch of the shading kernel a bounce, as
on every route).
"""

from __future__ import annotations

import torch

import ctypes
import dataclasses

from ..core import vecmath as vm
from ..intersect.dispatch import HitRecord
from ..kernels import check_tensor as _check
from ..scene.types import CameraRT
from . import camera as cam_mod
from .film import Film
from .integrator import (BounceRecords, PathState, PathTape, _needs_grad,
                         preprocess_uniforms, shade_bounce_reference)

# Columns of the material table (integrator._material_matrix).
MAT_F = 14
# The camera's tensors as the camera kernel reads them (csrc/camera.cuh).
CAMERA_FIELDS = ("position", "look", "side", "up", "w2", "h2", "ax", "ay",
                 "image_plane", "dof_amount", "focal_length")


def _inputs(hit: HitRecord, state: PathState | None, d, u_entry, matf,
            ambient, air, dtype) -> list:
    """What the shading kernel reads, as ``(name, tensor, shape, dtype)``
    in its order (the next origin is the hit or the parking point, so not
    ``state.ray_o``), ``u_entry`` the bounce's uniforms; no state tensors
    where a bounce 0 starts from the initial state (``state`` None)."""
    R, N = d.shape[0], matf.shape[0]
    i32, b8 = torch.int32, torch.bool
    if state is None:
        state_tensors = (None,) * 9
    else:
        prev = state.prev
        state_tensors = (state.tint, state.alive, state.result, state.miss,
                         prev.prim, prev.t, prev.position, prev.normal,
                         prev.inside)
    names = (("state.tint", (R, 3), dtype), ("state.alive", (R,), b8),
             ("state.result", (R, 3), dtype), ("state.miss", (R,), b8),
             ("prev.prim", (R,), i32), ("prev.t", (R,), dtype),
             ("prev.position", (R, 3), dtype),
             ("prev.normal", (R, 3), dtype), ("prev.inside", (R,), b8))
    return [
        ("hit.prim", hit.prim, (R,), i32), ("hit.t", hit.t, (R,), dtype),
        ("hit.position", hit.position, (R, 3), dtype),
        ("hit.normal", hit.normal, (R, 3), dtype),
        ("hit.inside", hit.inside, (R,), b8),
        ("d", d, (R, 3), dtype),
        *((name, t, shape, want)
          for (name, shape, want), t in zip(names, state_tensors)),
        u_entry, ("matf", matf, (N, MAT_F), dtype),
        ("ambient", ambient, (3,), dtype), ("air", air, (), dtype)]


def _checked(inputs, dev) -> list:
    """The tensors of :func:`_inputs`, made contiguous and checked against
    their shape, dtype and ``dev`` (None stays None); raises
    ``ValueError`` where one requires grad while autograd records (the
    kernel has no backward)."""
    if _needs_grad(*(t for _, t, _, _ in inputs if t is not None)):
        raise ValueError("shade kernel: an input requires grad and the "
                         "kernel has no backward; trace runs "
                         "shade_bounce_reference under autograd")
    ins = []
    for name, t, shape, want in inputs:
        if t is not None:
            t = t.contiguous()
            _check(name, t, shape, want, dev)
        ins.append(t)
    return ins


def _empty_state(R, dtype, dev):
    """A :class:`.integrator.PathState` of new tensors for the kernel to
    write, and its tensors in the kernel's output order."""
    i32, b8 = torch.int32, torch.bool

    def empty(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)
    out = PathState(
        ray_o=empty((R, 3)), ray_d=empty((R, 3)), tint=empty((R, 3)),
        alive=empty((R,), b8), result=empty((R, 3)), miss=empty((R,), b8),
        prev=HitRecord(prim=empty((R,), i32), t=empty((R,)),
                       position=empty((R, 3)), normal=empty((R, 3)),
                       inside=empty((R,), b8)))
    return out, [out.ray_o, out.ray_d, out.tint, out.alive, out.result,
                 out.miss, out.prev.prim, out.prev.t, out.prev.position,
                 out.prev.normal, out.prev.inside]


def _launch(hit: HitRecord, state: PathState, d, u, matf, ambient, air,
            i: int, recursion: int, ambient_is_miss: bool,
            tape: PathTape | None, records: BounceRecords | None
            ) -> PathState:
    from .. import kernels

    dev = d.device
    dtype = d.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"shade kernel: rays of {dtype}, expected float32 "
                         "or float64")
    R = d.shape[0]
    N = matf.shape[0]
    if N == 0:
        raise ValueError("shade kernel: the material table has no rows")
    i32, b8 = torch.int32, torch.bool
    ins = _checked(_inputs(hit, state, d, ("u", u, (7, R), dtype), matf,
                           ambient, air, dtype), dev)
    out, outs = _empty_state(R, dtype, dev)
    B = recursion + 1
    if not 0 <= i < B:
        raise ValueError(f"shade kernel: bounce {i} of {B}")
    if tape is None:
        tape_ptrs = [None] * 5
    else:
        for name, t, want in (("tape.prim", tape.prim, i32),
                              ("tape.flags", tape.flags, i32),
                              ("tape.nx", tape.nx, dtype),
                              ("tape.ny", tape.ny, dtype),
                              ("tape.nz", tape.nz, dtype)):
            _check(name, t, (B, R), want, dev)
        tape_ptrs = [t.data_ptr() for t in (tape.prim, tape.flags, tape.nx,
                                            tape.ny, tape.nz)]
    if records is None:
        rec_ptrs = [None] * 7
    else:
        for name, t, shape, want in (
                ("records.btype", records.btype, (R, B), i32),
                ("records.prim", records.prim, (R, B), i32),
                ("records.t", records.t, (R, B), dtype),
                ("records.position", records.position, (R, B, 3), dtype),
                ("records.normal", records.normal, (R, B, 3), dtype),
                ("records.inside", records.inside, (R, B), b8),
                ("records.fresnel", records.fresnel, (R, B), dtype)):
            _check(name, t, shape, want, dev)
        rec_ptrs = [t.data_ptr() for t in (
            records.btype, records.prim, records.t, records.position,
            records.normal, records.inside, records.fresnel)]
    err = kernels.load().rtc_shade(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        *tape_ptrs, *rec_ptrs, R, N, i, B, recursion, int(ambient_is_miss),
        int(dtype == torch.float64), _stream(dev))
    if err != 0:
        raise RuntimeError(f"shade kernel launch failed: CUDA error {err}")
    kernels.count_launch(shade_bounce)
    return out


def _stream(device) -> int:
    """The handle of ``device``'s current CUDA stream."""
    return torch.cuda.current_stream(device).cuda_stream


def shade_bounce(hit: HitRecord, state: PathState, d, u, matf, ambient, air,
                 i: int, recursion: int, ambient_is_miss: bool,
                 tape: PathTape | None = None,
                 records: BounceRecords | None = None) -> PathState:
    """Bounce ``i`` of ``trace`` after its closest hit, with the arguments
    and result of :func:`.integrator.shade_bounce_reference`.  On CUDA
    tensors this launches ``csrc/shade.cu`` (f32 or f64, the rays' dtype)
    and raises if it cannot, or if an input requires grad while autograd
    records (the kernel has no backward); on CPU tensors it runs the plain
    version.  The caller's tensors are never written, but for row / column
    ``i`` of ``tape`` and ``records``."""
    if d.device.type == "cuda":
        return _launch(hit, state, d, u, matf, ambient, air, i, recursion,
                       ambient_is_miss, tape, records)
    if d.device.type == "cpu":
        return shade_bounce_reference(hit, state, d, u, matf, ambient, air,
                                      i, recursion, ambient_is_miss, tape,
                                      records)
    raise ValueError(f"shade_bounce: unsupported device {d.device}")


# Launches of the shading kernel (set it to 0 before a run to see that the
# run went through the kernel).
shade_bounce.launches = 0


def _launch_pass(hit: HitRecord, state: PathState | None, d, raw, matf,
                 ambient, air, i: int, recursion: int,
                 ambient_is_miss: bool, film: Film | None, renorm: bool
                 ) -> PathState | None:
    from .. import kernels

    dev = d.device
    f32 = torch.float32
    R = d.shape[0]
    N = matf.shape[0]
    B = recursion + 1
    if N == 0:
        raise ValueError("shade kernel: the material table has no rows")
    if not 0 <= i < B:
        raise ValueError(f"shade kernel: bounce {i} of {B}")
    if (state is None) != (i == 0):
        raise ValueError("shade_bounce_pass: bounce 0, and only bounce 0, "
                         "starts from the initial path state (state=None)")
    if (film is not None) != (i == recursion):
        raise ValueError("shade_bounce_pass: the film takes the samples at "
                         "the last bounce, and only there")
    ins = _checked(_inputs(hit, state, d, ("raw", raw, (B, 5, R), f32),
                           matf, ambient, air, f32), dev)
    ptrs = [None if t is None else t.data_ptr() for t in ins]
    ptrs[15] += 5 * R * 4 * i  # bounce i's raw draws [5, R]
    if film is None:
        film_ptrs = [None] * 3
        out, outs = _empty_state(R, f32, dev)
        out_ptrs = [t.data_ptr() for t in outs]
    else:
        if film.color_c is not None:
            raise ValueError("shade_bounce_pass: a compensated film is "
                             "added by Film.add_full_frame_, not the kernel")
        h, w = film.shape
        if h * w != R:
            raise ValueError(f"shade_bounce_pass: a film of {h}x{w} pixels "
                             f"for {R} rays")
        for name, t in zip(("color_sum", "samples", "misses"),
                           film.tensors()):
            _check(f"film.{name}", t, t.shape, f32, dev)
        film_ptrs = [t.data_ptr() for t in film.tensors()]
        out, out_ptrs = None, [None] * 11
    err = kernels.load().rtc_shade_pass(
        *ptrs, *out_ptrs, *film_ptrs, R, N, i, B, recursion,
        int(ambient_is_miss), int(renorm), _stream(dev))
    if err != 0:
        raise RuntimeError(f"shade kernel launch failed: CUDA error {err}")
    kernels.count_launch(shade_bounce)
    return out


def shade_bounce_pass(hit: HitRecord, state: PathState | None, d, raw,
                      matf, ambient, air, i: int, recursion: int,
                      ambient_is_miss: bool, film: Film | None = None,
                      renorm: bool = False) -> PathState | None:
    """Bounce ``i`` of :func:`.integrator.trace_pass` after its closest hit:
    :func:`shade_bounce` (without tape or records) on the bounce's raw
    draws ``raw[i]`` (``raw``: the pass's ``[recursion + 1, 5, R]``), whose
    uniform channels it computes (:func:`.integrator.preprocess_uniforms`).
    ``state`` is None at bounce 0, and only there: the paths start from
    :meth:`.integrator.PathState.start`.  ``renorm``: the next direction
    comes out normalized (``vecmath.normalize``, as ``trace`` renormalizes
    it before the next query).  ``film`` (the last bounce, and only it):
    the samples are added into its own tensors
    (:meth:`.film.Film.add_full_frame_`) and None is returned; else the
    paths' state after the bounce.

    On CUDA tensors (float32; a float32 film without compensation) this
    launches the shading kernel's pass form (``csrc/shade.cu``
    ``rtc_shade_pass``, counted in ``shade_bounce.launches``) or raises;
    on CPU tensors it runs the plain version, which is those steps in
    torch."""
    if d.device.type == "cuda":
        return _launch_pass(hit, state, d, raw, matf, ambient, air, i,
                            recursion, ambient_is_miss, film, renorm)
    if d.device.type != "cpu":
        raise ValueError(f"shade_bounce_pass: unsupported device {d.device}")
    if state is None:
        state = PathState.start(torch.zeros_like(d), d)
    out = shade_bounce_reference(hit, state, d, preprocess_uniforms(raw[i]),
                                 matf, ambient, air, i, recursion,
                                 ambient_is_miss)
    if film is not None:
        film.add_full_frame_(out.result, out.miss)
        return None
    if renorm:
        out = dataclasses.replace(out, ray_d=vm.normalize(out.ray_d))
    return out


def pass_rays(camera: CameraRT, jitter, width: int):
    """The camera rays of a pass over the row-major pixel grid ``width``
    wide (ray ``i`` is pixel ``i``) from its ``[R, 4]`` jitter: ``(ray_o
    [R, 3], ray_d [R, 3])``, :func:`.camera.camera_rays` with ``ray_d``
    normalized as ``trace`` renormalizes it at bounce 0.

    On CUDA tensors (float32) this launches ``csrc/shade.cu``
    ``rtc_pass_rays`` (the camera code the megakernel's whole pass runs,
    ``csrc/camera.cuh``; counted in ``pass_rays.launches``) or raises; on
    CPU tensors it runs the plain version, those two steps in torch."""
    R = jitter.shape[0]
    if width <= 0 or R % width:
        raise ValueError(f"pass_rays: {R} rays do not fill rows of {width}")
    if jitter.device.type == "cuda":
        return _launch_rays(camera, jitter, width)
    if jitter.device.type != "cpu":
        raise ValueError(f"pass_rays: unsupported device {jitter.device}")
    px, py = cam_mod.pixel_grid(width, R // width, device=jitter.device)
    ray_o, ray_d = cam_mod.camera_rays(camera, px, py, jitter)
    return ray_o.contiguous(), vm.normalize(ray_d)


def _launch_rays(camera: CameraRT, jitter, width: int):
    from .. import kernels

    dev = jitter.device
    f32 = torch.float32
    R = jitter.shape[0]
    _check("jitter", jitter, (R, 4), f32, dev)
    cam = [getattr(camera, name) for name in CAMERA_FIELDS]
    for name, t in zip(CAMERA_FIELDS, cam):
        _check(f"camera.{name}", t, t.shape, f32, dev)
    if _needs_grad(jitter, *cam):
        raise ValueError("pass_rays: an input requires grad and the kernel "
                         "has no backward")
    ray_o = torch.empty((R, 3), dtype=f32, device=dev)
    ray_d = torch.empty((R, 3), dtype=f32, device=dev)
    cam_ptrs = (ctypes.c_void_p * len(cam))(*(t.data_ptr() for t in cam))
    err = kernels.load().rtc_pass_rays(
        jitter.data_ptr(), cam_ptrs, ray_o.data_ptr(), ray_d.data_ptr(), R,
        width, int(camera.mode), _stream(dev))
    if err != 0:
        raise RuntimeError(f"camera kernel launch failed: CUDA error {err}")
    kernels.count_launch(pass_rays)
    return ray_o, ray_d


# Launches of the camera kernel: one a pass of integrator.trace_pass on the
# card, so the count of those passes.
pass_rays.launches = 0
