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
"""

from __future__ import annotations

import torch

from ..intersect.dispatch import HitRecord
from ..kernels import check_tensor as _check
from .integrator import (BounceRecords, PathState, PathTape, _needs_grad,
                         shade_bounce_reference)

# Columns of the material table (integrator._material_matrix).
MAT_F = 14


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
    prev = state.prev
    # What the kernel reads (the next origin is the hit or the parking
    # point, so not state.ray_o).
    inputs = [
        ("hit.prim", hit.prim, (R,), i32), ("hit.t", hit.t, (R,), dtype),
        ("hit.position", hit.position, (R, 3), dtype),
        ("hit.normal", hit.normal, (R, 3), dtype),
        ("hit.inside", hit.inside, (R,), b8),
        ("d", d, (R, 3), dtype),
        ("state.tint", state.tint, (R, 3), dtype),
        ("state.alive", state.alive, (R,), b8),
        ("state.result", state.result, (R, 3), dtype),
        ("state.miss", state.miss, (R,), b8),
        ("prev.prim", prev.prim, (R,), i32), ("prev.t", prev.t, (R,), dtype),
        ("prev.position", prev.position, (R, 3), dtype),
        ("prev.normal", prev.normal, (R, 3), dtype),
        ("prev.inside", prev.inside, (R,), b8),
        ("u", u, (7, R), dtype), ("matf", matf, (N, MAT_F), dtype),
        ("ambient", ambient, (3,), dtype), ("air", air, (), dtype)]
    if _needs_grad(*(t for _, t, _, _ in inputs)):
        raise ValueError("shade kernel: an input requires grad and the "
                         "kernel has no backward; trace runs "
                         "shade_bounce_reference under autograd")
    ins = []
    for name, t, shape, want in inputs:
        t = t.contiguous()
        _check(name, t, shape, want, dev)
        ins.append(t)

    def empty(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)
    out = PathState(
        ray_o=empty((R, 3)), ray_d=empty((R, 3)), tint=empty((R, 3)),
        alive=empty((R,), b8), result=empty((R, 3)), miss=empty((R,), b8),
        prev=HitRecord(prim=empty((R,), i32), t=empty((R,)),
                       position=empty((R, 3)), normal=empty((R, 3)),
                       inside=empty((R,), b8)))
    outs = [out.ray_o, out.ray_d, out.tint, out.alive, out.result, out.miss,
            out.prev.prim, out.prev.t, out.prev.position, out.prev.normal,
            out.prev.inside]
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
