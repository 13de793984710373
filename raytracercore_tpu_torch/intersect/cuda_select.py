"""The per-bounce closest-hit kernel (counterpart of
``raytracercore_tpu.intersect.pallas_select``).

One launch answers one bounce's closest-hit query for every ray against
every row of the three packed primitive tables, and returns both

* the per-table winner rows (plus the sphere winner's near/far root) — the
  no-grad *selection* that the differentiable winner evaluation of
  :mod:`.dispatch` consumes (:func:`select_all`), and
* the complete hit record (t, prim, inside, position, normal) evaluated in
  the kernel — the forward path of the renderer and of the tape recorder,
  which needs no gradients (:func:`closest_hit_fused`).

On CUDA tensors both launch the hand-written kernel ``csrc/select.cu``
(counted in ``closest_hit_fused.launches``) or raise; on CPU tensors they
run the plain version, :func:`select_reference`, which walks the same
per-row passes (:mod:`.kernel_body`) in the kernel's operation order.
Semantics are those of :mod:`.torch_ref` / :mod:`.dispatch`, the
independent grid oracle, except on dead lanes: a ray whose origin is
``config.PARKED_ORIGIN`` in all three coordinates (a path the integrator
has finished and parked) gets the no-hit record without a scan, in the
kernel and in its plain version alike.

The kernel reads the tables in a layout of its own,
:func:`pack_select_tables` (``SceneArrays.select_tables``, built once per
geometry), whose rows load as 128-bit words.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import PARKED_ORIGIN, SELECT_MAX_PRIMS
from ..core import vecmath as vm
from ..kernels import check_tensor as _check
from ..scene.types import SceneArrays
from . import kernel_body as kb
from .dispatch import HitRecord, _position_eps, n_table_rows


class SelectOut(NamedTuple):
    """The kernel's 13 output planes.  Per-table winner rows are -1 where
    the table has no surviving hit; ``t`` is 0, ``prim`` -1 and position
    and normal zero where nothing is found; ``inside`` is post-Invert."""

    tri_idx: torch.Tensor    # [R] int32
    sph_idx: torch.Tensor    # [R] int32
    sph_near: torch.Tensor   # [R] bool — the sphere winner is its near root
    pl_idx: torch.Tensor     # [R] int32
    t: torch.Tensor          # [R] f32
    prim: torch.Tensor       # [R] int32
    inside: torch.Tensor     # [R] bool
    position: torch.Tensor   # [R, 3] f32 (planes px, py, pz)
    normal: torch.Tensor     # [R, 3] f32 (planes nx, ny, nz)


class _TableWinner:
    """One table's closest surviving candidate (row, and for spheres the
    near-root flag), tracked beside the global commit."""

    def __init__(self, like):
        self.t = torch.full_like(like, float("inf"))
        self.row = torch.full(like.shape, -1, dtype=torch.int32,
                              device=like.device)
        self.near = torch.zeros(like.shape, dtype=torch.bool,
                                device=like.device)

    def commit(self, row, ok, tt, extra):
        better = ok & (tt < self.t)
        self.t = torch.where(better, tt, self.t)
        self.row = torch.where(better, row, self.row)
        if "v_near" in extra:
            self.near = torch.where(better, extra["v_near"] != 0, self.near)


# Flag bits of the select layout's rows.
SF_MIRROR, SF_SMOOTH, SF_INVERT, SF_TWO_SIDED = 1, 2, 4, 8
# Floats per row of the select layout: triangle (hot and cold), sphere,
# plane.
SEL_TRI_F, SEL_COLD_F, SEL_SPH_F, SEL_PL_F = 16, 12, 32, 8


def _bits(ints):
    """int32 columns as f32 words (the same 32 bits)."""
    return ints.to(torch.int32).contiguous().view(torch.float32)


def pack_select_tables(tables):
    """The select kernel's layout of the packed tables ``(tf, ti, sf, si,
    pf, pi)`` (:func:`.kernel_body.pack_tables`), f32, every row a whole
    number of 16-byte words:

    * ``tri`` ``[T, 16]``: v0, prim | e1, flags | e2, 0 | face normal, 0;
    * ``cold`` ``[T, 12]``: n0, 0 | n1, 0 | n2, 0 — read only for a winner;
    * ``sph`` ``[S, 32]``: w2o rows (12), o2w rows (12), center, radius |
      prim, flags, 0, 0;
    * ``pln`` ``[P, 8]``: normal, dist | prim, flags, 0, 0.

    prim and flags are int32 bits in the f32 words; flags are mirror |
    smooth << 1 | invert << 2 | two_sided << 3."""
    tf, ti, sf, si, pf, pi = tables

    def flags(i):
        return i[:, 1] | (i[:, 2] << 2) | (i[:, 3] << 3)

    def zeros(t, n):
        return torch.zeros((t.shape[0], n), dtype=torch.float32,
                           device=t.device)

    def words(i):
        return _bits(torch.stack([i[:, 0], flags(i)], dim=1))
    tri = torch.cat([tf[:, 0:3], _bits(ti[:, 0:1]), tf[:, 3:6],
                     _bits(flags(ti)[:, None]), tf[:, 6:9], zeros(tf, 1),
                     tf[:, 9:12], zeros(tf, 1)], dim=1)
    cold = torch.cat([tf[:, 12:15], zeros(tf, 1), tf[:, 15:18], zeros(tf, 1),
                      tf[:, 18:21], zeros(tf, 1)], dim=1)
    sph = torch.cat([sf, words(si), zeros(sf, 2)], dim=1)
    pln = torch.cat([pf, words(pi), zeros(pf, 2)], dim=1)
    return tuple(t.to(torch.float32).contiguous()
                 for t in (tri, cold, sph, pln))


def parked_lanes(ray_o):
    """[R] bool: the rays whose origin is ``config.PARKED_ORIGIN`` in all
    three coordinates — dead lanes, which the select kernel answers with
    the no-hit record without a scan."""
    return (ray_o == PARKED_ORIGIN).all(dim=1)


def live_list_reference(ray_o):
    """Plain version of the list kernel: the indices of the live lanes
    (int64, ascending; the kernel's list holds the same indices in any
    order)."""
    return torch.nonzero(~parked_lanes(ray_o))[:, 0]


def _no_hit(R, device) -> SelectOut:
    i32 = torch.int32
    return SelectOut(
        tri_idx=torch.full((R,), -1, dtype=i32, device=device),
        sph_idx=torch.full((R,), -1, dtype=i32, device=device),
        sph_near=torch.zeros((R,), dtype=torch.bool, device=device),
        pl_idx=torch.full((R,), -1, dtype=i32, device=device),
        t=torch.zeros((R,), dtype=torch.float32, device=device),
        prim=torch.full((R,), -1, dtype=i32, device=device),
        inside=torch.zeros((R,), dtype=torch.bool, device=device),
        position=torch.zeros((R, 3), dtype=torch.float32, device=device),
        normal=torch.zeros((R, 3), dtype=torch.float32, device=device))


def select_reference(scene: SceneArrays, ray_o, ray_d, skip, eps_behind,
                     eps_pos) -> SelectOut:
    """Plain torch version of the select kernel (any device), f32: dead
    lanes (:func:`parked_lanes`) get the no-hit record; every live lane
    gets :func:`scan_reference`."""
    R = ray_o.shape[0]
    live = live_list_reference(ray_o)
    if live.numel() == R:
        return scan_reference(scene, ray_o, ray_d, skip, eps_behind, eps_pos)
    out = _no_hit(R, ray_o.device)
    if live.numel():
        sub_skip = None if skip is None else type(skip)(
            *(getattr(skip, f.name)[live] for f in dataclasses.fields(skip)))
        sub = scan_reference(scene, ray_o[live], ray_d[live], sub_skip,
                             eps_behind, eps_pos)
        for full, part in zip(out, sub):
            full[live] = part
    return out


def scan_reference(scene: SceneArrays, ray_o, ray_d, skip, eps_behind,
                   eps_pos) -> SelectOut:
    """The scan of every ray, dead or not: the triangle pass (coplanar
    branch and smooth normals on), the sphere pass and the plane pass over
    every row, each candidate committed to its table's winner and to the
    global best (strict ``t <``: the earliest row of the earliest table
    wins a tie)."""
    f32 = torch.float32
    tf, ti, sf, si, pf, pi = scene.fused_tables[:6]
    o3 = tuple(ray_o[:, k].to(f32) for k in range(3))
    d3 = tuple(ray_d[:, k].to(f32) for k in range(3))
    skip_d = None
    if skip is not None:
        pos, nrm = skip.position.to(f32), skip.normal.to(f32)
        skip_d = {"prim": skip.prim, "px": pos[:, 0], "py": pos[:, 1],
                  "pz": pos[:, 2], "nx": nrm[:, 0], "ny": nrm[:, 1],
                  "nz": nrm[:, 2], "inside": skip.inside.to(torch.int32)}
    skip_match = kb.make_skip_match(d3, skip_d, eps_pos)
    best = kb.GlobalBest(o3[0])
    winners = []

    def emit(row, ok, tt, prim, inside_i32, pos3, nrm3, extra):
        winners[-1].commit(row, ok, tt, extra)
        best.commit(ok, tt, prim, inside_i32, pos3, nrm3)

    winners.append(_TableWinner(o3[0]))
    kb.triangle_pass(tf, ti, o3, d3, eps_behind, skip_match, emit)
    winners.append(_TableWinner(o3[0]))
    kb.sphere_pass(sf, si, o3, d3, skip_match, emit)
    winners.append(_TableWinner(o3[0]))
    kb.plane_pass(pf, pi, o3, d3, eps_behind, skip_match, emit)
    tri, sph, pln = winners

    found = best.prim >= 0
    return SelectOut(
        tri_idx=tri.row, sph_idx=sph.row, sph_near=sph.near, pl_idx=pln.row,
        t=torch.where(found, best.t, 0.0), prim=best.prim,
        inside=best.inside != 0,
        position=torch.stack(best.pos, dim=1),
        normal=torch.stack(best.nrm, dim=1))


def _launch(scene: SceneArrays, ray_o, ray_d, skip, eps_behind,
            eps_pos) -> SelectOut:
    from .. import kernels

    rows = n_table_rows(scene)
    if rows > SELECT_MAX_PRIMS:
        raise ValueError(
            f"scene has {rows} table rows, more than SELECT_MAX_PRIMS "
            f"({SELECT_MAX_PRIMS}): the select kernel keeps every row in "
            "shared memory and cannot take it")
    dev = ray_o.device
    R = ray_o.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("ray_o", ray_o, (R, 3), f32, dev)
    _check("ray_d", ray_d, (R, 3), f32, dev)
    if skip is None:
        skip_ptrs = [None] * 4
    else:
        _check("skip.prim", skip.prim, (R,), i32, dev)
        _check("skip.position", skip.position, (R, 3), f32, dev)
        _check("skip.normal", skip.normal, (R, 3), f32, dev)
        _check("skip.inside", skip.inside, (R,), torch.bool, dev)
        skip_ptrs = [t.data_ptr() for t in (skip.prim, skip.position,
                                            skip.normal, skip.inside)]
    tables = scene.select_tables
    for name, t, width in zip(("tri", "cold", "sph", "pln"), tables,
                              (SEL_TRI_F, SEL_COLD_F, SEL_SPH_F, SEL_PL_F)):
        _check(name, t, (t.shape[0], width), f32, dev)
    tri, _, sph, pln = tables

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = SelectOut(
        tri_idx=empty((R,), i32), sph_idx=empty((R,), i32),
        sph_near=empty((R,), torch.bool), pl_idx=empty((R,), i32),
        t=empty((R,), f32), prim=empty((R,), i32),
        inside=empty((R,), torch.bool), position=empty((R, 3), f32),
        normal=empty((R, 3), f32))
    work = empty((R + 2,), i32)
    keys = empty((R, 3), torch.int64)
    err = kernels.load().rtc_select(
        ray_o.data_ptr(), ray_d.data_ptr(), *skip_ptrs,
        *(t.data_ptr() for t in tables), *(t.data_ptr() for t in out),
        work.data_ptr(), keys.data_ptr(), R, tri.shape[0], sph.shape[0],
        pln.shape[0],
        eps_behind, eps_pos * eps_pos, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"select kernel launch failed: CUDA error {err}")
    kernels.count_launch(closest_hit_fused)
    return out


def _invoke(scene, ray_o, ray_d, skip, eps_behind, eps_pos) -> SelectOut:
    if ray_o.device.type == "cuda":
        return _launch(scene, ray_o, ray_d, skip, eps_behind, eps_pos)
    if ray_o.device.type == "cpu":
        return select_reference(scene, ray_o, ray_d, skip, eps_behind,
                                eps_pos)
    raise ValueError(f"select kernel: unsupported device {ray_o.device}")


def _selection(out: SelectOut):
    return ((torch.clamp(out.tri_idx, min=0), out.tri_idx >= 0),
            (torch.clamp(out.sph_idx, min=0), out.sph_near,
             out.sph_idx >= 0),
            (torch.clamp(out.pl_idx, min=0), out.pl_idx >= 0))


def _record(out: SelectOut, dtype) -> HitRecord:
    return HitRecord(prim=out.prim, t=out.t.to(dtype),
                     position=out.position.to(dtype),
                     normal=out.normal.to(dtype), inside=out.inside)


def select_all(scene: SceneArrays, ray_o, ray_d, skip, eps_behind, eps_pos):
    """Selection-phase outputs for the differentiable dispatch path:
    ``((tri_idx, tri_any), (sph_idx, use_near, sph_any), (pl_idx,
    pl_any))``.  Launches the kernel on CUDA tensors (or raises), runs the
    plain version on CPU tensors."""
    return _selection(_invoke(scene, ray_o, ray_d, skip, eps_behind,
                              eps_pos))


def select_all_reference(scene: SceneArrays, ray_o, ray_d, skip, eps_behind,
                         eps_pos):
    """:func:`select_all` from the plain version, on any device."""
    return _selection(select_reference(scene, ray_o, ray_d, skip,
                                       eps_behind, eps_pos))


def closest_hit_fused(scene: SceneArrays, ray_o, ray_d,
                      skip: HitRecord | None) -> HitRecord:
    """Full :class:`.dispatch.HitRecord` straight from the kernel (the
    forward / rendering / recording path; not differentiable — use
    :func:`.dispatch.closest_hit` for gradients).  Launches the kernel on
    CUDA tensors (or raises), runs the plain version on CPU tensors.

    A dead lane (origin ``config.PARKED_ORIGIN``) gets the no-hit record
    without a scan.  ``render.integrator.trace`` reads nothing from a dead
    lane's record but its tape row, and the replay never reads that row.
    The wrapper never synchronises with the host: the live lanes' count
    stays on the device."""
    dtype = ray_o.dtype
    f32 = torch.float32
    if skip is not None:
        skip = HitRecord(prim=skip.prim, t=skip.t,
                         position=skip.position.detach().to(f32).contiguous(),
                         normal=skip.normal.detach().to(f32).contiguous(),
                         inside=skip.inside)
    out = _invoke(scene, ray_o.detach().to(f32).contiguous(),
                  ray_d.detach().to(f32).contiguous(), skip,
                  vm.near_enough(f32), _position_eps(f32))
    return _record(out, dtype)


def closest_hit_fused_reference(scene: SceneArrays, ray_o, ray_d,
                                skip: HitRecord | None) -> HitRecord:
    """:func:`closest_hit_fused` from the plain version, on any device."""
    f32 = torch.float32
    out = select_reference(scene, ray_o.detach(), ray_d.detach(), skip,
                           vm.near_enough(f32), _position_eps(f32))
    return _record(out, ray_o.dtype)


# Launches of the select kernel, by either entry point (set it to 0 before
# a run to see that the run went through the kernel).
closest_hit_fused.launches = 0
