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
independent grid oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SELECT_MAX_PRIMS
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


def select_reference(scene: SceneArrays, ray_o, ray_d, skip, eps_behind,
                     eps_pos) -> SelectOut:
    """Plain torch version of the select kernel (any device), f32: the
    triangle pass (coplanar branch and smooth normals on), the sphere pass
    and the plane pass over every row, each candidate committed to its
    table's winner and to the global best (strict ``t <``: the earliest
    row of the earliest table wins a tie)."""
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


def _launch(scene: SceneArrays, ray_o, ray_d, skip, eps_behind, eps_pos
            ) -> SelectOut:
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
    tables = scene.fused_tables[:6]
    for name, t, width, dtype in zip(
            ("tf", "ti", "sf", "si", "pf", "pi"), tables,
            (kb.TRI_F, kb.INT_F, kb.SPH_F, kb.INT_F, kb.PL_F, kb.INT_F),
            (f32, i32, f32, i32, f32, i32)):
        _check(name, t, (t.shape[0], width), dtype, dev)
    tf, _, sf, _, pf, _ = tables

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = SelectOut(
        tri_idx=empty((R,), i32), sph_idx=empty((R,), i32),
        sph_near=empty((R,), torch.bool), pl_idx=empty((R,), i32),
        t=empty((R,), f32), prim=empty((R,), i32),
        inside=empty((R,), torch.bool), position=empty((R, 3), f32),
        normal=empty((R, 3), f32))
    err = kernels.load().rtc_select(
        ray_o.data_ptr(), ray_d.data_ptr(), *skip_ptrs,
        *(t.data_ptr() for t in tables), *(t.data_ptr() for t in out),
        R, tf.shape[0], sf.shape[0], pf.shape[0],
        eps_behind, eps_pos * eps_pos,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"select kernel launch failed: CUDA error {err}")
    closest_hit_fused.launches += 1
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
    CUDA tensors (or raises), runs the plain version on CPU tensors."""
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
