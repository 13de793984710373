"""The whole-path megakernel (counterpart of
``raytracercore_tpu.render.fused``).

One call renders one progressive pass: camera rays enter, final colours
leave.  Every bounce — closest hit over all primitive tables
(Scene.RayTracePrimitives, Scene.cs:65-111), material fetch, Fresnel/TIR
split, stochastic branch selection and path-state update (the whole of
``Raytracer.GetColor``, Raytracer.cs:65-246) — runs inside the kernel, with
nothing going to device memory between bounces.

* :func:`trace_fused` is the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/fused.cu`` (and counts the launch in
  ``trace_fused.launches``); on CPU tensors it runs the plain version.
* :func:`trace_fused_reference` is the plain torch version, with the JAX
  megakernel's per-bounce specializations: renormalize only when
  ``i % 3 == 0 and i > 0``, no skip record on bounce 0, emission only on the
  final bounce.

Both consume the preprocessed uniforms of
:func:`.integrator.prepare_uniforms` (``[bounces, 7, R]``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FUSED_COPLANAR_BRANCH
from ..config import FUSED_MAX_PRIMS as MAX_PRIMS
from ..core import vecmath as vm
from ..core.color import LUM_B, LUM_G, LUM_R
from ..intersect import kernel_body as kb
from ..scene.types import SceneArrays
from .integrator import BounceType as BT
from .integrator import PathTape

MAT_F = 14  # emission(3) diffuse(3) specular(3) refraction(3) ior shin
SC_F = 4    # air_ior, ambient r g b


def pack_materials(mats):
    """Materials → ``[N, 14]`` rows indexed by global prim id."""
    return torch.cat([
        mats.emission, mats.diffuse, mats.specular, mats.refraction,
        mats.refractive_index[:, None], mats.shininess[:, None],
    ], dim=1).to(torch.float32)


def pack_scene(scene: SceneArrays):
    """Everything the kernel reads of a scene, as contiguous tensors:
    ``(tf, ti, sf, si, pf, pi, mf, scf)`` — the :func:`.kernel_body.
    pack_tables` tables, the ``[N, 14]`` materials and ``scf = (air ior,
    ambient rgb)``.  Cached per scene as ``SceneArrays.fused_tables``."""
    scf = torch.cat([scene.air_refractive_index.reshape(1),
                     scene.ambient_rgb.reshape(3)]).to(torch.float32)
    return tuple(t.detach().contiguous() for t in (
        *kb.pack_tables(scene), pack_materials(scene.materials), scf))


def with_material_rows(tables, materials):
    """A :func:`pack_scene` tuple with its ``[N, 14]`` material rows packed
    again from ``materials``; the geometry tables and ``scf`` carry over."""
    *geometry, _, scf = tables
    return (*geometry, pack_materials(materials).detach().contiguous(), scf)


def fits(scene: SceneArrays) -> bool:
    """True when the megakernel can trace ``scene``: at most
    ``config.FUSED_MAX_PRIMS`` table rows and no ``debug geom``."""
    n_rows = (scene.triangles.v0.shape[0] + scene.spheres.radius.shape[0]
              + scene.planes.origin_dist.shape[0])
    return n_rows <= MAX_PRIMS and not scene.debug_geom


def _lum(c):
    return LUM_R * c[0] + LUM_G * c[1] + LUM_B * c[2]


def trace_fused_reference(scene: SceneArrays, ray_o, ray_d, uniforms,
                          want_tape: bool = False):
    """Plain torch version of the megakernel (any device).

    Args:
      scene: frozen scene on the rays' device.
      ray_o, ray_d: [R, 3] camera rays.
      uniforms: [recursion + 1, 7, R] preprocessed uniforms.
      want_tape: also return the :class:`.integrator.PathTape`.

    Returns: (color [R, 3], miss [R] bool[, PathTape]).
    """
    R = ray_o.shape[0]
    n_bounces = scene.recursion + 1
    dev = ray_o.device
    tf, ti, sf, si, pf, pi = kb.pack_tables(scene)
    mf = pack_materials(scene.materials)
    if mf.shape[0] == 0:  # no primitives: nothing is ever hit
        mf = torch.zeros((1, MAT_F), device=dev)
    air = scene.air_refractive_index.to(torch.float32)
    amb = tuple(scene.ambient_rgb.to(torch.float32))
    eps_behind = vm.near_enough(torch.float32)
    eps_pos = vm.POSITION_EPS_F32

    zero = torch.zeros(R, dtype=torch.float32, device=dev)
    one = torch.ones_like(zero)
    o = tuple(ray_o[:, k].to(torch.float32) for k in range(3))
    d = tuple(ray_d[:, k].to(torch.float32) for k in range(3))
    tint = (one, one, one)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    result = (zero, zero, zero)
    miss = torch.zeros(R, dtype=torch.bool, device=dev)
    pv_prim = torch.full((R,), -1, dtype=torch.int32, device=dev)
    pv_pos = (zero, zero, zero)
    pv_nrm = (zero, zero, one)
    pv_in = torch.zeros(R, dtype=torch.int32, device=dev)
    tape = [[] for _ in range(5)]

    def record(active, prim, flags, nrm):
        tape[0].append(torch.where(active, prim, -1).to(torch.int32))
        tape[1].append(torch.where(active, flags, 0).to(torch.int32))
        for k in range(3):
            tape[2 + k].append(torch.where(active, nrm[k], zero))

    for i in range(n_bounces):
        # Periodic renormalization (Raytracer.cs:74-75).
        if i % 3 == 0 and i > 0:
            d = vm.scale3(d, 1.0 / torch.sqrt(vm.dot3(d, d)))

        # --- closest hit across all tables ------------------------------
        skip = None if i == 0 else {
            "prim": pv_prim, "px": pv_pos[0], "py": pv_pos[1],
            "pz": pv_pos[2], "nx": pv_nrm[0], "ny": pv_nrm[1],
            "nz": pv_nrm[2], "inside": pv_in}
        skip_match = kb.make_skip_match(d, skip, eps_pos)
        best = kb.GlobalBest(zero)

        def emit(row, ok, tt, prim, inside_i32, pos3, nrm3, extra):
            best.commit(ok, tt, prim, inside_i32, pos3, nrm3)

        kb.triangle_pass(tf, ti, o, d, eps_behind, skip_match, emit,
                         coplanar=FUSED_COPLANAR_BRANCH,
                         any_smooth=scene.any_smooth)
        kb.sphere_pass(sf, si, o, d, skip_match, emit)
        kb.plane_pass(pf, pi, o, d, eps_behind, skip_match, emit)

        found = best.prim >= 0
        hit_pos, hit_nrm = best.pos, best.nrm
        inside = best.inside != 0
        active = alive
        was_missed = alive & ~found

        # --- miss handling (Raytracer.cs:81-91) ---------------------------
        if i == 0 or scene.ambient_is_miss:
            miss = miss | was_missed
        else:
            result = vm.where3(was_missed, amb, result)
        alive = alive & found

        # --- material fetch (rows are global prim ids) --------------------
        mat = mf[torch.clamp(best.prim, min=0).long()]  # [R, 14]
        emis = (mat[:, 0], mat[:, 1], mat[:, 2])
        te = (tint[0] * emis[0], tint[1] * emis[1], tint[2] * emis[2])
        in_bit = torch.where(inside, PathTape.FLAG_INSIDE, 0)

        # --- recursion complete (Raytracer.cs:100-104) --------------------
        if i >= scene.recursion:
            result = vm.where3(alive, te, result)
            if want_tape:
                code = torch.where(
                    was_missed, BT.MISSED,
                    torch.where(alive, BT.RECURSION_COMPLETE, BT.SKIPPED))
                record(active, best.prim, code | in_bit, hit_nrm)
            break

        diff = (mat[:, 3], mat[:, 4], mat[:, 5])
        spec = (mat[:, 6], mat[:, 7], mat[:, 8])
        refr = (mat[:, 9], mat[:, 10], mat[:, 11])
        ior, shin = mat[:, 12], mat[:, 13]
        l_e, l_d, l_s, l_r = _lum(emis), _lum(diff), _lum(spec), _lum(refr)
        u = uniforms[i].to(torch.float32)

        # --- shading ------------------------------------------------------
        # RandomShine (Raytracer.cs:51-56): z = exp(ln U / shininess).
        z_shine = torch.where(torch.isinf(shin), one, torch.exp(u[0] / shin))
        rough_n = vm.create_horizon3_cs(hit_nrm, z_shine, u[1], u[2])
        cos = -vm.dot3(rough_n, d)

        # Fresnel split (Raytracer.cs:120-157).
        can_refract = ((l_r > 0) | (l_s > 0)) & (ior != 0) & (cos >= 0)
        ior_in = torch.where(inside, ior, air)
        ior_out = torch.where(inside, air, ior)
        safe_out = torch.where(ior_out == 0, one, ior_out)
        ior_ratio = ior_in / safe_out
        sin_out = ior_ratio * vm.safe_sqrt(1.0 - cos * cos)
        tir = sin_out >= 1.0
        cos_out = vm.safe_sqrt(1.0 - sin_out * sin_out)
        f_live = can_refract & ~tir
        cos_f = torch.where(f_live, cos, one)
        cos_out_f = torch.where(f_live, cos_out, one)
        rs = ((ior_out * cos_f) - (ior_in * cos_out_f)) / \
            ((ior_out * cos_f) + (ior_in * cos_out_f))
        rp = ((ior_in * cos_f) - (ior_out * cos_out_f)) / \
            ((ior_in * cos_f) + (ior_out * cos_out_f))
        fresnel = (rs * rs + rp * rp) / 2.0

        spec_lum = torch.where(f_live, l_s * fresnel, l_s)
        refr_lum = torch.where(f_live, l_r * (1.0 - fresnel), zero)
        total_lum = l_d + spec_lum + refr_lum + l_e

        # Pure black termination (Raytracer.cs:165-169).
        black = alive & (total_lum <= 0)
        result = vm.where3(black, te, result)
        alive = alive & ~black

        # --- stochastic branch selection (Raytracer.cs:177-229) ----------
        ray_rand = u[3] * total_lum
        pick_refr = (refr_lum != 0) & (ray_rand - refr_lum <= 0)
        r2 = ray_rand - refr_lum
        pick_spec = ~pick_refr & (spec_lum != 0) & (r2 - spec_lum <= 0)
        r3 = r2 - spec_lum
        pick_diff = ~pick_refr & ~pick_spec & (l_d != 0) & (r3 - l_d <= 0)
        pick_emit = ~pick_refr & ~pick_spec & ~pick_diff

        # Transmission (Raytracer.cs:181-193).
        refr_dir = tuple(rough_n[k] * (-cos_out) + (d[k] + rough_n[k] * cos)
                         * ior_ratio for k in range(3))
        refr_tint = vm.where3(inside, (one, one, one), refr)

        # Specular with rough-normal fail (Raytracer.cs:194-209).
        spec_dir = vm.reflect3(rough_n, d, cos)
        spec_ok = vm.dot3(spec_dir, hit_nrm) > 0

        # Diffuse (Raytracer.cs:210-219) around the TRUE normal.
        diff_dir = vm.create_horizon3_cs(hit_nrm, u[4], u[5], u[6])

        # Terminal branches: emission pick, or failed specular.
        terminal = alive & (pick_emit | (pick_spec & ~spec_ok))
        result = vm.where3(terminal, te, result)
        alive = alive & ~terminal

        out_dir = vm.where3(pick_refr, refr_dir,
                            vm.where3(pick_spec, spec_dir, diff_dir))
        new_tint = vm.where3(pick_refr, refr_tint,
                             vm.where3(pick_spec, spec, diff))
        # Energy compensation (Raytracer.cs:238-240).
        new_tint = vm.scale3(new_tint, torch.clamp(total_lum, min=1.0))

        bounced = alive
        if want_tape:
            code = torch.where(was_missed, BT.MISSED, BT.SKIPPED)
            code = torch.where(black, BT.PURE_BLACK, code)
            code = torch.where(terminal & pick_emit, BT.EMISSION, code)
            code = torch.where(terminal & pick_spec & ~spec_ok,
                               BT.SPECULAR_FAIL, code)
            code = torch.where(bounced & pick_refr, BT.TRANSMITTED, code)
            code = torch.where(bounced & pick_spec, BT.SPECULAR, code)
            code = torch.where(bounced & pick_diff, BT.DIFFUSE, code)
            # FLIVE is left out on misses: no material was hit there.
            flive = torch.where(f_live & found, PathTape.FLAG_FLIVE, 0)
            record(active, best.prim, code | in_bit | flive, hit_nrm)

        o = vm.where3(bounced, hit_pos, o)
        d = vm.where3(bounced, out_dir, d)
        tint = vm.where3(bounced, (tint[0] * new_tint[0],
                                   tint[1] * new_tint[1],
                                   tint[2] * new_tint[2]), tint)
        pv_prim = torch.where(bounced, best.prim, pv_prim)
        pv_pos = vm.where3(bounced, hit_pos, pv_pos)
        pv_nrm = vm.where3(bounced, hit_nrm, pv_nrm)
        pv_in = torch.where(bounced, best.inside, pv_in)

    color = torch.stack(result, dim=1)
    if not want_tape:
        return color, miss
    return color, miss, PathTape(*(torch.stack(planes) for planes in tape))


def classify_mismatches(ref, got, atol=1e-3, rtol=1e-3):
    """Compare two traces of the same rays and uniforms, and sort the rays
    whose colours differ by why (the ``kernel_equivalence`` classification
    of the JAX package's ``bench.py``).

    ``ref`` and ``got`` are ``(color [R,3], miss [R], PathTape)`` from any
    two tracers.  A ray is *close* when every channel is within
    ``atol + rtol·|ref|``.  Paths are compared bounce by bounce while the
    reference path is live: the code everywhere, and on bounced codes also
    the prim and the inside/FLIVE bits.  Each mismatched ray is then

    * ``flip``     — a discrete pick differs (a knife-edge f32 branch or
      prim flip, expected between any two f32 implementations);
    * ``graze``    — same picks, but hit normals differ by > 1e-2 (a grazing
      hit landing elsewhere on the same primitive);
    * ``samepick`` — same picks and normals yet a different colour: an
      arithmetic fault in one of the two.

    Returns a dict of boolean ``[R]`` numpy masks ``close``, ``miss_eq``,
    ``flip``, ``graze``, ``samepick`` and the max abs colour error over
    rays whose paths agree (``max_abs_err_same_path``).
    """
    def host(x):
        return x.detach().cpu().numpy()

    ref_c, got_c = host(ref[0]), host(got[0])
    close = np.all(np.abs(ref_c - got_c) <= atol + rtol * np.abs(ref_c),
                   axis=1)
    miss_eq = host(ref[1]) == host(got[1])
    tr, tg = ref[2], got[2]
    flags_r, flags_g = host(tr.flags), host(tg.flags)
    codes_r = flags_r & PathTape.CODE_MASK
    codes_g = flags_g & PathTape.CODE_MASK
    prim_r, prim_g = host(tr.prim), host(tg.prim)
    nrm_r = np.stack([host(a) for a in (tr.nx, tr.ny, tr.nz)], axis=-1)
    nrm_g = np.stack([host(a) for a in (tg.nx, tg.ny, tg.nz)], axis=-1)
    bits = PathTape.FLAG_INSIDE | PathTape.FLAG_FLIVE
    bounced_codes = [BT.DIFFUSE, BT.SPECULAR, BT.TRANSMITTED]
    R = ref_c.shape[0]
    live = np.ones(R, bool)     # the reference path is still live
    path_eq = np.ones(R, bool)
    nrm_eq = np.ones(R, bool)
    for i in range(codes_r.shape[0]):
        cr, cg = codes_r[i], codes_g[i]
        is_b = np.isin(cr, bounced_codes)
        same = (cr == cg) & (~is_b | ((prim_r[i] == prim_g[i])
                                      & ((flags_r[i] & bits)
                                         == (flags_g[i] & bits))))
        n_close = np.abs(nrm_r[i] - nrm_g[i]).max(axis=-1) <= 1e-2
        path_eq &= ~live | same
        nrm_eq &= ~(live & is_b & same) | n_close
        live &= is_b & same  # a diverged path stops constraining later
    mismatch = ~close | ~miss_eq
    same_path = path_eq & nrm_eq
    err = np.abs(ref_c - got_c).max(axis=1)
    return {
        "close": close,
        "miss_eq": miss_eq,
        "flip": mismatch & ~path_eq,
        "graze": mismatch & path_eq & ~nrm_eq,
        "samepick": mismatch & same_path,
        "max_abs_err_same_path": float(err[same_path].max(initial=0.0)),
    }


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(scene: SceneArrays, ray_o, ray_d, uniforms, want_tape):
    from .. import kernels

    if not fits(scene):
        raise ValueError(
            f"scene has more than {MAX_PRIMS} table rows or debug geom: the "
            "megakernel cannot trace it")
    dev = ray_o.device
    R = ray_o.shape[0]
    n_bounces = scene.recursion + 1
    f32, i32 = torch.float32, torch.int32
    _check("ray_o", ray_o, (R, 3), f32, dev)
    _check("ray_d", ray_d, (R, 3), f32, dev)
    _check("uniforms", uniforms, (n_bounces, 7, R), f32, dev)

    tables = scene.fused_tables
    for name, t, width, dtype in zip(
            ("tf", "ti", "sf", "si", "pf", "pi", "mf"), tables,
            (kb.TRI_F, kb.INT_F, kb.SPH_F, kb.INT_F, kb.PL_F, kb.INT_F,
             MAT_F), (f32, i32, f32, i32, f32, i32, f32)):
        _check(name, t, (t.shape[0], width), dtype, dev)
    tf, ti, sf, si, pf, pi, mf, scf = tables
    _check("scf", scf, (SC_F,), f32, dev)

    color = torch.empty((R, 3), dtype=f32, device=dev)
    miss = torch.empty((R,), dtype=i32, device=dev)
    if want_tape:
        tape = PathTape(
            prim=torch.empty((n_bounces, R), dtype=i32, device=dev),
            flags=torch.empty((n_bounces, R), dtype=i32, device=dev),
            nx=torch.empty((n_bounces, R), dtype=f32, device=dev),
            ny=torch.empty((n_bounces, R), dtype=f32, device=dev),
            nz=torch.empty((n_bounces, R), dtype=f32, device=dev))
        tape_ptrs = [t.data_ptr() for t in
                     (tape.prim, tape.flags, tape.nx, tape.ny, tape.nz)]
    else:
        tape = None
        tape_ptrs = [None] * 5

    eps_pos = vm.POSITION_EPS_F32
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.load().rtc_trace_fused(
        ray_o.data_ptr(), ray_d.data_ptr(), uniforms.data_ptr(),
        tf.data_ptr(), ti.data_ptr(), sf.data_ptr(), si.data_ptr(),
        pf.data_ptr(), pi.data_ptr(), mf.data_ptr(), scf.data_ptr(),
        color.data_ptr(), miss.data_ptr(), *tape_ptrs,
        R, tf.shape[0], sf.shape[0], pf.shape[0], mf.shape[0],
        n_bounces, scene.recursion,
        vm.near_enough(f32), eps_pos * eps_pos,
        int(scene.ambient_is_miss), int(want_tape), int(scene.any_smooth),
        int(FUSED_COPLANAR_BRANCH), stream)
    if err != 0:
        raise RuntimeError(f"trace_fused kernel launch failed: CUDA error "
                           f"{err}")
    trace_fused.launches += 1
    if want_tape:
        return color, miss != 0, tape
    return color, miss != 0


def trace_fused(scene: SceneArrays, ray_o, ray_d, uniforms,
                want_tape: bool = False):
    """Trace camera rays through every bounce: (color [R, 3], miss [R]
    bool[, PathTape]).

    On CUDA tensors this launches the hand-written megakernel
    (``csrc/fused.cu``) and raises if it cannot; it never falls back.  On
    CPU tensors it runs :func:`trace_fused_reference`.
    """
    if ray_o.device.type == "cuda":
        return _launch(scene, ray_o, ray_d, uniforms, want_tape)
    if ray_o.device.type == "cpu":
        return trace_fused_reference(scene, ray_o, ray_d, uniforms,
                                     want_tape)
    raise ValueError(f"trace_fused: unsupported device {ray_o.device}")


# Kernel launches made by trace_fused (reset it to 0 before a run to see
# that the run went through the kernel).
trace_fused.launches = 0
