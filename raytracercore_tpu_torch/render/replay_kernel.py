"""The replay kernels: a recorded path's shading, forward and backward
(counterpart of ``raytracercore_tpu.render.replay_kernel``).

Given the :class:`.integrator.PathTape` of a recording pass (per bounce:
winning primitive, branch code, inside/Fresnel-live bits, hit normal), the
uniforms and the ``[N, 14]`` material table, a path's colour is a closed-form
function of the material table (Raytracer.cs:65-246 with every decision
pinned by the tape).  This module holds that function one bounce at a time:

* :func:`_bounce_fwd` — one bounce's shading, the JAX kernel's
  ``_bounce_fwd`` (its semantics are those of the JAX ``replay`` body:
  renormalize at ``i % 3 == 0`` including bounce 0);
* :func:`_bounce_bwd` — its adjoint, written out by hand (the TPU kernel
  traced ``jax.vjp`` into the kernel; CUDA has no autodiff).  The tests
  hold it against torch autograd of :func:`_bounce_fwd` in float64, and
  ``csrc/replay.cu`` transcribes it line for line.

and the two kernels built from them, each with its plain version:

* :func:`replay_fwd` — colour and miss of every path
  (``csrc/replay.cu`` ``replay_fwd_kernel``; plain
  :func:`replay_fwd_reference`);
* :func:`replay_bwd` — dL/d(material table) for a colour cotangent: a
  forward sweep that keeps each bounce's entry (direction, tint), a reverse
  sweep through the adjoint, and the sum into the ``[N, 14]`` gradient
  (``replay_bwd_kernel``; plain :func:`replay_bwd_reference`).

:func:`replay_fused` ties them into one ``torch.autograd.Function``; with
``primal=`` it passes the recorder's own colour through instead of running
the forward kernel (record-as-primal).  Only the material table gets a
gradient: directions, air IOR and ambient get none, as in the JAX
``_bwd_core``.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.color import LUM_B, LUM_G, LUM_R
from .fused import _check
from .integrator import BounceType as BT
from .integrator import PathTape, _material_matrix

C = 14                   # material channels (integrator._material_matrix)
MAX_KERNEL_MATS = 64     # material rows the kernels keep in shared memory
MAX_KERNEL_BOUNCES = 32  # bounces the backward kernel stashes per thread
REPLAY_BLOCK = 128       # threads per block (csrc/replay.cu REPLAY_BLOCK)
_LUM = (LUM_R, LUM_G, LUM_B)
_TERMINAL = (BT.EMISSION, BT.SPECULAR_FAIL, BT.PURE_BLACK,
             BT.RECURSION_COMPLETE)
_SQRT_FLOOR = 1e-20      # vecmath.safe_sqrt's floor


def _lum(c):
    return LUM_R * c[0] + LUM_G * c[1] + LUM_B * c[2]


def _decode(flags):
    code = flags & PathTape.CODE_MASK
    inside = (flags & PathTape.FLAG_INSIDE) != 0
    f_live = (flags & PathTape.FLAG_FLIVE) != 0
    return code, inside, f_live


def _shine_den(shin):
    """Denominator of ``ln U / shininess`` with shininess 0 replaced by 1:
    the shininess-0 branch takes its value (0, the limit of
    ``exp(ln U / s)`` for ``ln U < 0``) from a ``where``, and this keeps
    its derivative 0 instead of ``0 · inf``."""
    return torch.where(shin == 0, torch.ones_like(shin), shin)


def _z_shine(u0, shin):
    """RandomShine's cone height (Raytracer.cs:51-56): exp(ln U /
    shininess); 1 for infinite shininess, 0 for shininess 0."""
    ez = torch.exp(u0 / _shine_den(shin))
    return torch.where(torch.isinf(shin), 1.0,
                       torch.where(shin == 0, 0.0, ez))


def _bounce_fwd(i, d, tint, result, g, u, flags, normal, air, ambient,
                ambient_is_miss):
    """One replay bounce over ``[R]`` planes.

    ``d``, ``tint``, ``result``, ``normal``: 3-tuples of ``[R]``; ``g``: the
    14 gathered material planes; ``u``: the bounce's ``[7, R]`` uniforms;
    ``flags``: ``[R]`` tape flags; ``air``, ``ambient``: scalars.
    Returns ``(d', tint', result', is_miss)``."""
    if i % 3 == 0:
        len_d = torch.sqrt(vm.dot3(d, d))
        d = (d[0] / len_d, d[1] / len_d, d[2] / len_d)

    code, inside, f_live = _decode(flags)
    emission, diffuse, specular, refraction = g[0:3], g[3:6], g[6:9], g[9:12]
    ior, shin = g[12], g[13]

    z_shine = _z_shine(u[0], shin)
    rough_n = vm.create_horizon3_cs(normal, z_shine, u[1], u[2])
    cos = -vm.dot3(rough_n, d)

    diff_lum = _lum(diffuse)
    spec_lum = _lum(specular)
    refr_lum = _lum(refraction)
    emis_lum = _lum(emission)

    ior_in = torch.where(inside, ior, air)
    ior_out = torch.where(inside, air, ior)
    safe_out = torch.where(ior_out == 0, 1.0, ior_out)
    ior_ratio = ior_in / safe_out
    sin_out = ior_ratio * vm.safe_sqrt(1.0 - cos * cos)
    cos_out = vm.safe_sqrt(1.0 - sin_out * sin_out)
    cos_f = torch.where(f_live, cos, 1.0)
    cos_out_f = torch.where(f_live, cos_out, 1.0)
    rs = ((ior_out * cos_f) - (ior_in * cos_out_f)) / \
        ((ior_out * cos_f) + (ior_in * cos_out_f))
    rp = ((ior_in * cos_f) - (ior_out * cos_out_f)) / \
        ((ior_in * cos_f) + (ior_out * cos_out_f))
    fresnel = (rs * rs + rp * rp) / 2.0

    spec_lum = torch.where(f_live, spec_lum * fresnel, spec_lum)
    refr_lum = torch.where(f_live, refr_lum * (1.0 - fresnel), 0.0)
    total_lum = diff_lum + spec_lum + refr_lum + emis_lum

    te = (tint[0] * emission[0], tint[1] * emission[1],
          tint[2] * emission[2])
    terminal = torch.isin(code, torch.tensor(_TERMINAL, device=code.device))
    result = vm.where3(terminal, te, result)

    is_miss = code == BT.MISSED
    if not ambient_is_miss and i != 0:
        result = vm.where3(is_miss, ambient, result)

    pick_refr = code == BT.TRANSMITTED
    pick_spec = code == BT.SPECULAR
    pick_diff = code == BT.DIFFUSE
    bounced = pick_refr | pick_spec | pick_diff

    refr_dir = tuple(
        rough_n[k] * (-cos_out) + (d[k] + rough_n[k] * cos) * ior_ratio
        for k in range(3))
    one = torch.ones_like(cos)
    refr_tint = vm.where3(inside, (one, one, one), refraction)
    spec_dir = vm.reflect3(rough_n, d, cos)
    diff_dir = vm.create_horizon3_cs(normal, u[4], u[5], u[6])

    out_dir = vm.where3(pick_refr, refr_dir,
                        vm.where3(pick_spec, spec_dir, diff_dir))
    new_tint = vm.where3(pick_refr, refr_tint,
                         vm.where3(pick_spec, specular, diffuse))
    # Energy compensation (Raytracer.cs:238-240); ``maximum`` splits the
    # derivative at a tie as JAX does.
    comp = torch.maximum(total_lum, torch.ones_like(total_lum))
    new_tint = vm.scale3(new_tint, comp)

    d = vm.where3(bounced, out_dir, d)
    tint = vm.where3(bounced,
                     (tint[0] * new_tint[0], tint[1] * new_tint[1],
                      tint[2] * new_tint[2]), tint)
    return d, tint, result, is_miss


def _safe_sqrt_bwd(x, y, y_ct):
    """Cotangent of ``x`` for ``y = safe_sqrt(x)``: 0 below the floor,
    half at it (``maximum``'s tie rule)."""
    gate = torch.where(x > _SQRT_FLOOR, 1.0,
                       torch.where(x == _SQRT_FLOOR, 0.5, 0.0))
    return y_ct * (0.5 / y) * gate


def _bounce_bwd(i, d_in, tint, g, u, flags, normal, air, ambient_is_miss,
                d_ct, t_ct, r_ct):
    """Adjoint of :func:`_bounce_fwd` at ``(d_in, tint, g)``.

    Takes the cotangents of ``(d', tint', result')`` and returns those of
    ``(d_in, tint, result)`` and the 14 material planes ``g``.  Every line
    below undoes one line of the forward, last line first."""
    zero = torch.zeros_like(d_in[0])
    # --- the forward, keeping what the adjoint reads ----------------------
    if i % 3 == 0:
        len_d = torch.sqrt(vm.dot3(d_in, d_in))
        d = tuple(c / len_d for c in d_in)
    else:
        d = d_in
    code, inside, f_live = _decode(flags)
    E, D, S, T = g[0:3], g[3:6], g[6:9], g[9:12]
    ior, shin = g[12], g[13]

    shin_special = torch.isinf(shin) | (shin == 0)
    den = _shine_den(shin)
    q = u[0] / den
    ez = torch.exp(q)
    z = _z_shine(u[0], shin)
    horiz = vm.create_horizontal3(normal)
    m1 = 1.0 - z * z
    s = vm.safe_sqrt(m1)
    base = tuple(normal[k] * z + horiz[k] * s for k in range(3))
    ct, st = u[1], u[2]
    rough = vm.rotate_about_axis3_cs(base, normal, ct, st)
    cos = -vm.dot3(rough, d)

    l_s0, l_r0 = _lum(S), _lum(T)
    ior_in = torch.where(inside, ior, air)
    ior_out = torch.where(inside, air, ior)
    safe_out = torch.where(ior_out == 0, 1.0, ior_out)
    ratio = ior_in / safe_out
    m2 = 1.0 - cos * cos
    sq1 = vm.safe_sqrt(m2)
    sin_out = ratio * sq1
    m3 = 1.0 - sin_out * sin_out
    cos_out = vm.safe_sqrt(m3)
    cos_f = torch.where(f_live, cos, 1.0)
    cos_out_f = torch.where(f_live, cos_out, 1.0)
    b_s = (ior_out * cos_f) + (ior_in * cos_out_f)
    rs = ((ior_out * cos_f) - (ior_in * cos_out_f)) / b_s
    b_p = (ior_in * cos_f) + (ior_out * cos_out_f)
    rp = ((ior_in * cos_f) - (ior_out * cos_out_f)) / b_p
    fres = (rs * rs + rp * rp) / 2.0
    spec_lum = torch.where(f_live, l_s0 * fres, l_s0)
    refr_lum = torch.where(f_live, l_r0 * (1.0 - fres), 0.0)
    total = _lum(D) + spec_lum + refr_lum + _lum(E)

    terminal = torch.isin(code, torch.tensor(_TERMINAL, device=code.device))
    is_miss = code == BT.MISSED
    pick_refr = code == BT.TRANSMITTED
    pick_spec = (code == BT.SPECULAR) & ~pick_refr
    pick_diff = code == BT.DIFFUSE
    bounced = pick_refr | pick_spec | pick_diff
    one = torch.ones_like(cos)
    refr_tint = vm.where3(inside, (one, one, one), T)
    new_tint0 = vm.where3(pick_refr, refr_tint, vm.where3(pick_spec, S, D))
    comp = torch.maximum(total, one)
    new_tint = vm.scale3(new_tint0, comp)

    # --- reverse ----------------------------------------------------------
    E_ct, D_ct, S_ct, T_ct = ([zero] * 3 for _ in range(4))

    # d' = bounced ? out_dir : d;  tint' = bounced ? tint * new_tint : tint
    out_ct = [torch.where(bounced, c, zero) for c in d_ct]
    dn_ct = [torch.where(bounced, zero, c) for c in d_ct]
    tint_ct = [torch.where(bounced, t_ct[k] * new_tint[k], t_ct[k])
               for k in range(3)]
    nt_ct = [torch.where(bounced, t_ct[k] * tint[k], zero) for k in range(3)]

    # new_tint = new_tint0 * comp;  comp = maximum(total, 1)
    nt0_ct = [nt_ct[k] * comp for k in range(3)]
    comp_ct = vm.dot3(nt_ct, new_tint0)
    total_ct = comp_ct * torch.where(total > 1.0, 1.0,
                                     torch.where(total == 1.0, 0.5, 0.0))

    # new_tint0 = pick_refr ? (inside ? 1 : T) : pick_spec ? S : D
    take_t = pick_refr & ~inside
    take_d = ~pick_refr & ~pick_spec
    for k in range(3):
        T_ct[k] = T_ct[k] + torch.where(take_t, nt0_ct[k], zero)
        S_ct[k] = S_ct[k] + torch.where(pick_spec, nt0_ct[k], zero)
        D_ct[k] = D_ct[k] + torch.where(take_d, nt0_ct[k], zero)

    # out_dir = pick_refr ? refr_dir : pick_spec ? spec_dir : diff_dir
    # (diff_dir depends on nothing differentiable)
    refr_ct = [torch.where(pick_refr, c, zero) for c in out_ct]
    spec_ct = [torch.where(pick_spec, c, zero) for c in out_ct]

    # spec_dir = d + rough * (2 cos)
    k2 = 2.0 * cos
    rough_ct = [spec_ct[k] * k2 for k in range(3)]
    dn_ct = [dn_ct[k] + spec_ct[k] for k in range(3)]
    cos_ct = 2.0 * vm.dot3(spec_ct, rough)

    # refr_dir = rough * (-cos_out) + (d + rough * cos) * ratio
    cos_out_ct = zero
    ratio_ct = zero
    for k in range(3):
        inner_ct = refr_ct[k] * ratio
        rough_ct[k] = (rough_ct[k] + refr_ct[k] * (-cos_out)
                       + inner_ct * cos)
        cos_out_ct = cos_out_ct - refr_ct[k] * rough[k]
        ratio_ct = ratio_ct + refr_ct[k] * (d[k] + rough[k] * cos)
        dn_ct[k] = dn_ct[k] + inner_ct
        cos_ct = cos_ct + inner_ct * rough[k]

    # result' = ambient-miss ? ambient : terminal ? tint * E : result
    if not ambient_is_miss and i != 0:
        r_ct = [torch.where(is_miss, zero, c) for c in r_ct]
    te_ct = [torch.where(terminal, c, zero) for c in r_ct]
    r_ct_in = [torch.where(terminal, zero, c) for c in r_ct]
    for k in range(3):
        tint_ct[k] = tint_ct[k] + te_ct[k] * E[k]
        E_ct[k] = E_ct[k] + te_ct[k] * tint[k]

    # total = diff_lum + spec_lum + refr_lum + emis_lum
    l_r0_ct = torch.where(f_live, total_ct * (1.0 - fres), zero)
    l_s0_ct = torch.where(f_live, total_ct * fres, total_ct)
    fres_ct = torch.where(f_live, total_ct * l_s0 - total_ct * l_r0, zero)
    for k in range(3):
        D_ct[k] = D_ct[k] + total_ct * _LUM[k]
        E_ct[k] = E_ct[k] + total_ct * _LUM[k]
        S_ct[k] = S_ct[k] + l_s0_ct * _LUM[k]
        T_ct[k] = T_ct[k] + l_r0_ct * _LUM[k]

    # fresnel = (rs² + rp²) / 2;  rs = a_s / b_s;  rp = a_p / b_p
    rs_ct = fres_ct * rs
    rp_ct = fres_ct * rp
    a_s_ct = rs_ct / b_s
    b_s_ct = -rs_ct * rs / b_s
    a_p_ct = rp_ct / b_p
    b_p_ct = -rp_ct * rp / b_p
    # a_s, b_s = ior_out·cos_f ∓ ior_in·cos_out_f
    # a_p, b_p = ior_in·cos_f ∓ ior_out·cos_out_f
    ior_out_ct = (a_s_ct + b_s_ct) * cos_f + (b_p_ct - a_p_ct) * cos_out_f
    ior_in_ct = (b_s_ct - a_s_ct) * cos_out_f + (a_p_ct + b_p_ct) * cos_f
    cos_f_ct = (a_s_ct + b_s_ct) * ior_out + (a_p_ct + b_p_ct) * ior_in
    cos_out_f_ct = (b_s_ct - a_s_ct) * ior_in + (b_p_ct - a_p_ct) * ior_out
    cos_ct = cos_ct + torch.where(f_live, cos_f_ct, zero)
    cos_out_ct = cos_out_ct + torch.where(f_live, cos_out_f_ct, zero)

    # cos_out = safe_sqrt(1 - sin_out²);  sin_out = ratio · safe_sqrt(1 - cos²)
    sin_out_ct = -2.0 * sin_out * _safe_sqrt_bwd(m3, cos_out, cos_out_ct)
    ratio_ct = ratio_ct + sin_out_ct * sq1
    cos_ct = cos_ct - 2.0 * cos * _safe_sqrt_bwd(m2, sq1, sin_out_ct * ratio)

    # ratio = ior_in / safe_out;  safe_out = ior_out == 0 ? 1 : ior_out
    ior_in_ct = ior_in_ct + ratio_ct / safe_out
    ior_out_ct = ior_out_ct + torch.where(ior_out == 0, zero,
                                          -ratio_ct * ratio / safe_out)
    # ior_in = inside ? ior : air;  ior_out = inside ? air : ior
    ior_ct = torch.where(inside, ior_in_ct, ior_out_ct)

    # cos = -(rough · d)
    for k in range(3):
        rough_ct[k] = rough_ct[k] - cos_ct * d[k]
        dn_ct[k] = dn_ct[k] - cos_ct * rough[k]

    # rough = base·ct + (n × base)·st + n·((n · base)(1 - ct))
    cxn = vm.cross3(rough_ct, normal)
    kd_ct = vm.dot3(rough_ct, normal) * (1.0 - ct)
    base_ct = [rough_ct[k] * ct + cxn[k] * st + normal[k] * kd_ct
               for k in range(3)]
    # base = n·z + horiz·s;  s = safe_sqrt(1 - z²)
    z_ct = vm.dot3(base_ct, normal)
    z_ct = z_ct - 2.0 * z * _safe_sqrt_bwd(m1, s, vm.dot3(base_ct, horiz))
    # z = exp(u0 / shininess) unless shininess is +inf or 0
    q_ct = torch.where(shin_special, zero, z_ct * ez)
    shin_ct = -(q_ct * q) / den

    # renormalization: d = d_in / |d_in|
    if i % 3 == 0:
        dot_ct = vm.dot3(dn_ct, d_in)
        l2_ct = (-dot_ct / (len_d * len_d)) * (0.5 / len_d)
        d_in_ct = tuple(dn_ct[k] / len_d + 2.0 * d_in[k] * l2_ct
                        for k in range(3))
    else:
        d_in_ct = tuple(dn_ct)
    g_ct = (*E_ct, *D_ct, *S_ct, *T_ct, ior_ct, shin_ct)
    return d_in_ct, tuple(tint_ct), tuple(r_ct_in), g_ct


def _gather(matf, prim):
    """The 14 material planes of ``prim`` (row 0 where ``prim`` < 0).  The
    gather reads a float64 copy, so autograd sums each row's gradient over
    all rays in float64 (an f32 sum of ~10^6 terms is off by ~1e-5
    relative); the values are ``matf``'s own."""
    rows = matf.to(torch.float64)[torch.clamp(prim, min=0).long()]
    return tuple(rows[:, c].to(matf.dtype) for c in range(C))


def _scalars(scf):
    return scf[0], (scf[1], scf[2], scf[3])


def _bounce_inputs(tape, uniforms, i):
    return (uniforms[i], tape.flags[i], (tape.nx[i], tape.ny[i], tape.nz[i]))


def replay_fwd_reference(ray_d, uniforms, tape: PathTape, matf, scf,
                         ambient_is_miss: bool):
    """Plain torch replay of every path: ``(color [R, 3], miss [R])``.

    ``ray_d`` [R, 3]; ``uniforms`` [B, 7, R]; ``matf`` [N, 14] (from
    :func:`.integrator._material_matrix`); ``scf`` = (air IOR, ambient
    rgb).  Differentiable with torch autograd in any float dtype."""
    B = tape.prim.shape[0]
    air, ambient = _scalars(scf)
    d = tuple(ray_d[:, k] for k in range(3))
    one = torch.ones_like(d[0])
    zero = torch.zeros_like(d[0])
    tint, result = (one, one, one), (zero, zero, zero)
    miss = torch.zeros(d[0].shape, dtype=torch.bool, device=d[0].device)
    for i in range(B):
        u, flags, normal = _bounce_inputs(tape, uniforms, i)
        d, tint, result, is_miss = _bounce_fwd(
            i, d, tint, result, _gather(matf, tape.prim[i]), u, flags,
            normal, air, ambient, ambient_is_miss)
        if ambient_is_miss or i == 0:
            miss = miss | is_miss
    return torch.stack(result, dim=1), miss


def replay_bwd_reference(ray_d, uniforms, tape: PathTape, matf, scf,
                         ambient_is_miss: bool, color_ct):
    """Plain torch version of the backward kernel: dL/d``matf`` ``[N, 14]``
    for the colour cotangent ``color_ct`` [R, 3], by the hand-written
    adjoint (no autograd): a forward sweep keeping each bounce's entry
    (direction, tint), then :func:`_bounce_bwd` from the last bounce to the
    first, each bounce's material cotangent added into its row (in
    float64).  Bounces a path never reached (code Skipped) add nothing."""
    B = tape.prim.shape[0]
    air, ambient = _scalars(scf)
    d = tuple(ray_d[:, k] for k in range(3))
    one = torch.ones_like(d[0])
    zero = torch.zeros_like(d[0])
    tint, result = (one, one, one), (zero, zero, zero)
    stash = []
    for i in range(B):
        stash.append((d, tint))
        u, flags, normal = _bounce_inputs(tape, uniforms, i)
        d, tint, result, _ = _bounce_fwd(
            i, d, tint, result, _gather(matf, tape.prim[i]), u, flags,
            normal, air, ambient, ambient_is_miss)

    d_ct = t_ct = (zero, zero, zero)
    r_ct = tuple(color_ct[:, k] for k in range(3))
    mat_ct = torch.zeros(matf.shape, dtype=torch.float64, device=matf.device)
    for i in reversed(range(B)):
        u, flags, normal = _bounce_inputs(tape, uniforms, i)
        d_i, tint_i = stash[i]
        d_ct, t_ct, r_ct, g_ct = _bounce_bwd(
            i, d_i, tint_i, _gather(matf, tape.prim[i]), u, flags, normal,
            air, ambient_is_miss, d_ct, t_ct, r_ct)
        live = (flags & PathTape.CODE_MASK) != BT.SKIPPED
        g_ct = torch.where(live[:, None], torch.stack(g_ct, dim=1), 0.0)
        mat_ct.index_add_(0, torch.clamp(tape.prim[i], min=0).long(),
                          g_ct.to(torch.float64))
    return mat_ct.to(matf.dtype)


# --- the kernels ------------------------------------------------------------

def material_table(scene, dtype=torch.float32):
    """What the replay reads of a scene besides the tape: ``(matf [N, 14],
    scf [4])`` — the differentiable material matrix and (air IOR, ambient
    rgb) — in ``dtype``."""
    matf = _material_matrix(scene.materials).to(dtype)
    scf = torch.cat([scene.air_refractive_index.reshape(1),
                     scene.ambient_rgb.reshape(3)]).to(dtype)
    return matf, scf


def _kernel_args(ray_d, uniforms, tape, matf, scf):
    """Checked pointers and sizes shared by both replay kernels."""
    dev = ray_d.device
    R = ray_d.shape[0]
    B = tape.prim.shape[0]
    N = matf.shape[0]
    f32, i32 = torch.float32, torch.int32
    if not 0 < N <= MAX_KERNEL_MATS:
        raise ValueError(f"replay kernels take 1 to {MAX_KERNEL_MATS} "
                         f"material rows (got {N})")
    if B > MAX_KERNEL_BOUNCES:
        raise ValueError(f"replay kernels take at most {MAX_KERNEL_BOUNCES} "
                         f"bounces (got {B})")
    _check("ray_d", ray_d, (R, 3), f32, dev)
    _check("uniforms", uniforms, (B, 7, R), f32, dev)
    for name, dtype in (("prim", i32), ("flags", i32), ("nx", f32),
                        ("ny", f32), ("nz", f32)):
        _check(f"tape.{name}", getattr(tape, name), (B, R), dtype, dev)
    _check("matf", matf, (N, C), f32, dev)
    _check("scf", scf, (4,), f32, dev)
    ptrs = [t.data_ptr() for t in (ray_d, uniforms, tape.prim, tape.flags,
                                   tape.nx, tape.ny, tape.nz, matf, scf)]
    return ptrs, R, N, B


def replay_fwd(ray_d, uniforms, tape: PathTape, matf, scf,
               ambient_is_miss: bool):
    """Replay forward: ``(color [R, 3] f32, miss [R] bool)``.

    On CUDA tensors this launches ``csrc/replay.cu``'s forward kernel (and
    counts it in ``replay_fwd.launches``), raising if it cannot; on CPU
    tensors it runs :func:`replay_fwd_reference`."""
    if ray_d.device.type == "cpu":
        return replay_fwd_reference(ray_d, uniforms, tape, matf, scf,
                                    ambient_is_miss)
    if ray_d.device.type != "cuda":
        raise ValueError(f"replay_fwd: unsupported device {ray_d.device}")
    from .. import kernels

    ptrs, R, N, B = _kernel_args(ray_d, uniforms, tape, matf, scf)
    color = torch.empty((R, 3), dtype=torch.float32, device=ray_d.device)
    miss = torch.empty((R,), dtype=torch.int32, device=ray_d.device)
    err = kernels.load().rtc_replay_fwd(
        *ptrs, color.data_ptr(), miss.data_ptr(), R, N, B,
        int(ambient_is_miss),
        torch.cuda.current_stream(ray_d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"replay forward kernel launch failed: CUDA "
                           f"error {err}")
    replay_fwd.launches += 1
    return color, miss != 0


def replay_bwd(ray_d, uniforms, tape: PathTape, matf, scf,
               ambient_is_miss: bool, color_ct):
    """Replay backward: dL/d``matf`` ``[N, 14]`` for the colour cotangent
    ``color_ct`` [R, 3].

    On CUDA tensors this launches ``csrc/replay.cu``'s backward kernel
    (counted in ``replay_bwd.launches``), which sums each block's paths
    into a ``[N, 14]`` slice of a ``[blocks, N, 14]`` buffer that torch then
    sums; it raises if it cannot launch.  On CPU tensors it runs
    :func:`replay_bwd_reference`."""
    if ray_d.device.type == "cpu":
        return replay_bwd_reference(ray_d, uniforms, tape, matf, scf,
                                    ambient_is_miss, color_ct)
    if ray_d.device.type != "cuda":
        raise ValueError(f"replay_bwd: unsupported device {ray_d.device}")
    from .. import kernels

    ptrs, R, N, B = _kernel_args(ray_d, uniforms, tape, matf, scf)
    _check("color_ct", color_ct, (R, 3), torch.float32, ray_d.device)
    n_blocks = -(-R // REPLAY_BLOCK)
    partial = torch.empty((n_blocks, N, C), dtype=torch.float32,
                          device=ray_d.device)
    err = kernels.load().rtc_replay_bwd(
        *ptrs, color_ct.data_ptr(), partial.data_ptr(), R, N, B, n_blocks,
        int(ambient_is_miss),
        torch.cuda.current_stream(ray_d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"replay backward kernel launch failed: CUDA "
                           f"error {err}")
    replay_bwd.launches += 1
    return partial.sum(dim=0, dtype=torch.float64).to(torch.float32)


# Kernel launches made by replay_fwd and replay_bwd.
replay_fwd.launches = 0
replay_bwd.launches = 0


class _ReplayShade(torch.autograd.Function):
    """``(color, miss)`` of a recorded path as a function of the material
    table.  Forward: the forward kernel, or the recorder's colour passed
    through (record-as-primal).  Backward: the backward kernel; only
    ``matf`` gets a gradient."""

    @staticmethod
    def forward(ctx, matf, ray_d, uniforms, prim, flags, nx, ny, nz, scf,
                ambient_is_miss, p_color, p_miss):
        tape = PathTape(prim, flags, nx, ny, nz)
        if p_color is None:
            color, miss = replay_fwd(ray_d, uniforms, tape, matf, scf,
                                     ambient_is_miss)
        else:
            color, miss = p_color.detach(), p_miss.detach()
        ctx.save_for_backward(matf, ray_d, uniforms, prim, flags, nx, ny, nz,
                              scf)
        ctx.ambient_is_miss = ambient_is_miss
        ctx.mark_non_differentiable(miss)
        return color, miss

    @staticmethod
    def backward(ctx, color_ct, _miss_ct):
        matf, ray_d, uniforms, prim, flags, nx, ny, nz, scf = \
            ctx.saved_tensors
        matf_ct = replay_bwd(ray_d, uniforms,
                             PathTape(prim, flags, nx, ny, nz), matf, scf,
                             ctx.ambient_is_miss, color_ct.contiguous())
        return (matf_ct,) + (None,) * 11


def replay_fused(scene, ray_o, ray_d, uniforms, tape: PathTape,
                 primal=None):
    """Kernel-backed drop-in for :func:`.replay.replay` (f32): ``(color
    [R, 3], miss [R] bool)``, differentiable in ``scene.materials``.

    ``primal``: optional ``(color, miss)`` of the recording pass itself.
    When given, the forward kernel is skipped and that colour comes back
    unchanged (the replay forward would recompute it to f32 round-off);
    the gradients are the same either way, since the backward kernel runs
    its own forward sweep from the tape.  Directions, air IOR and ambient
    get no gradient (the JAX ``_bwd_core`` gives them zeros)."""
    matf, scf = material_table(scene)
    if matf.shape[0] > MAX_KERNEL_MATS:
        raise ValueError(
            f"replay_fused supports material tables up to {MAX_KERNEL_MATS} "
            f"rows (got {matf.shape[0]}); use replay.replay")
    p_color, p_miss = (None, None) if primal is None else primal
    f32 = torch.float32
    color, miss = _ReplayShade.apply(
        matf, ray_d.detach().to(f32).contiguous(),
        uniforms.detach().to(f32).contiguous(),
        tape.prim.contiguous(), tape.flags.contiguous(),
        *(t.to(f32).contiguous() for t in (tape.nx, tape.ny, tape.nz)),
        scf.detach(), bool(scene.ambient_is_miss), p_color, p_miss)
    return color.to(ray_o.dtype), miss
