"""The wavefront path-tracing integrator (counterpart of
``raytracercore_tpu.render.integrator``).

:func:`trace` is the batched rebuild of ``Raytracer.GetColor``
(Raytracing/Raytracer.cs:65-246): a whole batch of rays advances through a
loop over bounces, one closest-hit query per bounce; terminated rays are
masked out and their results frozen.  All reference semantics are kept:

* direction renormalized every 3 bounces (Raytracer.cs:74-75)
* primary miss → "Placeholder" miss sample; secondary miss → the scene's
  ambient colour returned untinted (Raytracer.cs:85-90)
* ``debug geom`` mode: flat spec+diff+emission of the first hit (:93-98)
* rough shading normal: ``z = U^(1/shininess)`` cone sample around the true
  normal (RandomShine, :51-56)
* exact Fresnel s/p-wave average with total internal reflection, applied to
  the luminance-weighted branch probabilities (:120-157)
* single stochastic branch per bounce ∝ luminance: transmit / specular (with
  the rough-normal fail path) / diffuse (``z = 2·acos(U)/π``) / emission
  (:163-229); throughput multiplied by chosen albedo × ``max(totalLum, 1)``
  (:238-240); termination returns ``tint · emission`` (:245)
* self-intersection via the previous-hit skip record, not ray epsilons (:77)

Differentiability: branch *selection* is discrete (comparisons carry no
gradient); the realized path's albedo/Fresnel/totalLum factors stay in the
autograd graph, so the gradient of a pixel w.r.t. material parameters
matches finite differences of the same fixed-uniforms estimator.

The module also holds the contract pieces the kernels share: the bounce
codes, the :class:`PathTape` bit layout, the preprocessed-uniform channels
and :func:`_material_matrix`, the differentiable ``[N, 14]`` material
packing.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import PARKED_ORIGIN
from ..core import graphs
from ..core import vecmath as vm
from ..core.color import luminance
from ..core.spans import span
from ..intersect.dispatch import HitRecord, closest_hit
from ..scene.types import SceneArrays

TWO_PI = 6.283185307179586


class BounceType:
    """Per-bounce tags (Raytracer.BounceType, Raytracer.cs:14-26)."""

    SKIPPED = 0
    DIFFUSE = 1
    SPECULAR = 2
    SPECULAR_FAIL = 3
    TRANSMITTED = 4
    EMISSION = 5
    PURE_BLACK = 6
    RECURSION_COMPLETE = 7
    MISSED = 8
    DEBUG = 9

    NAMES = ("Skipped", "Diffuse", "Specular", "SpecularFail", "Transmitted",
             "Emission", "PureBlack", "RecursionComplete", "Missed", "Debug")


@dataclasses.dataclass(frozen=True)
class PathTape:
    """Compact per-bounce decision record, ``[bounces, R]`` per field.

    ``flags`` bit layout: bits 0-3 = :class:`BounceType` code,
    bit 4 = hit ``inside`` (post-Invert), bit 5 = ``f_live``
    (Fresnel evaluated: refraction geometrically possible and no TIR).

    ``prim`` and ``flags`` are defined only where a replay reads them:
    ``prim`` on live bounces, the INSIDE/FLIVE bits on bounced codes
    (Diffuse, Specular, Transmitted); normals only on bounced codes.  The
    megakernel writes prim = -1, flags = 0 and zero normals on bounces a
    ray did not reach, and no FLIVE bit on the final bounce.
    """

    prim: torch.Tensor   # [bounces, R] int32 winning primitive (-1 miss)
    flags: torch.Tensor  # [bounces, R] int32 bitfield
    nx: torch.Tensor     # [bounces, R] hit normal components
    ny: torch.Tensor
    nz: torch.Tensor

    FLAG_INSIDE = 1 << 4
    FLAG_FLIVE = 1 << 5
    CODE_MASK = 0xF

    @classmethod
    def create(cls, R, n_bounces, dtype, device):
        """The tape of ``R`` paths that reached no bounce yet: prim -1,
        flags 0, zero normals (what a bounce after an early exit keeps)."""
        def zero():
            return torch.zeros((n_bounces, R), dtype=dtype, device=device)
        return cls(prim=torch.full((n_bounces, R), -1, dtype=torch.int32,
                                   device=device),
                   flags=torch.zeros((n_bounces, R), dtype=torch.int32,
                                     device=device),
                   nx=zero(), ny=zero(), nz=zero())


def preprocess_uniforms(raw):
    """Per-bounce raw uniforms ``[B, 5, R]`` → the 7 channels ``[B, 7, R]``
    (one bounce's ``[5, R]`` → its ``[7, R]``).

    Raw channel order is the integrator's consumption order (shine z, shine
    θ, branch u, diffuse z, diffuse θ; Raytracer.cs:51-56, 177, 215-216);
    every transform that is a pure function of a uniform is applied here:

      ch0 = ln(clip(u0))          — RandomShine exponent input
      ch1, ch2 = cos/sin(2π·u1)   — shine azimuth
      ch3 = u2                    — branch-selection variate
      ch4 = 2·acos(u3)/π          — diffuse cone height (Raytracer.cs:215)
      ch5, ch6 = cos/sin(2π·u4)   — diffuse azimuth
    """
    t1 = raw[..., 1, :] * TWO_PI
    t2 = raw[..., 4, :] * TWO_PI
    return torch.stack([
        torch.log(torch.clamp(raw[..., 0, :], 1e-20, 1.0)),
        torch.cos(t1), torch.sin(t1),
        raw[..., 2, :],
        2.0 * torch.acos(torch.clamp(raw[..., 3, :], 0.0, 1.0)) / torch.pi,
        torch.cos(t2), torch.sin(t2),
    ], dim=-2)


def prepare_uniforms(generator: torch.Generator, n: int, bounces: int,
                     device=None, dtype=torch.float32):
    """All per-bounce randomness for ``n`` paths, preprocessed:
    ``[bounces, 7, n]``, drawn from ``generator`` on ``device`` (default:
    the generator's device)."""
    device = generator.device if device is None else device
    raw = torch.rand((bounces, 5, n), generator=generator, device=device,
                     dtype=dtype)
    return preprocess_uniforms(raw)


def _material_matrix(mats):
    """Materials packed ``[N, 14]``, differentiably: emission, diffuse,
    specular, refraction (3 each), ior, shininess.  Infinite shininess is
    clamped to the f32 maximum, as in JAX, so no backward meets ``0·inf``;
    ``exp(ln U / 3.4e38)`` rounds to exactly 1, the value of the explicit
    ``isinf`` branch."""
    shin = mats.shininess
    shin = torch.where(torch.isinf(shin), torch.finfo(torch.float32).max,
                       shin)
    return torch.cat([
        mats.emission, mats.diffuse, mats.specular, mats.refraction,
        mats.refractive_index[:, None], shin[:, None]], dim=1)


def _random_shine(ln_u, cos_t, sin_t, normal, shininess):
    """RandomShine (Raytracer.cs:51-56): perturb the shading normal on a cone
    with ``z = U^(1/shininess)`` = exp(ln U / shininess); shininess=+inf ⇒
    z=1 (unperturbed).  ``ln_u`` is pre-clipped away from ln(0) so the
    backward pass through the exp stays finite."""
    z = torch.where(torch.isinf(shininess), 1.0, torch.exp(ln_u / shininess))
    return vm.create_horizon_cs(normal, z, cos_t, sin_t)


def _gather_material(mats, prim, matf=None):
    """The hit primitives' material rows (row 0 where ``prim`` < 0) as a
    dict of fields, by a plain index gather of :func:`_material_matrix`
    (``matf``, when the caller already packed it).  The gather reads a
    float64 copy, so autograd sums each row's gradient over all rays in
    float64 (as the replay's ``_gather``); the values are the table's
    own."""
    if matf is None:
        matf = _material_matrix(mats)
    m = matf.to(torch.float64)[torch.clamp(prim, min=0).long()].to(matf.dtype)
    return {
        "emission": m[:, 0:3],
        "diffuse": m[:, 3:6],
        "specular": m[:, 6:9],
        "refraction": m[:, 9:12],
        "ior": m[:, 12],
        "shininess": m[:, 13],
    }


@dataclasses.dataclass(frozen=True)
class BounceRecords:
    """Per-bounce debug trace (the DebugRay records of Raytracer.cs:28-33),
    ``[R, recursion + 1]`` per field."""

    btype: torch.Tensor     # int32 BounceType
    prim: torch.Tensor      # int32 hit primitive (-1 miss)
    t: torch.Tensor         # hit distance
    position: torch.Tensor  # [R, B, 3]
    normal: torch.Tensor    # [R, B, 3]
    inside: torch.Tensor    # bool
    fresnel: torch.Tensor   # Fresnel ratio (NaN when not evaluated)

    @classmethod
    def create(cls, R, n_bounces, dtype, device):
        """Records of ``R`` paths that reached no bounce yet: type Skipped,
        prim -1, zero geometry, not inside, Fresnel NaN (what a bounce
        after an early exit keeps)."""
        return cls(
            btype=torch.zeros((R, n_bounces), dtype=torch.int32,
                              device=device),
            prim=torch.full((R, n_bounces), -1, dtype=torch.int32,
                            device=device),
            t=torch.zeros((R, n_bounces), dtype=dtype, device=device),
            position=torch.zeros((R, n_bounces, 3), dtype=dtype,
                                 device=device),
            normal=torch.zeros((R, n_bounces, 3), dtype=dtype,
                               device=device),
            inside=torch.zeros((R, n_bounces), dtype=torch.bool,
                               device=device),
            fresnel=torch.full((R, n_bounces), float("nan"), dtype=dtype,
                               device=device))



@dataclasses.dataclass(frozen=True)
class PathState:
    ray_o: torch.Tensor    # [R, 3]
    ray_d: torch.Tensor    # [R, 3]
    tint: torch.Tensor     # [R, 3] running throughput
    alive: torch.Tensor    # [R] bool — still bouncing
    result: torch.Tensor   # [R, 3] final colour once dead
    miss: torch.Tensor     # [R] bool — sample counts as a miss
    prev: HitRecord        # previous bounce's hit (skip record)

    @classmethod
    def start(cls, ray_o, ray_d) -> "PathState":
        """Camera paths before bounce 0: tint 1, alive, result 0, no miss,
        no skip record."""
        R = ray_o.shape[0]
        dtype, device = ray_o.dtype, ray_o.device
        return cls(
            ray_o=ray_o, ray_d=ray_d,
            tint=torch.ones((R, 3), dtype=dtype, device=device),
            alive=torch.ones((R,), dtype=torch.bool, device=device),
            result=torch.zeros((R, 3), dtype=dtype, device=device),
            miss=torch.zeros((R,), dtype=torch.bool, device=device),
            prev=HitRecord.none(R, dtype, device))


def shade_bounce_reference(hit: HitRecord, state: PathState, d, u, matf,
                           ambient, air, i: int, recursion: int,
                           ambient_is_miss: bool, tape: PathTape | None = None,
                           records: BounceRecords | None = None
                           ) -> PathState:
    """Bounce ``i`` of :func:`trace` after its closest hit: the plain
    version of the shading kernel (``csrc/shade.cu``) and the body autograd
    differentiates.

    Miss handling, the recursion cap, the material gather, the Fresnel
    split, pure black, the branch pick, the three directions and the
    terminal branches give the path state after the bounce (dead lanes
    parked at ``config.PARKED_ORIGIN``, pointing +x) and the skip record of
    the next query.  ``hit``: this bounce's closest hit; ``state``: the
    paths before it; ``d``: the direction the query traced (``state.ray_d``
    renormalized on every third bounce); ``u``: this bounce's ``[7, R]``
    uniform channels; ``matf``: :func:`_material_matrix`; ``ambient`` [3]
    and ``air`` (0-dim): the scene's, in the rays' dtype.

    ``tape`` (``[B, R]``) and ``records`` (``[R, B]``) get row / column
    ``i`` written in place where given: the tape row on every lane (dead
    lanes included: prim and flags from the no-hit record and row 0's
    material), the record row with the defaults of
    :meth:`BounceRecords.create` on lanes that were not alive."""
    R = d.shape[0]
    dtype, device = d.dtype, d.device
    one = torch.ones((), dtype=dtype, device=device)
    # Dead lanes are parked far outside any scene, pointing away (+x):
    # their results are already committed, and a parked ray misses
    # everything.  (Filled on the device: no copy from host memory.)
    parked_o = torch.full((3,), PARKED_ORIGIN, dtype=dtype, device=device)
    parked_d = torch.zeros((3,), dtype=dtype, device=device)
    parked_d[0].fill_(1.0)  # a fill, not a copy (a graph captures it)

    active = state.alive
    found = hit.found

    # --- miss handling (Raytracer.cs:81-91) ---------------------------------
    was_missed = active & ~found
    result = state.result
    miss = state.miss
    if i == 0 or ambient_is_miss:
        miss = miss | was_missed
    else:
        result = torch.where(was_missed[:, None], ambient, result)
    alive = active & found

    mat = _gather_material(None, hit.prim, matf)
    emission = mat["emission"]

    # --- recursion complete (Raytracer.cs:100-104) --------------------------
    if i >= recursion:
        done = alive
        result = torch.where(done[:, None], state.tint * emission, result)
        alive = torch.zeros_like(alive)
    else:
        done = torch.zeros_like(alive)

    # --- shading (only meaningful where alive) ------------------------------
    rough_n = _random_shine(u[0], u[1], u[2], hit.normal, mat["shininess"])

    diff_lum = luminance(mat["diffuse"])
    spec_lum = luminance(mat["specular"])
    refr_lum = luminance(mat["refraction"])
    emis_lum = luminance(emission)

    cos = -vm.dot(rough_n, d)

    # Fresnel split (Raytracer.cs:120-157).
    can_refract = ((refr_lum > 0) | (spec_lum > 0)) & \
        (mat["ior"] != 0) & (cos >= 0)
    ior_in = torch.where(hit.inside, mat["ior"], air)
    ior_out = torch.where(hit.inside, air, mat["ior"])
    safe_out = torch.where(ior_out == 0, 1.0, ior_out)
    ior_ratio = ior_in / safe_out
    sin_out = ior_ratio * vm.safe_sqrt(1.0 - cos * cos)
    tir = sin_out >= 1.0
    cos_out = vm.safe_sqrt(1.0 - sin_out * sin_out)
    # Fresnel terms evaluated with masked inputs: where refraction is
    # impossible (cos<0, ior=0, TIR) the raw denominators can pass
    # through 0 and rs² overflows to inf, which NaNs the backward pass
    # through torch.where even though the branch is unselected.
    f_live = can_refract & ~tir
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

    # Pure black termination (Raytracer.cs:165-169).
    black = alive & (total_lum <= 0)
    result = torch.where(black[:, None], state.tint * emission, result)
    alive = alive & ~black

    # --- stochastic branch selection (Raytracer.cs:177-229) -----------------
    ray_rand = u[3] * total_lum
    pick_refr = (refr_lum != 0) & (ray_rand - refr_lum <= 0)
    r2 = ray_rand - refr_lum
    pick_spec = ~pick_refr & (spec_lum != 0) & (r2 - spec_lum <= 0)
    r3 = r2 - spec_lum
    pick_diff = ~pick_refr & ~pick_spec & (diff_lum != 0) & \
        (r3 - diff_lum <= 0)
    pick_emit = ~pick_refr & ~pick_spec & ~pick_diff

    # Transmission (Raytracer.cs:181-193).
    refr_dir = (rough_n * (-cos_out)[:, None]
                + (d + rough_n * cos[:, None]) * ior_ratio[:, None])
    refr_tint = torch.where(hit.inside[:, None], 1.0, mat["refraction"])

    # Specular with rough-normal fail (Raytracer.cs:194-209).
    spec_dir = vm.reflect(rough_n, d, cos)
    spec_ok = vm.dot(spec_dir, hit.normal) > 0

    # Diffuse (Raytracer.cs:210-219): z = 2·acos(U)/π around the TRUE
    # normal (not the rough normal); z precomputed as channel 4.
    diff_dir = vm.create_horizon_cs(hit.normal, u[4], u[5], u[6])

    # Terminal branches: emission pick, or failed specular.
    terminal = alive & (pick_emit | (pick_spec & ~spec_ok))
    result = torch.where(terminal[:, None], state.tint * emission, result)
    alive = alive & ~terminal

    out_dir = torch.where(pick_refr[:, None], refr_dir,
                          torch.where(pick_spec[:, None], spec_dir,
                                      diff_dir))
    new_tint = torch.where(pick_refr[:, None], refr_tint,
                           torch.where(pick_spec[:, None],
                                       mat["specular"], mat["diffuse"]))
    # Energy compensation (Raytracer.cs:238-240); torch.maximum splits
    # the derivative at a tie as jnp.maximum does.
    new_tint = new_tint * torch.maximum(total_lum, one)[:, None]

    bounced = alive
    sel = bounced[:, None]
    new_o = torch.where(sel, hit.position, state.ray_o)
    new_d = torch.where(sel, out_dir, d)
    new_o = torch.where(alive[:, None], new_o, parked_o)
    new_d = torch.where(alive[:, None], new_d, parked_d)
    tint = torch.where(sel, state.tint * new_tint, state.tint)

    prev = HitRecord(
        prim=torch.where(bounced, hit.prim, state.prev.prim),
        t=torch.where(bounced, hit.t, state.prev.t),
        position=torch.where(sel, hit.position, state.prev.position),
        normal=torch.where(sel, hit.normal, state.prev.normal),
        inside=torch.where(bounced, hit.inside, state.prev.inside))

    if records is not None or tape is not None:
        btype = torch.full_like(hit.prim, BounceType.SKIPPED)
        for code, mask in (
                (BounceType.MISSED, was_missed),
                (BounceType.RECURSION_COMPLETE, done),
                (BounceType.PURE_BLACK, black),
                (BounceType.EMISSION, terminal & pick_emit),
                (BounceType.SPECULAR_FAIL, terminal & pick_spec & ~spec_ok),
                (BounceType.TRANSMITTED, bounced & pick_refr),
                (BounceType.SPECULAR, bounced & pick_spec),
                (BounceType.DIFFUSE, bounced & pick_diff)):
            btype = torch.where(mask, code, btype)

    if tape is not None:
        flags = (btype
                 | torch.where(hit.inside, PathTape.FLAG_INSIDE, 0)
                 | torch.where(f_live, PathTape.FLAG_FLIVE, 0))
        normal = hit.normal.detach()
        tape.prim[i] = hit.prim
        tape.flags[i] = flags.to(torch.int32)
        tape.nx[i], tape.ny[i], tape.nz[i] = normal.unbind(1)

    if records is not None:
        nan = torch.full_like(fresnel, float("nan"))
        fr = torch.where(active & can_refract,
                         torch.where(tir, 1.0, fresnel), nan)
        none = HitRecord.none(R, dtype, device)
        touched = active
        records.btype[:, i] = torch.where(touched, btype, 0)
        records.prim[:, i] = torch.where(touched, hit.prim, none.prim)
        records.t[:, i] = torch.where(touched, hit.t, none.t)
        records.position[:, i] = torch.where(touched[:, None], hit.position,
                                             none.position)
        records.normal[:, i] = torch.where(touched[:, None], hit.normal,
                                           none.normal)
        records.inside[:, i] = torch.where(touched, hit.inside, none.inside)
        records.fresnel[:, i] = fr

    return PathState(ray_o=new_o, ray_d=new_d, tint=tint, alive=alive,
                     result=result, miss=miss, prev=prev)


def _needs_grad(*tensors) -> bool:
    """True where autograd records and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def trace(scene: SceneArrays, ray_o, ray_d, generator=None,
          closest_fn=closest_hit, record: bool = False,
          early_exit: bool = False, uniforms=None, want_tape: bool = False,
          shade_fn=None):
    """Trace a batch of camera rays to final colours.

    Args:
      scene: frozen SceneArrays on the rays' device.
      ray_o, ray_d: [R, 3] camera rays (unit directions).
      generator: ``torch.Generator`` the per-bounce uniforms are drawn from
        (:func:`prepare_uniforms`) when ``uniforms`` is not given.
      closest_fn: closest-hit implementation, ``(scene, ray_o, ray_d, skip)
        → HitRecord`` (:func:`..intersect.dispatch.closest_hit`, which is
        differentiable, or :func:`..intersect.cuda_select.closest_hit_fused`).
      record: also return per-bounce :class:`BounceRecords` (the
        GetDebugTrace path, Raytracer.cs:254-260) — same loop body, so the
        debug view can never drift from the render path.
      early_exit: stop the bounce loop once every ray has terminated
        (one host read of a flag per bounce).  Forward only.  A CUDA graph
        cannot capture the read: while one is captured this raises
        ``ValueError``.
      uniforms: pre-generated ``[recursion + 1, 7, R]`` channels to use
        instead of drawing from ``generator`` (the replay path shares one
        uniform set between the recording and replay passes).
      want_tape: also return a :class:`PathTape` of per-bounce discrete
        decisions (recorded through the same loop body).  ``trace`` writes
        the hit's prim and flag bits on every lane, dead ones included;
        compare tapes only where a replay reads them.
      shade_fn: the bounce body after the closest hit, with the signature
        of :func:`shade_bounce_reference`.  None picks it bounce by bounce
        by need: where autograd records and an input of the bounce (the
        materials, the rays, ambient, air IOR, the hit or the path state)
        requires grad, :func:`shade_bounce_reference` under autograd (the
        kernel has no backward); else
        :func:`.shade_kernel.shade_bounce`, which launches the shading
        kernel on a CUDA device (or raises) and runs the plain version on
        the CPU.

    Returns:
      (color [R, 3], miss [R] bool) — ``miss`` marks Placeholder samples
      (primary miss, or any miss under ``ambient miss``); with
      ``record=True`` a :class:`BounceRecords` is appended, and with
      ``want_tape=True`` a :class:`PathTape` is appended (in that order).
    """
    from . import shade_kernel

    if early_exit and graphs.capturing(ray_o.device):
        raise ValueError("trace(early_exit=True) reads the device from the "
                         "host at every bounce, which a CUDA graph cannot "
                         "capture: a graphed pass traces every bounce")
    R = ray_o.shape[0]
    dtype, device = ray_o.dtype, ray_o.device
    recursion = scene.recursion
    n_bounces = recursion + 1
    records = (BounceRecords.create(R, n_bounces, dtype, device) if record
               else None)
    tape = (PathTape.create(R, n_bounces, dtype, device) if want_tape
            else None)

    if scene.debug_geom:
        # Flat geometry view (Raytracer.cs:93-98): first hit's
        # spec+diff+emission; primary misses stay misses.
        with span("closest_hit"):
            hit = closest_fn(scene, ray_o, ray_d, None)
        mat = _gather_material(scene.materials, hit.prim)
        color = mat["specular"] + mat["diffuse"] + mat["emission"]
        color = torch.where(hit.found[:, None], color, 0.0)
        code = torch.where(hit.found, BounceType.DEBUG,
                           BounceType.MISSED).to(torch.int32)
        out = (color, ~hit.found)
        if record:
            records.btype[:, 0] = code
            records.prim[:, 0] = hit.prim
            records.t[:, 0] = hit.t
            records.position[:, 0] = hit.position
            records.normal[:, 0] = hit.normal
            records.inside[:, 0] = hit.inside
            out += (records,)
        if want_tape:
            tape.prim[0] = hit.prim
            tape.flags[0] = code
            out += (tape,)
        return out

    # All randomness for the whole trace, generated up front (bounce i reads
    # uniforms[i]).
    if uniforms is None:
        if generator is None:
            raise ValueError("trace: give a generator or the uniforms")
        uniforms = prepare_uniforms(generator, R, n_bounces, device, dtype)
    ambient = scene.ambient_rgb.to(dtype)
    air = scene.air_refractive_index.to(dtype)
    matf = _material_matrix(scene.materials)  # packed once for all bounces

    state = PathState.start(ray_o, ray_d)

    for i in range(n_bounces):
        if early_exit and not bool(state.alive.any()):
            break
        # Periodic renormalization (Raytracer.cs:74-75), bounce 0 included.
        d = vm.normalize(state.ray_d) if i % 3 == 0 else state.ray_d

        with span("closest_hit"):
            hit = closest_fn(scene, state.ray_o, d, state.prev)
        u = uniforms[i]  # [7, R] preprocessed channels
        shade = shade_fn
        if shade is None:
            shade = (shade_bounce_reference if _needs_grad(
                matf, ambient, air, d, u, state.ray_o, state.tint,
                state.result, state.prev.t, state.prev.position,
                state.prev.normal, hit.t, hit.position, hit.normal)
                else shade_kernel.shade_bounce)
        state = shade(hit, state, d, u, matf, ambient, air, i, recursion,
                      scene.ambient_is_miss, tape, records)

    out = (state.result, state.miss)
    if record:
        out += (records,)
    if want_tape:
        out += (tape,)
    return out


def trace_pass(scene: SceneArrays, camera, film, jitter, raw,
               closest_fn=closest_hit):
    """One progressive pass of the bounce loop (the ``trace`` route) added
    into ``film``'s own tensors, +1 sample for every pixel, from the pass's
    draws: ``jitter`` [H*W, 4] and the raw ``[recursion + 1, 5, H*W]``
    (ray ``i`` takes row-major pixel ``i``); returns ``film``.

    The pass without its eager glue: one launch of the camera rays
    (:func:`.shade_kernel.pass_rays`: :func:`.camera.camera_rays` and the
    renormalization of bounce 0), then each bounce's ``closest_fn`` and one
    launch of the shading kernel on the bounce's raw draws
    (:func:`.shade_kernel.shade_bounce_pass`), which computes the uniform
    channels where :func:`trace` reads :func:`preprocess_uniforms`' planes,
    starts bounce 0 from :meth:`PathState.start`, writes the direction of
    bounces 3, 6, 9, ... already renormalized (``trace`` reads the
    unnormalized one only to renormalize it), and at the last bounce adds
    the samples into ``film`` (:meth:`.film.Film.add_full_frame_`).  Bounce
    0 queries with no skip record, which skips nothing, as the empty record
    ``trace`` passes.  The shading reads the scene's material rows, packed
    once (:attr:`..scene.types.SceneArrays.material_rows`), where ``trace``
    packs :func:`_material_matrix` a pass.  On CUDA tensors the kernels run
    (a float32, uncompensated film); on CPU tensors their plain versions.  Bit-equal to the chain it replaces,
    :func:`.renderer.render_pass_` on :func:`preprocess_uniforms` ``(raw)``
    with ``closest_fn``.  No host synchronisation."""
    from . import shade_kernel

    if scene.debug_geom:
        raise ValueError("trace_pass: a debug geom scene traces one flat "
                         "bounce; render_pass_ runs it")
    h, w = film.shape
    recursion = scene.recursion
    with span("camera_rays"):
        ray_o, d = shade_kernel.pass_rays(camera, jitter, w)
    ambient = scene.ambient_rgb.to(d.dtype)
    air = scene.air_refractive_index.to(d.dtype)
    matf = scene.material_rows
    state = None
    for i in range(recursion + 1):
        last = i == recursion
        with span("closest_hit"):
            hit = closest_fn(scene, ray_o, d,
                             None if state is None else state.prev)
        state = shade_kernel.shade_bounce_pass(
            hit, state, d, raw, matf, ambient, air, i, recursion,
            scene.ambient_is_miss, film=film if last else None,
            renorm=(i + 1) % 3 == 0)
        if not last:
            ray_o, d = state.ray_o, state.ray_d
    return film
