"""Integrator contract pieces (counterpart of
``raytracercore_tpu.render.integrator``): the bounce codes, the
:class:`PathTape` bit layout and the preprocessed-uniform channels that the
megakernel (:mod:`.fused`) consumes.

The differentiable ``trace`` and the dense ``closest_hit`` of the JAX
package are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses

import torch

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


def preprocess_uniforms(raw):
    """Per-bounce raw uniforms ``[B, 5, R]`` → the 7 channels ``[B, 7, R]``.

    Raw channel order is the integrator's consumption order (shine z, shine
    θ, branch u, diffuse z, diffuse θ; Raytracer.cs:51-56, 177, 215-216);
    every transform that is a pure function of a uniform is applied here:

      ch0 = ln(clip(u0))          — RandomShine exponent input
      ch1, ch2 = cos/sin(2π·u1)   — shine azimuth
      ch3 = u2                    — branch-selection variate
      ch4 = 2·acos(u3)/π          — diffuse cone height (Raytracer.cs:215)
      ch5, ch6 = cos/sin(2π·u4)   — diffuse azimuth
    """
    t1 = raw[:, 1] * TWO_PI
    t2 = raw[:, 4] * TWO_PI
    return torch.stack([
        torch.log(torch.clamp(raw[:, 0], 1e-20, 1.0)),
        torch.cos(t1), torch.sin(t1),
        raw[:, 2],
        2.0 * torch.acos(torch.clamp(raw[:, 3], 0.0, 1.0)) / torch.pi,
        torch.cos(t2), torch.sin(t2),
    ], dim=1)


def prepare_uniforms(generator: torch.Generator, n: int, bounces: int,
                     device=None, dtype=torch.float32):
    """All per-bounce randomness for ``n`` paths, preprocessed:
    ``[bounces, 7, n]``, drawn from ``generator`` on ``device`` (default:
    the generator's device)."""
    device = generator.device if device is None else device
    raw = torch.rand((bounces, 5, n), generator=generator, device=device,
                     dtype=dtype)
    return preprocess_uniforms(raw)
