"""Vector math on torch tensors (counterpart of
``raytracercore_tpu.core.vecmath``), only what the render and train paths
use.

Two conventions, as in the JAX package: ``[..., 3]`` tensors at module
boundaries, and component tuples ``(x, y, z)`` of ``[R]`` tensors inside
the per-ray loops (the ``*3`` functions).  The plain versions here are what
the CUDA megakernel is checked against, so every formula keeps the JAX
package's operation order, and ``rsqrt`` is written ``1 / sqrt`` (the
kernel's ``1.0f / sqrtf``).
"""

from __future__ import annotations

import torch

# Behind-ray tolerance used by the intersectors in f32 (the reference's
# Util.cs:18 ``NearEnough = 1e-24`` is an f64 value).
NEAR_ENOUGH_F32 = 1e-7

# Skip-record position tolerance in f32 (relative: eps² · (1 + |p|²)),
# ``raytracercore_tpu.intersect.dispatch._position_eps``.
POSITION_EPS_F32 = 1e-4

# Smallest normal f32 (np.finfo(np.float32).tiny).
_F32_TINY = 1.1754943508222875e-38


def near_enough(dtype=torch.float32) -> float:
    """Behind-ray epsilon matched to the compute dtype."""
    if dtype == torch.float64:
        return 1e-24
    return NEAR_ENOUGH_F32


def _scalar_like(x, value):
    """A 0-dim tensor of ``value`` in ``x``'s dtype, filled on ``x``'s
    device (``x.new_tensor`` would copy it from host memory, and on a CUDA
    device that copy first waits for the stream to drain)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def dot(a, b):
    """Dot product over the trailing axis of ``[..., 3]`` tensors, summed
    x, y, z in that order (as :func:`dot3`)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    """Cross product over the trailing axis of ``[..., 3]`` tensors
    (Vec4D.cs:357)."""
    return torch.stack(cross3(a.unbind(-1), b.unbind(-1)), dim=-1)


def normalize(a, eps=0.0):
    """Normalize over the trailing axis.  With ``eps=0`` a zero vector
    yields NaN, like the reference (Vec4D.cs:321); otherwise the length is
    floored at ``eps`` (``torch.maximum``: half the derivative at a tie,
    as JAX's ``jnp.maximum``)."""
    n = torch.sqrt(dot(a, a))
    if eps:
        n = torch.maximum(n, _scalar_like(n, eps))
    return a / n[..., None]


def safe_sqrt(x, floor=1e-20):
    """sqrt with the argument floored away from 0 (≤1e-10 change).  Below
    the floor the derivative is 0; at it, ``torch.maximum`` passes half, as
    JAX's ``jnp.maximum`` does (``clamp`` would pass all of it)."""
    return torch.sqrt(torch.maximum(x, _scalar_like(x, floor)))


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def scale3(a, s):
    return a[0] * s, a[1] * s, a[2] * s


def where3(c, a, b):
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]),
            torch.where(c, a[2], b[2]))


def create_horizontal3(v):
    """Componentized CreateHorizontal (Vec4D.cs:33-43): cross with ẑ,
    fallback x̂ when degenerate."""
    cx, cy = v[1], -v[0]  # v × (0,0,1) = (vy, -vx, 0)
    sq = cx * cx + cy * cy
    good = sq > _F32_TINY
    inv = 1.0 / torch.sqrt(torch.where(good, sq, torch.ones_like(sq)))
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)
    return (torch.where(good, cx * inv, one),
            torch.where(good, cy * inv, zero),
            zero)


def rotate_about_axis3_cs(vec, axis, ct, st):
    """Componentized Rodrigues rotation with precomputed cos/sin(theta)."""
    kxv = cross3(axis, vec)
    kd = dot3(axis, vec) * (1.0 - ct)
    return (vec[0] * ct + kxv[0] * st + axis[0] * kd,
            vec[1] * ct + kxv[1] * st + axis[1] * kd,
            vec[2] * ct + kxv[2] * st + axis[2] * kd)


def create_horizon3_cs(pole, z, ct, st):
    """Componentized CreateHorizon (Vec4D.cs:52-58) with precomputed
    cos/sin of the azimuth angle: a point on the cone of height ``z``
    around unit ``pole``."""
    horiz = create_horizontal3(pole)
    s = safe_sqrt(1.0 - z * z)
    base = (pole[0] * z + horiz[0] * s,
            pole[1] * z + horiz[1] * s,
            pole[2] * z + horiz[2] * s)
    return rotate_about_axis3_cs(base, pole, ct, st)


def create_horizon_cs(pole, z, ct, st):
    """``[..., 3]``-shaped CreateHorizon with precomputed azimuth
    cos/sin."""
    return torch.stack(create_horizon3_cs(pole.unbind(-1), z, ct, st),
                       dim=-1)


def reflect(normal, incoming, cos):
    """Mirror ``incoming`` about ``normal``; ``cos = -normal·incoming``
    (Raytracer.Reflection, Raytracer.cs:58-61)."""
    return incoming + normal * (2.0 * cos)[..., None]


def transform_point(m, p):
    """Apply row-major 4x4 ``m`` (``[..., 4, 4]``) to point(s) ``p``
    (``[..., 3]``) with implicit w=1 (Mat4x4D.cs:151-168)."""
    return transform_dir(m, p) + m[..., :3, 3]


def transform_dir(m, d):
    """Apply 4x4 ``m`` to direction(s) ``d`` with implicit w=0."""
    x, y, z = d.unbind(-1)
    return torch.stack([m[..., i, 0] * x + m[..., i, 1] * y + m[..., i, 2] * z
                        for i in range(3)], dim=-1)


def reflect3(normal, incoming, cos):
    """Componentized Reflection (Raytracer.cs:58-61)."""
    k = 2.0 * cos
    return (incoming[0] + normal[0] * k,
            incoming[1] + normal[1] * k,
            incoming[2] + normal[2] * k)
