"""Progressive accumulation film (counterpart of
``raytracercore_tpu.render.film``).

Per-pixel color sum, hit-sample count and miss count, as a dataclass of
tensors on the render device (the reference's ``SampleSet[,]`` grid,
Raytracing/SampleSet.cs).  ``compensated=True`` keeps a Neumaier
compensation term beside ``color_sum``, for runs of thousands of samples per
pixel where plain f32 sums lose low-order contributions.  Films are values:
every update returns a new :class:`Film`, except :meth:`Film.add_full_frame_`,
which accumulates into the film's own tensors (the form a captured CUDA
graph ends in: its film lives at fixed addresses).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.color import to_uint8, tonemap
from ..core.device import DEFAULT_DEVICE, resolve_device


def _neumaier_add(s, c, x):
    """One Neumaier compensated-sum step: returns (s', c') with the true sum
    ≈ s' + c'.  Unlike classic Kahan this stays accurate when the increment
    exceeds the running sum."""
    t = s + x
    lost = torch.where(torch.abs(s) >= torch.abs(x), (s - t) + x, (x - t) + s)
    return t, c + lost


@dataclasses.dataclass(frozen=True)
class Film:
    color_sum: torch.Tensor  # [H, W, 3]
    samples: torch.Tensor    # [H, W] float (counts)
    misses: torch.Tensor     # [H, W]
    # Neumaier compensation for color_sum; None ⇒ plain summation.
    color_c: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, height: int, width: int, device=DEFAULT_DEVICE,
               dtype=torch.float32, compensated: bool = False):
        device = resolve_device(device, "Film.create")

        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(color_sum=z(height, width, 3), samples=z(height, width),
                   misses=z(height, width),
                   color_c=z(height, width, 3) if compensated else None)

    @property
    def shape(self):
        return tuple(self.samples.shape)

    def add_full_frame(self, color, miss):
        """Accumulate one sample for every pixel (row-major flat [H*W, 3]).

        A miss sample contributes to ``misses`` only (the Placeholder path,
        FullRaytracer.cs:334-337); hits add color + sample count.
        """
        h, w = self.shape
        color = color.reshape(h, w, 3)
        miss = miss.reshape(h, w)
        hit = ~miss
        contrib = torch.where(hit[..., None], color, torch.zeros_like(color))
        if self.color_c is None:
            cs, cc = self.color_sum + contrib, None
        else:
            cs, cc = _neumaier_add(self.color_sum, self.color_c, contrib)
        return Film(
            color_sum=cs,
            samples=self.samples + hit.to(self.samples.dtype),
            misses=self.misses + miss.to(self.misses.dtype),
            color_c=cc,
        )

    def add_full_frame_(self, color, miss) -> "Film":
        """:meth:`add_full_frame` written into this film's own tensors (the
        same operations, so the sums are bit-equal); returns ``self``."""
        h, w = self.shape
        color = color.reshape(h, w, 3)
        miss = miss.reshape(h, w)
        hit = ~miss
        contrib = torch.where(hit[..., None], color, torch.zeros_like(color))
        if self.color_c is None:
            self.color_sum.add_(contrib)
        else:
            cs, cc = _neumaier_add(self.color_sum, self.color_c, contrib)
            self.color_sum.copy_(cs)
            self.color_c.copy_(cc)
        self.samples.add_(hit.to(self.samples.dtype))
        self.misses.add_(miss.to(self.misses.dtype))
        return self

    def tensors(self) -> tuple:
        """``(color_sum, samples, misses[, color_c])``."""
        planes = (self.color_sum, self.samples, self.misses)
        return planes if self.color_c is None else planes + (self.color_c,)

    def add_scatter(self, pix_linear, color, miss):
        """Accumulate samples at arbitrary pixel indices (tile/shard path):
        sample ``i`` [R] lands on row-major pixel ``pix_linear[i]``.

        Scattered adds can collide on repeated indices, so compensation is
        not maintained here — the error term is carried unchanged.  On
        CUDA tensors ``index_add_`` sums colliding float samples by
        atomics, in no fixed order; with unique indices every pixel gets
        one add and the film equals :meth:`add_full_frame` of the same
        samples in pixel order.
        """
        h, w = self.shape
        idx = pix_linear.reshape(-1).long()
        hit = ~miss
        contrib = torch.where(hit[:, None], color, torch.zeros_like(color))

        def scatter(plane, src):
            out = plane.reshape((h * w,) + plane.shape[2:]).clone()
            return out.index_add_(0, idx, src.to(out.dtype)).reshape(
                plane.shape)
        return Film(color_sum=scatter(self.color_sum, contrib),
                    samples=scatter(self.samples, hit),
                    misses=scatter(self.misses, miss),
                    color_c=self.color_c)

    def merge(self, other: "Film") -> "Film":
        """Combine two accumulators (cross-device reduction).  The
        compensation terms add, a missing one counting as zeros; the
        result has none only when neither film has one."""
        cc = self.color_c
        if cc is not None or other.color_c is not None:
            z = torch.zeros_like(self.color_sum)
            cc = ((self.color_c if self.color_c is not None else z)
                  + (other.color_c if other.color_c is not None else z))
        return Film(color_sum=self.color_sum + other.color_sum,
                    samples=self.samples + other.samples,
                    misses=self.misses + other.misses,
                    color_c=cc)

    @property
    def corrected_sum(self):
        """color_sum with the compensation folded in."""
        if self.color_c is None:
            return self.color_sum
        return self.color_sum + self.color_c

    def to_image(self, background_rgb, background_alpha, exposure=1.0):
        """Tonemapped [0,1] image + alpha (SampleSet.GetOutput semantics)."""
        return tonemap(self.corrected_sum, self.samples, self.misses,
                       background_rgb, background_alpha, exposure)

    def to_uint8(self, background_rgb, background_alpha, exposure=1.0):
        rgb, alpha = self.to_image(background_rgb, background_alpha, exposure)
        return to_uint8(rgb, alpha)
