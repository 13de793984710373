"""Color helpers mirroring the reference ``DoubleColor`` semantics
(counterpart of ``raytracercore_tpu.core.color``).

Colors are linear-RGB ``[..., 3]`` tensors, unclamped (DoubleColor.cs:6-7).
The reference's ``Placeholder`` miss sentinel is an explicit miss flag
here; no sentinel colors reach the tensors.
"""

from __future__ import annotations

import torch

# Rec.601 luma weights, DoubleColor.GetLuminance (DoubleColor.cs:76-81).
LUM_R, LUM_G, LUM_B = 0.299, 0.587, 0.114


def luminance(rgb):
    """Rec.601 luminance of an ``[..., 3]`` linear color."""
    return LUM_R * rgb[..., 0] + LUM_G * rgb[..., 1] + LUM_B * rgb[..., 2]


def tonemap(color_sum, samples, misses, background_rgb, background_alpha,
            exposure=1.0):
    """Reproduce ``SampleSet.GetOutput`` (SampleSet.cs:61-113) in batch.

    Args:
      color_sum: [H, W, 3] accumulated linear color of hit samples.
      samples:   [H, W] count of hit samples.
      misses:    [H, W] count of miss samples.
      background_rgb: [3] background color, background_alpha: scalar.
      exposure: scalar multiplier applied before compositing.

    Returns:
      (rgb [H, W, 3] in [0,1] after gamma, alpha [H, W]).
    """
    samples = samples.to(color_sum.dtype)
    misses = misses.to(color_sum.dtype)
    total = samples + misses

    # Pixels with zero hit samples show the raw background (SampleSet.cs:63-64).
    no_samples = samples == 0

    color_mult = exposure / torch.clamp(samples, min=1.0)
    rgb = color_sum * color_mult[..., None]

    back_alpha_amt = torch.where(total > 0,
                                 misses / torch.clamp(total, min=1.0),
                                 torch.zeros_like(total))
    back_amt = back_alpha_amt * background_alpha

    rgb = rgb + (background_rgb - rgb) * back_amt[..., None]
    alpha = 1.0 + (background_alpha - 1.0) * back_alpha_amt

    rgb = torch.where(no_samples[..., None], background_rgb * exposure, rgb)
    alpha = torch.where(no_samples, background_alpha, alpha)

    gamma = 1.0 / 2.2
    rgb = torch.pow(torch.clamp(rgb, min=0.0), gamma)
    return torch.clamp(rgb, 0.0, 1.0), torch.clamp(alpha, 0.0, 1.0)


def to_uint8(rgb, alpha=None):
    """Pack tonemapped [0,1] floats to uint8, truncating like the reference
    ``(int)(x * 255)`` (SampleSet.cs:47-53)."""
    out = torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)
    if alpha is None:
        return out
    a = torch.clamp(alpha * 255.0, 0, 255).to(torch.uint8)
    return torch.cat([out, a[..., None]], dim=-1)
