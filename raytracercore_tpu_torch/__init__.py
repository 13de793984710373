"""raytracercore_tpu_torch — the PyTorch + CUDA port of raytracercore_tpu.

The same progressive path tracer as the JAX package beside it (which stays
the reference this package is tested against), written as plain functions
on torch tensors with an explicit ``device`` everywhere and explicit
``torch.Generator``s.  Module names match the JAX package one for one, so
each counterpart is easy to find.

Layering (bottom-up):
  core/      vector math, colour/tonemap
  scene/     text-format loader → SoA scene tensors, procedural scenes
  intersect/ per-row intersection passes (plain torch + CUDA device code),
             grid oracle, dense closest hit, the per-bounce select kernel
  render/    camera rays, uniforms, the integrator, the whole-path
             megakernel, path replay, film, progressive renderer
  diff/      material parameters as leaf tensors
  parallel/  train step and loop
  tools/     PNG IO, CLI
  csrc/      hand-written CUDA C++ kernels for Hopper (sm_90a), built at
             first use by :mod:`.kernels`

Nothing here imports JAX.
"""

__version__ = "0.1.0"
