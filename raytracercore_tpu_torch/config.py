"""Central runtime configuration (counterpart of ``raytracercore_tpu.config``).

Only the knobs the forward render path reads are carried over.
"""

from __future__ import annotations

# Scenes with at most this many primitive table rows (triangles + spheres +
# planes, padding rows included) run through the whole-path megakernel
# (render/fused.py).  Kept equal to the JAX package's cap so both packages
# route the same scenes the same way; larger scenes need the per-bounce
# select kernel or the BVH, which this package does not have yet.
FUSED_MAX_PRIMS = 64

# Keep the scalar triangle test's coplanar ray-in-plane branch in the
# megakernel?  False matches the reference's production (AVX) tier and the
# JAX megakernel's setting; det == 0 exactly is measure-zero under
# jittered camera rays.
FUSED_COPLANAR_BRANCH = False
