"""Central runtime configuration (counterpart of ``raytracercore_tpu.config``).

Only the knobs the port's paths read are carried over.
"""

from __future__ import annotations

# Scenes with at most this many primitive table rows (triangles + spheres +
# planes, padding rows included) run through the whole-path megakernel
# (render/fused.py).  Kept equal to the JAX package's cap so both packages
# route the same scenes the same way; larger scenes go bounce by bounce
# through the select kernel (intersect/cuda_select.py).
FUSED_MAX_PRIMS = 64

# Keep the scalar triangle test's coplanar ray-in-plane branch in the
# megakernel?  False matches the reference's production (AVX) tier and the
# JAX megakernel's setting; det == 0 exactly is measure-zero under
# jittered camera rays.
FUSED_COPLANAR_BRANCH = False

# Table-row cap of the per-bounce select kernel (csrc/select.cu), which
# keeps every row in a block's shared memory, in its own layout
# (intersect/cuda_select.py: pack_select_tables): a triangle 4 float4 =
# 64 B (its smooth normals stay in device memory), a sphere 8 float4 =
# 128 B, a plane 2 float4 = 32 B.  An H100 block may take 227 KB
# (232,448 B) of dynamic shared memory; 768 rows are at most 768 * 128 B =
# 96 KB (all spheres), so the two blocks per SM that the kernel's registers
# allow always fit (2 * 96 KB <= 227 KB); a 768-row triangle table takes
# 48 KB.  768 is also the JAX package's cap, so both packages route the
# same scenes alike.
SELECT_MAX_PRIMS = 768

# Where the integrator parks a finished path: origin (4e8, 4e8, 4e8), far
# outside any scene, pointing +x (raytracercore_tpu/render/integrator.py
# parks at the same point).  The select kernel reads a ray whose origin is
# this point in all three coordinates as a dead lane and gives it the
# no-hit record without a scan (intersect/cuda_select.py).  4e8 is exact in
# f32.
PARKED_ORIGIN = 4e8

# Primitive slots per BVH leaf (bvh/builder.py) when the caller names none.
# One thread walks one ray (csrc/traverse.cu), so a leaf costs a thread its
# records one after another and small leaves win: on the 184,322-triangle
# mesh at 512x512, five bounces of the kernel took 1.639 / 1.630 / 1.718 /
# 1.917 / 2.431 / 3.596 ms at leaf sizes 1 / 2 / 3 / 4 / 8 / 16 (NVIDIA H100
# 80GB HBM3, 700.00 W; chip_smoke.py times them in turn; PERF.md section 6).
BVH_LEAF_SIZE = 2

# make_bvh_closest_fn gives the untransformed spheres, and the transformed
# ones, a BVH of their own from this many rows on (as the JAX package does);
# fewer stay with the planes in the dense tail, which the select kernel
# scans.
SPHERE_BVH_MIN_ROWS = 256
