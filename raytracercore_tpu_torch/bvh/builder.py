"""Host-side BVH builder → flattened SoA arrays for device traversal
(counterpart of ``raytracercore_tpu.bvh.builder``; the numpy builder is a
copy, so its arrays equal the JAX package's exactly).

The reference builds its BVH agglomeratively bottom-up with a k-d tree +
min-heap of candidate pairs (Acceleration/BVH.cs:89-191, strategies selected
by size at :193-236).  The contract here is the *traversal result* — the
closest surviving hit — not the build algorithm, so the build is a top-down
binned-SAH split (numpy, vectorized) which flattens naturally into the
skip-link layout a stackless traversal wants:

* nodes stored in preorder; ``skip[i]`` = node to visit when the ray misses
  node ``i``'s box (or after finishing its leaf) — the "escape" index.
* a hit on an internal node falls through to ``i+1`` (its left child).
* leaves own up to ``leaf_size`` primitive slots in a dense [L, K] index
  matrix (padded with -1; the valid entries are a prefix).

The same skip-volume idea the reference uses (``MakeParent`` marking
redundant child AABBs, BVH.cs:44-48) is subsumed by the skip-link scheme.
"""

from __future__ import annotations

import dataclasses
import sys
import warnings
from collections.abc import Mapping

import numpy as np
import torch

from ..config import BVH_LEAF_SIZE
from ..core.device import DEFAULT_DEVICE, resolve_device
from ..scene.types import HostScene, SceneArrays, _Tensors

# "auto" takes the native builder from this many rows on: below, the numpy
# builder takes well under a second.
NATIVE_MIN_ROWS = 4096


@dataclasses.dataclass(frozen=True)
class BVHArrays(_Tensors):
    """Flattened skip-link BVH over the rows of one primitive table."""

    bmin: torch.Tensor        # [N, 3]
    bmax: torch.Tensor        # [N, 3]
    skip: torch.Tensor        # [N] int32 escape index; N ⇒ done
    leaf_slot: torch.Tensor   # [N] int32 row into leaf_prims, -1 for internal
    leaf_prims: torch.Tensor  # [L, K] int32 table rows, -1 pad

    @property
    def n_nodes(self) -> int:
        return self.bmin.shape[0]


def _arrays(bmin, bmax, skip, slot, prims, dtype, device) -> BVHArrays:
    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    def f(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return BVHArrays(bmin=f(bmin), bmax=f(bmax), skip=i32(skip),
                     leaf_slot=i32(slot), leaf_prims=i32(prims))


def bvh_arrays_from_numpy(d, device=DEFAULT_DEVICE,
                          dtype=torch.float32) -> BVHArrays:
    """Build a :class:`BVHArrays` from the JAX package's ``BVHArrays``
    fields given as numpy arrays (a mapping, or any object with those
    attributes), so that both packages can walk one tree."""
    device = resolve_device(device, "bvh_arrays_from_numpy")
    def get(name):
        return d[name] if isinstance(d, Mapping) else getattr(d, name)
    return _arrays(*(get(f.name) for f in dataclasses.fields(BVHArrays)),
                   dtype, device)


@dataclasses.dataclass
class _Node:
    bmin: np.ndarray
    bmax: np.ndarray
    left: "_Node | None" = None
    right: "_Node | None" = None
    prims: np.ndarray | None = None  # table rows for leaves


def triangle_bounds(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    mirror: np.ndarray):
    """Per-triangle AABBs; mirrored quads include the 4th corner
    (v0+e1+e2 — Triangle.GetMaxCenterDistance, Triangle.cs:237-241)."""
    v1 = v0 + e1
    v2 = v0 + e2
    v3 = v0 + e1 + e2
    corners = np.stack([v0, v1, v2, v3], axis=1)  # [T, 4, 3]
    # Non-mirrored triangles ignore the 4th corner.
    big = np.where(mirror[:, None, None], corners,
                   np.concatenate([corners[:, :3],
                                   corners[:, :1]], axis=1))
    return big.min(axis=1), big.max(axis=1)


def _build(idx, bmin, bmax, centers, leaf_size, n_bins=16):
    """Recursive binned-SAH split returning a _Node tree."""
    node_bmin = bmin[idx].min(axis=0)
    node_bmax = bmax[idx].max(axis=0)
    n = len(idx)
    if n <= leaf_size:
        return _Node(node_bmin, node_bmax, prims=idx)

    c = centers[idx]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    extent = cmax - cmin
    axis = int(np.argmax(extent))
    if extent[axis] <= 0:
        # All centers identical: split arbitrarily in half.
        half = n // 2
        return _Node(node_bmin, node_bmax,
                     left=_build(idx[:half], bmin, bmax, centers, leaf_size),
                     right=_build(idx[half:], bmin, bmax, centers, leaf_size))

    # Binned SAH along the widest axis.
    rel = (c[:, axis] - cmin[axis]) / extent[axis]
    bins = np.minimum((rel * n_bins).astype(np.int32), n_bins - 1)

    def area(lo, hi):
        d = np.maximum(hi - lo, 0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    best_cost, best_split = np.inf, None
    for split in range(1, n_bins):
        lmask = bins < split
        nl = int(lmask.sum())
        nr = n - nl
        if nl == 0 or nr == 0:
            continue
        l_lo = bmin[idx[lmask]].min(axis=0)
        l_hi = bmax[idx[lmask]].max(axis=0)
        r_lo = bmin[idx[~lmask]].min(axis=0)
        r_hi = bmax[idx[~lmask]].max(axis=0)
        cost = area(l_lo, l_hi) * nl + area(r_lo, r_hi) * nr
        if cost < best_cost:
            best_cost, best_split = cost, split

    if best_split is None:
        half = n // 2
        order = np.argsort(c[:, axis], kind="stable")
        l_idx, r_idx = idx[order[:half]], idx[order[half:]]
    else:
        lmask = bins < best_split
        l_idx, r_idx = idx[lmask], idx[~lmask]

    return _Node(node_bmin, node_bmax,
                 left=_build(l_idx, bmin, bmax, centers, leaf_size),
                 right=_build(r_idx, bmin, bmax, centers, leaf_size))


def build_boxes_bvh(bmin: np.ndarray, bmax: np.ndarray, valid: np.ndarray,
                    leaf_size: int = BVH_LEAF_SIZE, dtype=torch.float32,
                    backend: str = "auto",
                    device=DEFAULT_DEVICE) -> BVHArrays:
    """Build a skip-link BVH over arbitrary per-row AABBs.

    Generic core shared by the triangle and sphere builders (the reference
    bounds every primitive type through IBoundedObject, Scene.cs:39-49);
    ``leaf_prims`` index the rows of the given box arrays.

    ``backend``: "numpy" (the reference implementation below), "native"
    (the C++ builder ``csrc/bvh_builder.cpp`` — same layout, built for
    million-triangle scenes; raises ``RuntimeError`` when it cannot be
    built), or "auto" (native from ``NATIVE_MIN_ROWS`` rows on when it can
    be built, else numpy).
    """
    device = resolve_device(device, "build_boxes_bvh")
    if backend not in ("auto", "numpy", "native"):
        raise ValueError(f"build_boxes_bvh: unknown backend {backend!r}")
    row_idx = np.nonzero(valid)[0]
    if len(row_idx) == 0:
        return _arrays(np.zeros((1, 3)), np.zeros((1, 3)), [1], [-1],
                       np.full((1, leaf_size), -1), dtype, device)

    if backend == "native" or (backend == "auto"
                               and len(row_idx) >= NATIVE_MIN_ROWS):
        from .native import build_bvh_native

        try:
            out = build_bvh_native(np.asarray(bmin[row_idx], np.float32),
                                   np.asarray(bmax[row_idx], np.float32),
                                   leaf_size)
        except RuntimeError as e:
            if backend == "native":
                raise RuntimeError(
                    f"native BVH builder unavailable: {e}") from e
            # "auto": the numpy builder below builds the same layout, slowly.
            warnings.warn(f"native BVH builder unavailable ({e}); building "
                          f"{len(row_idx)} rows with the numpy builder",
                          RuntimeWarning, stacklevel=2)
            out = None
        if out is not None:
            nb_min, nb_max, skip, slot, prims = out
            # Leaf entries index the valid subset — map back to table rows.
            mapped = np.where(prims >= 0, row_idx[np.maximum(prims, 0)], -1)
            return _arrays(nb_min, nb_max, skip, slot, mapped, dtype, device)

    centers = (bmin + bmax) / 2.0
    root = _build(row_idx, bmin, bmax, centers, leaf_size)

    # Preorder flatten with escape links.
    nodes_bmin, nodes_bmax, skips, leaf_slots = [], [], [], []
    leaf_rows = []

    def emit(node: _Node) -> None:
        """Append node; fix its skip afterwards (escape = index after the
        whole subtree)."""
        i = len(nodes_bmin)
        nodes_bmin.append(node.bmin)
        nodes_bmax.append(node.bmax)
        skips.append(-1)       # patched below
        if node.prims is not None:
            leaf_slots.append(len(leaf_rows))
            row = np.full(leaf_size, -1, np.int64)
            row[: len(node.prims)] = node.prims
            leaf_rows.append(row)
        else:
            leaf_slots.append(-1)
            emit(node.left)
            emit(node.right)
        skips[i] = len(nodes_bmin)  # escape = first index past the subtree

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * len(row_idx)))
    try:
        emit(root)
    finally:
        sys.setrecursionlimit(old_limit)

    return _arrays(np.stack(nodes_bmin), np.stack(nodes_bmax),
                   np.array(skips), np.array(leaf_slots),
                   np.stack(leaf_rows), dtype, device)


def build_triangle_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                       mirror: np.ndarray, valid: np.ndarray,
                       leaf_size: int = BVH_LEAF_SIZE, dtype=torch.float32,
                       backend: str = "auto",
                       device=DEFAULT_DEVICE) -> BVHArrays:
    """Build a skip-link BVH over the valid rows of a triangle table."""
    bmin, bmax = triangle_bounds(v0, e1, e2, mirror)
    return build_boxes_bvh(bmin, bmax, valid, leaf_size, dtype, backend,
                           device)


def sphere_bounds(center: np.ndarray, radius: np.ndarray):
    """AABBs of untransformed spheres: center ± radius (the reference's
    GetMaxCenterDistance sampling degenerates to this for plain spheres,
    Sphere.cs:220-232 / AABB.cs:22-36)."""
    r = radius[:, None]
    return center - r, center + r


def ellipsoid_bounds(center: np.ndarray, radius: np.ndarray,
                     obj_to_world: np.ndarray):
    """Exact world-space AABBs of transformed spheres (ellipsoids).

    The reference bounds every primitive type into its BVH via
    IBoundedObject (Scene.cs:39-49); for spheres it samples
    GetMaxCenterDistance through the transform (Sphere.cs:220-232,
    AABB.cs:22-36).  The closed form: the world AABB of the affine image
    of a sphere has center ``M·c`` and per-axis half-extent
    ``r · ||row_i(M_linear)||``."""
    lin = np.asarray(obj_to_world, np.float64)[:, :3, :3]   # [S, 3, 3]
    trans = np.asarray(obj_to_world, np.float64)[:, :3, 3]
    c = np.asarray(center, np.float64)
    r = np.asarray(radius, np.float64)
    wc = np.einsum("sij,sj->si", lin, c) + trans
    half = r[:, None] * np.linalg.norm(lin, axis=2)         # rows of M
    return (wc - half).astype(np.float32), (wc + half).astype(np.float32)


def build_ellipsoid_bvh(center: np.ndarray, radius: np.ndarray,
                        obj_to_world: np.ndarray, valid: np.ndarray,
                        leaf_size: int = BVH_LEAF_SIZE, dtype=torch.float32,
                        backend: str = "auto",
                        device=DEFAULT_DEVICE) -> BVHArrays:
    """Skip-link BVH over TRANSFORMED spheres (leaf_prims = sphere-table
    rows); the kernel leaf test runs the full object-space quadratic with
    the matrices packed into the leaf record
    (``cuda_traverse.pack_leaf_ellipsoids``)."""
    bmin, bmax = ellipsoid_bounds(center, radius, obj_to_world)
    return build_boxes_bvh(bmin, bmax, valid, leaf_size, dtype, backend,
                           device)


def build_sphere_bvh(center: np.ndarray, radius: np.ndarray,
                     valid: np.ndarray, leaf_size: int = BVH_LEAF_SIZE,
                     dtype=torch.float32, backend: str = "auto",
                     device=DEFAULT_DEVICE) -> BVHArrays:
    """Skip-link BVH over untransformed spheres (leaf_prims = sphere-table
    rows); its leaf test is the plain-sphere quadratic."""
    bmin, bmax = sphere_bounds(center, radius)
    return build_boxes_bvh(bmin, bmax, valid, leaf_size, dtype, backend,
                           device)


def build_bvh(scene: HostScene | SceneArrays, leaf_size: int | None = None,
              dtype=torch.float32, backend: str = "auto") -> BVHArrays:
    """Build the triangle BVH of a :class:`HostScene` or of frozen
    :class:`SceneArrays` (sphere tables get their own BVHs in
    ``dispatch.make_bvh_closest_fn``; planes stay a scan).  The tree lives
    on the CPU: the traversal's packers read it with numpy.

    ``leaf_size=None`` → ``config.BVH_LEAF_SIZE``."""
    if leaf_size is None:
        leaf_size = BVH_LEAF_SIZE
    if isinstance(scene, SceneArrays):
        tri = scene.triangles
        v0, e1, e2, mirror, prim_id = (
            t.detach().cpu().numpy() for t in
            (tri.v0, tri.e1, tri.e2, tri.mirror, tri.prim_id))
        return build_triangle_bvh(v0, e1, e2, mirror, prim_id >= 0,
                                  leaf_size, dtype, backend, device="cpu")
    tris = scene.triangles
    if not tris:
        return build_triangle_bvh(np.zeros((0, 3)), np.zeros((0, 3)),
                                  np.zeros((0, 3)), np.zeros(0, bool),
                                  np.zeros(0, bool), leaf_size, dtype,
                                  backend, device="cpu")
    v0 = np.stack([t.v0 for t in tris])
    e1 = np.stack([t.edge01 for t in tris])
    e2 = np.stack([t.edge02 for t in tris])
    mirror = np.array([t.mirror for t in tris], bool)
    valid = np.ones(len(tris), bool)
    return build_triangle_bvh(v0, e1, e2, mirror, valid, leaf_size, dtype,
                              backend, device="cpu")
