"""Debug/observability views (counterpart of
``raytracercore_tpu.tools.debug``) — the reference's DebugRaycaster overlay
modes and RayInspector per-pixel bounce traces, as host-side images and
text over device queries.

* :func:`primitive_id_map` — one ray per pixel, primitive id → 7-colour
  rotation (DebugRaycaster Primitives mode, DebugRaycaster.cs:193-199,
  80-89).
* :func:`bvh_heatmap` — per-pixel count of BVH nodes whose AABB the ray
  enters, as a white heat map (BoundingVolumes mode,
  DebugRaycaster.cs:200-212).
* :func:`selection_map` — only one primitive or one BVH node (Selection
  mode, DebugRaycaster.cs:21-78).
* :func:`trace_pixel` — bounce listings of a few paths through one pixel
  (RayInspector.RunTraces, Inspector/RayInspector.cs:139-155), through the
  integrator's own loop body.

Every view takes ``device`` (the card by default).  The closest hit is
the one :class:`..render.renderer.Renderer` would use with the same
``accelerator`` (:func:`..render.renderer.pick_route`): with "auto", the
select kernel up to ``config.SELECT_MAX_PRIMS`` table rows, the BVH
traversal kernel above; on CPU tensors their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..bvh.builder import build_bvh
from ..bvh.traverse import count_node_hits
from ..core.device import resolve_device
from ..intersect.torch_ref import aabb_slab
from ..render import camera as cam_mod
from ..render.integrator import BounceType, trace
from ..render.renderer import pass_draws, pick_route
from ..scene.types import SceneArrays, freeze_scene, init_camera

# 7 distinct overlay colours (the reference rotates 7 hard-coded colours,
# DebugRaycaster.cs:80-89).
_ID_COLORS = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240]], dtype=np.uint8)

# Rays x nodes of one chunk of the dense heat-map count.
_HEATMAP_CELLS = 1 << 22


def _frozen(scene, device, cameras):
    """``(SceneArrays on device, host cameras)`` of a loaded
    :class:`HostScene`, or of frozen :class:`SceneArrays` (as
    :mod:`..scene.meshgen` makes them) with their ``cameras``."""
    if isinstance(scene, SceneArrays):
        if not cameras:
            raise ValueError("debug views: frozen SceneArrays come with "
                             "their cameras=[HostCamera, ...]")
        return scene.to(device), list(cameras)
    return freeze_scene(scene, device=device), scene.cameras


def _center_rays(arrays, cameras, camera_index: int, device):
    cam = init_camera(cameras[camera_index], arrays.width, arrays.height,
                      device=device)
    px, py = cam_mod.pixel_grid(arrays.width, arrays.height, device=device)
    # Pixel centres, no jitter/DoF (DebugRaycaster casts plain rays).
    o, d = cam_mod.center_rays(cam, px, py)
    return o.contiguous(), d.contiguous()


def _first_hit_prims(arrays, o, d, accelerator) -> np.ndarray:
    closest_fn = pick_route(arrays, accelerator)[0]
    with torch.no_grad():
        prim = closest_fn(arrays, o, d, None).prim
    return prim.cpu().numpy().reshape(arrays.height, arrays.width)


def primitive_ids(scene, camera_index: int = 0, device="cuda",
                  accelerator: str = "auto", cameras=None) -> np.ndarray:
    """[H, W] int32 primitive id of each pixel centre's first hit (-1:
    miss).  ``scene``: a :class:`HostScene`, or :class:`SceneArrays` with
    their host ``cameras``."""
    device = resolve_device(device, "primitive_ids")
    arrays, cameras = _frozen(scene, device, cameras)
    o, d = _center_rays(arrays, cameras, camera_index, device)
    return _first_hit_prims(arrays, o, d, accelerator)


def primitive_id_map(scene, camera_index: int = 0, device="cuda",
                     accelerator: str = "auto", cameras=None) -> np.ndarray:
    """[H, W, 3] uint8 primitive-id false-colour image; misses are black."""
    prim = primitive_ids(scene, camera_index, device, accelerator, cameras)
    img = _ID_COLORS[prim % len(_ID_COLORS)]
    img[prim < 0] = 0
    return img


def node_hit_counts(bvh, o, d) -> torch.Tensor:
    """:func:`..bvh.traverse.count_node_hits` over the rays in chunks, so
    that the dense ``[rays x nodes]`` test stays within a few MB."""
    step = max(1, _HEATMAP_CELLS // max(bvh.n_nodes, 1))
    return torch.cat([count_node_hits(bvh, o[i:i + step], d[i:i + step])
                      for i in range(0, o.shape[0], step)])


def bvh_hit_counts(scene, camera_index: int = 0, bvh=None, device="cuda",
                   cameras=None) -> np.ndarray:
    """[H, W] count of BVH nodes whose AABB each pixel centre's ray
    enters (BVH.GetIntersectionCount, BVH.cs:352-363); ``bvh`` defaults
    to the scene's triangle BVH."""
    device = resolve_device(device, "bvh_hit_counts")
    arrays, cameras = _frozen(scene, device, cameras)
    if bvh is None:
        bvh = build_bvh(arrays)
    o, d = _center_rays(arrays, cameras, camera_index, device)
    return node_hit_counts(bvh.to(device), o, d).cpu().numpy().reshape(
        arrays.height, arrays.width)


def bvh_heatmap(scene, camera_index: int = 0, bvh=None, device="cuda",
                cameras=None) -> np.ndarray:
    """[H, W, 3] uint8 white heat map of :func:`bvh_hit_counts`,
    normalized by the maximum (DebugRaycaster.cs:200-212, 246-249)."""
    counts = bvh_hit_counts(scene, camera_index, bvh, device, cameras)
    peak = max(counts.max(), 1)
    v = (counts / peak * 255).astype(np.uint8)
    return np.stack([v, v, v], axis=-1)


def selection_map(scene, selection: str, camera_index: int = 0, bvh=None,
                  device="cuda", accelerator: str = "auto", cameras=None
                  ) -> np.ndarray:
    """[H, W, 4] uint8 overlay of ONLY the selected primitive or BVH node —
    the DebugRaycaster Selection mode (DebugRaycaster.cs:21-78, 138-161).

    ``selection``: "prim:<id>" (global primitive id; drawn in that id's
    rotation colour) or "node:<index>" (preorder BVH node index; its AABB
    drawn white).  Alpha 255 where the ray hits the selection, 0 elsewhere.
    """
    kind, _, val = selection.partition(":")
    idx = int(val)
    device = resolve_device(device, "selection_map")
    arrays, cameras = _frozen(scene, device, cameras)
    o, d = _center_rays(arrays, cameras, camera_index, device)
    out = np.zeros((arrays.height, arrays.width, 4), np.uint8)

    if kind == "prim":
        # Every other primitive row becomes padding (-1), so the query
        # intersects ONLY the selected primitive (DebugRaycaster.cs:21-47).
        # A new scene object: the packed tables are built for it.
        def only(tbl):
            return dataclasses.replace(tbl, prim_id=torch.where(
                tbl.prim_id == idx, tbl.prim_id, -1))
        arrays = dataclasses.replace(
            arrays, triangles=only(arrays.triangles),
            spheres=only(arrays.spheres), planes=only(arrays.planes))
        mask = _first_hit_prims(arrays, o, d, accelerator) == idx
        out[mask, :3] = _ID_COLORS[idx % len(_ID_COLORS)]
        out[mask, 3] = 255
    elif kind == "node":
        if bvh is None:
            bvh = build_bvh(arrays)
        if not 0 <= idx < bvh.n_nodes:
            raise ValueError(f"node {idx} out of range (0..{bvh.n_nodes-1})")
        box = bvh.to(device)
        near, far = aabb_slab(box.bmin[idx:idx + 1], box.bmax[idx:idx + 1],
                              o, d)
        mask = ((near <= far) & (far >= 0))[:, 0].cpu().numpy()
        out[mask.reshape(arrays.height, arrays.width)] = 255
    else:
        raise ValueError(f"selection must be prim:<id> or node:<i>, "
                         f"got {selection!r}")
    return out


def trace_pixel(scene, x: int, y: int, camera_index: int = 0,
                n_traces: int = 4, seed: int = 0, device="cuda",
                accelerator: str = "auto", jitter=None, uniforms=None,
                cameras=None) -> List[List[str]]:
    """Human-readable bounce listings for one pixel (the RayInspector view).

    Each trace has its own sub-pixel jitter and path randomness, like N
    clicks of the reference inspector: drawn from ``seed`` unless
    ``jitter`` [n_traces, 4] and ``uniforms`` [B, 7, n_traces] are given.
    """
    device = resolve_device(device, "trace_pixel")
    arrays, cameras = _frozen(scene, device, cameras)
    cam = init_camera(cameras[camera_index], arrays.width, arrays.height,
                      device=device)
    if jitter is None or uniforms is None:
        jitter, uniforms = pass_draws(seed, 0, n_traces,
                                      arrays.recursion + 1, device)
    px = torch.full((n_traces,), x, dtype=torch.int32, device=device)
    py = torch.full((n_traces,), y, dtype=torch.int32, device=device)
    o, d = cam_mod.camera_rays(cam, px, py, jitter.to(device))
    with torch.no_grad():
        color, miss, rec = trace(arrays, o.contiguous(), d.contiguous(), None,
                                 closest_fn=pick_route(arrays, accelerator)[0],
                                 record=True, uniforms=uniforms.to(device))

    btype, prim, t, pos, inside, fresnel, color, miss = (
        a.cpu().numpy() for a in (rec.btype, rec.prim, rec.t, rec.position,
                                  rec.inside, rec.fresnel, color, miss))
    out: List[List[str]] = []
    for r in range(n_traces):
        lines = []
        for b in range(btype.shape[1]):
            bt = int(btype[r, b])
            if bt == BounceType.SKIPPED:
                break
            desc = BounceType.NAMES[bt]
            if prim[r, b] >= 0:
                p = pos[r, b]
                desc += (f" prim={int(prim[r, b])} t={t[r, b]:.5g}"
                         f" pos=({p[0]:.4g},{p[1]:.4g},{p[2]:.4g})"
                         f" inside={bool(inside[r, b])}")
            if np.isfinite(fresnel[r, b]):
                desc += f" fresnel={fresnel[r, b]:.4f}"
            lines.append(desc)
        c = color[r]
        lines.append(f"color=({c[0]:.5g},{c[1]:.5g},{c[2]:.5g})"
                     f" miss={bool(miss[r])}")
        out.append(lines)
    return out
