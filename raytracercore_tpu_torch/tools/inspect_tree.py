"""Scene / BVH tree inspection (counterpart of
``raytracercore_tpu.tools.inspect_tree``) — the headless counterpart of the
reference's SceneInspector two-tab browser (Inspector/SceneInspector.cs:12-361)
and its Nodifier pretty-printer (Inspector/Nodifier.cs:13-237).  Host-side
numpy text formatting; the BVH's tensors are read on the CPU."""

from __future__ import annotations

from typing import List

import numpy as np

from ..bvh.builder import BVHArrays
from ..scene.types import (HostPlane, HostScene, HostSphere, HostTriangle)


def _fmt_vec(v) -> str:
    return "(" + ", ".join(f"{x:.4g}" for x in np.asarray(v)) + ")"


def _material_lines(m, indent: str) -> List[str]:
    out = []
    for name, val in (("emission", m.emission), ("diffuse", m.diffuse),
                      ("specular", m.specular), ("refraction", m.refraction)):
        if np.any(np.asarray(val) != 0):
            out.append(f"{indent}{name} = {_fmt_vec(val)}")
    if m.refractive_index:
        out.append(f"{indent}ior = {m.refractive_index:g}")
    out.append(f"{indent}shininess = {m.shininess:g}"
               f"  twosided = {m.two_sided}  invert = {m.invert}")
    return out


def describe_primitive(i: int, p) -> List[str]:
    """Primitive → text lines (the Properties lists of Primitive.cs:151-170,
    Triangle.cs:265-297, Sphere.cs:234-252, Plane.cs:73-84)."""
    if isinstance(p, HostTriangle):
        kind = "Quad" if p.mirror else "Triangle"
        head = (f"[{i}] {kind} v0={_fmt_vec(p.v0)} v1={_fmt_vec(p.v1)} "
                f"v2={_fmt_vec(p.v2)}"
                + (" smooth" if p.has_normals else ""))
    elif isinstance(p, HostSphere):
        head = (f"[{i}] Sphere center={_fmt_vec(p.center)} r={p.radius:g}"
                + (" transformed" if p.transformed else ""))
    elif isinstance(p, HostPlane):
        head = (f"[{i}] Plane n={_fmt_vec(p.normal)} "
                f"d={p.origin_distance:g}")
    else:
        head = f"[{i}] {type(p).__name__}"
    return [head] + _material_lines(p.material, "      ")


def scene_tree(scene: HostScene) -> str:
    """Text dump of the whole scene: globals, cameras, primitives."""
    lines = [
        f"Scene {scene.width}x{scene.height} recursion={scene.recursion}",
        f"  background = {_fmt_vec(scene.background_rgb)} "
        f"alpha={scene.background_alpha:g}",
        "  ambient = " + ("miss" if scene.ambient_rgb is None
                          else _fmt_vec(scene.ambient_rgb)),
    ]
    for ci, cam in enumerate(scene.cameras):
        lines.append(
            f"  camera[{ci}] {cam.mode} pos={_fmt_vec(cam.position)} "
            f"lookAt={_fmt_vec(cam.look_at)} focal={cam.focal_length:.4g}"
            + (f" dof={cam.dof_amount:g}@{cam.image_plane:g}"
               if cam.dof_amount else ""))
    lines.append(f"  primitives ({len(scene.primitives)}):")
    for i, p in enumerate(scene.primitives):
        lines.extend("    " + ln for ln in describe_primitive(i, p))
    return "\n".join(lines)


def bvh_tree(bvh: BVHArrays, max_depth: int = 32) -> str:
    """Text dump of the flattened BVH (the BVH tab,
    SceneInspector.cs:226-265): preorder walk reconstructed from skip
    links."""
    bmin, bmax, skip, slot, prims = (
        t.detach().cpu().numpy() for t in
        (bvh.bmin, bvh.bmax, bvh.skip, bvh.leaf_slot, bvh.leaf_prims))

    lines = []
    # Depth via an explicit stack of (escape_index, depth).
    stack = []
    depth = 0
    for i in range(len(skip)):
        while stack and i >= stack[-1]:
            stack.pop()
            depth -= 1
        box = f"[{_fmt_vec(bmin[i])} .. {_fmt_vec(bmax[i])}]"
        if slot[i] >= 0:
            tris = [int(t) for t in prims[slot[i]] if t >= 0]
            lines.append("  " * depth + f"leaf {box} tris={tris}")
        else:
            lines.append("  " * depth + f"node {box}")
            stack.append(skip[i])
            depth = min(depth + 1, max_depth)
    return "\n".join(lines)
