"""A scene's numpy tables and camera as tensors for the plain reference.

``load`` rounds the float64 tables to ``dtype`` in one step (float32 for
the reference, bfloat16 for the control) and splits every table into
``[N]`` columns, the operands of :mod:`rtbench.reference.tracer`'s grid
tests.  ``camera`` is a frozen copy of ``init_camera``
(``raytracercore_tpu_torch/scene/types.py`` at commit 25c2873) for the
frustum camera the benchmark's scenes use.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Scene:
    tri: dict          # [T] columns: v0 e1 e2 n fn0..2 (x y z), flags
    sph: dict          # [S] columns: w2o, o2w (12 each), center, radius
    pln: dict          # [P] columns: n (3), dist
    mats: dict         # [N] material columns (float) and flags (bool)
    ambient: tuple
    air: torch.Tensor
    background: torch.Tensor
    background_alpha: torch.Tensor
    width: int
    height: int
    recursion: int
    ambient_is_miss: bool
    n_tri: int         # triangle rows in use (prim_id >= 0)


def load(tables: dict, device, dtype=torch.float32) -> Scene:
    def f(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    def b(a):
        return torch.tensor(np.asarray(a, bool), device=device)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    mats = tables["materials"]
    invert = np.asarray(mats["invert"], bool)
    two_sided = np.asarray(mats["two_sided"], bool)

    def flags(prim_id):
        safe = np.maximum(np.asarray(prim_id), 0)
        return {"prim": i32(prim_id), "invert": b(invert[safe]),
                "two_sided": b(two_sided[safe])}

    t = tables["triangles"]
    tri = flags(t["prim_id"])
    for key in ("v0", "e1", "e2", "normal", "n0", "n1", "n2"):
        cols = np.asarray(t[key], np.float64)
        for k, axis in enumerate("xyz"):
            tri[key + axis] = f(cols[:, k])
    tri["mirror"] = b(t["mirror"])
    tri["smooth"] = b(t["smooth"])

    s = tables["spheres"]
    sph = flags(s["prim_id"])
    w2o = np.asarray(s["world_to_obj"], np.float64)[:, :3, :].reshape(-1, 12)
    o2w = np.asarray(s["obj_to_world"], np.float64)[:, :3, :].reshape(-1, 12)
    for k in range(12):
        sph[f"w{k}"] = f(w2o[:, k])
        sph[f"o{k}"] = f(o2w[:, k])
    center = np.asarray(s["center"], np.float64)
    for k, axis in enumerate("xyz"):
        sph["c" + axis] = f(center[:, k])
    sph["radius"] = f(s["radius"])

    p = tables["planes"]
    pln = flags(p["prim_id"])
    normal = np.asarray(p["normal"], np.float64)
    for k, axis in enumerate("xyz"):
        pln["n" + axis] = f(normal[:, k])
    pln["dist"] = f(p["origin_dist"])

    matd = {key: f(mats[key]) for key in (
        "emission", "diffuse", "specular", "refraction", "refractive_index",
        "shininess")}
    ambient = f(tables["ambient_rgb"])
    return Scene(
        tri=tri, sph=sph, pln=pln, mats=matd,
        ambient=tuple(ambient[k] for k in range(3)),
        air=f(tables["air_refractive_index"]),
        background=f(tables["background_rgb"]),
        background_alpha=f(tables["background_alpha"]),
        width=int(tables["width"]), height=int(tables["height"]),
        recursion=int(tables["recursion"]),
        ambient_is_miss=bool(tables["ambient_is_miss"]),
        n_tri=int((np.asarray(t["prim_id"]) >= 0).sum()))


def camera(cam: dict, width: int, height: int, device,
           dtype=torch.float32) -> dict:
    """The render basis of a frustum camera (Camera.InitRender)."""
    if cam.get("dof_amount", 0.0) != 0.0:
        raise ValueError("the reference carries no depth of field")
    pos = np.asarray(cam["position"], np.float64)
    look = np.asarray(cam["look_at"], np.float64) - pos
    look = look / np.linalg.norm(look)
    side = np.cross(look, -np.asarray(cam["up"], np.float64))
    side = side / np.linalg.norm(side)
    up = np.cross(look, side)
    up = up / np.linalg.norm(up)
    side = -side
    tan_y = np.tan(cam["fov"] / 2.0)

    def f(x):
        return torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                            device=device)
    return {"position": f(pos), "look": f(look), "side": f(side),
            "up": f(up), "w2": f(width / 2.0), "h2": f(height / 2.0),
            "ax": f(tan_y * (width / float(height))), "ay": f(-tan_y),
            "image_plane": f(cam.get("image_plane", 0.0))}
