"""The reference's scene text format parsed into numpy tables.

A frozen copy of the parse and freeze of ``raytracercore_tpu_torch``
(``scene/loader.py``, ``scene/objects.py``, ``scene/transforms.py`` and
``scene/types.py`` ``freeze_scene`` / ``init_camera`` at commit 25c2873),
cut to the commands a scene of the benchmark uses and ending in plain numpy
arrays: the benchmark works the scene's tables out again from the text
instead of taking the program's.  All host math is float64, as in the
original, so the tables round to float32 in one step where they are used.

:func:`parse` returns ``(tables, cameras)``: ``tables`` the dict
:func:`rtbench.reference.tables.load` reads, ``cameras`` one dict per
``camera`` command.
"""

from __future__ import annotations

import math

import numpy as np

AIR_REFRACTIVE_INDEX = 1.000293

# Cube side bits (Cube.cs:12-20).
X_POS, X_NEG, Y_POS, Y_NEG, Z_POS, Z_NEG = 1, 2, 4, 8, 16, 32
ALL_SIDES = 63
_SIDE_BY_AXIS = {"x": (X_POS, X_NEG), "y": (Y_POS, Y_NEG),
                 "z": (Z_POS, Z_NEG)}


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y, z):
    return np.diag([x, y, z, 1.0])


def _rotate(angle, axis):
    x, y, z = (float(a) for a in axis)
    c, s = np.cos(angle), np.sin(angle)
    oc = 1.0 - c
    m = np.eye(4)
    m[:3, :3] = np.array([
        [c + x * x * oc, x * y * oc - z * s, x * z * oc + y * s],
        [y * x * oc + z * s, c + y * y * oc, y * z * oc - x * s],
        [z * x * oc - y * s, z * y * oc + x * s, c + z * z * oc]])
    return m


def _point(m, p):
    return m[:3, :3] @ np.asarray(p, np.float64) + m[:3, 3]


def _side(name):
    if name == "implicit":
        return 0
    if name == "all":
        return ALL_SIDES
    if len(name) == 2 and name[0] == "-" and name[1] in _SIDE_BY_AXIS:
        return _SIDE_BY_AXIS[name[1]][1]
    axis = name[1] if len(name) == 2 and name[0] == "+" else name
    if axis in _SIDE_BY_AXIS:
        return _SIDE_BY_AXIS[axis][0]
    raise ValueError(f"unknown cube side {name!r}")


def _rectangle(origin, up, normal, width, height):
    """Triangle.CreateRectangle: a mirrored quad as ``(v0, v1, v2)``."""
    up = np.asarray(up, np.float64)
    up = up / np.linalg.norm(up)
    side = np.cross(up, normal)
    side = side / np.linalg.norm(side)
    v0 = origin + up * (-height / 2.0) + side * (-width / 2.0)
    return v0, v0 + side * width, v0 + up * height


def _cube_sides(pos, size, sides):
    sx, sy, sz = size
    out = []
    for bit, up, norm, dist, w, h in (
            (X_POS, (0, 0, 1), (1, 0, 0), sx, sy, sz),
            (X_NEG, (0, 0, -1), (-1, 0, 0), sx, sy, sz),
            (Y_POS, (0, 0, 1), (0, 1, 0), sy, sx, sz),
            (Y_NEG, (0, 0, -1), (0, -1, 0), sy, sx, sz),
            (Z_POS, (0, 1, 0), (0, 0, 1), sz, sx, sy),
            (Z_NEG, (0, -1, 0), (0, 0, -1), sz, sx, sy)):
        if sides & bit:
            norm = np.asarray(norm, np.float64)
            out.append(("tri", _rectangle(pos + norm * (dist / 2.0), up,
                                          norm, w, h)))
    return out


def parse(text: str):
    """``(tables, cameras)`` of a scene text; raises ``ValueError`` on a
    command this copy does not carry."""
    size = [0, 0]
    background, background_alpha = np.zeros(3), 0.0
    ambient = np.zeros(3)
    recursion = 3
    cameras = []
    two_sided, invert = True, False
    emission = diffuse = specular = refraction = None
    shininess, refraction_index = -1.0, -1.0
    stack, inv_stack = [np.eye(4)], [np.eye(4)]
    cube = None
    prims = []  # (kind, geometry, material, forward, inverse)

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].replace(",", " ").split()
        if not line:
            continue
        cmd, args = line[0].lower(), line[1:]
        nums = [float(a) for a in args if _is_number(a)]
        new = []
        if cmd == "size":
            size = [int(args[0]), int(args[1])]
        elif cmd == "background":
            background, background_alpha = np.array(nums[:3]), nums[3]
        elif cmd == "ambient":
            if args[0] == "miss":
                ambient = None
            else:
                ambient = np.array(nums[:3])
        elif cmd in ("recursion", "bounce"):
            recursion = int(args[0])
        elif cmd == "camera":
            pos, look_at = np.array(nums[0:3]), np.array(nums[3:6])
            up = _point(stack[-1], np.array(nums[6:9]) + pos)
            pos = _point(stack[-1], pos)
            cameras.append({
                "position": pos, "look_at": look_at, "up": up - pos,
                "fov": math.radians(nums[9]), "image_plane": 0.0,
                "dof_amount": 0.0,
                "focal_length": float(np.linalg.norm(look_at - pos))})
        elif cmd == "twosided":
            two_sided = args[0] in ("1", "true", "yes", "y")
        elif cmd == "invert":
            invert = args[0] in ("1", "true", "yes", "y")
        elif cmd == "emission":
            emission = np.array(nums[:3])
        elif cmd == "diffuse":
            diffuse = np.array(nums[:3])
        elif cmd == "specular":
            specular = np.array(nums[:3])
        elif cmd == "shininess":
            shininess = nums[0] ** nums[1] if len(nums) > 1 else nums[0]
        elif cmd == "refraction":
            if args[0] == "off":
                refraction, refraction_index = None, -1.0
            else:
                refraction, refraction_index = np.array(nums[:3]), nums[3]
        elif cmd == "translate":
            stack[-1] = stack[-1] @ _translate(*nums[:3])
            inv_stack[-1] = _translate(*(-x for x in nums[:3])) @ inv_stack[-1]
        elif cmd == "scale":
            stack[-1] = stack[-1] @ _scale(*nums[:3])
            inv_stack[-1] = _scale(*(1.0 / x for x in nums[:3])) @ inv_stack[-1]
        elif cmd == "rotate":
            axis = np.array(nums[:3])
            axis = axis / np.linalg.norm(axis)
            angle = math.radians(nums[3])
            stack[-1] = stack[-1] @ _rotate(angle, axis)
            inv_stack[-1] = _rotate(-angle, axis) @ inv_stack[-1]
        elif cmd == "pushtransform":
            stack.append(stack[-1].copy())
            inv_stack.append(inv_stack[-1].copy())
        elif cmd == "poptransform":
            stack.pop()
            inv_stack.pop()
        elif cmd == "sphere":
            new.append(("sphere", (np.array(nums[:3]), nums[3])))
        elif cmd == "plane":
            normal = np.array(nums[1:4])
            new.append(("plane", (normal / np.linalg.norm(normal), nums[0])))
        elif cmd == "cube":
            cube = (np.array(nums[0:3]), np.array(nums[3:6]))
            opts = [a for a in args if not _is_number(a)]
            if opts:
                if opts[0] == "all":
                    sides = ALL_SIDES
                elif opts[0] == "only":
                    sides = 0
                    for name in opts[1:]:
                        sides |= _side(name)
                elif opts[0] == "not":
                    sides = ALL_SIDES
                    for name in opts[1:]:
                        sides &= ~_side(name)
                else:
                    raise ValueError(f"unknown cube option {opts[0]!r}")
                new.extend(_cube_sides(*cube, sides))
        elif cmd == "instance":
            for name in args:
                new.extend(_cube_sides(*cube, _side(name)))
        else:
            raise ValueError(f"scene command {cmd!r} is not carried")
        for kind, geo in new:
            mat = {"emission": np.zeros(3), "diffuse": np.zeros(3),
                   "specular": np.zeros(3), "refraction": np.zeros(3),
                   "ior": 0.0, "shininess": 100.0,
                   "two_sided": two_sided, "invert": invert}
            for key, val in (("emission", emission), ("diffuse", diffuse),
                             ("specular", specular)):
                if val is not None:
                    mat[key] = val.copy()
            if shininess != -1.0:
                mat["shininess"] = shininess
            if refraction is not None:
                mat["refraction"] = refraction.copy()
                mat["ior"] = refraction_index
            prims.append((kind, geo, mat, stack[-1].copy(),
                          inv_stack[-1].copy()))

    tables = _freeze(prims)
    tables.update(
        width=size[0], height=size[1], recursion=recursion,
        background_rgb=background, background_alpha=background_alpha,
        ambient_rgb=np.zeros(3) if ambient is None else ambient,
        ambient_is_miss=ambient is None,
        air_refractive_index=AIR_REFRACTIVE_INDEX)
    return tables, cameras


def _is_number(tok):
    try:
        float(tok)
    except ValueError:
        return False
    return True


def _freeze(prims):
    """The SoA tables of ``prims`` in primitive-id order, with the
    ``IsReflective`` gating (shininess > 0) baked in, and one masked row
    for an empty table."""
    n = len(prims)
    mat = {k: np.array([p[2][k] for p in prims]) for k in prims[0][2]}
    reflective = mat["shininess"] > 0
    mat["specular"] = np.where(reflective[:, None], mat["specular"], 0.0)
    mat["refraction"] = np.where(reflective[:, None], mat["refraction"], 0.0)

    tri_rows, sph_rows, pl_rows = [], [], []
    for i, (kind, geo, _, fwd, inv) in enumerate(prims):
        if kind == "tri":
            v0, v1, v2 = (_point(fwd, v) for v in geo)
            e1, e2 = v1 - v0, v2 - v0
            nrm = np.cross(e1, e2)
            nrm = nrm / np.linalg.norm(nrm)
            tri_rows.append((i, v0, e1, e2, nrm))
        elif kind == "sphere":
            transformed = not np.array_equal(fwd, np.eye(4))
            # Sphere.Transform: obj_to_world = I @ forward, world_to_obj =
            # inverse @ I.
            sph_rows.append((i, geo[0], geo[1], np.eye(4) @ fwd,
                             inv @ np.eye(4), transformed))
        else:
            normal, dist = geo
            center = _point(fwd, normal * dist)
            nn = inv[:3, :3].T @ normal
            nn = nn / np.linalg.norm(nn)
            pl_rows.append((i, nn, float(center @ nn)))

    T = max(len(tri_rows), 1)
    tri = {"v0": np.zeros((T, 3)), "e1": np.zeros((T, 3)),
           "e2": np.zeros((T, 3)), "normal": np.tile([0.0, 0.0, 1.0], (T, 1)),
           "mirror": np.zeros(T, bool), "smooth": np.zeros(T, bool),
           "prim_id": np.full(T, -1, np.int32)}
    for j, (i, v0, e1, e2, nrm) in enumerate(tri_rows):
        tri["v0"][j], tri["e1"][j], tri["e2"][j], tri["normal"][j] = (
            v0, e1, e2, nrm)
        tri["mirror"][j], tri["prim_id"][j] = True, i
    for k in ("n0", "n1", "n2"):
        tri[k] = tri["normal"].copy()

    S = max(len(sph_rows), 1)
    sph = {"center": np.zeros((S, 3)), "radius": np.ones(S),
           "obj_to_world": np.tile(np.eye(4), (S, 1, 1)),
           "world_to_obj": np.tile(np.eye(4), (S, 1, 1)),
           "transformed": np.zeros(S, bool),
           "prim_id": np.full(S, -1, np.int32)}
    for j, (i, c, r, o2w, w2o, tr) in enumerate(sph_rows):
        sph["center"][j], sph["radius"][j] = c, r
        sph["obj_to_world"][j], sph["world_to_obj"][j] = o2w, w2o
        sph["transformed"][j], sph["prim_id"][j] = tr, i

    P = max(len(pl_rows), 1)
    pl = {"normal": np.tile([0.0, 0.0, 1.0], (P, 1)),
          "origin_dist": np.zeros(P), "prim_id": np.full(P, -1, np.int32)}
    for j, (i, nn, dist) in enumerate(pl_rows):
        pl["normal"][j], pl["origin_dist"][j], pl["prim_id"][j] = nn, dist, i

    materials = {
        "emission": mat["emission"], "diffuse": mat["diffuse"],
        "specular": mat["specular"], "refraction": mat["refraction"],
        "refractive_index": mat["ior"].astype(np.float64),
        "shininess": mat["shininess"].astype(np.float64),
        "two_sided": mat["two_sided"].astype(bool),
        "invert": mat["invert"].astype(bool)}
    return {"triangles": tri, "spheres": sph, "planes": pl,
            "materials": materials, "n_prims": n}
