"""The icosphere field, as numpy tables.

A frozen copy of ``raytracercore_tpu_torch/scene/meshgen.py``
``icosphere`` and ``make_mesh_scene`` (commit 25c2873), ending in numpy
arrays instead of the program's tensors, with the light quad made
two-sided as ``chip_smoke.py`` ``lit_mesh_scene`` does (single-sided, it
faces up and lights nothing below it).  ``grid=12, subdiv=3`` gives the
184,322 triangles of the JAX package's large-scene configuration.

The benchmark makes these tables once and hands the same arrays to both
sides: the program through ``scene_arrays_from_numpy``, the reference
through :func:`rtbench.reference.tables.load`.
"""

from __future__ import annotations

import numpy as np


def icosphere(subdiv: int):
    """Unit icosphere: ``(verts [V, 3] f64, faces [20·4^subdiv, 3])``."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k not in edge_mid:
                m = (vlist[a] + vlist[b]) / 2.0
                edge_mid[k] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return edge_mid[k]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces.astype(np.int32)


def make(grid: int, subdiv: int, seed: int, recursion: int, width: int,
         height: int):
    """``(tables, camera)``: a ``grid`` x ``grid`` field of icospheres of
    ``20·4^subdiv`` smooth triangles over a floor quad, lit by a two-sided
    emissive quad; every triangle its own material row."""
    rng = np.random.default_rng(seed)
    sv, sf = icosphere(subdiv)
    spacing = 2.6
    half = (grid - 1) * spacing / 2.0
    v0s, v1s, v2s, n0s, n1s, n2s, diffuse_rows = [], [], [], [], [], [], []
    for gy in range(grid):
        for gx in range(grid):
            scale = 0.8 + 0.4 * rng.random()
            v = sv * scale + np.array([gx * spacing - half,
                                       gy * spacing - half, scale])
            tri_v = v[sf]
            v0s.append(tri_v[:, 0])
            v1s.append(tri_v[:, 1])
            v2s.append(tri_v[:, 2])
            n = sv[sf]  # unit sphere vertices are the normals
            n0s.append(n[:, 0])
            n1s.append(n[:, 1])
            n2s.append(n[:, 2])
            diffuse_rows.append(np.tile(0.25 + 0.7 * rng.random(3),
                                        (len(sf), 1)))

    ext = half + 3.0
    floor_v0 = np.array([[-ext, -ext, 0.0]])
    floor_e1 = np.array([[2 * ext, 0.0, 0.0]])
    floor_e2 = np.array([[0.0, 2 * ext, 0.0]])
    light_v0 = np.array([[-ext / 2, -ext / 2, 6.0 + half]])
    light_e1 = np.array([[ext, 0.0, 0.0]])
    light_e2 = np.array([[0.0, ext, 0.0]])
    v0 = np.concatenate(v0s + [floor_v0, light_v0])
    v1 = np.concatenate(v1s + [floor_v0 + floor_e1, light_v0 + light_e1])
    v2 = np.concatenate(v2s + [floor_v0 + floor_e2, light_v0 + light_e2])
    e1, e2 = v1 - v0, v2 - v0
    normal = np.cross(e1, e2)
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True),
                         1e-30)
    T = len(v0)
    mirror = np.zeros(T, bool)
    mirror[-2:] = True  # floor and light are quads
    smooth = np.zeros(T, bool)
    smooth[:-2] = True
    n0 = np.concatenate(n0s + [normal[-2:][:1], normal[-1:]])
    n1 = np.concatenate(n1s + [normal[-2:][:1], normal[-1:]])
    n2 = np.concatenate(n2s + [normal[-2:][:1], normal[-1:]])
    diffuse = np.concatenate(diffuse_rows + [np.array([[0.6, 0.6, 0.65]]),
                                             np.array([[0.0, 0.0, 0.0]])])
    emission = np.zeros((T, 3))
    emission[-1] = [14.0, 13.0, 12.0]
    triangles = {"v0": v0, "e1": e1, "e2": e2, "normal": normal, "n0": n0,
                 "n1": n1, "n2": n2, "mirror": mirror, "smooth": smooth,
                 "prim_id": np.arange(T, dtype=np.int32)}
    spheres = {"center": np.zeros((1, 3)), "radius": np.ones(1),
               "obj_to_world": np.eye(4)[None],
               "world_to_obj": np.eye(4)[None], "normal_mat": np.eye(3)[None],
               "transformed": np.zeros(1, bool),
               "prim_id": np.array([-1], np.int32)}
    return (field_tables(triangles, spheres, diffuse, emission, recursion,
                         width, height), field_camera(half))


def field_tables(triangles: dict, spheres: dict, diffuse, emission,
                 recursion: int, width: int, height: int) -> dict:
    """The tables of a generated field: its triangle and sphere tables, no
    planes (one masked row), diffuse materials ``diffuse`` and
    ``emission`` (one row a primitive, the light last and two-sided) and
    the generators' scene settings."""
    n = len(diffuse)
    two_sided = np.zeros(n, bool)
    two_sided[-1] = True  # the light, as chip_smoke.lit_mesh_scene
    return {
        "triangles": triangles, "spheres": spheres,
        "planes": {"normal": np.array([[0.0, 0.0, 1.0]]),
                   "origin_dist": np.zeros(1),
                   "prim_id": np.array([-1], np.int32)},
        "materials": {"emission": emission, "diffuse": diffuse,
                      "specular": np.zeros((n, 3)),
                      "refraction": np.zeros((n, 3)),
                      "refractive_index": np.ones(n),
                      "shininess": np.full(n, 100.0),
                      "two_sided": two_sided, "invert": np.zeros(n, bool)},
        "background_rgb": np.zeros(3), "background_alpha": 0.0,
        "ambient_rgb": np.full(3, 0.12), "air_refractive_index": 1.000293,
        "width": width, "height": height, "recursion": recursion,
        "ambient_is_miss": False, "debug_geom": False, "n_prims": n,
        "any_smooth": True}


def field_camera(half: float) -> dict:
    """The generators' frustum camera over a field of half-width
    ``half``."""
    return {"position": np.array([0.0, -half - 14.0, half * 0.9 + 7.0]),
            "look_at": np.array([0.0, 0.0, 1.0]),
            "up": np.array([0.0, 0.0, 1.0]), "fov": np.deg2rad(55.0),
            "image_plane": 0.0, "dof_amount": 0.0, "focal_length": 0.0}
