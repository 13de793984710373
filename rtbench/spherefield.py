"""The sphere and ellipsoid fields, as numpy tables.

A frozen copy of ``raytracercore_tpu_torch/scene/meshgen.py``
``make_sphere_field_scene`` (commit d1f2e31), in its analytic and its
ellipsoid form, ending in numpy arrays in :mod:`rtbench.meshfield`'s
format instead of the program's tensors.  As there, the light quad is
made two-sided: as generated it faces up from above the field and lights
nothing below it.  ``grid=320`` gives 102,400 sphere rows and 2
triangles; ``grid=224, ellipsoid=True`` gives 50,176 ellipsoid rows and 2
triangles (the JAX package's ``docs/SCALE.md`` rows "102,400 spheres
512²" and "50,176 ellipsoids 512²").

The benchmark makes these tables once and hands the same arrays to both
sides: the program through ``scene_arrays_from_numpy``, the reference
through :func:`rtbench.reference.tables.load`.
"""

from __future__ import annotations

import numpy as np

from . import meshfield


def make(grid: int, seed: int, ellipsoid: bool, recursion: int, width: int,
         height: int):
    """``(tables, camera)``: a ``grid`` x ``grid`` field of spheres (or,
    with ``ellipsoid``, of unit spheres under a random anisotropic scale,
    z-rotation and translation) over a floor quad, lit by a two-sided
    emissive quad; sphere ``i`` is primitive ``i``, the floor and the light
    ``S`` and ``S + 1``, each its own material row."""
    rng = np.random.default_rng(seed)
    S = grid * grid
    spacing = 2.6
    half = (grid - 1) * spacing / 2.0

    gx, gy = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    scale = 0.8 + 0.4 * rng.random(S)
    center = np.stack([gx.reshape(-1) * spacing - half,
                       gy.reshape(-1) * spacing - half,
                       scale], axis=1)

    ext = half + 3.0
    floor_v0 = np.array([[-ext, -ext, 0.0]])
    floor_e1 = np.array([[2 * ext, 0.0, 0.0]])
    floor_e2 = np.array([[0.0, 2 * ext, 0.0]])
    light_v0 = np.array([[-ext / 2, -ext / 2, 6.0 + half]])
    light_e1 = np.array([[ext, 0.0, 0.0]])
    light_e2 = np.array([[0.0, ext, 0.0]])
    v0 = np.concatenate([floor_v0, light_v0])
    e1 = np.concatenate([floor_e1, light_e1])
    e2 = np.concatenate([floor_e2, light_e2])
    normal = np.cross(e1, e2)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)

    N = S + 2
    if ellipsoid:
        ax = scale[:, None] * (0.55 + 0.9 * rng.random((S, 3)))
        th = rng.random(S) * 2 * np.pi
        cs, sn = np.cos(th), np.sin(th)
        o2w = np.zeros((S, 4, 4))
        o2w[:, 3, 3] = 1.0
        rot = np.zeros((S, 3, 3))
        rot[:, 0, 0], rot[:, 0, 1] = cs, -sn
        rot[:, 1, 0], rot[:, 1, 1] = sn, cs
        rot[:, 2, 2] = 1.0
        o2w[:, :3, :3] = rot * ax[:, None, :]
        center_w = center.copy()
        center_w[:, 2] = ax[:, 2]  # rest on the floor
        o2w[:, :3, 3] = center_w
        w2o = np.linalg.inv(o2w)
        spheres = {"center": np.zeros((S, 3)), "radius": np.ones(S),
                   "obj_to_world": o2w, "world_to_obj": w2o,
                   "normal_mat": np.transpose(w2o[:, :3, :3], (0, 2, 1)),
                   "transformed": np.ones(S, bool),
                   "prim_id": np.arange(S, dtype=np.int32)}
    else:
        eye4 = np.broadcast_to(np.eye(4), (S, 4, 4)).copy()
        spheres = {"center": center, "radius": scale,
                   "obj_to_world": eye4, "world_to_obj": eye4,
                   "normal_mat": np.broadcast_to(np.eye(3), (S, 3, 3)),
                   "transformed": np.zeros(S, bool),
                   "prim_id": np.arange(S, dtype=np.int32)}

    diffuse = np.concatenate([0.25 + 0.7 * rng.random((S, 3)),
                              np.array([[0.6, 0.6, 0.65]]),
                              np.zeros((1, 3))])
    emission = np.zeros((N, 3))
    emission[-1] = [14.0, 13.0, 12.0]
    triangles = {"v0": v0, "e1": e1, "e2": e2, "normal": normal,
                 "n0": normal, "n1": normal, "n2": normal,
                 "mirror": np.ones(2, bool), "smooth": np.zeros(2, bool),
                 "prim_id": np.array([S, S + 1], np.int32)}
    return (meshfield.field_tables(triangles, spheres, diffuse, emission,
                                   recursion, width, height),
            meshfield.field_camera(half))
