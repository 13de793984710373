"""Procedural mesh-scene generation (counterpart of
``raytracercore_tpu.scene.meshgen``).

The reference has no mesh format (scenes are hand-written primitives), so
tests and measurements above the hand-written scenes' size use procedural
geometry: a grid of replicated icospheres, or of analytic spheres or
ellipsoids, over a floor, lit by an emissive quad — every row built
directly as SoA arrays in numpy (no per-primitive host objects) and frozen
into the port's :class:`.types.SceneArrays` on a given device.  Same seeds
give the same scenes as the JAX package's generator.
"""

from __future__ import annotations

import numpy as np

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device
from .types import (HostCamera, Materials, Planes, SceneArrays, Spheres,
                    Triangles)


def _converters(device, dtype):
    """numpy → tensor on ``device``: floats in ``dtype`` (rounded once from
    f64), bools, int32s."""
    def f(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    def b(a):
        return torch.tensor(np.asarray(a, bool), device=device)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    return f, b, i32


def _empty_planes(f, i32):
    """The one masked padding row of a scene without planes."""
    return Planes(normal=f([[0.0, 0.0, 1.0]]), origin_dist=f(np.zeros(1)),
                  prim_id=i32([-1]))


def _camera(half):
    return HostCamera(
        mode="frustum",
        position=np.array([0.0, -half - 14.0, half * 0.9 + 7.0]),
        look_at=np.array([0.0, 0.0, 1.0]),
        up=np.array([0.0, 0.0, 1.0]),
        fov_or_size=np.deg2rad(55.0))


def _scene(tris, spheres, planes, mats, f, n_prims, recursion, width,
           height):
    return SceneArrays(
        triangles=tris, spheres=spheres, planes=planes, materials=mats,
        background_rgb=f(np.zeros(3)), background_alpha=f(0.0),
        ambient_rgb=f(np.full(3, 0.12)),
        air_refractive_index=f(1.000293),
        width=width, height=height, recursion=recursion,
        ambient_is_miss=False, debug_geom=False, n_prims=n_prims)


def _diffuse_materials(f, b, diffuse, emission):
    n = len(diffuse)
    return Materials(
        emission=f(emission), diffuse=f(diffuse),
        specular=f(np.zeros((n, 3))), refraction=f(np.zeros((n, 3))),
        refractive_index=f(np.ones(n)), shininess=f(np.full(n, 100.0)),
        two_sided=b(np.zeros(n, bool)), invert=b(np.zeros(n, bool)))


def icosphere(subdiv: int):
    """Unit icosphere: returns (verts [V,3] f64, faces [F,3] int32).

    20 * 4^subdiv faces (subdiv 4 → 5120).
    """
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
                m = m / np.linalg.norm(m)
                edge_mid[k] = len(vlist)
                vlist.append(m)
            return edge_mid[k]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces.astype(np.int32)


def make_mesh_scene(grid: int = 14, subdiv: int = 4, seed: int = 0,
                    recursion: int = 4, width: int = 1024,
                    height: int = 1024, smooth: bool = True,
                    device=DEFAULT_DEVICE, dtype=torch.float32):
    """A grid x grid field of replicated icospheres + floor + quad light.

    grid=14, subdiv=4 → 14*14*5120 + 2 = 1,003,522 triangles; grid=1,
    subdiv=1 → 82 (just above the megakernel's cap); grid=3, subdiv=1 → 722
    (near the top of the dense tier).

    Returns (SceneArrays, HostCamera, host_tri_bounds_inputs) where the
    last element is the (v0, e1, e2, mirror, valid) numpy tuple the BVH
    construction consumes — kept on host so callers can build the BVH without
    pulling the device arrays back.
    """
    device = resolve_device(device, "make_mesh_scene")
    rng = np.random.default_rng(seed)
    sv, sf = icosphere(subdiv)

    spacing = 2.6
    half = (grid - 1) * spacing / 2.0

    v0_list, v1_list, v2_list = [], [], []
    n0_list, n1_list, n2_list = [], [], []
    diffuse_rows = []

    for gy in range(grid):
        for gx in range(grid):
            scale = 0.8 + 0.4 * rng.random()
            cx = gx * spacing - half
            cy = gy * spacing - half
            cz = scale  # resting on the floor z=0
            v = sv * scale + np.array([cx, cy, cz])
            tri_v = v[sf]  # [F, 3, 3]
            v0_list.append(tri_v[:, 0])
            v1_list.append(tri_v[:, 1])
            v2_list.append(tri_v[:, 2])
            if smooth:
                n = sv[sf]  # unit sphere verts ARE the normals
                n0_list.append(n[:, 0])
                n1_list.append(n[:, 1])
                n2_list.append(n[:, 2])
            diffuse_rows.append(
                np.tile(0.25 + 0.7 * rng.random(3), (len(sf), 1)))

    # Floor: one mirrored quad (two corners + edges span the field), plus an
    # emissive quad light overhead.
    ext = half + 3.0
    floor_v0 = np.array([[-ext, -ext, 0.0]])
    floor_e1 = np.array([[2 * ext, 0.0, 0.0]])
    floor_e2 = np.array([[0.0, 2 * ext, 0.0]])
    light_v0 = np.array([[-ext / 2, -ext / 2, 6.0 + half]])
    light_e1 = np.array([[ext, 0.0, 0.0]])
    light_e2 = np.array([[0.0, ext, 0.0]])

    v0 = np.concatenate(v0_list + [floor_v0, light_v0])
    v1 = np.concatenate(v1_list + [floor_v0 + floor_e1, light_v0 + light_e1])
    v2 = np.concatenate(v2_list + [floor_v0 + floor_e2, light_v0 + light_e2])
    e1 = v1 - v0
    e2 = v2 - v0
    normal = np.cross(e1, e2)
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True),
                         1e-30)
    T = len(v0)
    mirror = np.zeros(T, bool)
    mirror[-2:] = True  # floor + light are quads
    smooth_f = np.zeros(T, bool)
    if smooth:
        smooth_f[:-2] = True
        n0 = np.concatenate(n0_list + [normal[-2:][:1], normal[-1:]])
        n1 = np.concatenate(n1_list + [normal[-2:][:1], normal[-1:]])
        n2 = np.concatenate(n2_list + [normal[-2:][:1], normal[-1:]])
    else:
        n0 = n1 = n2 = normal

    prim_id = np.arange(T, dtype=np.int32)

    diffuse = np.concatenate(
        diffuse_rows + [np.array([[0.6, 0.6, 0.65]]),
                        np.array([[0.0, 0.0, 0.0]])])
    emission = np.zeros((T, 3))
    emission[-1] = [14.0, 13.0, 12.0]

    f, b, i32 = _converters(device, dtype)
    tris = Triangles(v0=f(v0), e1=f(e1), e2=f(e2), normal=f(normal),
                     n0=f(n0), n1=f(n1), n2=f(n2), mirror=b(mirror),
                     smooth=b(smooth_f), prim_id=i32(prim_id))
    # Empty (1-row padded) sphere/plane tables.
    spheres = Spheres(center=f(np.zeros((1, 3))), radius=f(np.ones(1)),
                      obj_to_world=f(np.eye(4)[None]),
                      world_to_obj=f(np.eye(4)[None]),
                      normal_mat=f(np.eye(3)[None]),
                      transformed=b(np.zeros(1, bool)), prim_id=i32([-1]))
    arrays = _scene(tris, spheres, _empty_planes(f, i32),
                    _diffuse_materials(f, b, diffuse, emission), f, T,
                    recursion, width, height)
    cam = _camera(half)
    host_tris = (v0.astype(np.float32), e1.astype(np.float32),
                 e2.astype(np.float32), mirror, np.ones(T, bool))
    return arrays, cam, host_tris


def make_sphere_field_scene(grid: int = 20, seed: int = 0,
                            recursion: int = 4, width: int = 512,
                            height: int = 512, device=DEFAULT_DEVICE,
                            dtype=torch.float32, ellipsoid: bool = False):
    """A grid x grid field of ANALYTIC (untransformed) spheres over a floor
    quad with an emissive quad light — the mixed sphere+triangle stress
    scene for the sphere-BVH path (reference analog: die.txt's 21 analytic
    pip spheres + cube quads, at scale).

    grid=320 → 102,400 spheres + 2 triangles.

    Returns (SceneArrays, HostCamera).
    """
    device = resolve_device(device, "make_sphere_field_scene")
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

    # Global prim ids: spheres 0..S-1, floor S, light S+1.
    N = S + 2
    f, b, i32 = _converters(device, dtype)
    if ellipsoid:
        # TRANSFORMED spheres: unit sphere at the object origin mapped by
        # a random anisotropic scale + z-rotation + translation — the
        # ellipsoid-field stress scene for the ellipsoid-BVH tier
        # (reference analog: Sphere.cs transformed spheres bounded via
        # IBoundedObject, Scene.cs:39-49).
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
        spheres = Spheres(
            center=f(np.zeros((S, 3))), radius=f(np.ones(S)),
            obj_to_world=f(o2w), world_to_obj=f(w2o),
            normal_mat=f(np.transpose(w2o[:, :3, :3], (0, 2, 1))),
            transformed=b(np.ones(S, bool)), prim_id=i32(np.arange(S)))
    else:
        eye4 = np.broadcast_to(np.eye(4), (S, 4, 4)).copy()
        spheres = Spheres(
            center=f(center), radius=f(scale),
            obj_to_world=f(eye4), world_to_obj=f(eye4),
            normal_mat=f(np.broadcast_to(np.eye(3), (S, 3, 3))),
            transformed=b(np.zeros(S, bool)), prim_id=i32(np.arange(S)))
    tris = Triangles(
        v0=f(v0), e1=f(e1), e2=f(e2), normal=f(normal),
        n0=f(normal), n1=f(normal), n2=f(normal),
        mirror=b(np.ones(2, bool)), smooth=b(np.zeros(2, bool)),
        prim_id=i32([S, S + 1]))

    diffuse = np.concatenate([0.25 + 0.7 * rng.random((S, 3)),
                              np.array([[0.6, 0.6, 0.65]]),
                              np.zeros((1, 3))])
    emission = np.zeros((N, 3))
    emission[-1] = [14.0, 13.0, 12.0]
    arrays = _scene(tris, spheres, _empty_planes(f, i32),
                    _diffuse_materials(f, b, diffuse, emission), f, N,
                    recursion, width, height)
    return arrays, _camera(half)
