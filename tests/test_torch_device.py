"""The port's constructors default to the card, as the JAX package puts its
arrays on the accelerator: without a card, called with no ``device``,
each raises a ``RuntimeError`` that names ``device="cpu"``; with one, its
tensors land there.  Whether a card is present is decided inside each
test."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytracercore_tpu.scene import loader as jloader
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.bvh import builder
from raytracercore_tpu_torch.diff import get_material_params
from raytracercore_tpu_torch.diff.params import material_params_from_numpy
from raytracercore_tpu_torch.render.camera import pixel_grid
from raytracercore_tpu_torch.render.film import Film
from raytracercore_tpu_torch.scene import loader, meshgen
from raytracercore_tpu_torch.scene import types as ttypes
from raytracercore_tpu_torch.tools.issue_probe import probe_inputs

SCENE = """
size 8 8
camera 0 0 5  0 0 0  0 1 0  45
diffuse .5 .5 .5
sphere 0 0 0 1
vertex -1 -1 0
vertex 1 -1 0
vertex 0 1 0
tri 0 1 2
"""


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _boxes():
    v0 = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
    e1 = np.array([[1, 0, 0]] * 3, np.float32)
    e2 = np.array([[0, 1, 0]] * 3, np.float32)
    mirror = np.zeros(3, bool)
    return v0, e1, e2, mirror, np.ones(3, bool)


def _bvh_fields():
    bmin, bmax = builder.triangle_bounds(*_boxes()[:4])
    bvh = builder.build_boxes_bvh(bmin, bmax, np.ones(3, bool), 2,
                                  backend="numpy", device="cpu")
    return {f.name: getattr(bvh, f.name).numpy()
            for f in dataclasses.fields(bvh)}


def _sphere_args():
    c = np.array([[0, 0, 0], [3, 0, 0], [0, 3, 0]], np.float32)
    r = np.ones(3, np.float32)
    return c, r


CONSTRUCTORS = {
    "freeze_scene": lambda **kw: ttypes.freeze_scene(loader.parse(SCENE),
                                                     **kw).triangles.v0,
    "init_camera": lambda **kw: ttypes.init_camera(
        loader.parse(SCENE).cameras[0], 8, 8, **kw).position,
    "scene_arrays_from_numpy": lambda **kw: ttypes.scene_arrays_from_numpy(
        _np_tree(jtypes.freeze_scene(jloader.parse(SCENE))),
        **kw).spheres.radius,
    "camera_from_numpy": lambda **kw: ttypes.camera_from_numpy(
        _np_tree(jtypes.init_camera(jloader.parse(SCENE).cameras[0], 8, 8)),
        **kw).position,
    "make_mesh_scene": lambda **kw: meshgen.make_mesh_scene(
        grid=1, subdiv=0, width=8, height=8, **kw)[0].triangles.v0,
    "make_sphere_field_scene": lambda **kw: meshgen.make_sphere_field_scene(
        grid=2, width=8, height=8, **kw)[0].spheres.radius,
    "bvh_arrays_from_numpy": lambda **kw: builder.bvh_arrays_from_numpy(
        _bvh_fields(), **kw).bmin,
    "build_boxes_bvh": lambda **kw: builder.build_boxes_bvh(
        *builder.triangle_bounds(*_boxes()[:4]), np.ones(3, bool), 2,
        backend="numpy", **kw).bmin,
    "build_triangle_bvh": lambda **kw: builder.build_triangle_bvh(
        *_boxes(), 2, backend="numpy", **kw).bmin,
    "build_ellipsoid_bvh": lambda **kw: builder.build_ellipsoid_bvh(
        *_sphere_args(), np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
        np.ones(3, bool), 2, backend="numpy", **kw).bmin,
    "build_sphere_bvh": lambda **kw: builder.build_sphere_bvh(
        *_sphere_args(), np.ones(3, bool), 2, backend="numpy", **kw).bmin,
    "Film.create": lambda **kw: Film.create(4, 4, **kw).color_sum,
    "material_params_from_numpy": lambda **kw: material_params_from_numpy(
        {k: v.detach().numpy() for k, v in get_material_params(
            ttypes.freeze_scene(loader.parse(SCENE),
                                device="cpu")).items()},
        **kw)["diffuse"],
    "probe_inputs": lambda **kw: probe_inputs(64, **kw),
    "pixel_grid": lambda **kw: pixel_grid(4, 3, **kw)[0],
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    make = CONSTRUCTORS[name]
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()


def test_default_error_names_the_caller():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="^freeze_scene: "):
        ttypes.freeze_scene(loader.parse(SCENE))
