"""The port's procedural scenes (``scene/meshgen.py``) against the JAX
package's: both build the same numpy f64 arrays from the same seed and
round them to f32 once, so every field is compared exactly (a stricter
bound than the 1e-6 a float comparison would need), ints and bools
included; and the JAX arrays carried over with ``scene_arrays_from_numpy``
equal the port's own."""

import jax
import numpy as np
import pytest
import torch

from raytracercore_tpu.scene import meshgen as jmeshgen
from raytracercore_tpu_torch.intersect.dispatch import n_table_rows
from raytracercore_tpu_torch.render import fused
from raytracercore_tpu_torch.scene import meshgen as tmeshgen
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_scene import assert_tensors_equal

CASES = {
    "mesh-82": ("make_mesh_scene", dict(grid=1, subdiv=1, width=16,
                                        height=16)),
    "mesh-flat": ("make_mesh_scene", dict(grid=2, subdiv=0, seed=3,
                                          smooth=False, recursion=2)),
    "spheres": ("make_sphere_field_scene", dict(grid=4)),
    "ellipsoids": ("make_sphere_field_scene", dict(grid=4, ellipsoid=True,
                                                   seed=5)),
}


def both(name):
    """(JAX result tuple, port result tuple) of one case."""
    fn, kw = CASES[name]
    return (getattr(jmeshgen, fn)(**kw),
            getattr(tmeshgen, fn)(**kw, device="cpu"))


@pytest.mark.parametrize("name", list(CASES))
def test_scene_fields_equal_jax(name):
    jres, tres = both(name)
    assert_tensors_equal(tres[0], jres[0])
    # The JAX arrays carried over are the port's own arrays.
    carried = ttypes.scene_arrays_from_numpy(
        jax.tree_util.tree_map(np.asarray, jres[0]), device="cpu")
    assert_tensors_equal(carried, tres[0])


@pytest.mark.parametrize("name", list(CASES))
def test_camera_and_host_triangles_equal_jax(name):
    jres, tres = both(name)
    jcam, tcam = jres[1], tres[1]
    assert tcam.mode == jcam.mode
    for field in ("position", "look_at", "up"):
        np.testing.assert_array_equal(getattr(tcam, field),
                                      getattr(jcam, field))
    assert tcam.fov_or_size == jcam.fov_or_size
    assert len(tres) == len(jres)
    if len(tres) == 3:  # the host inputs of a BVH build
        for got, want in zip(tres[2], jres[2]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("subdiv", [0, 1, 2])
def test_icosphere_equals_jax(subdiv):
    jv, jf = jmeshgen.icosphere(subdiv)
    tv, tf = tmeshgen.icosphere(subdiv)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert len(tf) == 20 * 4 ** subdiv
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), 1.0, atol=1e-12)


def test_scene_sizes_and_tiers():
    """mesh-82 sits just above the megakernel's cap, mesh-722 near the top
    of the dense tier; single-table scenes carry one masked padding row in
    each empty table."""
    small = tmeshgen.make_mesh_scene(grid=1, subdiv=1, device="cpu")[0]
    big = tmeshgen.make_mesh_scene(grid=3, subdiv=1, recursion=10,
                                   width=700, height=700, device="cpu")[0]
    assert small.triangles.v0.shape[0] == 82 and n_table_rows(small) == 84
    assert big.triangles.v0.shape[0] == 722 and n_table_rows(big) == 724
    assert (big.width, big.height, big.recursion) == (700, 700, 10)
    for scene in (small, big):
        assert not fused.fits(scene)
        assert scene.spheres.prim_id.tolist() == [-1]
        assert scene.planes.prim_id.tolist() == [-1]
        assert bool(scene.triangles.smooth[:-2].all())
        assert not bool(scene.triangles.smooth[-2:].any())
    field = tmeshgen.make_sphere_field_scene(grid=4, device="cpu")[0]
    assert fused.fits(field) and n_table_rows(field) == 16 + 2 + 1


def test_scene_lands_on_the_device_asked_for():
    scene = tmeshgen.make_mesh_scene(grid=1, subdiv=0, device="cpu",
                                     dtype=torch.float64)[0]
    assert scene.triangles.v0.dtype == torch.float64
    assert scene.triangles.prim_id.dtype == torch.int32
    assert scene.materials.invert.dtype == torch.bool
    assert scene.triangles.v0.device == torch.device("cpu")
