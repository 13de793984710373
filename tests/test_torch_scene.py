"""Port scene pipeline vs the JAX package: ``parse`` + ``freeze_scene``,
``pack_tables`` and ``init_camera`` of both packages give exactly equal
values (both round the same f64 host values to f32 once), and the port's
``scene_arrays_from_numpy``/``camera_from_numpy`` carry the JAX arrays over
bit for bit."""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from raytracercore_tpu.intersect import kernel_body as jkb
from raytracercore_tpu.scene import loader as jloader
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.intersect import kernel_body as tkb
from raytracercore_tpu_torch.parallel.worker import CORNELL_SCENE, SMOOTH_SCENE
from raytracercore_tpu_torch.scene import loader as tloader
from raytracercore_tpu_torch.scene import types as ttypes
from test_fused import SCENE as FUSED_SCENE

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

DOF_SCENE = """
size 12 10
recursion 2
ambient miss
dof .1 .05 to 3
camera 0 1 4  0 1 0  0 1 0  50
orthographic 0 0 5  0 0 0  0 1 0  2
twosided false
diffuse .5 .4 .3
cube 0 0 0  1 1 1 not -z
sphere 0 0 2 .3
"""

# The geometry of the JAX megakernel test's scene with materials whose total
# luminance exceeds 1, so the energy compensation max(total, 1) passes
# gradients to Fresnel: IOR and shininess get real gradients (with total < 1
# everywhere those gradients are exactly 0).
ROUGH_SCENE = """
size 16 16
recursion 4
ambient color 0.05 0.05 0.05
camera 0 1 4  0 1 0  0 1 0  60
emission 6 6 6
vertex -1 2.5 -1
vertex 1 2.5 -1
vertex -1 2.5 1
tri 0 1 2 mirrored
emission 0 0 0
diffuse .7 .6 .5
specular .5 .5 .5
shininess 40
twosided true
plane -1  0 0 1
diffuse .3 .3 .3
specular .8 .8 .8
shininess 30
refraction .7 .7 .7, 1.5
sphere -0.8 1 0.5 0.6
refraction off
diffuse .4 .4 .4
specular .9 .9 .9
shininess 60
sphere 0.8 1 0.5 0.6
"""


def _stress_scene(types):
    """The mixed stress scene of tests/test_configs.py (config 4), built
    with ``types`` (either package's host records)."""
    scene = types.HostScene(width=8, height=8, recursion=3)
    floor = types.HostPlane(normal=np.array([0.0, 0, 1.0]),
                            origin_distance=-1.0)
    floor.material.two_sided = True
    floor.material.diffuse = np.array([0.4, 0.4, 0.5])
    quad = types.HostTriangle(v0=np.array([-2.0, -2, 3]),
                              v1=np.array([2.0, -2, 3]),
                              v2=np.array([-2.0, 2, 3]), mirror=True)
    quad.material.two_sided = True
    quad.material.emission = np.array([4.0, 4, 4])
    ball = types.HostSphere(center=np.array([0.0, 0, 0.5]), radius=0.7)
    ball.material.two_sided = True
    ball.material.diffuse = np.array([0.3, 0.1, 0.1])
    ball.material.specular = np.array([0.5, 0.5, 0.5])
    ball.material.shininess = 64.0
    for p in (floor, quad, ball):
        scene.add_primitive(p)
    scene.cameras.append(types.HostCamera(
        mode="frustum", position=np.array([0.0, -0.5, -3.0]),
        look_at=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
        fov_or_size=0.8))
    return scene


def host_scenes(name):
    """(JAX HostScene, port HostScene) of one named test scene."""
    if name == "stress":
        return _stress_scene(jtypes), _stress_scene(ttypes)
    text = {"fused": FUSED_SCENE, "cornell": CORNELL_SCENE,
            "dof": DOF_SCENE, "smooth": SMOOTH_SCENE}[name]
    return jloader.parse(text), tloader.parse(text)


SCENES = ["fused", "cornell", "dof", "stress", "smooth"]


def assert_tensors_equal(port, ref, where=""):
    """Every field of a port dataclass equals the JAX struct's field."""
    for f in dataclasses.fields(port):
        got = getattr(port, f.name)
        want = getattr(ref, f.name)
        path = f"{where}.{f.name}"
        if dataclasses.is_dataclass(got):
            assert_tensors_equal(got, want, path)
        elif isinstance(got, torch.Tensor):
            want = np.asarray(want)
            got = got.numpy()
            assert got.dtype == want.dtype, path
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            assert got == want, path


@pytest.mark.parametrize("name", SCENES)
def test_freeze_scene_matches_jax(name):
    jhost, thost = host_scenes(name)
    ja = jtypes.freeze_scene(jhost)
    ta = ttypes.freeze_scene(thost, device="cpu")
    assert_tensors_equal(ta, ja)
    for got, want in zip(tkb.pack_tables(ta), jkb.pack_tables(ja)):
        assert got.dtype == torch.float32 or got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", SCENES)
def test_init_camera_matches_jax(name):
    jhost, thost = host_scenes(name)
    assert len(thost.cameras) == len(jhost.cameras) > 0
    for jc, tc in zip(jhost.cameras, thost.cameras):
        want = jtypes.init_camera(jc, jhost.width, jhost.height)
        got = ttypes.init_camera(tc, thost.width, thost.height, device="cpu")
        assert_tensors_equal(got, want)


@pytest.mark.parametrize("name", SCENES)
def test_state_from_numpy_equals_port_freeze(name):
    jhost, thost = host_scenes(name)
    ja = jax.tree_util.tree_map(np.asarray, jtypes.freeze_scene(jhost))
    assert_tensors_equal(ttypes.scene_arrays_from_numpy(ja, device="cpu"),
                         ttypes.freeze_scene(thost, device="cpu"))
    jc = jax.tree_util.tree_map(np.asarray, jtypes.init_camera(
        jhost.cameras[0], jhost.width, jhost.height))
    assert_tensors_equal(
        ttypes.camera_from_numpy(jc, device="cpu"),
        ttypes.init_camera(thost.cameras[0], thost.width, thost.height,
                           device="cpu"))


def test_scene_arrays_to_device_keeps_metadata():
    ta = ttypes.freeze_scene(tloader.parse(CORNELL_SCENE), device="cpu")
    moved = ta.to("cpu")
    assert moved.recursion == ta.recursion == 10
    assert moved.n_prims == ta.n_prims
    assert moved.materials.emission.device == torch.device("cpu")
    # The Cornell scene fills every table (triangles, spheres, a plane).
    assert int((ta.triangles.prim_id >= 0).sum()) > 0
    assert int((ta.spheres.prim_id >= 0).sum()) > 0
    assert int((ta.planes.prim_id >= 0).sum()) > 0
