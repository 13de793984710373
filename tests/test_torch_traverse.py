"""The port's BVH traversal (``bvh/cuda_traverse.py``: packers, the plain
version ``traverse_reference`` of the CUDA kernel, the three ``select``
classes) and what is built on it — the detail route of
``dispatch.make_bvh_closest_fn``, ``Renderer(accelerator="bvh")``, the BVH
train step, the replay above 768 material rows — against the JAX package.

On the CPU the wrappers run the plain version; the JAX kernel runs in
Pallas interpret mode, as in the JAX package's own tests.  Both walk one
tree (the JAX numpy-built one, carried over) over the same scene arrays and
rays.  What is held:

* the packed leaf records equal the JAX packers' (without their lane
  padding and the record count in slot 15);
* ``traverse_reference`` against ``PallasBVH`` / ``PallasSphereBVH`` /
  ``PallasEllipsoidBVH`` ``.select(interpret=True, want_detail=True)`` on
  primary rays and one skip-carrying bounce: rows, prim and flags equal, t
  within 1e-6 (relative for the sphere kinds, whose t spans tens of units),
  position and normal within 1e-5;
* zero direction components: the plain version (finite inverse) against the
  reference walk (infinite inverse, NaN scrubbed) on axis-aligned rays;
* the detail route against JAX ``make_bvh_closest_fn(traversal="xla")`` and
  the port's dense ``closest_hit``; sphere and ellipsoid fields of 256 rows
  (a BVH of their own) against the dense scan: prim agreement >= 0.999, t
  as ``tests/test_pallas_traverse.py`` holds it;
* the BVH-route ``Renderer`` and train step equal the dense route's;
* the replay's plain kernels versions on a material table above 768 rows
  against autograd through ``replay``.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.bvh import builder as jbuilder
from raytracercore_tpu.bvh import pallas_traverse as jpt
from raytracercore_tpu.intersect import dispatch as jdispatch
from raytracercore_tpu.render import camera as jcam
from raytracercore_tpu.scene import meshgen as jmeshgen
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.bvh import (build_bvh, bvh_arrays_from_numpy,
                                         traverse_closest)
from raytracercore_tpu_torch.bvh import cuda_traverse as ct
from raytracercore_tpu_torch.config import (SELECT_MAX_PRIMS,
                                            SPHERE_BVH_MIN_ROWS)
from raytracercore_tpu_torch.diff import (MATERIAL_FIELDS,
                                          get_material_params)
from raytracercore_tpu_torch.intersect import cuda_select
from raytracercore_tpu_torch.intersect import dispatch as tdispatch
from raytracercore_tpu_torch.parallel import make_train_step
from raytracercore_tpu_torch.render import replay_kernel as rk
from raytracercore_tpu_torch.render.integrator import prepare_uniforms, trace
from raytracercore_tpu_torch.render.renderer import Renderer
from raytracercore_tpu_torch.render.replay import replay, trace_replay
from raytracercore_tpu_torch.scene import meshgen as tmeshgen
from raytracercore_tpu_torch.scene import types as ttypes
from raytracercore_tpu_torch.tools.png import write_png
from test_torch_bvh import EPS_B, EPS_P, bounce_of, mesh_case
from test_torch_dispatch import assert_hits_match, port_hit
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_scene import REPO_ROOT, host_scenes


def _t(a):
    return torch.tensor(np.asarray(a))


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def field_case(ellipsoid, grid=8, size=16):
    """A sphere (or ellipsoid) field of both packages with one BVH over its
    spheres, built by the JAX numpy builder and carried over, the two
    packages' ``select`` objects and centre rays:
    ``(ja, ta, jsel, tsel, o, d)``."""
    ja, host_cam = jmeshgen.make_sphere_field_scene(
        grid=grid, width=size, height=size, ellipsoid=ellipsoid)
    ta = ttypes.scene_arrays_from_numpy(_np_tree(ja), device="cpu")
    sph = _np_tree(ja.spheres)
    valid = sph.prim_id >= 0
    if ellipsoid:
        jbvh = jbuilder.build_ellipsoid_bvh(
            sph.center, sph.radius, sph.obj_to_world, valid, leaf_size=4,
            backend="numpy")
        jsel = jpt.PallasEllipsoidBVH(jbvh, ja.spheres, ja.materials,
                                      ja.n_prims)
        cls = ct.CudaEllipsoidBVH
    else:
        jbvh = jbuilder.build_sphere_bvh(sph.center, sph.radius, valid,
                                         leaf_size=4, backend="numpy")
        jsel = jpt.PallasSphereBVH(jbvh, ja.spheres, ja.materials,
                                   ja.n_prims)
        cls = ct.CudaSphereBVH
    tsel = cls(bvh_arrays_from_numpy(_np_tree(jbvh), device="cpu"), ta.spheres,
               ta.materials, ta.n_prims)
    camera = jtypes.init_camera(host_cam, size, size)
    o, d = jcam.center_rays(camera, *jcam.pixel_grid(size, size))
    return ja, ta, jsel, tsel, np.asarray(o), np.asarray(d)


def tri_case(two_sided=False):
    ja, ta, jbvh, tbvh, o, d = mesh_case(two_sided=two_sided)
    jsel = jpt.PallasBVH(jbvh, ja.triangles, ja.materials, ja.n_prims)
    tsel = ct.CudaBVH(tbvh, ta.triangles, ta.materials, ta.n_prims)
    return ja, ta, jsel, tsel, o, d


# (t rtol, t atol, position atol, normal atol).  Triangles: the same
# formulas in f32.  Sphere kinds: the root of a quadratic whose b^2 - 4c
# cancels, on rays some 30 units long, computed in another operation order
# (and with another rsqrt) than the Pallas kernel's: t as the JAX package's
# own tests hold it against the dense scan, the position with it, and the
# normal, which is the position's error over a radius of ~0.3.
TRI_TOL = (1e-6, 1e-6, 1e-5, 1e-5)
SPHERE_TOL = (1e-4, 2e-3, 2e-3, 1e-2)


def assert_select_matches(jsel, tsel, o, d, jskip, tol, sort=False):
    """``select(want_detail=True, sort=sort)`` of both packages on the same
    rays."""
    want = jsel.select(jnp.asarray(o), jnp.asarray(d), jskip, EPS_B, EPS_P,
                       interpret=True, want_detail=True, sort=sort)
    skip = None if jskip is None else port_hit(jskip)
    got = tsel.select(_t(o), _t(d), skip, EPS_B, EPS_P, want_detail=True,
                      sort=sort)
    hit = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), hit)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    np.testing.assert_allclose(got[2].numpy()[hit], np.asarray(want[2])[hit],
                               rtol=tol[0], atol=tol[1])
    assert np.isinf(got[2].numpy()[~hit]).all()
    for k in ("prim", "inside", "inside_geo", "smooth"):
        np.testing.assert_array_equal(got[3][k].numpy()[hit],
                                      np.asarray(want[3][k])[hit], err_msg=k)
    for k, atol in (("pos", tol[2]), ("nrm", tol[3]), ("u", 1e-5),
                    ("v", 1e-5)):
        err = np.abs(got[3][k].numpy()[hit] - np.asarray(want[3][k])[hit])
        assert err.max() <= atol, (k, err.max())
    return hit


# ---------------------------------------------------------------------------
# packers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tri", "sph", "spht"])
def test_packers_equal_jax(kind):
    if kind == "tri":
        ja, ta, jsel, tsel, _, _ = tri_case()
        F = ct.TRI_F
    else:
        ja, ta, jsel, tsel, _, _ = field_case(kind == "spht")
        F = ct.SPH_F if kind == "sph" else ct.SPT_F
    assert ct.LEAF_KINDS[kind][1] == F == getattr(
        jpt, {"tri": "TRI_F", "sph": "SPH_F", "spht": "SPT_F"}[kind])
    got = tsel.leaves.numpy()
    L, K = got.shape[0], tsel.K
    assert got.shape == (L, K * F) and K == 4
    # The JAX rows are padded to whole lanes (more slots, more leaves);
    # slot 15 of its triangle records carries the leaf's record count.
    want = np.asarray(jsel.leaf_tris)
    want = want.reshape(want.shape[0], -1, F)[:L, :K]
    cols = 15 if kind == "tri" else F
    np.testing.assert_array_equal(got.reshape(L, K, F)[..., :cols],
                                  want[..., :cols])
    if kind == "tri":
        assert not got.reshape(L, K, F)[..., 15].any()
    # Nodes: the f32 boxes themselves (the JAX kernel's are bf16-widened).
    nodes = tsel.nodes.numpy()
    assert nodes.shape == (tsel.n_nodes, 8) and nodes.dtype == np.float32
    assert (nodes[:, 6] > np.arange(tsel.n_nodes)).all()
    assert ((nodes[:, 7] >= 0).sum()) == L
    np.testing.assert_array_equal(tsel.prim_to_row.numpy(),
                                  np.asarray(jsel.prim_to_row))


def test_every_primitive_owns_one_row():
    """The skip record is matched by primitive id here and by the winner's
    own-table row (through ``prim_to_row``) in the JAX kernel: the same rule
    as long as no primitive owns two rows.  None does, in any scene of the
    loader or of ``meshgen``."""
    scenes = [ttypes.freeze_scene(host_scenes(name)[1], device="cpu")
              for name in ("cornell", "smooth", "fused", "dof", "stress")]
    scenes.append(tmeshgen.make_mesh_scene(grid=2, subdiv=1, device="cpu")[0])
    scenes.append(tmeshgen.make_sphere_field_scene(grid=5, device="cpu")[0])
    scenes.append(tmeshgen.make_sphere_field_scene(grid=5, ellipsoid=True,
                                                   device="cpu")[0])
    for scene in scenes:
        seen = []
        for table in (scene.triangles, scene.spheres, scene.planes):
            pid = table.prim_id.numpy()
            pid = pid[pid >= 0]
            assert len(np.unique(pid)) == len(pid)
            inv = ct.prim_to_row(table.prim_id, scene.n_prims)
            np.testing.assert_array_equal(
                inv[pid], np.nonzero(table.prim_id.numpy() >= 0)[0])
            seen += pid.tolist()
        assert sorted(seen) == list(range(len(seen)))


# ---------------------------------------------------------------------------
# the plain version of the kernel against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def test_traverse_reference_matches_pallas_triangles():
    ja, ta, jsel, tsel, o, d = tri_case(two_sided=True)
    hit = assert_select_matches(jsel, tsel, o, d, None, TRI_TOL)
    assert hit.any() and not hit.all()
    jhit = jdispatch.closest_hit(ja, jnp.asarray(o), jnp.asarray(d), None)
    o2, d2 = bounce_of(jhit, o, d)
    hit2 = assert_select_matches(jsel, tsel, o2, d2, jhit, TRI_TOL)
    assert hit2.any()
    # Without the skip record some bounce rays find the surface they left.
    free = tsel.select(_t(o2), _t(d2), None, EPS_B, EPS_P)
    assert int(free[1].sum()) > int(hit2.sum())


@pytest.mark.parametrize("ellipsoid", [False, True])
def test_traverse_reference_matches_pallas_sphere_leaves(ellipsoid):
    ja, ta, jsel, tsel, o, d = field_case(ellipsoid)
    hit = assert_select_matches(jsel, tsel, o, d, None, SPHERE_TOL)
    assert hit.any() and not hit.all()
    jhit = jdispatch.closest_hit(ja, jnp.asarray(o), jnp.asarray(d), None)
    o2, d2 = bounce_of(jhit, o, d)
    assert_select_matches(jsel, tsel, o2, d2, jhit, SPHERE_TOL)


def test_traverse_outputs_counters_and_parked_rays():
    _, ta, _, tsel, o, d = tri_case()
    R = o.shape[0]
    out = ct.traverse(tsel.nodes, tsel.leaves, "tri", _t(o), _t(d), None,
                      EPS_B, EPS_P, want_stats=True)
    assert isinstance(out, ct.TraverseOut)
    for name, shape, dtype in (
            ("row", (R,), torch.int32), ("t", (R,), torch.float32),
            ("prim", (R,), torch.int32), ("position", (R, 3), torch.float32),
            ("normal", (R, 3), torch.float32), ("flags", (R,), torch.int32),
            ("u", (R,), torch.float32), ("v", (R,), torch.float32),
            ("stats", (R, 2), torch.int32)):
        got = getattr(out, name)
        assert tuple(got.shape) == shape and got.dtype == dtype, name
    miss = out.row < 0
    assert bool(miss.any()) and bool((~miss).any())
    assert bool((out.prim[miss] == -1).all())
    assert bool(torch.isinf(out.t[miss]).all())
    for name in ("position", "normal", "flags", "u", "v"):
        assert not bool(getattr(out, name)[miss].any()), name
    # The winner's record: prim of its row, position on the ray at t.
    rows = out.row[~miss].long()
    assert torch.equal(out.prim[~miss], ta.triangles.prim_id[rows])
    on_ray = _t(o)[~miss] + _t(d)[~miss] * out.t[~miss][:, None]
    np.testing.assert_allclose(out.position[~miss].numpy(), on_ray.numpy(),
                               atol=1e-4)
    # Counters: every ray visits the root; a ray that hit tested a record;
    # no ray tests more records than there are triangles.
    visited, tested = out.stats[:, 0], out.stats[:, 1]
    assert int(visited.min()) >= 1 and int(visited.max()) <= tsel.n_nodes
    assert bool((tested[~miss] >= 1).all())
    assert int(tested.max()) <= int((ta.triangles.prim_id >= 0).sum())
    assert ct.traverse(tsel.nodes, tsel.leaves, "tri", _t(o), _t(d), None,
                       EPS_B, EPS_P).stats is None
    assert len(tsel.select(_t(o), _t(d), None, EPS_B, EPS_P,
                           want_stats=True)) == 4

    # A parked lane (the integrator's: far outside, pointing away) ends at
    # the root's box.
    parked_o = torch.full((8, 3), 4e8)
    parked_d = torch.zeros((8, 3))
    parked_d[:, 0] = 1.0
    parked = ct.traverse(tsel.nodes, tsel.leaves, "tri", parked_o, parked_d,
                         None, EPS_B, EPS_P, want_stats=True)
    assert bool((parked.row == -1).all())
    assert parked.stats.tolist() == [[1, 0]] * 8


def test_traverse_reference_on_axis_aligned_rays():
    """Zero direction components: the plain version gives them the finite
    inverse 3.4e38, the reference walk an infinite one with the NaN of
    0 * inf scrubbed.  Same hits, but for rays through a shared vertex or
    edge (same t, another row)."""
    _, ta, _, tsel, _, _ = tri_case()
    bvh = build_bvh(ta, leaf_size=4, backend="numpy")
    rng = np.random.default_rng(9)
    n = 192
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 2] = 6.0
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    faces = bvh.bmin.numpy()[rng.integers(0, bvh.n_nodes, n // 2)]
    o[: n // 2, 0] = faces[:, 0]
    o[n // 4: n // 2, 1] = faces[n // 4:, 1]
    # Sideways rays in the floor's plane and just above it.
    o[-32:, 2] = np.where(np.arange(32) % 2 == 0, 0.0, 0.5)
    d[-32:] = 0
    d[-32:, 0] = 1.0
    tsel = ct.CudaBVH(bvh, ta.triangles, ta.materials, ta.n_prims)
    row, hit, t = tsel.select(_t(o), _t(d), None, EPS_B, EPS_P)
    want_row, want_t = traverse_closest(bvh, ta.triangles, ta.materials,
                                        _t(o), _t(d), None, EPS_B, EPS_P)
    np.testing.assert_array_equal(hit.numpy(), (want_row >= 0).numpy())
    assert bool(hit[:160].all()) and bool(torch.isfinite(t[hit]).all())
    np.testing.assert_allclose(t.numpy(), want_t.numpy(), rtol=1e-6,
                               atol=1e-6)
    flip = (torch.where(hit, row, -1) != want_row).numpy()
    assert flip.mean() <= 0.05


def test_traverse_wrapper_rejects_bad_inputs():
    """The launch checks run before anything reaches the card, so they are
    exercised here on CPU tensors."""
    _, _, _, tsel, o, d = tri_case()
    o, d = _t(o), _t(d)
    good = (tsel.nodes, tsel.leaves, "tri", o, d, None, EPS_B, EPS_P, False)
    skip = tdispatch.HitRecord(
        prim=torch.zeros(len(o), dtype=torch.int32), t=torch.zeros(len(o)),
        position=torch.zeros_like(o), normal=torch.zeros_like(o),
        inside=torch.zeros(len(o), dtype=torch.bool))

    def bad(**kw):
        names = ("nodes", "leaves", "leaf_kind", "ray_o", "ray_d", "skip")
        args = [kw.get(n, g) for n, g in zip(names, good)] + list(good[6:])
        with pytest.raises(ValueError):
            ct._launch(*args)
    bad(ray_o=o.double())
    bad(ray_d=d[:-1])
    bad(ray_o=o.t().contiguous().t())
    bad(nodes=tsel.nodes[:, :7])
    bad(leaves=tsel.leaves[:, :-1])
    bad(skip=dataclasses.replace(skip, prim=skip.prim.long()))
    bad(skip=dataclasses.replace(skip, normal=skip.normal[:-1]))
    with pytest.raises(ValueError, match="leaf kind"):
        ct.traverse(tsel.nodes, tsel.leaves, "box", o, d, None, EPS_B, EPS_P)
    with pytest.raises(ValueError, match="nodes"):
        ct.pack_nodes(dataclasses.replace(
            build_bvh(tmeshgen.make_mesh_scene(grid=1, subdiv=0,
                                               device="cpu")[0]),
            bmin=torch.zeros((1 << 24, 3))))


# ---------------------------------------------------------------------------
# the detail route of make_bvh_closest_fn
# ---------------------------------------------------------------------------

def test_bvh_closest_fn_kernel_route_matches_jax_and_dense():
    """Smooth-shaded mesh (the winner's normal re-interpolated from the
    committed u, v), floor and light quads; no spheres, no planes."""
    ja, ta, jbvh, tbvh, o, d = mesh_case()
    assert bool(ta.triangles.smooth.any())
    jfn = jdispatch.make_bvh_closest_fn(jbvh, ja, traversal="xla")
    tfn = tdispatch.make_bvh_closest_fn(tbvh, ta, traversal="kernel")
    assert tfn.__name__ == "closest_kernel"
    before = ct.traverse.launches
    want = jfn(ja, jnp.asarray(o), jnp.asarray(d), None)
    got = tfn(ta, _t(o), _t(d), None)
    assert_hits_match(got, want)
    dense = tdispatch.closest_hit(ta, _t(o), _t(d), None)
    assert torch.equal(got.prim, dense.prim)
    o2, d2 = bounce_of(want, o, d)
    want2 = jfn(ja, jnp.asarray(o2), jnp.asarray(d2), want)
    got2 = tfn(ta, _t(o2), _t(d2), port_hit(want))
    assert_hits_match(got2, want2)
    assert ct.traverse.launches == before   # CPU tensors: the plain version
    # f64 rays come back as f64 records (the walk itself is f32).
    got64 = tfn(ta, _t(o).double(), _t(d).double(), None)
    assert got64.t.dtype == got64.normal.dtype == torch.float64
    assert torch.equal(got64.prim, got.prim)


def test_bvh_closest_fn_sends_the_dense_tail_through_select():
    """Cornell: 20 triangles in the BVH, 3 spheres (one transformed) and a
    plane in the dense tail, which goes through the select wrapper as a
    scene of its own with an empty triangle table."""
    _, thost = host_scenes("cornell")
    thost.width = thost.height = 24
    ta = ttypes.freeze_scene(thost, device="cpu")
    tfn = tdispatch.make_bvh_closest_fn(build_bvh(thost, leaf_size=4), ta,
                                        traversal="kernel")
    cam = ttypes.init_camera(thost.cameras[0], 24, 24, device="cpu")
    from raytracercore_tpu_torch.render import camera as tcam
    o, d = tcam.camera_rays(cam, *tcam.pixel_grid(24, 24, device="cpu"),
                            torch.full((576, 4), 0.5))
    def assert_same(got, want):
        # Every camera ray hits (the room is open only behind the camera).
        # A ray through two coplanar surfaces (the rotated cube stands on
        # the floor plane) may name either: same t.
        tie = (got.prim != want.prim) & ((got.t - want.t).abs() <= 1e-5)
        assert float(tie.float().mean()) < 0.02
        assert torch.equal(got.prim[~tie], want.prim[~tie])
        same = ~tie & (want.prim >= 0)
        assert float(same.float().mean()) > 0.5
        assert torch.equal(got.inside[same], want.inside[same])
        for name, tol in (("t", 1e-5), ("position", 1e-5), ("normal", 4e-5)):
            np.testing.assert_allclose(
                getattr(got, name)[same].numpy(),
                getattr(want, name)[same].numpy(), rtol=tol, atol=tol,
                err_msg=name)

    got = tfn(ta, o, d, None)
    want = tdispatch.closest_hit(ta, o, d, None)
    assert_same(got, want)
    kinds = set()
    for table in (ta.triangles, ta.spheres, ta.planes):
        pid = table.prim_id[table.prim_id >= 0]
        kinds.add(bool(torch.isin(got.prim, pid).any()))
    assert kinds == {True}   # every table wins somewhere
    # One bounce with the skip record, through all three tables.
    dn = (d * want.normal).sum(-1, keepdim=True)
    found = (want.prim >= 0)[:, None]
    o2 = torch.where(found, want.position, o)
    d2 = torch.where(found, d - 2.0 * dn * want.normal, d)
    assert_same(tfn(ta, o2, d2, want),
                tdispatch.closest_hit(ta, o2, d2, want))


@pytest.mark.parametrize("ellipsoid", [False, True])
def test_sphere_field_bvh_matches_dense(ellipsoid):
    """A field of 256 spheres (ellipsoids) gets a BVH of its own; floor and
    light are the triangle BVH; nothing is left for the dense tail.  Against
    the dense scan, primary rays and one skip-carrying bounce."""
    ja, host_cam = jmeshgen.make_sphere_field_scene(
        grid=16, width=24, height=24, ellipsoid=ellipsoid)
    ta = ttypes.scene_arrays_from_numpy(_np_tree(ja), device="cpu")
    n_sph = int((ta.spheres.prim_id >= 0).sum())
    assert n_sph == 256 >= SPHERE_BVH_MIN_ROWS
    tfn = tdispatch.make_bvh_closest_fn(build_bvh(ta, leaf_size=4), ta,
                                        traversal="kernel")
    camera = jtypes.init_camera(host_cam, 24, 24)
    o, d = jcam.center_rays(camera, *jcam.pixel_grid(24, 24))
    o, d = np.asarray(o), np.asarray(d)

    select_launches = cuda_select.closest_hit_fused.launches
    hb = tfn(ta, _t(o), _t(d), None)
    hd = jdispatch.closest_hit(ja, jnp.asarray(o), jnp.asarray(d), None)
    assert cuda_select.closest_hit_fused.launches == select_launches
    prim_d = np.asarray(hd.prim)
    assert (hb.prim.numpy() == prim_d).mean() >= 0.999
    assert ((prim_d >= 0) & (prim_d < 256)).any()   # spheres are hit
    same = (hb.prim.numpy() == prim_d) & (prim_d >= 0)
    np.testing.assert_allclose(hb.t.numpy()[same], np.asarray(hd.t)[same],
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_array_equal(hb.inside.numpy()[same],
                                  np.asarray(hd.inside)[same])
    td = tdispatch.closest_hit(ta, _t(o), _t(d), None)
    assert (hb.prim == td.prim).float().mean() >= 0.999

    o2, d2 = bounce_of(hd, o, d)
    hb2 = tfn(ta, _t(o2), _t(d2), port_hit(hd))
    hd2 = jdispatch.closest_hit(ja, jnp.asarray(o2), jnp.asarray(d2), hd)
    assert (hb2.prim.numpy() == np.asarray(hd2.prim)).mean() >= 0.999


# ---------------------------------------------------------------------------
# Renderer, train step and replay on the BVH route
# ---------------------------------------------------------------------------

def lit_mesh(grid, subdiv, size, recursion):
    """``make_mesh_scene`` with its light quad made two-sided (the
    generator's lights nothing below it): ``(SceneArrays, HostCamera)``."""
    arrays, cam, _ = tmeshgen.make_mesh_scene(
        grid=grid, subdiv=subdiv, width=size, height=size,
        recursion=recursion, device="cpu")
    two_sided = arrays.materials.two_sided.clone()
    two_sided[-1] = True
    return dataclasses.replace(arrays, materials=dataclasses.replace(
        arrays.materials, two_sided=two_sided)), cam


def test_renderer_bvh_route_matches_dense_on_mesh_722():
    arrays, cam = lit_mesh(3, 1, 12, 3)
    assert arrays.triangles.v0.shape[0] == 722
    films = {}
    for accelerator in ("bvh", "brute", "auto"):
        r = Renderer(arrays, device="cpu", cameras=[cam], seed=4,
                     accelerator=accelerator)
        assert r.route == ("bvh" if accelerator == "bvh" else "trace")
        r.step(2)
        films[accelerator] = r.film
    assert torch.equal(films["auto"].color_sum, films["brute"].color_sum)
    assert torch.equal(films["bvh"].misses, films["brute"].misses)
    assert float(films["bvh"].samples.sum()) > 0
    np.testing.assert_allclose(films["bvh"].color_sum.numpy(),
                               films["brute"].color_sum.numpy(), rtol=1e-4,
                               atol=1e-4)
    # One row more than the dense tier takes: "auto" goes to the BVH.
    big, cam = lit_mesh(4, 1, 4, 1)
    assert big.triangles.v0.shape[0] > SELECT_MAX_PRIMS
    r = Renderer(big, device="cpu", cameras=[cam])
    assert r.route == "bvh"
    r.step(1)
    assert bool(torch.isfinite(r.film.color_sum).all())


def test_train_step_through_bvh_matches_dense():
    """A whole step (record, replay, gradients, SGD) whose closest hit runs
    through ``make_bvh_closest_fn`` equals the dense step: the BVH picks the
    same winners."""
    arrays, cam = lit_mesh(1, 1, 16, 3)
    camera = ttypes.init_camera(
        ttypes.HostCamera(
            mode="frustum", position=np.array([0.0, -5.0, 3.0]),
            look_at=np.array([0.0, 0.0, 0.9]), up=np.array([0.0, 0.0, 1.0]),
            fov_or_size=np.deg2rad(45.0)), 16, 16, device="cpu")
    bvh = build_bvh(arrays, leaf_size=4)
    target = torch.zeros((16, 16, 3))
    out = {}
    for name, fn in (
            ("dense", None),
            ("walk", tdispatch.make_bvh_closest_fn(bvh, arrays,
                                                   traversal="walk")),
            ("kernel", tdispatch.make_bvh_closest_fn(bvh, arrays,
                                                     traversal="kernel"))):
        params = get_material_params(arrays)
        opt = torch.optim.SGD(params.values(), lr=1e-2)
        step = (make_train_step(None, opt) if fn is None
                else make_train_step(None, opt, closest_fn=fn))
        loss = step(params, arrays, camera, target, 5)
        out[name] = (float(loss), {k: v.detach().numpy()
                                   for k, v in params.items()})
    start = get_material_params(arrays)
    moved = sum(int((out["dense"][1][k] != start[k].detach().numpy()).sum())
                for k in MATERIAL_FIELDS)
    assert moved > 5 and np.isfinite(out["dense"][0])
    for name in ("walk", "kernel"):
        assert out[name][0] == pytest.approx(out["dense"][0], rel=1e-6)
        for k in MATERIAL_FIELDS:
            np.testing.assert_allclose(out[name][1][k], out["dense"][1][k],
                                       atol=1e-6, err_msg=f"{name} {k}")


def test_replay_above_768_material_rows():
    """A mesh has one material row per triangle.  ``trace_replay`` records
    through the BVH closest hit and replays through the kernels' plain
    versions, which take a table of any size: colours equal ``trace``'s,
    gradients equal autograd's through ``replay``."""
    arrays, cam = lit_mesh(4, 1, 16, 3)
    n_mats = arrays.materials.emission.shape[0]
    assert n_mats == 1282 > rk.MAX_KERNEL_MATS
    fn = tdispatch.make_bvh_closest_fn(build_bvh(arrays), arrays,
                                       traversal="kernel")
    camera = ttypes.init_camera(cam, 16, 16, device="cpu")
    from raytracercore_tpu_torch.render import camera as tcam
    gen = torch.Generator().manual_seed(3)
    o, d = tcam.camera_rays(camera, *tcam.pixel_grid(16, 16, device="cpu"),
                            torch.rand((256, 4), generator=gen))
    u = prepare_uniforms(gen, 256, arrays.recursion + 1, "cpu")

    from raytracercore_tpu_torch.diff import with_material_params

    def loss_grads(trace_fn):
        p = get_material_params(arrays)
        color, miss = trace_fn(with_material_params(arrays, p))
        torch.where(miss[:, None], 0.0, color).square().mean().backward()
        return color.detach(), miss, {k: v.grad for k, v in p.items()}

    with torch.no_grad():
        _, _, tape = trace(arrays, o, d, None, closest_fn=fn, uniforms=u,
                           want_tape=True)
    c_k, m_k, g_k = loss_grads(lambda s: trace_replay(
        s, o, d, uniforms=u, closest_fn=fn))
    c_r, m_r, g_r = loss_grads(lambda s: replay(s, o, d, u, tape))
    c_t, m_t, _ = loss_grads(lambda s: trace(s, o, d, None, closest_fn=fn,
                                             uniforms=u))
    assert torch.equal(m_k, m_r) and torch.equal(m_k, m_t)
    assert not bool(m_k.all()) and float(c_k.max()) > 0.05
    np.testing.assert_allclose(c_k.numpy(), c_r.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c_k.numpy(), c_t.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert int((g_r["diffuse"] != 0).sum()) > 5
    for k in MATERIAL_FIELDS:
        assert g_k[k].shape[0] == n_mats
        scale = float(g_r[k].abs().max())
        np.testing.assert_allclose(g_k[k].numpy(), g_r[k].numpy(), rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=k)
    # The blocks of a launch above the shared-memory cap: one per 128 paths.
    assert rk._kernel_args(d, u, tape, *rk.material_table(arrays))[2] \
        == n_mats


def test_cli_optimize_above_the_dense_tier(tmp_path):
    """``cli optimize`` on a scene above ``SELECT_MAX_PRIMS`` table rows
    trains through the BVH tier (the dense recorder refuses such a scene)."""
    scene = tmp_path / "field.txt"
    scene.write_text(
        "size 4 4\nrecursion 2\nambient color .2 .2 .2\n"
        "camera 0 0 5  0 0 0  0 1 0  40\ndiffuse .5 .4 .3\n" + "".join(
            f"sphere {(i % 40 - 20) * .1} {(i // 40 - 10) * .1} 0 .05\n"
            for i in range(SELECT_MAX_PRIMS + 32)))
    target = tmp_path / "target.png"
    write_png(str(target), np.full((4, 4, 3), 90, np.uint8))
    params = tmp_path / "materials.npz"
    subprocess.run(
        [sys.executable, "-m", "raytracercore_tpu_torch.tools.cli",
         "optimize", str(scene), "--device", "cpu", "--steps", "2",
         "--target", str(target), "-o", str(params)],
        check=True, cwd=REPO_ROOT, capture_output=True, timeout=300)
    with np.load(params) as data:
        assert data["diffuse"].shape == (SELECT_MAX_PRIMS + 32, 3)
        assert np.isfinite(data["diffuse"]).all()
        # Two Adam steps moved the emission of the spheres the camera sees.
        moved = np.abs(data["emission"]).max(axis=1) > 1e-3
        assert 0 < int(moved.sum()) < SELECT_MAX_PRIMS + 32


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tri", "sph", "spht"])
def test_traverse_kernel_matches_reference_on_card(cuda_device, kind):  # noqa: F811
    if kind == "tri":
        _, ta, _, _, o, d = tri_case()
        scene = ta.to(cuda_device)
        sel = ct.CudaBVH(build_bvh(scene, leaf_size=4), scene.triangles,
                         scene.materials, scene.n_prims)
    else:
        _, ta, _, tsel, o, d = field_case(kind == "spht")
        scene = ta.to(cuda_device)
        sel = tsel
        sel.nodes, sel.leaves = (x.to(cuda_device) for x in (sel.nodes,
                                                             sel.leaves))
    o, d = _t(o).to(cuda_device), _t(d).to(cuda_device)
    hit = tdispatch.closest_hit(scene, o, d, None)
    found = (hit.prim >= 0)[:, None]
    dn = (d * hit.normal).sum(-1, keepdim=True)
    o2 = torch.where(found, hit.position, o).contiguous()
    d2 = torch.where(found, d - 2.0 * dn * hit.normal, d).contiguous()
    for rays, skip in (((o, d), None), ((o2, d2), hit)):
        before = ct.traverse.launches
        args = (sel.nodes, sel.leaves, kind, *rays, sel._skip(skip), EPS_B,
                EPS_P, True)
        got = ct.traverse(*args)
        assert ct.traverse.launches == before + 1
        want = ct.traverse_reference(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(ct.TraverseOut._fields, got, want):
            assert torch.equal(g, w), name
        assert bool((got.row >= 0).any())


@pytest.mark.cuda
def test_bvh_route_on_card_launches_the_traversal_kernel(cuda_device):  # noqa: F811
    """Above the dense tier on CUDA tensors: the dense ``closest_hit``
    raises, ``Renderer`` takes the BVH route and launches the traversal
    kernel once per bounce, the train step the replay kernels."""
    arrays, cam = lit_mesh(4, 1, 32, 3)
    r = Renderer(arrays, device="cuda", cameras=[cam])
    assert r.route == "bvh"
    before = ct.traverse.launches
    r.step(2)
    assert ct.traverse.launches == before + 2 * 4
    assert bool(torch.isfinite(r.film.color_sum).all())
    scene = r.arrays
    params = get_material_params(scene)
    step = make_train_step(None, torch.optim.SGD(params.values(), lr=1e-2),
                           closest_fn=r.closest_fn)
    launches = (rk.replay_fwd.launches, rk.replay_bwd.launches)
    loss = step(params, scene, r.camera, torch.zeros((32, 32, 3),
                                                     device=cuda_device), 5)
    assert np.isfinite(float(loss))
    assert (rk.replay_fwd.launches, rk.replay_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    with pytest.raises(NotImplementedError, match="make_bvh_closest_fn"):
        trace_replay(scene, *(torch.zeros((4, 3), device=cuda_device),) * 2,
                     seed=0)
    # "auto" without a scene to pack cannot take the kernel: on CUDA rays
    # it raises, it does not walk in torch unasked.
    walk = tdispatch.make_bvh_closest_fn(r.bvh)
    with pytest.raises(ValueError, match="traversal"):
        walk(scene, *(torch.zeros((4, 3), device=cuda_device),) * 2, None)
