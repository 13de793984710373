"""The port's BVH builder (``bvh/builder.py``, ``bvh/native.py``), its
reference walk (``bvh/traverse.py``), ``torch_ref.aabb_slab`` and the hooks
route of ``dispatch.make_bvh_closest_fn`` against the JAX package.

Inputs are made with numpy from seeds, or by the generators both packages
share (``scene.meshgen``), and handed to both.  What is held:

* the numpy builder is a copy of the JAX one: its five arrays are equal;
* the native builder keeps the layout's contract (every row in exactly one
  leaf, skip links strictly forward, every box encloses its rows' boxes and
  its children) and the walk through its tree finds the same hits;
* ``traverse_closest`` returns JAX ``traverse_closest``'s rows exactly and
  its t within 1e-6, on primary rays and on a skip-carrying bounce;
* ``make_bvh_closest_fn(traversal="walk")`` names the primitives of JAX
  ``make_bvh_closest_fn(traversal="xla")`` and of the port's dense
  ``closest_hit``, floats within 1e-5 (the tolerances of
  ``test_torch_dispatch.assert_hits_match``), and its material gradients
  through ``trace`` equal the dense route's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.bvh import builder as jbuilder
from raytracercore_tpu.bvh import traverse as jtraverse
from raytracercore_tpu.core import vecmath as jvm
from raytracercore_tpu.intersect import dispatch as jdispatch
from raytracercore_tpu.intersect import jnp_ref
from raytracercore_tpu.render import camera as jcam
from raytracercore_tpu.scene import meshgen as jmeshgen
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.bvh import (BVHArrays, build_bvh, builder,
                                         bvh_arrays_from_numpy,
                                         count_node_hits, native,
                                         traverse_closest)
from raytracercore_tpu_torch.core import vecmath as tvm
from raytracercore_tpu_torch.diff import (get_material_params,
                                          with_material_params)
from raytracercore_tpu_torch.intersect import dispatch as tdispatch
from raytracercore_tpu_torch.intersect import torch_ref
from raytracercore_tpu_torch.render.integrator import trace
from raytracercore_tpu_torch.scene import meshgen as tmeshgen
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_dispatch import assert_hits_match, port_hit, scene_pair

FIELDS = [f.name for f in dataclasses.fields(BVHArrays)]
EPS_B = jvm.near_enough(jnp.float32)
EPS_P = jdispatch._position_eps(jnp.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def mesh_case(grid=2, subdiv=1, size=16, leaf_size=4, two_sided=False):
    """Both packages' arrays of ``make_mesh_scene`` (equal values), the JAX
    numpy-built triangle BVH carried over to the port, and the centre rays
    of the generator's camera: ``(ja, ta, jbvh, tbvh, o, d)`` (numpy
    rays).  ``two_sided`` makes every material two-sided, so that a ray
    leaving a surface finds that surface again at t = 0 unless the skip
    record takes it out."""
    ja, host_cam, host = jmeshgen.make_mesh_scene(
        grid=grid, subdiv=subdiv, width=size, height=size, recursion=2)
    if two_sided:
        ja = ja.replace(materials=ja.materials.replace(
            two_sided=jnp.ones_like(ja.materials.two_sided)))
    ta = ttypes.scene_arrays_from_numpy(
        jax.tree_util.tree_map(np.asarray, ja), device="cpu")
    jbvh = jbuilder.build_triangle_bvh(*host, leaf_size=leaf_size,
                                       backend="numpy")
    tbvh = bvh_arrays_from_numpy(jax.tree_util.tree_map(np.asarray, jbvh),
                                 device="cpu")
    camera = jtypes.init_camera(host_cam, size, size)
    px, py = jcam.pixel_grid(size, size)
    o, d = jcam.center_rays(camera, px, py)
    return ja, ta, jbvh, tbvh, np.asarray(o), np.asarray(d)


def bounce_of(jhit, o, d):
    """Mirror-bounce rays leaving the hits ``jhit`` (numpy in, numpy
    out): the skip-carrying query of the JAX traversal tests."""
    found = np.asarray(jhit.prim) >= 0
    pos, nrm = np.asarray(jhit.position), np.asarray(jhit.normal)
    o2 = np.where(found[:, None], pos, o)
    dn = np.sum(d * nrm, axis=-1, keepdims=True)
    d2 = np.where(found[:, None], d - 2.0 * dn * nrm, d)
    return o2.astype(np.float32), d2.astype(np.float32)


def assert_bvh_equal(got: BVHArrays, want):
    for name in FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def boxes_of(kind):
    """Per-row boxes ``(bmin, bmax, valid)`` of one primitive table, from
    the port's bounds functions."""
    if kind == "tri":
        _, _, (v0, e1, e2, mirror, valid) = tmeshgen.make_mesh_scene(
            grid=2, subdiv=1, device="cpu")
        return (*builder.triangle_bounds(v0, e1, e2, mirror), valid)
    arrays, _ = tmeshgen.make_sphere_field_scene(
        grid=7, ellipsoid=kind == "spht", device="cpu")
    sph = arrays.spheres
    c, r = sph.center.numpy(), sph.radius.numpy()
    valid = sph.prim_id.numpy() >= 0
    if kind == "sph":
        return (*builder.sphere_bounds(c, r), valid)
    return (*builder.ellipsoid_bounds(c, r, sph.obj_to_world.numpy()), valid)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf_size", [2, 4, 8])
def test_numpy_triangle_builder_equals_jax(leaf_size):
    _, _, host = jmeshgen.make_mesh_scene(grid=2, subdiv=1)
    want = jbuilder.build_triangle_bvh(*host, leaf_size=leaf_size,
                                       backend="numpy")
    got = builder.build_triangle_bvh(*host, leaf_size=leaf_size,
                                     backend="numpy", device="cpu")
    assert got.n_nodes == want.n_nodes > 3
    assert_bvh_equal(got, want)
    # Carried over from the JAX arrays, the tree is the same again.
    assert_bvh_equal(bvh_arrays_from_numpy(
        jax.tree_util.tree_map(np.asarray, want), device="cpu"), want)
    assert_bvh_equal(bvh_arrays_from_numpy(
        {f: np.asarray(getattr(want, f)) for f in FIELDS}, device="cpu"), want)


@pytest.mark.parametrize("ellipsoid", [False, True])
def test_numpy_sphere_builders_equal_jax(ellipsoid):
    ja, _ = jmeshgen.make_sphere_field_scene(grid=7, ellipsoid=ellipsoid)
    sph = jax.tree_util.tree_map(np.asarray, ja.spheres)
    valid = sph.prim_id >= 0
    if ellipsoid:
        args = (sph.center, sph.radius, sph.obj_to_world, valid)
        want = jbuilder.build_ellipsoid_bvh(*args, leaf_size=4,
                                            backend="numpy")
        got = builder.build_ellipsoid_bvh(*args, leaf_size=4,
                                          backend="numpy", device="cpu")
        for a, b in zip(builder.ellipsoid_bounds(*args[:3]),
                        jbuilder.ellipsoid_bounds(*args[:3])):
            np.testing.assert_array_equal(a, b)
    else:
        args = (sph.center, sph.radius, valid)
        want = jbuilder.build_sphere_bvh(*args, leaf_size=4, backend="numpy")
        got = builder.build_sphere_bvh(*args, leaf_size=4, backend="numpy",
                                       device="cpu")
    assert got.n_nodes > 3
    assert_bvh_equal(got, want)


def test_build_bvh_takes_host_scenes_and_frozen_arrays():
    """``build_bvh`` of a ``HostScene`` equals JAX ``build_bvh``; of the
    frozen arrays of the same scene it holds the same rows; an empty table
    gives the one-node tree."""
    from test_torch_scene import host_scenes

    jhost, thost = host_scenes("cornell")
    want = jbuilder.build_bvh(jhost, leaf_size=4)
    got = build_bvh(thost, leaf_size=4, backend="numpy")
    assert_bvh_equal(got, want)
    # The frozen table is f32, so a split may fall otherwise: the same
    # rows under the same root box, in a tree that keeps the contract.
    arrays = ttypes.freeze_scene(thost, device="cpu")
    frozen = build_bvh(arrays, leaf_size=4, backend="numpy")
    tri = arrays.triangles
    bmin, bmax = builder.triangle_bounds(
        tri.v0.numpy(), tri.e1.numpy(), tri.e2.numpy(), tri.mirror.numpy())
    check_contract(frozen, bmin, bmax, tri.prim_id.numpy() >= 0, 4)
    for name in ("bmin", "bmax"):
        np.testing.assert_allclose(getattr(frozen, name).numpy()[0],
                                   getattr(got, name).numpy()[0], atol=1e-6)

    spheres_only = thost.__class__(width=4, height=4)
    empty = build_bvh(spheres_only, leaf_size=4)
    assert_bvh_equal(empty, jbuilder.build_bvh(
        jhost.__class__(width=4, height=4), leaf_size=4))
    assert empty.n_nodes == 1 and int(empty.skip[0]) == 1
    assert build_bvh(thost).leaf_prims.shape[1] == builder.BVH_LEAF_SIZE
    with pytest.raises(ValueError, match="backend"):
        build_bvh(thost, backend="cuda")


def check_contract(bvh: BVHArrays, bmin, bmax, valid, leaf_size):
    """The skip-link layout's invariants over the rows ``valid``."""
    n = bvh.n_nodes
    skip, slot = bvh.skip.numpy(), bvh.leaf_slot.numpy()
    prims = bvh.leaf_prims.numpy()
    nb_min, nb_max = bvh.bmin.numpy(), bvh.bmax.numpy()
    assert (skip > np.arange(n)).all() and (skip <= n).all()
    assert prims.shape[1] == leaf_size
    # Every valid row in exactly one leaf; the valid entries are a prefix.
    used = prims[prims >= 0]
    assert sorted(used.tolist()) == np.nonzero(valid)[0].tolist()
    assert ((prims[:, 1:] < 0) | (prims[:, :-1] >= 0)).all()
    # Every leaf has its own slot, inner nodes none.
    leaves = np.nonzero(slot >= 0)[0]
    assert sorted(slot[leaves].tolist()) == list(range(prims.shape[0]))
    for i in range(n):
        if slot[i] >= 0:
            rows = prims[slot[i]]
            rows = rows[rows >= 0]
            assert skip[i] == i + 1 and len(rows) > 0
            assert (nb_min[i] <= bmin[rows].min(0)).all()
            assert (nb_max[i] >= bmax[rows].max(0)).all()
        else:
            # Preorder: the left child follows, the right one is where the
            # left one's subtree ends; both lie inside their parent.
            for j in (i + 1, skip[i + 1]):
                assert j < skip[i]
                assert (nb_min[j] >= nb_min[i]).all()
                assert (nb_max[j] <= nb_max[i]).all()
            assert skip[skip[i + 1]] == skip[i]


@pytest.mark.parametrize("kind,leaf_size,backend", [
    ("tri", 4, "numpy"), ("tri", 2, "native"), ("tri", 4, "native"),
    ("tri", 8, "native"), ("sph", 4, "native"), ("spht", 4, "native")])
def test_builder_contract(kind, leaf_size, backend):
    bmin, bmax, valid = boxes_of(kind)
    # Some rows left out: the leaves then index the table, not the subset.
    valid = valid.copy()
    valid[1::7] = False
    bvh = builder.build_boxes_bvh(bmin, bmax, valid, leaf_size,
                                  backend=backend, device="cpu")
    check_contract(bvh, bmin.astype(np.float32), bmax.astype(np.float32),
                   valid, leaf_size)


def test_native_builder_builds_from_the_ports_own_source(tmp_path,
                                                         monkeypatch):
    assert native.SOURCE.name == "bvh_builder.cpp"
    assert "raytracercore_tpu_torch" in str(native.SOURCE)
    assert native.library_path().parent.name == "build"
    bmin, bmax, valid = boxes_of("tri")
    out = native.build_bvh_native(bmin[valid].astype(np.float32),
                                  bmax[valid].astype(np.float32), 4)
    assert [a.dtype for a in out] == [np.float32] * 2 + [np.int32] * 3
    assert out[4].shape[1] == 4 and out[0].shape == out[1].shape
    # "auto" takes the numpy builder for a small table, "native" the
    # library: both find the rows.
    auto = builder.build_boxes_bvh(bmin, bmax, valid, 4, backend="auto",
                                   device="cpu")
    nat = builder.build_boxes_bvh(bmin, bmax, valid, 4, backend="native",
                                  device="cpu")
    assert (auto.leaf_prims >= 0).sum() == (nat.leaf_prims >= 0).sum()

    # Without a compiler (and nothing built) "native" raises; it does not
    # hand the work to the numpy builder.
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_compiler", lambda: "/nonexistent/c++")
    with pytest.raises((RuntimeError, OSError)):
        builder.build_boxes_bvh(bmin, bmax, valid, 4, backend="native",
                                device="cpu")


# ---------------------------------------------------------------------------
# slab test and node heat map
# ---------------------------------------------------------------------------

def test_aabb_slab_matches_jnp_ref():
    rng = np.random.default_rng(5)
    lo = rng.uniform(-3, 2, (40, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (40, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (96, 3)).astype(np.float32)
    d = rng.normal(size=(96, 3)).astype(np.float32)
    # Axis-aligned rays, some starting on a box face.
    d[64:] = 0
    d[np.arange(64, 96), rng.integers(0, 3, 32)] = rng.choice([-1, 1], 32)
    o[80:, 0] = lo[:16, 0]
    want = jnp_ref.aabb_slab(jnp.asarray(lo), jnp.asarray(hi),
                             jnp.asarray(o), jnp.asarray(d))
    got = torch_ref.aabb_slab(_t(lo), _t(hi), _t(o), _t(d))
    for g, w in zip(got, want):
        assert g.shape == (96, 40)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    hit = np.asarray(want[0]) <= np.asarray(want[1])
    assert hit.any() and not hit.all()


def test_count_node_hits_matches_jax():
    _, _, jbvh, tbvh, o, d = mesh_case()
    want = np.asarray(jtraverse.count_node_hits(jbvh, jnp.asarray(o),
                                                jnp.asarray(d)))
    got = count_node_hits(tbvh, _t(o), _t(d)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() > 3 and got.max() <= tbvh.n_nodes


# ---------------------------------------------------------------------------
# the reference walk
# ---------------------------------------------------------------------------

def walk_both(ja, ta, jbvh, tbvh, o, d, jskip, max_flips=0.0):
    """Both packages' walks on the same rays: rows equal and t within 1e-6.
    ``max_flips``: the share of rays that may name another row at the same
    t (a ray through a vertex or an edge that several triangles share)."""
    want_idx, want_t = jtraverse.traverse_closest(
        jbvh, ja.triangles, ja.materials, jnp.asarray(o), jnp.asarray(d),
        jskip, EPS_B, EPS_P)
    skip = None if jskip is None else port_hit(jskip)
    got_idx, got_t = traverse_closest(
        tbvh, ta.triangles, ta.materials, _t(o), _t(d), skip,
        tvm.near_enough(torch.float32),
        tdispatch._position_eps(torch.float32))
    assert got_idx.dtype == torch.int32
    hit = np.asarray(want_idx) >= 0
    flip = (got_idx.numpy() != np.asarray(want_idx)) & hit \
        & (got_idx.numpy() >= 0)
    assert flip.mean() <= max_flips
    np.testing.assert_array_equal(got_idx.numpy()[~flip],
                                  np.asarray(want_idx)[~flip])
    np.testing.assert_allclose(got_t.numpy()[hit], np.asarray(want_t)[hit],
                               rtol=1e-6, atol=1e-6)
    assert np.isinf(got_t.numpy()[~hit]).all()
    return hit


@pytest.mark.parametrize("leaf_size", [4, 8])
def test_traverse_closest_matches_jax_walk(leaf_size):
    ja, ta, jbvh, tbvh, o, d = mesh_case(leaf_size=leaf_size,
                                         two_sided=True)
    hit = walk_both(ja, ta, jbvh, tbvh, o, d, None)
    assert hit.any() and not hit.all()
    # One bounce from the first hits, with them as skip records; without
    # the records the rays find the surface they left.
    jhit = jdispatch.closest_hit(ja, jnp.asarray(o), jnp.asarray(d), None)
    o2, d2 = bounce_of(jhit, o, d)
    hit2 = walk_both(ja, ta, jbvh, tbvh, o2, d2, jhit)
    free = walk_both(ja, ta, jbvh, tbvh, o2, d2, None)
    assert hit2.any() and free.sum() > hit2.sum()


def test_traverse_closest_on_axis_aligned_rays():
    """Zero direction components (the infinite inverse and its NaN scrub):
    rays along the axes, some starting exactly on a node's box face."""
    ja, ta, jbvh, tbvh, _, _ = mesh_case()
    rng = np.random.default_rng(9)
    n = 192
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 2] = 6.0
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    faces = np.asarray(jbvh.bmin)[rng.integers(0, jbvh.n_nodes, n // 2)]
    o[: n // 2, 0] = faces[:, 0]
    o[n // 4: n // 2, 1] = faces[n // 4:, 1]
    # The faces of the boxes are coordinates of vertices: such a ray runs
    # through a vertex or along an edge, where the triangles that share it
    # tie in t and the last bit decides.
    hit = walk_both(ja, ta, jbvh, tbvh, o, d, None, max_flips=0.05)
    assert hit.all()   # the floor quad is below every ray


# ---------------------------------------------------------------------------
# the hooks route of make_bvh_closest_fn
# ---------------------------------------------------------------------------

def test_bvh_closest_fn_walk_matches_jax_and_dense():
    ja, ta, jbvh, tbvh, o, d = mesh_case()
    jfn = jdispatch.make_bvh_closest_fn(jbvh, ja, traversal="xla")
    for tfn in (tdispatch.make_bvh_closest_fn(tbvh, traversal="walk"),
                tdispatch.make_bvh_closest_fn(tbvh, ta, traversal="walk"),
                tdispatch.make_bvh_closest_fn(tbvh, ta)):  # "auto" on CPU
        assert tfn.__name__ == "closest_walk"
        want = jfn(ja, jnp.asarray(o), jnp.asarray(d), None)
        got = tfn(ta, _t(o), _t(d), None)
        assert_hits_match(got, want)
        dense = tdispatch.closest_hit(ta, _t(o), _t(d), None)
        assert torch.equal(got.prim, dense.prim)
        np.testing.assert_allclose(got.t.numpy(), dense.t.numpy(),
                                   rtol=1e-6, atol=1e-6)

        o2, d2 = bounce_of(want, o, d)
        want2 = jfn(ja, jnp.asarray(o2), jnp.asarray(d2), want)
        got2 = tfn(ta, _t(o2), _t(d2), port_hit(want))
        assert_hits_match(got2, want2)
    with pytest.raises(ValueError, match="traversal"):
        tdispatch.make_bvh_closest_fn(tbvh, ta, traversal="pallas")
    with pytest.raises(ValueError, match="scene"):
        tdispatch.make_bvh_closest_fn(tbvh, traversal="kernel")


def test_gradients_through_the_bvh_walk_equal_the_dense_route():
    """``trace`` with the hooks route differentiates the winners like the
    dense route: same colours, same material gradients (the walk picks the
    same rows, and the winner's evaluation is shared)."""
    _, ta = scene_pair("mesh-82", recursion=3)
    bvh = build_bvh(ta, leaf_size=4)
    fn = tdispatch.make_bvh_closest_fn(bvh, ta, traversal="walk")
    rng = np.random.default_rng(3)
    n = 128
    o = np.tile(np.float32([[0.0, -5.0, 3.0]]), (n, 1))
    d = np.float32([0.0, 0.0, 0.9]) + rng.uniform(-1, 1, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    u = _t(rng.uniform(0.01, 0.99, (4, 7, n)).astype(np.float32))
    grads = []
    for closest_fn in (tdispatch.closest_hit, fn):
        p = get_material_params(ta)
        color, miss = trace(with_material_params(ta, p), _t(o), _t(d), None,
                            closest_fn=closest_fn, uniforms=u)
        torch.where(miss[:, None], 0.0, color).square().mean().backward()
        grads.append((color.detach(), miss, {k: v.grad for k, v in
                                             p.items()}))
    (c0, m0, g0), (c1, m1, g1) = grads
    assert torch.equal(m0, m1) and not bool(m0.all())
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), rtol=1e-6, atol=1e-6)
    assert float(g0["diffuse"].abs().sum()) > 0
    for k in g0:
        scale = float(g0[k].abs().max())
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=0,
                                   atol=1e-5 * scale + 1e-12, err_msg=k)
