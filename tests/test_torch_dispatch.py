"""The port's grid intersection functions (``intersect/torch_ref.py``) and
dense closest hit (``intersect/dispatch.py``) against the JAX package's
``jnp_ref`` and ``dispatch.closest_hit``.

Both packages get the same scene arrays (the JAX arrays carried over with
``scene_arrays_from_numpy``) and the same rays, made with numpy from a
seed: random rays, rays aimed at the geometry, and axis-aligned rays lying
in and beside the planes of axis-aligned quads (the degenerate ``det == 0``
branch and its on-plane check).

Tolerances: masks, primitive ids and inside flags are equal; floats agree
to 1e-6 absolute + 1e-5 relative for the grid functions (same formulas, f32,
another summation order) and to 1e-5 for the closest-hit record (4e-5 for
its normals, see ``assert_hits_match``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.core import vecmath as jvm
from raytracercore_tpu.intersect import dispatch as jdispatch
from raytracercore_tpu.intersect import jnp_ref
from raytracercore_tpu.scene import meshgen as jmeshgen
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.core import vecmath as tvm
from raytracercore_tpu_torch.intersect import dispatch as tdispatch
from raytracercore_tpu_torch.intersect import torch_ref
from raytracercore_tpu_torch.intersect.dispatch import HitRecord
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_scene import host_scenes

ATOL, RTOL = 1e-6, 1e-5   # grid functions
HIT_TOL = 1e-5            # closest-hit record


def _t(a):
    return torch.tensor(np.asarray(a))


def scene_pair(name, **overrides):
    """(JAX SceneArrays, port SceneArrays) holding the same values:
    ``cornell`` and the other named text scenes are frozen by the JAX
    package, ``mesh-82`` is its ``make_mesh_scene(grid=1, subdiv=1)`` with
    the light quad made two-sided (the generator's light faces up and is
    single-sided, so it lights nothing below it and no colour would depend
    on a diffuse material); the port's copy is carried over array by
    array."""
    if name == "mesh-82":
        kw = dict(grid=1, subdiv=1, width=16, height=16)
        kw.update(overrides)
        ja = jmeshgen.make_mesh_scene(**kw)[0]
        mats = ja.materials
        ja = ja.replace(materials=mats.replace(
            two_sided=mats.two_sided.at[-1].set(True)))
    else:
        jhost, _ = host_scenes(name)
        for k, v in overrides.items():
            setattr(jhost, k, v)
        ja = jtypes.freeze_scene(jhost)
    ta = ttypes.scene_arrays_from_numpy(
        jax.tree_util.tree_map(np.asarray, ja), device="cpu")
    return ja, ta


def rays_for(name, n, seed):
    """``(o, d)`` float32 numpy rays for a scene: a third random, a third
    aimed at the geometry, a third axis-aligned in or beside the planes of
    the scene's axis-aligned quads."""
    rng = np.random.default_rng(seed)
    k = n // 3
    if name == "mesh-82":
        eye, centre, spread = (0.0, -8.0, 4.0), (0.0, 0.0, 1.0), 1.4
        plane_axis, plane_at = 2, 0.0    # the floor quad, z = 0
    else:
        eye, centre, spread = (0.0, 2.0, 6.5), (0.0, 1.5, 0.0), 2.0
        plane_axis, plane_at = 1, 4.0    # the room's ceiling quad, y = 4
    o1 = rng.uniform(-3, 3, (k, 3))
    d1 = rng.normal(size=(k, 3))
    o2 = np.asarray(eye) + rng.normal(0, 0.3, (k, 3))
    d2 = np.asarray(centre) + rng.uniform(-spread, spread, (k, 3)) - o2
    m = n - 2 * k
    o3 = rng.uniform(-1.5, 1.5, (m, 3))
    # in the quad's plane, or a little off it
    o3[:, plane_axis] = plane_at + rng.choice([0.0, 0.0, -0.25, 0.5], m)
    d3 = np.zeros((m, 3))
    axes = rng.integers(0, 3, m)
    d3[np.arange(m), axes] = rng.choice([-1.0, 1.0], m)
    o = np.concatenate([o1, o2, o3])
    d = np.concatenate([d1, d2, d3])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def assert_close(got, want, where=None, tol=(ATOL, RTOL), msg=""):
    got, want = np.asarray(got), np.asarray(want)
    if where is not None:
        got, want = got[where], want[where]
    np.testing.assert_allclose(got, want, atol=tol[0], rtol=tol[1],
                               err_msg=msg)


def port_hit(jhit) -> HitRecord:
    return HitRecord(prim=_t(jhit.prim), t=_t(jhit.t),
                     position=_t(jhit.position), normal=_t(jhit.normal),
                     inside=_t(jhit.inside))


def assert_hits_match(got: HitRecord, want, tol=HIT_TOL):
    """prim and inside equal, floats within ``tol``.  The one exception: a
    ray through two coplanar surfaces (Cornell's rotated cube stands on the
    floor plane) may name either of them; there the two hits have the same
    t, and such rays stay below 2 %."""
    got_prim, want_prim = got.prim.numpy(), np.asarray(want.prim)
    found = want_prim >= 0
    assert found.any() and not found.all()
    dt = np.abs(got.t.detach().numpy() - np.asarray(want.t))
    tie = (got_prim != want_prim) & found & (got_prim >= 0) & (dt <= tol)
    np.testing.assert_array_equal(got_prim[~tie], want_prim[~tie])
    assert tie.mean() < 0.02
    same = found & ~tie
    np.testing.assert_array_equal(got.inside.numpy()[same],
                                  np.asarray(want.inside)[same])
    # A sphere's normal is its hit position over its radius: the
    # position's f32 error (rays here are up to ~8 long) grows by 1/0.45
    # on Cornell's smallest sphere, hence 4x the tolerance on normals.
    for field, k in (("t", 1), ("position", 1), ("normal", 4)):
        np.testing.assert_allclose(
            getattr(got, field).detach().numpy()[same],
            np.asarray(getattr(want, field))[same], rtol=k * tol,
            atol=k * tol, err_msg=field)


# ---------------------------------------------------------------------------
# torch_ref vs jnp_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cornell", "mesh-82", "smooth"])
def test_triangle_candidates_match_jnp_ref(name):
    ja, ta = scene_pair(name)
    o, d = rays_for(name, 240, 1)
    eps = jvm.near_enough(jnp.float32)
    assert eps == tvm.near_enough(torch.float32)
    want = jnp_ref.triangle_candidates(ja.triangles, jnp.asarray(o),
                                       jnp.asarray(d), eps)
    got = torch_ref.triangle_candidates(ta.triangles, _t(o), _t(d), eps)
    valid = np.asarray(want["valid"])
    assert valid.any()
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["inside"].numpy()[valid],
                                  np.asarray(want["inside"])[valid])
    assert_close(got["t"], want["t"], msg="t")  # inf where not valid
    for k in ("u", "v"):
        assert_close(got[k], want[k], where=valid, msg=k)
    if name != "smooth":
        # The axis-aligned rays reach the degenerate branch: t == 0 hits
        # that lie in a quad's plane, and they are the same ones.
        degenerate = valid & (np.asarray(want["t"]) == 0)
        assert degenerate.any()


@pytest.mark.parametrize("name", ["cornell", "smooth", "mesh-82"])
def test_triangle_hit_detail_matches_jnp_ref(name):
    ja, ta = scene_pair(name)
    rng = np.random.default_rng(2)
    n, rows = 200, ja.triangles.v0.shape[0]
    idx = rng.integers(0, rows, n).astype(np.int32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    inside = rng.integers(0, 2, n) == 1
    want = jnp_ref.triangle_hit_detail(ja.triangles, jnp.asarray(idx),
                                       jnp.asarray(u), jnp.asarray(v),
                                       jnp.asarray(inside))
    got = torch_ref.triangle_hit_detail(ta.triangles, _t(idx).long(), _t(u),
                                        _t(v), _t(inside))
    for g, w, what in zip(got, want, ("position", "normal")):
        assert_close(g, w, msg=what)


@pytest.mark.parametrize("name", ["cornell", "fused"])
def test_sphere_candidates_match_jnp_ref(name):
    """Cornell has plain spheres and a transformed one (the ellipsoid)."""
    ja, ta = scene_pair(name)
    o, d = rays_for(name, 240, 3)
    want = jnp_ref.sphere_candidates(ja.spheres, jnp.asarray(o),
                                     jnp.asarray(d))
    got = torch_ref.sphere_candidates(ta.spheres, _t(o), _t(d))
    for k in ("valid_near", "valid_far"):
        assert np.asarray(want[k]).any(), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("t_near_obj", "t_far_obj"):
        assert_close(got[k], want[k], msg=k)  # inf where not valid
    for k in ("o_obj", "d_obj"):
        assert_close(torch.stack(got[k], dim=-1), want[k], msg=k)


def test_sphere_hit_detail_matches_jnp_ref():
    ja, ta = scene_pair("cornell")
    rng = np.random.default_rng(4)
    n, rows = 200, ja.spheres.radius.shape[0]
    assert np.asarray(ja.spheres.transformed).any()
    idx = rng.integers(0, rows, n).astype(np.int32)
    o, d = rays_for("cornell", n, 5)
    o_obj = rng.normal(size=(n, 3)).astype(np.float32)
    d_obj = rng.normal(size=(n, 3)).astype(np.float32)
    t_obj = rng.uniform(0, 3, n).astype(np.float32)
    inside = rng.integers(0, 2, n) == 1
    want = jnp_ref.sphere_hit_detail(
        ja.spheres, jnp.asarray(idx), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(o_obj), jnp.asarray(d_obj), jnp.asarray(t_obj),
        jnp.asarray(inside))
    got = torch_ref.sphere_hit_detail(
        ta.spheres, _t(idx).long(), _t(o), _t(d), _t(o_obj), _t(d_obj),
        _t(t_obj), _t(inside))
    for g, w, what in zip(got, want, ("position", "normal", "t")):
        assert_close(g, w, msg=what)


@pytest.mark.parametrize("name", ["cornell", "fused"])
def test_plane_candidates_and_detail_match_jnp_ref(name):
    ja, ta = scene_pair(name)
    o, d = rays_for(name, 240, 6)
    if name == "cornell":
        # Rays lying in the floor plane y = 0 (the coplanar case) and
        # parallel ones above it.
        o[-40:, 1] = np.where(np.arange(40) % 2 == 0, 0.0, 0.7)
        d[-40:] = np.asarray([1.0, 0.0, 0.0], np.float32)
    eps = jvm.near_enough(jnp.float32)
    want = jnp_ref.plane_candidates(ja.planes, jnp.asarray(o),
                                    jnp.asarray(d), eps)
    got = torch_ref.plane_candidates(ta.planes, _t(o), _t(d), eps)
    valid = np.asarray(want["valid"])
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["inside"].numpy()[valid],
                                  np.asarray(want["inside"])[valid])
    assert_close(got["t"], want["t"], msg="t")
    if name == "cornell":
        assert (np.asarray(want["t"])[valid] == 0).any()  # coplanar hits

    n = o.shape[0]
    rng = np.random.default_rng(7)
    idx = np.zeros(n, np.int32)
    t = rng.uniform(0, 5, n).astype(np.float32)
    inside = rng.integers(0, 2, n) == 1
    want = jnp_ref.plane_hit_detail(ja.planes, jnp.asarray(idx),
                                    jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t), jnp.asarray(inside))
    got = torch_ref.plane_hit_detail(ta.planes, _t(idx).long(), _t(o), _t(d),
                                     _t(t), _t(inside))
    for g, w, what in zip(got, want, ("position", "normal")):
        assert_close(g, w, msg=what)


# ---------------------------------------------------------------------------
# dispatch.closest_hit vs the JAX closest_hit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cornell", "mesh-82", "smooth"])
def test_closest_hit_matches_jax(name):
    ja, ta = scene_pair(name)
    o, d = rays_for(name, 240, 8)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    want = jax.jit(jdispatch.closest_hit)(ja, jo, jd, None)
    got = tdispatch.closest_hit(ta, _t(o), _t(d), None)
    assert_hits_match(got, want)

    # Second query with the first hit as the skip record (the same record
    # on both sides): a ray re-sent from its origin must not hit the same
    # point of the same primitive again.
    want2 = jax.jit(jdispatch.closest_hit)(ja, jo, jd, want)
    got2 = tdispatch.closest_hit(ta, _t(o), _t(d), port_hit(want))
    assert_hits_match(got2, want2)
    first = np.asarray(want.prim)
    second = np.asarray(want2.prim)
    assert (first != second)[first >= 0].mean() > 0.5


def test_closest_hit_from_the_first_hit_position():
    """The trace's own pattern: the next ray starts at the hit, with the
    hit as skip record."""
    ja, ta = scene_pair("cornell")
    o, d = rays_for("cornell", 240, 9)
    first = jax.jit(jdispatch.closest_hit)(ja, jnp.asarray(o),
                                           jnp.asarray(d), None)
    rng = np.random.default_rng(10)
    d2 = rng.normal(size=d.shape)
    d2 = (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(np.float32)
    o2 = np.where(np.asarray(first.found)[:, None],
                  np.asarray(first.position), o)
    want = jax.jit(jdispatch.closest_hit)(ja, jnp.asarray(o2),
                                          jnp.asarray(d2), first)
    got = tdispatch.closest_hit(ta, _t(o2), _t(d2), port_hit(first))
    assert_hits_match(got, want)


def test_hit_record_none_and_found():
    rec = HitRecord.none(5, torch.float64)
    assert rec.prim.tolist() == [-1] * 5 and not rec.found.any()
    assert rec.position.shape == (5, 3) and rec.t.dtype == torch.float64
    assert rec.inside.dtype == torch.bool
    want = jdispatch.HitRecord.none(5)
    for f in ("prim", "t", "position", "normal", "inside"):
        np.testing.assert_array_equal(
            getattr(HitRecord.none(5), f).numpy(),
            np.asarray(getattr(want, f)))
    assert tdispatch._position_eps(torch.float32) == \
        jdispatch._position_eps(jnp.float32)
    assert tdispatch._position_eps(torch.float64) == \
        jdispatch._position_eps(jnp.float64)


def test_dense_scan_chunks_do_not_change_the_result(monkeypatch):
    _, ta = scene_pair("cornell")
    o, d = rays_for("cornell", 240, 11)
    whole = tdispatch.closest_hit(ta, _t(o), _t(d), None)
    second = tdispatch.closest_hit(ta, _t(o), _t(d), whole)
    monkeypatch.setattr(tdispatch, "_GRID_CHUNK_CELLS", 7 * 20)  # 7 rays
    assert len(tdispatch._chunks(20, 240)) == 35
    for skip, want in ((None, whole), (whole, second)):
        got = tdispatch.closest_hit(ta, _t(o), _t(d), skip)
        for f in ("prim", "t", "position", "normal", "inside"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_select_hooks_replace_the_dense_scans():
    """``tri_select_fn`` / ``sphere_select_fn`` are where a BVH plugs in."""
    _, ta = scene_pair("cornell")
    o, d = rays_for("cornell", 120, 12)
    calls = []

    def tri_select(scene, ray_o, ray_d, skip, eps_behind, eps_pos):
        calls.append("tri")
        assert not ray_o.requires_grad
        return tdispatch._triangle_select_dense(scene, ray_o, ray_d, skip,
                                                eps_behind, eps_pos)

    def sphere_select(scene, ray_o, ray_d, skip, eps_pos):
        calls.append("sph")
        return tdispatch._sphere_select(scene, ray_o, ray_d, skip, eps_pos)

    ray_o = _t(o).requires_grad_(True)
    got = tdispatch._closest_from_tri_select(ta, ray_o, _t(d), None,
                                             tri_select, sphere_select)
    want = tdispatch.closest_hit(ta, _t(o), _t(d), None)
    assert calls == ["tri", "sph"]
    assert torch.equal(got.prim, want.prim)
    assert torch.equal(got.t.detach(), want.t)
    # Winner evaluation is differentiable: t has a gradient in the origin.
    got.t.sum().backward()
    assert ray_o.grad is not None and bool((ray_o.grad != 0).any())
