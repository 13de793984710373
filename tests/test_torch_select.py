"""The select kernel's plain version (``intersect/cuda_select.py``) against
the JAX package's Pallas select kernel and grid selection.

* Cornell scene, 256 rays: ``select_all_reference`` /
  ``closest_hit_fused_reference`` against ``pallas_select.select_all`` /
  ``closest_hit_fused`` in interpret mode (the way the JAX package's own
  tests run the kernel on the CPU), with and without a skip record: winner
  rows, near-root flags and any-flags equal; prim and inside equal; t and
  position within 1e-5, normals within 4e-5 (the two walk the same per-row
  passes).
* mesh-82 (84 table rows, too many for an interpret-mode run): against the
  JAX grid selection functions, indices and flags equal.
* ``closest_hit_fused`` against the port's own grid oracle
  ``dispatch.closest_hit``: prim equal, floats within 1e-4 (different
  formulas for the winner's position and normal, the tolerance of
  tests/test_pallas_select.py).

The CUDA kernel has no CPU mode: its cases carry the ``cuda`` marker and
skip without a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.core import vecmath as jvm
from raytracercore_tpu.intersect import dispatch as jdispatch
from raytracercore_tpu.intersect import pallas_select
from raytracercore_tpu_torch import config
from raytracercore_tpu_torch.core import vecmath as tvm
from raytracercore_tpu_torch.intersect import cuda_select
from raytracercore_tpu_torch.intersect import dispatch as tdispatch
from raytracercore_tpu_torch.intersect.dispatch import HitRecord
from raytracercore_tpu_torch.scene import meshgen as tmeshgen
from test_torch_dispatch import port_hit, rays_for, scene_pair
from test_torch_fused import cuda_device  # noqa: F401

EPS_B = jvm.near_enough(jnp.float32)
EPS_P = jdispatch._position_eps(jnp.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _random_skip(n, n_prims, o, d, seed):
    """A skip record that matches nothing in particular (the pattern of
    tests/test_pallas_select.py): random prims, the ray's own origin and
    direction as position and normal, random inside flags."""
    rng = np.random.default_rng(seed)
    prim = rng.integers(-1, n_prims, n).astype(np.int32)
    inside = rng.integers(0, 2, n) == 1
    return jdispatch.HitRecord(prim=jnp.asarray(prim), t=jnp.zeros(n),
                               position=jnp.asarray(o),
                               normal=jnp.asarray(d),
                               inside=jnp.asarray(inside))


def _first_hit_skip(ja, o, d):
    """The rays' own first hit: re-sent from the same origin, a ray must
    skip exactly that hit."""
    return jax.jit(jdispatch.closest_hit)(ja, jnp.asarray(o), jnp.asarray(d),
                                          None)


def assert_selection_equal(got, want):
    (ti, ta), (si, sn, sa), (pi, pa) = got
    (wti, wta), (wsi, wsn, wsa), (wpi, wpa) = (
        tuple(np.asarray(x) for x in table) for table in want)
    np.testing.assert_array_equal(ta.numpy(), wta)
    np.testing.assert_array_equal(ti.numpy()[wta], wti[wta])
    np.testing.assert_array_equal(sa.numpy(), wsa)
    np.testing.assert_array_equal(si.numpy()[wsa], wsi[wsa])
    np.testing.assert_array_equal(sn.numpy()[wsa], wsn[wsa])
    np.testing.assert_array_equal(pa.numpy(), wpa)
    np.testing.assert_array_equal(pi.numpy()[wpa], wpi[wpa])
    return wta.sum(), wsa.sum(), wpa.sum()


@pytest.mark.parametrize("skip_kind", ["none", "random", "first-hit"])
def test_reference_matches_pallas_interpret(skip_kind):
    ja, ta = scene_pair("cornell")
    o, d = rays_for("cornell", 256, 20)
    jskip = {"none": None,
             "random": _random_skip(256, ja.n_prims, o, d, 21),
             "first-hit": _first_hit_skip(ja, o, d)}[skip_kind]
    tskip = None if jskip is None else port_hit(jskip)
    jo, jd = jnp.asarray(o), jnp.asarray(d)

    want = pallas_select.select_all(ja, jo, jd, jskip, EPS_B, EPS_P,
                                    interpret=True)
    got = cuda_select.select_all_reference(ta, _t(o), _t(d), tskip, EPS_B,
                                           EPS_P)
    counts = assert_selection_equal(got, want)
    assert all(c > 10 for c in counts)  # every table wins somewhere
    # The CPU route of the public entry point is the plain version.
    again = cuda_select.select_all(ta, _t(o), _t(d), tskip, EPS_B, EPS_P)
    for a, b in zip(sum(again, ()), sum(got, ())):
        assert torch.equal(a, b)

    wrec = pallas_select.closest_hit_fused(ja, jo, jd, jskip, interpret=True)
    grec = cuda_select.closest_hit_fused_reference(ta, _t(o), _t(d), tskip)
    np.testing.assert_array_equal(grec.prim.numpy(), np.asarray(wrec.prim))
    np.testing.assert_array_equal(grec.inside.numpy(),
                                  np.asarray(wrec.inside))
    # 4e-5 on normals: a sphere's normal is its position error over its
    # radius (0.45 on Cornell's smallest sphere).
    for f, tol in (("t", 1e-5), ("position", 1e-5), ("normal", 4e-5)):
        np.testing.assert_allclose(getattr(grec, f).numpy(),
                                   np.asarray(getattr(wrec, f)), rtol=tol,
                                   atol=tol, err_msg=f)
    found = np.asarray(wrec.prim) >= 0
    assert found.any() and not found.all()
    # Output conventions where nothing is found: t 0, zero vectors.
    assert (grec.t.numpy()[~found] == 0).all()
    assert (grec.position.numpy()[~found] == 0).all()
    assert (grec.normal.numpy()[~found] == 0).all()


@pytest.mark.parametrize("skip_kind", ["none", "first-hit"])
def test_reference_matches_jnp_selection_on_mesh82(skip_kind):
    ja, ta = scene_pair("mesh-82")
    o, d = rays_for("mesh-82", 240, 22)
    jskip = None if skip_kind == "none" else _first_hit_skip(ja, o, d)
    tskip = None if jskip is None else port_hit(jskip)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    want = (
        jdispatch._triangle_select_dense(ja, jo, jd, jskip, EPS_B, EPS_P),
        jdispatch._sphere_select(ja, jo, jd, jskip, EPS_P),
        jdispatch._plane_select(ja, jo, jd, jskip, EPS_B, EPS_P))
    got = cuda_select.select_all_reference(ta, _t(o), _t(d), tskip, EPS_B,
                                           EPS_P)
    n_tri, n_sph, n_pl = assert_selection_equal(got, want)
    # One triangle table; the sphere and plane tables are one masked
    # padding row each, which must never win.
    assert n_tri > 15 and n_sph == 0 and n_pl == 0


@pytest.mark.parametrize("name", ["cornell", "mesh-82", "smooth"])
def test_fused_record_matches_the_grid_oracle(name):
    """``closest_hit_fused`` (winner evaluated in the kernel body's passes)
    against ``dispatch.closest_hit`` (grid selection + winner
    re-evaluation), first hit and second hit with the first as skip."""
    _, ta = scene_pair(name)
    o, d = rays_for(name, 240, 23)
    skip = None
    for _ in range(2):
        want = tdispatch.closest_hit(ta, _t(o), _t(d), skip)
        got = cuda_select.closest_hit_fused(ta, _t(o), _t(d), skip)
        dt = (got.t - want.t).abs().numpy()
        # Coplanar surfaces may tie (see test_torch_dispatch).
        tie = ((got.prim != want.prim) & (got.prim >= 0)
               & (want.prim >= 0)).numpy() & (dt <= 1e-4)
        assert tie.mean() < 0.02
        np.testing.assert_array_equal(got.prim.numpy()[~tie],
                                      want.prim.numpy()[~tie])
        m = want.found.numpy() & ~tie
        assert m.any()
        np.testing.assert_array_equal(got.inside.numpy()[m],
                                      want.inside.numpy()[m])
        for f in ("t", "position", "normal"):
            np.testing.assert_allclose(getattr(got, f).numpy()[m],
                                       getattr(want, f).numpy()[m],
                                       rtol=1e-4, atol=1e-4, err_msg=f)
        skip = want


def test_parked_rays_miss_without_nan():
    """``trace`` parks dead lanes at (4e8, 4e8, 4e8) pointing +x: they must
    miss every row and produce no NaN or inf."""
    for name in ("cornell", "mesh-82"):
        _, ta = scene_pair(name)
        o = torch.full((8, 3), 4e8)
        d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(8, 1)
        skip = HitRecord.none(8)
        out = cuda_select.select_reference(ta, o, d, skip, EPS_B, EPS_P)
        assert (out.prim == -1).all() and (out.tri_idx == -1).all()
        assert (out.sph_idx == -1).all() and (out.pl_idx == -1).all()
        for t in (out.t, out.position, out.normal):
            assert bool(torch.isfinite(t).all()) and bool((t == 0).all())


def test_cpu_route_counts_no_launch_and_f64_rays_come_back_f64():
    _, ta = scene_pair("cornell")
    o, d = rays_for("cornell", 60, 24)
    before = cuda_select.closest_hit_fused.launches
    rec = cuda_select.closest_hit_fused(ta, _t(o).double(), _t(d).double(),
                                        None)
    assert cuda_select.closest_hit_fused.launches == before
    assert rec.t.dtype == rec.position.dtype == torch.float64
    ref = cuda_select.closest_hit_fused_reference(ta, _t(o), _t(d), None)
    assert torch.equal(rec.prim, ref.prim)
    assert torch.equal(rec.position.float(), ref.position)


def test_kernel_wrapper_rejects_bad_inputs():
    """The launch checks run before anything reaches the GPU, so they are
    exercised here on CPU tensors through the launch path itself."""
    _, ta = scene_pair("cornell")
    o, d = (_t(x) for x in rays_for("cornell", 60, 25))
    skip = HitRecord.none(60)
    bad = [
        (o.double(), d, None),                               # dtype
        (o, d[:-1], None),                                   # shape
        (o.t().contiguous().t(), d, None),                   # layout
        (o, d, dataclasses.replace(skip, prim=skip.prim.long())),
        (o, d, dataclasses.replace(skip, inside=skip.inside.int())),
        (o, d, dataclasses.replace(skip, position=skip.position[:-1])),
    ]
    for ray_o, ray_d, k in bad:
        with pytest.raises(ValueError):
            cuda_select._launch(ta, ray_o, ray_d, k, EPS_B, EPS_P)
    big = tmeshgen.make_mesh_scene(grid=4, subdiv=1,
                                   device="cpu")[0]  # 1,282 triangles
    with pytest.raises(ValueError, match="SELECT_MAX_PRIMS"):
        cuda_select._launch(big, o, d, None, EPS_B, EPS_P)


def test_caps_follow_the_jax_package():
    from raytracercore_tpu import config as jconfig
    assert config.SELECT_MAX_PRIMS >= 768
    assert config.SELECT_MAX_PRIMS == jconfig.PALLAS_MAX_PRIMS
    # The worst-case row (a sphere) times the cap fits twice in the 227 KB
    # of shared memory a block may take on an H100.
    assert 2 * config.SELECT_MAX_PRIMS * (28 * 4 + 4 * 4) <= 232448
    assert EPS_B == tvm.near_enough(torch.float32)
    assert EPS_P == tdispatch._position_eps(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "mesh-82", "smooth"])
def test_kernel_matches_reference_on_card(cuda_device, name):  # noqa: F811
    _, ta = scene_pair(name)
    scene = ta.to(cuda_device)
    o, d = (_t(x).to(cuda_device) for x in rays_for(name, 4096, 26))
    skip = None
    for _ in range(2):
        ref = cuda_select.select_reference(scene, o, d, skip, EPS_B, EPS_P)
        before = cuda_select.closest_hit_fused.launches
        got = cuda_select._invoke(scene, o, d, skip, EPS_B, EPS_P)
        torch.cuda.synchronize()
        assert cuda_select.closest_hit_fused.launches == before + 1
        for f in ref._fields:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        skip = cuda_select.closest_hit_fused(scene, o, d, skip)


def test_dense_closest_hit_above_the_cap_scans_the_grid_on_cpu_tensors():
    """Above ``SELECT_MAX_PRIMS`` rows the plain grid scan still answers on
    CPU tensors (on CUDA tensors the dispatch raises: the card-only case
    below)."""
    big = tmeshgen.make_mesh_scene(grid=4, subdiv=1, device="cpu")[0]
    assert tdispatch.n_table_rows(big) > config.SELECT_MAX_PRIMS
    o = torch.tensor([[0.0, -20.0, 8.0]]).repeat(32, 1)
    d = torch.nn.functional.normalize(
        torch.tensor([[0.0, 20.0, -7.0]]).repeat(32, 1)
        + torch.linspace(-3, 3, 32)[:, None] * torch.tensor([[1.0, 0, 0]]),
        dim=1)
    hit = tdispatch.closest_hit(big, o, d, None)
    assert bool(hit.found.any()) and bool(torch.isfinite(hit.position).all())


@pytest.mark.cuda
def test_dense_closest_hit_on_card_launches_or_raises(cuda_device):  # noqa: F811
    """On CUDA tensors ``dispatch.closest_hit`` never gives way to the grid
    scan: it launches the select kernel, or raises for rays that are not
    f32 and for scenes above the cap."""
    _, ta = scene_pair("cornell")
    scene = ta.to(cuda_device)
    o, d = (_t(x).to(cuda_device) for x in rays_for("cornell", 60, 27))
    before = cuda_select.closest_hit_fused.launches
    tdispatch.closest_hit(scene, o, d, None)
    assert cuda_select.closest_hit_fused.launches == before + 1
    with pytest.raises(ValueError, match="dtype"):
        tdispatch.closest_hit(scene, o.double(), d.double(), None)
    big = tmeshgen.make_mesh_scene(grid=4, subdiv=1, device=cuda_device)[0]
    with pytest.raises(NotImplementedError, match="make_bvh_closest_fn"):
        tdispatch.closest_hit(big, o, d, None)
