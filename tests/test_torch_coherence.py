"""Ray coherence on the port's BVH tier against the JAX package: the sort
key (``cuda_traverse.sort_key_reference`` against ``PallasBVH._sort_key``),
``CudaBVH.select(sort=True)`` and ``make_bvh_closest_fn(sort=)``, and the
tiled pixel order (``camera.pixel_grid_tiled`` / ``untile``,
``render_pass(tile=)``).

Tolerances: exact throughout, but where a port result is held against the
JAX Pallas kernel or the JAX integrator, which compute in another operation
order: there the tolerances of ``tests/test_torch_traverse.py`` and
``tests/test_torch_renderer.py``.  On the CPU the wrappers run their plain
versions; the card-only cases (the key kernel against its plain version,
the sorted traversal kernel against the unsorted one) carry the ``cuda``
marker and skip without a card.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.intersect import dispatch as jdispatch
from raytracercore_tpu.render import camera as jcam
from raytracercore_tpu.render.film import Film as JFilm
from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu.render.renderer import render_passes as jrender_passes
from raytracercore_tpu.scene import types as jtypes
from raytracercore_tpu_torch.bvh import build_bvh
from raytracercore_tpu_torch.bvh import cuda_traverse as ct
from raytracercore_tpu_torch.config import PARKED_ORIGIN
from raytracercore_tpu_torch.intersect import dispatch as tdispatch
from raytracercore_tpu_torch.render import camera as tcam
from raytracercore_tpu_torch.render.film import Film as TFilm
from raytracercore_tpu_torch.render.renderer import (pass_draws,
                                                     render_pass,
                                                     render_passes)
from raytracercore_tpu_torch.scene import meshgen as tmeshgen
from raytracercore_tpu_torch.scene import types as ttypes
from test_torch_bvh import EPS_B, EPS_P, bounce_of
from test_torch_dispatch import port_hit
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_renderer import _small
from test_torch_traverse import (TRI_TOL, assert_select_matches, field_case,
                                 tri_case)

KEY_MAX = (1 << 27) - 1   # direction bin 7, Morton code all ones


def _t(a):
    return torch.tensor(np.asarray(a))


def case(kind):
    """``(ja, ta, jsel, tsel, o, d)`` of one leaf kind (a mesh, a sphere
    field, an ellipsoid field; the JAX tree carried over)."""
    if kind == "tri":
        return tri_case(two_sided=True)
    return field_case(kind == "spht")


def key_rays(root_min, root_max, n=4096, seed=0):
    """Seeded f32 rays for the key: origins inside the root box and up to
    half its extent outside; origins on its faces and corners; parked rays;
    axis-aligned directions, zero and negative-zero components and
    components a few ulps either side of zero."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(root_min, np.float32)
    hi = np.asarray(root_max, np.float32)
    ext = hi - lo
    o = (lo + rng.uniform(-0.5, 1.5, (n, 3)) * ext).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    q = n // 8
    o[:q] = np.where(rng.random((q, 3)) < 0.5, lo, hi)      # corners
    face = rng.integers(0, 3, q)
    o[q:2 * q] = (lo + rng.random((q, 3)) * ext).astype(np.float32)
    o[q + np.arange(q), face] = np.where(rng.random(q) < 0.5, lo[face],
                                         hi[face])          # on a face
    o[2 * q:2 * q + 64] = PARKED_ORIGIN                     # parked
    d[2 * q:2 * q + 64] = (1.0, 0.0, 0.0)
    axis = rng.integers(0, 3, q)                            # axis-aligned
    d[3 * q:4 * q] = 0.0
    d[3 * q + np.arange(q), axis] = np.where(rng.random(q) < 0.5, 1.0, -1.0)
    d[4 * q:5 * q, rng.integers(0, 3)] = -0.0
    tiny = np.float32(1e-30) * rng.integers(-3, 4, (q, 3)).astype(np.float32)
    d[5 * q:6 * q] = tiny
    d[5 * q:6 * q, 0] = 1.0
    return o, d


# ---------------------------------------------------------------------------
# the key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tri", "sph", "spht"])
def test_sort_key_reference_matches_jax(kind):
    _, _, jsel, tsel, o, d = case(kind)
    np.testing.assert_array_equal(tsel.root_min.numpy(),
                                  np.asarray(jsel.root_min))
    np.testing.assert_array_equal(tsel.root_max.numpy(),
                                  np.asarray(jsel.root_max))
    assert tsel.root_min.dtype == torch.float32
    ko, kd = key_rays(jsel.root_min, jsel.root_max, seed=len(kind))
    for o_, d_ in ((o, d), (ko, kd)):
        want = np.asarray(jsel._sort_key(jnp.asarray(o_), jnp.asarray(d_)))
        got = ct.sort_key_reference(_t(o_), _t(d_), tsel.root_min,
                                    tsel.root_max)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # The wrapper runs the plain version on CPU tensors.
        assert torch.equal(ct.sort_key(_t(o_), _t(d_), tsel.root_min,
                                       tsel.root_max), got)
    keys = ct.sort_key_reference(_t(ko), _t(kd), tsel.root_min,
                                 tsel.root_max)
    parked = (ko == PARKED_ORIGIN).all(1)
    assert parked.sum() == 64
    assert bool((keys[torch.from_numpy(parked)] == KEY_MAX).all())
    assert int(keys.max()) == KEY_MAX and int(keys.min()) >= 0
    # Every octant and much of the Morton range are used.
    assert len(np.unique(keys.numpy() >> 24)) == 8
    assert len(np.unique(keys.numpy())) > len(keys) // 2


def test_sort_key_on_the_root_box():
    """Origins on the root box's lower corner get Morton code 0, on its
    upper corner all ones; the octant is the signs of the direction, a zero
    (or negative zero) component counting as positive."""
    lo = torch.tensor([-1.0, 0.5, 2.0])
    hi = torch.tensor([3.0, 0.75, 2.0])   # a flat box: ext clamps to 1e-30
    o = torch.stack([lo, hi, lo, hi])
    d = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
                      [0.0, -0.0, -1e-30], [-0.5, 0.5, 0.0]])
    key = ct.sort_key_reference(o, d, lo, hi)
    assert (key >> 24).tolist() == [7, 0, 7, 6]
    assert (key & 0xFFFFFF).tolist() == [0, 0x6DB6DB, 0, 0x6DB6DB]


# ---------------------------------------------------------------------------
# the sorted walk
# ---------------------------------------------------------------------------

def _flat(out):
    row, found, t, detail, stats = out
    return {"row": row, "any": found, "t": t, **detail, "stats": stats}


def _bounce_query(kind):
    ja, _, jsel, tsel, o, d = case(kind)
    jhit = jdispatch.closest_hit(ja, jnp.asarray(o), jnp.asarray(d), None)
    o2, d2 = bounce_of(jhit, o, d)
    return tsel, [(o, d, None), (o2, d2, port_hit(jhit))]


@pytest.mark.parametrize("kind", ["tri", "sph", "spht"])
def test_select_sorted_equals_unsorted(kind):
    tsel, queries = _bounce_query(kind)
    for o, d, skip in queries:
        o, d = _t(o), _t(d)
        want = _flat(tsel.select(o, d, skip, EPS_B, EPS_P, want_detail=True,
                                 want_stats=True))
        got = _flat(tsel.select(o, d, skip, EPS_B, EPS_P, want_detail=True,
                                want_stats=True, sort=True))
        for k in want:
            assert torch.equal(got[k], want[k]), k
        order = tsel.ray_order(o, d)
        assert order.dtype == torch.int64
        assert torch.equal(torch.sort(order).values, torch.arange(len(o)))
    # On the bounce the order is no longer the caller's.
    assert not torch.equal(order, torch.arange(len(o)))


def test_traverse_in_order_writes_at_each_rays_index():
    """``traverse(order=)`` walks ray ``order[t]`` in place ``t`` and puts
    every output back: a reversed order and a random one give the unordered
    outputs, counters included."""
    tsel, queries = _bounce_query("tri")
    o, d, skip = queries[1]
    o, d = _t(o), _t(d)
    args = (tsel.nodes, tsel.leaves, "tri", o, d, skip, EPS_B, EPS_P, True)
    want = ct.traverse(*args)
    gen = torch.Generator().manual_seed(5)
    for order in (torch.arange(len(o) - 1, -1, -1),
                  torch.randperm(len(o), generator=gen)):
        got = ct.traverse(*args, order=order)
        for name, w in want._asdict().items():
            assert torch.equal(getattr(got, name), w), name


def test_select_sorted_matches_pallas_sorted():
    """The sorted select against the JAX kernel's sorted select (interpret
    mode) on a primary bounce and a skip-carrying one, with the unsorted
    comparison's tolerances."""
    ja, _, jsel, tsel, o, d = tri_case(two_sided=True)
    hit = assert_select_matches(jsel, tsel, o, d, None, TRI_TOL, sort=True)
    assert hit.any() and not hit.all()
    jhit = jdispatch.closest_hit(ja, jnp.asarray(o), jnp.asarray(d), None)
    o2, d2 = bounce_of(jhit, o, d)
    assert assert_select_matches(jsel, tsel, o2, d2, jhit, TRI_TOL,
                                 sort=True).any()


def test_sort_wrappers_reject_bad_inputs():
    """The launch checks run before anything reaches the card."""
    _, _, _, tsel, o, d = tri_case()
    o, d = _t(o), _t(d)
    lo, hi = tsel.root_min, tsel.root_max
    for args in ((o.double(), d, lo, hi), (o, d[:-1], lo, hi),
                 (o, d, lo[:2], hi), (o, d, lo, hi.double())):
        with pytest.raises(ValueError):
            ct._launch_key(*args)
    good = [tsel.nodes, tsel.leaves, "tri", o, d, None, EPS_B, EPS_P, False]
    for order in (torch.arange(len(o), dtype=torch.int32),
                  torch.arange(len(o) - 1)):
        with pytest.raises(ValueError):
            ct._launch(*good, order)


# ---------------------------------------------------------------------------
# make_bvh_closest_fn(sort=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid,want", [(2, False), (3, True)])
def test_sort_none_follows_the_covered_records_rule(grid, want):
    """None sorts where the triangle tree covers more than 16384 leaf
    records (nodes x records a leaf): 5,122 triangles do not, 11,522 do."""
    scene = tmeshgen.make_mesh_scene(grid=grid, subdiv=3, width=16,
                                     height=16, device="cpu")[0]
    bvh = build_bvh(scene)
    covered = bvh.n_nodes * bvh.leaf_prims.shape[1]
    assert (covered > tdispatch.SORT_MIN_COVERED) == want
    assert tdispatch.SORT_MIN_COVERED == 16384
    closest = tdispatch.make_bvh_closest_fn(bvh, scene, traversal="kernel")
    assert closest.sort is want
    for sort in (False, True):
        assert tdispatch.make_bvh_closest_fn(
            bvh, scene, traversal="kernel", sort=sort).sort is sort


@pytest.mark.parametrize("ellipsoid", [False, True])
def test_closest_fn_sorted_records_equal_unsorted(ellipsoid, monkeypatch):
    """A field of 256 spheres (or ellipsoids) has a BVH of its own beside
    the triangle BVH; ``sort=True`` reaches both and changes no bit of the
    merged record, on primary rays and on a bounce."""
    scene, host_cam = tmeshgen.make_sphere_field_scene(
        grid=16, width=16, height=16, ellipsoid=ellipsoid, device="cpu")
    bvh = build_bvh(scene)
    unsorted = tdispatch.make_bvh_closest_fn(bvh, scene, traversal="kernel",
                                             sort=False)
    closest = tdispatch.make_bvh_closest_fn(bvh, scene, traversal="kernel",
                                            sort=True)
    kinds = [b.leaf_kind for b in closest.bvhs]
    assert kinds == ["tri", "spht" if ellipsoid else "sph"]
    assert closest.sort and not unsorted.sort
    seen = []
    select = ct.CudaBVH.select

    def spy(self, *args, **kw):
        seen.append((self.leaf_kind, kw.get("sort")))
        return select(self, *args, **kw)
    monkeypatch.setattr(ct.CudaBVH, "select", spy)

    camera = ttypes.init_camera(host_cam, 16, 16, device="cpu")
    o, d = tcam.center_rays(camera, *tcam.pixel_grid(16, 16, device="cpu"))
    skip = None
    for _ in range(2):
        want = unsorted(scene, o, d, skip)
        seen.clear()
        got = closest(scene, o, d, skip)
        assert seen == [(k, True) for k in kinds]
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name),
                               getattr(want, f.name)), f.name
        found = want.prim >= 0
        assert bool(found.any())
        dn = (d * want.normal).sum(1, keepdim=True)
        o = torch.where(found[:, None], want.position, o)
        d = torch.where(found[:, None], d - 2.0 * dn * want.normal, d)
        skip = want


# ---------------------------------------------------------------------------
# the tiled pixel order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,h,tile", [(16, 8, 4), (32, 32, 8), (24, 16, 8),
                                      (8, 8, 1)])
def test_pixel_grid_tiled_and_untile_match_jax(w, h, tile):
    px, py = tcam.pixel_grid_tiled(w, h, tile, device="cpu")
    jpx, jpy = jcam.pixel_grid_tiled(w, h, tile)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jpy))
    a = np.random.default_rng(w * h + tile).random((w * h, 3), np.float32)
    np.testing.assert_array_equal(
        tcam.untile(torch.from_numpy(a), w, h, tile).numpy(),
        np.asarray(jcam.untile(jnp.asarray(a), w, h, tile)))
    # untile of the tiled grid is the row-major grid.
    rx, ry = tcam.pixel_grid(w, h, device="cpu")
    assert torch.equal(tcam.untile(px, w, h, tile), rx)
    assert torch.equal(tcam.untile(py, w, h, tile), ry)


@pytest.mark.parametrize("w,h,tile", [(16, 8, 3), (16, 12, 8), (8, 8, 0)])
def test_tile_that_does_not_divide_raises(w, h, tile):
    with pytest.raises(ValueError):
        tcam.pixel_grid_tiled(w, h, tile, device="cpu")
    with pytest.raises(ValueError):
        tcam.untile(torch.zeros(w * h), w, h, tile)


def tile_perm(w, h, tile):
    """Row-major pixel index of ray ``i`` in tile order."""
    px, py = tcam.pixel_grid_tiled(w, h, tile, device="cpu")
    return py * w + px


def test_render_pass_tiled_equals_row_major_with_reordered_draws():
    """Ray ``i`` of a tiled pass traces pixel ``perm[i]`` with row ``i`` of
    the draws: the row-major pass given the draws moved to those pixels
    makes the same film, bit for bit; ``render_passes(tile=)`` is that pass
    with the pass's own draws."""
    size, rec = 16, 4
    _, thost = _small("cornell", size, rec)
    scene = ttypes.freeze_scene(thost, device="cpu")
    camera = ttypes.init_camera(thost.cameras[0], size, size, device="cpu")
    jitter, uniforms = pass_draws(7, 0, size * size, rec + 1, "cpu")
    film = TFilm.create(size, size, device="cpu")
    tiled = render_pass(scene, camera, film, jitter, uniforms, tile=8)
    perm = tile_perm(size, size, 8)
    j2 = torch.empty_like(jitter)
    j2[perm] = jitter
    u2 = torch.empty_like(uniforms)
    u2[..., perm] = uniforms
    rowmajor = render_pass(scene, camera, film, j2, u2)
    plain = render_pass(scene, camera, film, jitter, uniforms)
    for f in ("color_sum", "samples", "misses"):
        assert torch.equal(getattr(tiled, f), getattr(rowmajor, f)), f
    assert not torch.equal(tiled.color_sum, plain.color_sum)
    assert float(tiled.samples.sum() + tiled.misses.sum()) == size * size
    passes = render_passes(scene, camera, film, 7, 0, 1, tile=8)
    for f in ("color_sum", "samples", "misses"):
        assert torch.equal(getattr(passes, f), getattr(tiled, f)), f


def test_render_pass_tiled_matches_jax_tiled_path():
    """The port's tiled pass against the JAX ``render_passes(tile=8)`` on
    the random numbers that pass draws (its ``fold_in`` / ``split`` key
    schedule), with the tolerances of the row-major chain test."""
    size, rec = 16, 4
    jhost, thost = _small("cornell", size, rec)
    ja = jtypes.freeze_scene(jhost)
    jc = jtypes.init_camera(jhost.cameras[0], size, size)
    base = jax.random.PRNGKey(11)
    jf = jrender_passes(ja, jc, JFilm.create(size, size), base, 0, n=1,
                        tile=8)
    k_cam, k_path = jax.random.split(jax.random.fold_in(base, 0))
    jitter = jax.random.uniform(k_cam, (size * size, 4), dtype=jnp.float32)
    uniforms = jprep(k_path, size * size, rec + 1, jnp.float32)

    ta = ttypes.freeze_scene(thost, device="cpu")
    tc = ttypes.init_camera(thost.cameras[0], size, size, device="cpu")
    tf = render_pass(ta, tc, TFilm.create(size, size, device="cpu"),
                     _t(jitter), _t(uniforms), tile=8)
    np.testing.assert_array_equal(tf.samples.numpy(), np.asarray(jf.samples))
    np.testing.assert_array_equal(tf.misses.numpy(), np.asarray(jf.misses))
    want = np.asarray(jf.color_sum).reshape(-1, 3)
    got = tf.color_sum.numpy().reshape(-1, 3)
    assert want.max() > 0.5
    close = np.all(np.abs(want - got) <= 1e-3 + 1e-3 * np.abs(want), axis=1)
    assert close.mean() >= 0.97, f"only {close.mean():.3f} close"
    np.testing.assert_allclose(got.mean(0), want.mean(0), rtol=5e-3,
                               atol=5e-3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tri", "sph", "spht"])
def test_key_kernel_matches_plain_on_card(cuda_device, kind):
    _, _, _, tsel, _, _ = case(kind)
    ko, kd = key_rays(tsel.root_min, tsel.root_max, n=100_003, seed=3)
    o, d = _t(ko).to(cuda_device), _t(kd).to(cuda_device)
    lo, hi = tsel.root_min.to(cuda_device), tsel.root_max.to(cuda_device)
    before = ct.sort_key.launches
    got = ct.sort_key(o, d, lo, hi)
    assert ct.sort_key.launches == before + 1
    assert torch.equal(got, ct.sort_key_reference(o, d, lo, hi))


def on_device(sel, device):
    """A copy of a packed BVH with its tensors on ``device``."""
    out = copy.copy(sel)
    for k, v in vars(sel).items():
        if isinstance(v, torch.Tensor):
            setattr(out, k, v.to(device))
    out.device = torch.device(device)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tri", "sph", "spht"])
def test_sorted_kernel_equals_unsorted_on_card(cuda_device, kind):
    tsel, queries = _bounce_query(kind)
    tsel = on_device(tsel, cuda_device)
    for o, d, skip in queries:
        o, d = _t(o).to(cuda_device), _t(d).to(cuda_device)
        if skip is not None:
            skip = tdispatch.HitRecord(*(
                getattr(skip, f.name).to(cuda_device)
                for f in dataclasses.fields(skip)))
        before = (ct.sort_key.launches, ct.traverse.launches)
        want = _flat(tsel.select(o, d, skip, EPS_B, EPS_P, want_detail=True,
                                 want_stats=True))
        got = _flat(tsel.select(o, d, skip, EPS_B, EPS_P, want_detail=True,
                                want_stats=True, sort=True))
        assert (ct.sort_key.launches, ct.traverse.launches) == (
            before[0] + 1, before[1] + 2)
        for k in want:
            assert torch.equal(got[k], want[k]), k
