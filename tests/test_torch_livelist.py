"""Dead lanes and live lists of the two closest-hit kernels.

* The select kernel's own table layout (``pack_select_tables``,
  ``SceneArrays.select_tables``) unpacks to ``fused_tables`` field by field
  and is carried over by ``with_materials``.
* ``select_reference`` gives a dead lane (origin ``config.PARKED_ORIGIN``)
  the no-hit record and every other lane the scan of every row
  (``scan_reference``), bit for bit.
* The plain list: ``live_list_reference`` is the live lanes.  The
  traversal keeps no list: ``traverse_reference`` gives a ray that fails
  the root's slab test (every parked lane among them) row -1, t inf and
  counters (1, 0).
* ``trace`` through the select route gives the same colours, misses and
  tape as with the scan of every lane, and matches JAX ``trace``.

The CUDA kernels have no CPU mode: their cases carry the ``cuda`` marker
and skip without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracercore_tpu.render.integrator import trace as jtrace
from raytracercore_tpu_torch import config
from raytracercore_tpu_torch.bvh import cuda_traverse as ct
from raytracercore_tpu_torch.intersect import cuda_select as cs
from raytracercore_tpu_torch.intersect.dispatch import HitRecord
from raytracercore_tpu_torch.render.integrator import trace
from raytracercore_tpu_torch.scene import meshgen as tmeshgen
from test_torch_dispatch import rays_for, scene_pair
from test_torch_fused import cuda_device  # noqa: F401
from test_torch_select import EPS_B, EPS_P
from test_torch_trace import assert_colours_match, assert_tapes_match, case
from test_torch_traverse import field_case, tri_case

PARKED_D = (1.0, 0.0, 0.0)


def _t(a):
    return torch.tensor(np.asarray(a))


def _scene(name):
    if name == "spheres":
        return tmeshgen.make_sphere_field_scene(grid=5, device="cpu")[0]
    if name == "ellipsoids":
        return tmeshgen.make_sphere_field_scene(grid=5, ellipsoid=True,
                                                device="cpu")[0]
    return scene_pair(name)[1]


def unpack_select_tables(sel):
    """``cuda_select.pack_select_tables`` undone: ``(tf, ti, sf, si, pf,
    pi)``."""
    tri, cold, sph, pln = sel

    def ints(prim_w, flag_w):
        prim = prim_w.contiguous().view(torch.int32)
        fl = flag_w.contiguous().view(torch.int32)
        return torch.stack([prim, fl & (cs.SF_MIRROR | cs.SF_SMOOTH),
                            (fl >> 2) & 1, (fl >> 3) & 1], dim=1)
    tf = torch.cat([tri[:, 0:3], tri[:, 4:7], tri[:, 8:11], tri[:, 12:15],
                    cold[:, 0:3], cold[:, 4:7], cold[:, 8:11]], dim=1)
    return (tf, ints(tri[:, 3], tri[:, 7]), sph[:, :28],
            ints(sph[:, 28], sph[:, 29]), pln[:, :4],
            ints(pln[:, 4], pln[:, 5]))


def park(o, d, mask):
    """The rays with the lanes ``mask`` parked as the integrator parks
    them."""
    p_o = torch.full_like(o, config.PARKED_ORIGIN)
    p_d = torch.tensor(PARKED_D, dtype=d.dtype).expand_as(d)
    return (torch.where(mask[:, None], p_o, o).contiguous(),
            torch.where(mask[:, None], p_d, d).contiguous())


def _random_skip(n, n_prims, o, d, seed):
    rng = np.random.default_rng(seed)
    return HitRecord(prim=_t(rng.integers(-1, n_prims, n).astype(np.int32)),
                     t=torch.zeros(n), position=o.clone(), normal=d.clone(),
                     inside=_t(rng.integers(0, 2, n) == 1))


@pytest.mark.parametrize("name", ["cornell", "mesh-82", "spheres",
                                  "ellipsoids"])
def test_select_layout_unpacks_to_fused_tables(name):
    scene = _scene(name)
    sel = scene.select_tables
    assert [t.shape[1] for t in sel] == [cs.SEL_TRI_F, cs.SEL_COLD_F,
                                         cs.SEL_SPH_F, cs.SEL_PL_F]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in sel)
    for got, want in zip(unpack_select_tables(sel),
                         scene.fused_tables[:6]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # The flag words keep every bit apart: mirror, smooth, invert, two-sided.
    ti = scene.fused_tables[1]
    flags = sel[0][:, 7].contiguous().view(torch.int32)
    assert torch.equal(flags & cs.SF_MIRROR, ti[:, 1] & 1)
    assert torch.equal((flags & cs.SF_TWO_SIDED) != 0, ti[:, 3] != 0)
    # A train step's material swap carries the layout over, unpacked once.
    mats = dataclasses.replace(scene.materials,
                               diffuse=scene.materials.diffuse * 0.5)
    new = scene.with_materials(mats)
    assert new.select_tables is sel
    assert all(a is b for a, b in zip(new.fused_tables[:6],
                                      scene.fused_tables[:6]))


@pytest.mark.parametrize("name", ["cornell", "mesh-82"])
@pytest.mark.parametrize("pattern", ["random", "all", "none"])
def test_select_reference_gives_dead_lanes_the_no_hit_record(name, pattern):
    scene = _scene(name)
    o, d = (_t(x) for x in rays_for(name, 300, 71))
    rng = np.random.default_rng(72)
    mask = {"random": _t(rng.random(300) < 0.5),
            "all": torch.ones(300, dtype=torch.bool),
            "none": torch.zeros(300, dtype=torch.bool)}[pattern]
    o, d = park(o, d, mask)
    assert torch.equal(cs.parked_lanes(o), mask)
    for skip in (None, _random_skip(300, scene.n_prims, o, d, 73)):
        got = cs.select_reference(scene, o, d, skip, EPS_B, EPS_P)
        full = cs.scan_reference(scene, o, d, skip, EPS_B, EPS_P)
        for f in got._fields:
            g, w = getattr(got, f), getattr(full, f)
            assert torch.equal(g[~mask], w[~mask]), f
        assert (got.tri_idx[mask] == -1).all()
        assert (got.sph_idx[mask] == -1).all()
        assert (got.pl_idx[mask] == -1).all()
        assert (got.prim[mask] == -1).all()
        assert not got.sph_near[mask].any() and not got.inside[mask].any()
        for t in (got.t, got.position, got.normal):
            assert (t[mask] == 0).all()
        # On these scenes a parked ray misses every row anyway: the rule
        # changes nothing the scan would have given.
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(full, f)), f
    if pattern == "random":
        assert bool((got.prim >= 0).any())


def test_live_list_reference_is_the_live_lanes():
    o, d = (_t(x) for x in rays_for("cornell", 200, 74))
    mask = _t(np.random.default_rng(75).random(200) < 0.3)
    o, _ = park(o, d, mask)
    live = cs.live_list_reference(o)
    assert torch.equal(torch.sort(live).values,
                       torch.arange(200)[~mask])
    # A lane with one coordinate off the parking point is live.
    o[0] = torch.tensor([config.PARKED_ORIGIN, config.PARKED_ORIGIN, 0.0])
    assert not bool(cs.parked_lanes(o)[0])


def _root_passes(nodes, o, d):
    """[R] bool: the rays that pass the root's slab test (finite inverse
    3.4e38 for a zero direction component, as the walk takes it), or whose
    walk goes on past a failed root."""
    root = nodes[0]
    lo, hi = [], []
    for k in range(3):
        c = d[:, k]
        inv = torch.where(c != 0, 1.0 / torch.where(c == 0, 1.0, c),
                          ct.BIG_INV)
        t0 = (root[k] - o[:, k]) * inv
        t1 = (root[3 + k] - o[:, k]) * inv
        lo.append(torch.minimum(t0, t1))
        hi.append(torch.maximum(t0, t1))
    near = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    far = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    hit = (near <= far) & (far >= -EPS_B) & (near <= float("inf"))
    return hit | (root[6] < nodes.shape[0])


@pytest.mark.parametrize("kind", ["tri", "sph", "spht"])
def test_root_list_and_root_fail_outputs(kind):
    if kind == "tri":
        _, _, _, tsel, o, d = tri_case()
    else:
        _, _, _, tsel, o, d = field_case(kind == "spht")
    o, d = _t(o), _t(d)
    R = o.shape[0]
    mask = _t(np.random.default_rng(76).random(R) < 0.4)
    o, d = park(o, d, mask)
    # Some rays that miss the scene's box without being parked.
    o[:5] = torch.tensor([0.0, 0.0, 1e4])
    d[:5] = torch.tensor([0.0, 0.0, 1.0])
    dead = ~_root_passes(tsel.nodes, o, d)
    out = ct.traverse_reference(tsel.nodes, tsel.leaves, kind, o, d, None,
                                EPS_B, EPS_P, want_stats=True)
    assert dead[mask].all() and dead[:5].all() and not dead.all()
    assert (out.row[dead] == -1).all() and (out.prim[dead] == -1).all()
    assert torch.isinf(out.t[dead]).all()
    assert (out.stats[dead] == torch.tensor([1, 0], dtype=torch.int32)).all()
    for t in (out.position, out.normal, out.u, out.v):
        assert (t[dead] == 0).all()
    assert (out.flags[dead] == 0).all()
    # Every other ray walks on past the root.
    assert (out.stats[~dead, 0] > 1).all()


def _scan_closest(scene, ray_o, ray_d, skip):
    """``closest_hit_fused`` on the CPU with every lane scanned, dead ones
    too (the select route before the dead-lane rule)."""
    f32 = torch.float32
    if skip is not None:
        skip = HitRecord(prim=skip.prim, t=skip.t,
                         position=skip.position.to(f32),
                         normal=skip.normal.to(f32), inside=skip.inside)
    out = cs.scan_reference(scene, ray_o.to(f32), ray_d.to(f32), skip, EPS_B,
                            EPS_P)
    return cs._record(out, ray_o.dtype)


@pytest.mark.parametrize("name,size,recursion", [("cornell", 20, 10),
                                                 ("mesh-82", 24, 4)])
def test_trace_through_the_select_route_with_dead_lanes(name, size,
                                                        recursion):
    ja, _, ta, _, jin, tin, _ = case(name, size, recursion)
    got = trace(ta, tin[0], tin[1], None, closest_fn=cs.closest_hit_fused,
                uniforms=tin[2], want_tape=True)
    before = trace(ta, tin[0], tin[1], None, closest_fn=_scan_closest,
                   uniforms=tin[2], want_tape=True)
    assert torch.equal(got[0], before[0]) and torch.equal(got[1], before[1])
    for f in ("prim", "flags", "nx", "ny", "nz"):
        assert torch.equal(getattr(got[2], f), getattr(before[2], f)), f
    ref = jtrace(ja, jin[0], jin[1], None, uniforms=jin[2], want_tape=True)
    assert_colours_match(ref, got, 0.1)
    assert_tapes_match(ref[2], got[2])


# --- on the card ----------------------------------------------------------

def _variants(o, d, seed):
    """Parked lanes at random, all parked, none parked, a ragged R."""
    R = o.shape[0]
    rng = np.random.default_rng(seed)
    mix = _t(rng.random(R) < 0.5).to(o.device)
    live = torch.nonzero(~cs.parked_lanes(o))[:, 0]
    return [park(o, d, mix), park(o, d, torch.ones_like(mix)),
            (o[live].contiguous(), d[live].contiguous()),
            (o[:R - 37].contiguous(), d[:R - 37].contiguous())]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "mesh-82", "smooth"])
def test_select_kernel_on_lane_variants_on_card(cuda_device, name):  # noqa: F811
    scene = _scene(name).to(cuda_device)
    o, d = (_t(x).to(cuda_device) for x in rays_for(name, 4099, 77))
    for qo, qd in _variants(o, d, 78):
        for skip in (None, cs.closest_hit_fused(scene, qo, qd, None)):
            ref = cs.select_reference(scene, qo, qd, skip, EPS_B, EPS_P)
            got = cs._launch(scene, qo, qd, skip, EPS_B, EPS_P)
            torch.cuda.synchronize()
            for f in ref._fields:
                assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tri", "sph", "spht"])
def test_traverse_kernel_on_lane_variants_on_card(cuda_device, kind):  # noqa: F811
    if kind == "tri":
        _, _, _, sel, o, d = tri_case()
    else:
        _, _, _, sel, o, d = field_case(kind == "spht")
    wide, leaves = sel.wide.to(cuda_device), sel.leaves.to(cuda_device)
    o, d = _t(o).to(cuda_device), _t(d).to(cuda_device)
    for qo, qd in _variants(o, d, 79):
        ref = ct.traverse_wide_reference(wide, leaves, kind, qo, qd, None,
                                         EPS_B, EPS_P, want_stats=True)
        got = ct._launch(wide, leaves, kind, qo, qd, None, EPS_B, EPS_P,
                         True)
        torch.cuda.synchronize()
        for f in ref._fields:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.cuda
def test_wrappers_do_not_synchronise_on_card(cuda_device):  # noqa: F811
    scene = _scene("cornell").to(cuda_device)
    o, d = (_t(x).to(cuda_device) for x in rays_for("cornell", 999, 80))
    _, _, _, sel, to, td = tri_case()
    wide, leaves = sel.wide.to(cuda_device), sel.leaves.to(cuda_device)
    to, td = _t(to).to(cuda_device), _t(td).to(cuda_device)
    cs.closest_hit_fused(scene, o, d, None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cs.closest_hit_fused(scene, o, d, None)
        ct.traverse(wide, leaves, "tri", to, td, None, EPS_B, EPS_P)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
