"""The BVH tier's record epilogue: the traversal kernel writes the bounce's
final hit record (``cuda_traverse.traverse_record``), and
``dispatch.make_bvh_closest_fn(traversal="kernel")`` chains one walk per
tree (triangles, then the sphere and ellipsoid BVHs merged into the record
before them) and the dense tail.

The oracle is the chain of torch ops that followed every walk before the
epilogue (:func:`chain_closest`): the walk's detail
(``CudaBVH.select(want_detail=True)``), ``dispatch._tri_smooth_fixup``,
``_rec_from_detail``, ``_merge2`` from tree to tree and with the tail, and
the final ``where``.  On CPU tensors the route's records are held to it
bit for bit on a smooth icosphere field, flat triangles, and a scene with
a sphere BVH, an ellipsoid BVH and a dense tail, with and without a skip
record and with rays that miss; the launcher is held with the kernel
library mocked.  Tests marked ``cuda`` run the kernel and skip without a
card; this file imports no JAX, so on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_bvh_record.py``.
"""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path

import pytest
import torch

from raytracercore_tpu_torch import config, kernels
from raytracercore_tpu_torch.bvh import build_bvh
from raytracercore_tpu_torch.bvh import cuda_traverse as ct
from raytracercore_tpu_torch.core import graphs
from raytracercore_tpu_torch.core import vecmath as vm
from raytracercore_tpu_torch.intersect import dispatch
from raytracercore_tpu_torch.intersect.cuda_select import closest_hit_fused
from raytracercore_tpu_torch.intersect.dispatch import HitRecord
from raytracercore_tpu_torch.parallel.worker import CORNELL_SCENE
from raytracercore_tpu_torch.render import camera as cam_mod
from raytracercore_tpu_torch.render import renderer as rmod
from raytracercore_tpu_torch.scene import loader, meshgen
from raytracercore_tpu_torch.scene.types import freeze_scene, init_camera

F32 = torch.float32
EPS_B = vm.near_enough(F32)
EPS_P = vm.POSITION_EPS_F32
SIZE = 24
SCENES = ("smooth", "flat", "spheres")


def bits_equal(a, b) -> bool:
    """Equal shapes, dtypes and bits (NaN payloads and signed zeros
    included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = torch.int64 if a.element_size() == 8 else torch.int32
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


def records_equal(got: HitRecord, want: HitRecord) -> list:
    """The fields of two records that are not bit-equal."""
    return [f.name for f in dataclasses.fields(HitRecord)
            if not bits_equal(getattr(got, f.name), getattr(want, f.name))]


def lit_mesh(grid, subdiv, size, recursion, smooth=True, device="cpu"):
    """``make_mesh_scene`` with its light quad made two-sided (the
    generator's lights nothing below it): ``(SceneArrays, HostCamera)``."""
    arrays, cam, _ = meshgen.make_mesh_scene(
        grid=grid, subdiv=subdiv, width=size, height=size,
        recursion=recursion, smooth=smooth, device=device)
    two_sided = arrays.materials.two_sided.clone()
    two_sided[-1] = True
    return dataclasses.replace(arrays, materials=dataclasses.replace(
        arrays.materials, two_sided=two_sided)), cam


def sphere_scene_text(n=4):
    """The Cornell room (walls and boxes: triangles; a floor plane; two
    spheres and a glass ellipsoid) with an ``n`` x ``n`` grid of spheres and
    one of scaled spheres (ellipsoids) added under the ceiling."""
    lines = [CORNELL_SCENE, "refraction off", "specular .2 .2 .2",
             "shininess 30", "diffuse .6 .5 .3"]
    step = 3.0 / (n - 1)
    for i in range(n):
        for j in range(n):
            x, z = -1.5 + i * step, -1.5 + j * step
            lines.append(f"sphere {x:.3f} 3.0 {z:.3f} .2")
            lines += ["pushtransform", f"translate {x + .3:.3f} 2.4 "
                      f"{z + .3:.3f}", "rotate 0 1 0 25",
                      "scale 1.3 .6 .9", "sphere 0 0 0 .18", "poptransform"]
    return "\n".join(lines) + "\n"


def scene_of(name, device="cpu"):
    """``(SceneArrays, HostCamera)`` of a case."""
    if name == "spheres":
        host = loader.parse(sphere_scene_text())
        host.width = host.height = SIZE
        return freeze_scene(host, device=device), host.cameras[0]
    return lit_mesh(2, 1, SIZE, 3, smooth=name == "smooth", device=device)


def closest_of(arrays, monkeypatch):
    """The detail route's closest hit of ``arrays``; the sphere kinds get
    BVHs of their own from 8 rows on, so the sphere scene has a sphere
    BVH, an ellipsoid BVH and the plane as the dense tail."""
    monkeypatch.setattr(config, "SPHERE_BVH_MIN_ROWS", 8)
    return dispatch.make_bvh_closest_fn(build_bvh(arrays, leaf_size=4),
                                        arrays, traversal="kernel")


def chain_closest(fn):
    """``fn``'s closest hit as the chain of torch ops that built the record
    from every walk's detail before the kernel wrote it: the oracle."""
    tri_bvh, *sphere_bvhs = fn.bvhs

    def closest(scene, ray_o, ray_d, skip):
        with torch.no_grad():
            row, any_t, t_t, det = tri_bvh.select(
                ray_o, ray_d, skip, EPS_B, EPS_P, want_detail=True,
                sort=fn.sort)
            if bool(scene.triangles.smooth.any()):
                det = dispatch._tri_smooth_fixup(scene.triangles, row, det)
            rec = dispatch._rec_from_detail(any_t, t_t, det)
            for b in sphere_bvhs:
                _, any_b, t_b, det_b = b.select(
                    ray_o, ray_d, skip, EPS_B, EPS_P, want_detail=True,
                    sort=fn.sort)
                rec = dispatch._merge2(
                    rec, dispatch._rec_from_detail(any_b, t_b, det_b))
            if fn.tail is not None:
                hit = closest_hit_fused(fn.tail, ray_o, ray_d, skip)
                rec = dispatch._merge2(rec, {
                    "t": hit.t, "any": hit.prim >= 0, "prim": hit.prim,
                    "inside": hit.inside, "position": hit.position,
                    "normal": hit.normal})
        prim = torch.where(rec["any"], rec["prim"], -1)
        return HitRecord(prim=prim.to(torch.int32), t=rec["t"],
                         position=rec["position"], normal=rec["normal"],
                         inside=rec["inside"])
    return closest


def rays_of(arrays, host_cam, device):
    """Camera rays through every pixel centre, then the same rays turned
    back (most of them leave the scene: misses)."""
    cam = init_camera(host_cam, SIZE, SIZE, device=device)
    px, py = cam_mod.pixel_grid(SIZE, SIZE, device=device)
    o, d = cam_mod.camera_rays(cam, px, py,
                               torch.full((SIZE * SIZE, 4), 0.5,
                                          device=device))
    d = vm.normalize(d)
    return (torch.cat([o, o]).contiguous(),
            torch.cat([d, -d]).contiguous())


def bounce(hit, o, d, seed=5):
    """From every hit, a ray in a direction drawn on the unit sphere (into
    the surface about half the time) with the hit as its skip record;
    missed rays go on as they were."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = torch.randn(o.shape, generator=g, dtype=F32).to(o.device)
    found = (hit.prim >= 0)[:, None]
    o2 = torch.where(found, hit.position, o).contiguous()
    d2 = torch.where(found, vm.normalize(rnd), d).contiguous()
    return o2, d2


def queries(arrays, host_cam, closest, skip: bool, device):
    """The rays of a case: primary rays (no skip record), or one bounce
    from their hits (the hits as the skip record)."""
    o, d = rays_of(arrays, host_cam, device)
    if not skip:
        return o, d, None
    hit = closest(arrays, o, d, None)
    o2, d2 = bounce(hit, o, d)
    return o2, d2, hit


# --- on the CPU: the plain route against the chain --------------------------

@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("name", SCENES)
def test_record_route_equals_the_chain(monkeypatch, name, skip):
    """The detail route's record on CPU tensors (the plain walk and the
    plain epilogue, tree by tree) bit-equal to the chain; no kernel runs;
    hits and misses both present, and on the sphere scene every tier wins
    somewhere."""
    arrays, host_cam = scene_of(name)
    fn = closest_of(arrays, monkeypatch)
    assert len(fn.bvhs) == (3 if name == "spheres" else 1)
    assert (fn.tail is not None) == (name == "spheres")
    chain = chain_closest(fn)
    o, d, sk = queries(arrays, host_cam, chain, skip, "cpu")
    before = (ct.traverse.launches, ct.traverse_record.launches)
    got = fn(arrays, o, d, sk)
    want = chain(arrays, o, d, sk)
    assert (ct.traverse.launches, ct.traverse_record.launches) == before
    assert not records_equal(got, want), records_equal(got, want)
    found = got.prim >= 0
    assert bool(found.any()) and bool((~found).any())
    if skip:
        assert bool(got.inside.any())
    if name == "smooth":
        smooth = arrays.triangles.smooth[got.prim.clamp(min=0).long()]
        assert bool((found & smooth).any())
    if name == "spheres":
        for table in (arrays.triangles, arrays.planes):
            pid = table.prim_id[table.prim_id >= 0]
            assert bool(torch.isin(got.prim, pid).any())
        sph = arrays.spheres
        for kind in (False, True):
            pid = sph.prim_id[(sph.prim_id >= 0) & (sph.transformed == kind)]
            assert bool(torch.isin(got.prim, pid).any()), kind


def test_record_reference_merges_into_a_prior_record(monkeypatch):
    """``CudaBVH.record`` on CPU tensors (the plain walk and
    ``record_reference``) of the sphere BVH merged into the triangle record
    equals ``_merge2`` of the two records as the chain
    builds them, and a record merged into itself stays itself."""
    arrays, host_cam = scene_of("spheres")
    fn = closest_of(arrays, monkeypatch)
    tri_bvh, sph_bvh, _ = fn.bvhs
    o, d = rays_of(arrays, host_cam, "cpu")
    a = tri_bvh.record(o, d, None, EPS_B, EPS_P)
    b = sph_bvh.record(o, d, None, EPS_B, EPS_P)
    got = sph_bvh.record(o, d, None, EPS_B, EPS_P, prior=a)
    want = dispatch._hit_from_rec(dispatch._merge2(dispatch._rec_dict(a),
                                                   dispatch._rec_dict(b)))
    assert not records_equal(got, want)
    same = sph_bvh.record(o, d, None, EPS_B, EPS_P, prior=b)
    assert not records_equal(same, b)
    assert bool(((a.prim >= 0) & (b.prim >= 0) & (got.prim == b.prim)).any())


# --- the launcher, with the library mocked ---------------------------------

class _FakeLib:
    def __init__(self):
        self.calls, self.err = [], 0

    def rtc_traverse_record(self, *args):
        self.calls.append(args)
        return self.err


def test_record_launcher_passes_the_tensors_and_counts(monkeypatch):
    """``_launch_record`` (mocked library and stream, CPU tensors): the
    walk's pointers, the vertex normal tables and the smooth flag for a
    triangle tree, the prior record's pointers and the order for a merge,
    the five record outputs, the sizes; one ``traverse.launches`` and one
    ``traverse_record.launches`` count a launch; a failing launch raises
    and is not counted; smooth normals on sphere leaves and a prior record
    that is not float32 are refused before the launch."""
    arrays, host_cam = scene_of("spheres")
    fn = closest_of(arrays, monkeypatch)
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(ct, "_stream", lambda device: 1234)
    tri_bvh, sph_bvh, _ = fn.bvhs
    o, d = rays_of(arrays, host_cam, "cpu")
    R = o.shape[0]
    skip = chain_closest(fn)(arrays, o, d, None)
    tri = arrays.triangles
    before = (ct.traverse.launches, ct.traverse_record.launches)

    rec = ct._launch_record(tri_bvh.wide, tri_bvh.leaves, "tri", o, d,
                            tri_bvh._skip(skip), EPS_B, EPS_P, tri, None,
                            None)
    (args,) = lib.calls
    assert len(args) == 22 + 6 + 2 + 1
    assert len(kernels.SIGNATURES["rtc_traverse_record"]) == len(args)
    assert args[:4] == (tri_bvh.wide.table.data_ptr(),
                        tri_bvh.leaves.data_ptr(), o.data_ptr(),
                        d.data_ptr())
    assert args[4:8] == tuple(t.data_ptr() for t in (
        skip.prim, skip.position, skip.normal, skip.inside))
    assert args[8] is None
    assert args[9:12] == (tri.n0.data_ptr(), tri.n1.data_ptr(),
                          tri.n2.data_ptr())
    assert args[12:17] == (None,) * 5
    assert args[17:22] == tuple(t.data_ptr() for t in (
        rec.prim, rec.t, rec.position, rec.normal, rec.inside))
    assert (rec.prim.dtype, rec.t.dtype, rec.inside.dtype) == (
        torch.int32, F32, torch.bool)
    assert args[22:] == (R, tri_bvh.wide.table.shape[0], tri_bvh.wide.depth,
                         tri_bvh.K, 0, 1, EPS_B, EPS_P * EPS_P, 1234)

    lib.calls.clear()
    order = torch.arange(R - 1, -1, -1)
    out = ct._launch_record(sph_bvh.wide, sph_bvh.leaves, "sph", o, d, None,
                            EPS_B, EPS_P, None, rec, order)
    (args,) = lib.calls
    assert args[4:8] == (None,) * 4
    assert args[8] == order.data_ptr()
    assert args[9:12] == (None,) * 3
    assert args[12:17] == tuple(t.data_ptr() for t in (
        rec.prim, rec.t, rec.position, rec.normal, rec.inside))
    assert args[17] == out.prim.data_ptr()
    assert args[22:28] == (R, sph_bvh.wide.table.shape[0],
                           sph_bvh.wide.depth, sph_bvh.K, 1, 0)
    assert (ct.traverse.launches, ct.traverse_record.launches) == (
        before[0] + 2, before[1] + 2)

    lib.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ct._launch_record(tri_bvh.wide, tri_bvh.leaves, "tri", o, d, None,
                          EPS_B, EPS_P, None, None, None)
    lib.err = 0
    assert (ct.traverse.launches, ct.traverse_record.launches) == (
        before[0] + 2, before[1] + 2)
    lib.calls.clear()
    with pytest.raises(ValueError, match="triangle table"):
        ct._launch_record(sph_bvh.wide, sph_bvh.leaves, "sph", o, d, None,
                          EPS_B, EPS_P, tri, None, None)
    f64 = dataclasses.replace(rec, t=rec.t.double())
    with pytest.raises(ValueError, match="prior.t"):
        ct._launch_record(sph_bvh.wide, sph_bvh.leaves, "sph", o, d, None,
                          EPS_B, EPS_P, None, f64, None)
    cut = dataclasses.replace(tri, n1=tri.n1[:-1])
    with pytest.raises(ValueError, match="tri.n1"):
        ct._launch_record(tri_bvh.wide, tri_bvh.leaves, "tri", o, d, None,
                          EPS_B, EPS_P, cut, None, None)
    assert not lib.calls


class _FakeGraph:
    def replay(self):
        pass


def test_record_launches_count_through_graph_replays():
    """A record launch recorded under a capture goes to the graph's tally
    under both wrappers, and each replay adds it to
    ``traverse_record.launches`` as to ``traverse.launches``."""
    before = (ct.traverse.launches, ct.traverse_record.launches)
    tally = {}
    kernels._capture_tally[0] = tally
    try:
        kernels.count_launch(ct.traverse)
        kernels.count_launch(ct.traverse_record)
    finally:
        kernels._capture_tally[0] = None
    assert tally == {ct.traverse: 1, ct.traverse_record: 1}
    assert (ct.traverse.launches, ct.traverse_record.launches) == before
    cap = graphs.Captured(graph=_FakeGraph(), inputs=(), outputs=None,
                          launches=tally, capture_ms=0.0, pool_bytes=0,
                          label="fake")
    for _ in range(3):
        cap.replay()
    assert (ct.traverse.launches, ct.traverse_record.launches) == (
        before[0] + 3, before[1] + 3)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the traversal kernel is CUDA C++ "
                    "for sm_90a and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["smooth", "spheres"])
def test_record_kernel_equals_the_chain_on_card(card, monkeypatch, name):
    """The kernel's records bit-equal to the chain's on the card (the
    chain: the detail launch and torch's eager ops), on a smooth lit mesh
    field and on the scene with a sphere BVH, an ellipsoid BVH and a
    tail; primary rays, misses among them, then two bounces with skip
    records, sorted and unsorted; one record launch a tree."""
    arrays, host_cam = scene_of(name, device=card)
    fn = closest_of(arrays, monkeypatch)
    chain = chain_closest(fn)
    o, d = rays_of(arrays, host_cam, card)
    skip = None
    for k in range(3):
        before = (ct.traverse.launches, ct.traverse_record.launches)
        got = fn(arrays, o, d, skip)
        torch.cuda.synchronize()
        n = len(fn.bvhs)
        assert (ct.traverse.launches - before[0],
                ct.traverse_record.launches - before[1]) == (n, n)
        want = chain(arrays, o, d, skip)
        assert not records_equal(got, want), (k, records_equal(got, want))
        srt = dispatch.make_bvh_closest_fn(build_bvh(arrays, leaf_size=4),
                                           arrays, traversal="kernel",
                                           sort=True)
        assert not records_equal(srt(arrays, o, d, skip), got), k
        assert bool((got.prim >= 0).any()) and bool((got.prim < 0).any())
        o, d = bounce(got, o, d, seed=k)
        skip = got


@pytest.mark.cuda
def test_graphed_mesh_pass_has_13_kernel_nodes_on_card(card):
    """A graphed BVH-route pass at recursion 4 is 13 kernel nodes: the two
    draws, the camera kernel, and a traversal and a shading launch a
    bounce; every traversal launch writes the record."""
    arrays, host_cam = lit_mesh(4, 1, 64, 4, device=card)
    r = rmod.Renderer(arrays, device=card, cameras=[host_cam])
    assert r.route == "bvh" and r.graphs
    r.step(1)   # captures
    torch.cuda.synchronize()
    before = (ct.traverse.launches, ct.traverse_record.launches)
    r.step(2)
    torch.cuda.synchronize()
    assert (ct.traverse.launches - before[0],
            ct.traverse_record.launches - before[1]) == (10, 10)
    (pg,) = r.pass_graphs.entries.values()
    with tempfile.TemporaryDirectory() as tmp:
        nodes = pg.captured.kernel_nodes(str(Path(tmp) / "pass.dot"))
    assert sum(nodes.values()) == 13, nodes
    assert sum(n for name, n in nodes.items()
               if "traverse_kernel" in name) == 5, nodes


@pytest.mark.cuda
def test_mesh184k_films_equal_the_chain_on_card(card):
    """3 graphed passes of the 184,322-triangle field at 512x512
    recursion 4 (mesh184k-512-rec4) against 3 eager passes whose closest
    hit is the chain: films bit-equal."""
    arrays, host_cam = lit_mesh(12, 3, 512, 4, device=card)
    assert arrays.triangles.v0.shape[0] == 184_322
    r = rmod.Renderer(arrays, device=card, cameras=[host_cam], seed=11)
    assert r.route == "bvh"
    r.step(3)
    want = rmod.Renderer(arrays, device=card, cameras=[host_cam], seed=11,
                         closest_fn=chain_closest(r.closest_fn),
                         graphs=False)
    want.step(3)
    torch.cuda.synchronize()
    for a, b in zip(r.film.tensors(), want.film.tensors()):
        assert bits_equal(a, b)
    assert float(r.film.color_sum.sum()) > 0
