"""The sphere fields on the port, one a leaf kind of the traversal kernel,
each merged into the record of the triangle tree before it:

* ``sph``, the 102,400-sphere field (the benchmark's configuration
  ``spheres102k-512-rec4``): untransformed spheres in a BVH of their own,
  walked by the sphere leaves (``KIND_SPH``);
* ``spht``, the 50,176-ellipsoid field (``ellipsoids50k-512-rec4``): unit
  spheres under an anisotropic scale, a z-rotation and a translation, in
  a BVH over their exact world boxes, walked by the ellipsoid leaves
  (``KIND_SPHT``: the object-space quadratic).

Both leaves follow the dense test's operation order (``csrc/
kernel_body.cuh`` ``sphere_pass`` / ``sphere_root``; for plain spheres
with the identity transform folded away), so their records are held to
the dense scan (``closest_hit_fused``) bit for bit.  The sphere field lies
500-1,100 units from its full-size camera, the ellipsoid field 270-710,
where the float32 quadratic keeps few digits and any other order moves
``t`` and the winner: the CPU cases put a grid-17 field (289 rows) before
the full-size camera of its configuration, at that distance.

One difference is the tree's by construction: the float32 quadratic
accepts some rays that pass just outside a sphere (its exact distance
from the centre above the radius), and where such a ray also passes
outside the sphere's box the walk never reaches the leaf.  On those rays
(:func:`assert_equals_dense`) the record must equal the dense scan without
the spheres whose false hits lie outside their boxes.

CPU tests, for each kind: the plain walk's records against the plain
dense scan, for camera rays and one scattered bounce with skip records,
with and without a prior triangle record; the program's film through the
BVH route against the benchmark's reference at a cut; the launch counters
by leaf kind and of merges through a graph's replays; the benchmark's
readers of the sphere and ellipsoid walks' rooflines.  Tests marked
``cuda`` run the kernel at full size and skip without a card; this file
imports no JAX, so on the card they run with ``python -m pytest
--noconftest -m cuda tests/test_torch_fields.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raytracercore_tpu_torch import kernels
from raytracercore_tpu_torch.bvh import build_bvh
from raytracercore_tpu_torch.bvh import builder
from raytracercore_tpu_torch.bvh import cuda_traverse as ct
from raytracercore_tpu_torch.core import graphs
from raytracercore_tpu_torch.core import vecmath as vm
from raytracercore_tpu_torch.intersect import dispatch
from raytracercore_tpu_torch.intersect.cuda_select import closest_hit_fused
from raytracercore_tpu_torch.intersect.dispatch import HitRecord
from raytracercore_tpu_torch.render import camera as cam_mod
from raytracercore_tpu_torch.render.renderer import Renderer
from raytracercore_tpu_torch.scene.types import HostCamera, init_camera
from rtbench import scenes
from rtbench.reference import view as ref_view

ROOT = Path(__file__).resolve().parent.parent
# Each leaf kind's configuration, its grid at full size, and the distances
# (least, most) from its full-size camera within which the cut's rows lie.
KINDS = {"sph": ("spheres102k-512-rec4", 320, (500, 1100)),
         "spht": ("ellipsoids50k-512-rec4", 224, (250, 750))}
F32 = torch.float32
EPS_B = vm.near_enough(F32)
EPS_P = vm.POSITION_EPS_F32
CUT_GRID = 17       # 289 rows: a field's BVH (>= 256), dense-scannable
WINDOW = 64         # the full-size camera's pixels around the image centre
# The select kernel keeps a scene's rows in shared memory: the card's dense
# scan of the full field goes through chunks of this many sphere rows.
CHUNK = 760


def _config(grid=None, size=None, recursion=None, kind="sph"):
    cfg = json.loads((ROOT / "rtbench" / "configs" / f"{KINDS[kind][0]}.json")
                     .read_text())
    if grid is not None:
        cfg["scene"] = dict(cfg["scene"], grid=grid)
    if size is not None:
        cfg["size"] = [size, size]
    if recursion is not None:
        cfg["recursion"] = recursion
    return cfg


def field(grid, device="cpu", kind="sph"):
    """``(SceneArrays, HostCamera)`` of the configuration of leaf kind
    ``kind`` at ``grid``, its camera the full-size field's (500-1,100 units
    from the spheres, 270-710 from the ellipsoids)."""
    scene, _ = scenes.for_program(scenes.make(_config(grid, kind=kind)),
                                  device)
    c = scenes.make(_config(kind=kind)).camera
    return scene, HostCamera(mode="frustum", position=c["position"],
                             look_at=c["look_at"], up=c["up"],
                             fov_or_size=c["fov"])


def camera_rays(host_cam, device, seed=3, window=WINDOW):
    """The full-size camera's jittered rays through the ``window`` x
    ``window`` pixels at the centre of its 512 x 512 image."""
    cam = init_camera(host_cam, 512, 512, device=device)
    px, py = cam_mod.pixel_grid(512, 512, device=device)
    lo, hi = 256 - window // 2, 256 + window // 2
    near = (px >= lo) & (px < hi) & (py >= lo) & (py < hi)
    px, py = px[near], py[near]
    g = torch.Generator(device="cpu").manual_seed(seed)
    jitter = torch.rand((px.shape[0], 4), generator=g).to(device)
    o, d = cam_mod.camera_rays(cam, px, py, jitter)
    return o.contiguous(), d.contiguous()


def scatter(hit, o, d, seed=5):
    """From every hit, a ray in a direction drawn on the unit sphere, with
    the hit as its skip record; missed rays go on as they were."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = torch.randn(o.shape, generator=g, dtype=F32).to(o.device)
    found = (hit.prim >= 0)[:, None]
    return (torch.where(found, hit.position, o).contiguous(),
            torch.where(found, vm.normalize(rnd), d).contiguous())


def spheres_only(scene):
    """``scene`` with its triangles masked: the spheres' dense scan."""
    tri = scene.triangles
    return dataclasses.replace(scene, triangles=dataclasses.replace(
        tri, prim_id=torch.full_like(tri.prim_id, -1)))


def without_spheres(scene, rows):
    """``scene`` with the sphere rows ``rows`` masked."""
    sph = scene.spheres
    pid = sph.prim_id.clone()
    pid[torch.as_tensor(rows, dtype=torch.long, device=pid.device)] = -1
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        sph, prim_id=pid))


def dense_scan(scene, o, d, skip):
    """The dense scan's record: ``closest_hit_fused`` over the whole scene,
    or, above the select kernel's rows, the triangles and planes then
    chunks of sphere rows merged in row order (strictly closer wins, as
    within one scan)."""
    if dispatch.n_table_rows(scene) <= 768:
        return closest_hit_fused(scene, o, d, skip)
    sph = scene.spheres
    rec = closest_hit_fused(dataclasses.replace(scene, spheres=_rows(
        sph, slice(0, 1), masked=True)), o, d, skip)
    planes = _rows(scene.planes, slice(0, 1), masked=True)
    for k in range(0, sph.prim_id.shape[0], CHUNK):
        part = closest_hit_fused(spheres_only(dataclasses.replace(
            scene, spheres=_rows(sph, slice(k, k + CHUNK)), planes=planes)),
            o, d, skip)
        rec = dispatch._hit_from_rec(dispatch._merge2(
            dispatch._rec_dict(rec), dispatch._rec_dict(part)))
    return rec


def _rows(table, rows, masked=False):
    cols = {f.name: getattr(table, f.name)[rows]
            for f in dataclasses.fields(table)}
    if masked:
        cols["prim_id"] = torch.full_like(cols["prim_id"], -1)
    return dataclasses.replace(table, **cols)


def bits_equal(a, b):
    """[R] bool: rows of ``a`` and ``b`` equal bit for bit."""
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return (a == b).reshape(a.shape[0], -1).all(1)


def unequal(got: HitRecord, want: HitRecord):
    """[R] bool: the rays whose records differ in any field's bits."""
    same = torch.ones_like(got.prim, dtype=torch.bool)
    for f in dataclasses.fields(HitRecord):
        same &= bits_equal(getattr(got, f.name), getattr(want, f.name))
    return ~same


def false_hit_outside_box(scene, o, d, prim):
    """[R] bool: the rays whose ``prim`` is a sphere that the exact ray
    (float64) misses and whose box it passes outside: centre ± radius for
    a plain sphere; for a transformed one the miss is decided in object
    space (the ray through ``world_to_obj``) and the box is the tree's
    (``builder.ellipsoid_bounds``)."""
    sph = scene.spheres
    is_sph = torch.isin(prim, sph.prim_id[sph.prim_id >= 0])
    row = torch.clamp(prim.long(), min=0, max=sph.prim_id.shape[0] - 1)
    c = sph.center[row].double()
    r = sph.radius[row].double()
    o64, d64 = o.double(), d.double()
    tf = sph.transformed[row][:, None]
    w2o = sph.world_to_obj[row].double()
    lin = w2o[:, :3, :3]
    oo = torch.where(tf, (lin @ o64[..., None])[..., 0] + w2o[:, :3, 3], o64)
    dd = torch.where(tf, (lin @ d64[..., None])[..., 0], d64)
    n = dd / dd.norm(dim=1, keepdim=True)
    f = oo - c
    miss = (f - (f * n).sum(1, keepdim=True) * n).norm(dim=1) > r
    lo, hi = builder.ellipsoid_bounds(
        sph.center[row].cpu().numpy(), sph.radius[row].cpu().numpy(),
        sph.obj_to_world[row].cpu().numpy())
    lo = torch.where(tf, torch.from_numpy(lo).double().to(o.device),
                     c - r[:, None])
    hi = torch.where(tf, torch.from_numpy(hi).double().to(o.device),
                     c + r[:, None])
    n = d64 / d64.norm(dim=1, keepdim=True)
    inv = 1.0 / torch.where(n == 0, torch.full_like(n, 1e-300), n)
    t0 = (lo - o64) * inv
    t1 = (hi - o64) * inv
    near = torch.minimum(t0, t1).max(1).values
    far = torch.maximum(t0, t1).min(1).values
    return is_sph & miss & (near > far)


def assert_equals_dense(got, scene, o, d, skip, dense_fn=dense_scan,
                        most=0.005):
    """``got`` bit-equal to the dense scan on every ray, but where the dense
    scan's winner is a false hit outside its sphere's box (at most
    ``most`` of the rays): there to the dense scan without that sphere,
    repeated while the next winner is one too.  Returns the number of such
    rays."""
    want = dense_fn(scene, o, d, skip)
    bad = torch.nonzero(unequal(got, want))[:, 0]
    boxed = 0
    for i in bad.tolist():
        sk = None if skip is None else HitRecord(
            *(getattr(skip, f.name)[i:i + 1]
              for f in dataclasses.fields(HitRecord)))
        oi, di = o[i:i + 1], d[i:i + 1]
        g = HitRecord(*(getattr(got, f.name)[i:i + 1]
                        for f in dataclasses.fields(HitRecord)))
        w = HitRecord(*(getattr(want, f.name)[i:i + 1]
                        for f in dataclasses.fields(HitRecord)))
        masked = []
        while bool(unequal(g, w)[0]):
            assert bool(false_hit_outside_box(scene, oi, di, w.prim)[0]), (
                i, int(g.prim[0]), int(w.prim[0]), float(g.t[0]),
                float(w.t[0]))
            row = torch.nonzero(scene.spheres.prim_id == w.prim[0])[0, 0]
            masked.append(int(row))
            w = dense_fn(without_spheres(scene, masked), oi, di, sk)
        boxed += 1
    assert boxed <= most * o.shape[0], (boxed, o.shape[0])
    return boxed


# --- on the CPU ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def cut_of(kind):
    """``(scene, closest_fn, o, d)``: the grid-17 field of leaf kind
    ``kind``, its BVH closest hit on the CPU (a triangle tree, then the
    ``kind`` tree, no dense tail) and the full-size camera's rays."""
    scene, host_cam = field(CUT_GRID, kind=kind)
    fn = dispatch.make_bvh_closest_fn(build_bvh(scene), scene,
                                      traversal="kernel")
    assert [b.leaf_kind for b in fn.bvhs] == ["tri", kind]
    assert fn.tail is None
    o, d = camera_rays(host_cam, "cpu")
    sph = scene.spheres
    centre = torch.where(sph.transformed[:, None],
                         sph.obj_to_world[:, :3, 3], sph.center)
    dist = (o[0] - centre[:CUT_GRID ** 2]).norm(dim=1)
    least, most = KINDS[kind][2]
    assert least < float(dist.min()) and float(dist.max()) < most
    return scene, fn, o, d


def _kind_cases(*axes):
    """The cases of every leaf kind over ``axes`` (``(values, ids)`` each,
    the first outermost); the sphere cases keep the ids they had before
    the ellipsoid cases came."""
    return [pytest.param(kind, *(v for v, _ in combo), id="-".join(
        ([] if kind == "sph" else [kind]) + [i for _, i in combo]))
        for kind in KINDS
        for combo in itertools.product(*(zip(v, i) for v, i in axes))]


@pytest.mark.parametrize("kind, bounce, prior", _kind_cases(
    ([0, 1], ["camera", "bounce"]), ([False, True], ["alone", "merged"])))
def test_sphere_records_equal_the_dense_scan(kind, bounce, prior):
    """``CudaSphereBVH.record`` / ``CudaEllipsoidBVH.record`` on CPU
    tensors (the plain walk and its epilogue), alone against the spheres'
    dense scan or merged into the triangle tree's record against the whole
    scene's, for camera rays and one scattered bounce with the dense hits
    as skip records: prim, t, position, normal and inside bit-equal."""
    scene, fn, o, d = cut_of(kind)
    tri_bvh, sph_bvh = fn.bvhs
    skip = None
    if bounce:
        skip = closest_hit_fused(scene, o, d, None)
        o, d = scatter(skip, o, d)
    if prior:
        a = tri_bvh.record(o, d, skip, EPS_B, EPS_P)
        got = sph_bvh.record(o, d, skip, EPS_B, EPS_P, prior=a)
        target = scene
    else:
        got = sph_bvh.record(o, d, skip, EPS_B, EPS_P)
        target = spheres_only(scene)
    assert_equals_dense(got, target, o, d, skip)
    sph = (got.prim >= 0) & (got.prim < CUT_GRID ** 2)
    assert int(sph.sum()) > 300
    if prior:
        assert bool(((got.prim >= CUT_GRID ** 2)).any())   # the quads win too
    # Normalized normals: off 1 by a few ulps at most.
    length = got.normal[sph].double().norm(dim=1)
    assert float((length - 1).abs().max()) < 1e-6


@pytest.mark.parametrize("kind, route", _kind_cases((["bvh", "auto"],
                                                     ["bvh", "auto"])))
def test_cut_film_equals_the_reference(kind, route):
    """Grid 17 at 24x24, recursion 3: the program's film on the CPU
    (route ``bvh``: the triangle tree, then the sphere or ellipsoid tree
    merged into its record, the plain walks; route ``auto``: the dense
    scan) bit-equal to the benchmark's reference film of the same
    passes."""
    seed = 2**40 + 27
    inputs = scenes.make(_config(CUT_GRID, 24, 3, kind=kind))
    scene, cameras = scenes.for_program(inputs, "cpu")
    r = Renderer(scene, device="cpu", seed=seed, cameras=cameras,
                 accelerator=route)
    if route == "bvh":
        assert [b.leaf_kind for b in r.closest_fn.bvhs] == ["tri", kind]
    r.step(2)
    n = 24 * 24
    want = ref_view.film_at(inputs.tables, inputs.camera, seed, np.arange(n),
                            2, 2, "cpu")
    assert np.array_equal(r.film.color_sum.reshape(n, 3).numpy(),
                          want["color_sum"])
    assert np.array_equal(r.film.samples.reshape(n).numpy(),
                          want["samples"])
    assert np.array_equal(r.image().reshape(n, 4), want["image"])
    assert want["samples"].sum() > n


class _FakeLib:
    def rtc_traverse_record(self, *args):
        return 0


class _FakeGraph:
    def replay(self):
        pass


def assert_record_counters_through_graph_replays(kind, monkeypatch):
    """The closest hits of one pass of the grid-17 field of leaf kind
    ``kind`` (recursion 4: five bounces) recorded under a capture, with the
    kernel library mocked: the graph's tally holds one ``tri`` and one
    ``kind`` record launch a bounce, every ``kind`` launch merged into the
    triangle record, none of the other leaf kind; each replay adds them to
    the counters."""
    scene, fn, o, d = cut_of(kind)
    monkeypatch.setattr(kernels, "load", lambda: _FakeLib())
    monkeypatch.setattr(ct, "_stream", lambda device: 1234)
    plain = ct.traverse_record

    def launching(wide, leaves, leaf_kind, ray_o, ray_d, skip, eps_behind,
                  eps_pos, tri=None, prior=None, order=None):
        return ct._launch_record(wide, leaves, leaf_kind, ray_o, ray_d, skip,
                                 eps_behind, eps_pos, tri, prior, order)
    launching.launches = 0
    launching.by_kind, launching.merges = plain.by_kind, plain.merges
    monkeypatch.setattr(ct, "traverse_record", launching)

    counters = [ct.traverse, launching, *plain.by_kind.values(),
                plain.merges]
    before = [c.launches for c in counters]
    tally = {}
    kernels._capture_tally[0] = tally
    try:
        for _ in range(scene.recursion + 1):
            fn(scene, o, d, None)
    finally:
        kernels._capture_tally[0] = None
    bounces = scene.recursion + 1
    assert tally == {ct.traverse: 2 * bounces, launching: 2 * bounces,
                     plain.by_kind["tri"]: bounces,
                     plain.by_kind[kind]: bounces,
                     plain.merges: bounces}
    assert [c.launches for c in counters] == before
    cap = graphs.Captured(graph=_FakeGraph(), inputs=(), outputs=None,
                          launches=tally, capture_ms=0.0, pool_bytes=0,
                          label="fake")
    for _ in range(3):
        cap.replay()
    after = [c.launches - b for c, b in zip(counters, before)]
    assert after == [6 * bounces, 6 * bounces] + [
        3 * bounces if k in ("tri", kind) else 0
        for k in plain.by_kind] + [3 * bounces]


def test_record_counters_by_kind_through_graph_replays(monkeypatch):
    """The sphere field: one ``tri`` and one ``sph`` record launch a
    bounce, every ``sph`` launch a merge, no ``spht``."""
    assert list(ct.traverse_record.by_kind) == ["tri", "sph", "spht"]
    assert_record_counters_through_graph_replays("sph", monkeypatch)


def test_ellipsoid_record_counters_through_graph_replays(monkeypatch):
    """The ellipsoid field: one ``tri`` and one ``spht`` record launch a
    bounce, every ``spht`` launch a merge, ``sph`` reading 0."""
    assert_record_counters_through_graph_replays("spht", monkeypatch)


class _Profile:
    """A traced stretch's kernels by name: ``kernel(part)`` sums those whose
    name holds ``part``, as ``rtbench.devtrace.Profile`` does."""

    def __init__(self, kernels_by_name):
        self.kernels = kernels_by_name

    def kernel(self, part):
        hits = [v for name, v in self.kernels.items() if part in name]
        return (sum(s for s, _ in hits), sum(n for _, n in hits))


def _metric(name):
    from rtbench.run import load_module
    return load_module(ROOT / "rtbench" / "metrics" / f"{name}.py")


def test_sphere_walk_roofline_reads_sphere_walks_only(monkeypatch):
    """The benchmark's ``sphere_walk_roofline`` reads None while the
    program counts no record launch over sphere leaves, and otherwise the
    least time of a launch's work over its mean device time; the work
    counts 135 bytes a ray of a bounce and 16 a sphere."""
    from rtbench.peaks import bound_ms

    metric = _metric("sphere_walk_roofline")

    class Profile:
        def kernel(self, part):
            return (0.5, 100) if part == metric.KERNEL else (0.0, 0)

    tables = scenes.make(_config(CUT_GRID)).tables
    ctx = SimpleNamespace(profile=Profile(), counts={
        "scene_tables": tables, "rays_per_pass": 512 * 512,
        "bounces_per_path": 3.0})
    sph = ct.traverse_record.by_kind["sph"]
    monkeypatch.setattr(sph, "launches", 0)
    assert metric.read(ctx) is None
    monkeypatch.setattr(sph, "launches", 5)
    rays = 512 * 512 * 3.0 / 5
    ops, n_bytes = metric.work(rays, CUT_GRID ** 2)
    assert n_bytes == rays * 135 + CUT_GRID ** 2 * 16
    assert metric.read(ctx) == pytest.approx(100 * bound_ms(ops, n_bytes)
                                             / 5.0)


# Kernel names as the profiler gives them: a traced stretch of the
# ellipsoid field holds the quads' walk and the merged ellipsoid walk.
FIELD_KERNELS = {
    "void rtc::traverse_kernel<0, false, 1>(rtc::TraverseParams)": (0.02, 100),
    "void rtc::traverse_kernel<2, false, 5>(rtc::TraverseParams)": (0.5, 100),
    "void rtc::shade_bounce_kernel<float, false, false, true>"
    "(rtc::ShadeParams)": (0.1, 100)}


def test_ellipsoid_walk_roofline_reads_ellipsoid_walks_only(monkeypatch):
    """The benchmark's ``ellipsoid_walk_roofline`` reads None while the
    program counts no record launch over ellipsoid leaves, and otherwise
    the least time of a ``traverse_kernel<2,`` launch's work over its mean
    device time, the other walks left out; the work counts 135 bytes a ray
    of a bounce and 112 a transformed sphere."""
    from rtbench.peaks import bound_ms

    metric = _metric("ellipsoid_walk_roofline")
    tables = scenes.make(_config(CUT_GRID, kind="spht")).tables
    ctx = SimpleNamespace(profile=_Profile(FIELD_KERNELS), counts={
        "scene_tables": tables, "rays_per_pass": 512 * 512,
        "bounces_per_path": 3.0})
    spht = ct.traverse_record.by_kind["spht"]
    monkeypatch.setattr(spht, "launches", 0)
    assert metric.read(ctx) is None
    monkeypatch.setattr(spht, "launches", 5)
    rays = 512 * 512 * 3.0 / 5
    ops, n_bytes = metric.work(rays, CUT_GRID ** 2)
    assert n_bytes == rays * 135 + CUT_GRID ** 2 * 112
    assert ops >= rays * (33 + 10 + 22 + 24 + 8 + 31 + 27)
    assert metric.read(ctx) == pytest.approx(100 * bound_ms(ops, n_bytes)
                                             / 5.0)
    # No ellipsoid walk in the stretch: nothing to read.
    ctx.profile = _Profile({k: v for k, v in FIELD_KERNELS.items()
                            if "<2," not in k})
    assert metric.read(ctx) is None
    # Only transformed rows count: none in the sphere field's tables.
    assert metric.n_ellipsoids(tables) == CUT_GRID ** 2
    assert metric.n_ellipsoids(scenes.make(_config(CUT_GRID)).tables) == 0


def test_sphere_walk_roofline_reads_none_on_the_ellipsoid_field(monkeypatch):
    """On the ellipsoid field the program counts no ``sph`` record launch
    (its counters read 0 there, as the counter test shows): the sphere
    walk's roofline reads None while the ellipsoid walk's reads a
    number."""
    tables = scenes.make(_config(CUT_GRID, kind="spht")).tables
    ctx = SimpleNamespace(profile=_Profile(FIELD_KERNELS), counts={
        "scene_tables": tables, "rays_per_pass": 512 * 512,
        "bounces_per_path": 3.0})
    kinds = ct.traverse_record.by_kind
    monkeypatch.setattr(kinds["sph"], "launches", 0)
    monkeypatch.setattr(kinds["spht"], "launches", 10)
    assert _metric("sphere_walk_roofline").read(ctx) is None
    assert _metric("ellipsoid_walk_roofline").read(ctx) > 0


# --- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the traversal kernel is CUDA C++ "
                    "for sm_90a and has no CPU mode")
    return torch.device("cuda")


def assert_full_field_equals_plain_and_dense(card, kind):
    """The full field of leaf kind ``kind`` on the card: 65,536 camera rays
    (the 256 x 256 pixels at the centre of the 512 x 512 image) and one
    scattered bounce with skip records.  The record kernel
    (``traverse_kernel<KIND, false, 5>``, merged into the triangle tree's
    record) bit-equal to its plain version (the plain wide walk and
    ``record_reference`` on the card) and to the dense scan
    (``closest_hit_fused`` over chunks of rows)."""
    _, grid, _ = KINDS[kind]
    scene, host_cam = field(grid, card, kind=kind)
    assert int((scene.spheres.prim_id >= 0).sum()) == grid * grid
    fn = dispatch.make_bvh_closest_fn(build_bvh(scene), scene,
                                      traversal="kernel")
    tri_bvh, sph_bvh = fn.bvhs
    assert sph_bvh.leaf_kind == kind and fn.tail is None
    o, d = camera_rays(host_cam, card, window=256)
    assert o.shape[0] == 65_536
    skip = None
    for k in range(2):
        before = (ct.traverse_record.by_kind[kind].launches,
                  ct.traverse_record.merges.launches)
        got = fn(scene, o, d, skip)
        torch.cuda.synchronize()
        assert (ct.traverse_record.by_kind[kind].launches - before[0],
                ct.traverse_record.merges.launches - before[1]) == (1, 1)
        a = ct.record_reference(ct.traverse_wide_reference(
            tri_bvh.wide, tri_bvh.leaves, "tri", o, d, tri_bvh._skip(skip),
            EPS_B, EPS_P))
        plain = ct.record_reference(ct.traverse_wide_reference(
            sph_bvh.wide, sph_bvh.leaves, kind, o, d, sph_bvh._skip(skip),
            EPS_B, EPS_P), prior=a)
        assert not bool(unequal(got, plain).any()), k
        boxed = assert_equals_dense(got, scene, o, d, skip)
        on_sph = int(((got.prim >= 0) & (got.prim < grid * grid)).sum())
        print(f"{kind} bounce {k}: {int((got.prim >= 0).sum())} hits, "
              f"{on_sph} on the field, {boxed} false dense hits outside "
              "their boxes")
        assert on_sph > 10_000
        skip = got
        o, d = scatter(got, o, d, seed=k)


@pytest.mark.cuda
def test_full_field_kernel_equals_plain_and_dense_on_card(card):
    """The full sphere field (102,400 spheres): ``traverse_kernel<1,
    false, 5>``."""
    assert_full_field_equals_plain_and_dense(card, "sph")


@pytest.mark.cuda
def test_full_ellipsoid_field_kernel_equals_plain_and_dense_on_card(card):
    """The full ellipsoid field (50,176 transformed spheres):
    ``traverse_kernel<2, false, 5>``."""
    assert_full_field_equals_plain_and_dense(card, "spht")


def assert_graphed_pass_counts(card, kind):
    """A graphed pass of the full field of leaf kind ``kind`` at 512 x 512,
    recursion 4: a ``tri`` and a ``kind`` record launch a bounce, each
    ``kind`` launch merged into the triangle record, none of the other
    leaf kind."""
    scene, host_cam = field(KINDS[kind][1], card, kind=kind)
    r = Renderer(scene, device=card, cameras=[host_cam])
    assert r.route == "bvh" and r.graphs
    r.step(1)   # captures
    torch.cuda.synchronize()
    kinds = ct.traverse_record.by_kind
    counters = [kinds["tri"], kinds["sph"], kinds["spht"],
                ct.traverse_record.merges]
    before = [c.launches for c in counters]
    r.step(2)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [
        10, 10 if kind == "sph" else 0, 10 if kind == "spht" else 0, 10]


@pytest.mark.cuda
def test_graphed_field_pass_counts_a_merged_sphere_walk_a_bounce(card):
    assert_graphed_pass_counts(card, "sph")


@pytest.mark.cuda
def test_graphed_field_pass_counts_a_merged_ellipsoid_walk_a_bounce(card):
    assert_graphed_pass_counts(card, "spht")
