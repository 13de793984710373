"""The bounce loop's pass without eager glue (``integrator.trace_pass``):
which passes take it, its plain form against the chain it replaces, its
launchers, and, on the card, its kernels bit for bit.

A pass of the ``trace`` route (dense select kernel or BVH) on a CUDA
device, into a float32 film without compensation and untiled, is the
pass's two ``torch.rand`` draws, one launch of the camera kernel
(``shade_kernel.pass_rays``) and, each bounce, the closest hit and one
launch of the shading kernel on the bounce's raw draws
(``shade_kernel.shade_bounce_pass``: uniform channels computed in the
kernel, the renormalization of the next bounce, the film add at the last)
on the scene's material rows, packed once (``SceneArrays.material_rows``).
Every other pass runs the chain ``camera_rays`` → ``preprocess_uniforms``
→ ``trace`` → ``Film.add_full_frame_`` (``render_pass_``), its plain
version.

CPU tests: which pass takes which form (``renderer.pass_form``, on every
route), the raw draws' channels against ``preprocess_uniforms``, the plain
form's film against ``render_pass_`` on a cut of mesh-722 (dense and BVH
routes), the eager and graphed pass bodies' dispatch, and the launchers
with the kernel library mocked.  Tests marked ``cuda`` run the kernels
and skip without a card; this file imports no JAX, so on the card they
run with
``python -m pytest --noconftest -m cuda tests/test_torch_trace_pass.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import pytest
import torch

from raytracercore_tpu_torch import kernels
from raytracercore_tpu_torch.core import spans
from raytracercore_tpu_torch.core import vecmath as vm
from raytracercore_tpu_torch.intersect.cuda_select import closest_hit_fused
from raytracercore_tpu_torch.parallel.worker import CORNELL_SCENE
from raytracercore_tpu_torch.render import fused, integrator
from raytracercore_tpu_torch.render import renderer as rmod
from raytracercore_tpu_torch.render import shade_kernel as sk
from raytracercore_tpu_torch.render.film import Film
from raytracercore_tpu_torch.render.integrator import (PathState,
                                                       preprocess_uniforms,
                                                       shade_bounce_reference)
from raytracercore_tpu_torch.scene import loader, meshgen
from raytracercore_tpu_torch.scene.types import freeze_scene, init_camera

F32, F64 = torch.float32, torch.float64
SEEDS = (0, 7, 2**33 + 5)
# The cameras of the checks: the scene's frustum camera, an ortho camera
# and the frustum camera with depth of field.
CAMERAS = ("frustum", "ortho", "dof")


def mesh(grid=2, width=12, height=10, recursion=10, camera="frustum",
         device="cpu"):
    """The icosphere field of mesh-722 (``grid`` 3) or its cut (``grid`` 2:
    4 icospheres, 322 rows) with the light two-sided, as the port's
    ``load_scene("mesh-722")``: its arrays, host camera and render-ready
    camera."""
    arrays, cam, _ = meshgen.make_mesh_scene(
        grid=grid, subdiv=1, recursion=recursion, width=width,
        height=height, device=device)
    two_sided = arrays.materials.two_sided.clone()
    two_sided[-1] = True
    arrays = dataclasses.replace(arrays, materials=dataclasses.replace(
        arrays.materials, two_sided=two_sided))
    if camera == "ortho":
        cam = dataclasses.replace(cam, mode="ortho", fov_or_size=4.0)
    elif camera == "dof":
        cam = dataclasses.replace(cam, image_plane=0.5, dof_amount=2.0,
                                  focal_length=9.0)
    return arrays, cam, init_camera(cam, width, height, device=device)


def shiny(arrays):
    """``arrays`` with every third material row a mirror of infinite
    shininess (``material_rows`` keeps the infinity; ``_material_matrix``
    puts the f32 maximum there) and the other rows' shininess finite, so
    the rough-normal draw decides some paths."""
    m = arrays.materials
    shin = torch.full_like(m.shininess, 40.0)
    shin[::3] = float("inf")
    spec = m.specular.clone()
    spec[::3] = 0.4
    spec[1::3] = 0.2
    return dataclasses.replace(arrays, materials=dataclasses.replace(
        m, shininess=shin, specular=spec))


def route_fn(arrays, route):
    """The closest hit of a ``trace``-route pass: the dense select kernel
    (``"dense"``), or the BVH walk (``"bvh"``)."""
    closest_fn, trace_fn, _ = rmod.pick_route(
        arrays, "bvh" if route == "bvh" else "auto")
    assert trace_fn is None
    assert (closest_fn is closest_hit_fused) == (route == "dense")
    return closest_fn


def draws(seed, k, arrays, device):
    return rmod.raw_draws(rmod.pass_generator(seed, k, device),
                          arrays.height * arrays.width, arrays.recursion + 1)


def chain_passes(arrays, camera, film, seed, passes, closest_fn):
    """``passes`` passes of the chain on the draws the glue-free pass
    takes: ``render_pass_`` on ``preprocess_uniforms(raw)``, into ``film``
    in place."""
    for k in range(passes):
        jitter, raw = draws(seed, k, arrays, film.samples.device)
        rmod.render_pass_(arrays, camera, film, jitter,
                          preprocess_uniforms(raw), closest_fn=closest_fn)
    return film


def films_equal(a: Film, b: Film) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))


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


def flat(x) -> list:
    """The tensors of a PathState / PathTape / BounceRecords, in order."""
    out = []
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        out += flat(v) if dataclasses.is_dataclass(v) else [v]
    return out


# --- which passes take which form ----------------------------------------

@functools.lru_cache(maxsize=None)
def routed(route):
    """A small scene of ``route`` as ``pick_route`` gives it: ``(arrays,
    camera, trace_fn)`` — the Cornell scene on the megakernel, mesh-82
    (one icosphere) on the select kernel (``"trace"``) or on the BVH."""
    if route == "megakernel":
        host = loader.parse(CORNELL_SCENE)
        host.width = host.height = 8
        arrays = freeze_scene(host, device="cpu")
        camera = init_camera(host.cameras[0], 8, 8, device="cpu")
    else:
        arrays, _, camera = mesh(grid=1, width=8, height=8)
    _, trace_fn, bvh = rmod.pick_route(
        arrays, "bvh" if route == "bvh" else "auto")
    assert (trace_fn is fused.trace_fused) == (route == "megakernel")
    assert (bvh is not None) == (route == "bvh")
    return arrays, camera, trace_fn


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("route", ["megakernel", "trace", "bvh"])
@pytest.mark.parametrize("tile", [0, 8])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_pass_form_route_choice(dtype, compensated, tile, route, device,
                                grad):
    """Only a pass on a CUDA device into a float32, uncompensated film,
    untiled, takes a whole form: the megakernel's on its route, the bounce
    loop's (select kernel or BVH) unless a scene tensor requires grad
    while autograd records; every other pass runs the chain (None)."""
    arrays, camera, trace_fn = routed(route)
    if grad:
        diffuse = arrays.materials.diffuse.clone().requires_grad_(True)
        arrays = dataclasses.replace(arrays, materials=dataclasses.replace(
            arrays.materials, diffuse=diffuse))
    whole = (dtype == F32 and not compensated and tile == 0
             and device == "cuda")
    if not whole:
        want = None
    elif route == "megakernel":
        want = rmod._megakernel_pass
    else:
        want = None if grad else integrator.trace_pass
    assert rmod.pass_form(arrays, camera, trace_fn, device, dtype,
                          compensated, tile) is want


def test_whole_trace_pass_refuses_debug_geom_and_grad():
    """A ``debug geom`` scene, and a scene or camera with a tensor that
    requires grad while autograd records, keep the chain; under
    ``torch.no_grad`` the same scene takes the glue-free pass."""
    arrays, _, camera = mesh(grid=1, width=8, height=8)
    args = (None, "cuda", F32, False, 0)
    glue_free = integrator.trace_pass
    assert rmod.pass_form(arrays, camera, *args) is glue_free
    geom = dataclasses.replace(arrays, debug_geom=True)
    assert rmod.pass_form(geom, camera, *args) is None
    diffuse = arrays.materials.diffuse.clone().requires_grad_(True)
    fit = dataclasses.replace(arrays, materials=dataclasses.replace(
        arrays.materials, diffuse=diffuse))
    assert rmod.pass_form(fit, camera, *args) is None
    with torch.no_grad():
        assert rmod.pass_form(fit, camera, *args) is glue_free
    moved = dataclasses.replace(
        camera, position=camera.position.clone().requires_grad_(True))
    assert rmod.pass_form(arrays, moved, *args) is None


# --- the raw draws' channels ------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 4099])
@pytest.mark.parametrize("seed", SEEDS)
def test_bounce_channels_equal_preprocess_uniforms(seed, n):
    """The channels one bounce computes from its raw draws ``[5, R]``
    (the plain version of the shading kernel's pass form) are bit-equal to
    that bounce's planes of ``preprocess_uniforms`` over all ``[B, 5, R]``
    draws, edge values of the clamps included."""
    gen = torch.Generator().manual_seed(seed)
    raw = torch.rand((11, 5, n), generator=gen)
    edges = torch.tensor([0.0, 1e-30, 1e-20, 0.5, 1.0 - 2**-24, 1.0])
    k = min(n, edges.numel())
    raw[3, :, :k] = edges[:k]
    planes = preprocess_uniforms(raw)
    assert planes.shape == (11, 7, n)
    for i in range(11):
        assert bits_equal(preprocess_uniforms(raw[i]), planes[i]), i


# --- the plain form against the chain ----------------------------------------

@pytest.mark.parametrize("route,camera,seed,rows", [
    ("dense", "frustum", SEEDS[0], "plain"),
    ("dense", "frustum", SEEDS[1], "plain"),
    ("dense", "frustum", SEEDS[2], "plain"),
    ("dense", "ortho", SEEDS[1], "plain"), ("dense", "dof", SEEDS[2], "plain"),
    ("dense", "frustum", SEEDS[0], "shiny"),
    ("bvh", "frustum", SEEDS[0], "plain")])
def test_plain_trace_pass_films_equal_the_chain(route, camera, seed, rows):
    """On CPU tensors ``trace_pass`` runs the plain versions of the camera
    and shading kernels; 2 passes of it on a cut of mesh-722 (322 rows,
    12x10, recursion 10; ``shiny``: mirrors of infinite shininess among
    the rows) film bit-equal to 2 passes of ``render_pass_`` on the same
    draws, and launch nothing."""
    arrays, _, cam = mesh(camera=camera)
    if rows == "shiny":
        arrays = shiny(arrays)
    closest_fn = route_fn(arrays, route)
    want = chain_passes(arrays, cam, Film.create(10, 12, device="cpu"),
                        seed, 2, closest_fn)
    got = Film.create(10, 12, device="cpu")
    launches = sk.pass_rays.launches, sk.shade_bounce.launches
    for k in range(2):
        jitter, raw = draws(seed, k, arrays, "cpu")
        assert integrator.trace_pass(arrays, cam, got, jitter, raw,
                                     closest_fn) is got
    assert films_equal(got, want)
    assert float(got.samples.sum() + got.misses.sum()) == 2 * 120
    assert (sk.pass_rays.launches, sk.shade_bounce.launches) == launches


def _bounces(arrays, cam, seed):
    """Each bounce of one chain pass (``trace`` with a spy body): ``[(hit,
    state, d, i)]``, and the pass's raw draws."""
    jitter, raw = draws(seed, 0, arrays, "cpu")
    seen = []

    def spy(hit, state, d, u, *rest):
        seen.append((hit, state, d, rest[3]))
        return shade_bounce_reference(hit, state, d, u, *rest)
    px, py = rmod.cam_mod.pixel_grid(arrays.width, arrays.height,
                                     device="cpu")
    ray_o, ray_d = rmod.cam_mod.camera_rays(cam, px, py, jitter)
    with torch.no_grad():
        integrator.trace(arrays, ray_o.contiguous(), ray_d.contiguous(),
                         None, closest_fn=closest_hit_fused,
                         uniforms=preprocess_uniforms(raw), shade_fn=spy)
    return seen, jitter, raw


def test_plain_pass_pieces_equal_trace_bounce_by_bounce():
    """The plain ``pass_rays`` is ``camera_rays`` with the direction
    normalized as ``trace`` does at bounce 0; the plain
    ``shade_bounce_pass`` on the scene's ``material_rows`` gives
    ``trace``'s state after every bounce on ``_material_matrix`` (bit for
    bit, mirrors of infinite shininess among the rows) but the direction
    of a bounce before a renormalizing one, which comes out normalized,
    and at the last bounce adds the result into the film as
    ``Film.add_full_frame_`` does."""
    arrays, _, cam = mesh(width=8, height=6, recursion=6)
    arrays = shiny(arrays)
    seen, jitter, raw = _bounces(arrays, cam, 3)
    ray_o, d0 = sk.pass_rays(cam, jitter, 8)
    assert bits_equal(d0, seen[0][2])
    matf = integrator._material_matrix(arrays.materials)
    amb, air = arrays.ambient_rgb, arrays.air_refractive_index
    for hit, state, d, i in seen:
        last = i == arrays.recursion
        film = Film.create(6, 8, device="cpu") if last else None
        got = sk.shade_bounce_pass(hit, None if i == 0 else state, d, raw,
                                   arrays.material_rows, amb, air, i,
                                   arrays.recursion, arrays.ambient_is_miss,
                                   film=film, renorm=(i + 1) % 3 == 0)
        want = shade_bounce_reference(hit, state, d,
                                      preprocess_uniforms(raw)[i], matf, amb,
                                      air, i, arrays.recursion,
                                      arrays.ambient_is_miss)
        if last:
            assert got is None
            ref = Film.create(6, 8, device="cpu").add_full_frame_(
                want.result, want.miss)
            assert films_equal(film, ref)
            continue
        if (i + 1) % 3 == 0:
            want = dataclasses.replace(want, ray_d=vm.normalize(want.ray_d))
            assert bits_equal(want.ray_d, seen[i + 1][2])
        for a, b in zip(flat(got), flat(want)):
            assert bits_equal(a, b), i


# --- the eager and graphed bodies ------------------------------------------

def _trace_pass_where_admitted(monkeypatch):
    """Decide each pass's form as for a film on the card, so a bounce-loop
    pass takes the glue-free pass (which runs its plain form on CPU
    tensors); returns the list of ``(jitter, raw)`` the passes were
    given."""
    calls = []
    real = integrator.trace_pass

    def trace_pass(scene, camera, film, jitter, raw, closest_fn):
        calls.append((jitter, raw))
        return real(scene, camera, film, jitter, raw, closest_fn)

    real_form = rmod.pass_form

    def on_the_card(scene, camera, trace_fn, device, *rest):
        return real_form(scene, camera, trace_fn, "cuda", *rest)

    monkeypatch.setattr(rmod, "pass_form", on_the_card)
    monkeypatch.setattr(integrator, "trace_pass", trace_pass)
    return calls


def test_render_passes_runs_the_glue_free_pass_where_admitted(monkeypatch):
    """Eager ``render_passes`` on a pass that ``pass_form`` gives the
    glue-free pass runs ``trace_pass`` once a pass on the pass's float32
    draws (spans ``camera_rays`` and a ``closest_hit`` a bounce, no
    ``film_accum`` and no ``trace_pass``, the megakernel's), on a copy of
    the caller's film; the film is the chain's, bit for bit."""
    arrays, _, cam = mesh(width=8, height=6, recursion=4)
    film = Film.create(6, 8, device="cpu")
    want = rmod.render_passes(arrays, cam, film, 5, 2, 2,
                              closest_fn=closest_hit_fused, graphs=False)
    calls = _trace_pass_where_admitted(monkeypatch)
    spans.start()
    try:
        got = rmod.render_passes(arrays, cam, film, 5, 2, 2,
                                 closest_fn=closest_hit_fused, graphs=False)
    finally:
        records = spans.stop()
    names = [rec[0] for rec in records]
    assert len(calls) == 2 and names.count("camera_rays") == 2
    assert names.count("closest_hit") == 2 * 5
    assert "film_accum" not in names and "trace_pass" not in names
    for jitter, raw in calls:
        assert jitter.shape == (48, 4) and jitter.dtype == F32
        assert raw.shape == (5, 5, 48) and raw.dtype == F32
    assert films_equal(got, want)
    assert not film.samples.any()  # the caller's film is left alone


def test_pass_graph_body_runs_the_glue_free_pass(monkeypatch):
    """The pass graph's body of a bounce-loop pass that ``pass_form``
    gives the glue-free pass, run eagerly on its generator seeded for
    pass ``k``, gives ``trace_pass`` the draws ``raw_draws`` makes and
    adds the chain's samples into the graph's film."""
    arrays, _, cam = mesh(width=8, height=6, recursion=4)
    calls = _trace_pass_where_admitted(monkeypatch)
    captured = {}

    def capture(body, inputs, **kwargs):
        captured["body"], captured["inputs"] = body, inputs
        return None

    monkeypatch.setattr(rmod.graphs_mod, "capture", capture)
    pg = rmod.PassGraph(arrays, cam, Film.create(6, 8, device="cpu"),
                        closest_fn=closest_hit_fused)
    pg.generator.manual_seed(rmod.pass_seed(9, 4))
    captured["body"](*captured["inputs"])
    (jitter, raw), = calls
    want_jitter, want_raw = draws(9, 4, arrays, "cpu")
    assert torch.equal(jitter, want_jitter) and torch.equal(raw, want_raw)
    want = Film.create(6, 8, device="cpu")
    rmod.render_pass_(arrays, cam, want, want_jitter,
                      preprocess_uniforms(want_raw),
                      closest_fn=closest_hit_fused)
    assert films_equal(pg.film, want)


# --- the launchers, with the library mocked --------------------------------

class _FakeLib:
    def __init__(self):
        self.calls, self.err = [], 0

    def rtc_shade_pass(self, *args):
        self.calls.append(("shade", args))
        return self.err

    def rtc_pass_rays(self, *args):
        self.calls.append(("rays", args))
        return self.err


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(sk, "_stream", lambda device: 1234)
    return lib


def test_shade_pass_launcher_passes_the_tensors_and_counts(fake_lib):
    """``_launch_pass`` (mocked library and stream, CPU tensors): bounce
    0 without state pointers, a middle bounce with them and bounce ``i``'s
    raw draws, the last bounce with the film's planes and no outputs; the
    sizes and flags; one ``shade_bounce`` count a launch; a failing launch
    raises and is not counted; misplaced state or film, a compensated or
    float64 film, wrong draws and an input that requires grad are refused
    before the launch."""
    arrays, _, cam = mesh(width=8, height=6, recursion=4)
    seen, _, raw = _bounces(arrays, cam, 1)
    matf = integrator._material_matrix(arrays.materials)
    amb, air = arrays.ambient_rgb, arrays.air_refractive_index
    R, N = 48, matf.shape[0]
    before = sk.shade_bounce.launches

    def launch(i, state="auto", film=None, renorm=False, **kw):
        hit, st, d, _ = seen[i]
        args = dict(hit=hit, state=st if state == "auto" else state, d=d,
                    raw=raw, matf=matf, ambient=amb, air=air, i=i,
                    recursion=4, ambient_is_miss=False, film=film,
                    renorm=renorm)
        args.update(kw)
        return sk._launch_pass(**args)

    out0 = launch(0, state=None)
    hit, _, d, _ = seen[0]
    (kind, args), = fake_lib.calls
    assert kind == "shade" and len(args) == 33 + 7 + 1
    assert args[:6] == (hit.prim.data_ptr(), hit.t.data_ptr(),
                        hit.position.data_ptr(), hit.normal.data_ptr(),
                        hit.inside.data_ptr(), d.data_ptr())
    assert args[6:15] == (None,) * 9
    assert args[15] == raw.data_ptr()
    assert args[16] == matf.data_ptr()
    assert args[19:30] == tuple(t.data_ptr() for t in flat(out0))
    assert args[30:33] == (None,) * 3
    assert args[33:] == (R, N, 0, 5, 4, 0, 0, 1234)

    fake_lib.calls.clear()
    hit, st, d, _ = seen[2]
    out2 = launch(2, renorm=True)
    (_, args), = fake_lib.calls
    assert args[6:15] == tuple(t.data_ptr() for t in flat(st)[2:])
    assert args[15] == raw[2].data_ptr()
    assert args[19] == out2.ray_o.data_ptr()
    assert args[33:] == (R, N, 2, 5, 4, 0, 1, 1234)

    fake_lib.calls.clear()
    film = Film.create(6, 8, device="cpu")
    assert launch(4, film=film) is None
    (_, args), = fake_lib.calls
    assert args[19:30] == (None,) * 11
    assert args[30:33] == tuple(t.data_ptr() for t in film.tensors())
    assert sk.shade_bounce.launches == before + 3

    fake_lib.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        launch(1)
    fake_lib.err = 0
    bad = [dict(i=0), dict(i=1, state=None), dict(i=2, film=film),
           dict(i=4),
           dict(i=4, film=Film.create(6, 8, device="cpu", compensated=True)),
           dict(i=4, film=Film.create(6, 8, device="cpu", dtype=F64)),
           dict(i=4, film=Film.create(6, 7, device="cpu")),
           dict(i=1, raw=raw[:, :, :-1]), dict(i=1, raw=raw.double()),
           dict(i=1, matf=matf.clone().requires_grad_(True)),
           dict(i=5)]
    for kw in bad:
        i = kw.pop("i")
        if i == 0:
            kw["state"] = seen[0][1]
        elif i == 5:
            i, kw["recursion"] = 4, 3
        with pytest.raises(ValueError):
            launch(i, **kw)
    assert sk.shade_bounce.launches == before + 3


def test_pass_rays_launcher_passes_the_tensors_and_counts(fake_lib):
    """``_launch_rays`` (mocked library and stream, CPU tensors): the
    jitter, the camera's 11 tensors by pointer, fresh outputs, the sizes
    and mode; one ``pass_rays`` count a launch; a failing launch raises
    and is not counted; rays that do not fill the rows, a float64 jitter
    and a jitter that requires grad are refused before the launch."""
    _, _, cam = mesh(width=8, height=6)
    jitter = torch.rand((48, 4))
    before = sk.pass_rays.launches
    ray_o, ray_d = sk._launch_rays(cam, jitter, 8)
    (kind, args), = fake_lib.calls
    assert kind == "rays" and len(args) == 4 + 3 + 1
    assert args[0] == jitter.data_ptr()
    assert list(args[1]) == [getattr(cam, f).data_ptr()
                             for f in sk.CAMERA_FIELDS]
    assert args[2:4] == (ray_o.data_ptr(), ray_d.data_ptr())
    assert ray_o.shape == ray_d.shape == (48, 3)
    assert args[4:] == (48, 8, cam.mode, 1234)
    assert sk.pass_rays.launches == before + 1
    fake_lib.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        sk._launch_rays(cam, jitter, 8)
    fake_lib.err = 0
    with pytest.raises(ValueError, match="rows"):
        sk.pass_rays(cam, jitter, 7)
    with pytest.raises(ValueError, match="dtype"):
        sk._launch_rays(cam, jitter.double(), 8)
    with pytest.raises(ValueError, match="requires grad"):
        sk._launch_rays(cam, jitter.clone().requires_grad_(True), 8)
    assert sk.pass_rays.launches == before + 1


def test_trace_pass_refuses_debug_geom():
    arrays, _, cam = mesh(width=8, height=6, recursion=2)
    jitter, raw = draws(0, 0, arrays, "cpu")
    with pytest.raises(ValueError, match="debug geom"):
        integrator.trace_pass(dataclasses.replace(arrays, debug_geom=True),
                              cam, Film.create(6, 8, device="cpu"), jitter,
                              raw, closest_hit_fused)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the camera and shading kernels "
                    "are CUDA C++ for sm_90a and have no CPU mode")
    return torch.device("cuda")


def widest_gap(a: Film, b: Film) -> str:
    """The planes that differ and their widest gap, for a message."""
    out = []
    for name, x, y in zip(("color_sum", "samples", "misses"), a.tensors(),
                          b.tensors()):
        if not torch.equal(x, y):
            gap = (x.double() - y.double()).abs()
            out.append(f"{name}: {int((gap > 0).sum())} differ, widest "
                       f"{float(gap.max()):.3e}")
    return "; ".join(out) or "equal"


@pytest.mark.cuda
@pytest.mark.parametrize("camera", CAMERAS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("route", ["dense", "bvh"])
def test_trace_pass_equals_the_chain_on_card(card, route, seed, camera):
    """3 glue-free passes against 3 passes of the chain on the same draws
    (mesh-722, 96x64, recursion 10, on the dense route and the BVH route):
    films bit-equal; one start launch a pass, one shading launch a
    bounce."""
    arrays, _, cam = mesh(3, 96, 64, 10, camera, device=card)
    closest_fn = route_fn(arrays, route)
    want = chain_passes(arrays, cam, Film.create(64, 96, device=card), seed,
                        3, closest_fn)
    got = Film.create(64, 96, device=card)
    before = sk.pass_rays.launches, sk.shade_bounce.launches
    for k in range(3):
        jitter, raw = draws(seed, k, arrays, card)
        integrator.trace_pass(arrays, cam, got, jitter, raw, closest_fn)
    torch.cuda.synchronize()
    assert (sk.pass_rays.launches - before[0],
            sk.shade_bounce.launches - before[1]) == (3, 33)
    assert films_equal(got, want), widest_gap(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["dense", "bvh"])
def test_trace_pass_on_shiny_rows_equals_the_chain_on_card(card, route):
    """As above with mirrors of infinite shininess among the rows, which
    the kernel reads as infinite from ``material_rows`` and the chain as
    the f32 maximum from ``_material_matrix``."""
    arrays, _, cam = mesh(3, 96, 64, 10, device=card)
    arrays = shiny(arrays)
    closest_fn = route_fn(arrays, route)
    want = chain_passes(arrays, cam, Film.create(64, 96, device=card), 3,
                        3, closest_fn)
    got = Film.create(64, 96, device=card)
    for k in range(3):
        jitter, raw = draws(3, k, arrays, card)
        integrator.trace_pass(arrays, cam, got, jitter, raw, closest_fn)
    assert films_equal(got, want), widest_gap(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["dense", "bvh"])
def test_graphed_and_eager_renderers_take_it_on_card(card, route):
    """A graphed and an eager ``Renderer`` on the ``trace`` route take the
    glue-free pass (a ``pass_rays`` launch a pass, a shading launch a
    bounce, no megakernel), and their films after 3 passes are bit-equal
    to each other and to the chain's."""
    arrays, host_cam, cam = mesh(3, 96, 64, 10, device=card)
    films = []
    for graphs in (True, False):
        r = rmod.Renderer(arrays, device=card, seed=3, cameras=[host_cam],
                          accelerator="bvh" if route == "bvh" else "auto",
                          graphs=graphs)
        assert r.route == ("bvh" if route == "bvh" else "trace")
        r.step(1)  # a graphed renderer captures here
        torch.cuda.synchronize()
        before = (sk.pass_rays.launches, sk.shade_bounce.launches,
                  fused.trace_pass.launches)
        r.step(2)
        torch.cuda.synchronize()
        assert (sk.pass_rays.launches - before[0],
                sk.shade_bounce.launches - before[1],
                fused.trace_pass.launches - before[2]) == (2, 22, 0)
        films.append(r.film)
        closest_fn = r.closest_fn
    want = chain_passes(arrays, cam, Film.create(64, 96, device=card), 3, 3,
                        closest_fn)
    assert films_equal(films[0], films[1]), widest_gap(*films)
    assert films_equal(films[0], want), widest_gap(films[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize("camera", CAMERAS)
def test_camera_kernel_equals_its_plain_version_on_card(card, camera):
    """``pass_rays`` on the card is bit-equal to ``camera_rays`` with the
    direction normalized, run by torch on the card."""
    arrays, _, cam = mesh(3, 96, 64, 10, camera, device=card)
    jitter, _ = draws(5, 0, arrays, card)
    ray_o, ray_d = sk.pass_rays(cam, jitter, 96)
    px, py = rmod.cam_mod.pixel_grid(96, 64, device=card)
    want_o, want_d = rmod.cam_mod.camera_rays(cam, px, py, jitter)
    assert bits_equal(ray_o, want_o.contiguous())
    assert bits_equal(ray_d, vm.normalize(want_d))


@pytest.mark.cuda
def test_shading_forms_equal_their_plain_versions_on_card(card):
    """Every bounce of a mesh-722 pass (the select kernel's hits; mirrors
    of infinite shininess among the rows): the pass form on
    ``material_rows`` bit-equal to ``shade_bounce_reference`` on the
    channels of ``preprocess_uniforms`` and ``_material_matrix`` (the next
    direction normalized where it renormalizes, the film added at the last
    bounce), and the ``[7, R]`` forms, tape and records off and on,
    bit-equal to it as before."""
    arrays, _, cam = mesh(3, 96, 64, 10, device=card)
    arrays = shiny(arrays)
    jitter, raw = draws(13, 0, arrays, card)
    u = preprocess_uniforms(raw)
    px, py = rmod.cam_mod.pixel_grid(96, 64, device=card)
    ray_o, ray_d = rmod.cam_mod.camera_rays(cam, px, py, jitter)
    seen = []

    def spy(hit, state, d, ui, *rest):
        seen.append((hit, state, d, ui, rest[3]))
        return shade_bounce_reference(hit, state, d, ui, *rest)
    with torch.no_grad():
        integrator.trace(arrays, ray_o.contiguous(), ray_d.contiguous(),
                         None, closest_fn=closest_hit_fused, uniforms=u,
                         shade_fn=spy)
    matf = integrator._material_matrix(arrays.materials)
    amb, air = arrays.ambient_rgb, arrays.air_refractive_index
    R, B = 96 * 64, 11
    for hit, state, d, ui, i in seen:
        common = (matf, amb, air, i, 10, arrays.ambient_is_miss)
        want = shade_bounce_reference(hit, state, d, ui, *common)
        for extras in (False, True):
            res = []
            for fn in (sk.shade_bounce, shade_bounce_reference):
                tape = integrator.PathTape.create(R, B, F32, card)
                rec = integrator.BounceRecords.create(R, B, F32, card)
                out = fn(hit, state, d, ui, *common,
                         tape if extras else None, rec if extras else None)
                res.append(flat(out) + flat(tape) + flat(rec))
            for a, b in zip(*res):
                assert bits_equal(a, b), (i, extras)
        last = i == 10
        film = Film.create(64, 96, device=card) if last else None
        got = sk.shade_bounce_pass(hit, None if i == 0 else state, d, raw,
                                   arrays.material_rows, *common[1:],
                                   film=film, renorm=(i + 1) % 3 == 0)
        if last:
            ref = Film.create(64, 96, device=card).add_full_frame_(
                want.result, want.miss)
            assert films_equal(film, ref), widest_gap(film, ref)
            continue
        if (i + 1) % 3 == 0:
            want = dataclasses.replace(want, ray_d=vm.normalize(want.ray_d))
        if i == 0:
            start = PathState.start(ray_o, d)
            assert bits_equal(start.prev.prim, state.prev.prim)
        for a, b in zip(flat(got), flat(want)):
            assert bits_equal(a, b), i
