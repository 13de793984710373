"""The megakernel's whole pass (``fused.trace_pass``): which passes take it,
and, on the card, that it equals the chain it replaces bit for bit.

A pass of the megakernel route on a CUDA device, into a float32 film
without compensation and untiled, is the pass's two ``torch.rand`` draws
and one launch that builds the camera rays, computes the uniform channels
and adds the samples into the film.  Every other pass runs the chain
``camera_rays`` → ``preprocess_uniforms`` → ``trace_fused`` →
``Film.add_full_frame_`` (``render_pass_``), the whole pass's plain
version.

CPU tests: a CPU ``Renderer`` on the chain (spans and film), the eager and
graphed pass bodies' dispatch with the kernel replaced by the chain, and
the launcher with the kernel library mocked (which pass takes which form
is ``renderer.pass_form``, tested in ``test_torch_trace_pass.py``).
Tests marked ``cuda`` run the kernel and skip without a card; this file
imports no JAX, so on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_whole_pass.py``.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from raytracercore_tpu_torch import kernels
from raytracercore_tpu_torch.core import spans
from raytracercore_tpu_torch.parallel.worker import CORNELL_SCENE
from raytracercore_tpu_torch.render import camera as cam_mod
from raytracercore_tpu_torch.render import fused
from raytracercore_tpu_torch.render import renderer as rmod
from raytracercore_tpu_torch.render import uniforms_kernel as uk
from raytracercore_tpu_torch.render.film import Film
from raytracercore_tpu_torch.render.integrator import preprocess_uniforms
from raytracercore_tpu_torch.scene import loader
from raytracercore_tpu_torch.scene.types import freeze_scene, init_camera

F32, F64 = torch.float32, torch.float64

# The cameras of the card checks: the scene's frustum camera, an ortho
# camera and the frustum camera with depth of field.
CAMERAS = ("frustum", "ortho", "dof")


def cornell(width=24, height=16, recursion=4, camera="frustum",
            device="cpu"):
    """The Cornell scene at ``width`` x ``height`` (not square, so a
    swapped pixel coordinate shows), its arrays and render-ready camera."""
    host = loader.parse(CORNELL_SCENE)
    host.width, host.height, host.recursion = width, height, recursion
    cam = host.cameras[0]
    if camera == "ortho":
        cam = dataclasses.replace(cam, mode="ortho", fov_or_size=3.0)
    elif camera == "dof":
        cam = dataclasses.replace(cam, image_plane=0.5, dof_amount=3.0,
                                  focal_length=6.5)
    host.cameras = [cam]
    arrays = freeze_scene(host, device=device)
    return host, arrays, init_camera(cam, width, height, device=device)


def chain_passes(arrays, camera, film, seed, passes, start=0):
    """``passes`` passes of the chain on the draws a whole pass takes:
    ``render_pass_`` with ``trace_fused`` on ``preprocess_uniforms(raw)``,
    into ``film`` in place."""
    h, w = film.shape
    for k in range(start, start + passes):
        gen = rmod.pass_generator(seed, k, film.samples.device)
        jitter, raw = rmod.raw_draws(gen, h * w, arrays.recursion + 1)
        rmod.render_pass_(arrays, camera, film, jitter,
                          preprocess_uniforms(raw),
                          trace_fn=fused.trace_fused)
    return film


def films_equal(a: Film, b: Film) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))


def on_the_card(pass_form):
    """``pass_form`` deciding as for a film on a CUDA device."""
    def decide(scene, camera, trace_fn, device, *rest):
        return pass_form(scene, camera, trace_fn, "cuda", *rest)
    return decide


# --- the chain off the card -----------------------------------------------

@pytest.mark.parametrize("compensated", [False, True])
def test_cpu_renderer_runs_the_chain(compensated):
    """A CPU ``Renderer`` on the megakernel route runs today's chain: its
    spans are ``camera_rays``, ``trace_fused`` and ``film_accum`` a pass
    (no ``trace_pass``), and its film after 3 passes is bit-equal to
    ``render_pass_`` on ``pass_draws`` pass by pass."""
    host, arrays, camera = cornell()
    r = rmod.Renderer(host, device="cpu", seed=11, compensated=compensated)
    assert r.route == "megakernel" and r.trace_fn is fused.trace_fused
    launches = fused.trace_fused.launches
    spans.start()
    try:
        r.step(3)
    finally:
        records = spans.stop()
    names = [rec[0] for rec in records]
    for name in ("camera_rays", "trace_fused", "film_accum"):
        assert names.count(name) == 3, (name, names)
    assert "trace_pass" not in names
    assert fused.trace_fused.launches == launches  # the plain version

    want = Film.create(arrays.height, arrays.width, device="cpu",
                       compensated=compensated)
    for k in range(3):
        jitter, uniforms = rmod.pass_draws(11, k, arrays.height
                                           * arrays.width,
                                           arrays.recursion + 1, "cpu")
        rmod.render_pass_(r.arrays, r.camera, want, jitter, uniforms,
                          trace_fn=fused.trace_fused)
    assert films_equal(r.film, want)


def _chain_in_place_of_the_kernel(monkeypatch):
    """Decide each pass's form as for a film on the card and run the
    chain where the kernel would run; returns the list of ``(jitter,
    raw)`` the whole passes were given."""
    calls = []

    def trace_pass(scene, camera, film, jitter, raw):
        calls.append((jitter, raw))
        rmod.render_pass_(scene, camera, film, jitter,
                          preprocess_uniforms(raw),
                          trace_fn=fused.trace_fused)
        return film

    monkeypatch.setattr(rmod, "pass_form", on_the_card(rmod.pass_form))
    monkeypatch.setattr(fused, "trace_pass", trace_pass)
    return calls


def test_render_passes_gives_a_whole_pass_its_draws(monkeypatch):
    """Eager ``render_passes`` on a pass that ``pass_form`` gives the
    megakernel's whole form calls ``trace_pass`` once a pass with the
    pass's float32 draws (jitter ``[R, 4]``, raw ``[B, 5, R]``), in a span
    ``trace_pass``, on a copy of the caller's film; the film is the
    chain's, bit for bit."""
    _, arrays, camera = cornell()
    h, w = arrays.height, arrays.width
    film = Film.create(h, w, device="cpu")
    want = rmod.render_passes(arrays, camera, film, 5, 2, 3,
                              trace_fn=fused.trace_fused, graphs=False)
    calls = _chain_in_place_of_the_kernel(monkeypatch)
    spans.start()
    try:
        render = rmod.render_passes(arrays, camera, film, 5, 2, 3,
                                    trace_fn=fused.trace_fused,
                                    graphs=False)
    finally:
        names = [rec[0] for rec in spans.stop()]
    assert len(calls) == 3 and names.count("trace_pass") == 3
    for jitter, raw in calls:
        assert jitter.shape == (h * w, 4) and jitter.dtype == F32
        assert raw.shape == (arrays.recursion + 1, 5, h * w)
        assert raw.dtype == F32
    assert films_equal(render, want)
    assert not film.samples.any()  # the caller's film is left alone


def test_pass_graph_body_gives_a_whole_pass_its_draws(monkeypatch):
    """The pass graph's body, run eagerly on its generator seeded for pass
    ``k``, gives ``trace_pass`` the draws ``raw_draws`` makes and adds the
    chain's samples into the graph's film."""
    _, arrays, camera = cornell()
    h, w = arrays.height, arrays.width
    calls = _chain_in_place_of_the_kernel(monkeypatch)
    captured = {}

    def capture(body, inputs, **kwargs):
        captured["body"], captured["inputs"] = body, inputs
        return None

    monkeypatch.setattr(rmod.graphs_mod, "capture", capture)
    film = Film.create(h, w, device="cpu")
    pg = rmod.PassGraph(arrays, camera, film, trace_fn=fused.trace_fused)
    pg.generator.manual_seed(rmod.pass_seed(9, 4))
    captured["body"](*captured["inputs"])
    (jitter, raw), = calls
    gen = rmod.pass_generator(9, 4, "cpu")
    want_jitter, want_raw = rmod.raw_draws(gen, h * w, arrays.recursion + 1)
    assert torch.equal(jitter, want_jitter) and torch.equal(raw, want_raw)
    want = chain_passes(arrays, camera, Film.create(h, w, device="cpu"), 9,
                        1, start=4)
    assert films_equal(pg.film, want)


class _FakeLib:
    def __init__(self):
        self.calls, self.err = [], 0

    def rtc_trace_pass(self, *args):
        self.calls.append(args)
        return self.err


def test_pass_launcher_passes_the_tensors_and_counts(monkeypatch):
    """``_launch_pass`` (mocked library and stream, CPU tensors): the
    pointers in the C order, the camera's 11 tensors by pointer, the film
    planes written in place, the sizes and flags; one count a launch; a
    failing launch raises and is not counted; a compensated or float64
    film, a wrong draw shape and a scene the megakernel cannot trace are
    refused before the launch."""
    _, arrays, camera = cornell()
    h, w = arrays.height, arrays.width
    B, R = arrays.recursion + 1, h * w
    film = Film.create(h, w, device="cpu")
    jitter = torch.rand((R, 4))
    raw = torch.rand((B, 5, R))
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(fused, "_stream", lambda device: 1234)
    before = fused.trace_pass.launches
    assert fused._launch_pass(arrays, camera, film, jitter, raw) is film
    assert fused.trace_pass.launches == before + 1
    (args,) = lib.calls
    assert len(args) == 15 + 9 + 2 + 3 + 1
    assert args[:2] == (jitter.data_ptr(), raw.data_ptr())
    assert list(args[2]) == [getattr(camera, f).data_ptr()
                             for f in fused.CAMERA_FIELDS]
    tables = fused.kernel_tables(arrays)
    assert args[3:11] == tuple(t.data_ptr() for t in tables)
    assert args[11:14] == tuple(t.data_ptr() for t in film.tensors())
    assert args[15:24] == (R, w, camera.mode, tables[0].shape[0],
                           tables[2].shape[0], tables[4].shape[0],
                           tables[6].shape[0], B, arrays.recursion)
    assert args[26:] == (int(arrays.ambient_is_miss),
                         int(arrays.any_smooth),
                         int(fused.FUSED_COPLANAR_BRANCH), 1234)
    lib.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fused._launch_pass(arrays, camera, film, jitter, raw)
    bad = [
        (Film.create(h, w, device="cpu", compensated=True), jitter, raw),
        (Film.create(h, w, device="cpu", dtype=F64), jitter, raw),
        (film, jitter[:-1], raw),
        (film, jitter, raw[:-1]),
    ]
    for f, j, u in bad:
        with pytest.raises(ValueError):
            fused._launch_pass(arrays, camera, f, j, u)
    with pytest.raises(ValueError, match="megakernel cannot trace"):
        fused._launch_pass(dataclasses.replace(arrays, debug_geom=True),
                           camera, film, jitter, raw)
    assert fused.trace_pass.launches == before + 1
    with pytest.raises(ValueError, match="CUDA device"):
        fused.trace_pass(arrays, camera, film, jitter, raw)


# --- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the whole-pass kernel is CUDA C++ "
                    "for sm_90a and has no CPU mode")
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
@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
def test_whole_pass_equals_the_chain_on_card(card, seed, camera):
    """3 passes of the whole-pass kernel against 3 passes of the chain on
    the same draws (Cornell 96x64, recursion 10): films bit-equal, one
    ``trace_pass`` launch a pass."""
    _, arrays, cam = cornell(96, 64, 10, camera, device=card)
    h, w = arrays.height, arrays.width
    want = chain_passes(arrays, cam, Film.create(h, w, device=card), seed, 3)
    got = Film.create(h, w, device=card)
    before = fused.trace_pass.launches
    for k in range(3):
        gen = rmod.pass_generator(seed, k, card)
        jitter, raw = rmod.raw_draws(gen, h * w, arrays.recursion + 1)
        fused.trace_pass(arrays, cam, got, jitter, raw)
    torch.cuda.synchronize()
    assert fused.trace_pass.launches == before + 3
    assert films_equal(got, want), widest_gap(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("camera", CAMERAS)
def test_graphed_and_eager_films_equal_on_card(card, camera):
    """A graphed and an eager ``Renderer`` take the whole pass (one
    ``trace_pass`` launch a pass, no ``trace_fused``), and their films
    after 3 passes are bit-equal to each other and to the chain's."""
    host, arrays, cam = cornell(96, 64, 10, camera, device=card)
    films = []
    for graphs in (True, False):
        r = rmod.Renderer(host, device=card, seed=3, graphs=graphs)
        r.step(1)  # a graphed renderer captures here
        passes, fused_launches = (fused.trace_pass.launches,
                                  fused.trace_fused.launches)
        r.step(2)
        assert fused.trace_pass.launches == passes + 2
        assert fused.trace_fused.launches == fused_launches
        films.append(r.film)
    want = chain_passes(arrays, cam, Film.create(arrays.height,
                                                 arrays.width, device=card),
                        3, 3)
    assert films_equal(films[0], films[1]), widest_gap(*films)
    assert films_equal(films[0], want), widest_gap(films[0], want)


@pytest.mark.cuda
def test_tape_on_recorder_unchanged_on_card(card):
    """The train step's tape-on recorder (``trace_fused`` with the tape, on
    the uniforms kernel's channels) keeps its form: its colour and miss
    are bit-equal to the tape-off launch's, and colour, miss and tape
    agree with the plain ``trace_fused_reference`` as the megakernel's
    own card test holds them (no same-pick colour gap, 97 % close)."""
    _, arrays, cam = cornell(96, 64, 10, device=card)
    h, w = arrays.height, arrays.width
    gen = rmod.pass_generator(1, 0, card)
    jitter, _ = rmod.raw_draws(gen, h * w, arrays.recursion + 1)
    px, py = cam_mod.pixel_grid(w, h, device=card)
    ray_o, ray_d = cam_mod.camera_rays(cam, px, py, jitter)
    ray_o, ray_d = ray_o.contiguous(), ray_d.contiguous()
    u = uk.prepare_uniforms_kernel(12345, h * w, arrays.recursion + 1, card)
    color, miss, tape = fused.trace_fused(arrays, ray_o, ray_d, u,
                                          want_tape=True)
    color_off, miss_off = fused.trace_fused(arrays, ray_o, ray_d, u)
    torch.cuda.synchronize()
    assert torch.equal(color, color_off) and torch.equal(miss, miss_off)
    ref = fused.trace_fused_reference(arrays, ray_o, ray_d, u,
                                      want_tape=True)
    cls = fused.classify_mismatches(ref, (color, miss, tape))
    assert (cls["miss_eq"] | cls["flip"]).all()
    assert cls["close"].mean() >= 0.97
    assert not cls["samepick"].any()
