"""``Renderer.image``'s two routes (``render/tonemap_kernel.py``): a film
of CUDA float32 planes is tonemapped and packed by one launch of
``csrc/tonemap.cu`` into pinned host memory; every other film keeps the
chain ``Film.to_uint8`` (``core/color.py``), the kernel's plain version.

CPU tests: the routing rule; CPU films (float32 and float64, compensated
or not) take the chain, whose images are the chain's as before, and count
no launch; the launcher's arguments, refusals and count with the library
mocked; successive images of a CPU ``Renderer`` are arrays of their own.
Tests marked ``cuda`` hold the kernel to the chain bit for bit and skip
without a card; this file imports no JAX, so on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_tonemap.py``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from raytracercore_tpu_torch import kernels
from raytracercore_tpu_torch.parallel.worker import CORNELL_SCENE
from raytracercore_tpu_torch.render import tonemap_kernel as tk
from raytracercore_tpu_torch.render.film import Film
from raytracercore_tpu_torch.render.renderer import Renderer
from raytracercore_tpu_torch.scene import loader

F32 = torch.float32
BACKGROUND = (0.2, 0.45, 0.9)


def _cornell(size=(12, 10), recursion=3):
    host = loader.parse(CORNELL_SCENE)
    host.width, host.height = size
    host.recursion = recursion
    return host


def _film(h, w, seed, compensated=False, device="cpu", dtype=F32):
    """A film of every kind of pixel: untouched (no sample, no miss), all
    missed, hit only, partly missed; colour sums from dark to far above
    1 a sample, a small compensation term where ``compensated``."""
    g = np.random.default_rng(seed)
    n = h * w
    kind = g.integers(0, 4, n)
    samples = g.integers(1, 300, n).astype(np.float64)
    misses = g.integers(1, 80, n).astype(np.float64)
    samples[kind <= 1] = 0
    misses[(kind == 0) | (kind == 2)] = 0
    per_sample = g.gamma(0.5, 0.8, (n, 3)) * g.choice([0.01, 1.0, 30.0],
                                                      (n, 1))
    color_sum = per_sample * samples[:, None]

    def t(a, *shape):
        return torch.tensor(a.reshape(shape), dtype=dtype, device=device)
    cc = (t(g.normal(0, 1e-3, (n, 3)) * (samples[:, None] > 0), h, w, 3)
          if compensated else None)
    return Film(color_sum=t(color_sum, h, w, 3), samples=t(samples, h, w),
                misses=t(misses, h, w), color_c=cc)


def _background(alpha, device="cpu", dtype=F32):
    return (torch.tensor(BACKGROUND, dtype=dtype, device=device),
            torch.tensor(alpha, dtype=dtype, device=device))


def _plane(device, dtype):
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("device,dtypes,want", [
    ("cuda", (F32,) * 3, True),
    ("cuda", (F32,) * 4, True),                      # compensated
    ("cuda", (torch.float64,) * 3, False),
    ("cuda", (F32, F32, torch.float64), False),
    ("cpu", (F32,) * 3, False),
    ("cpu", (F32,) * 4, False),
    ("meta", (F32,) * 3, False)])
def test_takes_films_of_cuda_float32_planes(device, dtypes, want):
    planes = [_plane(device, dt) for dt in dtypes]
    film = SimpleNamespace(color_sum=planes[0],
                           tensors=lambda: tuple(planes))
    assert tk.takes(film) is want


@pytest.mark.parametrize("dtype", [F32, torch.float64])
@pytest.mark.parametrize("compensated", [False, True])
def test_cpu_films_take_the_chain(monkeypatch, dtype, compensated):
    """A CPU ``Renderer``'s image is the chain's (``Film.to_uint8`` and a
    copy, as before), at exposure 1 and 1.5; the kernel library is never
    loaded and ``tonemap_pack.launches`` does not move."""
    def no_library():
        raise AssertionError("the chain loads no kernel library")
    monkeypatch.setattr(kernels, "load", no_library)
    launches = tk.tonemap_pack.launches
    r = Renderer(_cornell(), device="cpu", seed=3, dtype=dtype,
                 compensated=compensated)
    r.step(3)
    s = r.arrays
    for exposure in (1.0, 1.5):
        got = r.image(exposure)
        want = r.film.to_uint8(s.background_rgb, s.background_alpha,
                               exposure).numpy()
        assert got.dtype == np.uint8 and got.shape == (10, 12, 4)
        np.testing.assert_array_equal(got, want)
    assert got[..., :3].max() > 0
    assert tk.tonemap_pack.launches == launches


class _FakeLib:
    """Stands in for the kernel library, the stream and the pinned
    allocator: records each launch's arguments (returning ``err``), each
    synchronize, and whether each output was asked for pinned."""

    def __init__(self, err=0):
        self.err, self.calls, self.syncs, self.pinned = err, [], [], []

    def rtc_tonemap_pack(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def fake(monkeypatch):
    """The library, stream and pinned allocation mocked, and CPU films
    taken, so that the packer runs on CPU tensors up to the launch."""
    lib = _FakeLib()
    empty = torch.empty

    def host_empty(*args, pin_memory=False, **kwargs):
        lib.pinned.append(pin_memory)
        return empty(*args, **kwargs)
    stream = SimpleNamespace(cuda_stream=1234,
                             synchronize=lambda: lib.syncs.append(1234))
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(tk, "_stream", lambda device: stream)
    monkeypatch.setattr(tk, "takes", lambda film: True)
    monkeypatch.setattr(tk.torch, "empty", host_empty)
    return lib


@pytest.mark.parametrize("compensated", [False, True])
def test_packer_passes_the_tensors_and_counts(fake, compensated):
    """A :class:`Packer` (library and stream mocked, CPU tensors): the
    planes' pointers in the C order, the compensation's or null, the
    background's, the output's; the pixel count, the exposure, the stream;
    one count a launch; a fresh pinned uint8 output a call, returned; the
    synchronize on the same stream."""
    film = _film(5, 6, seed=2, compensated=compensated)
    bg, ba = _background(0.0)
    before = tk.tonemap_pack.launches
    packer = tk.Packer(film, bg, ba)
    assert packer.film is film and packer.shape == (5, 6, 4)
    outs = [packer(1.5), packer(1.0)]
    assert tk.tonemap_pack.launches == before + 2
    assert fake.pinned == [True, True]
    assert all(o.dtype == torch.uint8 and o.shape == (5, 6, 4)
               for o in outs)
    assert len(fake.calls[0]) == len(kernels.SIGNATURES["rtc_tonemap_pack"])
    cc = film.color_c.data_ptr() if compensated else None
    ptrs = (film.color_sum.data_ptr(), film.samples.data_ptr(),
            film.misses.data_ptr(), cc, bg.data_ptr(), ba.data_ptr())
    assert fake.calls == [ptrs + (o.data_ptr(), 30, e, 1234)
                          for o, e in zip(outs, (1.5, 1.0))]
    packer.synchronize()
    assert fake.syncs == [1234]


def test_packer_refuses_wrong_shapes_and_dtypes(fake, monkeypatch):
    """Every tensor the kernel reads through a raw pointer is checked
    before a launch: dtype, shape, layout; a failing launch raises and is
    not counted; a film the kernel does not take is refused."""
    film = _film(5, 6, seed=3)
    bg, ba = _background(0.5)
    before = tk.tonemap_pack.launches
    bad = [
        (Film(film.color_sum, film.samples.double(), film.misses), bg, ba,
         "film.samples: dtype"),
        (Film(film.color_sum[..., :2].contiguous(), film.samples,
              film.misses), bg, ba, "film.color_sum: shape"),
        (Film(film.color_sum, film.samples, film.misses[:4]), bg, ba,
         "film.misses: shape"),
        (Film(film.color_sum, film.samples, film.misses,
              film.color_sum.double()), bg, ba, "film.color_c: dtype"),
        (Film(film.color_sum.transpose(0, 1).contiguous().transpose(0, 1),
              film.samples, film.misses), bg, ba,
         "film.color_sum: not contiguous"),
        (film, bg[:2], ba, "background_rgb: shape"),
        (film, bg, ba.reshape(1), "background_alpha: shape"),
        (film, bg.double(), ba, "background_rgb: dtype")]
    for f, b, a, match in bad:
        with pytest.raises(ValueError, match=match):
            tk.Packer(f, b, a)
    assert not fake.calls
    packer = tk.Packer(film, bg, ba)
    fake.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        packer(1.0)
    assert len(fake.calls) == 1
    assert tk.tonemap_pack.launches == before
    monkeypatch.undo()
    for dtype in (F32, torch.float64):
        with pytest.raises(ValueError, match="CUDA float32"):
            tk.Packer(_film(5, 6, seed=3, dtype=dtype),
                      *_background(0.5, dtype=dtype))


def test_successive_images_are_arrays_of_their_own():
    """An image kept from one frame stays as it was while the renderer
    goes on: each ``image()`` is a new array."""
    r = Renderer(_cornell(), device="cpu", seed=5)
    r.step(1)
    first = r.image()
    kept = first.copy()
    for _ in range(3):
        r.step(1)
        later = r.image()
        assert not np.shares_memory(first, later)
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(first, later)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tonemap kernel is CUDA C++ "
                    "for sm_90a and has no CPU mode")
    return torch.device("cuda")


def _chain(film, bg, ba, exposure):
    return film.to_uint8(bg, ba, exposure).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(512, 512), (700, 700), (37, 53)],
                         ids=["512", "700", "37x53"])
@pytest.mark.parametrize("compensated", [False, True])
def test_kernel_bit_equal_to_the_chain_on_card(cuda_device, size,
                                               compensated):
    """The kernel's image against ``Film.to_uint8`` on the card: 0
    differing bytes on films with untouched, all-missed, hit-only and
    partly missed pixels, at exposure 1 and 1.5 and background alpha 0
    and 0.5."""
    h, w = size
    film = _film(h, w, seed=h + compensated, compensated=compensated,
                 device=cuda_device)
    for alpha in (0.0, 0.5):
        bg, ba = _background(alpha, cuda_device)
        for exposure in (1.0, 1.5):
            want = _chain(film, bg, ba, exposure)
            got = tk.Packer(film, bg, ba)(exposure)
            torch.cuda.synchronize()
            assert int((got.numpy() != want).sum()) == 0, (alpha, exposure)


@pytest.mark.cuda
def test_kernel_packs_every_unit_float_like_the_chain_on_card(cuda_device):
    """Every float32 from 0 to 1 (and 2^20 above it) as a colour sum of
    one hit sample: the gamma (``powf`` against ``torch.pow``) and the
    pack, byte for byte, in chunks of 2^24 pixels."""
    top = int(np.float32(1.0).view(np.int32)) + (1 << 20)
    top += -top % 3
    bg, ba = _background(0.0, cuda_device)
    chunk = 3 << 24
    for start in range(0, top, chunk):
        v = torch.arange(start, min(start + chunk, top), dtype=torch.int32,
                         device=cuda_device).view(F32)
        n = v.numel() // 3
        film = Film(color_sum=v.reshape(n, 1, 3),
                    samples=torch.ones((n, 1), device=cuda_device),
                    misses=torch.zeros((n, 1), device=cuda_device))
        want = film.to_uint8(bg, ba, 1.0).cpu().numpy()
        got = tk.Packer(film, bg, ba)(1.0)
        torch.cuda.synchronize()
        bad = np.flatnonzero((got.numpy() != want).any(axis=-1))
        assert bad.size == 0, v.reshape(n, 3)[torch.as_tensor(
            bad[:8], device=cuda_device)]


def _view(device, size=(64, 48)):
    return Renderer(_cornell(size, 4), device=device, seed=7)


class _Ops(TorchDispatchMode):
    """The aten ops dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_image_counts_one_launch_and_equals_the_chain_on_card(cuda_device):
    """A graphed ``Renderer``'s ``image()``: one ``tonemap_pack`` launch a
    call and no aten op but the pinned tensor's allocation and a view,
    bit-equal to the chain on its film; one packer while the film stays
    the same object, another after ``reset``; a float64 film takes the
    chain and counts none."""
    r = _view(cuda_device)
    assert r.graphs
    r.step(4)
    s = r.arrays
    before = tk.tonemap_pack.launches
    for exposure in (1.0, 1.5, 1.0):
        with _Ops() as ops:
            got = r.image(exposure)
        # The pinned tensor's allocation (film.tonemap) and numpy's
        # detach, a view (film.to_host): no kernel but the tonemap's.
        assert ops.names == ["aten.empty.memory_format",
                             "aten.detach.default"]
        np.testing.assert_array_equal(
            got, _chain(r.film, s.background_rgb, s.background_alpha,
                        exposure))
    assert tk.tonemap_pack.launches == before + 3
    packer = r._packer[1]
    r.step(1)
    r.image()
    assert r._packer[1] is packer
    r.reset()
    r.step(1)
    r.image()
    assert r._packer[1] is not packer
    r64 = Renderer(_cornell((64, 48), 4), device=cuda_device, seed=7,
                   dtype=torch.float64)
    assert r64.image().shape == (48, 64, 4)
    assert tk.tonemap_pack.launches == before + 5


@pytest.mark.cuda
def test_kept_image_unchanged_after_graphed_frames_on_card(cuda_device):
    """An array kept from frame 1 is unchanged after eight more graphed
    frames: the pinned blocks of later images are others."""
    r = _view(cuda_device)
    r.step(1)
    first = r.image()
    kept = first.copy()
    for _ in range(8):
        r.step(1)
        later = r.image()
        assert not np.shares_memory(first, later)
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(first, later)
