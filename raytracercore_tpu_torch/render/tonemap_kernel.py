"""A viewer frame's tonemap and pack as one CUDA kernel
(``csrc/tonemap.cu``): the counterpart of the XLA fusion the JAX package
compiles ``Film.to_uint8`` into (``raytracercore_tpu/render/renderer.py``
``Renderer.image``).

:meth:`.renderer.Renderer.image` routes by what :func:`takes` observes in
the film: CUDA tensors and float32 planes, compensated or not, go to the
kernel, which stores the image straight into a fresh pinned host tensor
(counted in ``tonemap_pack.launches``); a CPU or float64 film, and every
other case, keeps the chain :meth:`.film.Film.to_uint8` (``core/color.py``
``tonemap`` and ``to_uint8``), which is the kernel's plain version.  The
kernel is bit-equal to it.

One thread packs one pixel, one ``uchar4`` store each.  Background colour
and alpha are read from device memory, so nothing waits for the device
before the launch.  ``Renderer.step`` ends in a synchronize, so every µs
of host time between it and the image is idle card: a :class:`Packer`
checks the film once and keeps its pointers, and a frame costs an
allocation, the launch and the synchronize.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..kernels import check_tensor as _check
from .film import Film


def takes(film: Film) -> bool:
    """Whether the kernel takes ``film``: its planes are CUDA tensors of
    float32 (a compensated film too)."""
    return film.color_sum.device.type == "cuda" and all(
        t.dtype == torch.float32 for t in film.tensors())


class Packer:
    """The kernel's launch on one film and background, checked once.  The
    film's tensors are read at every call, so the image is that of the
    film as it stands: a graphed ``Renderer`` accumulates frame after frame
    into one film, and keeps one packer for it.

    Raises ``ValueError`` where the kernel does not take the film
    (:func:`takes`), or a tensor's device, dtype, shape or layout is not
    what it reads."""

    def __init__(self, film: Film, background_rgb, background_alpha):
        if not takes(film):
            raise ValueError("tonemap_pack: the kernel takes a film of CUDA "
                             "float32 planes; Film.to_uint8 packs the "
                             "others")
        dev = film.color_sum.device
        f32 = torch.float32
        h, w = film.shape
        for name, t, shape in zip(
                ("color_sum", "samples", "misses", "color_c"),
                film.tensors(), ((h, w, 3), (h, w), (h, w), (h, w, 3))):
            _check(f"film.{name}", t, shape, f32, dev)
        _check("background_rgb", background_rgb, (3,), f32, dev)
        _check("background_alpha", background_alpha, (), f32, dev)
        c = film.color_c
        self.film = film
        self.shape = (h, w, 4)
        # The tensors the pointers point into stay referenced here.
        self._inputs = (background_rgb, background_alpha)
        self._ptrs = (film.color_sum.data_ptr(), film.samples.data_ptr(),
                      film.misses.data_ptr(),
                      None if c is None else c.data_ptr(),
                      background_rgb.data_ptr(), background_alpha.data_ptr())
        self._device = dev

    def __call__(self, exposure: float = 1.0) -> torch.Tensor:
        """One launch on the film device's current stream, counted in
        ``tonemap_pack.launches``: the film's tonemapped RGBA uint8 image
        ``[H, W, 4]``, bit-equal to ``film.to_uint8(background_rgb,
        background_alpha, exposure)``, stored into a fresh pinned host
        tensor (``torch.empty(..., pin_memory=True)``, from PyTorch's
        caching host allocator, which recycles a block only once nothing
        holds it).  Returns that tensor without synchronizing: the image
        is there once the stream has run the launch (:meth:`synchronize`).
        Raises ``RuntimeError`` where the launch fails."""
        out = torch.empty(self.shape, dtype=torch.uint8, pin_memory=True)
        h, w, _ = self.shape
        err = kernels.load().rtc_tonemap_pack(
            *self._ptrs, out.data_ptr(), h * w, float(exposure),
            _stream(self._device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"tonemap kernel launch failed: CUDA error {err}")
        kernels.count_launch(tonemap_pack)
        return out

    def synchronize(self) -> None:
        """Wait until the film device's current stream has run every
        launch on it: the images of the calls before are then whole."""
        _stream(self._device).synchronize()


def _stream(device):
    """``device``'s current CUDA stream."""
    return torch.cuda.current_stream(device)


# Launches of the tonemap kernel: one an image() on the kernel route, none
# on the chain.
tonemap_pack = kernels.LaunchCount("tonemap_pack")
