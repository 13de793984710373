"""Uniforms for the train path, generated by a kernel (counterpart of
``raytracercore_tpu.render.uniforms_kernel``).

The ``[bounces, 7, n]`` channels of :func:`.integrator.preprocess_uniforms`
are drawn from a counter-based generator, Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC'11), written out by hand
both in the CUDA kernel (``csrc/uniforms.cu``) and in the plain torch
version here, so the two draw the same bits:

* key = the 64-bit seed as (low word, high word);
* counter ``(r, b, 0, 0)`` gives ``u0 … u3`` of path ``r``, bounce ``b``;
  counter ``(r, b, 1, 0)``, word 0, gives ``u4``;
* a word becomes a float in [0, 1) as ``(w >> 8) · 2⁻²⁴`` (the mapping of
  the JAX kernel's ``_bits_to_unit``), then the channel transforms of
  ``preprocess_uniforms`` apply.

The TPU kernel drew from the TPU's hardware generator, whose stream exists
nowhere else; this stream has the same channel distributions (the tests
hold it to JAX ``prepare_uniforms`` with a two-sample KS test).  Like the
JAX package, only the train path uses it: the forward render keeps
``prepare_uniforms`` and its ``torch.Generator``.
"""

from __future__ import annotations

import torch

from .integrator import preprocess_uniforms

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10


def _mulhilo(a: int, b):
    """``(hi, lo)`` 32-bit words of ``a · b`` for a 32-bit constant ``a``
    and an int64 tensor ``b`` of 32-bit words.  The full product needs 64
    unsigned bits, more than int64 holds, so ``b`` is split into 16-bit
    halves and no step relies on signed wraparound."""
    p_lo = a * (b & 0xFFFF)   # < 2^48
    p_hi = a * (b >> 16)      # < 2^48
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(ctr, key):
    """Philox4x32-10 of counter words ``ctr`` (four int64 tensors of
    32-bit values, broadcastable) under ``key = (k0, k1)`` (ints, or
    int64 tensors of 32-bit values)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for rnd in range(PHILOX_ROUNDS):
        if rnd:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def split_seed(seed: int):
    """The Philox key of a 64-bit seed: (low word, high word)."""
    seed = int(seed) & ((1 << 64) - 1)
    return seed & MASK32, seed >> 32


def seed_key(seed: int, device="cpu"):
    """``[2]`` int32: the Philox key of ``seed`` (:func:`split_seed`'s two
    words, as bits), the tensor the kernel reads its key from."""
    return fill_seed_key(torch.empty((2,), dtype=torch.int32,
                                     device=device), seed)


def fill_seed_key(key, seed: int):
    """Write the key of ``seed`` into the ``[2]`` int32 tensor ``key`` in
    place, with one fill on its device and no copy from host memory (so
    that a captured CUDA graph reads the new key at its next replay);
    returns ``key``.  The words are the bits of the seed's 64 unsigned
    bits, low word first, so a seed at or above 2^63 keys the stream
    :func:`split_seed` gives it."""
    seed = int(seed) & ((1 << 64) - 1)
    key.view(torch.int64).fill_(seed - (1 << 64) if seed >> 63 else seed)
    return key


def _key_words(key):
    """The two key words of a :func:`seed_key` tensor as int64 tensors
    holding 32-bit unsigned values (no read to the host)."""
    words = key.to(torch.int64) & MASK32
    return words[0], words[1]


def prepare_uniforms_reference(seed, n: int, bounces: int, device="cpu"):
    """Plain torch version of the kernel: ``[bounces, 7, n]`` f32, keyed by
    ``seed``: an int, or the key tensor the kernel reads
    (:func:`seed_key`, on ``device``)."""
    device = torch.device(device)
    key = (_key_words(seed) if isinstance(seed, torch.Tensor)
           else split_seed(seed))
    r = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    b = torch.arange(bounces, dtype=torch.int64, device=device)[:, None]
    r, b = torch.broadcast_tensors(r, b)
    zero = torch.zeros_like(r)
    w = philox4x32((r, b, zero, zero), key)
    w4 = philox4x32((r, b, torch.ones_like(r), zero), key)[0]
    raw = torch.stack([(x >> 8).to(torch.float32) * 2.0 ** -24
                       for x in (*w, w4)], dim=1)
    return preprocess_uniforms(raw)


def prepare_uniforms_keyed(key, n: int, bounces: int):
    """``[bounces, 7, n]`` f32 uniforms keyed by the ``[2]`` int32 tensor
    ``key`` (:func:`seed_key`), on its device: the form a captured train
    step runs, whose key is filled before each replay.

    On a CUDA device this launches ``csrc/uniforms.cu``, which reads the
    two words from device memory (counted in
    ``prepare_uniforms_kernel.launches``), raising if it cannot; on the
    CPU it runs :func:`prepare_uniforms_reference` on the same tensor."""
    device = key.device
    if device.type == "cpu":
        return prepare_uniforms_reference(key, n, bounces, device)
    if device.type != "cuda":
        raise ValueError(f"prepare_uniforms_keyed: unsupported device "
                         f"{device}")
    from .. import kernels

    kernels.check_tensor("key", key, (2,), torch.int32, device)
    out = torch.empty((bounces, 7, n), dtype=torch.float32, device=device)
    err = kernels.load().rtc_uniforms(
        out.data_ptr(), n, bounces, key.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"uniforms kernel launch failed: CUDA error {err}")
    kernels.count_launch(prepare_uniforms_kernel)
    return out


def prepare_uniforms_kernel(seed: int, n: int, bounces: int, device):
    """``[bounces, 7, n]`` f32 uniforms of the train path for ``seed``.

    On a CUDA device this fills a key tensor (:func:`seed_key`) and
    launches ``csrc/uniforms.cu`` on it (:func:`prepare_uniforms_keyed`;
    counted in ``prepare_uniforms_kernel.launches``), raising if it
    cannot; on the CPU it runs :func:`prepare_uniforms_reference`.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return prepare_uniforms_reference(seed, n, bounces, device)
    if device.type != "cuda":
        raise ValueError(f"prepare_uniforms_kernel: unsupported device "
                         f"{device}")
    return prepare_uniforms_keyed(seed_key(seed, device), n, bounces)


# Kernel launches made by prepare_uniforms_kernel and prepare_uniforms_keyed.
prepare_uniforms_kernel.launches = 0
