"""The train path's uniforms (``render/uniforms_kernel.py``): Philox4x32-10
written out in torch int64 against the Random123 known-answer vectors, the
stream layout, and the channel distributions against JAX
``prepare_uniforms`` (threefry) by a two-sample Kolmogorov-Smirnov test
per channel.

The streams differ by construction (the TPU kernel's hardware generator
has no counterpart anywhere), so only the distributions are compared: at
2^16 draws per channel, with fixed seeds, D must stay under the
α = 0.001 critical value 1.9495·sqrt(2/2^16) ≈ 0.0108.  The CUDA kernel
has no CPU mode: its case needs a card and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracercore_tpu.render.integrator import prepare_uniforms as jprep
from raytracercore_tpu_torch.render import uniforms_kernel as uk
from test_torch_fused import cuda_device  # noqa: F401

# Random123's known-answer vectors for Philox4x32-10: counter, key, output.
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]

N_KS, B_KS = 1 << 14, 4          # 2^16 draws per channel
KS_CRIT = 1.9495 * np.sqrt(2.0 / (N_KS * B_KS))


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    got = uk.philox4x32(tuple(torch.tensor([c], dtype=torch.int64)
                              for c in ctr), key)
    assert [int(w) for w in got] == list(want)


def test_reference_shape_dtype_and_determinism():
    a = uk.prepare_uniforms_reference(7, 1000, 3)
    assert a.shape == (3, 7, 1000) and a.dtype == torch.float32
    assert torch.equal(a, uk.prepare_uniforms_reference(7, 1000, 3))
    # A longer run is the same stream extended: counters are (path, bounce).
    b = uk.prepare_uniforms_reference(7, 1500, 4)
    assert torch.equal(b[:3, :, :1000], a)
    assert torch.isfinite(a).all()
    assert (a[:, 0] < 0).all()                      # ln U, U < 1
    assert ((a[:, 3] >= 0) & (a[:, 3] < 1)).all()
    assert ((a[:, 4] >= 0) & (a[:, 4] <= 1)).all()
    np.testing.assert_allclose((a[:, 1] ** 2 + a[:, 2] ** 2).numpy(), 1.0,
                               atol=1e-6)


def test_channel_3_is_the_raw_draw():
    """Channel 3 is u2 itself: counter (r, b, 0, 0), word 2, top 24 bits —
    the value the card test compares bit for bit."""
    u = uk.prepare_uniforms_reference(2 ** 40 + 5, 64, 2)
    key = uk.split_seed(2 ** 40 + 5)
    assert key == (5, 256)
    r = torch.arange(64, dtype=torch.int64)
    for b in range(2):
        w = uk.philox4x32((r, torch.full_like(r, b), torch.zeros_like(r),
                           torch.zeros_like(r)), key)[2]
        assert torch.equal(u[b, 3], (w >> 8).to(torch.float32) / 2 ** 24)


def test_streams_differ_by_seed_and_bounce():
    a = uk.prepare_uniforms_reference(1, 4096, 2)[:, 3]
    b = uk.prepare_uniforms_reference(2, 4096, 2)[:, 3]
    c = uk.prepare_uniforms_reference(2 ** 32 + 1, 4096, 2)[:, 3]
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert float((a[0] == a[1]).float().mean()) < 0.01
    assert float((a == b).float().mean()) < 0.01
    # Neighbouring paths are not correlated.
    x = a[0].numpy() - 0.5
    assert abs(np.corrcoef(x[:-1], x[1:])[0, 1]) < 0.05


def _ks(a, b):
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / a.size
    fb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(fa - fb).max())


@pytest.fixture(scope="module")
def both_streams():
    jax_u = np.asarray(jprep(jax.random.PRNGKey(11), N_KS, B_KS,
                             jnp.float32))
    port_u = uk.prepare_uniforms_reference(12345, N_KS, B_KS).numpy()
    return jax_u, port_u


@pytest.mark.parametrize("channel", range(7))
def test_channel_distribution_matches_jax(both_streams, channel):
    jax_u, port_u = both_streams
    d = _ks(jax_u[:, channel].ravel(), port_u[:, channel].ravel())
    assert d < KS_CRIT, f"channel {channel}: KS D = {d:.5f}"


def test_ks_test_has_power():
    """The KS check above would catch a wrong transform: the same draws
    through a wrong channel-4 map (acos without the 2/π) fail it."""
    jax_u = np.asarray(jprep(jax.random.PRNGKey(11), N_KS, 1, jnp.float32))
    port_u = uk.prepare_uniforms_reference(12345, N_KS, 1).numpy()
    wrong = port_u[:, 4] * np.pi / 2 * 0.98
    assert _ks(jax_u[:, 4].ravel(), wrong.ravel()) > 1.9495 * np.sqrt(
        2.0 / N_KS)


def test_kernel_wrapper_on_cpu_runs_the_reference():
    before = uk.prepare_uniforms_kernel.launches
    got = uk.prepare_uniforms_kernel(99, 300, 3, "cpu")
    assert uk.prepare_uniforms_kernel.launches == before
    assert torch.equal(got, uk.prepare_uniforms_reference(99, 300, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        uk.prepare_uniforms_kernel(99, 300, 3, "meta")


def test_uniforms_kernel_matches_reference_on_card(cuda_device):  # noqa: F811
    want = uk.prepare_uniforms_reference(2 ** 63 + 17, 70000, 11,
                                         cuda_device)
    before = uk.prepare_uniforms_kernel.launches
    got = uk.prepare_uniforms_kernel(2 ** 63 + 17, 70000, 11, cuda_device)
    torch.cuda.synchronize()
    assert uk.prepare_uniforms_kernel.launches == before + 1
    assert torch.equal(got[:, 3], want[:, 3])
    ulp = torch.finfo(torch.float32).eps
    torch.testing.assert_close(got, want, rtol=4 * ulp, atol=1e-6)
