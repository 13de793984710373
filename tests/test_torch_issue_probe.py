"""The issue-rate probe (counterpart of the Pallas microbenchmark
``scripts/vpu_issue_bench.py``): its plain torch chains against a numpy
recomputation at a small trip count.  The CUDA kernel runs on the card
only (``chip_smoke.py`` holds it against the plain chains there)."""

import numpy as np
import pytest
import torch

from raytracercore_tpu_torch.tools import issue_probe as ip


def numpy_chains(abc, mix, iters):
    """The probe's chains in numpy f32, entry j of a group on chain
    j % NS, in the kernel's order."""
    a = abc[0].copy()
    b, c = abc[1], abc[2]
    mul, add, cmpsel, div, sqrt, exp = ip.MIXES[mix]
    f32 = np.float32
    for _ in range(iters * ip.UNROLL):
        j = 0
        for _ in range(mul):
            s = j % ip.NS
            a[s] = a[s] * b[s]
            j += 1
        for k in range(add):
            s = j % ip.NS
            a[s] = a[s] - c[s] if k & 1 else a[s] + c[s]
            j += 1
        for _ in range(cmpsel):
            s = j % ip.NS
            a[s] = np.where(a[s] > b[s], c[s], a[s])
            j += 1
        for _ in range(div):
            s = j % ip.NS
            a[s] = f32(1.0) / (a[s] * a[s] + f32(1.5))
            j += 1
        for _ in range(sqrt):
            s = j % ip.NS
            a[s] = np.sqrt(a[s] * f32(0.5) + f32(0.25))
            j += 1
        for _ in range(exp):
            s = j % ip.NS
            a[s] = np.exp(a[s] * f32(-0.25))
            j += 1
    return a


@pytest.mark.parametrize("mix", list(ip.MIXES))
def test_plain_chains_match_numpy(mix):
    abc = ip.probe_inputs(96, seed=3, device="cpu")
    got = ip.issue_probe(abc, mix, 3)          # CPU tensor: the plain chains
    want = numpy_chains(abc.numpy(), mix, 3)
    assert got.dtype == torch.float32 and got.shape == (ip.NS, 96)
    assert np.all(np.isfinite(want))
    # mul, add and cmpsel are exact in both; division and sqrt are
    # correctly rounded in both; exp may differ in its last bit.
    if ip.MIXES[mix][5] == 0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=4e-7, atol=0)


def test_inputs_and_operation_count():
    abc = ip.probe_inputs(50, seed=1, device="cpu")
    assert abc.shape == (3, ip.NS, 50) and abc.dtype == torch.float32
    a, b, c = abc
    assert float(a.min()) >= 0.1 and float(a.max()) <= 0.9
    assert float(b.max()) < 1.0 and float(b.min()) >= 1 - 1.1e-6
    assert float(c.min()) >= 1e-5 and float(c.max()) <= 1e-4
    # mul 1, add 1, cmpsel 2, div 3, sqrt 3, exp 2 operations an entry.
    assert ip.ops_per_thread("mul", 10) == 10 * ip.UNROLL * 8
    assert ip.ops_per_thread("div", 1) == ip.UNROLL * 8 * 3
    assert ip.ops_per_thread("megakernel", 1) == ip.UNROLL * (
        430 + 250 + 2 * 90 + 3 * 11 + 3 * 6 + 2 * 1)
