"""Issue-rate probe of the card (counterpart of the Pallas microbenchmark
``scripts/vpu_issue_bench.py``): independent fp32 register chains built as
the port's kernels are (``-fmad=false``, correctly rounded ``/`` and
``sqrtf``), one mix of operations at a time.

* :func:`issue_probe` is the wrapper: on CUDA tensors it launches
  ``csrc/issue_probe.cu`` (counted in ``issue_probe.launches``); on CPU
  tensors it runs :func:`probe_reference`, the same chains in torch.
* :func:`probe_rate` times the kernel on the card and returns operations
  per second in the convention of the kernels' bounds (``chip_smoke.py``:
  every fp32 multiply, add, compare, select, division, sqrt and exp is
  one operation).

The megakernel's mix (``MIXES["megakernel"]``) is counted from
``csrc/fused.cu`` and ``csrc/kernel_body.cuh`` for the Cornell scene of
``chip_smoke.py`` (20 triangle rows, 3 spheres, 1 plane): per bounce
about 430 multiplies, 250 adds, 90 compares and selects, 11 divisions, 6
square roots and one exp.  Its group is those counts, one bounce, so that
the rare slow operations keep their share.

Run on a card: ``python -m raytracercore_tpu_torch.tools.issue_probe``.
"""

from __future__ import annotations

import json

import torch

from ..core.device import DEFAULT_DEVICE, resolve_device

NS = 8       # independent chains per thread (csrc/issue_probe.cu PROBE_NS)
UNROLL = 4   # groups per trip (PROBE_UNROLL)
THREADS = 256
# Mixes in the kernel's order: entries per group of mul, add, cmpsel, div,
# sqrt, exp (csrc/issue_probe.cu MIXES).
MIXES = {
    "mul": (8, 0, 0, 0, 0, 0),
    "add": (0, 8, 0, 0, 0, 0),
    "cmpsel": (0, 0, 8, 0, 0, 0),
    "div": (0, 0, 0, 8, 0, 0),
    "sqrt": (0, 0, 0, 0, 8, 0),
    "exp": (0, 0, 0, 0, 0, 8),
    "megakernel": (430, 250, 90, 11, 6, 1),
}
# Operations per entry in the bounds' convention.
OPS_PER_ENTRY = (1, 1, 2, 3, 3, 2)


def probe_inputs(n: int, seed: int = 0, device=DEFAULT_DEVICE):
    """``[3, NS, n]`` f32 chain starts (0.1-0.9), multipliers (1 - 1e-7 to
    1 - 1e-6, so 10^5 products stay near 1) and addends (1e-5 to 1e-4)."""
    device = resolve_device(device, "probe_inputs")
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((3, NS, n), generator=gen, dtype=torch.float32)
    abc = torch.stack([0.1 + 0.8 * u[0], 1.0 - (1e-7 + 9e-7 * u[1]),
                       1e-5 + 9e-5 * u[2]]).to(torch.float32)
    return abc.to(device).contiguous()


def _group(a, b, c, counts):
    """One group of a mix on the chain list ``a`` (in place), entry j on
    chain j % NS, in the kernel's order."""
    mul, add, cmpsel, div, sqrt, exp = counts
    j = 0
    for _ in range(mul):
        a[j % NS] = a[j % NS] * b[j % NS]
        j += 1
    for k in range(add):
        s = j % NS
        a[s] = a[s] - c[s] if k & 1 else a[s] + c[s]
        j += 1
    for _ in range(cmpsel):
        s = j % NS
        a[s] = torch.where(a[s] > b[s], c[s], a[s])
        j += 1
    for _ in range(div):
        s = j % NS
        a[s] = 1.0 / (a[s] * a[s] + 1.5)
        j += 1
    for _ in range(sqrt):
        s = j % NS
        a[s] = torch.sqrt(a[s] * 0.5 + 0.25)
        j += 1
    for _ in range(exp):
        s = j % NS
        a[s] = torch.exp(a[s] * -0.25)
        j += 1


def probe_reference(abc, mix: str, iters: int):
    """Plain torch version of the kernel: ``[NS, n]`` chain ends."""
    a = [abc[0, s].clone() for s in range(NS)]
    b = [abc[1, s] for s in range(NS)]
    c = [abc[2, s] for s in range(NS)]
    for _ in range(iters * UNROLL):
        _group(a, b, c, MIXES[mix])
    return torch.stack(a)


def issue_probe(abc, mix: str, iters: int):
    """Chain ends ``[NS, n]`` of ``iters`` trips of mix ``mix`` from the
    starts ``abc`` (:func:`probe_inputs`).

    On CUDA tensors this launches ``csrc/issue_probe.cu`` and raises if it
    cannot; on CPU tensors it runs :func:`probe_reference`."""
    if abc.device.type == "cpu":
        return probe_reference(abc, mix, iters)
    if abc.device.type != "cuda":
        raise ValueError(f"issue_probe: unsupported device {abc.device}")
    from .. import kernels

    n = abc.shape[2]
    kernels.check_tensor("abc", abc, (3, NS, n), torch.float32, abc.device)
    out = torch.empty((NS, n), dtype=torch.float32, device=abc.device)
    err = kernels.load().rtc_issue_probe(
        abc.data_ptr(), out.data_ptr(), n, iters, list(MIXES).index(mix),
        torch.cuda.current_stream(abc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"issue probe kernel launch failed: CUDA error "
                           f"{err}")
    kernels.count_launch(issue_probe)
    return out


# Kernel launches made by issue_probe.
issue_probe.launches = 0


def ops_per_thread(mix: str, iters: int) -> int:
    """Operations one thread of the kernel does, in the bounds'
    convention."""
    per_group = sum(k * o for k, o in zip(MIXES[mix], OPS_PER_ENTRY))
    return iters * UNROLL * per_group


def probe_rate(mix: str, n: int, iters: int, reps: int = 5):
    """``(operations per second, ms per launch)`` of mix ``mix`` on the
    current card: ``reps`` launches between CUDA events after one warm-up
    launch."""
    abc = probe_inputs(n, device="cuda")
    issue_probe(abc, mix, iters)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        issue_probe(abc, mix, iters)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    return n * ops_per_thread(mix, iters) / (ms * 1e-3), ms


def main():
    if not torch.cuda.is_available():
        raise SystemExit("issue_probe: no CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = sms * 8 * THREADS
    rates = {mix: probe_rate(mix, n, 2048)[0] for mix in MIXES}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ops_per_sec": rates}))


if __name__ == "__main__":
    main()
