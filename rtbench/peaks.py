"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time a piece of work
could take on it."""

PEAK_FP32 = 67e12    # float32 operations per second outside tensor cores
PEAK_BYTES = 3.35e12  # bytes per second of device memory


def bound_ms(ops: float, n_bytes: float) -> float:
    """The larger of ``ops / PEAK_FP32`` and ``n_bytes / PEAK_BYTES``, in
    milliseconds."""
    return max(ops / PEAK_FP32, n_bytes / PEAK_BYTES) * 1e3
