"""The end-to-end arithmetic on synthetic timings, and the rooflines' work
counts at the cells' shapes."""

from __future__ import annotations

import json

import pytest

from rtbench import run, stats
from rtbench.peaks import bound_ms

from .conftest import ROOT


def test_rate_is_over_all_of_the_window():
    # 10 frames of 8 passes in a window of 2 s: every pass over every
    # second, however the frames are spread in it.
    assert stats.rate(80, 2.0) == 40.0


def test_p95_is_over_all_frames_not_chunks():
    frames = [0.010] * 95 + [0.050] * 5
    assert stats.p95(frames) == 0.010
    frames = [0.010] * 94 + [0.050] * 6
    assert stats.p95(frames) == 0.050
    # A median of chunks of 16 frames would hide the stall; p95 sees it.
    stalled = [0.010] * 180 + [0.200] * 20
    assert stats.p95(stalled) == 0.200


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert abs(stats.spread([90, 95, 100, 105, 110]) - 0.15) < 1e-12


def _metric(name):
    return run.load_module(ROOT / "rtbench" / "metrics" / f"{name}.py")


def test_replay_backward_count_reproduces_the_kernel_table():
    """Cornell 700x700 rec10: 0.0823 ms in PERF.md counts the kernel's
    per-block partial sums (3829 blocks of 24 x 14 floats) beside the
    problem's bytes; without them the problem's count is 0.0807 ms."""
    m = _metric("replay_bwd_roofline")
    ops, n_bytes = m.work(700 * 700, 11, 5.93, 24)
    assert round(bound_ms(ops, n_bytes), 4) == 0.0807
    layout = 3829 * 24 * 14 * 4 - 24 * 56
    assert round(bound_ms(ops, n_bytes + layout), 4) == 0.0823


def test_megakernel_count_reproduces_the_kernel_table():
    """0.0551 ms at 5.93 bounces a path (PERF.md, the megakernel's row)."""
    m = _metric("megakernel_roofline")
    ops, n_bytes = m.work(700 * 700, 5.93, 10, 20, 3, 1, 24)
    assert round(bound_ms(ops, n_bytes), 4) == 0.0552


def test_traversal_count_ray_bytes():
    """The traversal's ray I/O at 262,144 rays matches chip_smoke's
    ``ray_io_bytes`` (rays 24, skip 29 bytes); its tree is not counted,
    so a launch's bound is under PERF.md's 0.0136 ms."""
    m = _metric("traverse_roofline")
    ops, n_bytes = m.work(512 * 512, 184322)
    assert bound_ms(ops, n_bytes) < 0.0136


CELLS = {
    "megakernel_roofline": (700 * 700, 11),
    "traverse_roofline": (512 * 512, 5),
    "replay_bwd_roofline": (700 * 700, 11),
}


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("bounces", [1.0, 3.0, 5.93])
def test_roofline_never_over_100(name, bounces):
    rays, b = CELLS[name]
    m = _metric(name)
    if name == "megakernel_roofline":
        work = m.work(rays, bounces, b - 1, 20, 3, 1, 24)
    elif name == "traverse_roofline":
        work = m.work(rays * bounces / b, 184322)
    else:
        work = m.work(rays, b, bounces, 184322)
    least = bound_ms(*work)
    for t in (least, least * 1.5, least * 10):
        assert 100.0 * least / t <= 100.0


def test_every_per_layer_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (ROOT / "rtbench" / "metrics" / f"{m['name']}.py").exists()
