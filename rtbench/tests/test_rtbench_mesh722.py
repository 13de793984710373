"""The dense tier's cells (``mesh722-view``, ``mesh722-fit``): the select
kernel's work count against the kernel table, its two roofline readers on
synthetic traces, and, on a dense-tier cut of the configuration, planted
faults and the control reading not ``correct``."""

from __future__ import annotations

import json
import shutil
from types import SimpleNamespace

import pytest
import torch

from rtbench import meshfield, run, select_work
from rtbench.devtrace import Profile
from rtbench.peaks import bound_ms
from rtbench.tools import control

from .conftest import ROOT

CONFIG = "mesh722-700-rec10"
READERS = {"select_roofline.view": "rays_per_pass",
           "select_roofline.fit": "rays_per_step"}


def test_select_count_reproduces_the_kernel_table():
    """PERF.md's select row: 0.2746 ms at bounce 0 of mesh-722 700x700
    (490,000 live rays, 722 triangles), set by the operations."""
    for winners in (0, 490_000):
        ops, n_bytes = select_work.work(490_000, 490_000, winners, 0, 722,
                                        0, 0)
        assert abs(bound_ms(ops, n_bytes) - 0.2746) <= 0.01 * 0.2746
        assert ops / 67e12 > n_bytes / 3.35e12


def _ctx(rays_key, bounces_per_path, seconds, extra=()):
    """A traced run's context with the select kernels' time a query set to
    ``seconds``, 11 queries, beside other kernels' ``extra``."""
    tables, _ = meshfield.make(3, 1, 0, 10, 700, 700)
    p = Profile()
    p.kernels = {"rtc::select_list_kernel(rtc::SelectParams)":
                 [0.1 * seconds * 11, 11],
                 "rtc::select_kernel(rtc::SelectParams)":
                 [0.8 * seconds * 11, 11],
                 "rtc::select_finish_kernel(rtc::SelectParams)":
                 [0.1 * seconds * 11, 11]}
    p.kernels.update(extra)
    return SimpleNamespace(profile=p, counts={
        rays_key: 700 * 700, "bounces_per_path": bounces_per_path,
        "scene_tables": tables})


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("bounces", [1.0, 3.0, 5.93])
def test_select_roofline_at_most_100(name, bounces):
    """A query taking exactly its least time reads 100 %, a slower one
    less; torch's own ``index_select`` kernels are not counted."""
    reader = run.load_module(ROOT / "rtbench" / "metrics" / f"{name}.py")
    least = bound_ms(*select_work.mean_query(700 * 700, bounces, 10, 722, 0,
                                             0)) * 1e-3
    at_least = reader.read(_ctx(READERS[name], bounces, least))
    assert at_least == pytest.approx(100.0, rel=1e-9)
    other = {"void at::native::index_select_kernel<float>()": [1.0, 11],
             "void rtc::shade_bounce_kernel<float, false, false>()":
             [1.0, 11]}
    slower = reader.read(_ctx(READERS[name], bounces, 4 * least, other))
    assert slower == pytest.approx(25.0, rel=1e-9)


@pytest.mark.parametrize("name", sorted(READERS))
def test_select_roofline_silent_without_the_kernel(name):
    reader = run.load_module(ROOT / "rtbench" / "metrics" / f"{name}.py")
    ctx = _ctx(READERS[name], 1.5, 1e-4)
    ctx.profile.kernels = {"void rtc::traverse_kernel<0, false>()": [1.0, 5]}
    assert reader.read(ctx) is None


@pytest.fixture
def dense_root(tmp_path):
    """A copy of the benchmark with ``mesh722-700-rec10`` cut to the dense
    tier (grid 2, subdiv 1: 322 rows) at 16x16, and frames of one pass."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    path = tmp_path / "rtbench" / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg["size"] = [16, 16]
    cfg["scene"].update(grid=2, subdiv=1)
    path.write_text(json.dumps(cfg))
    mix = tmp_path / "rtbench" / "traffic" / "view.json"
    m = json.loads(mix.read_text())
    m["passes_per_frame"] = 1
    mix.write_text(json.dumps(m))
    return tmp_path


def _break_trace(monkeypatch, fault):
    """The ``trace`` route's pass broken: ``half`` leaves the second half
    of the pixels out (each a miss), ``altered`` adds 1 to every 7th
    ray's colour."""
    from raytracercore_tpu_torch.render import renderer as rmod

    plain = rmod.trace

    def broken(*a, **k):
        color, miss = plain(*a, **k)
        lane = torch.arange(color.shape[0])
        if fault == "half":
            return color, miss | (lane >= color.shape[0] // 2)
        return color + (lane % 7 == 0)[:, None].to(color.dtype), miss
    monkeypatch.setattr(rmod, "trace", broken)


def test_dense_cut_is_correct_and_takes_route_trace(dense_root, capfd):
    res = run.run_cell(dense_root, "mesh722-view", 2**40 + 7, 0.1, False,
                       "cpu")
    assert res["correct"], res["checked"]
    assert "route trace" in capfd.readouterr().err


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_view_faults_are_not_correct(dense_root, monkeypatch, fault):
    _break_trace(monkeypatch, fault)
    res = run.run_cell(dense_root, "mesh722-view", 9, 0.1, False, "cpu")
    assert not res["correct"], res["checked"]


def test_fit_fault_half_is_not_correct(dense_root, monkeypatch):
    from raytracercore_tpu_torch.parallel import shard

    loss = shard.image_loss

    def half(color, miss, target, n=None):
        h = color.shape[0] // 2
        return loss(color[:h], miss[:h], target.reshape(-1, 3)[:h], h * 3)
    monkeypatch.setattr(shard, "image_loss", half)
    res = run.run_cell(dense_root, "mesh722-fit", 9, 0.3, False, "cpu")
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("workload", ["mesh722-view", "mesh722-fit"])
def test_control_is_not_correct(dense_root, workload):
    """The reference in bfloat16, put in the program's place, fails a
    limit of the cell on the dense-tier cut."""
    cell = run.Cell(dense_root, workload)
    if workload == "mesh722-view":
        nums = control.view_reading(cell, 21, 16, "cpu")
    else:
        nums = control.fit_reading(cell, 21, "control", "cpu")
    assert any(nums[k] > v for k, v in cell.limits.items()), nums
