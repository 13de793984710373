"""Whole runs on the CPU at a tiny size: the result line, the import
guard, faults planted in the program, and the control."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from rtbench import run
from rtbench.tools import control

from .conftest import ROOT

VIEW = ("cornell-view", "mesh184k-view")
FIT = ("cornell-fit", "mesh184k-fit")


def test_result_line_keys(tiny_root):
    res = run.run_cell(tiny_root, "cornell-view", 2**40 + 1, 0.3, False,
                       "cpu")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checked"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"samples_px_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    for c in res["checked"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_traced_result_line_keys(tiny_root):
    mix = tiny_root / "rtbench" / "traffic" / "view.json"
    m = json.loads(mix.read_text())
    m.update(trace_after=0, trace_count=1, passes_per_frame=1)
    mix.write_text(json.dumps(m))
    res = run.run_cell(tiny_root, "cornell-view", 5, 0.3, True, "cpu")
    assert list(res)[-1] == "checked" and "breakdown" in res
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert {"image_ms.view_rate", "frame_ms_p95.view_rate"} <= set(
        res["metrics"])
    assert "image_ms.view" not in res["metrics"]
    # No device time on the CPU: the device readers read nothing.
    assert "megakernel_roofline" not in res["metrics"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA card (this machine) or without the program (a
    directory of only BENCHMARK.json and rtbench/), a run exits non-zero
    and prints no result."""
    import shutil
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "-m", "rtbench.run", "--workload",
             "cornell-view", "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(cwd)))
        assert p.returncode != 0 and p.stdout.strip() == ""


def test_banned_modules_compare_top_level_names():
    sys.modules["jax.fake_sub"] = sys.modules["json"]
    try:
        assert run.banned_modules() == ["jax"]
    finally:
        del sys.modules["jax.fake_sub"]
    assert "raytracercore_tpu_torch" not in run.BANNED


def test_run_loads_no_jax(tiny_root):
    code = ("import sys; sys.path.insert(0, %r); from pathlib import Path; "
            "from rtbench import run; "
            "r = run.run_cell(Path(%r), 'mesh184k-fit', 3, 0.2, False, 'cpu'); "
            "print(run.banned_modules(), r['correct'])"
            % (str(ROOT), str(tiny_root)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_imports_nothing_of_the_program():
    banned = {"raytracercore_tpu_torch", "raytracercore_tpu", "jax",
              "jaxlib", "flax"}
    for path in (ROOT / "rtbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & {"raytracercore_tpu", "jax", "jaxlib",
                            "flax"}, path
        if "reference" in path.parts:
            assert not names & banned, path


def _break_view(monkeypatch, fault):
    from raytracercore_tpu_torch.render import film, fused
    from raytracercore_tpu_torch.render import renderer as rmod

    if fault == "unchanged":
        def step(self, n=1):
            self.pass_index += n
        monkeypatch.setattr(rmod.Renderer, "step", step)
    elif fault == "half":
        # The second half of the pixels left out of the film, in both the
        # film's add and its in-place form (the pass's body).
        add, add_ = film.Film.add_full_frame, film.Film.add_full_frame_

        def keep(color):
            return torch.arange(color.shape[0]) < color.shape[0] // 2

        def half(self, color, miss):
            k = keep(color)
            return film.Film(*(torch.where(
                k.reshape(self.shape + (1,) * (a.ndim - 2)), a, b)
                for a, b in zip(add(self, color, miss).tensors(),
                                self.tensors())))

        def half_(self, color, miss):
            k = keep(color)
            old = [t.clone() for t in self.tensors()]
            add_(self, color, miss)
            for t, b in zip(self.tensors(), old):
                t.copy_(torch.where(
                    k.reshape(self.shape + (1,) * (t.ndim - 2)), t, b))
            return self
        monkeypatch.setattr(film.Film, "add_full_frame", half)
        monkeypatch.setattr(film.Film, "add_full_frame_", half_)
    else:
        plain = fused.trace_fused_reference

        def altered(*a, **k):
            color, *rest = plain(*a, **k)
            bump = (torch.arange(color.shape[0]) % 7 == 0)[:, None]
            return (color + bump.to(color.dtype), *rest)
        monkeypatch.setattr(fused, "trace_fused_reference", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_view_faults_are_not_correct(tiny_root, monkeypatch, fault):
    _break_view(monkeypatch, fault)
    # A step that does nothing is fast: a short window keeps the
    # reference's passes few.
    seconds = 0.02 if fault == "unchanged" else 0.3
    res = run.run_cell(tiny_root, "cornell-view", 9, seconds, False, "cpu")
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fit_faults_are_not_correct(tiny_root, monkeypatch, fault):
    from raytracercore_tpu_torch.parallel import shard

    if fault == "unchanged":
        adam_step = torch.optim.Adam.step

        def frozen(self, closure=None):
            params = [p for g in self.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in params]
            adam_step(self)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
        monkeypatch.setattr(torch.optim.Adam, "step", frozen)
    else:
        loss = shard.image_loss

        def broken(color, miss, target, n=None):
            if fault == "altered":
                return loss(color, miss, target, n) * 1.01
            half = color.shape[0] // 2
            return loss(color[:half], miss[:half],
                        target.reshape(-1, 3)[:half], half * 3)
        monkeypatch.setattr(shard, "image_loss", broken)
    res = run.run_cell(tiny_root, "cornell-fit", 9, 0.3, False, "cpu")
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("workload", VIEW + FIT)
def test_control_is_not_correct(tiny_root, workload):
    """The reference in bfloat16, put in the program's place, fails a
    limit of the cell."""
    cell = run.Cell(tiny_root, workload)
    if workload in VIEW:
        nums = control.view_reading(cell, 21, 16, "cpu")
    else:
        nums = control.fit_reading(cell, 21, "control", "cpu")
    assert any(nums[k] > v for k, v in cell.limits.items()), nums


@pytest.mark.card
@pytest.mark.parametrize("workload", VIEW + FIT)
def test_card_cell_runs_correct(card, workload):
    """On the card: each cell, a short window at its real size, is
    correct (``python -m pytest rtbench/tests -m card`` on the chip)."""
    res = run.run_cell(ROOT, workload, 2**40 + 17, 1.0, False, str(card))
    assert res["correct"], res["checked"]
    assert res["device"]["platform"] == "gpu"
