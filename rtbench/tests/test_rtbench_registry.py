"""The cells' files are found by the names ``BENCHMARK.json`` gives, and a
new configuration, traffic mix and metric are new files plus new entries."""

from __future__ import annotations

import json
import re

import pytest

from rtbench import run

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = run.Cell(ROOT, workload)
    assert cell.loop_path.exists()
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    for path in cell.metric_paths.values():
        assert path.exists() and callable(run.load_module(path).read)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    for m in cell.per_layer:
        assert m["moves"] in reported  # each moves a metric the cell reports


def test_benchmark_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("rtbench/")
        assert (ROOT / c["file"]).exists()
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_added_cell_needs_no_edit(tiny_root):
    """A throwaway configuration, traffic mix and per-layer metric, added
    as new files and new entries in a copy, are run with no edit of an
    existing file."""
    base = tiny_root / "rtbench"
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "cornell-700-rec10.json")
                     .read_text())
    cfg["name"] = "cornell-tiny-rec3"
    cfg["recursion"] = 3
    cfg["scene"]["text"] = [("recursion 3" if line.startswith("recursion")
                             else line) for line in cfg["scene"]["text"]]
    (base / "configs" / "cornell-tiny-rec3.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "view.json").read_text())
    mix["passes_per_frame"] = 2
    (base / "traffic" / "view2.json").write_text(json.dumps(mix))
    (base / "metrics" / "frames.view2.py").write_text(
        "def read(ctx):\n    return float(ctx.counts['frames'])\n")
    (base / "limits" / "tiny-view2.json").write_text(json.dumps(
        {"film_gap": 0.05, "image_gap": 8.0}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cornell-tiny-rec3", "source": "test",
                             "file": "rtbench/configs/cornell-tiny-rec3.json",
                             "reduced": ["recursion"], "why": "test"})
    bench["workloads"].append({"name": "tiny-view2",
                               "config": "cornell-tiny-rec3",
                               "traffic": "view2", "chips": 1, "why": "t"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cornell-view" in m["workloads"]:
            m["workloads"].append("tiny-view2")
    bench["per_layer"].append({
        "name": "frames.view2", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "device",
        "moves": "samples_px_per_s", "workloads": ["tiny-view2"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = run.run_cell(tiny_root, "tiny-view2", 7, 0.2, False, "cpu")
    assert res["correct"]
    assert set(res["metrics"]) == {"samples_px_per_s", "setup_s"}
    cell = run.Cell(tiny_root, "tiny-view2")
    assert "frames.view2" in cell.metric_paths
    assert cell.traffic["passes_per_frame"] == 2
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
