"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with its
configurations cut to a size the CPU runs in seconds.

Run from the repository's root: ``python -m pytest rtbench/tests -q``.
Tests that need a CUDA card carry the ``card`` marker and skip without
one, deciding so in the ``card`` fixture."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
TINY = 16


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def shrink(root: Path, size: int = TINY):
    """Cut every configuration under ``root`` to ``size`` x ``size`` and
    the icosphere field to 4 spheres of 320 triangles (above the dense
    tier, so the program still takes the BVH route)."""
    for path in (root / "rtbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["size"] = [size, size]
        scene = cfg["scene"]
        if scene["kind"] == "text":
            scene["text"] = [f"size {size} {size}" if line.startswith("size")
                             else line for line in scene["text"]]
        else:
            scene.update(grid=2, subdiv=2)
        path.write_text(json.dumps(cfg))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``rtbench/`` with tiny
    configurations."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shrink(tmp_path)
    return tmp_path
