"""The dense tier as the benchmark's ``mesh722-700-rec10`` runs it: the
722-triangle icosphere field, which the port routes through ``trace``
with the select kernel's closest hit and the shading kernel each bounce,
and whose fit takes the replay backward's regeneration mode.

CPU tests: the benchmark's field equals the port's named scene
``mesh-722``; its rows sit in the dense tier and the regeneration range;
at a dense-tier cut (grid 2, subdiv 1: 322 rows) the ``Renderer`` takes
route ``trace`` and its film is bit-equal to the benchmark's plain
reference, and a whole fit cell reads ``correct``.  Tests marked ``cuda``
count the kernels' launches of a graphed pass and step at 700x700 and skip
without a card; this file imports no JAX, so on the card they run with
``python -m pytest --noconftest -m cuda tests/test_torch_mesh722.py``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracercore_tpu_torch.config import FUSED_MAX_PRIMS, SELECT_MAX_PRIMS
from raytracercore_tpu_torch.intersect.cuda_select import closest_hit_fused
from raytracercore_tpu_torch.intersect.dispatch import n_table_rows
from raytracercore_tpu_torch.parallel.worker import load_scene
from raytracercore_tpu_torch.render import replay_kernel
from raytracercore_tpu_torch.render.renderer import Renderer, pick_route
from rtbench import meshfield, run, scenes
from rtbench.reference import view as ref_view

ROOT = Path(__file__).resolve().parent.parent
CONFIG = "mesh722-700-rec10"
# The dense-tier cut: 4 icospheres of 80 triangles, the floor and the
# light, 322 rows (the benchmark's own CPU tests cut every field to grid 2,
# subdiv 2, 1,282 rows, which is the BVH route).
CUT = {"grid": 2, "subdiv": 1}
SIZE = 20


def _config(cut=False):
    cfg = json.loads((ROOT / "rtbench" / "configs" / f"{CONFIG}.json")
                     .read_text())
    if cut:
        cfg["size"] = [SIZE, SIZE]
        cfg["scene"].update(CUT)
    return cfg


def test_field_is_the_ports_mesh_722():
    tables, cam = meshfield.make(3, 1, 0, 10, 700, 700)
    assert len(tables["triangles"]["v0"]) == tables["n_prims"] == 722
    arrays, host_cam = load_scene("mesh-722", 700, 10, "cpu")
    for table in ("triangles", "materials"):
        for key, got in tables[table].items():
            want = getattr(getattr(arrays, table), key)
            got = torch.tensor(np.asarray(got)).to(want.dtype)
            assert torch.equal(got, want), (table, key)
    assert (arrays.width, arrays.height, arrays.recursion) == (700, 700, 10)
    assert np.allclose(cam["position"], host_cam.position)


def test_rows_sit_in_the_dense_tier_and_the_regeneration_range():
    inputs = scenes.make(_config())
    arrays, _ = scenes.for_program(inputs, "cpu")
    rows = n_table_rows(arrays)
    assert FUSED_MAX_PRIMS < rows <= SELECT_MAX_PRIMS
    n_mat = arrays.materials.diffuse.shape[0]
    assert n_mat == 722
    assert replay_kernel.SMALL_TABLE_MATS < n_mat \
        <= replay_kernel.MAX_KERNEL_MATS
    assert replay_kernel._regenerates(n_mat)
    assert pick_route(arrays) == (closest_hit_fused, None, None)


@pytest.mark.parametrize("seed", [11, 2_000_000_011, 2**40 + 3])
def test_cut_film_equals_the_reference(seed):
    """On the CPU the program runs the plain versions of the select and
    shading kernels; the reference's film of the same passes is bit-equal
    to it on every pixel."""
    inputs = scenes.make(_config(cut=True))
    assert len(inputs.tables["triangles"]["v0"]) == 322
    scene, cameras = scenes.for_program(inputs, "cpu")
    r = Renderer(scene, device="cpu", seed=seed, cameras=cameras)
    assert r.route == "trace"
    r.step(2)
    n = SIZE * SIZE
    want = ref_view.film_at(inputs.tables, inputs.camera, seed, np.arange(n),
                            2, 2, "cpu")
    assert np.array_equal(r.film.color_sum.reshape(n, 3).numpy(),
                          want["color_sum"])
    assert np.array_equal(r.film.samples.reshape(n).numpy(),
                          want["samples"])
    assert np.array_equal(r.image().reshape(n, 4), want["image"])


def test_cut_fit_cell_reads_correct(tmp_path):
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    (tmp_path / "rtbench" / "configs" / f"{CONFIG}.json").write_text(
        json.dumps(_config(cut=True)))
    res = run.run_cell(tmp_path, "mesh722-fit", 2**40 + 9, 0.3, False, "cpu")
    assert res["correct"], res["checked"]
    assert res["failed"] == 0 and res["attempted"] >= 1


# --- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the select, shading and replay "
                    "kernels are CUDA C++ for sm_90a and have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_pass_launches_on_card(card):
    from raytracercore_tpu_torch.render.shade_kernel import shade_bounce

    arrays, cam = load_scene("mesh-722", 700, 10, card)
    r = Renderer(arrays, device=card, seed=5, cameras=[cam])
    assert r.route == "trace"
    r.step(1)  # captures the pass's graph
    torch.cuda.synchronize()
    before = closest_hit_fused.launches, shade_bounce.launches
    r.step(1)
    torch.cuda.synchronize()
    assert closest_hit_fused.launches - before[0] == 11
    assert shade_bounce.launches - before[1] == 11


@pytest.mark.cuda
def test_graphed_step_launches_the_backward_once_on_card(card):
    from raytracercore_tpu_torch.diff import get_material_params
    from raytracercore_tpu_torch.intersect.dispatch import closest_hit
    from raytracercore_tpu_torch.parallel import make_train_step
    from raytracercore_tpu_torch.scene.types import init_camera

    arrays, cam = load_scene("mesh-722", 700, 10, card)
    camera = init_camera(cam, 700, 700, device=card)
    target = torch.full((700, 700, 3), 0.2, device=card)
    params = get_material_params(arrays)
    step = make_train_step(None, torch.optim.Adam(params.values(), lr=0.01),
                           closest_fn=closest_hit)
    step(params, arrays, camera, target, 1)  # captures the step's graph
    torch.cuda.synchronize()
    before = replay_kernel.replay_bwd.launches
    loss = step(params, arrays, camera, target, 2)
    torch.cuda.synchronize()
    assert replay_kernel.replay_bwd.launches - before == 1
    assert torch.isfinite(loss)
