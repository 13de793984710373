"""Two OS processes (``python -m raytracercore_tpu_torch.parallel.worker``,
CPU, gloo) render one film sharded over them; rank 0's gathered film must
equal the single-process film (the counterpart of
``tests/test_multihost.py``)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from raytracercore_tpu_torch.intersect.cuda_select import closest_hit_fused
from raytracercore_tpu_torch.parallel import worker
from raytracercore_tpu_torch.render.film import Film
from raytracercore_tpu_torch.render.renderer import pick_route, render_passes
from raytracercore_tpu_torch.scene.types import init_camera

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE, REC, PASSES, SEED = 16, 3, 2, 4


@pytest.mark.parametrize("prims", [1, 2])
def test_two_process_render_matches_single(tmp_path, prims):
    """``prims=1``: the image rows split over the two processes (the
    megakernel's route); ``prims=2``: the triangle table split instead,
    the closest hit agreed per bounce."""
    out = tmp_path / "film.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "raytracercore_tpu_torch.parallel.worker",
         str(rank), "2", str(tmp_path / "store"), str(out),
         "--device", "cpu", "--size", str(SIZE), "--recursion", str(REC),
         "--passes", str(PASSES), "--seed", str(SEED),
         "--prims", str(prims)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(REPO))
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
    got = np.load(out)

    arrays, cam = worker.load_scene("cornell", SIZE, REC, "cpu")
    camera = init_camera(cam, SIZE, SIZE, device="cpu")
    closest_fn, trace_fn, _ = pick_route(arrays)
    if prims > 1:
        closest_fn, trace_fn = closest_hit_fused, None
    film = render_passes(arrays, camera, Film.create(SIZE, SIZE, device="cpu"),
                         SEED, 0, PASSES, closest_fn=closest_fn,
                         trace_fn=trace_fn)
    np.testing.assert_array_equal(got["samples"], film.samples.numpy())
    np.testing.assert_array_equal(got["misses"], film.misses.numpy())
    np.testing.assert_allclose(got["color_sum"], film.color_sum.numpy(),
                               rtol=2e-5, atol=2e-5)
    assert got["color_sum"].max() > 0.5
