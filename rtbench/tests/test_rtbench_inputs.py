"""The seeded inputs repeat exactly, the frozen copies give what they were
copied from, and the reference matches the program's plain versions."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from rtbench import meshfield, scenes
from rtbench.loops import fit as fit_loop
from rtbench.reference import scene_text, tracer
from rtbench.reference import view as ref_view

from .conftest import ROOT


def _config(name):
    return json.loads((ROOT / "rtbench" / "configs" / f"{name}.json")
                      .read_text())


def test_icosphere_field_is_the_184k_mesh():
    tables, cam = meshfield.make(12, 3, 0, 4, 512, 512)
    tri = tables["triangles"]
    assert tri["v0"].shape == (184322, 3)
    assert tables["materials"]["two_sided"].sum() == 1
    assert tables["materials"]["two_sided"][-1]  # the light
    assert tables["materials"]["emission"][-1].tolist() == [14.0, 13.0, 12.0]
    again, _ = meshfield.make(12, 3, 0, 4, 512, 512)
    for key in tri:
        assert np.array_equal(tri[key], again["triangles"][key])


def test_icosphere_field_equals_the_programs_generator():
    from raytracercore_tpu_torch.scene import meshgen

    tables, cam = meshfield.make(2, 1, 3, 4, 32, 32)
    arrays, host_cam, _ = meshgen.make_mesh_scene(
        grid=2, subdiv=1, seed=3, recursion=4, width=32, height=32,
        device="cpu")
    for key in ("v0", "e1", "e2", "normal", "n0", "n1", "n2", "mirror",
                "smooth", "prim_id"):
        want = getattr(arrays.triangles, key).numpy()
        got = torch.tensor(np.asarray(tables["triangles"][key])).to(
            getattr(arrays.triangles, key).dtype).numpy()
        assert np.array_equal(got, want), key
    assert np.allclose(cam["position"], host_cam.position)


def test_scene_text_equals_the_programs_parse():
    from raytracercore_tpu_torch.scene import loader
    from raytracercore_tpu_torch.scene.types import freeze_scene

    cfg = _config("cornell-700-rec10")
    text = "\n".join(cfg["scene"]["text"])
    tables, cams = scene_text.parse(text)
    arrays = freeze_scene(loader.parse(text), device="cpu")
    for table in ("triangles", "spheres", "planes", "materials"):
        for key, got in tables[table].items():
            want = getattr(getattr(arrays, table), key)
            got = torch.tensor(np.asarray(got)).to(want.dtype)
            assert torch.equal(got, want), (table, key)
    assert tables["n_prims"] == arrays.n_prims == 24
    assert (tables["width"], tables["recursion"]) == (700, 10)


def test_draws_and_pixels_repeat():
    a = tracer.pass_draws(2**40 + 3, 5, 64, 3, torch.arange(8), "cpu",
                          torch.float32)
    b = tracer.pass_draws(2**40 + 3, 5, 64, 3, torch.arange(8), "cpu",
                          torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tracer.pass_seed(2**40 + 3, 5) != tracer.pass_seed(2**40 + 3, 6)
    target = fit_loop.make_target(2**40 + 3, 4, 4, "cpu")
    assert torch.equal(target, fit_loop.make_target(2**40 + 3, 4, 4, "cpu"))


@pytest.mark.parametrize("name", ["cornell-700-rec10", "mesh184k-512-rec4"])
def test_reference_film_equals_the_programs(name):
    """On the CPU the program runs its plain versions; the reference's
    film of the same passes is bit-equal to it."""
    from raytracercore_tpu_torch.render.renderer import Renderer

    cfg = _config(name)
    cfg["size"] = [20, 20]
    if cfg["scene"]["kind"] == "text":
        cfg["scene"]["text"] = [("size 20 20" if line.startswith("size")
                                 else line) for line in cfg["scene"]["text"]]
    else:
        cfg["scene"].update(grid=2, subdiv=2)
    inputs = scenes.make(cfg)
    scene, cameras = scenes.for_program(inputs, "cpu")
    r = Renderer(scene, device="cpu", seed=11, cameras=cameras)
    r.step(3)
    pix = np.arange(400)
    want = ref_view.film_at(inputs.tables, inputs.camera, 11, pix, 3, 3,
                            "cpu")
    assert np.array_equal(r.film.color_sum.reshape(400, 3).numpy(),
                          want["color_sum"])
    assert np.array_equal(r.film.samples.reshape(400).numpy(),
                          want["samples"])
    assert np.array_equal(r.image().reshape(400, 4), want["image"])
