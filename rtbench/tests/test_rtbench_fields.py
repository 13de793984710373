"""The sphere and ellipsoid fields as the harness takes them: the scene
kind ``sphere_field`` (``rtbench/spherefield.py``) and the reference's
clustered sphere scan (``reference/tracer.py`` ``SphereClusters``).

CPU tests: the field's tables equal the port's generator's; at full size
they have the JAX package's row counts; the clustered sphere scan equals
the dense scan bit for bit, for camera rays and scattered rays with skip
records; at a cut the reference's film equals the program's; a
``sphere_field`` cell is added as new files and entries only; and the
existing configurations' references are untouched (no sphere clusters,
the triangle scan through the changed code still equal to the dense
one)."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from rtbench import run, scenes
from rtbench.reference import tables as tb
from rtbench.reference import tracer as tr
from rtbench.reference import view as ref_view

from .conftest import ROOT

FORMS = [pytest.param(False, id="spheres"),
         pytest.param(True, id="ellipsoids")]


def _config(grid, ellipsoid, size=24, recursion=3):
    return {"name": "field", "size": [size, size], "recursion": recursion,
            "scene": {"kind": "sphere_field", "grid": grid, "seed": 0,
                      "ellipsoid": ellipsoid}}


@pytest.mark.parametrize("ellipsoid", FORMS)
def test_field_equals_the_ports_generator(ellipsoid):
    """Every table equal to ``meshgen.make_sphere_field_scene``'s at grid
    17, bit for bit, but the light's ``two_sided``, which the harness
    sets."""
    from raytracercore_tpu_torch.scene import meshgen
    from raytracercore_tpu_torch.scene.types import scene_arrays_from_numpy

    inputs = scenes.make(_config(17, ellipsoid))
    got = scene_arrays_from_numpy(inputs.tables, device="cpu")
    want, cam = meshgen.make_sphere_field_scene(
        grid=17, seed=0, recursion=3, width=24, height=24, device="cpu",
        ellipsoid=ellipsoid)
    n = 17 * 17 + 2
    for table in ("triangles", "spheres", "planes", "materials"):
        for f in dataclasses.fields(getattr(want, table)):
            a = getattr(getattr(got, table), f.name)
            b = getattr(getattr(want, table), f.name)
            if (table, f.name) == ("materials", "two_sided"):
                b = b.clone()
                b[n - 1] = True
            assert a.dtype == b.dtype and torch.equal(a, b), (table, f.name)
    for f in dataclasses.fields(want):
        if f.name not in ("triangles", "spheres", "planes", "materials"):
            a, b = getattr(got, f.name), getattr(want, f.name)
            same = torch.equal(a, b) if isinstance(b, torch.Tensor) \
                else a == b
            assert same, f.name
    c = inputs.camera
    assert cam.mode == "frustum" and c["fov"] == cam.fov_or_size
    for key in ("position", "look_at", "up"):
        assert np.array_equal(c[key], getattr(cam, key)), key


@pytest.mark.parametrize("grid, ellipsoid, rows", [
    (320, False, 102_400), (224, True, 50_176)])
def test_full_size_row_counts(grid, ellipsoid, rows):
    t = scenes.make(_config(grid, ellipsoid, 512, 4)).tables
    sph = t["spheres"]
    assert len(sph["prim_id"]) == rows and (sph["prim_id"] >= 0).all()
    assert bool(sph["transformed"].all()) == ellipsoid
    assert list(t["triangles"]["prim_id"]) == [rows, rows + 1]
    assert t["n_prims"] == rows + 2


def _records_equal(a, b):
    for key in ("prim", "found", "inside"):
        assert torch.equal(a[key], b[key]), key
    for key in ("p", "n"):
        for k in range(3):
            assert torch.equal(a[key][k], b[key][k]), (key, k)


def _scan_both(scene, clusters, kind, o, d, skip):
    test = tr._TESTS[kind]
    cols = getattr(scene, kind)
    got = tr._best_clustered(clusters[kind], test, cols, o, d, skip)
    want = tr._best_dense(test, cols, o, d, skip)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _records_equal(tr.closest_hit(scene, o, d, skip, clusters),
                   tr.closest_hit(scene, o, d, skip))
    return want


def _camera_and_bounce(scene, camera, size, seed, clusters, kind):
    """The clustered scan against the dense one for camera rays, then for
    one bounce of diffusely scattered rays from their hits, with the hits
    as skip records."""
    cam = tb.camera(camera, size, size, "cpu")
    pix = torch.arange(size * size)
    jitter, raw = tr.pass_draws(seed, 0, size * size, 2, pix, "cpu",
                                torch.float32)
    o, d = tr.camera_rays(cam, pix % size, pix // size, jitter)
    _, row = _scan_both(scene, clusters, kind, o, d, None)
    assert int((row >= 0).sum()) > size * size // 10
    hit = tr.closest_hit(scene, o, d, None)
    idx = torch.nonzero(hit["found"])[:, 0]
    u = tr.preprocess(raw)[1][:, idx]
    nrm = tuple(a[idx] for a in hit["n"])
    o2 = tuple(a[idx] for a in hit["p"])
    d2 = tr._horizon(nrm, u[4], u[5], u[6])
    skip = {"prim": hit["prim"][idx], "inside": hit["inside"][idx],
            "p": o2, "n": nrm}
    _, row2 = _scan_both(scene, clusters, kind, o2, d2, skip)
    assert int((row2 >= 0).sum()) > 0


@pytest.mark.parametrize("ellipsoid", FORMS)
def test_clustered_sphere_scan_equals_the_dense_scan(ellipsoid):
    """Grid 20: 400 sphere rows, two clusters."""
    inputs = scenes.make(_config(20, ellipsoid))
    scene = tb.load(inputs.tables, "cpu")
    clusters = tr.scene_clusters(scene)
    assert set(clusters) == {"sph"} and clusters["sph"].k == 2
    _camera_and_bounce(scene, inputs.camera, 48, 2**40 + 5, clusters, "sph")


def test_triangle_scan_through_the_clusters_is_unchanged():
    """The 1,282-row icosphere cut (grid 2, subdiv 2) through the changed
    ``_best_clustered``: bit-equal to the dense scan."""
    cfg = json.loads((ROOT / "rtbench" / "configs" / "mesh184k-512-rec4.json")
                     .read_text())
    cfg["scene"].update(grid=2, subdiv=2)
    inputs = scenes.make(cfg)
    scene = tb.load(inputs.tables, "cpu")
    assert scene.n_tri == 1282
    clusters = tr.scene_clusters(scene)
    assert set(clusters) == {"tri"} and clusters["tri"].k == 6
    _camera_and_bounce(scene, inputs.camera, 48, 2**40 + 6, clusters, "tri")


@pytest.mark.parametrize("config", ["cornell-700-rec10",
                                    "mesh184k-512-rec4",
                                    "mesh722-700-rec10"])
def test_existing_references_build_no_sphere_clusters(config):
    cfg = json.loads((ROOT / "rtbench" / "configs" / f"{config}.json")
                     .read_text())
    scene = tb.load(scenes.make(cfg).tables, "cpu")
    clusters = tr.scene_clusters(scene)
    assert "sph" not in clusters
    assert ("tri" in clusters) == (scene.n_tri > tr.CLUSTER)


@pytest.mark.parametrize("ellipsoid", FORMS)
def test_cut_film_equals_the_reference(ellipsoid):
    """Grid 17 (289 sphere rows: the reference scans them through two
    clusters) at 24x24, recursion 3: on the CPU the program takes route
    ``trace`` with the plain versions of its kernels, and the reference's
    film of the same passes is bit-equal to it on every pixel."""
    from raytracercore_tpu_torch.render.renderer import Renderer

    inputs = scenes.make(_config(17, ellipsoid))
    scene, cameras = scenes.for_program(inputs, "cpu")
    r = Renderer(scene, device="cpu", seed=2**40 + 3, cameras=cameras)
    assert r.route == "trace"
    r.step(2)
    n = 24 * 24
    want = ref_view.film_at(inputs.tables, inputs.camera, 2**40 + 3,
                            np.arange(n), 2, 2, "cpu")
    assert np.array_equal(r.film.color_sum.reshape(n, 3).numpy(),
                          want["color_sum"])
    assert np.array_equal(r.film.samples.reshape(n).numpy(),
                          want["samples"])
    assert np.array_equal(r.image().reshape(n, 4), want["image"])
    assert want["samples"].sum() > n  # the field is hit


def test_added_sphere_field_cell_needs_no_edit(tiny_root):
    """A throwaway ``sphere_field`` configuration and ``view`` cell, added
    as new files and new entries in a copy, run ``correct`` on the CPU
    with no existing file edited."""
    base = tiny_root / "rtbench"
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = dict(_config(17, True, 16, 3), name="ellipsoids-tiny-rec3")
    (base / "configs" / "ellipsoids-tiny-rec3.json").write_text(
        json.dumps(cfg))
    (base / "limits" / "ellipsoids-tiny-view.json").write_text(json.dumps(
        {"film_gap": 0.1, "image_gap": 8.0}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "ellipsoids-tiny-rec3", "source": "test",
        "file": "rtbench/configs/ellipsoids-tiny-rec3.json",
        "reduced": ["grid"], "why": "test"})
    bench["workloads"].append({"name": "ellipsoids-tiny-view",
                               "config": "ellipsoids-tiny-rec3",
                               "traffic": "view", "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mesh184k-view" in m.get("workloads", []):
            m["workloads"].append("ellipsoids-tiny-view")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = run.run_cell(tiny_root, "ellipsoids-tiny-view", 2**40 + 11, 0.2,
                       False, "cpu")
    assert res["correct"], res["checked"]
    assert set(res["metrics"]) == {"samples_px_per_s", "frame_ms_p95",
                                   "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
